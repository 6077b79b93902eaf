"""Batch encoding of canonical byte-level Unigram and BPE tokenizers on the
native host library (counterpart of ``zett_tpu/tokenization/fast_encode.py``).

Valid only for the canonical sampled/converted pipeline: a Prepend(" ")
normalizer (optional), Split(SPLIT_REGEX or SPLIT_REGEX_NO_MARKS, every
match kept) + ByteLevel (or a plain ByteLevel with use_regex)
pre-tokenization, and a byte-complete model. Any other tokenizer (Llama-3's
Split among them) gets None from ``fast_encoder_or_none`` and its callers
encode with the general pipeline (``Tokenizer.encode_batch``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..constants import SPLIT_REGEX, SPLIT_REGEX_NO_MARKS
from ..csrc import host_lib
from .bytemaps import CHARS_TO_BYTES
from .core import Tokenizer
from .models import BPE, Unigram
from .normalizers import Prepend
from .postprocessors import ByteLevelPost, TemplateProcessing
from .pretokenizers import ByteLevel, Sequence, Split

# byte-char -> latin-1 char translation. Raw chars outside the byte alphabet
# but < 0x100 map to an un-encodable char so the piece is skipped.
_BYTECHAR_TRANS = {ord(c): chr(b) for c, b in CHARS_TO_BYTES.items()}
for _b in range(256):
    if _b not in _BYTECHAR_TRANS:
        _BYTECHAR_TRANS[_b] = "￿"


def _build_native_bpe(model: BPE, trans) -> Optional[host_lib.NativeBPE]:
    """NativeBPE from a byte-level BPE model, or None unless the raw-byte
    vocab covers all 256 single bytes (then unk can never trigger)."""
    pieces_raw: List[bytes] = []
    piece_ids: List[int] = []
    raw_by_piece = {}
    bytes_seen = set()
    for piece, idx in model.vocab.items():
        try:
            raw = piece.translate(trans).encode("latin-1")
        except UnicodeEncodeError:
            continue  # specials never match raw byte text
        pieces_raw.append(raw)
        piece_ids.append(idx)
        raw_by_piece[piece] = raw
        if len(raw) == 1:
            bytes_seen.add(raw[0])
    if len(bytes_seen) < 256:
        return None
    merges = []
    vocab = model.vocab
    for left, right in model.merges:
        li, ri, mi = vocab.get(left), vocab.get(right), vocab.get(left + right)
        if li is None or ri is None or mi is None:
            continue
        if left not in raw_by_piece or right not in raw_by_piece:
            continue
        merges.append((li, ri, mi))
    return host_lib.NativeBPE(pieces_raw, piece_ids, merges, unk_id=-1,
                              ignore_merges=model.ignore_merges)


def _canonical_structure(tok: Tokenizer) -> bool:
    """Whether the native split is the tokenizer's own: a Split on one of
    the two GPT-2 patterns that keeps every match (the JAX package takes
    any Split before a ByteLevel and runs the GPT-2 split on Llama-3's
    pattern too: ROADMAP C.24), or a plain ByteLevel with use_regex."""
    if isinstance(tok.model, BPE):
        m = tok.model
        if m.continuing_subword_prefix or m.end_of_word_suffix:
            return False
    elif not isinstance(tok.model, Unigram):
        return False
    pt = tok.pre_tokenizer
    if (isinstance(pt, Sequence) and len(pt.pretokenizers) == 2
            and isinstance(pt.pretokenizers[0], Split)
            and isinstance(pt.pretokenizers[1], ByteLevel)):
        split = pt.pretokenizers[0]
        return split.pattern in (SPLIT_REGEX, SPLIT_REGEX_NO_MARKS) and (
            split.invert or split.behavior.lower() == "isolated")
    return isinstance(pt, ByteLevel) and pt.use_regex


class SplitConfig:
    """What the native split needs from a canonical tokenizer: the
    Prepend normalizer's string (or None), whether the letter class takes
    marks (SPLIT_REGEX vs SPLIT_REGEX_NO_MARKS), and the plain ByteLevel
    pre-tokenizer's add_prefix_space."""

    def __init__(self, prepend: Optional[str], use_marks: bool, add_prefix_space: bool):
        self.prepend = prepend
        self.use_marks = use_marks
        self.add_prefix_space = add_prefix_space

    @staticmethod
    def of(tok: Tokenizer) -> "SplitConfig":
        """Raises ValueError unless ``tok`` has the canonical structure."""
        if not _canonical_structure(tok):
            raise ValueError("tokenizer is not canonical byte-level")
        norm = tok.normalizer
        prepend = None
        if norm is not None:
            if not isinstance(norm, Prepend):
                raise ValueError(f"unsupported normalizer for the fast path: {norm.to_json()}")
            prepend = norm.prepend
        pt = tok.pre_tokenizer
        if isinstance(pt, ByteLevel):
            return SplitConfig(prepend, False, bool(pt.add_prefix_space))
        return SplitConfig(prepend, r"\p{M}" in pt.pretokenizers[0].pattern, False)

    def raw_texts(self, texts: List[str]) -> List[bytes]:
        """The normalized utf-8 texts that the native split takes."""
        prepend_b = self.prepend.encode("utf-8") if self.prepend else b""
        raw = [(prepend_b + t.encode("utf-8")) if (prepend_b and t) else t.encode("utf-8")
               for t in texts]
        if self.add_prefix_space:
            raw = [(b" " + t) if t and not t.startswith(b" ") else t for t in raw]
        return raw


class FastUnigramEncoder:
    """Vectorized encode for a canonical byte-level Unigram or BPE tokenizer."""

    def __init__(self, tok: Tokenizer):
        self.tok = tok
        self.split = SplitConfig.of(tok)

        trans = _BYTECHAR_TRANS
        if isinstance(tok.model, Unigram):
            pieces_raw: List[bytes] = []
            scores: List[float] = []
            id_map: List[int] = []
            for i, (piece, score) in enumerate(tok.model.pieces):
                try:
                    raw = piece.translate(trans).encode("latin-1")
                except UnicodeEncodeError:
                    continue
                pieces_raw.append(raw)
                scores.append(score)
                id_map.append(i)
            self._id_map = np.asarray(id_map, dtype=np.int32)
            self._native = host_lib.NativeUnigram(pieces_raw, scores, unk_id=-1)
        else:
            self._id_map = None
            self._native = _build_native_bpe(tok.model, trans)
            if self._native is None:
                raise ValueError("BPE vocab is not byte-complete")

        # single-sequence special-token template (TemplateProcessing)
        self.prefix_ids: List[int] = []
        self.suffix_ids: List[int] = []
        post = tok.post_processor
        if isinstance(post, TemplateProcessing):
            specials = post.special_tokens
            seen_seq = False
            for piece in post.single:
                if "Sequence" in piece:
                    seen_seq = True
                elif "SpecialToken" in piece:
                    ids = specials[piece["SpecialToken"]["id"]]["ids"]
                    (self.suffix_ids if seen_seq else self.prefix_ids).extend(ids)
        elif post is not None and not isinstance(post, ByteLevelPost):
            raise ValueError(f"unsupported post_processor for the fast path: {post.to_json()}")

    def segment(self, tokens: List[str]) -> List[Optional[np.ndarray]]:
        """Each byte-level string segmented on its own by a Unigram model's
        Viterbi, as ``Unigram.tokenize`` segments a pretoken (no normalizer,
        no split; ties to the first begin, as there): int32 vocab ids, or
        None for a string with a char outside the byte alphabet or a byte
        no piece covers (the caller segments it the general way)."""
        if self._id_map is None:
            raise TypeError("segment: a Unigram model only")
        out: List[Optional[np.ndarray]] = [None] * len(tokens)
        raw, where = [], []
        for i, token in enumerate(tokens):
            try:
                raw.append(token.translate(_BYTECHAR_TRANS).encode("latin-1"))
            except UnicodeEncodeError:
                continue
            where.append(i)
        for i, ids in zip(where, self._native.encode_pretokens(raw)):
            if len(ids) and not (ids < 0).any():
                out[i] = self._id_map[ids]
        return out

    def encode_batch(self, texts: List[str], add_special_tokens: bool = True,
                     max_length: Optional[int] = None,
                     pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """(input_ids, attention_mask) int32. With max_length set the output
        is truncated and padded to (n_texts, max_length); otherwise to the
        longest sequence."""
        flat_ids, tokens_per_text = self._native.encode_texts(self.split.raw_texts(texts),
                                                              use_marks=self.split.use_marks)
        if self._id_map is not None:
            flat_ids = self._id_map[flat_ids]  # trie ids -> vocab ids
        text_tok_starts = np.concatenate([[0], np.cumsum(tokens_per_text[:-1], dtype=np.int64)])

        prefix = np.asarray(self.prefix_ids if add_special_tokens else [], dtype=np.int32)
        suffix = np.asarray(self.suffix_ids if add_special_tokens else [], dtype=np.int32)
        np_, ns = len(prefix), len(suffix)
        total_per_text = tokens_per_text + np_ + ns
        if max_length is not None:
            final_per_text = np.minimum(total_per_text, max_length)
            width = max_length
        else:
            final_per_text = total_per_text
            width = int(final_per_text.max()) if len(texts) else 0

        out = np.full((len(texts), width), pad_id, dtype=np.int32)
        rows = np.repeat(np.arange(len(texts)), tokens_per_text)
        cols = (np.arange(len(flat_ids), dtype=np.int64)
                - np.repeat(text_tok_starts, tokens_per_text) + np_)
        keep = cols < width - (ns if max_length is not None else 0) if ns else cols < width
        if max_length is not None and ns:
            # reserve room for the suffix under truncation
            keep = cols < np.repeat(final_per_text - ns, tokens_per_text)
        out[rows[keep], cols[keep]] = flat_ids[keep]
        if np_:
            out[:, :np_] = prefix[None, :]
        if ns:
            suffix_start = final_per_text - ns
            for k in range(ns):
                out[np.arange(len(texts)), np.minimum(suffix_start + k, width - 1)] = suffix[k]
        mask = (np.arange(width)[None, :] < final_per_text[:, None]).astype(np.int32)
        return out, mask


def fast_encoder_or_none(tok: Tokenizer) -> Optional[FastUnigramEncoder]:
    if not _canonical_structure(tok):
        return None
    try:
        return FastUnigramEncoder(tok)
    except ValueError:
        return None
