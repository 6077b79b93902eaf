"""The top-level Tokenizer: normalization -> added-token split -> pre-tokenize
-> model -> post-process, with tokenizer.json (de)serialization that
round-trips with HF `tokenizers`.

Counterpart of ``zett_tpu/tokenization/core.py``: encode/encode_batch with
pairs, truncation (before post-processing, leaving room for the special
tokens), padding and the special-tokens mask; decode; added and special
tokens. Standard library only: the added-token split runs on ``re`` over
escaped literals, and a word character for ``single_word`` is ``regex``'s
``\\w`` (``patterns.is_word``).

Offsets follow the JAX package, also where it departs from HF: a
length-changing normalizer shifts a segment's offsets by its length change
(exact for a prepended prefix only), and an added token's offsets are
``(0, len(content))`` wherever it stands (ROADMAP C.10).
"""

from __future__ import annotations

import copy
import json
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import decoders as _decoders
from . import models as _models
from . import normalizers as _normalizers
from . import postprocessors as _post
from . import pretokenizers as _pretok
from .patterns import is_word


@dataclass
class AddedToken:
    content: str
    single_word: bool = False
    lstrip: bool = False
    rstrip: bool = False
    normalized: bool = True
    special: bool = False

    @staticmethod
    def from_any(x, special: bool = False) -> "AddedToken":
        if isinstance(x, AddedToken):
            return x
        if isinstance(x, str):
            return AddedToken(x, normalized=not special, special=special)
        return AddedToken(
            x["content"],
            single_word=x.get("single_word", False),
            lstrip=x.get("lstrip", False),
            rstrip=x.get("rstrip", False),
            normalized=x.get("normalized", not special),
            special=x.get("special", special),
        )

    def to_json(self, idx: int) -> dict:
        return {
            "id": idx,
            "content": self.content,
            "single_word": self.single_word,
            "lstrip": self.lstrip,
            "rstrip": self.rstrip,
            "normalized": self.normalized,
            "special": self.special,
        }


@dataclass
class Encoding:
    ids: List[int] = field(default_factory=list)
    tokens: List[str] = field(default_factory=list)
    offsets: List[Tuple[int, int]] = field(default_factory=list)
    type_ids: List[int] = field(default_factory=list)
    attention_mask: List[int] = field(default_factory=list)
    special_tokens_mask: List[int] = field(default_factory=list)

    def __len__(self):
        return len(self.ids)

    def pad(self, length: int, pad_id: int, pad_token: str, pad_type_id: int = 0):
        n = length - len(self.ids)
        if n <= 0:
            return
        self.ids += [pad_id] * n
        self.tokens += [pad_token] * n
        self.offsets += [(0, 0)] * n
        self.type_ids += [pad_type_id] * n
        self.attention_mask += [0] * n
        self.special_tokens_mask += [1] * n

    def truncate(self, length: int):
        self.ids = self.ids[:length]
        self.tokens = self.tokens[:length]
        self.offsets = self.offsets[:length]
        self.type_ids = self.type_ids[:length]
        self.attention_mask = self.attention_mask[:length]
        self.special_tokens_mask = self.special_tokens_mask[:length]


class Tokenizer:
    def __init__(
        self,
        model: _models.Model,
        normalizer: Optional[_normalizers.Normalizer] = None,
        pre_tokenizer: Optional[_pretok.PreTokenizer] = None,
        post_processor: Optional[_post.PostProcessor] = None,
        decoder: Optional[_decoders.Decoder] = None,
    ):
        self.model = model
        self.normalizer = normalizer
        self.pre_tokenizer = pre_tokenizer
        self.post_processor = post_processor
        self.decoder = decoder
        # content -> (id, AddedToken)
        self._added: Dict[str, Tuple[int, AddedToken]] = {}
        self._added_rx = None
        self._padding = None  # dict(pad_id, pad_token, pad_type_id, length|None ('longest'))
        self._truncation = None  # dict(max_length)

    # ------------------------------------------------------------------ vocab
    def get_vocab(self, with_added_tokens: bool = True) -> Dict[str, int]:
        vocab = dict(self.model.get_vocab())
        if with_added_tokens:
            for content, (idx, _) in self._added.items():
                vocab.setdefault(content, idx)
        return vocab

    def get_vocab_size(self, with_added_tokens: bool = True) -> int:
        vocab = self.get_vocab(with_added_tokens)
        return max(vocab.values()) + 1 if vocab else 0

    def token_to_id(self, token: str) -> Optional[int]:
        hit = self._added.get(token)
        if hit is not None:
            return hit[0]
        return self.model.token_to_id(token)

    def id_to_token(self, idx: int) -> Optional[str]:
        for content, (i, _) in self._added.items():
            if i == idx:
                return content
        return self.model.id_to_token(idx)

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.id_to_token(i) for i in ids]

    # ----------------------------------------------------------- added tokens
    def add_tokens(self, tokens: Sequence, special: bool = False) -> int:
        n_added = 0
        next_id = self.get_vocab_size(with_added_tokens=True)
        for t in tokens:
            at = AddedToken.from_any(t, special=special)
            at.special = at.special or special
            if at.content in self._added:
                # upgrade to special if requested
                idx, old = self._added[at.content]
                if special and not old.special:
                    self._added[at.content] = (idx, at)
                continue
            existing = self.model.token_to_id(at.content)
            idx = existing if existing is not None else next_id
            if existing is None:
                next_id += 1
                n_added += 1
            self._added[at.content] = (idx, at)
        self._added_rx = None
        return n_added

    def add_special_tokens(self, tokens: Sequence) -> int:
        return self.add_tokens(tokens, special=True)

    def register_added_token(self, at: AddedToken, idx: int):
        """Register an added token at an explicit id."""
        self._added[at.content] = (idx, at)
        self._added_rx = None

    @property
    def added_tokens(self) -> List[Tuple[int, AddedToken]]:
        return sorted(((i, at) for i, at in self._added.values()), key=lambda x: x[0])

    def get_added_tokens_decoder(self) -> Dict[int, AddedToken]:
        return {i: at for i, at in self._added.values()}

    def _compiled_added_rx(self):
        if self._added_rx is None and self._added:
            contents = sorted(self._added.keys(), key=len, reverse=True)
            self._added_rx = re.compile("|".join(re.escape(c) for c in contents))
        return self._added_rx

    def _split_added(self, text: str) -> List[Tuple[str, Optional[str]]]:
        """Split text into (segment, matched_added_content|None) pieces."""
        rx = self._compiled_added_rx()
        if rx is None:
            return [(text, None)]
        out: List[Tuple[str, Optional[str]]] = []
        pos = 0
        for m in rx.finditer(text):
            s, e = m.start(), m.end()
            content = m.group()
            _, at = self._added[content]
            if at.single_word:
                before_ok = s == 0 or not is_word(text[s - 1])
                after_ok = e == len(text) or not is_word(text[e])
                if not (before_ok and after_ok):
                    continue
            if at.lstrip:
                while s > 0 and text[s - 1].isspace():
                    s -= 1
            if at.rstrip:
                while e < len(text) and text[e].isspace():
                    e += 1
            if s < pos:
                s = m.start()
                if s < pos:
                    continue
            if pos < s:
                out.append((text[pos:s], None))
            out.append((content, content))
            pos = e
        if pos < len(text):
            out.append((text[pos:], None))
        return out

    # ---------------------------------------------------------------- encode
    def num_special_tokens_to_add(self, is_pair: bool = False) -> int:
        if self.post_processor is None:
            return 0
        return self.post_processor.num_special_tokens_to_add(is_pair)

    def _encode_core(self, text: str) -> Tuple[List[int], List[str], List[Tuple[int, int]]]:
        """Normalize, split on added tokens, pretokenize, run the model."""
        ids: List[int] = []
        tokens: List[str] = []
        offsets: List[Tuple[int, int]] = []
        norm_shift = 0
        for segment, added in self._split_added(text):
            if added is not None:
                idx, _ = self._added[added]
                ids.append(idx)
                tokens.append(added)
                offsets.append((0, len(added)))
                continue
            normalized = (
                self.normalizer.normalize_str(segment) if self.normalizer else segment
            )
            # offset correction for length-changing normalizers (approximate:
            # assume prefix insertion, the common Prepend/Metaspace case)
            shift = len(segment) - len(normalized)
            if self.pre_tokenizer is not None:
                pretokens = self.pre_tokenizer.pre_tokenize_str(normalized)
            else:
                pretokens = [(normalized, (0, len(normalized)))] if normalized else []
            for pretoken, (s, e) in pretokens:
                for tid, tok in self.model.tokenize(pretoken):
                    ids.append(tid)
                    tokens.append(tok)
                    offsets.append((max(s + shift, 0), max(e + shift, 0)))
        return ids, tokens, offsets

    def encode(
        self,
        text: str,
        pair: Optional[str] = None,
        add_special_tokens: bool = True,
    ) -> Encoding:
        ids, tokens, offsets = self._encode_core(text)
        pair_enc = None
        if pair is not None:
            pair_enc = self._encode_core(pair)
        # truncation happens pre-postprocessing, reserving room for specials
        if self._truncation is not None:
            budget = self._truncation["max_length"]
            if add_special_tokens:
                budget -= self.num_special_tokens_to_add(pair is not None)
            budget = max(budget, 0)
            ids, tokens, offsets = ids[:budget], tokens[:budget], offsets[:budget]
            if pair_enc is not None:
                p_ids, p_tokens, p_offsets = pair_enc
                pair_enc = (p_ids[:budget], p_tokens[:budget], p_offsets[:budget])
        if self.post_processor is not None:
            ids, tokens, offsets, type_ids, special_mask = self.post_processor.process(
                ids, tokens, offsets, pair_enc, add_special_tokens
            )
        else:
            if pair_enc is not None:
                ids += pair_enc[0]
                tokens += pair_enc[1]
                offsets += pair_enc[2]
            type_ids = [0] * len(ids)
            special_mask = [0] * len(ids)
        # mark added special tokens in the mask even without a post-processor
        special_ids = {i for i, at in self._added.values() if at.special}
        special_mask = [
            1 if (m or i in special_ids) else 0 for m, i in zip(special_mask, ids)
        ]
        enc = Encoding(
            ids=ids,
            tokens=tokens,
            offsets=offsets,
            type_ids=type_ids,
            attention_mask=[1] * len(ids),
            special_tokens_mask=special_mask,
        )
        if self._truncation is not None:
            enc.truncate(self._truncation["max_length"])
        if self._padding is not None and self._padding.get("length") is not None:
            p = self._padding
            enc.pad(p["length"], p["pad_id"], p["pad_token"], p.get("pad_type_id", 0))
        return enc

    def encode_batch(
        self,
        inputs: Sequence,
        add_special_tokens: bool = True,
    ) -> List[Encoding]:
        encs = []
        for item in inputs:
            if isinstance(item, (tuple, list)):
                encs.append(self.encode(item[0], item[1], add_special_tokens))
            else:
                encs.append(self.encode(item, add_special_tokens=add_special_tokens))
        if self._padding is not None and self._padding.get("length") is None:
            longest = max((len(e) for e in encs), default=0)
            p = self._padding
            for e in encs:
                e.pad(longest, p["pad_id"], p["pad_token"], p.get("pad_type_id", 0))
        return encs

    def enable_truncation(self, max_length: int, **_):
        self._truncation = {"max_length": max_length}

    def no_truncation(self):
        self._truncation = None

    def enable_padding(
        self,
        length: Optional[int] = None,
        pad_id: int = 0,
        pad_token: str = "[PAD]",
        pad_type_id: int = 0,
        **_,
    ):
        self._padding = {
            "length": length,
            "pad_id": pad_id,
            "pad_token": pad_token,
            "pad_type_id": pad_type_id,
        }

    def no_padding(self):
        self._padding = None

    # ---------------------------------------------------------------- decode
    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        special_ids = {i for i, at in self._added.values() if at.special}
        tokens = []
        for i in ids:
            if skip_special_tokens and i in special_ids:
                continue
            tok = self.id_to_token(int(i))
            if tok is not None:
                tokens.append(tok)
        if self.decoder is not None:
            return self.decoder.decode(tokens)
        return " ".join(tokens)

    def decode_batch(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    # ----------------------------------------------------------------- (de)ser
    def to_json(self) -> dict:
        return {
            "version": "1.0",
            "truncation": None,
            "padding": None,
            "added_tokens": [at.to_json(i) for i, at in self.added_tokens],
            "normalizer": self.normalizer.to_json() if self.normalizer else None,
            "pre_tokenizer": self.pre_tokenizer.to_json() if self.pre_tokenizer else None,
            "post_processor": self.post_processor.to_json() if self.post_processor else None,
            "decoder": self.decoder.to_json() if self.decoder else None,
            "model": self.model.to_json(),
        }

    def to_str(self, pretty: bool = False) -> str:
        return json.dumps(self.to_json(), indent=2 if pretty else None, ensure_ascii=False)

    def save(self, path: str, pretty: bool = True):
        with open(path, "w") as f:
            f.write(self.to_str(pretty))

    @staticmethod
    def from_json(data: dict) -> "Tokenizer":
        tok = Tokenizer(
            model=_models.Model.from_json(data["model"]),
            normalizer=_normalizers.Normalizer.from_json(data.get("normalizer")),
            pre_tokenizer=_pretok.PreTokenizer.from_json(data.get("pre_tokenizer")),
            post_processor=_post.PostProcessor.from_json(data.get("post_processor")),
            decoder=_decoders.Decoder.from_json(data.get("decoder")),
        )
        for at_json in data.get("added_tokens", []):
            tok.register_added_token(AddedToken.from_any(at_json), at_json["id"])
        return tok

    @staticmethod
    def from_str(s: str) -> "Tokenizer":
        # parse floats from their raw decimal bytes with serde_json
        # semantics (see jsonfloat.serde_parse_float): for files holding
        # non-shortest literals this is the only way to land on the exact
        # doubles HF holds after its own serde_json load
        from .jsonfloat import serde_parse_float

        return Tokenizer.from_json(json.loads(s, parse_float=serde_parse_float))

    @staticmethod
    def from_file(path: str) -> "Tokenizer":
        with open(path) as f:
            return Tokenizer.from_str(f.read())

    def copy(self) -> "Tokenizer":
        data = self.to_json()
        # the model's JSON is built anew by to_json but for a BPE's or
        # WordPiece's vocab dict, its own: copied here, not deep-copied
        # element by element (250k pieces take a second)
        model = data.pop("model")
        if isinstance(model.get("vocab"), dict):
            model["vocab"] = dict(model["vocab"])
        data = copy.deepcopy(data)
        data["model"] = model
        return Tokenizer.from_json(data)

    def __len__(self) -> int:
        return self.get_vocab_size(with_added_tokens=True)

    @property
    def all_special_tokens(self) -> List[str]:
        return [at.content for _, at in self.added_tokens if at.special]

    @property
    def all_special_ids(self) -> List[int]:
        return [i for i, at in self.added_tokens if at.special]
