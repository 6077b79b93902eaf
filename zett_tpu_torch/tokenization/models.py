"""Tokenization models of the transfer path: BPE (whose ``tokenize`` segments
surface forms), Unigram and WordPiece (vocab and scores only).

Counterpart of ``zett_tpu/tokenization/models.py``. Transfer never encodes
text, so Unigram Viterbi and WordPiece segmentation are not carried over.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class Model:
    def tokenize(self, pretoken: str) -> List[Tuple[int, str]]:
        """Segment one pretoken into a list of (token_id, token_str)."""
        raise NotImplementedError(f"{type(self).__name__}.tokenize is not ported")

    def get_vocab(self) -> Dict[str, int]:
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError

    def id_to_token(self, idx: int) -> Optional[str]:
        vocab = self.get_vocab()
        if len(self._inv_vocab) != len(vocab):
            self._inv_vocab = {v: k for k, v in vocab.items()}
        return self._inv_vocab.get(idx)

    def token_to_id(self, token: str) -> Optional[int]:
        return self.get_vocab().get(token)

    @staticmethod
    def from_json(data: dict) -> "Model":
        t = data["type"]
        if t == "Unigram":
            # hold the scores HF holds (serde_json parsing, see jsonfloat.py)
            from .jsonfloat import serde_canon

            pieces = [p for p, _ in data["vocab"]]
            scores = serde_canon([s for _, s in data["vocab"]])
            return Unigram(
                list(zip(pieces, scores)),
                unk_id=data.get("unk_id"),
                byte_fallback=data.get("byte_fallback", False),
            )
        if t == "BPE":
            merges = []
            for m in data.get("merges", []):
                if isinstance(m, str):
                    a, b = m.split(" ")
                else:
                    a, b = m
                merges.append((a, b))
            return BPE(
                data["vocab"],
                merges,
                unk_token=data.get("unk_token"),
                continuing_subword_prefix=data.get("continuing_subword_prefix") or "",
                end_of_word_suffix=data.get("end_of_word_suffix") or "",
                fuse_unk=data.get("fuse_unk", False),
                byte_fallback=data.get("byte_fallback", False),
                ignore_merges=data.get("ignore_merges", False),
            )
        if t == "WordPiece":
            return WordPiece(
                data["vocab"],
                unk_token=data.get("unk_token", "[UNK]"),
                continuing_subword_prefix=data.get("continuing_subword_prefix", "##"),
                max_input_chars_per_word=data.get("max_input_chars_per_word", 100),
            )
        raise ValueError(f"Unsupported model type: {t}")


class Unigram(Model):
    """Unigram LM vocab: (piece, log-prob score) pairs."""

    def __init__(
        self,
        vocab: Sequence[Tuple[str, float]],
        unk_id: Optional[int] = None,
        byte_fallback: bool = False,
    ):
        self.pieces: List[Tuple[str, float]] = [(str(p), float(s)) for p, s in vocab]
        self.unk_id = unk_id
        self.byte_fallback = byte_fallback
        self._vocab: Dict[str, int] = {}
        for i, (piece, _) in enumerate(self.pieces):
            self._vocab.setdefault(piece, i)  # first occurrence wins, like HF
        self._inv_vocab: Dict[int, str] = {}

    def get_scores(self) -> List[float]:
        return [s for _, s in self.pieces]

    def get_vocab(self) -> Dict[str, int]:
        return self._vocab

    def to_json(self) -> dict:
        return {
            "type": "Unigram",
            "unk_id": self.unk_id,
            "vocab": [[p, s] for p, s in self.pieces],
            "byte_fallback": self.byte_fallback,
        }


class BPE(Model):
    """Byte-pair encoding with ranked merges (GPT-2 semantics)."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        unk_token: Optional[str] = None,
        continuing_subword_prefix: str = "",
        end_of_word_suffix: str = "",
        fuse_unk: bool = False,
        byte_fallback: bool = False,
        ignore_merges: bool = False,
    ):
        self.vocab = dict(vocab)
        self.merges = [tuple(m) for m in merges]
        self.unk_token = unk_token
        self.continuing_subword_prefix = continuing_subword_prefix
        self.end_of_word_suffix = end_of_word_suffix
        self.fuse_unk = fuse_unk
        self.byte_fallback = byte_fallback
        self.ignore_merges = ignore_merges
        self._ranks = {m: i for i, m in enumerate(self.merges)}
        self._inv_vocab: Dict[int, str] = {}

    def get_vocab(self) -> Dict[str, int]:
        return self.vocab

    def _merge_word(self, word: str) -> List[str]:
        if self.ignore_merges and word in self.vocab:
            return [word]
        csp = self.continuing_subword_prefix
        parts = list(word)
        if csp and parts:
            parts = [parts[0]] + [csp + c for c in parts[1:]]
        if self.end_of_word_suffix and parts:
            parts[-1] = parts[-1] + self.end_of_word_suffix
        ranks = self._ranks
        while len(parts) > 1:
            best_rank = None
            best_pair = None
            for a, b in zip(parts, parts[1:]):
                r = ranks.get((a, b))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_pair = (a, b)
            if best_pair is None:
                break
            a, b = best_pair
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and parts[i] == a and parts[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        return parts

    def tokenize(self, pretoken: str) -> List[Tuple[int, str]]:
        out: List[Tuple[int, str]] = []
        unk_id = self.vocab.get(self.unk_token) if self.unk_token is not None else None
        for part in self._merge_word(pretoken):
            tid = self.vocab.get(part)
            if tid is not None:
                out.append((tid, part))
                continue
            if self.byte_fallback:
                ids = [self.vocab.get(f"<0x{b:02X}>") for b in part.encode("utf-8")]
                if all(i is not None for i in ids):
                    out.extend((i, f"<0x{b:02X}>") for i, b in zip(ids, part.encode("utf-8")))
                    continue
            if unk_id is not None:
                if self.fuse_unk and out and out[-1][0] == unk_id:
                    out[-1] = (unk_id, out[-1][1] + part)
                else:
                    out.append((unk_id, part))
            # else: dropped, as the JAX package does (byte-complete vocabs)
        return out

    def to_json(self) -> dict:
        return {
            "type": "BPE",
            "dropout": None,
            "unk_token": self.unk_token,
            "continuing_subword_prefix": self.continuing_subword_prefix or None,
            "end_of_word_suffix": self.end_of_word_suffix or None,
            "fuse_unk": self.fuse_unk,
            "byte_fallback": self.byte_fallback,
            "ignore_merges": self.ignore_merges,
            "vocab": self.vocab,
            "merges": [list(m) for m in self.merges],
        }


class WordPiece(Model):
    """WordPiece vocab (greedy segmentation is not ported)."""

    def __init__(
        self,
        vocab: Dict[str, int],
        unk_token: str = "[UNK]",
        continuing_subword_prefix: str = "##",
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = dict(vocab)
        self.unk_token = unk_token
        self.continuing_subword_prefix = continuing_subword_prefix
        self.max_input_chars_per_word = max_input_chars_per_word
        self._inv_vocab: Dict[int, str] = {}

    def get_vocab(self) -> Dict[str, int]:
        return self.vocab

    def to_json(self) -> dict:
        return {
            "type": "WordPiece",
            "unk_token": self.unk_token,
            "continuing_subword_prefix": self.continuing_subword_prefix,
            "max_input_chars_per_word": self.max_input_chars_per_word,
            "vocab": self.vocab,
        }
