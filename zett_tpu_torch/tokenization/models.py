"""Tokenization models: Unigram (lattice Viterbi), BPE (ranked merges) and
WordPiece (greedy longest match), in pure Python.

Counterpart of ``zett_tpu/tokenization/models.py``; the native host
library (``csrc/``) runs the same Unigram and BPE algorithms for canonical
byte-level tokenizers (``fast_encode.py``).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from ..constants import UNK_PENALTY


class Model:
    def tokenize(self, pretoken: str) -> List[Tuple[int, str]]:
        """Segment one pretoken into a list of (token_id, token_str)."""
        raise NotImplementedError

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


class _Trie:
    """Char trie for common-prefix search over the vocab."""

    __slots__ = ("children", "token_id")

    def __init__(self):
        self.children: Dict[str, _Trie] = {}
        self.token_id: Optional[int] = None

    def insert(self, token: str, token_id: int):
        node = self
        for c in token:
            nxt = node.children.get(c)
            if nxt is None:
                nxt = node.children[c] = _Trie()
            node = nxt
        node.token_id = token_id

    def prefix_matches(self, text: str, start: int) -> List[Tuple[int, int]]:
        """All (end_pos, token_id) for vocab tokens that prefix text[start:]."""
        out = []
        node = self
        i = start
        n = len(text)
        while i < n:
            node = node.children.get(text[i])
            if node is None:
                break
            i += 1
            if node.token_id is not None:
                out.append((i, node.token_id))
        return out


class Unigram(Model):
    """Unigram LM tokenizer: maximize the sum of piece log-probs (Viterbi).

    Ties go as in sentencepiece/HF and JAX: strict improvement only,
    scanning begin positions in ascending order per end position. An
    unknown character gets min_score - UNK_PENALTY; with byte_fallback it
    becomes its <0xNN> pieces where the vocab has them all, else unk, and
    consecutive unknowns fuse when fuse_unk is set (the default with an
    unk_id).
    """

    def __init__(
        self,
        vocab: Sequence[Tuple[str, float]],
        unk_id: Optional[int] = None,
        byte_fallback: bool = False,
        fuse_unk: Optional[bool] = None,
    ):
        self.pieces: List[Tuple[str, float]] = [(str(p), float(s)) for p, s in vocab]
        self.unk_id = unk_id
        self.byte_fallback = byte_fallback
        self.fuse_unk = fuse_unk if fuse_unk is not None else unk_id is not None
        self._vocab: Dict[str, int] = {}
        for i, (piece, _) in enumerate(self.pieces):
            self._vocab.setdefault(piece, i)  # first occurrence wins, like HF
        self.min_score = min([0.0] + [s for _, s in self.pieces])
        self._unk_score = self.min_score - UNK_PENALTY
        self._trie: Optional[_Trie] = None  # built at the first tokenize
        self._inv_vocab: Dict[int, str] = {}

    def get_scores(self) -> List[float]:
        return [s for _, s in self.pieces]

    def get_vocab(self) -> Dict[str, int]:
        return self._vocab

    def _lattice(self, text: str):
        """edges[end] = list of (begin, token_id, score); unk edges id=-1."""
        if self._trie is None:
            self._trie = _Trie()
            for piece, i in self._vocab.items():
                self._trie.insert(piece, i)
        n = len(text)
        edges: List[List[Tuple[int, int, float]]] = [[] for _ in range(n + 1)]
        pieces = self.pieces
        for begin in range(n):
            matches = self._trie.prefix_matches(text, begin)
            has_single = any(e == begin + 1 for e, _ in matches)
            for end, tid in matches:
                edges[end].append((begin, tid, pieces[tid][1]))
            if not has_single:
                edges[begin + 1].append((begin, -1, self._unk_score))
        return edges

    def tokenize(self, pretoken: str) -> List[Tuple[int, str]]:
        if not pretoken:
            return []
        n = len(pretoken)
        edges = self._lattice(pretoken)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        for end in range(1, n + 1):
            for begin, tid, score in edges[end]:
                cand = best[begin] + score
                if cand > best[end]:
                    best[end] = cand
                    back[end] = (begin, tid)
        rev: List[Tuple[int, str]] = []
        pos = n
        while pos > 0:
            begin, tid = back[pos]
            rev.append((tid, pretoken[begin:pos]))
            pos = begin
        rev.reverse()
        return self._resolve_unknowns(rev)

    def _resolve_unknowns(self, segs: List[Tuple[int, str]]) -> List[Tuple[int, str]]:
        out: List[Tuple[int, str]] = []
        for tid, piece in segs:
            if tid != -1:
                out.append((tid, piece))
                continue
            if self.byte_fallback:
                fallback = [(self._vocab.get(f"<0x{b:02X}>"), f"<0x{b:02X}>")
                            for b in piece.encode("utf-8")]
                if all(bid is not None for bid, _ in fallback):
                    out.extend(fallback)
                    continue
            if self.fuse_unk and out and self.unk_id is not None and out[-1][0] == self.unk_id:
                out[-1] = (self.unk_id, out[-1][1] + piece)
            else:
                out.append((self.unk_id if self.unk_id is not None else -1, piece))
        return out

    def to_json(self) -> dict:
        return {
            "type": "Unigram",
            "unk_id": self.unk_id,
            "vocab": [[p, s] for p, s in self.pieces],
            "byte_fallback": self.byte_fallback,
        }


def _merge(parts: List[str], ranks) -> List[str]:
    """The JAX package's merge loop (while any adjacent pair has a rank,
    merge every occurrence of the lowest-ranked pair, left to right), in
    O(n log n) rather than its O(n^2): a pretoken of a BPE without a
    pre-tokenizer (Llama's metaspace BPE) is a whole text. The symbols sit
    in a linked list, the ranked adjacent pairs on a heap of (rank,
    position). A round pops every entry of the lowest rank (one rank is one
    pair) and merges its occurrences that are still adjacent, left to
    right, skipping one that overlaps a merge of the round, as the loop
    does. A merge cannot make another occurrence of its own pair (that
    would need a symbol equal to the merged one's half), so a round sees
    the loop's occurrences."""
    n = len(parts)
    sym = list(parts)
    nxt = list(range(1, n + 1))
    prv = list(range(-1, n - 1))
    alive = [True] * n
    heap = [(r, i) for i in range(n - 1) if (r := ranks.get((sym[i], sym[i + 1]))) is not None]
    heapq.heapify(heap)
    while heap:
        rank = heap[0][0]
        starts = []
        while heap and heap[0][0] == rank:
            starts.append(heapq.heappop(heap)[1])
        starts.sort()
        for i in starts:
            j = nxt[i] if alive[i] else n
            if j >= n or ranks.get((sym[i], sym[j])) != rank:
                continue  # merged away, or no longer this pair
            sym[i] = sym[i] + sym[j]
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] < n:
                prv[nxt[i]] = i
            for a, b in ((prv[i], i), (i, nxt[i])):
                if a >= 0 and b < n:
                    r = ranks.get((sym[a], sym[b]))
                    if r is not None:
                        heapq.heappush(heap, (r, a))
    return [sym[i] for i in range(n) if alive[i]]


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
        self._cache: Dict[str, List[str]] = {}

    def get_vocab(self) -> Dict[str, int]:
        return self.vocab

    def _merge_word(self, word: str) -> List[str]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        if self.ignore_merges and word in self.vocab:
            self._cache[word] = [word]
            return [word]
        csp = self.continuing_subword_prefix
        parts = list(word)
        if csp and parts:
            parts = [parts[0]] + [csp + c for c in parts[1:]]
        if self.end_of_word_suffix and parts:
            parts[-1] = parts[-1] + self.end_of_word_suffix
        parts = _merge(parts, self._ranks)
        if len(self._cache) < 65536:
            self._cache[word] = parts
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
    """Greedy longest-match-first segmentation with a continuation prefix."""

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

    def tokenize(self, pretoken: str) -> List[Tuple[int, str]]:
        unk_id = self.vocab.get(self.unk_token)
        unk = [(unk_id, self.unk_token)] if unk_id is not None else []
        if len(pretoken) > self.max_input_chars_per_word:
            return unk
        out: List[Tuple[int, str]] = []
        start, n = 0, len(pretoken)
        while start < n:
            end = n
            found = None
            while end > start:
                sub = pretoken[start:end]
                if start > 0:
                    sub = self.continuing_subword_prefix + sub
                tid = self.vocab.get(sub)
                if tid is not None:
                    found = (tid, sub)
                    break
                end -= 1
            if found is None:
                return unk
            out.append(found)
            start = end
        return out

    def to_json(self) -> dict:
        return {
            "type": "WordPiece",
            "unk_token": self.unk_token,
            "continuing_subword_prefix": self.continuing_subword_prefix,
            "max_input_chars_per_word": self.max_input_chars_per_word,
            "vocab": self.vocab,
        }
