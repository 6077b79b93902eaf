"""ctypes bindings for the native host library (``zett_host.cpp``, a copy
of ``zett_tpu/csrc/zett_host.cpp``).

The shared object is built with ``g++ -O3`` from this directory's source
into ``build/zett_tpu_torch/`` at the root of the checkout at first use
(rebuilt when the source is newer), never into the source tree and never at
import; a failed build raises. Exposes what the training data path needs:

- ``NativeUnigram`` / ``NativeBPE``: fused split-regex pre-tokenization and
  Viterbi (Unigram) or ranked-merge (BPE) encode of whole utf-8 texts;
- ``count_substrings_texts_native`` / ``merge_counts``: the tokenizer
  sampler's substring counting and its sliding-window merge;
- ``NativeUnigram.encode_pretokens`` / ``encode_flat`` /
  ``score_pretokens``: Viterbi of single pretokens (the device prior
  pipeline's oracle and overlong tail), ``split_pretokens_native``: the
  GPT-2-regex split alone, ``bucket4_build_native``: the device
  retokenizer's vocab table, ``NativeAhoCorasick`` / ``substring_counts``:
  the substring prior's multi-pattern counting.

All interfaces speak raw bytes; byte-char conversion happens at the caller.
The native pre-tokenizer reads a Unicode class table
(``unicode_classes_v1.npy``, one byte per code point: 1 = \\s, 2 = \\p{L},
4 = \\p{M}, 8 = \\p{N}) shipped beside the source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "zett_host.cpp")
_CTAB_PATH = os.path.join(_DIR, "unicode_classes_v1.npy")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "zett_tpu_torch")

LETTERS_WITH_MARKS = 2 | 4  # [\p{L}\p{M}] branch (SPLIT_REGEX)
LETTERS_NO_MARKS = 2  # \p{L} branch (SPLIT_REGEX_NO_MARKS)

_LIB: Optional[ctypes.CDLL] = None
_CTAB: Optional[np.ndarray] = None


def lib_path() -> str:
    return os.path.join(BUILD_DIR, "libzett_host.so")


def build() -> str:
    """Compile the library if it is missing or older than its source.
    Returns its path; raises with the compiler's output on failure."""
    so = lib_path()
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(_SRC):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-o", tmp, _SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError("g++ not found: the native host library cannot be built") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.uni_new.restype = p
    lib.uni_new.argtypes = [p, p, p, i64, i32, ctypes.c_double, i64]
    lib.uni_free.argtypes = [p]
    lib.uni_encode_texts.restype = i64
    lib.uni_encode_texts.argtypes = [p, p, p, i64, p, i32, p, i64, p, i32]
    lib.bpe_new.restype = p
    lib.bpe_new.argtypes = [p, p, p, i64, p, p, p, i64, i32, i32]
    lib.bpe_free.argtypes = [p]
    lib.bpe_encode_texts.restype = i64
    lib.bpe_encode_texts.argtypes = [p, p, p, i64, p, i32, p, i64, p, i32]
    lib.count_substrings_texts.restype = p
    lib.count_substrings_texts.argtypes = [p, p, i64, p, p, i32, i32, i32]
    lib.countmap_merge.restype = p
    lib.countmap_merge.argtypes = [p, i64]
    lib.countmap_size.restype = i64
    lib.countmap_size.argtypes = [p]
    lib.countmap_serialize.restype = i64
    lib.countmap_serialize.argtypes = [p, p, p, p]
    lib.countmap_free.argtypes = [p]
    lib.uni_encode_batch.restype = i64
    lib.uni_encode_batch.argtypes = [p, p, p, i64, p, i64, p]
    lib.uni_encode_batch_threaded.restype = i64
    lib.uni_encode_batch_threaded.argtypes = [p, p, p, i64, p, i64, p, i32]
    lib.uni_score_batch.argtypes = [p, p, p, i64, p]
    lib.split_pretokens.restype = i64
    lib.split_pretokens.argtypes = [p, i64, p, i32, p, i64]
    lib.bucket4_build.restype = i32
    lib.bucket4_build.argtypes = [p, p, p, i64, i64, ctypes.c_uint32, p, p]
    lib.ac_new.restype = p
    lib.ac_new.argtypes = [p, p, p, i64]
    lib.ac_free.argtypes = [p]
    lib.ac_count.argtypes = [p, p, p, i64, p, p]


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(build())
        _bind(handle)
        _LIB = handle
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def unicode_class_table() -> np.ndarray:
    global _CTAB
    if _CTAB is None:
        tab = np.load(_CTAB_PATH)
        if tab.shape != (0x110000,) or tab.dtype != np.uint8:
            raise ValueError(f"{_CTAB_PATH}: not a (0x110000,) uint8 class table")
        _CTAB = np.ascontiguousarray(tab)
    return _CTAB


def _concat_bytes(items: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in items], out=offsets[1:])
    data = np.frombuffer(b"".join(items), dtype=np.uint8).copy()
    if len(data) == 0:
        data = np.zeros(1, dtype=np.uint8)
    return data, offsets


def _encode_texts(fn, handle, texts: Sequence[bytes], use_marks: bool, n_threads: int):
    ctab = unicode_class_table()
    data, offsets = _concat_bytes(texts)
    cap = max(int(offsets[-1]), 1)
    out_ids = np.empty(cap, dtype=np.int32)
    out_tokens = np.empty(len(texts), dtype=np.int64)
    if n_threads == 0:
        n_threads = min(os.cpu_count() or 1, 8)
    total = fn(handle, _ptr(data), _ptr(offsets), len(texts), _ptr(ctab),
               LETTERS_WITH_MARKS if use_marks else LETTERS_NO_MARKS,
               _ptr(out_ids), cap, _ptr(out_tokens), n_threads)
    if total < 0:
        raise RuntimeError("native encode: output capacity exceeded")
    return out_ids[:total], out_tokens


class NativeUnigram:
    """Byte-level Unigram Viterbi over a trie, with a memo cache."""

    def __init__(self, pieces: Sequence[bytes], scores: Sequence[float], unk_id: int = -1,
                 unk_penalty: float = 10.0, cache_cap: int = 1 << 20):
        self._lib = lib()
        data, offsets = _concat_bytes(pieces)
        scores_arr = np.asarray(scores, dtype=np.float64)
        self._data = data  # keep alive
        self._handle = self._lib.uni_new(_ptr(data), _ptr(offsets), _ptr(scores_arr),
                                         len(pieces), unk_id, unk_penalty, cache_cap)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.uni_free(self._handle)
            self._handle = None

    def encode_texts(self, texts: Sequence[bytes], use_marks: bool = True,
                     n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """(flat_ids, tokens_per_text) of whole utf-8 texts."""
        return _encode_texts(self._lib.uni_encode_texts, self._handle, texts, use_marks,
                             n_threads)

    def encode_pretokens(self, pretokens: Sequence[bytes]) -> List[np.ndarray]:
        """Each pretoken encoded on its own: a list of int32 id arrays (-1
        where a byte has no piece)."""
        ids, lens = self._encode_batch(pretokens, 0)
        return np.split(ids, np.cumsum(lens[:-1]))

    def encode_flat(self, pretokens: Sequence[bytes], n_threads: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(flat_ids, ids_per_pretoken) of ``encode_pretokens``, without the
        per-pretoken split, on ``n_threads`` threads (0: from the CPU count)."""
        return self._encode_batch(pretokens, n_threads or min(os.cpu_count() or 1, 8))

    def _encode_batch(self, pretokens, n_threads):
        data, offsets = _concat_bytes(pretokens)
        cap = max(int(offsets[-1]), 1)
        out_ids = np.empty(cap, dtype=np.int32)
        out_lens = np.empty(len(pretokens), dtype=np.int32)
        args = (self._handle, _ptr(data), _ptr(offsets), len(pretokens), _ptr(out_ids), cap,
                _ptr(out_lens))
        if n_threads:
            total = self._lib.uni_encode_batch_threaded(*args, n_threads)
        else:
            total = self._lib.uni_encode_batch(*args)
        if total < 0:
            raise RuntimeError("native encode: output capacity exceeded")
        return out_ids[:total], out_lens

    def score_pretokens(self, pretokens: Sequence[bytes]) -> np.ndarray:
        """Score (f64 sum of piece scores) of each pretoken's best
        segmentation."""
        data, offsets = _concat_bytes(pretokens)
        out = np.empty(len(pretokens), dtype=np.float64)
        self._lib.uni_score_batch(self._handle, _ptr(data), _ptr(offsets), len(pretokens),
                                  _ptr(out))
        return out


def split_pretokens_native(text: bytes, use_marks: bool = True) -> List[bytes]:
    """The native GPT-2-regex split of one utf-8 text into raw-byte
    pretokens."""
    if not text:
        return []
    data = np.frombuffer(text, dtype=np.uint8).copy()
    ends = np.empty(len(text), dtype=np.int64)
    n = lib().split_pretokens(_ptr(data), len(text), _ptr(unicode_class_table()),
                              LETTERS_WITH_MARKS if use_marks else LETTERS_NO_MARKS,
                              _ptr(ends), len(ends))
    if n < 0:
        raise RuntimeError("native split: output capacity exceeded")
    starts = [0, *ends[:n - 1].tolist()]
    return [text[a:b] for a, b in zip(starts, ends[:n].tolist())]


def bucket4_build_native(pieces: Sequence[bytes], scores: Sequence[float], M: int,
                         salt: int) -> Optional[Tuple[np.ndarray, int]]:
    """The device retokenizer's bucket-4 vocab table: ((M, 16) int32,
    max_piece_len), or None when a bucket overflows (the caller bumps the
    salt or doubles M)."""
    data, offsets = _concat_bytes(pieces)
    scores_arr = np.asarray(scores, dtype=np.float32)
    table = np.empty((M, 16), dtype=np.int32)
    maxlen = np.zeros(1, dtype=np.int32)
    ok = lib().bucket4_build(_ptr(data), _ptr(offsets), _ptr(scores_arr), len(pieces), M,
                             salt, _ptr(table), _ptr(maxlen))
    return (table, int(maxlen[0])) if ok else None


class NativeAhoCorasick:
    """Aho-Corasick automaton over byte patterns, counting weighted
    occurrences into one slot per pattern value."""

    def __init__(self, patterns: Sequence[bytes], values: Sequence[int]):
        self._lib = lib()
        data, offsets = _concat_bytes(patterns)
        vals = np.asarray(values, dtype=np.int32)
        self._n_values = int(vals.max()) + 1 if len(vals) else 0
        self._handle = self._lib.ac_new(_ptr(data), _ptr(offsets), _ptr(vals), len(patterns))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.ac_free(self._handle)
            self._handle = None

    def count(self, texts: Sequence[bytes], weights: Sequence[int],
              n_out: Optional[int] = None) -> np.ndarray:
        data, offsets = _concat_bytes(texts)
        w = np.asarray(weights, dtype=np.int64)
        acc = np.zeros(n_out or self._n_values, dtype=np.int64)
        self._lib.ac_count(self._handle, _ptr(data), _ptr(offsets), len(texts), _ptr(w),
                           _ptr(acc))
        return acc


def substring_counts(vocab: Dict[str, int], pretoken_counts: Mapping[str, int],
                     acc: np.ndarray) -> None:
    """Add to ``acc`` how often each vocab token occurs as a substring of
    the pretokens, weighted by their counts (tokens and pretokens as str,
    matched on their utf-8 bytes)."""
    ac = NativeAhoCorasick([k.encode("utf-8") for k in vocab], list(vocab.values()))
    texts = [t.encode("utf-8") for t in pretoken_counts]
    acc += ac.count(texts, list(pretoken_counts.values()), n_out=len(acc))


class NativeBPE:
    """Byte-level BPE merge encode; merges are (left_id, right_id,
    merged_id) in rank order."""

    def __init__(self, pieces: Sequence[bytes], piece_ids: Sequence[int],
                 merges: Sequence[Tuple[int, int, int]], unk_id: int = -1,
                 ignore_merges: bool = False):
        self._lib = lib()
        data, offsets = _concat_bytes(pieces)
        ids_arr = np.asarray(piece_ids, dtype=np.int32)
        m = np.asarray(merges, dtype=np.int32).reshape(-1, 3)
        left, right, out = (np.ascontiguousarray(m[:, c]) for c in range(3))
        self._keep = (data, ids_arr, left, right, out)
        self._handle = self._lib.bpe_new(
            _ptr(data), _ptr(offsets), _ptr(ids_arr), len(pieces),
            _ptr(left), _ptr(right), _ptr(out), len(m), unk_id, 1 if ignore_merges else 0)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bpe_free(self._handle)
            self._handle = None

    def encode_texts(self, texts: Sequence[bytes], use_marks: bool = True,
                     n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        return _encode_texts(self._lib.bpe_encode_texts, self._handle, texts, use_marks,
                             n_threads)


class NativeCounts:
    """Owning wrapper around a native count map (one sampler batch)."""

    def __init__(self, handle):
        self._lib = lib()
        self._handle = handle

    def __len__(self) -> int:
        return int(self._lib.countmap_size(self._handle))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.countmap_free(self._handle)
            self._handle = None


def count_substrings_texts_native(texts: Sequence[bytes], weights: Sequence[int],
                                  max_length: int = 16, stride: int = 1,
                                  use_marks: bool = False) -> NativeCounts:
    """Fused split + substring enumeration over whole utf-8 texts (the
    sampler's counting stage): score += weight * byte-char utf-8 length."""
    handle_lib = lib()
    ctab = unicode_class_table()
    data, offsets = _concat_bytes(texts)
    w = np.asarray(weights, dtype=np.int32)
    handle = handle_lib.count_substrings_texts(
        _ptr(data), _ptr(offsets), len(texts), _ptr(w), _ptr(ctab),
        LETTERS_WITH_MARKS if use_marks else LETTERS_NO_MARKS, max_length, stride)
    return NativeCounts(handle)


def merge_counts(batches: Sequence[NativeCounts]) -> Tuple[bytes, np.ndarray, np.ndarray]:
    """Sum count maps natively: (keys_blob, key_offsets[n+1], values[n])."""
    handle_lib = lib()
    handles = (ctypes.c_void_p * len(batches))(*[b._handle for b in batches])
    merged = handle_lib.countmap_merge(handles, len(batches))
    try:
        n = handle_lib.countmap_size(merged)
        key_bytes = handle_lib.countmap_serialize(merged, None, None, None)
        keys = np.empty(max(key_bytes, 1), dtype=np.uint8)
        key_offsets = np.empty(n + 1, dtype=np.int64)
        values = np.empty(max(n, 1), dtype=np.uint64)
        handle_lib.countmap_serialize(merged, _ptr(keys), _ptr(key_offsets), _ptr(values))
        return keys.tobytes()[:key_bytes], key_offsets, values[:n]
    finally:
        handle_lib.countmap_free(merged)
