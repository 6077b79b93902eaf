"""The device-side batched Unigram Viterbi: retokenization and token
counting on the card (counterpart of ``zett_tpu/ops/device_viterbi.py``).

Pretokens are padded byte rows (B, L). The vocab is compiled on the host
into a bucket-4 hash table: (M, 16) int32 rows of four entries
[key1, key2, score_bits, piece_id], slot = fmix32(h1 ^ salt) % M, built
natively (``csrc/host_lib.bucket4_build_native``; ``_bucket4_build_py`` is
the Python reference, bit-identical). Double fingerprints of every (start,
length <= K) span are rolled, one table row is looked up per span and
compared against its four entries (``compute_span_scores``, PyTorch, as it
is XLA in JAX), and the DP runs over those span scores (kernel 6,
``ops/viterbi_dp.py``). On the card ``viterbi_device`` runs both in one
launch, ``viterbi_spans_dp`` (the fused entry point of
``csrc/viterbi_dp.cu``: the spans are computed in registers and never reach
device memory, and only spans inside the pretoken are looked up); on the
CPU it runs their plain composition. Backtracking and counting follow the
backpointer chains with PyTorch gathers.

Every function runs on the device of its input tensors, or takes a
``device`` argument that defaults to the card. PyTorch has no full uint32
arithmetic: the hashes run in int64 masked to 32 bits, with products split
into 16-bit halves where they would leave int64.

Differences from the JAX module, none of them visible in the results:
- ``count_tokens_device`` splits its pretoken rows over the ranks of a
  ``torch.distributed`` process group where one is given (``group``; the
  counterpart of the JAX version's ``mesh`` and its ``shard_map`` psum,
  ``:438-450``) and all-reduces the (V,) histogram: the counts are
  integers, so any split gives the same histogram. It accumulates in int64
  on the device, so the int32 chunking of the JAX version (whose TPU
  histogram is int32) has no counterpart; rows go through in fixed chunks
  for memory only.
- ``DeviceRetokenizer`` runs its width groups as a loop of launches, with
  no batch-size buckets (they existed for jit signatures) and no program
  cache; the reversed ids of all groups are concatenated on the device and
  fetched once.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..csrc import host_lib
from . import _build
from .viterbi_dp import _MAX_K, NEG, viterbi_dp_plain

_P1 = 0x01000193  # FNV-ish multipliers
_P2 = 0x85EBCA6B
_OFF1 = 0x811C9DC5
_OFF2 = 0x9E3779B9
_FMIX1 = 0x85EBCA6B
_FMIX2 = 0xC2B2AE35
_MASK32 = 0xFFFFFFFF
_CHUNK_ROWS = 1 << 20  # rows per device pass of count_tokens_device (memory only)


def _fingerprints(piece: bytes) -> Tuple[int, int]:
    h1, h2 = _OFF1, _OFF2
    for b in piece:
        h1 = (h1 * _P1 + b + 1) & _MASK32
        h2 = (h2 * _P2 + b + 1) & _MASK32
    if h1 == 0:
        h1 = 1
    return h1, h2


def _mix32(h: int) -> int:
    """murmur3 fmix32 avalanche."""
    h = int(h) & _MASK32
    h ^= h >> 16
    h = (h * _FMIX1) & _MASK32
    h ^= h >> 13
    h = (h * _FMIX2) & _MASK32
    h ^= h >> 16
    return h


class PackedTable:
    """Single-gather bucket-4 hash of pieces -> (score, id): ``table``
    (M, 16) int32, four entries of [key1, key2, score_bits, piece_id] per
    row; key1 == 0 marks an empty entry."""

    __slots__ = ("table", "salt", "max_piece_len", "M")

    def __init__(self, table, salt, max_piece_len):
        self.table = table
        self.salt = salt
        self.max_piece_len = max_piece_len
        self.M = table.shape[0]


def build_vocab_table(pieces: Sequence[bytes], scores: Sequence[float],
                      use_native: bool = True) -> PackedTable:
    """Build the vocab table: M is the power of two >= max(len(pieces), 32);
    on a bucket overflow bump the salt (0..7), then double M."""
    M = 1 << int(np.ceil(np.log2(max(len(pieces), 32))))
    build = host_lib.bucket4_build_native if use_native else _bucket4_build_py
    while True:
        for salt in range(8):
            out = build(pieces, scores, M, salt)
            if out is not None:
                return PackedTable(out[0], salt, out[1])
        M *= 2


def _bucket4_build_py(pieces, scores, M, salt):
    """Python reference build, bit-identical to the native one."""
    table = np.zeros((M, 16), dtype=np.int64)
    seen = set()
    max_len = 1
    for pid, (piece, score) in enumerate(zip(pieces, scores)):
        if not piece:
            continue
        h1, h2 = _fingerprints(piece)
        if (h1, h2) in seen:
            continue  # first occurrence wins (duplicate piece)
        seen.add((h1, h2))
        max_len = max(max_len, len(piece))
        sbits = int(np.float32(score).view(np.int32)) & _MASK32
        slot = _mix32(h1 ^ salt) % M
        for e in range(4):
            if table[slot, e * 4] == 0:
                table[slot, e * 4:e * 4 + 4] = (h1, h2, sbits, pid)
                break
        else:
            return None
    return table.astype(np.uint32).view(np.int32).reshape(M, 16), max_len


def pack_pretokens(pretokens: Sequence[bytes], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack pretoken bytes into (B, max_len) int32 rows + (B,) int32 lengths;
    longer pretokens are truncated."""
    B = len(pretokens)
    cut = [p[:max_len] for p in pretokens]
    lens = np.fromiter(map(len, cut), dtype=np.int32, count=B)
    rows = np.zeros((B, max_len), dtype=np.int32)
    data = np.frombuffer(b"".join(cut), dtype=np.uint8)
    if len(data):
        starts = np.repeat(np.cumsum(lens, dtype=np.int64) - lens, lens)
        cols = np.arange(len(data), dtype=np.int64) - starts
        rows[np.repeat(np.arange(B), lens), cols] = data
    return rows, lens


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for x holding 32-bit values in int64: the high half
    of x is multiplied separately so no product leaves int64."""
    lo = (x & 0xFFFF) * m
    hi = (((x >> 16) * m) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32_dev(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX2)
    return h ^ (h >> 16)


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """32-bit values held in int64 -> the int32 of the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def compute_span_scores(rows: torch.Tensor, lens: torch.Tensor, table: torch.Tensor, salt: int,
                        unk_score: float, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucket-4 lookup of all (start, len <= K) spans: (S, I), each (B, L, K),
    span scores (NEG where absent or outside the pretoken) and piece ids;
    single-byte spans with no piece score ``unk_score`` (rounded to f32)
    with id -2. rows (B, L) int32 bytes, lens (B,) int32, table (M, 16)
    int32 with M a power of two, all on one device."""
    B, L = rows.shape
    M = table.shape[0]
    if M & (M - 1):
        raise ValueError(f"vocab table rows {M} is not a power of two")
    dev = rows.device
    b = rows.to(torch.int64)
    h1 = torch.full((B, L), _OFF1, dtype=torch.int64, device=dev)
    h2 = torch.full((B, L), _OFF2, dtype=torch.int64, device=dev)
    S = torch.empty((B, L, K), dtype=torch.float32, device=dev)
    I = torch.empty((B, L, K), dtype=torch.int32, device=dev)
    for k in range(1, K + 1):
        # byte at position i+k-1 for each start i (shift left by k-1)
        shifted = torch.nn.functional.pad(b[:, k - 1:], (0, k - 1))
        h1 = (h1 * _P1 + shifted + 1) & _MASK32
        h2 = (_mul32(h2, _P2) + shifted + 1) & _MASK32
        hh1 = torch.where(h1 == 0, 1, h1)
        slot = _fmix32_dev(hh1 ^ salt) & (M - 1)
        ent = table[slot].view(B, L, 4, 4)  # four entries per bucket
        hit = ((ent[..., 0] == _as_int32(hh1)[..., None])
               & (ent[..., 1] == _as_int32(h2)[..., None]))
        score_e = torch.where(hit, ent[..., 2].view(torch.float32), NEG)
        id_e = torch.where(hit, ent[..., 3], -1)
        # at most one entry matches (keys are unique)
        S[:, :, k - 1] = score_e.amax(-1)
        I[:, :, k - 1] = id_e.amax(-1)
    # spans must stay inside the pretoken
    pos = torch.arange(L, device=dev)[None, :, None]
    klen = torch.arange(1, K + 1, device=dev)[None, None, :]
    valid = (pos + klen) <= lens.to(torch.int64)[:, None, None]
    # unk fallback: single-byte spans always available at unk_score
    single = (klen == 1) & valid
    unk = torch.tensor(unk_score, dtype=torch.float32, device=dev)
    S = torch.where(valid, S, NEG)
    S = torch.where(single & (S <= NEG / 2), unk, S)
    I = torch.where(single & (I < 0), -2, I)  # -2 marks unk bytes
    return S, I


def viterbi_spans_dp_plain(rows: torch.Tensor, lens: torch.Tensor, table: torch.Tensor,
                           salt: int, unk_score: float, K: int):
    """Plain version of the fused kernel: kernel 6's plain DP over
    ``compute_span_scores``. (dp, bk, bi), each (B, L+K)."""
    return viterbi_dp_plain(*compute_span_scores(rows, lens, table, salt, unk_score, K))


def viterbi_spans_dp(rows: torch.Tensor, lens: torch.Tensor, table: torch.Tensor, salt: int,
                     unk_score: float, K: int):
    """(dp, bk, bi) of the Viterbi DP over the span scores of ``rows``
    (B, L) int32 bytes with ``lens`` (B,) in 0..L and a table as
    ``build_vocab_table`` makes it (each bucket's entries filled in order,
    keys unique), bit-equal to ``viterbi_spans_dp_plain``. CPU tensors take
    the plain version; on the card this launches the fused kernel
    (``csrc/viterbi_dp.cu`` zt_viterbi_spans_dp); any other device raises."""
    if rows.device.type == "cpu":
        return viterbi_spans_dp_plain(rows, lens, table, salt, unk_score, K)
    return _launch_spans(rows, lens, table, salt, unk_score, K)


def _launch_spans(rows, lens, table, salt, unk_score, K):
    lib = _build.load("viterbi_dp")
    if not rows.is_cuda:
        raise ValueError(f"viterbi_spans_dp: no kernel for device {rows.device}")
    if rows.dim() != 2 or lens.shape != rows.shape[:1] or table.dim() != 2 \
            or table.shape[1] != 16:
        raise ValueError(f"viterbi_spans_dp: rows {tuple(rows.shape)}, lens "
                         f"{tuple(lens.shape)}, table {tuple(table.shape)} must be (B, L), "
                         "(B,), (M, 16)")
    if lens.device != rows.device or table.device != rows.device:
        raise ValueError("viterbi_spans_dp: rows, lens and table must share a device")
    B, L = rows.shape
    M = table.shape[0]
    if M & (M - 1):
        raise ValueError(f"vocab table rows {M} is not a power of two")
    if not 1 <= K <= _MAX_K:
        raise ValueError(f"viterbi_spans_dp: K = {K} outside 1..{_MAX_K}")
    rows = _build.aligned16(rows.to(torch.int32))
    lens = lens.to(torch.int32).contiguous()
    table = table.to(torch.int32).contiguous()
    dp = torch.empty((B, L + K), dtype=torch.float32, device=rows.device)
    bk = torch.empty((B, L + K), dtype=torch.int32, device=rows.device)
    bi = torch.empty((B, L + K), dtype=torch.int32, device=rows.device)
    if B == 0 or L == 0:
        dp.fill_(NEG)
        dp[:, :1] = 0.0
        bk.zero_()
        bi.fill_(-1)
        return dp, bk, bi
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.zt_viterbi_spans_dp
    fn.restype = i
    fn.argtypes = [p, p, p, i, ctypes.c_uint, ctypes.c_float, p, p, p, ctypes.c_longlong, i, i,
                   p]
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = fn(rows.data_ptr(), lens.data_ptr(), table.data_ptr(), M, int(salt) & 0xFFFFFFFF,
             float(unk_score), dp.data_ptr(), bk.data_ptr(), bi.data_ptr(), B, L, K, stream)
    _build.check(err, "viterbi_spans_dp kernel launch")
    _build.count_launch("viterbi_spans_dp")
    return dp, bk, bi


def viterbi_device(rows: torch.Tensor, lens: torch.Tensor, table: torch.Tensor, salt: int,
                   unk_score: float, K: int = 16, with_backtrack: bool = True):
    """Batched Viterbi: (best_scores (B,), back_k (B, L+1) int32, back_id
    (B, L+1) int32), where back_k[j] is the length of the best piece ending
    at j (0 where unreachable). The span scores and the DP are one fused
    kernel on the card."""
    L = rows.shape[1]
    dp, bk, bi = viterbi_spans_dp(rows, lens, table, salt, unk_score, K)
    best = dp.gather(1, lens.to(torch.int64)[:, None])[:, 0]
    if not with_backtrack:
        return best, None, None
    return best, bk[:, :L + 1], bi[:, :L + 1]


def backtrack_device(back_k: torch.Tensor, back_id: torch.Tensor,
                     lens: torch.Tensor) -> torch.Tensor:
    """Follow each row's segmentation chain on the device: (B, L) int32 piece
    ids in reverse order, padded with -1."""
    B, L1 = back_k.shape
    L = L1 - 1
    out = torch.full((B, L), -1, dtype=torch.int32, device=back_k.device)
    j = lens.to(torch.int64)
    for step in range(L):
        k = back_k.gather(1, j[:, None])[:, 0].to(torch.int64)
        pid = back_id.gather(1, j[:, None])[:, 0]
        active = (j > 0) & (k > 0)
        out[:, step] = torch.where(active, pid, -1)
        j = torch.where(active, j - k, 0)
    return out


def unpack_backtrack(ids_rev: np.ndarray) -> List[List[int]]:
    """Host unpack of ``backtrack_device``'s output into per-row id lists."""
    L = ids_rev.shape[1]
    fwd = ids_rev[:, ::-1]
    counts = L - (ids_rev != -1).sum(axis=1)
    return [row[c:].tolist() for row, c in zip(fwd, counts)]


def backtrack_ids(back_k: np.ndarray, back_id: np.ndarray, lens: np.ndarray) -> List[List[int]]:
    """Host-side backtrack, one pass per row."""
    out = []
    for row_k, row_id, n in zip(back_k, back_id, lens):
        ids = []
        j = int(n)
        while j > 0:
            k = int(row_k[j])
            if k <= 0:
                break
            ids.append(int(row_id[j]))
            j -= k
        ids.reverse()
        out.append(ids)
    return out


def count_token_usage(back_k: torch.Tensor, back_id: torch.Tensor, lens: torch.Tensor,
                      n_pieces: int, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-frequency counts (n_pieces,) int64 from the backpointers,
    following each chain on the device and adding its row's weight (default
    1) for every real piece (unk bytes are not counted)."""
    B, L1 = back_k.shape
    dev = back_k.device
    w = (torch.ones(B, dtype=torch.int64, device=dev) if weights is None
         else weights.to(device=dev, dtype=torch.int64))
    counts = torch.zeros(n_pieces + 1, dtype=torch.int64, device=dev)  # +1 overflow slot
    j = lens.to(torch.int64)
    for _ in range(L1):
        k = back_k.gather(1, j[:, None])[:, 0].to(torch.int64)
        pid = back_id.gather(1, j[:, None])[:, 0].to(torch.int64)
        active = (j > 0) & (k > 0) & (pid >= 0)
        counts.index_add_(0, torch.where(active, pid, n_pieces), torch.where(active, w, 0))
        j = torch.clamp(j - torch.clamp(k, min=1), min=0)
    return counts[:n_pieces]


def count_tokens_device(pieces: Sequence[bytes], scores: Sequence[float],
                        pretoken_counts: Mapping[bytes, int], max_pretoken_len: int = 64,
                        K: int = 16, overlong: str = "host", device="cuda",
                        group=None) -> np.ndarray:
    """Corpus token-usage counts (len(pieces),) int64: the weighted
    pretokens (weights = multiplicities) are packed into byte rows, Viterbi
    and chain-following counts run on ``device``, and only the histogram
    comes back. With ``group`` (a ``torch.distributed`` process group, every
    rank calling with the same arguments), each rank runs a contiguous share
    of the rows on its own device and the histograms are summed over the
    ranks.

    ``overlong``: pretokens longer than ``max_pretoken_len`` are segmented
    exactly by the native encoder on the host and their counts folded in
    ("host", the default), or truncated ("truncate")."""
    if overlong not in ("host", "truncate"):
        raise ValueError(f"overlong must be 'host' or 'truncate', got {overlong!r}")
    table = build_vocab_table(pieces, scores)
    K = min(K, table.max_piece_len)
    unk_score = (min(scores) if len(scores) else 0.0) - 10.0
    n_pieces = len(pieces)

    total = np.zeros(n_pieces, dtype=np.int64)
    agg: Dict[bytes, int] = {}
    long_keys: list = []
    for p, w in pretoken_counts.items():
        if len(p) > max_pretoken_len and overlong == "host":
            long_keys.append(p)
            continue
        key = p[:max_pretoken_len]
        agg[key] = agg.get(key, 0) + int(w)
    if long_keys:
        native = host_lib.NativeUnigram(pieces, scores, unk_id=-1)
        for p, seg in zip(long_keys, native.encode_pretokens(long_keys)):
            seg = seg[seg >= 0]
            np.add.at(total, seg, int(pretoken_counts[p]))
    if not agg:
        return total
    rows, lens = pack_pretokens(list(agg), max_pretoken_len)
    weights = np.fromiter(agg.values(), dtype=np.int64, count=len(agg))
    tab = torch.from_numpy(table.table).to(device)
    counts = torch.zeros(n_pieces, dtype=torch.int64, device=tab.device)
    first, last = 0, len(rows)
    if group is not None:
        import torch.distributed as dist

        world, rank = dist.get_world_size(group), dist.get_rank(group)
        first, last = len(rows) * rank // world, len(rows) * (rank + 1) // world
    for start in range(first, last, _CHUNK_ROWS):
        sl = slice(start, min(start + _CHUNK_ROWS, last))
        r = torch.from_numpy(rows[sl]).to(tab.device)
        ln = torch.from_numpy(lens[sl]).to(tab.device)
        _, bk, bi = viterbi_device(r, ln, tab, table.salt, unk_score, K=K)
        counts += count_token_usage(bk, bi, ln, n_pieces,
                                    weights=torch.from_numpy(weights[sl]).to(tab.device))
    if group is not None:
        dist.all_reduce(counts, group=group)
    return total + counts.cpu().numpy()


class DeviceRetokenizer:
    """Host packs and dedups pretokens, the device runs Viterbi.

    Per call, identical pretokens collapse to one row; across calls,
    segmentations are memoized, so a pretoken seen before never reaches the
    device again. Unique rows go to length buckets (widths 8/12/16/24/32/48
    below ``max_pretoken_len``, and ``max_pretoken_len`` itself), so short
    pretokens do not pay the full (L, K) span grid. Pretokens longer than
    ``max_pretoken_len`` are truncated. Segmentations hold piece ids, and
    -2 for a byte with no piece."""

    BUCKET_WIDTHS = (8, 12, 16, 24, 32, 48)

    def __init__(self, pieces: Sequence[bytes], scores: Sequence[float],
                 max_pretoken_len: int = 64, K: int = 16, memoize: bool = True,
                 device="cuda"):
        self.table = build_vocab_table(pieces, scores)
        self.K = min(K, self.table.max_piece_len)
        self.max_pretoken_len = max_pretoken_len
        min_score = min(scores) if len(scores) else 0.0
        self.unk_score = float(min_score) - 10.0
        self.n_pieces = len(pieces)
        self._dev_table = torch.from_numpy(self.table.table).to(device)
        self.memoize = memoize
        self._cache: Dict[bytes, List[int]] = {}
        self._widths = sorted({w for w in self.BUCKET_WIDTHS if w < max_pretoken_len}
                              | {max_pretoken_len})

    def _segment_unique(self, unique_pretokens: Sequence[bytes]) -> List[List[int]]:
        """Segment pretokens (each at most ``max_pretoken_len`` bytes): one
        Viterbi + backtrack per width group, one fetch."""
        if not unique_pretokens:
            return []
        dev = self._dev_table.device
        lengths = np.fromiter(map(len, unique_pretokens), dtype=np.int64,
                              count=len(unique_pretokens))
        group = np.minimum(np.searchsorted(self._widths, lengths, side="left"),
                           len(self._widths) - 1)
        w_max = max(self._widths)
        idxs, outs = [], []
        for g, width in enumerate(self._widths):
            idx = np.flatnonzero(group == g)
            if not len(idx):
                continue
            rows, lens = pack_pretokens([unique_pretokens[i] for i in idx], width)
            r, ln = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
            _, bk, bi = viterbi_device(r, ln, self._dev_table, self.table.salt, self.unk_score,
                                       K=min(self.K, width))
            ids_rev = backtrack_device(bk, bi, ln)
            # ids fill a -1-terminated prefix of each reversed row, so
            # right-padding with -1 changes nothing
            outs.append(torch.nn.functional.pad(ids_rev, (0, w_max - width), value=-1))
            idxs.append(idx)
        all_ids = torch.cat(outs).cpu().numpy()  # one fetch
        out: List[Optional[List[int]]] = [None] * len(unique_pretokens)
        off = 0
        for idx in idxs:
            for i, seg in zip(idx.tolist(), unpack_backtrack(all_ids[off:off + len(idx)])):
                out[i] = seg
            off += len(idx)
        return out  # type: ignore[return-value]

    def _segmentations(self, pretokens: Sequence[bytes]) -> List[List[int]]:
        n = self.max_pretoken_len
        if self.memoize:
            new = [k for k in dict.fromkeys(p[:n] for p in pretokens) if k not in self._cache]
            for key, ids in zip(new, self._segment_unique(new)):
                self._cache[key] = ids
            return [self._cache[p[:n]] for p in pretokens]
        uniq = list(dict.fromkeys(p[:n] for p in pretokens))
        seg = dict(zip(uniq, self._segment_unique(uniq)))
        return [seg[p[:n]] for p in pretokens]

    def encode(self, pretokens: Sequence[bytes]) -> List[List[int]]:
        return self._segmentations(pretokens)

    def best_scores(self, pretokens: Sequence[bytes]) -> np.ndarray:
        """(n,) f32 score of each pretoken's best segmentation."""
        keys = [p[:self.max_pretoken_len] for p in pretokens]
        uniq = list(dict.fromkeys(keys))
        rows, lens = pack_pretokens(uniq, self.max_pretoken_len)
        dev = self._dev_table.device
        best, _, _ = viterbi_device(torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev),
                                    self._dev_table, self.table.salt, self.unk_score, K=self.K,
                                    with_backtrack=False)
        best = dict(zip(uniq, best.cpu().numpy()))
        return np.asarray([best[k] for k in keys], dtype=np.float32)

    def token_counts(self, pretokens: Sequence[bytes]) -> np.ndarray:
        """Piece-usage histogram (n_pieces,) int64 over the segmentations."""
        counts = np.zeros(self.n_pieces, dtype=np.int64)
        ids = [pid for seg in self._segmentations(pretokens) for pid in seg if pid >= 0]
        np.add.at(counts, np.asarray(ids, dtype=np.int64), 1)
        return counts
