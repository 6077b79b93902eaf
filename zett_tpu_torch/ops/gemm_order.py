"""The tile order of the persistent bf16 GEMM of ``csrc/gemm.cuh``
(``gemm_bf16_kernel``), in Python: the same parameters as the C entry
point ``zt_gemm_order`` of ``libencoder_layer.so``, and the walk itself.

The GEMM serves kernels 1 and 4 (``zett_tpu/ops/pallas_attention.py``
``_layer_kernel`` :727 through the seven-launch route, ``_block_kernel``
:530). C (M, N) = A (M, K) @ W (K, N) is walked in 128-row tiles of A by
256-column tiles of W, n-fastest, over row groups: a row group is
``cluster`` neighbouring row tiles, one a CTA of a cluster that shares
each weight tile (two where K is 2048 or more and there are two row tiles
to pair, else one).

The pure functions build and launch nothing; ``card_order`` asks the
built library (on the card only).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Tuple

from . import _build

TILE_M = 128  # gemm.cuh GM
TILE_N = 256  # gemm.cuh GN


@dataclass(frozen=True)
class GemmOrder:
    """``zt_gemm_order``'s first five values: row tiles, N tiles, CTAs a
    cluster, row groups (ceil(m_tiles / cluster)) and work items (groups x
    n_tiles)."""

    m_tiles: int
    n_tiles: int
    cluster: int
    groups: int
    tiles: int


def gemm_cluster(M: int, K: int) -> int:
    """gemm.cuh ``gemm_cluster``: two CTAs a cluster where K is 2048 or more
    and there are two row tiles to pair."""
    return 2 if K >= 2048 and -(-M // TILE_M) >= 2 else 1


def gemm_order(M: int, N: int, K: int) -> GemmOrder:
    """gemm.cuh ``gemm_order``."""
    if min(M, N, K) < 1:
        raise ValueError(f"gemm_order: shape ({M}, {N}, {K})")
    m_tiles, n_tiles = -(-M // TILE_M), -(-N // TILE_N)
    cluster = gemm_cluster(M, K)
    groups = -(-m_tiles // cluster)
    return GemmOrder(m_tiles, n_tiles, cluster, groups, groups * n_tiles)


def tile_walk(o: GemmOrder, clusters: int) -> List[List[Tuple[int, int]]]:
    """The (row tile, N tile) pairs each CTA walks, in order, when
    ``clusters`` clusters run: cluster c takes items c, c + clusters, ...
    (item t is row group t // n_tiles, N tile t % n_tiles), and its rank r
    the row tile cluster x group + r (a row tile past the last one is
    computed and not stored). CTA i is rank i % cluster of cluster
    i // cluster."""
    walks = []
    for cta in range(clusters * o.cluster):
        c, rank = divmod(cta, o.cluster)
        walk = []
        for t in range(c, o.tiles, clusters):
            g, n = divmod(t, o.n_tiles)
            walk.append((g * o.cluster + rank, n))
        walks.append(walk)
    return walks


def as_values(o: GemmOrder, resident: int) -> Tuple[int, ...]:
    """The seven values ``zt_gemm_order`` writes, given the first of the
    last two (the clusters resident at once, the card's): the order, then
    those clusters and the CTAs a launch runs (a cluster's for each
    resident cluster, at most one cluster a work item)."""
    return (o.m_tiles, o.n_tiles, o.cluster, o.groups, o.tiles, resident,
            min(o.tiles, resident) * o.cluster)


def card_order(M: int, N: int, K: int) -> Tuple[int, ...]:
    """The card's ``zt_gemm_order``: the seven values ``as_values`` gives,
    with the clusters resident at once read from the card."""
    lib = _build.load("encoder_layer")
    out = (ctypes.c_int * 7)()
    fn = lib.zt_gemm_order
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    _build.check(fn(M, N, K, ctypes.addressof(out)), "zt_gemm_order")
    return tuple(out)
