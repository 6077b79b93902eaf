"""The tile order of the persistent bf16 GEMM (``csrc/gemm.cuh``
``GemmOrder``) through its Python mirror, ``zett_tpu_torch.ops.gemm_order``,
on the CPU: every tile walked once, ragged and odd shapes included, the
CTAs of a cluster in lockstep, the n-fastest order, the cluster choice and
the values ``zt_gemm_order`` reports."""

import itertools

import pytest

from zett_tpu_torch.ops import gemm_order as go

# (M, N, K): ragged M and N at one and two CTAs a cluster, an odd count of
# row tiles, a single row tile, GPT-2's and TinyLlama's widths, and
# Mistral-7B's [q|k|v] at B 16384, L 7
SHAPES = [(7000, 1600, 640), (7000, 1600, 2048), (300, 1920, 640), (300, 1920, 4096),
          (100, 768, 768), (100, 768, 4096), (128 * 5, 2688, 896), (114688, 2304, 768),
          (114688, 6144, 2048), (114688, 12288, 4096)]


def covered(o, clusters):
    """Every (row tile, N tile) the CTAs store, with how often; and the
    N-tile sequences of each cluster's CTAs."""
    seen, lockstep = {}, []
    walks = go.tile_walk(o, clusters)
    for c in range(clusters):
        ranks = walks[c * o.cluster:(c + 1) * o.cluster]
        lockstep.append([[n for _, n in w] for w in ranks])
        for walk in ranks:
            for m, n in walk:
                if m < o.m_tiles:  # a row tile past M is computed and not stored
                    seen[(m, n)] = seen.get((m, n), 0) + 1
    return seen, lockstep


@pytest.mark.parametrize("clusters", [1, 5, 66])
@pytest.mark.parametrize("M,N,K", SHAPES[:9])
def test_every_tile_walked_once(M, N, K, clusters):
    o = go.gemm_order(M, N, K)
    seen, lockstep = covered(o, clusters)
    assert set(seen) == set(itertools.product(range(o.m_tiles), range(o.n_tiles)))
    assert set(seen.values()) == {1}
    # the CTAs of a cluster walk the same N tiles in the same order
    assert all(all(w == ranks[0] for w in ranks) for ranks in lockstep)


def test_odd_row_tiles_pair_with_a_tile_past_m():
    o = go.gemm_order(300, 1920, 4096)
    assert (o.m_tiles, o.cluster, o.groups, o.n_tiles) == (3, 2, 2, 8)
    past = [(m, n) for walk in go.tile_walk(o, 4) for m, n in walk if m >= o.m_tiles]
    # the last group's second CTA: one row tile past M, every N tile once
    assert sorted(past) == [(3, n) for n in range(8)]


@pytest.mark.parametrize("M,N,K", SHAPES)
def test_n_fastest(M, N, K):
    # a cluster's items run each row group's N tiles in order, then the next
    # group's: the order the GEMM had before its clusters
    o = go.gemm_order(M, N, K)
    walk = go.tile_walk(o, 1)[0]
    groups = [m // o.cluster for m, _ in walk]
    assert walk[:o.n_tiles] == [(0, n) for n in range(o.n_tiles)]
    assert groups == sorted(groups) and [n for _, n in walk] == list(range(o.n_tiles)) * o.groups


def test_cluster_choice_and_values():
    # two CTAs a cluster at K 2048 and over with two row tiles to pair
    assert go.gemm_cluster(129, 2048) == 2
    assert go.gemm_cluster(128, 4096) == 1 and go.gemm_cluster(114688, 768) == 1
    assert [go.gemm_order(114688, N, K).cluster for N, K in (
        (12288, 4096), (4096, 4096), (8192, 4096), (4096, 8192), (6144, 2048), (2304, 768))] \
        == [2, 2, 2, 2, 2, 1]
    o = go.gemm_order(7000, 1600, 2048)
    assert o == go.GemmOrder(55, 7, 2, 28, 196)
    # zt_gemm_order's seven values: the order, the resident clusters, the CTAs
    assert go.as_values(o, 66) == (55, 7, 2, 28, 196, 66, 132)
    assert go.as_values(go.gemm_order(7000, 1600, 640), 132) == (55, 7, 1, 55, 385, 132, 132)
    assert go.as_values(go.gemm_order(100, 768, 768), 132) == (1, 3, 1, 1, 3, 132, 3)
    with pytest.raises(ValueError):
        go.gemm_order(0, 1600, 640)
