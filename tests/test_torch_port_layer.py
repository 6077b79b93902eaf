"""Kernel 1's four-launch bf16 design, on the CPU: the wrapper's plan for a
shape (a pure function), the repacks its launches read, and a plain model of
the residual-LayerNorm epilogue's rounding order (the bias added to the
rounded accumulator, the residual added and rounded, f32 row statistics
reduced over the cluster's 192-column slices, the affine in f32, one cast),
held against the port's plain version and against the JAX package's
``encoder_layer_reference`` and ``encoder_layer_pallas(interpret=True)``.
The kernels themselves run only on the card (``chip_smoke.py`` phases 1
and 2)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zett_tpu.ops.pallas_attention import encoder_layer_pallas
from zett_tpu.ops.pallas_attention import encoder_layer_reference as jax_layer_reference

from zett_tpu_torch.models.hypernet import MERGED_ATTENTION_MAX
from zett_tpu_torch.ops import _build
from zett_tpu_torch.ops.attention_core import merged_attention_reference
from zett_tpu_torch.ops.encoder_layer import (
    CLUSTER_SLICE,
    GELU_TILE_COLS,
    TILE_ROWS,
    dense_exact,
    encoder_layer_reference,
    gelu,
    layer_norm_flax_exact,
    layer_plan,
    pack_biases,
    pack_qkv_by_head,
    pack_weights,
)

BF, F32 = torch.bfloat16, torch.float32


# ----------------------------------------------------------------- the plan
@pytest.mark.parametrize("h", range(1, 17))
def test_plan_takes_every_bf16_width(h):
    """Every width today's bf16 kernel takes (H = 64 h, h <= 16; L in 1..32
    with L*h within the merged-attention bound; I of whole 16-byte rows)
    gets the four-launch plan: a LayerNorm cluster of ceil(H / 192) CTAs,
    within the portable size of 8, and [q|k|v] tiles of whole surface
    forms that use all but at most L - 1 of the 128 rows."""
    H = 64 * h
    for L in range(1, 33):
        if L * h > MERGED_ATTENTION_MAX:
            continue
        for I in (8, 2 * H, 1600, 4 * H):
            plan = layer_plan(BF, L, H, h, I)
            assert (plan.route, plan.launches) == ("fused", 4)
            assert plan.cluster == math.ceil(H / CLUSTER_SLICE) <= 8
            assert plan.tile_forms == TILE_ROWS // L
            assert plan.tile_rows == plan.tile_forms * L
            assert TILE_ROWS - L < plan.tile_rows <= TILE_ROWS


@pytest.mark.parametrize("h", [1, 12, 16, 17, 24])
@pytest.mark.parametrize("L", [1, 7, 32])
def test_plan_f32_keeps_the_unfused_launches(h, L):
    """f32 keeps the seven-launch sequence at every head count it takes
    (beyond 16 too: its scalar core has no head limit)."""
    plan = layer_plan(F32, L, 64 * h, h, 1536)
    assert plan == type(plan)("unfused", 7, 0, 0, 0)


def test_plan_main_shapes():
    """The transfer's shapes, and the widths off the GEMMs' tiles: H 768 at
    L 7 and 4; H 640 (10 heads, I 1600), 896 (14) and 1024 (16, I 4096)."""
    assert layer_plan(BF, 7, 768, 12, 1536) == type(layer_plan(BF, 7, 768, 12, 1536))(
        "fused", 4, 4, 18, 126)
    assert layer_plan(BF, 4, 768, 12, 1536).tile_rows == 128
    assert [layer_plan(BF, 7, 64 * h, h, I).cluster
            for h, I in ((10, 1600), (14, 1600), (16, 4096))] == [4, 5, 6]


@pytest.mark.parametrize("dtype,L,H,h,I,error,match", [
    (BF, 7, 770, 12, 1536, ValueError, "head width 770/12 heads is not one of"),
    (BF, 0, 768, 12, 1536, ValueError, "outside 1..32"),
    (BF, 33, 768, 12, 1536, ValueError, "outside 1..32"),
    (BF, 7, 64 * 33, 33, 1536, ValueError, "at most 32"),
    (BF, 7, 768, 12, 1004, ValueError, "16 bytes"),
    (F32, 7, 768, 12, 1002, ValueError, "16 bytes"),
    (torch.float16, 7, 768, 12, 1536, TypeError, "unsupported dtype"),
])
def test_plan_refusals_keep_their_messages(dtype, L, H, h, I, error, match):
    """What the kernel refuses, the plan refuses, with the wrapper's
    messages (``test_torch_port_guards.py``, ``test_torch_port_hopper.py``)."""
    with pytest.raises(error, match=match):
        layer_plan(dtype, L, H, h, I)


def test_plan_is_pure():
    """Nothing is built, loaded or launched, and equal shapes give equal
    plans."""
    before, libs = dict(_build.launch_counts), dict(_build._LIBS)
    assert layer_plan(BF, 7, 768, 12, 1536) == layer_plan(BF, 7, 768, 12, 1536)
    assert _build.launch_counts == before and _build._LIBS == libs


# --------------------------------------------------------------- the repacks
def _randn(rng, shape, dtype, scale=0.1):
    return torch.from_numpy(scale * rng.standard_normal(shape).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("h", [1, 2, 12])
def test_head_by_head_pack_is_the_unfused_product_permuted(h):
    """x @ the head-by-head (3H, H) weight, in bf16 (products summed in
    f64, exact), equals today's ``pack_weights(wq, wk, wv)`` product with
    its columns put back: head i's q, k, v columns at 192 i + [0, 64, 128)."""
    rng = np.random.default_rng(h)
    H = 64 * h
    x = _randn(rng, (5, H), BF, 1.0)
    wq, wk, wv = (_randn(rng, (H, H), BF) for _ in range(3))
    packed = pack_qkv_by_head(wq, wk, wv, h)
    assert packed.shape == (3 * H, H) and packed.is_contiguous()
    fused = x.double() @ packed.double().t()
    unfused = x.double() @ pack_weights(wq, wk, wv).double().t()  # [q | k | v]
    order = torch.tensor([part * H + i * 64 + c for i in range(h) for part in range(3)
                          for c in range(64)])
    assert torch.equal(fused, unfused[:, order])


def test_pack_weights_two_weights_side_by_side():
    """Wo and W1 packed in one copy: rows [0, H) are Wo transposed, the rest
    W1 transposed, K contiguous."""
    rng = np.random.default_rng(3)
    wo, w1 = _randn(rng, (64, 64), BF), _randn(rng, (64, 200), BF)
    packed = pack_weights(wo, w1)
    assert packed.shape == (264, 64) and packed.stride() == (64, 1)
    assert torch.equal(packed[:64], wo.t()) and torch.equal(packed[64:], w1.t())


@pytest.mark.parametrize("I", [1536, 1600, 40, 192])
def test_pack_biases(I):
    """One copy of every bias: [q | k | v], bo, b2, and b1 grown to whole
    192-column gelu tiles by repeating its own values; every view 16-byte
    aligned."""
    rng = np.random.default_rng(I)
    H = 64
    bq, bk, bv, bo, b2 = (_randn(rng, (H,), BF) for _ in range(5))
    b1 = _randn(rng, (I,), BF)
    qkv, o, two, one = pack_biases(bq, bk, bv, bo, b2, b1)
    assert torch.equal(qkv, torch.cat([bq, bk, bv])) and torch.equal(o, bo)
    assert torch.equal(two, b2)
    assert one.shape[0] == -(-I // GELU_TILE_COLS) * GELU_TILE_COLS
    assert torch.equal(one[:I], b1)
    assert torch.equal(one[I:], b1.repeat(-(-one.shape[0] // I))[:one.shape[0] - I])
    assert all(v.data_ptr() % 16 == 0 for v in (qkv, o, two, one))


# ------------------------------------------- the fused epilogue, modelled
def fused_ln(acc, bias, residual, scale, shift, eps, dtype, slices=True):
    """The residual-LayerNorm epilogue of the LN GEMMs, in plain PyTorch:
    t = round(round(acc) + bias); s = round(t + residual); f32 row sums and
    sums of squares, each a sum over the cluster's 192-column slices in
    rank order (``slices``; else the plain version's own means), mean =
    sum * (1/H), var = max(0, sumsq * (1/H) - mean^2), rstd = 1/sqrt(var +
    eps) (the plain version: rsqrt); (s - mean) * (rstd * scale) + shift in
    f32, one cast."""
    t = acc.to(dtype) + bias
    s = (t + residual).float()
    H = s.shape[-1]
    if not slices:
        return layer_norm_flax_exact(s, scale, shift, eps, dtype)
    parts = [(s[..., c:c + CLUSTER_SLICE].sum(-1), (s[..., c:c + CLUSTER_SLICE] ** 2).sum(-1))
             for c in range(0, H, CLUSTER_SLICE)]
    total, total_sq = parts[0]
    for p, q in parts[1:]:
        total, total_sq = total + p, total_sq + q
    inv_n = torch.tensor(1.0 / H, dtype=torch.float32)
    mean = (total * inv_n)[..., None]
    var = torch.clamp(total_sq[..., None] * inv_n - mean * mean, min=0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    return ((s - mean) * (rstd * scale.float()) + shift.float()).to(dtype)


def fused_layer(x, mask, wq, bq, wk, bk, wv, bv, wo, bo, ln1_s, ln1_b, w1, b1, w2, b2,
                ln2_s, ln2_b, num_heads, eps, slices=True):
    """Kernel 1's bf16 sequence in plain PyTorch: the [q|k|v] projections
    and the core as the plain version has them (the kernel's core is the
    plain core's arithmetic), then the two LN epilogues of ``fused_ln``
    around the gelu FFN."""
    B, L, H = x.shape
    h, d = num_heads, H // num_heads
    q, k, v = (dense_exact(x, w, b) for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    kmask = mask.bool().repeat_interleave(h, dim=-1)
    ctx = merged_attention_reference(q.reshape(B, L * h, d), k.reshape(B, L * h, d),
                                     v.reshape(B, L * h, d), kmask, num_heads=h)
    ctx = ctx.reshape(B, L, H)
    y1 = fused_ln(ctx.float() @ wo.float(), bo, x, ln1_s, ln1_b, eps, x.dtype, slices)
    mid = gelu(dense_exact(y1, w1, b1))
    return fused_ln(mid.float() @ w2.float(), b2, y1, ln2_s, ln2_b, eps, x.dtype, slices)


def _layer_args(dtype, B, L, H, I, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H)).astype(np.float32)
    mask = rng.random((B, L)) > 0.3
    mask[:, 0] = True
    mask[1] = False  # all-padding surface forms
    mask[5] = False
    mats = [rng.normal(size=s).astype(np.float32) * 0.06
            for s in [(H, H)] * 4 + [(H, I), (I, H)]]
    vecs = [rng.normal(size=s).astype(np.float32) * 0.02 for s in [(H,)] * 4 + [(I,), (H,)]]
    lns = [1.0 + 0.1 * rng.normal(size=H).astype(np.float32),
           0.1 * rng.normal(size=H).astype(np.float32)]
    w = mats + vecs
    order = [w[0], w[6], w[1], w[7], w[2], w[8], w[3], w[9], lns[0], lns[1],
             w[4], w[10], w[5], w[11], lns[0], lns[1]]
    is_ln = [False] * 8 + [True, True] + [False] * 4 + [True, True]
    return x, mask, order, is_ln


def _torch_args(dtype, x, mask, order, is_ln):
    t = [torch.from_numpy(a) if ln else torch.from_numpy(a).to(dtype)
         for a, ln in zip(order, is_ln)]
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(mask), *t)


@pytest.mark.parametrize("dtype", [F32, BF], ids=str)
@pytest.mark.parametrize("L", [4, 7])
def test_fused_rounding_order_is_the_plain_versions(dtype, L):
    """With the plain version's row statistics, the modelled epilogue
    sequence gives exactly ``encoder_layer_reference``'s output: the bias,
    the residual and the casts sit where the plain version has them."""
    x, mask, order, is_ln = _layer_args(dtype, 12, L, 128, 256, seed=L)
    args = _torch_args(dtype, x, mask, order, is_ln)
    got = fused_layer(*args, num_heads=2, eps=1e-5, slices=False)
    assert torch.equal(got, encoder_layer_reference(*args, 2, 1e-5))


@pytest.mark.parametrize("dtype", [F32, BF], ids=str)
@pytest.mark.parametrize("H,h,I", [(128, 2, 256), (320, 5, 200), (768, 12, 1536)])
def test_cluster_sums_differ_only_in_f32_order(dtype, H, h, I):
    """The LN epilogue with the cluster's slice-by-slice row sums against
    the plain LayerNorm on the same pre-LN input: only the f32 order of the
    sums differs. Tolerances: f32 2e-6 absolute on LayerNormed values
    (|y| < 8); bf16 one ulp of the output (the f32 difference can round the
    other way)."""
    rng = np.random.default_rng(H)
    M = 64
    acc = torch.from_numpy(rng.normal(size=(M, H)).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.normal(size=H).astype(np.float32)).to(dtype)
    res = torch.from_numpy(rng.normal(size=(M, H)).astype(np.float32)).to(dtype)
    scale = torch.from_numpy(1 + 0.1 * rng.normal(size=H).astype(np.float32))
    shift = torch.from_numpy(0.1 * rng.normal(size=H).astype(np.float32))
    got = fused_ln(acc, bias, res, scale, shift, 1e-5, dtype).float()
    ref = fused_ln(acc, bias, res, scale, shift, 1e-5, dtype, slices=False).float()
    err = (got - ref).abs()
    if dtype == F32:
        assert float(err.max()) <= 2e-6
    else:
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=2.0 ** -126))) - 7)
        assert bool((err <= ulp).all())


@pytest.mark.parametrize("dtype", [F32, BF], ids=str)
@pytest.mark.parametrize("L,H,h,I", [(4, 128, 2, 256), (7, 128, 2, 256), (7, 320, 5, 200)])
def test_fused_layer_model_matches_jax(dtype, L, H, h, I):
    """The modelled bf16 sequence (cluster-order LN sums) vs JAX's
    encoder_layer_reference (all rows) and encoder_layer_pallas(interpret=
    True) on rows with a valid key (the Pallas kernel pads L to 8, so its
    all-padding rows also average the padding's values). Tolerances as
    ``test_torch_port_kernels.py``: f32 1e-5 absolute (sums in another
    order, LayerNormed outputs |y| < 6); bf16 one ulp at the output scale
    (2^-8 * 8 = 0.03125), since XLA rounds intermediate bf16 ops where the
    port rounds once."""
    jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
    x, mask, order, is_ln = _layer_args(dtype, 12, L, H, I, seed=L + H)
    args = _torch_args(dtype, x, mask, order, is_ln)
    got = fused_layer(*args, num_heads=h, eps=1e-5).float().numpy()
    jargs = [jnp.asarray(a) if ln else jnp.asarray(a, jdt) for a, ln in zip(order, is_ln)]
    jx, jmask = jnp.asarray(x, jdt), jnp.asarray(mask)
    ref = np.asarray(jax_layer_reference(jx, jmask, *jargs, h, 1e-5, True), np.float32)
    pal = np.asarray(encoder_layer_pallas(jx, jmask, *jargs, num_heads=h, eps=1e-5,
                                          approximate_gelu=True, tile_b=4, interpret=True),
                     np.float32)
    tol = 1e-5 if dtype == F32 else 0.03125
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= tol, np.abs(got - ref).max()
    live = mask.any(axis=1)
    assert np.abs(got[live] - pal[live]).max() <= tol, np.abs(got[live] - pal[live]).max()
