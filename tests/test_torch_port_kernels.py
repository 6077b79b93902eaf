"""The port's kernel plain versions (zett_tpu_torch/ops) held against the JAX
package's Pallas kernels in interpret mode and their pure-JAX references.

The same numpy-seeded inputs go through both sides. The CUDA kernels
themselves run only on the card (chip_smoke.py holds them against these
plain versions there)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zett_tpu.ops.pallas_attention import (
    _core_train_fwd_pallas,
    encoder_layer_pallas,
    encoder_layer_reference,
    layer_norm_flax_exact,
    merged_attention_reference,
)
from zett_tpu_torch.ops import attention_core, encoder_layer
from zett_tpu_torch.ops import layer_norm_flax_exact as port_layer_norm

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _layer_inputs(dtype_name, B, L, H, I, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H)).astype(np.float32)
    mask = rng.random((B, L)) > 0.3
    mask[:, 0] = True
    mask[1] = False  # an all-padding surface form
    mask[5] = False
    mats = [rng.normal(size=s).astype(np.float32) * 0.06
            for s in [(H, H)] * 4 + [(H, I), (I, H)]]
    vecs = [rng.normal(size=s).astype(np.float32) * 0.02 for s in [(H,)] * 4 + [(I,), (H,)]]
    lns = [1.0 + 0.1 * rng.normal(size=H).astype(np.float32),
           0.1 * rng.normal(size=H).astype(np.float32)]
    jx, tx = _pair(x, dtype_name)
    jw = [_pair(m, dtype_name) for m in mats]
    jb = [_pair(v, dtype_name) for v in vecs]
    ln_j = [jnp.asarray(v) for v in lns]
    ln_t = [torch.from_numpy(v) for v in lns]

    def order(side):
        w = [p[side] for p in jw]
        b = [p[side] for p in jb]
        ln = ln_j if side == 0 else ln_t
        return (w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3],
                ln[0], ln[1], w[4], b[4], w[5], b[5], ln[0], ln[1])

    return (jx, jnp.asarray(mask), *order(0)), (tx, torch.from_numpy(mask), *order(1)), mask


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [4, 7])
def test_encoder_layer_plain_matches_jax(dtype_name, L):
    """Kernel 1's plain version vs encoder_layer_reference (all rows) and
    vs encoder_layer_pallas(interpret=True) on rows with a valid key.

    Tolerances: f32 1e-5 absolute (sums in another order, outputs are
    LayerNormed, |y| < 6); bf16 one ulp at the output scale (2^-8 * 8 =
    0.03125), since XLA rounds intermediate bf16 ops where the port rounds
    once. The Pallas kernel pads L to a multiple of 8 with masked
    positions, so its all-padding rows average over the padding's values as
    well; there it is held on the rows that have a valid key."""
    B, H, I, h, eps = 12, 128, 256, 2, 1e-5
    jargs, targs, mask = _layer_inputs(dtype_name, B, L, H, I, seed=L)
    got = _f32(encoder_layer(*targs, num_heads=h, eps=eps))
    ref = _f32(encoder_layer_reference(*jargs, h, eps, True))
    pal = _f32(encoder_layer_pallas(*jargs, num_heads=h, eps=eps, approximate_gelu=True,
                                    tile_b=4, interpret=True))
    tol = 1e-5 if dtype_name == "float32" else 0.03125
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= tol, np.abs(got - ref).max()
    live = mask.any(axis=1)
    assert np.abs(got[live] - pal[live]).max() <= tol, np.abs(got[live] - pal[live]).max()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lk", [4, 7])
def test_attention_core_plain_matches_jax(dtype_name, Lk):
    """Kernel 2's plain version vs _core_train_fwd_pallas(rate=0,
    interpret=True) and merged_attention_reference, CLS query against Lk
    keys, with all-padding rows. Tolerances: f32 1e-6 absolute on values of
    magnitude < 4; bf16 one ulp at that scale (2^-8 * 4)."""
    B, h, d = 20, 2, 64
    rng = np.random.default_rng(Lk)
    qm = rng.normal(size=(B, h, d)).astype(np.float32)
    km = rng.normal(size=(B, Lk * h, d)).astype(np.float32)
    vm = rng.normal(size=(B, Lk * h, d)).astype(np.float32)
    mask = rng.random((B, Lk)) > 0.3
    mask[:, 0] = True
    mask[2] = False
    kmaskf = np.repeat(mask, h, axis=-1).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype_name) for a in (qm, km, vm))
    got = _f32(attention_core(tq, tk, tv, torch.from_numpy(kmaskf), h, 0.0))
    pal = _f32(_core_train_fwd_pallas(jq, jk, jv, jnp.asarray(kmaskf),
                                      jnp.zeros((), jnp.int32), h, 0.0, interpret=True))
    ref = _f32(merged_attention_reference(jq, jk, jv, jnp.asarray(kmaskf > 0), None, h))
    tol = 1e-6 if dtype_name == "float32" else 2.0 ** -8 * 4
    assert np.abs(got - pal).max() <= tol, np.abs(got - pal).max()
    assert np.abs(got - ref).max() <= tol, np.abs(got - ref).max()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,Lq,Lk", [(14, 1, 7), (14, 7, 7), (14, 16, 9), (3, 12, 16),
                                     (2, 5, 3)])
def test_attention_core_plain_matches_jax_heads_and_queries(dtype_name, h, Lq, Lk):
    """Kernel 2's plain version at the shapes its tensor-core kernel tiles
    (h up to 14, qwen2-0.5B's heads; Lq from 1 to 16, one m16 tile; Lk past
    one n8 tile) vs _core_train_fwd_pallas(rate=0, interpret=True) and
    merged_attention_reference, with all-padding rows. Tolerances: f32 1e-6
    absolute on values of magnitude < 4; bf16 one ulp at that scale."""
    B, d = 6, 64
    rng = np.random.default_rng(100 * h + Lq)
    qm = rng.normal(size=(B, Lq * h, d)).astype(np.float32)
    km = rng.normal(size=(B, Lk * h, d)).astype(np.float32)
    vm = rng.normal(size=(B, Lk * h, d)).astype(np.float32)
    mask = rng.random((B, Lk)) > 0.3
    mask[:, 0] = True
    mask[2] = False
    kmaskf = np.repeat(mask, h, axis=-1).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype_name) for a in (qm, km, vm))
    got = _f32(attention_core(tq, tk, tv, torch.from_numpy(kmaskf), h, 0.0))
    pal = _f32(_core_train_fwd_pallas(jq, jk, jv, jnp.asarray(kmaskf),
                                      jnp.zeros((), jnp.int32), h, 0.0, interpret=True))
    ref = _f32(merged_attention_reference(jq, jk, jv, jnp.asarray(kmaskf > 0), None, h))
    tol = 1e-6 if dtype_name == "float32" else 2.0 ** -8 * 4
    assert np.abs(got - pal).max() <= tol, np.abs(got - pal).max()
    assert np.abs(got - ref).max() <= tol, np.abs(got - ref).max()


def test_attention_core_dropout_raises():
    """Dropout inside the core is ported (tests/test_torch_port_train_kernels.py
    holds it); a rate outside [0, 1) raises."""
    q = torch.zeros(2, 2, 64)
    assert torch.isfinite(attention_core(q, q, q, torch.ones(2, 2), 2, 0.1, seed=3)).all()
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout rate"):
            attention_core(q, q, q, torch.ones(2, 2), 2, rate)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_layer_norm_matches_flax_exact(dtype_name):
    """The port's LayerNorm is the flax-exact arithmetic (fast variance,
    rsqrt * scale first): equal to layer_norm_flax_exact within 2 f32 ulps
    before the cast (exact in bf16 on these inputs)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 96)).astype(np.float32) * 3
    scale = rng.normal(size=96).astype(np.float32)
    bias = rng.normal(size=96).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    jx, tx = _pair(x, dtype_name)
    ref = _f32(layer_norm_flax_exact(jx, jnp.asarray(scale), jnp.asarray(bias), 1e-12, jdt))
    got = _f32(port_layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias), 1e-12, tdt))
    if dtype_name == "float32":
        np.testing.assert_allclose(got, ref, rtol=2.5e-7, atol=1e-6)
    else:
        assert np.abs(got - ref).max() <= 2.0 ** -8 * np.abs(ref).max()
