"""The plain versions of kernel 5 (the tier-1 core with key bias) and kernel 4
(the tier-2 attention block), and attention_block_fused's backward, held
against the JAX package on the CPU: merged_attention_pallas /
attention_block_pallas in interpret mode on rows with a valid key, the
pure-JAX references on all rows, and jax.grad of the JAX
attention_block_fused.

The same numpy-seeded inputs go through both sides, at H = 128, 2 heads of
width 64 and L in {4, 7, 8, 9}; the key bias holds Unigram-prior-like values
and one key at the padding fill (-100000). The CUDA kernels run only on the
card (chip_smoke.py holds them against these plain versions there)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zett_tpu.ops.pallas_attention import attention_block_fused as jax_block_fused
from zett_tpu.ops.pallas_attention import (
    attention_block_pallas,
    attention_block_reference,
    merged_attention_pallas,
    merged_attention_reference,
)
from zett_tpu_torch.ops import attention_block, attention_block_fused, merged_attention

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
H, NH, D = 128, 2, 64


def _pair(a, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _mask_and_bias(rng, B, L):
    mask = rng.random((B, L)) > 0.3
    mask[:, 0] = True
    mask[1] = False  # all-padding rows
    mask[6] = False
    kbias = (rng.normal(size=(B, L)) * 2.0 - 6.0).astype(np.float32)
    kbias[:, -1] = -100000.0
    return mask, kbias


def _tol(dtype_name, scale):
    """f32: 2e-6 x scale (sums in another order); bf16: 2^-7 x scale, one
    bf16 ulp of the largest output (XLA rounds intermediate bf16 ops where
    the port rounds once, and an output near the top of its binade differs
    by one ulp of that binade)."""
    return (2e-6 if dtype_name == "float32" else 2.0 ** -7) * max(scale, 1.0)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("L", [4, 7, 8, 9])
def test_merged_attention_plain_matches_jax(L, with_bias, dtype_name):
    """Kernel 5's plain version vs merged_attention_reference (every row)
    and merged_attention_pallas(interpret=True) (rows with a valid key)."""
    B = 12
    rng = np.random.default_rng(L)
    q, k, v = (rng.normal(size=(B, L * NH, D)).astype(np.float32) for _ in range(3))
    mask, kbias = _mask_and_bias(rng, B, L)
    kmask = np.repeat(mask, NH, axis=-1)
    kb = np.repeat(kbias, NH, axis=-1) if with_bias else None
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype_name) for a in (q, k, v))
    jkb, tkb = _pair(kb, dtype_name) if with_bias else (None, None)
    got = _f32(merged_attention(tq, tk, tv, torch.from_numpy(kmask), tkb, num_heads=NH))
    ref = _f32(merged_attention_reference(jq, jk, jv, jnp.asarray(kmask), jkb, NH))
    pal = _f32(merged_attention_pallas(jq, jk, jv, jnp.asarray(kmask), jkb, num_heads=NH,
                                       tile_b=8, interpret=True))
    tol = _tol(dtype_name, np.abs(ref).max())
    live = mask.any(axis=1)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= tol, np.abs(got - ref).max()
    assert np.abs(got[live] - pal[live]).max() <= tol, np.abs(got[live] - pal[live]).max()


def _block_inputs(dtype_name, B, L, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H)).astype(np.float32)
    mask, kbias = _mask_and_bias(rng, B, L)
    ws = [rng.normal(size=(H, H)).astype(np.float32) * 0.08 for _ in range(4)]
    bs = [rng.normal(size=H).astype(np.float32) * 0.05 for _ in range(4)]
    jx, tx = _pair(x, dtype_name)
    jwb, twb = [], []
    for w, b in zip(ws, bs):
        (jw, tw), (jb, tb) = _pair(w, dtype_name), _pair(b, dtype_name)
        jwb += [jw, jb]
        twb += [tw, tb]
    return (jx, tx), mask, kbias, jwb, twb


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("L", [4, 7, 8, 9])
def test_attention_block_plain_matches_jax(L, with_bias, dtype_name):
    """Kernel 4's plain version vs attention_block_reference (every row) and
    attention_block_pallas(interpret=True) (rows with a valid key: the
    Pallas kernel pads L to a multiple of 8 with masked positions, so a row
    without a valid key averages over the padding's values too)."""
    B = 12
    (jx, tx), mask, kbias, jwb, twb = _block_inputs(dtype_name, B, L, seed=L)
    jkb, tkb = _pair(kbias, dtype_name) if with_bias else (None, None)
    got = _f32(attention_block(tx, torch.from_numpy(mask), tkb, *twb, num_heads=NH))
    ref = _f32(attention_block_reference(jx, jnp.asarray(mask), jkb, *jwb, NH))
    pal = _f32(attention_block_pallas(jx, jnp.asarray(mask), jkb, *jwb, num_heads=NH, tile_b=8,
                                      interpret=True))
    tol = _tol(dtype_name, np.abs(ref).max())
    live = mask.any(axis=1)
    assert np.isfinite(got).all() and got.shape == (B, L, H)
    assert np.abs(got - ref).max() <= tol, np.abs(got - ref).max()
    assert np.abs(got[live] - pal[live]).max() <= tol, np.abs(got[live] - pal[live]).max()
    gap = np.abs(got[~live] - pal[~live]).max()
    print(f"L={L} {dtype_name} bias={with_bias}: Pallas vs reference on rows "
          f"without a valid key, max abs {gap:.3g}")
    if L % 8:
        assert gap > tol  # the padding's gap, logged in ROADMAP §C


@pytest.mark.parametrize("masked,with_bias", [(True, False), (False, False), (True, True)])
def test_attention_block_fused_grads_match_jax(masked, with_bias):
    """attention_block_fused's backward (without key bias: torch matmuls
    around the plain versions of kernels 2 and 3; with it: autograd through
    the plain block) vs jax.grad of the JAX attention_block_fused on the CPU,
    every input, f32, within 1e-5 of each gradient's largest value (or of
    1% of the largest of all, for the key bias, whose exact gradient is 0:
    the softmax ignores a per-query constant); the forward within 2e-6 of
    its scale."""
    B, L = 12, 7
    rng = np.random.default_rng(5)
    (jx, tx), mask, kbias, jwb, twb = _block_inputs("float32", B, L, seed=11)
    if not masked:
        mask = np.ones_like(mask)
    maskf = mask.astype(np.float32)
    cot = rng.normal(size=(B, L, H)).astype(np.float32)

    def jloss(*args):
        out = jax_block_fused(args[0], jnp.asarray(maskf), jnp.asarray(kbias), *args[1:], NH,
                              masked, with_bias)
        return (out * cot).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(9)), has_aux=True)(jx, *jwb)
    leaves = [t.clone().requires_grad_() for t in [tx] + twb]
    out = attention_block_fused(leaves[0], torch.from_numpy(maskf), torch.from_numpy(kbias),
                                *leaves[1:], NH, masked, with_bias)
    (out * torch.from_numpy(cot)).sum().backward()
    assert np.abs(_f32(out) - _f32(jout)).max() <= 2e-6 * np.abs(_f32(jout)).max()
    floor = 1e-2 * max(np.abs(_f32(g)).max() for g in jgrads)
    for i, (leaf, want) in enumerate(zip(leaves, jgrads)):
        want = _f32(want)
        err = np.abs(_f32(leaf.grad) - want).max()
        assert err <= 1e-5 * max(np.abs(want).max(), floor), (i, err, np.abs(want).max())


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers return the plain versions' values and
    count no launch."""
    from zett_tpu_torch.ops import _build

    before = dict(_build.launch_counts)
    (jx, tx), mask, kbias, jwb, twb = _block_inputs("float32", 8, 5, seed=2)
    attention_block(tx, torch.from_numpy(mask), None, *twb, num_heads=NH)
    q = torch.randn(8, 5 * NH, D)
    merged_attention(q, q, q, None, None, num_heads=NH)
    assert _build.launch_counts == before
