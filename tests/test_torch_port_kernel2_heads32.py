"""Kernel 2 (the attention-core forward) on the inputs that its 32-head,
head-width-128 kernel carries across the CTAs of a cluster: key masks whose
heads differ within a row and rows with no valid key at all. The card holds
the kernel against the plain version (``chip_smoke.py`` phase 15(b)); here
the plain version is held against the JAX package on exactly those inputs,
at 4 heads of 128 and at 32 heads of 128 with a few rows: at rate 0 against
``_core_train_fwd_pallas(interpret=True)`` and the differentiable fallback,
at rate 0.1 against the fallback with its keep mask handed to the plain
version (the Pallas kernel's TPU bits have no CPU rule). Also the rows the
bf16 forward admits past 16 heads of 128, and the cluster's staging of each
(``cluster_plan``)."""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zett_tpu.ops.pallas_attention import _core_train_fallback, _core_train_fwd_pallas
from zett_tpu_torch.ops.attention_core import (
    CLUSTER_MAX_STAGES,
    SMEM_BYTES,
    attention_core_reference,
    check_heads,
    check_row_fits,
    cluster_plan,
)

core = importlib.import_module("zett_tpu_torch.ops.attention_core")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, L, d = 6, 7, 128
BF = torch.bfloat16


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(dtype_name, ref):
    """f32: 1e-5 of the output scale (sums in another order). bf16: 2 ulps
    of the largest magnitude (an f32 sum in another order can round an
    intermediate the other way)."""
    scale = max(float(np.abs(ref).max()), 1.0)
    return 1e-5 * scale if dtype_name == "float32" else 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)


def _head_masks(kind, h, seed):
    """(B, L, h) key masks, ragged, as ``test_torch_port_head128.py``'s at
    any head count. "mixed": row 0 heads 0 and h/2 without a valid key (one
    in each half of a two-CTA cluster), row 3 head h - 1, row 5 heads 1 to
    h - 1, row 1 no head with one; "all_padding": every head masked alike,
    rows 1 and 4 without any."""
    rng = np.random.default_rng(seed)
    m = rng.random((B, L, h)) > 0.3
    m[:, 0, :] = True
    if kind == "all_padding":
        m = np.repeat(m[:, :, :1], h, axis=2)
        m[[1, 4]] = False
        return m
    m[0, :, [0, h // 2]] = False
    m[1] = False
    m[3, :, h - 1] = False
    m[5, :, 1:] = False
    return m


def _inputs(dtype_name, masks, seed):
    h = masks.shape[-1]
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, L * h, d)).astype(np.float32) for _ in range(3)]
    kmaskf = masks.reshape(B, L * h).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    jx = [jnp.asarray(a, jdt) for a in arrs] + [jnp.asarray(kmaskf)]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs] + [torch.from_numpy(kmaskf)]
    return jx, tx


CASES = [(kind, h) for kind in ("mixed", "all_padding") for h in (4, 32)]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,h", CASES)
def test_plain_head_masks_match_pallas_and_fallback(kind, h, dtype_name):
    """Rate 0: the plain version against _core_train_fwd_pallas(interpret=
    True) and the fallback on rows whose heads differ and rows with no valid
    key; tolerance as ``_tol``."""
    masks = _head_masks(kind, h, 70 + h)
    jx, tx = _inputs(dtype_name, masks, 71 + h)
    seed = jnp.asarray(3, jnp.int32)
    got = _f32(attention_core_reference(*tx[:3], tx[3], h))
    assert got.shape == (B, L * h, d) and np.isfinite(got).all()
    for ref in (_core_train_fwd_pallas(*jx[:3], jx[3], seed, h, 0.0, interpret=True),
                _core_train_fallback(*jx[:3], jx[3], seed, h, 0.0)):
        ref = _f32(ref)
        assert np.abs(got - ref).max() <= _tol(dtype_name, ref), np.abs(got - ref).max()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,h", CASES)
def test_plain_head_masks_at_rate_01_match_fallback(kind, h, dtype_name, monkeypatch):
    """Rate 0.1: the plain version against the fallback with the fallback's
    bernoulli keep mask in place of Philox (both sides drop the same
    weights), on the same masks; tolerance as ``_tol``."""
    rate = 0.1
    masks = _head_masks(kind, h, 80 + h)
    jx, tx = _inputs(dtype_name, masks, 81 + h)
    seed = jnp.asarray(9, jnp.int32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), seed.astype(jnp.uint32))
    keep = np.array(jax.random.bernoulli(key, 1.0 - rate, (B, L * h, L * h)))
    monkeypatch.setattr(core, "keep_mask", lambda *a, **k: torch.from_numpy(keep))
    got = _f32(attention_core_reference(*tx[:3], tx[3], h, rate, 9))
    ref = _f32(_core_train_fallback(*jx[:3], jx[3], seed, h, rate))
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= _tol(dtype_name, ref), np.abs(got - ref).max()
    # a head without a valid key keeps a share of every head's values
    pad = np.tile(~masks.any(axis=1), L)  # (B, L*h): merged query index position*h + head
    assert np.abs(got[pad]).max() > 0


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,h", CASES)
def test_padding_head_is_the_rows_mean_over_every_head(kind, h, dtype_name):
    """At rate 0 a head without a valid key returns, for every query,
    round(1/(Lk·h)) times the row's merged value rows summed over every
    position and every head: the term the cluster kernel adds across its
    CTAs. Tolerance: 2 ulps of the output scale in bf16 (the same f32 terms
    summed in another order, one cast), 1e-5 of it in f32."""
    masks = _head_masks(kind, h, 90 + h)
    _, tx = _inputs(dtype_name, masks, 91 + h)
    got = _f32(attention_core_reference(*tx[:3], tx[3], h))
    w = float(torch.tensor(1.0 / (L * h), dtype=tx[0].dtype))
    total = w * _f32(tx[2]).sum(axis=1)  # (B, d)
    pad = ~masks.any(axis=1)  # (B, h)
    assert pad.any(1).sum() == (2 if kind == "all_padding" else 4)
    for b, hd in zip(*np.nonzero(pad)):
        rows = got[b, hd::h]  # the head's Lq queries
        assert np.abs(rows - total[b]).max() <= _tol(dtype_name, total[b]), (b, hd)


def _admitted_today(Lq, Lk, h):
    """The rows the bf16 forward admitted before the cluster kernel: one
    whole row (zero row, per-head value sums, q, k and v positions) in one
    block's 232,448 bytes."""
    return 2 * d + h * 32 * 8 * (d // 64) + 2 * (Lq + 2 * Lk) * (h * d + 8) <= 232448


@pytest.mark.parametrize("h", range(17, 33))
def test_rows_admitted_past_16_heads_keep_two_stages(h):
    """Every (Lq, Lk) at h heads of 128 that was admitted stays admitted,
    none other is, and the cluster's staging holds two or more stages of
    each (three or more at the CLS shapes, Lq 1 with Lk 7 and 8), within
    the block's shared memory."""
    for Lq in range(1, 17):
        check_heads("attention_core", BF, h, Lq)
        for Lk in range(1, 33):
            c, hl, stages, per_cta = cluster_plan(Lq, Lk, h, d)
            if not _admitted_today(Lq, Lk, h):
                with pytest.raises(ValueError, match="shared memory"):
                    check_row_fits("attention_core", BF, Lq, Lk, h, d)
                continue
            check_row_fits("attention_core", BF, Lq, Lk, h, d)
            assert c in (2, 3) and c * hl >= h and (c - 1) * hl < h
            assert 2 <= stages <= CLUSTER_MAX_STAGES and per_cta <= SMEM_BYTES, (Lq, Lk)
            # at rate > 0 a head without a valid key keeps its keep bits (4
            # a k16 step at Lq <= 8, else 8) for every CTA's keys in its
            # share of the value sums and totals (attention.cuh)
            steps = sum((Lk * min(hl, h - q * hl) + 15) // 16 for q in range(c))
            words = (steps * (8 if Lq > 8 else 4) + 31) // 32
            assert words <= (hl * 512 + 2 * 3 * 512) // 4 // hl // 32, (Lq, Lk)
            if Lq == 1 and Lk in (7, 8):
                assert stages >= 3, (Lk, stages)
    with pytest.raises(ValueError, match="past 16"):
        check_heads("attention_core", BF, h, 17)


def test_cluster_plan_at_32_heads_of_128():
    """Mistral-7B's and Llama-3-8B's rows: two CTAs of 16 heads, each
    position's share 4,104 bf16 (16 heads of 128 and the 16-byte pad):
    three stages at the CLS shapes, two at the full layer's L 7 and at the
    largest row admitted (Lq + 2 Lk = 26)."""
    assert cluster_plan(1, 7, 32, d)[:3] == (2, 16, 3)
    assert cluster_plan(1, 8, 32, d)[:3] == (2, 16, 3)
    assert cluster_plan(7, 7, 32, d)[:3] == (2, 16, 2)
    assert cluster_plan(16, 5, 32, d)[:3] == (2, 16, 2)
    stage = 2 * 15 * (16 * d + 8)
    # 16 heads' value sums, two parities of up to 3 CTAs' totals, the zero
    # row, 4 stages' two mbarriers and 16 flag words, 16 words
    fixed = 16 * 512 + 2 * 3 * 512 + 2 * d + 4 * (16 + 64) + 64
    assert stage == 61680 and cluster_plan(1, 7, 32, d)[3] == 3 * stage + fixed
