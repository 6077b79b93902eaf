"""The training route's attention core in the port (kernels 2 and 3 of
zett_tpu_torch/ops/attention_core.py, plain versions) held against the JAX
package: the Pallas backward kernel in interpret mode and jax.vjp of its
differentiable fallback, on the same numpy-seeded inputs. Dropout is held to
Philox's published test vectors and statistically (keep rate, forward and
backward masks agree, the mask does not depend on how the batch is split);
the CUDA kernels themselves run only on the card (chip_smoke.py phase 5)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zett_tpu.ops.pallas_attention import (
    _core_train_bwd_pallas,
    _core_train_fallback,
    _core_train_fwd_pallas,
)
from zett_tpu_torch.ops import _build
from zett_tpu_torch.ops.attention_core import (
    softmax_weights,
    attention_core_bwd_reference,
    attention_core_reference,
    keep_mask,
    merged_attention_train,
    philox_word0,
)
from zett_tpu_torch.ops.encoder_layer import encoder_layer

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
H = 2  # heads of 64


def _inputs(B, Lq, Lk, dtype_name, seed, all_padding=(1, 4)):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, L * H, 64)).astype(np.float32) for L in (Lq, Lk, Lk, Lq)]
    mask = rng.random((B, Lk)) > 0.3
    mask[:, 0] = True
    for r in all_padding:
        if r < B:
            mask[r] = False
    kmaskf = np.repeat(mask, H, axis=-1).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    jx = [jnp.asarray(a, jdt) for a in arrs] + [jnp.asarray(kmaskf)]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs] + [torch.from_numpy(kmaskf)]
    return jx, tx, mask


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(dtype_name, ref):
    """f32: 1e-5 of the output scale (sums in another order). bf16: 2 ulps
    of the largest magnitude (one f32 sum in another order can round an
    intermediate the other way)."""
    scale = max(float(np.abs(ref).max()), 1.0)
    return 1e-5 * scale if dtype_name == "float32" else 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,Lq", [(7, 7), (7, 1), (1, 1)])
def test_plain_backward_matches_jax(dtype_name, L, Lq):
    """Kernel 3's plain version against the Pallas backward kernel
    (interpret mode) on rows with a valid key, and against jax.vjp of the
    differentiable fallback on every row, all-padding rows included."""
    jx, tx, mask = _inputs(6, Lq, L, dtype_name, seed=L * 10 + Lq)
    jq, jk, jv, jg, jm = jx
    tq, tk, tv, tg, tm = tx
    got = attention_core_bwd_reference(tq, tk, tv, tm, tg, H)
    seed = jnp.zeros((), jnp.int32)
    pallas = _core_train_bwd_pallas(jq, jk, jv, jm, seed, jg, H, 0.0, interpret=True)
    _, vjp = jax.vjp(lambda q, k, v: _core_train_fallback(q, k, v, jm, seed, H, 0.0), jq, jk, jv)
    fallback = vjp(jg)
    rows = mask.any(1)
    for name, g, p, f in zip(("dq", "dk", "dv"), got, pallas, fallback):
        g, p, f = _f32(g), _f32(p), _f32(f)
        tol = _tol(dtype_name, f)
        assert np.abs(g - f).max() <= tol, (name, np.abs(g - f).max(), tol)
        assert np.abs(g[rows] - p[rows]).max() <= tol, (name, np.abs(g[rows] - p[rows]).max())
    assert not rows.all()
    assert np.abs(_f32(got[0])[~rows]).max() == 0.0  # no valid key: no dq


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_plain_forward_matches_pallas(dtype_name):
    jx, tx, _ = _inputs(6, 7, 7, dtype_name, seed=3)
    got = attention_core_reference(*tx[:3], tx[4], H)
    want = _core_train_fwd_pallas(*jx[:3], jx[4], jnp.zeros((), jnp.int32), H, 0.0,
                                  interpret=True)
    want = _f32(want)
    assert np.abs(_f32(got) - want).max() <= _tol(dtype_name, want)


def test_philox_known_answers():
    """Philox4x32-10's published test vectors (first output word)."""
    z = torch.zeros((), dtype=torch.int64)
    ones = torch.tensor(0xFFFFFFFF)
    pi = [torch.tensor(v) for v in (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)]
    assert int(philox_word0(z, z, z, z, 0, 0)) == 0x6627E8D5
    assert int(philox_word0(ones, ones, ones, ones, 0xFFFFFFFF, 0xFFFFFFFF)) == 0x408F276D
    assert int(philox_word0(*pi, 0xA4093822, 0x299F31D0)) == 0xD16CFE09


def test_keep_mask_rate_and_split_invariance():
    rate, B, Lqh, Lkh = 0.1, 40, 14, 14
    full = keep_mask(1234, B, Lqh, Lkh, rate, "cpu")
    n = full.numel()
    frac = full.float().mean().item()
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(frac - (1 - rate)) < 5 * sigma
    parts = torch.cat([keep_mask(1234, 13, Lqh, Lkh, rate, "cpu", row_offset=0),
                       keep_mask(1234, 27, Lqh, Lkh, rate, "cpu", row_offset=13)])
    assert torch.equal(full, parts)
    assert not torch.equal(full, keep_mask(1235, B, Lqh, Lkh, rate, "cpu"))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_dropout_forward_and_backward_share_the_mask(dtype_name):
    """At rate 0.1 the output is the rate-0 core with the dropped weights
    zeroed and the kept ones scaled; the backward zeroes exactly the entries
    the forward dropped: with dout = one-hot on a query row, dv of a key is
    zero precisely where that (query, key) weight was dropped."""
    rate, seed = 0.1, 77
    _, tx, mask = _inputs(5, 7, 7, dtype_name, seed=5)
    tq, tk, tv, _, tm = tx
    out = attention_core_reference(tq, tk, tv, tm, H, rate, seed)
    keep = keep_mask(seed, 5, 7 * H, 7 * H, rate, "cpu")
    w, _ = softmax_weights(tq, tk, tm, H)
    div = torch.tensor(1 - rate, dtype=tq.dtype)
    manual = torch.einsum("bqk,bkd->bqd", torch.where(keep, w / div, 0).float(),
                          tv.float()).to(tq.dtype)
    assert torch.equal(out, manual)
    for qi in range(7 * H):
        g = torch.zeros_like(tq)
        g[:, qi] = 1.0
        _, _, dv = attention_core_bwd_reference(tq, tk, tv, tm, g, H, rate, seed)
        nonzero = dv.float().abs().sum(-1) > 0
        expect = keep[:, qi] & (w[:, qi] > 0)
        assert torch.equal(nonzero, expect), qi


def test_merged_attention_train_gradcheck():
    """The autograd.Function's plain forward and hand-written backward in
    f64, rate 0 and 0.1, with a masked key and an all-padding row (head
    width 8: the plain versions take any width)."""
    rng = np.random.default_rng(0)
    B, L = 3, 2
    q, k, v = (torch.from_numpy(rng.normal(size=(B, L * H, 8))).requires_grad_()
               for _ in range(3))
    mask = np.ones((B, L), bool)
    mask[0, 1] = False
    mask[2] = False
    kmaskf = torch.from_numpy(np.repeat(mask, H, -1).astype(np.float64))
    for rate in (0.0, 0.1):
        assert torch.autograd.gradcheck(
            lambda a, b, c: merged_attention_train(a, b, c, kmaskf, 9, H, rate),
            (q, k, v), eps=1e-6, atol=1e-6)


def test_merged_attention_train_cpu_counts_nothing():
    before = dict(_build.launch_counts)
    _, tx, _ = _inputs(3, 7, 7, "float32", seed=1)
    q = tx[0].clone().requires_grad_()
    merged_attention_train(q, tx[1], tx[2], tx[4], 0, H, 0.0).sum().backward()
    assert q.grad is not None and _build.launch_counts == before


def test_encoder_layer_kernel_raises_under_grad():
    """Kernel 1 is forward-only: off the CPU it refuses inputs that require
    grad instead of returning an output with no grad_fn."""
    Hd, L, B = 128, 4, 2
    x = torch.empty(B, L, Hd, device="meta", requires_grad=True)
    w, b = torch.empty(Hd, Hd, device="meta"), torch.empty(Hd, device="meta")
    with pytest.raises(RuntimeError, match="requires grad"):
        encoder_layer(x, None, w, b, w, b, w, b, w, b, b, b, w, b, w, b, b, b,
                      num_heads=2, eps=1e-5)


def _head_mask_inputs(dtype_name, seed, masks, h=H, d=64, L=7):
    """Inputs with per-head key masks ``masks`` (B, L, h): kmaskf (B, L*h)
    position-major, as the merged operands."""
    rng = np.random.default_rng(seed)
    B = masks.shape[0]
    arrs = [rng.normal(size=(B, L * h, d)).astype(np.float32) for _ in range(4)]
    kmaskf = masks.reshape(B, L * h).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    jx = [jnp.asarray(a, jdt) for a in arrs] + [jnp.asarray(kmaskf)]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs] + [torch.from_numpy(kmaskf)]
    return jx, tx


def _mixed_masks(seed, B=6, L=7, h=H):
    """Ragged keys; row 0: head 0 has no valid key, the others do; row 2:
    the last head has none; row 4: no head has one."""
    rng = np.random.default_rng(seed)
    m = rng.random((B, L, h)) > 0.3
    m[:, 0, :] = True
    m[0, :, 0] = False
    m[2, :, h - 1] = False
    m[4] = False
    return m


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_plain_backward_all_padding_rows_match_jax(dtype_name):
    """Rows whose every head has no valid key: each query weights all Lk*h
    merged keys alike, w = round(1/(Lk*h)), so every dv row of such a row
    is w times the row's dout summed over its Lq*h queries, and dq = dk = 0,
    as jax.vjp of the differentiable fallback gives (rate 0)."""
    masks = np.repeat(_mixed_masks(13)[:, :, :1], H, axis=2)
    masks[[1, 4]] = False
    jx, tx = _head_mask_inputs(dtype_name, 14, masks)
    jq, jk, jv, jg, jm = jx
    tq, tk, tv, tg, tm = tx
    got = attention_core_bwd_reference(tq, tk, tv, tm, tg, H)
    seed = jnp.zeros((), jnp.int32)
    _, vjp = jax.vjp(lambda q, k, v: _core_train_fallback(q, k, v, jm, seed, H, 0.0), jq, jk, jv)
    for name, g, f in zip(("dq", "dk", "dv"), got, vjp(jg)):
        g, f = _f32(g), _f32(f)
        assert np.abs(g - f).max() <= _tol(dtype_name, f), (name, np.abs(g - f).max())
    rows = ~masks.any(axis=(1, 2))
    assert rows.sum() == 3  # rows 0 (head 0 of _mixed_masks), 1 and 4
    w = float(torch.tensor(1.0 / (7 * H), dtype=tq.dtype))
    expect = w * _f32(tg).sum(axis=1, keepdims=True)[rows]
    dv = _f32(got[2])[rows]
    assert np.abs(dv - expect).max() <= _tol(dtype_name, expect), np.abs(dv - expect).max()
    assert not _f32(got[0])[rows].any() and not _f32(got[1])[rows].any()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_plain_backward_mixed_head_masks_match_jax(dtype_name):
    """Key masks that differ between the heads of a row (rate 0), held
    against jax.vjp of the differentiable fallback on every row, and
    against the Pallas kernel (interpret mode), which works on the whole
    merged plane: dv everywhere, dq at the queries of heads with a valid
    key, dk in rows where every head has one (ROADMAP C.4: the Pallas
    kernel omits the select's gradient, which is what a query without a
    valid key would otherwise add). The padding heads' dq and dk are 0."""
    masks = _mixed_masks(15)
    jx, tx = _head_mask_inputs(dtype_name, 16, masks)
    jq, jk, jv, jg, jm = jx
    tq, tk, tv, tg, tm = tx
    got = [_f32(g) for g in attention_core_bwd_reference(tq, tk, tv, tm, tg, H)]
    seed = jnp.zeros((), jnp.int32)
    _, vjp = jax.vjp(lambda q, k, v: _core_train_fallback(q, k, v, jm, seed, H, 0.0), jq, jk, jv)
    pallas = [_f32(p) for p in _core_train_bwd_pallas(jq, jk, jv, jm, seed, jg, H, 0.0,
                                                      interpret=True)]
    for name, g, f in zip(("dq", "dk", "dv"), got, vjp(jg)):
        f = _f32(f)
        assert np.abs(g - f).max() <= _tol(dtype_name, f), (name, np.abs(g - f).max())
    pad = ~masks.any(axis=1)  # (B, h): heads with no valid key
    merged_pad = np.tile(pad, 7)  # (B, L*h), index position*h + head
    tol = _tol(dtype_name, pallas[2])
    assert np.abs(got[2] - pallas[2]).max() <= tol
    assert np.abs(got[0] - pallas[0])[~merged_pad].max() <= tol
    whole_rows = ~pad.any(1)
    assert np.abs(got[1] - pallas[1])[whole_rows].max() <= tol
    assert not got[0][merged_pad].any() and not got[1][merged_pad].any()
    assert pad[0].tolist() == [True, False] and pad[4].all()


@pytest.mark.parametrize("kind", ["all_padding", "mixed"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_backward_head_masks_match_autograd(kind, rate):
    """The hand-written backward against autograd of the plain forward in
    f64, on rows whose heads all lack a valid key and on rows whose heads
    differ, at rates 0 and 0.1; and the share of the padding heads' queries
    in dv: dv less dv with their dout zeroed is sum keep * wd * dout over
    those queries at every merged key, the keep bit at counter (row, merged
    query, merged key) as the forward draws it."""
    masks = _mixed_masks(17)
    if kind == "all_padding":
        masks = np.repeat(masks[:, :, 1:2], H, axis=2)
        masks[[0, 3]] = False
    _, tx = _head_mask_inputs("float32", 18, masks)
    q, k, v, g = (t.double().requires_grad_(i < 3) for i, t in enumerate(tx[:4]))
    kmaskf = tx[4].double()
    seed, B, h, L = 9, masks.shape[0], H, 7
    attention_core_reference(q, k, v, kmaskf, h, rate, seed).backward(g)
    got = [t.detach() for t in attention_core_bwd_reference(q, k, v, kmaskf, g, h, rate, seed)]
    for name, a, b in zip(("dq", "dk", "dv"), got, (q.grad, k.grad, v.grad)):
        tol = 1e-6 * max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= tol, name
    pad = ~masks.any(axis=1)
    merged_pad = torch.from_numpy(np.tile(pad, L))
    g0 = torch.where(merged_pad[..., None], torch.zeros((), dtype=g.dtype), g.detach())
    dv0 = attention_core_bwd_reference(q, k, v, kmaskf, g0, h, rate, seed)[2].detach()
    keep = keep_mask(seed, B, L * h, L * h, rate, "cpu") & merged_pad[:, :, None]
    wd = 1.0 / (L * h) / (1.0 - rate)
    share = wd * torch.einsum("bqk,bqd->bkd", keep.double(), g.detach())
    assert float((got[2] - dv0 - share).abs().max()) <= 1e-12
    assert pad.any() and not got[0][merged_pad].any()
