"""Kernel 1: the whole hypernet encoder layer (forward), and its plain
PyTorch version.

Replaces ``zett_tpu/ops/pallas_attention.py`` ``_layer_kernel`` /
``encoder_layer_pallas`` (:727, :825), the tier-3 TPU kernel. The CUDA
source is ``zett_tpu_torch/csrc/encoder_layer.cu``; its header note gives
the bound (tensor-core operations at the transfer's shapes) and the design.
``layer_plan`` says how a shape runs: in bf16 at head width 64, four device
kernels a layer (the [q|k|v] GEMM with the attention core in its epilogue,
the output projection and the FFN-out each with the residual LayerNorm in
theirs, on thread-block clusters of ``cluster`` CTAs, and the gelu FFN-in
GEMM); in bf16 at head width 128 or past ``FUSED_MAX_HEADS`` heads of 64,
and in f32, the seven launches of the unfused sequence (the header note of
``encoder_layer.cu`` says why 128 does not fuse; past 16 heads of 64 a
LayerNorm cluster would be over the portable size). The shared attention
core takes up to 32 heads (``attention_core.MAX_HEADS_BF16``).

``encoder_layer`` keeps the JAX function's signature. On CPU tensors it runs
``encoder_layer_reference``; on any other device it launches the kernel or
raises. The kernel is forward-only: its output has no ``grad_fn``, so the
wrapper raises when grad mode is on and an input requires grad rather than
silently stopping the gradient (training takes the tier-4 route,
``attention_core.merged_attention_train``).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch

from . import _build
from .attention_core import (check_head_width, check_heads, check_row_fits,
                             merged_attention_reference)

_NAME = "encoder_layer"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_flax_exact(x, scale, bias, eps: float, out_dtype):
    """flax.linen.LayerNorm's arithmetic: f32 statistics with the fast
    variance max(0, E[x^2] - mean^2), rsqrt(var + eps) times the scale before
    it multiplies (x - mean), f32 affine, one cast at the end
    (``layer_norm_flax_exact``, pallas_attention.py:692)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    mu2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    return ((xf - mu) * mul + bias.float()).to(out_dtype)


def gelu(x):
    """tanh-approximate gelu (flax nn.gelu's default), computed in f32 on
    the compute-dtype value and cast once."""
    xf = x.float()
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (xf + 0.044715 * (xf ** 3))))
    return (xf * cdf).to(x.dtype)


def dense_exact(x, w, b):
    """x @ w accumulated in f32, cast to the compute dtype, then + b in that
    dtype (flax nn.Dense; pallas_attention.py:741-744)."""
    return (x.float() @ w.float()).to(x.dtype) + b


def encoder_layer_reference(x, mask, wq, bq, wk, bk, wv, bv, wo, bo,
                            ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b,
                            num_heads: int, eps: float):
    """Plain version of kernel 1 (``encoder_layer_reference``,
    pallas_attention.py:712). x (B, L, H); mask (B, L) bool or None; weights
    (in, out) and biases in x's dtype; LayerNorm params f32."""
    B, L, H = x.shape
    h = num_heads
    d = H // h
    q = dense_exact(x, wq, bq)
    k = dense_exact(x, wk, bk)
    v = dense_exact(x, wv, bv)
    if mask is None:
        mask = torch.ones(B, L, dtype=torch.bool, device=x.device)
    kmask = mask.bool().repeat_interleave(h, dim=-1)
    ctx = merged_attention_reference(
        q.reshape(B, L * h, d), k.reshape(B, L * h, d), v.reshape(B, L * h, d), kmask,
        num_heads=h,
    ).reshape(B, L, H)
    attn = dense_exact(ctx, wo, bo)
    y1 = layer_norm_flax_exact(attn + x, ln1_s, ln1_b, eps, x.dtype)
    mid = gelu(dense_exact(y1, w1, b1))
    ffn = dense_exact(mid, w2, b2)
    return layer_norm_flax_exact(ffn + y1, ln2_s, ln2_b, eps, x.dtype)


def encoder_layer(x, mask: Optional[torch.Tensor], wq, bq, wk, bk, wv, bv, wo, bo,
                  ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, *,
                  num_heads: int, eps: float):
    """One post-LN encoder layer with tanh-gelu: x (B, L, H) -> (B, L, H).
    CPU tensors take the plain version; on the card this launches kernel 1."""
    args = (x, mask, wq, bq, wk, bk, wv, bv, wo, bo,
            ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b)
    if x.device.type == "cpu":
        return encoder_layer_reference(*args, num_heads, eps)
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in args
    ):
        raise RuntimeError(
            "encoder_layer: the kernel is forward-only and an input requires grad; "
            "differentiate through the tier-4 route (merged_attention_train)"
        )
    return _launch(*args, num_heads=num_heads, eps=eps)


def check_gemm_widths(what: str, dtype, widths, depths) -> None:
    """Raise ValueError on what the GEMMs of ``csrc/gemm.cuh`` refuse: rows
    (output ``widths`` N and ``depths`` K) that are not whole 16-byte units,
    TMA's stride rule. Any other width is taken: the last N and k tiles may
    be partial (TMA zero-fills the loads past the edge and clips the
    stores)."""
    size = torch.finfo(dtype).bits // 8
    for n in (*widths, *depths):
        if n * size % 16:
            raise ValueError(f"{what}: rows of {n} {dtype} values are not a multiple of "
                             "16 bytes")


TILE_ROWS = 128       # the Hopper GEMMs' row tile (gemm.cuh GM)
CLUSTER_SLICE = 192   # the columns of one CTA of a LayerNorm cluster (encoder_layer.cu kLnN)
GELU_TILE_COLS = 192  # the gelu GEMM's column tile (encoder_layer.cu kGeluN)
# heads of the fused route (encoder_layer.cu kFusedMaxHeads): past 16 heads
# of 64 a LayerNorm cluster would be over the portable 8 CTAs
FUSED_MAX_HEADS = 16


@dataclass(frozen=True)
class LayerPlan:
    """How kernel 1 runs one shape. ``launches``: device kernels a layer;
    ``cluster``: CTAs of a LayerNorm GEMM's cluster (a row's H columns,
    ``CLUSTER_SLICE`` each); ``tile_forms``, ``tile_rows``: the surface
    forms and rows of a [q|k|v] tile (whole forms within ``TILE_ROWS``).
    The f32 route runs the unfused sequence and has no tiles or clusters
    (0)."""

    route: str
    launches: int
    cluster: int
    tile_forms: int
    tile_rows: int


def layer_plan(dtype, L: int, H: int, num_heads: int, I: int) -> LayerPlan:
    """The plan for x (B, L, H) with ``num_heads`` heads and FFN width I, or
    the error the kernel's wrapper raises before any launch. A pure
    function of the shape: nothing is built or launched."""
    if dtype not in _DTYPES:
        raise TypeError(f"encoder_layer: unsupported dtype {dtype}")
    check_head_width("encoder_layer", H, num_heads)
    if not 1 <= L <= 32:
        raise ValueError(f"encoder_layer: sequence length {L} outside 1..32")
    check_heads("encoder_layer", dtype, num_heads, L)
    check_gemm_widths("encoder_layer", dtype, (3 * H, H, I), (H, I))
    if dtype == torch.float32 or H // num_heads == 128 or num_heads > FUSED_MAX_HEADS:
        check_row_fits("encoder_layer", dtype, L, L, num_heads, H // num_heads)
        return LayerPlan("unfused", 7, 0, 0, 0)
    forms = TILE_ROWS // L
    return LayerPlan("fused", 4, -(-H // CLUSTER_SLICE), forms, forms * L)


def pack_weights(*ws):
    """The GEMM's B operand: the (K, N_i) weights side by side, transposed to
    (sum N_i, K) row-major (K contiguous, as the wgmma reads it). Rebuilt
    at every call, never cached: the optimizer updates weights in place."""
    return torch.cat([w.t() for w in ws], dim=0)


def pack_qkv_by_head(wq, wk, wv, num_heads: int):
    """The bf16 [q|k|v] GEMM's weight, head by head: rows [192 i, 192 i +
    192) of the (3H, H) result are head i's q, k and v output columns,
    transposed (K contiguous). One copy, rebuilt at every call like
    ``pack_weights``."""
    K, h = wq.shape[0], num_heads
    w = torch.cat([t.t().reshape(h, 1, 64, K) for t in (wq, wk, wv)], dim=1)
    return w.view(3 * h * 64, K)


def pack_biases(bq, bk, bv, bo, b2, b1):
    """Every bias of the bf16 layer in one copy: [q | k | v], bo, b2, then
    b1 grown to whole gelu tiles (``GELU_TILE_COLS``) by repeating its own
    values (the columns past I are computed and never stored). Returns the
    (3H,), (H,), (H,) and padded b1 views, each 16-byte aligned."""
    I = b1.shape[0]
    parts, n = [bq, bk, bv, bo, b2, b1], I
    while n % GELU_TILE_COLS:
        take = min(I, -n % GELU_TILE_COLS)
        parts.append(b1[:take])
        n += take
    flat = torch.cat(parts)
    H = bo.shape[0]
    return flat[:3 * H], flat[3 * H:4 * H], flat[4 * H:5 * H], flat[5 * H:]


def _launch(x, mask, wq, bq, wk, bk, wv, bv, wo, bo,
            ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, *,
            num_heads, eps):
    B, L, H = x.shape
    I = w1.shape[1]
    lib = _build.load(_NAME)
    plan = layer_plan(x.dtype, L, H, num_heads, I)
    if not x.is_cuda:
        raise ValueError(f"encoder_layer: no kernel for device {x.device}")
    weights = (wq, bq, wk, bk, wv, bv, wo, bo, w1, b1, w2, b2)
    if any(t.dtype != x.dtype or t.device != x.device for t in weights):
        raise TypeError("encoder_layer: weights must match x's dtype and device")
    x = _build.aligned16(x)
    ln = [t.float().contiguous() for t in (ln1_s, ln1_b, ln2_s, ln2_b)]
    if plan.route == "fused":
        out = _launch_fused(lib, plan, x, mask, wq, bq, wk, bk, wv, bv, wo, bo, ln, w1, b1,
                            w2, b2, num_heads, eps)
    else:
        out = _launch_unfused(lib, x, mask, wq, bq, wk, bk, wv, bv, wo, bo, ln, w1, b1, w2,
                              b2, num_heads, eps)
    _build.count_launch(_NAME)
    return out


def _launch_fused(lib, plan, x, mask, wq, bq, wk, bk, wv, bv, wo, bo, ln, w1, b1, w2, b2,
                  num_heads, eps):
    B, L, H = x.shape
    I = w1.shape[1]
    dev = x.device
    # four copies: the weights transposed (K contiguous), [q|k|v] head by
    # head, Wo and W1 in one, W2; every bias in one
    w_qkv = pack_qkv_by_head(wq, wk, wv, num_heads)
    wo1_t = pack_weights(wo, w1)
    wo_t, w1_t = wo1_t[:H], wo1_t[H:]
    w2_t = pack_weights(w2)
    b_qkv, bo, b2, b1 = pack_biases(bq, bk, bv, bo, b2, b1)
    if mask is not None:
        mask = (mask if mask.dtype == torch.bool else mask > 0).contiguous().view(torch.uint8)
    M = B * L
    ctx = torch.empty(M, H, dtype=x.dtype, device=dev)
    y1 = torch.empty(M, H, dtype=x.dtype, device=dev)
    mid = torch.empty(M, I, dtype=x.dtype, device=dev)
    out = torch.empty(B, L, H, dtype=x.dtype, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.zt_encoder_layer_bf16
    fn.restype = i
    fn.argtypes = [p, p, i, i, i, i, i, i, i, p, p, p, p, p, p, p, p, p, p, p, p,
                   ctypes.c_float, p, p, p, p, p]
    err = fn(x.data_ptr(), None if mask is None else mask.data_ptr(), B, L, H, num_heads, I,
             plan.tile_forms, plan.cluster, w_qkv.data_ptr(), b_qkv.data_ptr(), wo_t.data_ptr(),
             bo.data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(), w1_t.data_ptr(), b1.data_ptr(),
             w2_t.data_ptr(), b2.data_ptr(), ln[2].data_ptr(), ln[3].data_ptr(), float(eps),
             ctx.data_ptr(), y1.data_ptr(), mid.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "encoder_layer kernel launch")
    return out


def _launch_unfused(lib, x, mask, wq, bq, wk, bk, wv, bv, wo, bo, ln, w1, b1, w2, b2,
                    num_heads, eps):
    B, L, H = x.shape
    I = w1.shape[1]
    dev, dtype = x.device, x.dtype
    maskf = (torch.ones(B, L, device=dev) if mask is None else mask.float()).contiguous()
    wqkv_t = pack_weights(wq, wk, wv)
    wo_t, w1_t, w2_t = (pack_weights(w) for w in (wo, w1, w2))
    bqkv = torch.cat([bq, bk, bv]).contiguous()
    bo, b1, b2 = (_build.aligned16(t) for t in (bo, b1, b2))
    M = B * L
    qkv = torch.empty(M, 3 * H, dtype=dtype, device=dev)
    ctx = torch.empty(M, H, dtype=dtype, device=dev)
    tmp = torch.empty(M, H, dtype=dtype, device=dev)
    y1 = torch.empty(M, H, dtype=dtype, device=dev)
    mid = torch.empty(M, I, dtype=dtype, device=dev)
    out = torch.empty(B, L, H, dtype=dtype, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.zt_encoder_layer_unfused
    fn.restype = i
    fn.argtypes = [i, p, p, i, i, i, i, i, p, p, p, p, p, p, p, p, p, p, p, p,
                   ctypes.c_float, p, p, p, p, p, p, p]
    err = fn(_DTYPES[dtype], x.data_ptr(), maskf.data_ptr(), B, L, H, num_heads, I,
             wqkv_t.data_ptr(), bqkv.data_ptr(), wo_t.data_ptr(), bo.data_ptr(),
             ln[0].data_ptr(), ln[1].data_ptr(), w1_t.data_ptr(), b1.data_ptr(),
             w2_t.data_ptr(), b2.data_ptr(), ln[2].data_ptr(), ln[3].data_ptr(),
             float(eps),
             qkv.data_ptr(), ctx.data_ptr(), tmp.data_ptr(), y1.data_ptr(),
             mid.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "encoder_layer kernel launch")
    return out
