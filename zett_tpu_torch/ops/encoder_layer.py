"""Kernel 1: the whole hypernet encoder layer (forward), and its plain
PyTorch version.

Replaces ``zett_tpu/ops/pallas_attention.py`` ``_layer_kernel`` /
``encoder_layer_pallas`` (:727, :825), the tier-3 TPU kernel. The CUDA
source is ``zett_tpu_torch/csrc/encoder_layer.cu``; its header note gives
the bound (tensor-core operations at the transfer's shapes) and the design.

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
from typing import Optional

import torch

from . import _build
from .attention_core import check_heads, merged_attention_reference

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


def pack_weights(*ws):
    """The GEMM's B operand: the (K, N_i) weights side by side, transposed to
    (sum N_i, K) row-major (K contiguous, as the wgmma reads it). Rebuilt
    at every call, never cached: the optimizer updates weights in place."""
    return torch.cat(ws, dim=1).t().contiguous()


def _launch(x, mask, wq, bq, wk, bk, wv, bv, wo, bo,
            ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, *,
            num_heads, eps):
    lib = _build.load(_NAME)
    dtype = x.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"encoder_layer: unsupported dtype {dtype}")
    B, L, H = x.shape
    I = w1.shape[1]
    if H != num_heads * 64:
        raise ValueError(f"encoder_layer: head width must be 64 (H={H}, h={num_heads})")
    if not 1 <= L <= 32:
        raise ValueError(f"encoder_layer: sequence length {L} outside 1..32")
    check_heads("encoder_layer", dtype, num_heads)
    check_gemm_widths("encoder_layer", dtype, (3 * H, H, I), (H, I))
    if not x.is_cuda:
        raise ValueError(f"encoder_layer: no kernel for device {x.device}")
    weights = (wq, bq, wk, bk, wv, bv, wo, bo, w1, b1, w2, b2)
    if any(t.dtype != dtype or t.device != x.device for t in weights):
        raise TypeError("encoder_layer: weights must match x's dtype and device")
    dev = x.device
    x = _build.aligned16(x)
    maskf = (torch.ones(B, L, device=dev) if mask is None else mask.float()).contiguous()
    wqkv_t = pack_weights(wq, wk, wv)
    wo_t, w1_t, w2_t = (pack_weights(w) for w in (wo, w1, w2))
    bqkv = torch.cat([bq, bk, bv]).contiguous()
    bo, b1, b2 = (_build.aligned16(t) for t in (bo, b1, b2))
    ln = [t.float().contiguous() for t in (ln1_s, ln1_b, ln2_s, ln2_b)]
    M = B * L
    qkv = torch.empty(M, 3 * H, dtype=dtype, device=dev)
    ctx = torch.empty(M, H, dtype=dtype, device=dev)
    tmp = torch.empty(M, H, dtype=dtype, device=dev)
    y1 = torch.empty(M, H, dtype=dtype, device=dev)
    mid = torch.empty(M, I, dtype=dtype, device=dev)
    out = torch.empty(B, L, H, dtype=dtype, device=dev)
    p = ctypes.c_void_p
    fn = lib.zt_encoder_layer
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, p, p, p, p, p, p, p, p, p, p, p, p,
                   ctypes.c_float, ctypes.c_int, p, p, p, p, p, p, p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_DTYPES[dtype], x.data_ptr(), maskf.data_ptr(), B, L, H, num_heads, I,
             wqkv_t.data_ptr(), bqkv.data_ptr(), wo_t.data_ptr(), bo.data_ptr(),
             ln[0].data_ptr(), ln[1].data_ptr(), w1_t.data_ptr(), b1.data_ptr(),
             w2_t.data_ptr(), b2.data_ptr(), ln[2].data_ptr(), ln[3].data_ptr(),
             float(eps), 1,
             qkv.data_ptr(), ctx.data_ptr(), tmp.data_ptr(), y1.data_ptr(),
             mid.data_ptr(), out.data_ptr(), stream)
    _build.check(err, "encoder_layer kernel launch")
    _build.count_launch(_NAME)
    return out
