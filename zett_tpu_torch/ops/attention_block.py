"""Kernel 4: the hypernet's attention block (tier 2) forward, its plain
PyTorch version, and ``attention_block_fused``, the differentiable wrapper.

Replaces ``zett_tpu/ops/pallas_attention.py`` ``_block_kernel`` /
``attention_block_pallas`` (:530, :611): the q/k/v projections, the masked
merged-head core with an optional additive key bias, and the output
projection. The CUDA source is ``zett_tpu_torch/csrc/attention_block.cu``;
its header note gives the bound (tensor-core operations at the transfer's
shapes) and the design.

``attention_block`` keeps the JAX function's signature: x (B, L, H), mask
(B, L) bool or None, kbias (B, L) or None, (H, H)/(H,) weights in x's dtype.
The kernel runs head widths 64 and 128 (the JAX kernel any multiple of 64;
other widths raise, naming ROADMAP A.10), up to 32 heads in bf16.
On CPU tensors it runs ``attention_block_reference``; on any other device
it launches the kernel or raises. The TPU kernel pads L to a multiple of 8
with masked positions, so on a row with no valid key it averages over the
padded positions too; the port follows ``attention_block_reference`` (no
padding) on every row.

``attention_block_fused`` ports the custom VJP of the same name
(pallas_attention.py:916-1028): forward is kernel 4; the backward without a
key bias recomputes the projections with torch matmuls, runs kernel 2 at
rate 0 for the context and kernel 3 for dq/dk/dv, and takes the projection
and bias gradients as matmuls; with a key bias it differentiates the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention_core import (attention_core, attention_core_bwd, check_head_width, check_heads,
                             check_row_fits, merged_attention_reference)
from .encoder_layer import check_gemm_widths, dense_exact, pack_weights

_NAME = "attention_block"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_block_reference(x, mask, kbias, wq, bq, wk, bk, wv, bv, wo, bo,
                              num_heads: int):
    """Plain version of kernel 4 (``attention_block_reference``,
    pallas_attention.py:509): Dense projections in the compute dtype, the
    merged-head core, the output Dense."""
    B, L, H = x.shape
    h = num_heads
    d = H // h
    q = dense_exact(x, wq, bq)
    k = dense_exact(x, wk, bk)
    v = dense_exact(x, wv, bv)
    kmask = mask.bool().repeat_interleave(h, dim=-1) if mask is not None else None
    kb = kbias.to(x.dtype).repeat_interleave(h, dim=-1) if kbias is not None else None
    ctx = merged_attention_reference(
        q.reshape(B, L * h, d), k.reshape(B, L * h, d), v.reshape(B, L * h, d), kmask, kb,
        num_heads=h,
    )
    return dense_exact(ctx.reshape(B, L, H), wo, bo)


def attention_block(x, mask: Optional[torch.Tensor], kbias: Optional[torch.Tensor],
                    wq, bq, wk, bk, wv, bv, wo, bo, *, num_heads: int):
    """Self-attention block: x (B, L, H) -> (B, L, H). CPU tensors take the
    plain version; on the card this launches kernel 4 (forward only)."""
    args = (x, mask, kbias, wq, bq, wk, bk, wv, bv, wo, bo)
    if x.device.type == "cpu":
        return attention_block_reference(*args, num_heads)
    return _launch(*args, num_heads=num_heads)


class _AttentionBlockFused(torch.autograd.Function):
    """Saves the inputs only, as the JAX custom VJP does
    (pallas_attention.py:942): the weight plane is recomputed."""

    @staticmethod
    def forward(ctx, x, maskf, kbias, wq, bq, wk, bk, wv, bv, wo, bo, num_heads, has_mask,
                has_bias):
        ctx.save_for_backward(x, maskf, kbias, wq, bq, wk, bk, wv, bv, wo, bo)
        ctx.num_heads, ctx.has_mask, ctx.has_bias = num_heads, has_mask, has_bias
        mask = maskf > 0 if has_mask else None
        return attention_block(x, mask, kbias if has_bias else None, wq, bq, wk, bk, wv, bv,
                               wo, bo, num_heads=num_heads)

    @staticmethod
    def backward(ctx, dout):
        x, maskf, kbias, wq, bq, wk, bk, wv, bv, wo, bo = ctx.saved_tensors
        h = ctx.num_heads
        if ctx.has_bias:
            # pallas_attention.py:954-965: autograd through the plain version
            leaves = [t.detach().requires_grad_() for t in (x, wq, bq, wk, bk, wv, bv, wo, bo)]
            mask = maskf > 0 if ctx.has_mask else None
            with torch.enable_grad():
                out = attention_block_reference(leaves[0], mask, kbias, *leaves[1:], h)
                grads = torch.autograd.grad(out, leaves, dout)
            return (grads[0], None, None, *grads[1:], None, None, None)
        B, L, H = x.shape
        d = H // h
        q = x @ wq + bq
        k = x @ wk + bk
        v = x @ wv + bv
        qm, km, vm = (t.reshape(B, L * h, d).contiguous() for t in (q, k, v))
        if ctx.has_mask:
            kmaskf = maskf.float().repeat_interleave(h, dim=-1)
        else:
            kmaskf = torch.ones(B, L * h, device=x.device)
        cm = attention_core(qm, km, vm, kmaskf, h, 0.0, 0)  # kernel 2 at rate 0
        ctx2 = cm.reshape(B * L, H)
        dout2 = dout.reshape(B * L, H)
        dctx = dout2 @ wo.t()
        dwo = ctx2.t() @ dout2
        dbo = dout2.sum(0)
        dqm, dkm, dvm = attention_core_bwd(qm, km, vm, kmaskf, dctx.reshape(B, L * h, d).contiguous(),
                                           h, 0.0, 0)  # kernel 3
        dq, dk, dv = (t.reshape(B * L, H) for t in (dqm, dkm, dvm))
        x2 = x.reshape(B * L, H)
        dx = (dq @ wq.t() + dk @ wk.t() + dv @ wv.t()).reshape(B, L, H)
        return (dx, None, None, x2.t() @ dq, dq.sum(0), x2.t() @ dk, dk.sum(0),
                x2.t() @ dv, dv.sum(0), dwo, dbo, None, None, None)


def attention_block_fused(x, maskf, kbias, wq, bq, wk, bk, wv, bv, wo, bo, num_heads: int,
                          has_mask: bool, has_bias: bool):
    """Differentiable tier-2 block (``attention_block_fused``,
    pallas_attention.py:916): maskf (B, L) f32 {0, 1}, read when
    ``has_mask``; kbias (B, L), read when ``has_bias``. Gradients flow to x
    and the weights."""
    return _AttentionBlockFused.apply(x, maskf, kbias, wq, bq, wk, bk, wv, bv, wo, bo,
                                      int(num_heads), bool(has_mask), bool(has_bias))


def _launch(x, mask, kbias, wq, bq, wk, bk, wv, bv, wo, bo, *, num_heads):
    lib = _build.load(_NAME)
    dtype = x.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"attention_block: unsupported dtype {dtype}")
    B, L, H = x.shape
    d = check_head_width("attention_block", H, num_heads)
    if not 1 <= L <= 32:
        raise ValueError(f"attention_block: sequence length {L} outside 1..32")
    check_heads("attention_block", dtype, num_heads, L)
    check_row_fits("attention_block", dtype, L, L, num_heads, d)
    check_gemm_widths("attention_block", dtype, (3 * H, H), (H,))
    if not x.is_cuda:
        raise ValueError(f"attention_block: no kernel for device {x.device}")
    weights = (wq, bq, wk, bk, wv, bv, wo, bo)
    if any(t.dtype != dtype or t.device != x.device for t in weights):
        raise TypeError("attention_block: weights must match x's dtype and device")
    for name, t in (("mask", mask), ("kbias", kbias)):
        if t is not None and (tuple(t.shape) != (B, L) or t.device != x.device):
            raise ValueError(f"attention_block: {name} must be ({B}, {L}) on {x.device}")
    out = _run(lib, x, mask, kbias, wq, bq, wk, bk, wv, bv, wo, bo, num_heads)
    _build.count_launch(_NAME)
    return out


def _run(lib, x, mask, kbias, wq, bq, wk, bk, wv, bv, wo, bo, num_heads):
    """Kernel 4's launch on checked operands, through ``lib``'s
    ``zt_attention_block`` (the package's library, or another version's)."""
    B, L, H = x.shape
    dtype, dev = x.dtype, x.device
    x = _build.aligned16(x)
    maskf = mask.float().contiguous() if mask is not None else None
    kb = kbias.to(dtype).contiguous() if kbias is not None else None
    wqkv_t, wo_t = pack_weights(wq, wk, wv), pack_weights(wo)
    bqkv = torch.cat([bq, bk, bv]).contiguous()
    bo = _build.aligned16(bo)
    M = B * L
    qkv = torch.empty(M, 3 * H, dtype=dtype, device=dev)
    ctx = torch.empty(M, H, dtype=dtype, device=dev)
    out = torch.empty(B, L, H, dtype=dtype, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.zt_attention_block
    fn.restype = i
    fn.argtypes = [i, p, p, p, i, i, i, i, p, p, p, p, p, p, p, p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_DTYPES[dtype], x.data_ptr(), maskf.data_ptr() if maskf is not None else None,
             kb.data_ptr() if kb is not None else None, B, L, H, num_heads,
             wqkv_t.data_ptr(), bqkv.data_ptr(), wo_t.data_ptr(), bo.data_ptr(),
             qkv.data_ptr(), ctx.data_ptr(), out.data_ptr(), stream)
    _build.check(err, "attention_block kernel launch")
    return out
