"""Kernel 2: the merged-head attention core forward at dropout rate 0, and
its plain PyTorch version.

Replaces ``zett_tpu/ops/pallas_attention.py`` ``_core_train_fwd_kernel`` /
``_core_train_fwd_pallas`` (:215, :335), the tier-4 core the transfer path
runs for the last, CLS-only encoder layer (``merged_attention_train`` at
rate 0, ``hypernet.py:190-212``). The CUDA source is
``zett_tpu_torch/csrc/attention_core.cu``; its header note gives the bound
(memory: q/k/v/out bytes) and the design.

``attention_core`` keeps the JAX function's operands: qm (B, Lq*h, d),
km/vm (B, Lk*h, d) merged position-major (index = position*h + head),
kmaskf (B, Lk*h) f32. Dropout (rate > 0) comes with the training slice and
raises until then.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .encoder_layer import merged_core_reference

_NAME = "attention_core"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_core_reference(qm, km, vm, kmaskf, num_heads: int):
    """Plain version of kernel 2: ``_core_train_fallback`` at rate 0
    (pallas_attention.py:409)."""
    return merged_core_reference(qm, km, vm, kmaskf > 0, num_heads)


def attention_core(qm, km, vm, kmaskf, num_heads: int, rate: float = 0.0):
    """Attention core forward. CPU tensors take the plain version; on the
    card this launches kernel 2."""
    if rate > 0.0:
        raise NotImplementedError("attention_core: in-kernel dropout is not ported")
    if qm.device.type == "cpu":
        return attention_core_reference(qm, km, vm, kmaskf, num_heads)
    return _launch(qm, km, vm, kmaskf, num_heads)


def _launch(qm, km, vm, kmaskf, num_heads):
    lib = _build.load(_NAME)
    if not qm.is_cuda:
        raise ValueError(f"attention_core: no kernel for device {qm.device}")
    dtype = qm.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"attention_core: unsupported dtype {dtype}")
    B, Lqh, d = qm.shape
    Lkh = km.shape[1]
    h = num_heads
    if d != 64 or Lqh % h or Lkh % h:
        raise ValueError(f"attention_core: shapes {tuple(qm.shape)}/{tuple(km.shape)} "
                         f"need d = 64 and a whole number of positions per head")
    Lq, Lk = Lqh // h, Lkh // h
    if not (1 <= Lq <= 32 and 1 <= Lk <= 32):
        raise ValueError(f"attention_core: lengths Lq={Lq}, Lk={Lk} outside 1..32")
    if km.dtype != dtype or vm.dtype != dtype or vm.shape != km.shape:
        raise TypeError("attention_core: km/vm must match qm's dtype and km's shape")
    qm, km, vm = qm.contiguous(), km.contiguous(), vm.contiguous()
    maskf = kmaskf.float().contiguous()
    out = torch.empty_like(qm)
    p = ctypes.c_void_p
    fn = lib.zt_attention_core
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, p]
    stream = torch.cuda.current_stream(qm.device).cuda_stream
    err = fn(_DTYPES[dtype], qm.data_ptr(), km.data_ptr(), vm.data_ptr(),
             maskf.data_ptr(), out.data_ptr(), B, Lq, Lk, h, stream)
    _build.check(err, "attention_core kernel launch")
    _build.count_launch(_NAME)
    return out
