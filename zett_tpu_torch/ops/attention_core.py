"""The merged-head attention cores: kernels 2 and 3, the tier-4 core forward
(kernel 2) and backward (kernel 3) with seeded dropout of the softmax
weights, and kernel 5, the tier-1 core forward with an optional additive
key bias; each with its plain PyTorch version.

Replaces ``zett_tpu/ops/pallas_attention.py`` ``_core_train_fwd_kernel`` /
``_core_train_fwd_pallas`` (:215, :335) and ``_core_train_bwd_kernel`` /
``_core_train_bwd_pallas`` (:254, :369), under ``merged_attention_train``
(:437). The CUDA sources are ``zett_tpu_torch/csrc/attention_core.cu`` and
``attention_core_bwd.cu``; their header notes give the bounds (memory) and
the design. Kernel 5 replaces ``_core_kernel`` / ``merged_attention_pallas``
(:87, :131); its source is ``csrc/merged_attention.cu``. No JAX path calls
tier 1 (only its tests do); the port's tier-2 block (kernel 4) runs the same
core with key bias inside its own launch sequence.

Operands keep the JAX function's layout: qm (B, Lq*h, d), km/vm
(B, Lk*h, d) merged position-major (index = position*h + head), kmaskf
(B, Lk*h) f32. Transfer runs the forward at rate 0 (``attention_core``);
training runs ``merged_attention_train``, an ``autograd.Function`` whose
forward is kernel 2 and whose backward is kernel 3 on the card, and whose
forward and backward are the plain versions on the CPU. Any other device
raises.

Dropout draws its keep mask from Philox4x32-10 keyed by (seed, 0) at the
counter (b, merged query index, merged key index, 0), so every entry of the
merged weight plane has its own bits whatever the tiling; the plain version
computes the same Philox in int64 tensor arithmetic, so kernel and plain
version drop the same entries. (The TPU kernel seeds the Mosaic PRNG per
grid tile instead; its stream cannot be reproduced.)
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_FWD = "attention_core"
_BWD = "attention_core_bwd"
_MERGED = "merged_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_MASK_ROWS = 4096  # rows of the plain keep mask computed at a time
# heads of a row in the bf16 forward (csrc/attention.cuh kMaxHeads: the
# row's heads in one CTA of at most 16 warps, two heads a warp past 16)
MAX_HEADS_BF16 = 32
# the head widths the kernels are instantiated for (csrc/attention.cuh,
# attention_core_bwd.cu: a template parameter); kernels 4 and 5 take 64 only
HEAD_WIDTHS = (64, 128)


def _mulhilo(m: int, x: torch.Tensor):
    """(high, low) 32-bit words of the 64-bit product m * x, for x holding
    32-bit values in int64: split x in 16-bit halves so no product leaves
    int64."""
    lo_p = m * (x & 0xFFFF)
    mid = m * (x >> 16) + (lo_p >> 16)
    hi = mid >> 16
    lo = ((mid & 0xFFFF) << 16) | (lo_p & 0xFFFF)
    return hi, lo


def philox_word0(c0, c1, c2, c3, k0: int, k1: int) -> torch.Tensor:
    """First output word of Philox4x32-10 (Salmon et al., SC'11) at the
    counters (c0, c1, c2, c3) (int64 tensors of 32-bit values, broadcast)
    under the key (k0, k1); the arithmetic of ``attention.cuh``."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def keep_threshold(rate: float) -> int:
    """Keep an entry when its 32 Philox bits are below this value."""
    return int(min(2**32 - 1, round((1.0 - rate) * 2**32)))


def keep_mask(seed: int, B: int, Lqh: int, Lkh: int, rate: float, device,
              row_offset: int = 0) -> torch.Tensor:
    """Bool (B, Lqh, Lkh): which merged weights of rows row_offset..+B
    survive dropout at ``rate`` under ``seed`` (True everywhere at rate 0)."""
    if rate <= 0.0:
        return torch.ones(B, Lqh, Lkh, dtype=torch.bool, device=device)
    thr = keep_threshold(rate)
    qi = torch.arange(Lqh, device=device, dtype=torch.int64)[None, :, None]
    kj = torch.arange(Lkh, device=device, dtype=torch.int64)[None, None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    out = []
    for start in range(0, B, _MASK_ROWS):
        n = min(_MASK_ROWS, B - start)
        b = torch.arange(row_offset + start, row_offset + start + n, device=device,
                         dtype=torch.int64)[:, None, None]
        out.append(philox_word0(b, qi, kj, zero, int(seed) & _MASK32, 0) < thr)
    return torch.cat(out) if out else torch.ones(0, Lqh, Lkh, dtype=torch.bool, device=device)


def _acc_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def softmax_weights(qm, km, kmaskf, num_heads: int, kbias=None, plane_bias=None):
    """The forward's softmax weights (B, Lq*h, Lk*h) in the compute dtype and
    the valid-entry plane: scores accumulated wide, cast, divided by sqrt(d)
    in the compute dtype, the key bias (B, Lk*h) added in it, then the
    plane bias (B', Lq*h, Lk*h; the hypernet's relative positions,
    hypernet.py:220-228) in it, one select to finfo.min over other heads'
    and masked keys (kmaskf (B, Lk*h), > 0 where valid; None: all valid),
    softmax wide, cast (pallas_attention.py:95-110, 224-237)."""
    dtype = qm.dtype
    acc = _acc_dtype(dtype)
    d = qm.shape[-1]
    h = num_heads
    dev = qm.device
    scores = torch.einsum("bqd,bkd->bqk", qm.to(acc), km.to(acc)).to(dtype)
    scores = scores / torch.tensor(math.sqrt(d), dtype=dtype, device=dev)
    if kbias is not None:
        scores = scores + kbias.to(dtype)[:, None, :]
    if plane_bias is not None:
        scores = scores + plane_bias.to(dtype)
    valid = ((torch.arange(qm.shape[1], device=dev) % h)[:, None]
             == (torch.arange(km.shape[1], device=dev) % h)[None, :])[None]
    if kmaskf is not None:
        valid = valid & (kmaskf > 0)[:, None, :]
    scores = torch.where(valid, scores, torch.finfo(dtype).min)
    return torch.softmax(scores.to(acc), dim=-1).to(dtype), valid


def attention_core_reference(qm, km, vm, kmaskf, num_heads: int, rate: float = 0.0,
                             seed: int = 0):
    """Plain version of kernel 2: ``_core_train_fwd_kernel``'s arithmetic
    with the Philox keep mask (kept weights divided by 1 - rate in the
    compute dtype)."""
    dtype = qm.dtype
    w, _ = softmax_weights(qm, km, kmaskf, num_heads)
    if rate > 0.0:
        keep = keep_mask(seed, *w.shape, rate, qm.device)
        div = torch.tensor(1.0 - rate, dtype=dtype, device=qm.device)
        w = torch.where(keep, w / div, torch.zeros((), dtype=dtype, device=qm.device))
    acc = _acc_dtype(dtype)
    return torch.einsum("bqk,bkd->bqd", w.to(acc), vm.to(acc)).to(dtype)


def core_bwd_weights(qm, km, vm, kmaskf, dout, num_heads: int, rate: float = 0.0,
                     seed: int = 0):
    """The planes of kernel 3's plain version, in the accumulation dtype as
    its output products take them: w (the forward's weights), wd (the
    dropped weights, dV = Wd^T dO) and ds (dQ = dS K, dK = dS^T Q). Each is
    rounded to the compute dtype, which is what lets the bf16 kernel feed
    them to the tensor cores and get the same products."""
    dtype = qm.dtype
    acc = _acc_dtype(dtype)
    dev = qm.device
    d = qm.shape[-1]
    w, valid = softmax_weights(qm, km, kmaskf, num_heads)
    dwd = torch.einsum("bqd,bkd->bqk", dout.to(acc), vm.to(acc))
    if rate > 0.0:
        keep = keep_mask(seed, *w.shape, rate, dev)
        scale = torch.tensor(1.0 / (1.0 - rate), dtype=dtype, device=dev)
        wd = torch.where(keep, w * scale, torch.zeros((), dtype=dtype, device=dev))
        scale32 = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).to(acc).item()
        dw = torch.where(keep, dwd * scale32, torch.zeros((), dtype=acc, device=dev))
    else:
        wd, dw = w, dwd
    w32 = w.to(acc)
    ds = w32 * (dw - (dw * w32).sum(-1, keepdim=True))
    ds = torch.where(valid, ds, torch.zeros((), dtype=acc, device=dev))
    inv_sqrt_d = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32).to(acc).item()
    ds = (ds * inv_sqrt_d).to(dtype)
    return w32, wd.to(acc), ds.to(acc)


def attention_core_bwd_reference(qm, km, vm, kmaskf, dout, num_heads: int,
                                 rate: float = 0.0, seed: int = 0):
    """Plain version of kernel 3, hand-written after
    ``_core_train_bwd_kernel`` (pallas_attention.py:254-317): (dqm, dkm,
    dvm). ds is zero on masked entries (the gradient of the forward's
    select), which the TPU kernel omits; see ``attention_core_bwd.cu``."""
    dtype = qm.dtype
    acc = _acc_dtype(dtype)
    _, wd, ds = core_bwd_weights(qm, km, vm, kmaskf, dout, num_heads, rate, seed)
    dvm = torch.einsum("bqk,bqd->bkd", wd, dout.to(acc)).to(dtype)
    dqm = torch.einsum("bqk,bkd->bqd", ds, km.to(acc)).to(dtype)
    dkm = torch.einsum("bqk,bqd->bkd", ds, qm.to(acc)).to(dtype)
    return dqm, dkm, dvm


def merged_attention_reference(qm, km, vm, kmask=None, kbias=None, *, num_heads: int):
    """Plain version of kernel 5 (``merged_attention_reference``,
    pallas_attention.py:61): scores accumulated wide, cast, divided by
    sqrt(d) in the compute dtype, the key bias added in it, one select to
    finfo.min over other heads' and masked keys, softmax wide, weights cast
    before PV. qm (B, Lq*h, d), km/vm (B, Lk*h, d); kmask (B, Lk*h) bool or
    None (all valid); kbias (B, Lk*h) or None."""
    acc = _acc_dtype(qm.dtype)
    w, _ = softmax_weights(qm, km, kmask, num_heads, kbias)
    return torch.einsum("bqk,bkd->bqd", w.to(acc), vm.to(acc)).to(qm.dtype)


def merged_attention(qm, km, vm, kmask=None, kbias=None, *, num_heads: int):
    """The tier-1 masked merged-head core with an optional key bias
    (``merged_attention_pallas``): (B, Lq*h, d). CPU tensors take the plain
    version; on the card this launches kernel 5."""
    if qm.device.type == "cpu":
        return merged_attention_reference(qm, km, vm, kmask, kbias, num_heads=num_heads)
    return _launch_merged(qm, km, vm, kmask, kbias, num_heads)


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")


def attention_core(qm, km, vm, kmaskf, num_heads: int, rate: float = 0.0, seed: int = 0):
    """Attention core forward. CPU tensors take the plain version; on the
    card this launches kernel 2."""
    _check_rate(rate)
    if qm.device.type == "cpu":
        return attention_core_reference(qm, km, vm, kmaskf, num_heads, rate, seed)
    return _launch_fwd(qm, km, vm, kmaskf, num_heads, rate, seed)


def attention_core_bwd(qm, km, vm, kmaskf, dout, num_heads: int, rate: float = 0.0,
                       seed: int = 0):
    """Attention core backward: (dqm, dkm, dvm). CPU tensors take the plain
    version; on the card this launches kernel 3."""
    _check_rate(rate)
    if qm.device.type == "cpu":
        return attention_core_bwd_reference(qm, km, vm, kmaskf, dout, num_heads, rate, seed)
    return _launch_bwd(qm, km, vm, kmaskf, dout, num_heads, rate, seed)


class _MergedAttentionTrain(torch.autograd.Function):
    """Saves only the operands and the seed, as the JAX custom VJP does
    (pallas_attention.py:457): the weight plane is recomputed by the
    backward, never kept."""

    @staticmethod
    def forward(ctx, qm, km, vm, kmaskf, seed, num_heads, rate):
        ctx.save_for_backward(qm, km, vm, kmaskf)
        ctx.seed, ctx.num_heads, ctx.rate = seed, num_heads, rate
        return attention_core(qm, km, vm, kmaskf, num_heads, rate, seed)

    @staticmethod
    def backward(ctx, dout):
        qm, km, vm, kmaskf = ctx.saved_tensors
        dqm, dkm, dvm = attention_core_bwd(qm, km, vm, kmaskf, dout.contiguous(),
                                           ctx.num_heads, ctx.rate, ctx.seed)
        return dqm, dkm, dvm, None, None, None, None


def merged_attention_train(qm, km, vm, kmaskf, seed: int, num_heads: int, rate: float):
    """Differentiable merged-head attention core with in-core dropout
    (``merged_attention_train``, pallas_attention.py:438). Gradients flow to
    qm, km and vm only."""
    return _MergedAttentionTrain.apply(qm, km, vm, kmaskf, int(seed), num_heads, float(rate))


# ------------------------------------------------------------------ launches
def check_head_width(what: str, H: int, num_heads: int, widths=HEAD_WIDTHS) -> int:
    """The head width H / num_heads, or ValueError where no kernel is
    instantiated for it (other widths: ROADMAP A.10)."""
    if num_heads < 1 or H % num_heads or H // num_heads not in widths:
        raise ValueError(f"{what}: head width {H}/{num_heads} heads is not one of "
                         f"{widths} (other widths: ROADMAP A.10)")
    return H // num_heads


def _check(qm, km, vm, num_heads, what, widths=HEAD_WIDTHS):
    dtype = qm.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{what}: unsupported dtype {dtype}")
    B, Lqh, d = qm.shape
    Lkh = km.shape[1]
    h = num_heads
    if d not in widths or Lqh % h or Lkh % h:
        raise ValueError(f"{what}: shapes {tuple(qm.shape)}/{tuple(km.shape)} "
                         f"need d in {widths} and a whole number of positions per head")
    Lq, Lk = Lqh // h, Lkh // h
    if not (1 <= Lq <= 32 and 1 <= Lk <= 32):
        raise ValueError(f"{what}: lengths Lq={Lq}, Lk={Lk} outside 1..32")
    if km.dtype != dtype or vm.dtype != dtype or vm.shape != km.shape:
        raise TypeError(f"{what}: km/vm must match qm's dtype and km's shape")
    return B, Lq, Lk


SMEM_BYTES = 232448  # an H100 block's shared memory


def check_row_fits(what: str, dtype, Lq: int, Lk: int, num_heads: int, d: int) -> None:
    """The bf16 forward stages a row's q, k and v positions (every head) in
    shared memory (``attention.cuh`` ``attn_mma_smem``): at 16 heads of 128,
    up to 18 positions; at 32 heads of 128, up to 26 (Lq = Lk = 8 takes
    213,632 bytes)."""
    if dtype != torch.bfloat16:
        return
    h = num_heads
    need = 2 * d + h * 32 * 8 * (d // 64) + 2 * (Lq + 2 * Lk) * (h * d + 8)
    if need > SMEM_BYTES:
        raise ValueError(f"{what}: a row of Lq={Lq}, Lk={Lk} positions of {h} heads of {d} "
                         f"needs {need} bytes of shared memory, over {SMEM_BYTES}")


def check_heads(what: str, dtype, num_heads: int, Lq: int = 1) -> None:
    """The bf16 forward runs a row's heads in one CTA of at most 16 warps,
    two heads a warp past 16: at most ``MAX_HEADS_BF16``, and past 16 heads
    at most 16 query positions (one m16 tile; a longer row's merged width
    is over 256, which the hypernet runs per head, as the JAX module
    does)."""
    if dtype != torch.bfloat16:
        return
    if num_heads > MAX_HEADS_BF16:
        raise ValueError(f"{what}: {num_heads} heads; the bf16 kernel takes at most "
                         f"{MAX_HEADS_BF16}")
    if num_heads > 16 and Lq > 16:
        raise ValueError(f"{what}: {num_heads} heads of {Lq} query positions; past 16 "
                         "heads the bf16 kernel takes at most 16 query positions")


def _dropout_args(rate: float, seed: int, dtype):
    """(dropout flag, seed, threshold, 1-rate in T, 1/(1-rate) in T,
    1/(1-rate) in f32) for the C entry points."""
    if rate == 0.0:
        return 0, 0, 0, 1.0, 1.0, 1.0
    div = torch.tensor(1.0 - rate, dtype=dtype).item()
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=dtype).item()
    scale32 = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).item()
    return 1, int(seed) & _MASK32, keep_threshold(rate), div, scale, scale32


def _launch_fwd(qm, km, vm, kmaskf, num_heads, rate, seed):
    lib = _build.load(_FWD)
    if not qm.is_cuda:
        raise ValueError(f"attention_core: no kernel for device {qm.device}")
    B, Lq, Lk = _check(qm, km, vm, num_heads, "attention_core")
    check_heads("attention_core", qm.dtype, num_heads, Lq)
    check_row_fits("attention_core", qm.dtype, Lq, Lk, num_heads, qm.shape[-1])
    qm, km, vm = (_build.aligned16(t) for t in (qm, km, vm))
    maskf = kmaskf.float().contiguous()
    out = torch.empty_like(qm)
    drop, seed32, thr, div, _, _ = _dropout_args(rate, seed, qm.dtype)
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn = lib.zt_attention_core
    fn.restype = i
    fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, u, u, ctypes.c_float, p]
    stream = torch.cuda.current_stream(qm.device).cuda_stream
    err = fn(_DTYPES[qm.dtype], qm.data_ptr(), km.data_ptr(), vm.data_ptr(),
             maskf.data_ptr(), out.data_ptr(), B, Lq, Lk, num_heads, qm.shape[-1],
             drop, seed32, thr, div, stream)
    _build.check(err, "attention_core kernel launch")
    _build.count_launch(_FWD)
    return out


def _launch_bwd(qm, km, vm, kmaskf, dout, num_heads, rate, seed):
    lib = _build.load(_BWD)
    B, Lq, Lk = _check(qm, km, vm, num_heads, "attention_core_bwd")
    if dout.shape != qm.shape or dout.dtype != qm.dtype:
        raise TypeError("attention_core_bwd: dout must match qm's shape and dtype")
    qm, km, vm, dout = (t.contiguous() for t in (qm, km, vm, dout))
    # the bf16 kernel stages rows with 16-byte cp.async loads
    if any(t.data_ptr() % 16 for t in (qm, km, vm, dout)):
        raise ValueError("attention_core_bwd: qm, km, vm and dout must start 16-byte aligned")
    if not qm.is_cuda:
        raise ValueError(f"attention_core_bwd: no kernel for device {qm.device}")
    maskf = kmaskf.float().contiguous()
    dqm, dkm, dvm = torch.empty_like(qm), torch.empty_like(km), torch.empty_like(vm)
    drop, seed32, thr, _, scale, scale32 = _dropout_args(rate, seed, qm.dtype)
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    fn = lib.zt_attention_core_bwd
    fn.restype = i
    fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, u, u, f, f, p]
    stream = torch.cuda.current_stream(qm.device).cuda_stream
    err = fn(_DTYPES[qm.dtype], qm.data_ptr(), km.data_ptr(), vm.data_ptr(),
             maskf.data_ptr(), dout.data_ptr(), dqm.data_ptr(), dkm.data_ptr(),
             dvm.data_ptr(), B, Lq, Lk, num_heads, qm.shape[-1], drop, seed32, thr, scale,
             scale32, stream)
    _build.check(err, "attention_core_bwd kernel launch")
    _build.count_launch(_BWD)
    return dqm, dkm, dvm


def _launch_merged(qm, km, vm, kmask, kbias, num_heads):
    lib = _build.load(_MERGED)
    if not qm.is_cuda:
        raise ValueError(f"merged_attention: no kernel for device {qm.device}")
    B, Lq, Lk = _check(qm, km, vm, num_heads, "merged_attention", widths=(64,))
    check_heads("merged_attention", qm.dtype, num_heads, Lq)
    check_row_fits("merged_attention", qm.dtype, Lq, Lk, num_heads, 64)
    Lkh = Lk * num_heads
    for name, t in (("kmask", kmask), ("kbias", kbias)):
        if t is not None and (tuple(t.shape) != (B, Lkh) or t.device != qm.device):
            raise ValueError(f"merged_attention: {name} must be ({B}, {Lkh}) on {qm.device}")
    qm, km, vm = (_build.aligned16(t) for t in (qm, km, vm))
    maskf = kmask.float().contiguous() if kmask is not None else None
    kb = kbias.to(qm.dtype).contiguous() if kbias is not None else None
    out = torch.empty_like(qm)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.zt_merged_attention
    fn.restype = i
    fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, p]
    stream = torch.cuda.current_stream(qm.device).cuda_stream
    err = fn(_DTYPES[qm.dtype], qm.data_ptr(), km.data_ptr(), vm.data_ptr(),
             maskf.data_ptr() if maskf is not None else None,
             kb.data_ptr() if kb is not None else None, out.data_ptr(), B, Lq, Lk,
             num_heads, stream)
    _build.check(err, "merged_attention kernel launch")
    _build.count_launch(_MERGED)
    return out
