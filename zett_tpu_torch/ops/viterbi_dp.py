"""Kernel 6: the batched Unigram Viterbi DP, and its plain PyTorch version.

Replaces ``zett_tpu/ops/pallas_viterbi.py`` ``_viterbi_dp_kernel`` /
``viterbi_dp_pallas`` (:25, :68) and the ``lax.scan`` DP of
``zett_tpu/ops/device_viterbi.py`` ``viterbi_device`` (:250-268), which
share one contract. The CUDA source is ``zett_tpu_torch/csrc/viterbi_dp.cu``;
its header note gives the bound (memory) and the design.

Contract: S (B, L, K) f32 span scores with ``NEG`` where a span is absent,
I (B, L, K) int32 piece ids -> dp (B, L+K) f32, bk and bi (B, L+K) int32.
dp[:, 0] = 0 and every other dp entry NEG, bk 0, bi -1; then for j = 0..L-1
in order, ``dp[j+1+k] = dp[j] + S[j, k]`` only where strictly greater, which
also sets bk = k+1 and bi = I[j, k]. The kernel is bit-identical to the
plain version: one f32 add per candidate, ties keep the earlier writer.

The device Viterbi's main path runs this DP fused with its span scores
(``ops/device_viterbi.py`` ``viterbi_spans_dp``, a second entry point of the
same library); ``viterbi_dp`` is the counterpart of ``viterbi_dp_pallas``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG = -1e30
_NAME = "viterbi_dp"
_MAX_K = 128  # the kernel's widest window (csrc/viterbi_dp.cu)


def viterbi_dp_plain(S: torch.Tensor, I: torch.Tensor):
    """Plain version of kernel 6: the scan as a loop over j of PyTorch ops."""
    B, L, K = S.shape
    dp = torch.full((B, L + K), NEG, dtype=torch.float32, device=S.device)
    dp[:, 0] = 0.0
    bk = torch.zeros((B, L + K), dtype=torch.int32, device=S.device)
    bi = torch.full((B, L + K), -1, dtype=torch.int32, device=S.device)
    klen = torch.arange(1, K + 1, dtype=torch.int32, device=S.device)[None, :]
    for j in range(L):
        cand = dp[:, j:j + 1] + S[:, j, :]
        window = dp[:, j + 1:j + 1 + K]
        better = cand > window
        dp[:, j + 1:j + 1 + K] = torch.where(better, cand, window)
        bk[:, j + 1:j + 1 + K] = torch.where(better, klen, bk[:, j + 1:j + 1 + K])
        bi[:, j + 1:j + 1 + K] = torch.where(better, I[:, j, :], bi[:, j + 1:j + 1 + K])
    return dp, bk, bi


def viterbi_dp(S: torch.Tensor, I: torch.Tensor):
    """(dp, bk, bi) of the Viterbi DP over span scores S and piece ids I.
    CPU tensors take the plain version; on the card this launches kernel 6;
    any other device raises."""
    if S.device.type == "cpu":
        return viterbi_dp_plain(S, I)
    return _launch(S, I)


def _launch(S, I):
    lib = _build.load(_NAME)
    if not S.is_cuda:
        raise ValueError(f"viterbi_dp: no kernel for device {S.device}")
    if S.dim() != 3 or tuple(I.shape) != tuple(S.shape) or I.device != S.device:
        raise ValueError(f"viterbi_dp: S {tuple(S.shape)} and I {tuple(I.shape)} must be "
                         "(B, L, K) on one device")
    if S.dtype != torch.float32 or I.dtype != torch.int32:
        raise ValueError(f"viterbi_dp: S must be float32 and I int32, got {S.dtype}, {I.dtype}")
    B, L, K = S.shape
    if not 1 <= K <= _MAX_K:
        raise ValueError(f"viterbi_dp: K = {K} outside 1..{_MAX_K}")
    S, I = S.contiguous(), I.contiguous()
    dp = torch.empty((B, L + K), dtype=torch.float32, device=S.device)
    bk = torch.empty((B, L + K), dtype=torch.int32, device=S.device)
    bi = torch.empty((B, L + K), dtype=torch.int32, device=S.device)
    if B == 0:
        return dp, bk, bi
    p = ctypes.c_void_p
    fn = lib.zt_viterbi_dp
    fn.restype = ctypes.c_int
    fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p]
    stream = torch.cuda.current_stream(S.device).cuda_stream
    err = fn(S.data_ptr(), I.data_ptr(), dp.data_ptr(), bk.data_ptr(), bi.data_ptr(), B, L, K,
             stream)
    _build.check(err, "viterbi_dp kernel launch")
    _build.count_launch(_NAME)
    return dp, bk, bi
