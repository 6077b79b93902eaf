"""The persistent bf16 GEMM of ``csrc/gemm.cuh`` (kernels 1 and 4's
``gemm_bf16_kernel``) in other versions beside the package's own, alone,
on the card, at the GEMM shapes of kernels 1 and 4 (``SHAPES``), beside
``torch.matmul`` (cuBLAS: timed only, never called by the port).

Each version is a directory holding a ``gemm.cuh`` (with the
``attention.cuh`` and ``sync.cuh`` it includes). A small entry file that
includes it is built with ``nvcc`` in a namespace of its own
(``-Dzt=zt_<name>``) and called through ``gemm<bf16>``. For each shape:

- whether each version's output is bit-equal to the package's;
- the device time a launch (``torch.profiler``'s kernel durations, the
  median of ``reps`` launches), in rounds of alternating order, the median
  over rounds, and its TFLOP/s.

A version with another choice is a copy of the package's sources with
that line changed, here single CTAs at every K (``gemm_cluster``)::

    V=build/zett_tpu_torch/one_cta; mkdir -p $V
    cp zett_tpu_torch/csrc/{gemm.cuh,attention.cuh,sync.cuh} $V
    sed -i 's/return K >= 2048/return K < 0/' $V/gemm.cuh
    python -m zett_tpu_torch.tools.gemm_versions --version one_cta=$V \\
        --version parent=build/zett_tpu_torch/parent \\
        --out build/zett_tpu_torch/gemm_versions.json
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from zett_tpu_torch.ops import _build

# (label, M, N, K, act): the GEMMs of the seven-launch route at Mistral-7B's
# widths (B 16384, L 7) and at TinyLlama's, the FFN in at GPT-2's (act 1:
# the gelu epilogue), kernel 4's at GPT-2's widths (B 16384, L 8), at H 640
# and at 32 heads of 64
SHAPES = (
    ("Mistral [q|k|v]", 114688, 12288, 4096, 0),
    ("Mistral out", 114688, 4096, 4096, 0),
    ("Mistral FFN in + gelu", 114688, 8192, 4096, 1),
    ("Mistral FFN out", 114688, 4096, 8192, 0),
    ("GPT-2 FFN in + gelu", 114688, 1536, 768, 1),
    ("TinyLlama [q|k|v]", 114688, 6144, 2048, 0),
    ("TinyLlama out", 114688, 2048, 2048, 0),
    ("TinyLlama FFN in + gelu", 114688, 4096, 2048, 1),
    ("TinyLlama FFN out", 114688, 2048, 4096, 0),
    ("GPT-2 [q|k|v]", 131072, 2304, 768, 0),
    ("GPT-2 out", 131072, 768, 768, 0),
    ("H 640 [q|k|v]", 131072, 1920, 640, 0),
    ("32 heads of 64 [q|k|v]", 131072, 6144, 2048, 0),
)
ENTRY = '''#include "gemm.cuh"
extern "C" int zt_gemm_bf16(const void* A, const void* Wt, const void* bias, void* C, int M,
                            int N, int K, int act, void* stream) {
  using T = zt::bf16;
  return (int)zt::gemm<T>((const T*)A, (const T*)Wt, (const T*)bias, (T*)C, M, N, K, act,
                          (cudaStream_t)stream);
}
'''


def build(versions: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """Each version's library; the package's own as ``package``. All nvcc
    processes at once."""
    out_dir = os.path.join(_build.BUILD_DIR, "gemm_versions")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "entry.cu")
    with open(src, "w") as f:
        f.write(ENTRY)
    nvcc = _build._nvcc()
    procs = []
    for name, d in {"package": _build.CSRC, **versions}.items():
        lib = os.path.join(out_dir, f"{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, f"-Dzt=zt_{name}", "-I", d, "-o", lib, src]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def launch(lib: ctypes.CDLL, a, wt, bias, act: int):
    M, K = a.shape
    N = wt.shape[0]
    out = torch.empty(M, N, dtype=a.dtype, device=a.device)
    fn = lib.zt_gemm_bf16
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, p]
    err = fn(a.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(), M, N, K, act,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "zt_gemm_bf16")
    return out


def device_ms(fn, reps: int) -> float:
    """The device time of one call of ``fn`` from a profile of ``reps``
    calls: the median kernel duration where a call launches one kernel,
    else the durations' sum over ``reps``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler may drop a whole window's events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.profiler.kineto_results.events() if not e.is_hidden_event()]
        # the device timeline also carries annotations named after the host
        # ops that enclose its kernels (chip_smoke.py device_events)
        host = {e.name() for e in events if e.device_type() != DeviceType.CUDA}
        events = [e for e in events
                  if e.device_type() == DeviceType.CUDA and e.name() not in host]
        if events:
            break
    else:
        raise RuntimeError("gemm_versions: three profiles held no device time")
    durations = [e.duration_ns() / 1e6 for e in events]
    if len(durations) <= reps:
        # one kernel a call (the profiler may drop some of a window's
        # events): the median launch
        return float(np.median(durations))
    return sum(durations) / reps


def run_shape(libs, label, M, N, K, act, gen, rounds: int, reps: int) -> dict:
    a = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    wt = (torch.randn(N, K, generator=gen, device="cuda") * K ** -0.5).bfloat16()
    bias = (0.1 * torch.randn(N, generator=gen, device="cuda")).bfloat16()
    w = wt.t().contiguous()
    calls = {name: (lambda lib=lib: launch(lib, a, wt, bias, act)) for name, lib in libs.items()}
    ref = calls["package"]()
    equal = {k: bool(torch.equal(fn(), ref)) for k, fn in calls.items()}
    del ref
    calls["torch.matmul"] = lambda: torch.matmul(a, w)
    names = list(calls)
    times: Dict[str, list] = {n: [] for n in names}
    for rnd in range(rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            times[name].append(device_ms(calls[name], reps))
    flops = 2.0 * M * N * K
    ms = {n: float(np.median(v)) for n, v in times.items()}
    row = {"shape": label, "M": M, "N": N, "K": K, "act": act, "ms": ms,
           "tflops": {n: flops / t / 1e9 for n, t in ms.items()}, "rounds": times,
           "bit_equal": equal}
    print("shape " + json.dumps(row), flush=True)
    for n in names:
        print(f"  {label}: {n}: {ms[n]:.4f} ms, {row['tflops'][n]:.1f} TFLOP/s"
              + ("" if n == "torch.matmul" else f", bit-equal {equal[n]}"), flush=True)
    del a, wt, bias, w, calls
    torch.cuda.empty_cache()
    return row


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--version", action="append", default=[], metavar="NAME=DIR",
                    help="a directory holding another gemm.cuh (repeatable)")
    ap.add_argument("--shapes", default="", help="labels of SHAPES to run (default: all)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_versions: no card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs = build(dict(v.split("=", 1) for v in args.version))
    wanted = [s.strip() for s in args.shapes.split(";") if s.strip()]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = [run_shape(libs, *shape, gen, args.rounds, args.reps) for shape in SHAPES
            if not wanted or shape[0] in wanted]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "versions": {"package": _build.CSRC,
                                                  **dict(v.split("=", 1) for v in args.version)},
                       "rows": rows}, f, indent=1)
    return 0 if all(all(r["bit_equal"].values()) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
