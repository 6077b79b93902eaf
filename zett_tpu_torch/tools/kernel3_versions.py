"""Kernel 3 (the attention-core backward) in other versions beside the
package's own, on the card. Each version's source is built with ``nvcc``
in a namespace of its own (``-Dzt=<name>``, so that no inline ``static``
is shared between the libraries) and called through the same C entry
point. Two parts:

- held: on key masks that differ between the heads of a row (B 2048, L 7,
  about 30% of a row's heads without a valid key), each version's dq, dk
  and dv against the plain version at rates 0 and 0.1, bf16 and f32, 12
  heads of 64, 16 and 32 of 128: the largest absolute difference, the
  largest |plain|, and in bf16 the share within 2 ulps of max(|plain|, 1);
- timed: at a train batch (B 32896, L 7; the full layer with every 97th
  row all padding, and with 18991 more such rows) at rates 0 and 0.1, the
  median of CUDA events per version, in rounds of alternating order.

A version is ``NAME=PATH`` to an ``attention_core_bwd.cu``; its
``attention.cuh`` is the one beside it, else the package's. A source whose
entry point takes no ``void* row_pad`` scratch is called without one. ::

    python -m zett_tpu_torch.tools.kernel3_versions \\
        --version parent=build/zett_tpu_torch/parent/attention_core_bwd.cu \\
        --out build/zett_tpu_torch/kernel3_versions.json
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from zett_tpu_torch.ops import _build
from zett_tpu_torch.ops.attention_core import _DTYPES, _dropout_args, attention_core_bwd_reference

SHAPES = ((12, 64), (16, 128), (32, 128))
SEED = 1234


def mixed_head_masks(B: int, Lk: int, h: int, gen: torch.Generator) -> torch.Tensor:
    """A (B, Lk·h) f32 key mask whose heads differ within a row: about 30%
    of a row's heads have no valid key, every fifth row's first head none,
    every 97th row no head one."""
    heads = torch.rand(B, Lk, h, generator=gen, device=gen.device) > 0.3
    heads[:, 0] = True
    heads &= torch.rand(B, 1, h, generator=gen, device=gen.device) >= 0.3
    heads[::5, :, 0] = False
    heads[1::97] = False
    return heads.reshape(B, Lk * h).float()


def train_masks(B: int, Lk: int, h: int, gen: torch.Generator, padding_rows: int = 0):
    """A train batch's key mask, one per row repeated over the heads:
    ragged, every 97th row all padding and ``padding_rows`` more drawn at
    random."""
    mask = torch.rand(B, Lk, generator=gen, device=gen.device) > 0.3
    mask[:, 0] = True
    mask[1::97] = False
    if padding_rows:
        mask[torch.randperm(B, generator=gen, device=gen.device)[:padding_rows]] = False
    return mask.repeat_interleave(h, dim=-1).float()


def errors(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """Largest absolute difference, largest |ref| and, for bf16, the share
    of elements within 2 ulps of max(|ref|, 1)."""
    g, r = got.float(), ref.float().to(got.device)
    diff = (g - r).abs()
    out = {"max_abs": diff.max().item(), "max_ref": r.abs().max().item()}
    if got.dtype == torch.bfloat16:
        scale = torch.clamp(r.abs(), min=1.0)
        ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
        out["within_2_ulps"] = (diff <= 2 * ulp).float().mean().item()
    return out


def build_versions(versions: Dict[str, str], package: str) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """Each version's library, built with ``nvcc`` in a namespace of its own
    (``-Dzt=zt_<name>``; all nvcc processes at once) under
    ``build/zett_tpu_torch/<package>_versions/``, with its source's text; the
    package's own library ``package`` as ``package``."""
    nvcc = _build._nvcc()
    out_dir = os.path.join(_build.BUILD_DIR, f"{package}_versions")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name, src in versions.items():
        lib = os.path.join(out_dir, f"{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, f"-Dzt=zt_{name}", "-I", _build.CSRC, "-o", lib, src]
        procs.append((name, src, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    with open(os.path.join(_build.CSRC, f"{package}.cu")) as f:
        libs = {"package": (_build.load(package), f.read())}
    for name, src, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        with open(src) as f:
            libs[name] = (ctypes.CDLL(lib), f.read())
    return libs


def build(versions: Dict[str, str]) -> Dict[str, Tuple[ctypes.CDLL, bool]]:
    """Each version's library and whether its entry point takes
    ``row_pad``; the package's own as ``package``."""
    return {name: (lib, "void* row_pad" in text)
            for name, (lib, text) in build_versions(versions, "attention_core_bwd").items()}


def call(lib: Tuple[ctypes.CDLL, bool], qm, km, vm, kmaskf, dout, h: int, rate: float,
         row_offset: int = 0):
    handle, takes_row_pad = lib
    B, Lq, Lk = qm.shape[0], qm.shape[1] // h, km.shape[1] // h
    maskf = kmaskf.float().contiguous()
    dq, dk, dv = torch.empty_like(qm), torch.empty_like(km), torch.empty_like(vm)
    scratch = [torch.empty(B, dtype=torch.uint8, device=qm.device)] if takes_row_pad else []
    drop, seed32, thr, _, scale, scale32 = _dropout_args(rate, SEED, qm.dtype)
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    fn = handle.zt_attention_core_bwd
    fn.restype = i
    fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, u, u, f, f, u] + \
        [p] * (1 + len(scratch))
    err = fn(_DTYPES[qm.dtype], qm.data_ptr(), km.data_ptr(), vm.data_ptr(),
             maskf.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
             Lq, Lk, h, qm.shape[-1], drop, seed32, thr, scale, scale32, row_offset,
             *[t.data_ptr() for t in scratch], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "kernel 3 version")
    return dq, dk, dv


def operands(B: int, L: int, h: int, d: int, dtype, gen: torch.Generator, kmaskf):
    def mk():
        return torch.randn(B, L * h, d, generator=gen, device=gen.device).to(dtype)

    return mk(), mk(), mk(), mk(), kmaskf


def held(libs, gen: torch.Generator) -> List[dict]:
    B, L = 2048, 7
    rows = []
    for h, d in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for rate in (0.0, 0.1):
                qm, km, vm, dout, kmaskf = operands(B, L, h, d, dtype, gen,
                                                    mixed_head_masks(B, L, h, gen))
                ref = attention_core_bwd_reference(qm, km, vm, kmaskf, dout, h, rate, SEED)
                for name, lib in libs.items():
                    got = call(lib, qm, km, vm, kmaskf, dout, h, rate)
                    torch.cuda.synchronize()
                    row = {"version": name, "h": h, "d": d, "dtype": str(dtype)[6:],
                           "rate": rate}
                    row.update({n: errors(g, r) for n, g, r in zip(("dq", "dk", "dv"), got, ref)})
                    rows.append(row)
                    print("held " + json.dumps(row), flush=True)
                del qm, km, vm, dout, kmaskf, ref
    return rows


def event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def timed(libs, gen: torch.Generator, rounds: int = 4, reps: int = 15) -> List[dict]:
    B, L = 32896, 7
    rows = []
    names = list(libs)
    for h, d in SHAPES:
        for padding_rows, rate in ((0, 0.0), (18991, 0.0), (0, 0.1), (18991, 0.1)):
            qm, km, vm, dout, kmaskf = operands(B, L, h, d, torch.bfloat16, gen,
                                                train_masks(B, L, h, gen, padding_rows))
            times: Dict[str, list] = {n: [] for n in names}
            for rnd in range(rounds):
                for name in (names if rnd % 2 == 0 else names[::-1]):
                    def run(lib=libs[name]):
                        call(lib, qm, km, vm, kmaskf, dout, h, rate)

                    for _ in range(3):
                        run()
                    times[name].append(float(np.median([event_ms(run) for _ in range(reps)])))
            row = {"h": h, "d": d, "rate": rate,
                   "all_padding_rows": int((kmaskf.view(B, L, h) <= 0).all(1).all(1).sum()),
                   "ms": {n: float(np.median(v)) for n, v in times.items()},
                   "rounds": times}
            rows.append(row)
            print("timed " + json.dumps(row), flush=True)
            del qm, km, vm, dout, kmaskf
            torch.cuda.empty_cache()
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--version", action="append", default=[], metavar="NAME=PATH",
                    help="another attention_core_bwd.cu to build and compare (repeatable)")
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel3_versions: no card")
    versions = dict(v.split("=", 1) for v in args.version)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    libs = build(versions)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    result = {"card": card, "versions": {"package": "zett_tpu_torch/csrc", **versions},
              "held": held(libs, gen), "timed": timed(libs, gen)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
