"""Kernel 2 (the attention-core forward) in other versions beside the
package's own, on the card. Each version's ``attention_core.cu`` (with the
``attention.cuh`` beside it) is built in a namespace of its own and called
through the same C entry point (``kernel3_versions.build_versions``).
Three parts:

- held: each version against the plain version, in bf16 and f32 at rates 0
  and 0.1, on key masks that differ between the heads of a row (B 2048, L
  7; 12 heads of 64, 16 and 32 of 128), and at 32 heads of 128 on the
  shapes a cluster of CTAs has to get right: B 1 and B 133 (fewer rows than
  clusters, a partial last wave), Lq 16 with Lk 5 (the largest query tile),
  a nonzero row offset at rate 0.1; the largest absolute difference, the
  largest |plain|, in bf16 the share within 2 ulps of max(|plain|, 1), and
  whether that meets ``chip_smoke.py``'s tolerance;
- timed: at the rows of the transfer and of a train batch (``TIMED``), the
  median of CUDA events per version, in rounds of alternating order, beside
  the bytes bound and, at rate > 0, the Philox bound;
- the Philox bound's instructions: the SASS of a probe that calls
  ``attention.cuh``'s ``philox_word0`` as the kernel's dropout does, less
  that of the same probe without it, is one word's instruction count; the
  words a row must draw (Lq·h × Lk·h for a row whose heads have no valid
  key, Lq × Lk for each head with one) times that count, over the card's
  issue rate (SMs × 4 schedulers × 32 lanes × the SM's top clock), is the
  least time the dropout's integer work takes.

A version is ``NAME=PATH`` to an ``attention_core.cu``. ::

    mkdir -p build/zett_tpu_torch/parent
    git show REV:zett_tpu_torch/csrc/attention.cuh > build/zett_tpu_torch/parent/attention.cuh
    git show REV:zett_tpu_torch/csrc/attention_core.cu > build/zett_tpu_torch/parent/attention_core.cu
    python -m zett_tpu_torch.tools.kernel2_versions \\
        --version parent=build/zett_tpu_torch/parent/attention_core.cu \\
        --out build/zett_tpu_torch/kernel2_versions.json
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from zett_tpu_torch.ops import _build
from zett_tpu_torch.ops.attention_core import _DTYPES, _dropout_args, attention_core_reference
from zett_tpu_torch.tools.kernel3_versions import (build_versions, errors, event_ms,
                                                   mixed_head_masks, train_masks)

SEED = 1234
HELD_SHAPES = ((12, 64), (16, 128), (32, 128))
# (what, h, d, B, Lq, Lk, all-padding rows beyond every 97th, rate): the
# transfer's CLS layer at 32 heads of 128 (Mistral-7B, Llama-3-8B), a train
# batch's full layer and its share of all-padding rows (gpt2_en's last batch:
# 18991 of 32896) at 32 and 16 heads of 128 and at 12 of 64
TIMED = (
    ("CLS", 32, 128, 16384, 1, 7, 0, 0.0),
    ("CLS", 32, 128, 16384, 1, 8, 0, 0.0),
    ("full layer", 32, 128, 32896, 7, 7, 0, 0.0),
    ("padding share", 32, 128, 32896, 7, 7, 18991, 0.0),
    ("padding share", 32, 128, 32896, 7, 7, 18991, 0.1),
    ("full layer", 16, 128, 32896, 7, 7, 0, 0.0),
    ("padding share", 16, 128, 32896, 7, 7, 18991, 0.0),
    ("padding share", 16, 128, 32896, 7, 7, 18991, 0.1),
    ("padding share", 12, 64, 32896, 7, 7, 18991, 0.1),
)
# (B, Lq, Lk, rate, row offset) at 32 heads of 128, on mixed head masks
EDGES = ((1, 1, 7, 0.0, 0), (133, 1, 7, 0.0, 0), (133, 7, 7, 0.1, 0), (777, 16, 5, 0.0, 0),
         (777, 16, 5, 0.1, 0), (2048, 7, 7, 0.1, 16448))
PEAK_BYTES = 3.35e12  # an H100 SXM's device memory, bytes/s

PROBE = r'''
#include "attention.cuh"
// one Philox word a thread, keyed as the dropout keys it (c3 = 0, k1 = 0)
extern "C" __global__ void philox_probe(unsigned* out, unsigned seed, unsigned thr) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = zt::philox_word0(blockIdx.x, threadIdx.x, i, 0u, seed, 0u) < thr;
}
// the same without the word
extern "C" __global__ void philox_base(unsigned* out, unsigned seed, unsigned thr) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = (blockIdx.x ^ threadIdx.x ^ i ^ seed) < thr;
}
'''


def sass_instructions(sass: str) -> Dict[str, int]:
    """Instructions of each kernel in ``cuobjdump -sass`` output, by the
    name after ``Function :``; NOP and the trailing self-branch not
    counted."""
    out = {}
    for section in re.split(r"^\s*Function : ", sass, flags=re.M)[1:]:
        name, body = section.split("\n", 1)
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
        out[name.strip()] = sum(1 for op in ops if op not in ("NOP", "BRA"))
    return out


def philox_instructions() -> Tuple[int, Dict[str, int]]:
    """One Philox word's SASS instructions (probe less base) and each
    probe's count."""
    src = os.path.join(_build.BUILD_DIR, "kernel2_versions", "philox_probe.cu")
    os.makedirs(os.path.dirname(src), exist_ok=True)
    with open(src, "w") as f:
        f.write(PROBE)
    cubin = src[:-3] + ".cubin"
    subprocess.run([_build._nvcc(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-I", _build.CSRC, "-o", cubin, src], check=True)
    tool = _build._tool("cuobjdump")
    if tool is None:
        raise RuntimeError("cuobjdump not found: the Philox word cannot be counted")
    sass = subprocess.run([tool, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    counts = sass_instructions(sass)
    return counts["philox_probe"] - counts["philox_base"], counts


def philox_words(B: int, Lq: int, Lk: int, h: int, pad_rows: int) -> int:
    """Words the forward's dropout draws: Lq·h × Lk·h for each row whose
    heads have no valid key (every merged key of the row), Lq × Lk for each
    head of the other rows (its own keys)."""
    return pad_rows * (Lq * h) * (Lk * h) + (B - pad_rows) * h * Lq * Lk


def issue_rate(sms: int, clock_mhz: float) -> float:
    """Instructions a second the card can issue: 4 schedulers an SM, a warp
    instruction (32 lanes) each a clock; IMAD runs on the FMA pipe and
    LOP3/IADD3 on the integer pipe, so Philox's mix reaches this and no
    more."""
    return sms * 4 * 32 * clock_mhz * 1e6


def bytes_bound_ms(B: int, Lq: int, Lk: int, h: int, d: int, pad_rows: int,
                   size: int = 2) -> float:
    """q, k and v in and the context out for each (row, head) pair with a
    valid key, v in and the context out for a pair without one (its
    queries weight every merged key alike: no q or k), the f32 key mask in;
    over the card's memory rate (``chip_smoke.py`` ``core_bound``'s count)."""
    pad, valid = pad_rows * h, (B - pad_rows) * h
    nbytes = (valid * (2 * Lq + 2 * Lk) + pad * (Lq + Lk)) * d * size + B * Lk * h * 4
    return nbytes / PEAK_BYTES * 1e3


def call(lib: ctypes.CDLL, qm, km, vm, kmaskf, h: int, rate: float, row_offset: int = 0):
    B, Lq, Lk = qm.shape[0], qm.shape[1] // h, km.shape[1] // h
    maskf = kmaskf.float().contiguous()
    out = torch.empty_like(qm)
    drop, seed32, thr, div, _, _ = _dropout_args(rate, SEED, qm.dtype)
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn = lib.zt_attention_core
    fn.restype = i
    fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, u, u, ctypes.c_float, u, p]
    err = fn(_DTYPES[qm.dtype], qm.data_ptr(), km.data_ptr(), vm.data_ptr(), maskf.data_ptr(),
             out.data_ptr(), B, Lq, Lk, h, qm.shape[-1], drop, seed32, thr, div, row_offset,
             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "kernel 2 version")
    return out


def held_by_rule(err: Dict[str, float], dtype) -> bool:
    """``chip_smoke.py`` ``compare``'s tolerance: bf16 99.9% within 2 ulps
    of max(|plain|, 1) and nowhere past 8 ulps of the largest |plain|; f32
    2e-5 x max(1, largest |plain| / 8)."""
    top = err["max_ref"]
    if dtype == torch.float32:
        return bool(err["max_abs"] <= 2e-5 * max(1.0, top / 8))
    cap = 8 * 2.0 ** (np.floor(np.log2(max(top, 2.0 ** -126))) - 7)
    return bool(err["within_2_ulps"] >= 0.999 and err["max_abs"] <= cap)


def operands(B: int, Lq: int, Lk: int, h: int, d: int, dtype, gen: torch.Generator):
    def mk(L):
        return torch.randn(B, L * h, d, generator=gen, device=gen.device).to(dtype)

    return mk(Lq), mk(Lk), mk(Lk)


def hold(libs, gen, rows, h, d, dtype, rate, B, Lq, Lk, row_offset, kmaskf):
    qm, km, vm = operands(B, Lq, Lk, h, d, dtype, gen)
    ref = attention_core_reference(qm, km, vm, kmaskf, h, rate, SEED, row_offset)
    for name, (lib, _) in libs.items():
        got = call(lib, qm, km, vm, kmaskf, h, rate, row_offset)
        torch.cuda.synchronize()
        err = errors(got, ref)
        row = {"version": name, "h": h, "d": d, "dtype": str(dtype)[6:], "rate": rate, "B": B,
               "Lq": Lq, "Lk": Lk, "row_offset": row_offset, **err,
               "held": held_by_rule(err, dtype)}
        rows.append(row)
        print("held " + json.dumps(row), flush=True)


def held(libs, gen: torch.Generator) -> List[dict]:
    rows: List[dict] = []
    for h, d in HELD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for rate in (0.0, 0.1):
                hold(libs, gen, rows, h, d, dtype, rate, 2048, 7, 7, 0,
                     mixed_head_masks(2048, 7, h, gen))
    for B, Lq, Lk, rate, row_offset in EDGES:
        for dtype in (torch.bfloat16, torch.float32):
            hold(libs, gen, rows, 32, 128, dtype, rate, B, Lq, Lk, row_offset,
                 mixed_head_masks(B, Lk, 32, gen))
    return rows


def timed(libs, gen: torch.Generator, word_instructions: int, rate_per_s: float,
          rounds: int = 4, reps: int = 15) -> List[dict]:
    rows = []
    names = list(libs)
    for what, h, d, B, Lq, Lk, padding_rows, rate in TIMED:
        qm, km, vm = operands(B, Lq, Lk, h, d, torch.bfloat16, gen)
        kmaskf = train_masks(B, Lk, h, gen, padding_rows)
        pad_rows = int((kmaskf.view(B, Lk, h) <= 0).all(1).all(1).sum())
        times: Dict[str, list] = {n: [] for n in names}
        for rnd in range(rounds):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                def run(lib=libs[name][0]):
                    call(lib, qm, km, vm, kmaskf, h, rate)

                for _ in range(3):
                    run()
                times[name].append(float(np.median([event_ms(run) for _ in range(reps)])))
        row = {"what": what, "h": h, "d": d, "B": B, "Lq": Lq, "Lk": Lk, "rate": rate,
               "all_padding_rows": pad_rows,
               "bytes_bound_ms": bytes_bound_ms(B, Lq, Lk, h, d, pad_rows),
               "ms": {n: float(np.median(v)) for n, v in times.items()}, "rounds": times}
        if rate > 0:
            words = philox_words(B, Lq, Lk, h, pad_rows)
            row["philox_words"] = words
            row["philox_bound_ms"] = words * word_instructions / rate_per_s * 1e3
        rows.append(row)
        print("timed " + json.dumps(row), flush=True)
        del qm, km, vm, kmaskf
        torch.cuda.empty_cache()
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--version", action="append", default=[], metavar="NAME=PATH",
                    help="another attention_core.cu to build and compare (repeatable)")
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel2_versions: no card")
    versions = dict(v.split("=", 1) for v in args.version)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader,nounits"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    clock_mhz = float(card.split(",")[-1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    libs = build_versions(versions, "attention_core")
    word, probes = philox_instructions()
    rate_per_s = issue_rate(sms, clock_mhz)
    print(f"philox word: {word} SASS instructions ({probes}); issue rate {rate_per_s:.4g} "
          f"instructions/s ({sms} SMs at {clock_mhz} MHz)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    result = {"card": card, "versions": {"package": "zett_tpu_torch/csrc", **versions},
              "philox_word_instructions": word, "probe_instructions": probes,
              "issue_rate_per_s": rate_per_s, "held": held(libs, gen),
              "timed": timed(libs, gen, word, rate_per_s)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    failed = [r for r in result["held"] if not r["held"]]
    for r in failed:
        print("not held: " + json.dumps(r), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
