"""Kernels 1 and 4 in other versions beside the package's own, on the card.
Each version's ``encoder_layer.cu`` and ``attention_block.cu`` (with the
``gemm.cuh``, ``attention.cuh`` and ``sync.cuh`` beside them) are built in
a namespace of their own (``kernel3_versions.build_versions``) and called
through the same C entry points, with the operands packed as the package's
wrappers pack them. At every kernel-1 and kernel-4 row of ``PERF.md``'s
table of TPU kernels (``K1_ROWS``, ``K4_ROWS``):

- whether each version's output is bit-equal to the package's, and where
  it is not, the largest difference and the plain version's tolerance
  (``chip_smoke.py``'s ``compare``) for both;
- the median of CUDA events per version, in rounds of alternating order,
  beside the row's bound (the larger of its operations over the card's
  bf16 peak and its bytes over the memory rate, counted as ``chip_smoke.py``
  counts them).

A version is ``NAME=DIR``, a directory holding that version's sources. ::

    mkdir -p build/zett_tpu_torch/parent
    for f in gemm.cuh encoder_layer.cu attention_block.cu attention.cuh sync.cuh; do
        git show REV:zett_tpu_torch/csrc/$f > build/zett_tpu_torch/parent/$f
    done
    python -m zett_tpu_torch.tools.kernel1_versions \\
        --version parent=build/zett_tpu_torch/parent \\
        --out build/zett_tpu_torch/kernel1_versions.json
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from zett_tpu_torch.ops import _build
from zett_tpu_torch.tools.kernel2_versions import held_by_rule
from zett_tpu_torch.tools.kernel3_versions import build_versions, errors, event_ms

# the modules (``zett_tpu_torch.ops`` exports functions of the same names)
ab = importlib.import_module("zett_tpu_torch.ops.attention_block")
el = importlib.import_module("zett_tpu_torch.ops.encoder_layer")
SEED = 1234
PEAK_FLOPS = 989e12  # an H100 SXM's dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # its device memory, bytes/s
# (what, B, L, H, heads, I): kernel 1's rows (bf16): GPT-2's widths on the
# fused route at L 7 and 4, the widths off the GEMMs' tiles, the widest
# fused width, and the seven-launch route at head width 128 (TinyLlama), at
# 32 heads of 64, and at 32 heads of 128 (Mistral-7B, Llama-3-8B) at L 7
# and 8
K1_ROWS = (
    ("d 64", 16384, 7, 768, 12, 1536),
    ("d 64", 16384, 4, 768, 12, 1536),
    ("H 640", 16384, 7, 640, 10, 1600),
    ("H 896", 16384, 7, 896, 14, 1600),
    ("H 1024", 4096, 7, 1024, 16, 4096),
    ("16 heads of 128", 16384, 7, 2048, 16, 4096),
    ("32 heads of 64", 4096, 8, 2048, 32, 4096),
    ("32 heads of 128", 16384, 7, 4096, 32, 8192),
    ("32 heads of 128", 16384, 8, 4096, 32, 8192),
)
# (what, B, L, H, heads, key bias): kernel 4's rows (bf16)
K4_ROWS = (
    ("d 64", 16384, 8, 768, 12, False),
    ("d 64", 16384, 8, 768, 12, True),
    ("d 64", 16384, 5, 768, 12, False),
    ("d 64", 32896, 8, 768, 12, False),
    ("H 640", 16384, 8, 640, 10, False),
    ("H 896", 16384, 8, 896, 14, False),
    ("32 heads of 64", 16384, 8, 2048, 32, False),
    ("16 heads of 128", 16384, 8, 2048, 16, False),
    ("32 heads of 128", 16384, 8, 4096, 32, False),
)
SOURCES = ("gemm.cuh", "encoder_layer.cu", "attention_block.cu", "attention.cuh", "sync.cuh")


def kernel1_bound_ms(B: int, L: int, H: int, h: int, I: int, size: int = 2) -> float:
    """``chip_smoke.py`` ``check_kernel1``'s bound: the four projections
    and the FFN (2 M (4 H^2 + 2 H I)) and the core's two products (4 B h
    L^2 d) over the peak, or x and out, the weights, biases, mask and
    LayerNorm parameters once over the memory rate, whichever is longer."""
    M = B * L
    flops = 2 * M * (4 * H * H + 2 * H * I) + 2 * 2 * B * h * L * L * (H // h)
    nbytes = (2 * M * H + 4 * H * H + 2 * H * I + 6 * H + I) * size + B * L * 4 + 4 * H * 4
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3


def kernel4_bound_ms(B: int, L: int, H: int, h: int, key_bias: bool, size: int = 2) -> float:
    """``chip_smoke.py`` ``check_kernel4``'s bound: the four (M, H) x (H, H)
    projections and the core's two products, or x, out, the weights and
    biases, the mask (and key bias) once."""
    M = B * L
    flops = 2 * M * 4 * H * H + 2 * 2 * B * h * L * L * (H // h)
    nbytes = (2 * M * H + 4 * H * H + 4 * H + (B * L if key_bias else 0)) * size + B * L * 4
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3


def layer_operands(B: int, L: int, H: int, I: int, gen: torch.Generator):
    """Kernel 1's operands at the init's scale (weights of std
    1/sqrt(fan_in)), a ragged key mask with every 97th row all padding."""
    def mk(shape, std):
        return (torch.randn(shape, generator=gen, device=gen.device) * std).bfloat16()

    mask = torch.rand(B, L, generator=gen, device=gen.device) > 0.3
    mask[:, 0] = True
    mask[1::97] = False
    ws = [mk((H, H), H ** -0.5) for _ in range(4)]
    bs = [mk((H,), 0.01) for _ in range(4)]
    lns = 1 + 0.1 * torch.randn(H, generator=gen, device=gen.device)
    lnb = 0.1 * torch.randn(H, generator=gen, device=gen.device)
    return (mk((B, L, H), 1.0), mask, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3],
            lns, lnb, mk((H, I), H ** -0.5), mk((I,), 0.01), mk((I, H), I ** -0.5),
            mk((H,), 0.01), lns, lnb)


def call_layer(lib, args, h: int):
    """Kernel 1 through ``lib``, packed and routed as the package's wrapper
    does (``ops/encoder_layer.py``)."""
    x, mask, wq, bq, wk, bk, wv, bv, wo, bo, l1s, l1b, w1, b1, w2, b2, l2s, l2b = args
    B, L, H = x.shape
    plan = el.layer_plan(x.dtype, L, H, h, w1.shape[1])
    ln = [t.float().contiguous() for t in (l1s, l1b, l2s, l2b)]
    if plan.route == "fused":
        return el._launch_fused(lib, plan, x, mask, wq, bq, wk, bk, wv, bv, wo, bo, ln, w1, b1,
                                w2, b2, h, 1e-5)
    # b1's storage runs on in zeros to whole 192-column tiles: the seven-launch
    # FFN in of older versions (gemm_gelu_kernel) reads whole tiles of it
    I = b1.shape[0]
    b1 = torch.cat([b1, b1.new_zeros(-I % el.GELU_TILE_COLS)])[:I]
    return el._launch_unfused(lib, x, mask, wq, bq, wk, bk, wv, bv, wo, bo, ln, w1, b1, w2, b2,
                              h, 1e-5)


def call_block(lib, args, h: int):
    """Kernel 4 through ``lib``, packed as the package's wrapper packs it."""
    return ab._run(lib, *args, h)


def block_operands(B: int, L: int, H: int, key_bias: bool, gen: torch.Generator):
    args = layer_operands(B, L, H, 8, gen)
    x, mask = args[0], args[1]
    kb = (0.5 * torch.randn(B, L, generator=gen, device=gen.device)).bfloat16() if key_bias \
        else None
    return (x, mask, kb, *args[2:10])


def run_row(libs, kind: str, row, gen: torch.Generator, rounds: int, reps: int) -> dict:
    """One row: each version's output against the package's, then the
    versions timed in turns."""
    if kind == "kernel 1":
        what, B, L, H, h, I = row
        args = layer_operands(B, L, H, I, gen)
        call, bound = call_layer, kernel1_bound_ms(B, L, H, h, I)
        desc = {"B": B, "L": L, "H": H, "heads": h, "I": I}
    else:
        what, B, L, H, h, key_bias = row
        args = block_operands(B, L, H, key_bias, gen)
        call, bound = call_block, kernel4_bound_ms(B, L, H, h, key_bias)
        desc = {"B": B, "L": L, "H": H, "heads": h, "key_bias": key_bias}
    names = list(libs)
    outs = {name: call(libs[name][0], args, h) for name in names}
    torch.cuda.synchronize()
    ref = outs["package"]
    equal = {name: bool(torch.equal(out, ref)) for name, out in outs.items()}
    held = {}
    if not all(equal.values()):
        # the plain version, and chip_smoke.py's tolerance for each version
        with torch.no_grad():
            if kind == "kernel 1":
                plain = el.encoder_layer_reference(*args, h, 1e-5)
            else:
                plain = ab.attention_block_reference(*args, h)
        for name, out in outs.items():
            err = errors(out, plain)
            held[name] = {**err, "held": held_by_rule(err, torch.bfloat16)}
        del plain
    del outs, ref
    times: Dict[str, list] = {n: [] for n in names}
    for rnd in range(rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            def run(lib=libs[name][0]):
                call(lib, args, h)

            for _ in range(2):
                run()
            times[name].append(float(np.median([event_ms(run) for _ in range(reps)])))
    out = {"kernel": kind, "what": what, **desc, "bound_ms": bound,
           "ms": {n: float(np.median(v)) for n, v in times.items()}, "rounds": times,
           "bit_equal": equal}
    if held:
        out["held"] = held
    print("row " + json.dumps(out), flush=True)
    del args
    torch.cuda.empty_cache()
    return out


def build(versions: Dict[str, str]):
    """Each version's kernel-1 and kernel-4 libraries, as {name: (lib, text)}
    per kernel; the package's own as ``package``."""
    return {"kernel 1": build_versions({n: os.path.join(d, "encoder_layer.cu")
                                        for n, d in versions.items()}, "encoder_layer"),
            "kernel 4": build_versions({n: os.path.join(d, "attention_block.cu")
                                        for n, d in versions.items()}, "attention_block")}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--version", action="append", default=[], metavar="NAME=DIR",
                    help="a directory of other kernel-1 and kernel-4 sources (repeatable)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel1_versions: no card")
    versions = dict(v.split("=", 1) for v in args.version)
    for d in versions.values():
        missing = [f for f in SOURCES if not os.path.exists(os.path.join(d, f))]
        if missing:
            raise SystemExit(f"kernel1_versions: {d} lacks {missing}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs = build(versions)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = [run_row(libs["kernel 1"], "kernel 1", row, gen, args.rounds, args.reps)
            for row in K1_ROWS]
    rows += [run_row(libs["kernel 4"], "kernel 4", row, gen, args.rounds, args.reps)
             for row in K4_ROWS]
    result = {"card": card, "versions": {"package": _build.CSRC, **versions}, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    failed = [r for r in rows for v in r.get("held", {}).values() if not v["held"]]
    for r in failed:
        print("not held: " + json.dumps(r), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
