"""Drive the PyTorch / CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. print the card's name and power limit; build the kernels from
     zett_tpu_torch/csrc (one nvcc per source, in parallel) and the native
     host library (g++) beside them, while the inputs of phases 12, 14 and
     15 that no kernel makes are written (``prepare_inputs``); print
     ptxas's registers, shared memory and spills
     of kernels 1 to 5, and count HGMMA and UTMALDG (kernels 1 and 4) and
     HMMA (kernels 1 to 5: the attention core's mma.sync; in kernel 1 within
     its [q|k|v] GEMM, whose epilogue runs the core) in their SASS
     (cuobjdump, read while phases 2-4 run and reported after phase 4): a
     count of zero fails;
  2. each kernel against its plain PyTorch version on the card at the
     transfer's shapes (bf16 and f32, ragged batch, all-padding rows), with
     median times of the kernel, the plain version and one PyTorch library
     call (each timed loop stops past TIMING_BUDGET_MS), beside the least
     time the card could take; kernel 1 also back to back (up to 20
     calls), its wrapper's host ms, its plan (launches, cluster,
     [q|k|v] tile rows), its device kernels a call (at most four in bf16, at
     every width), its device time by kernel and each GEMM's TFLOP/s beside
     torch.matmul's (cuBLAS, timed only); kernel 1 at widths off the GEMMs'
     tiles (H 640 with 10 heads and I 1600, H 896 with 14 heads) and at the
     widest bf16 width (H 1024, 16 heads, I 4096);
  3. the Hypernet module at configs/zeroshot/gpt2_en.json's widths on 512
     rows (cut from 2048 for time): the card (kernels) against the CPU
     (plain versions), f32;
  4. zero-shot transfer end to end through ``zett_tpu_torch.transfer``'s
     CLI on its default device: a seeded GPT-2-small-shaped source model with
     gpt2_raw's tokenizer, a seeded hypernet at gpt2_en's config (bf16), the
     gpt_neox0001 target at batch 16384; checks the written model, that both
     kernels ran, times the transfer and the hypernet per 32k vocab, and
     breaks the hypernet's device time down by kernel (torch.profiler);
  5. kernels 2 and 3 (the tier-4 attention core's forward and backward)
     against their plain versions at the training shapes (B = 32896 full and
     CLS-only layers, B = 16384 at L = 1, a ragged batch, all-padding rows,
     and Lq, Lk of 16, 9 and 20, 32),
     bf16 and f32, dropout rate 0 and 0.1; the kept fraction of kernel 2's
     own mask, and seed determinism; times beside bounds, plain versions and
     SDPA; kernel 3 at rates 0 and 0.1 with a train batch's share of
     all-padding rows;
  6. the hypernet's training route at gpt2_en's widths on 512 rows, card
     against CPU, f32: the loss and every parameter gradient;
  7. training through ``zett_tpu_torch.training``'s CLI on its default
     device at configs/zeroshot/gpt2_en.json's widths (6 steps, 2 of them
     identity steps, on text made from the repo's Markdown files, phase 4's
     seeded source model; the collate inline, prefetch_batches 0): finite
     losses, both kernels launched 3 times per step, frozen weights
     unchanged, a transfer from the written final/; times per step, host
     collate time, peak memory and a profile of one train step;
  8. kernels 4 and 5 (the tier-2 attention block and the tier-1 core with
     key bias) against their plain versions, bf16 and f32, with and without
     key bias, a ragged batch and all-padding rows, at the transfer's B =
     16384 (L = 8 and the bucketed L = 5) and the eval's fixed vocab
     (B = 32896, L = 8); times beside bounds, plain versions and the
     library calls; at L = 8 without bias kernel 4's device time by kernel
     and each GEMM's TFLOP/s beside torch.matmul's (cuBLAS, timed only);
     kernel 4 at H 640 (10 heads) and H 896 (14 heads), kernel 5 at 14
     heads; attention_block_fused's backward card vs CPU;
  9. the Hypernet at configs/zeroshot/gpt2_en_priors_inter_token_attn.json's
     widths and at a hidden_act="gelu" variant of gpt2_en on 512 rows, card
     against CPU, f32: inference outputs (and which kernels ran), the
     training route's loss and every parameter gradient;
 10. transfer through the CLI at the prior + inter-token-attention config
     (bf16, gpt_neox0001, batch 16384): kernel 4 on every layer of every
     batch, kernel 1 on none; the hypernet per 32k vocab, the device
     breakdown;
 11. training through the CLI at that config at its own batch 128: each of
     remat_hypernet, loss_chunk_size 32 (L - 1 = 127 pads) and
     remat_backbone alone (peak memory and train step ms, or out of
     memory), then all three with in-training eval (step 0 and the last
     step; gpt_neox0001 and en_raw as fixed tokenizers with cached
     embeddings and the chunked eval, sampled validation tokenizers,
     held-out paragraphs): finite losses and eval rows, kernel 2 twice a
     train step for each layer (remat), one embedding pass per fixed
     tokenizer per eval, eval time per fixed tokenizer, peak memory;
 12. the device prior pipeline: kernel 6 (the Viterbi DP) bit-equal to its
     plain version at B = 65536 (L 48, K 16; L 8, K 8; L 24, K 7) and
     2^20 rows, with exact ties, all-NEG rows and ragged batches, and on
     gpt_neox0001's span scores; the span scores card vs CPU (unk bytes,
     bytes >= 0x80, empty and full rows); the span scores fused into kernel
     6 (the main paths' kernel) bit-equal to their plain composition at B =
     65536 and on the pipeline's rows, with gpt_neox0001's vocab and with a
     vocab of exact ties and unk bytes, and the device ms of spans + DP
     unfused and fused; on 2^20 synthetic unique pretokens
     with Zipf weights (8.7e8 occurrences), count_tokens_device equal to the
     native C++ Viterbi's counts and DeviceRetokenizer.encode equal to its
     segmentations (exact ties aside, logged), a memoized second call that
     launches nothing; compute_prior's CLI with --device on the repo's
     Markdown and Python, its token prior equal to the native oracle's;
 13. the trainer's levers through the training CLI at gpt2_en's widths on
     phase 7's text: (a) at LM batch 32 with dropout on (kernels 2 and 3 at
     rate 0.1), remat_hypernet, remat_backbone, the chunked loss and all
     three against the plain run for 2 steps (cut from 3; losses, every hypernet
     gradient, kernel 2 and 3 launches), the plain run twice for the card's
     own gap; (b) a SIGTERM sent from the log callback at step 2 writes
     preempt_step_2, and resume_from_checkpoint continues it: steps 3-4
     against an uninterrupted run (and two uninterrupted runs' gap); (c)
     Adafactor on a repeated batch, losses finite and falling; (d) at the
     config's batch 128, prefetch_batches 0 and 2 with num_workers 0 and 4,
     4 steps (cut from 6): the loop's wall per train step, its idle share
     (a profiled step's device busy time over the loop's wall per step),
     collate, wait and device ms, no worker process left; (e) the
     in-training eval with loss_chunk_size 32 on held-out paragraphs
     (kernel 1 on the inference route, no (B, L, V) logits), and on its first batch the chunked eval
     against the whole-logits eval; the phase's wall time;
 14. TinyLlama (TinyLlama-1.1B-intermediate-step-1431k-3T's published
     config.json, random bf16 weights from a seed, a 32000-piece metaspace
     BPE tokenizer with byte fallback rewritten from gpt2_raw): (a) the
     model directory and the byte-level conversion's vocab and
     n_added_tokens; (b) kernels 1, 2 and 3 at head width 128 against their
     plain versions (kernel 1 at B 16384, L 7, H 2048, 16 heads, I 4096
     with its plan; kernels 2 and 3 at B 32896, L 7 and CLS-only, rates 0
     and 0.1, a train batch's all-padding share; bf16 timed beside the
     bound, the plain version and nn.TransformerEncoderLayer / SDPA, f32 at
     a smaller batch); (c) the Llama backbone's logits at full depth, card
     vs CPU (f32); (d) the training CLI at
     configs/zeroshot/tinyllama_en_code_lw0.5_long.json (batch 128, vocab
     sample 32768; no lever and each lever alone: peak or out of memory;
     then 4 steps, 1 of them an identity step, with the levers, eval at
     step 0 and 4 on en_raw and starcoder0001 and sampled tokenizers over
     the repo's Markdown (en) and Python (the code languages); cut from 6
     steps, 2 of them identity steps, to make room for phase 17): finite losses
     and eval rows, exact launches of kernels 1, 2 and 3, step times, idle
     share, peak memory; (e) the transfer CLI to llama0001 from the
     trained final/: both tables at 32771 rows and different, config.json's
     vocab_size, the written model's logits through the port's Llama, the
     hypernet per 32k vocab over the transfer's own batches, idle share and
     kernel launches;
 15. Mistral-7B (mistralai/Mistral-7B-v0.1's published config.json, every
     width kept, cut to MISTRAL_LAYERS layers, random bf16 weights from a
     seed, a 32000-piece metaspace tokenizer): (a) the model directory; (b)
     kernels 1 to 5 at 32 heads against their plain versions (kernel 1 at
     B 16384, H 4096, 32 heads of 128, I 8192 at L 7 and 8; kernel 2 at the
     transfer's CLS shape, Lk 7 and 8; kernels 2 and 3 at B 32896, L 7 with
     a train batch's all-padding share, rates 0 and 0.1; kernel 1 at 32
     heads of 64 on its seven-launch route, kernels 4 and 5 at 32 heads of
     64), bf16 timed beside the bound, the plain version and the library
     call, f32 at a smaller batch; (c) the hypernet of both Mistral configs
     on 64 surface forms (cut from 256), card vs CPU, f32, with and without
     the language id; (d) the transfer CLI on its default device from a seeded
     checkpoint at mistral7b_en_code_lw0.5_long and (at --lang-index 5)
     mistral7b_multilingual_lw0.5_long to llama0001: exact launches, both
     tables, wall and peak memory, the hypernet per 32k vocab over the
     transfer's own batches, its idle share and its device time by kernel;
     the multilingual hypernet ran at the CLI's language id, and its first
     batch at language id 0 differs (cut to make room for phase 17: a
     second multilingual transfer at --lang-index 0, and the matrix
     products by input shape); (e) the training CLI at
     tinyllama_multilingual_lw0.5_long (26 languages, batch 128, vocab
     sample 32768, the four levers) on phase 14's TinyLlama cut to 2
     layers (from 22, for time), 1 identity and 2 train steps: finite
     losses, exact launches, lang_embedding's gradient nonzero;
 16. the eval CLIs on phase 14's TinyLlama: (a) ``python -m
     zett_tpu_torch.evaluation`` (perplexity / bits-per-char, f32, block
     512, batch 8) on the source model under its own metaspace BPE, through
     the general encode pipeline, over the repo's Markdown (about 64
     blocks): loss, perplexity, bits-per-char, chars-per-token, n_tokens,
     the host encode's MB/s, eval tokens a second on the card, the eval
     loop's idle share (a traced second run) and peak memory; (b) the same
     on 14(e)'s transferred model under llama0001, through the native fast
     path, with the transfer's lm-head bias where it wrote one; (c)
     evaluate_lm on 4 blocks of (a) at a 2-layer cut, card vs CPU, f32:
     loss within 1e-5 relative, n_tokens and chars equal; (d) the choice
     CLI on the transferred model over out/multilingual_eval/copa_en.jsonl
     and copa_code.jsonl (60 items of 3 choices each): acc, acc_norm,
     requests a second; at the 2-layer cut, card vs CPU on the first 4
     items of each (cut from 8): every request's ll within 1e-4, or 1e-5
     of |ll| where that is more, n_tokens, n_bytes and greedy equal;
 17. the n-shot and baseline path on phase 14's TinyLlama (launches no port
     kernel; run under PYTHONHASHSEED 0, ROADMAP C.13): (a) ``python -m
     zett_tpu_torch.transfer.baselines_cli`` to starcoder0001 for lexical,
     bfvt, focus and ofa (char n-grams) on a 2-layer cut of the model (the
     methods read its tables only): wall, overlap, rows per route,
     finite tables; FOCUS's and OFA's search and combination card vs plain
     on 4096 seeded new tokens (other top-k sets only at a tie within 1e-6,
     counted; rows within 1e-5 of the scale); (b) the training CLI at
     configs/baseline/tinyllama_code_original.json (passthrough tables and
     full fine-tuning, batch 32, block 512, lr 1e-6, lexical weight 0) for 3
     steps on the repo's Python, first at the config's own settings, then
     with remat_backbone and the chunked loss in turn where it runs out of
     memory: finite losses, the share of table and backbone elements (layers
     0 and 21) that moved, step ms, peak memory, idle share (final/ with the
     tables only, cut for time and disk writes: the full state is (c)'s);
     (c) at a 2-layer cut, step 2 resumed through the CLI from a
     1-step run's full state against a 2-step run: the same batch, loss
     and a backbone weight within 1e-6; (d) the training CLI at
     tinyllama_code_starcoder_from_focus.json on (a)'s FOCUS model (2
     layers), 2 steps; (e) ``--method passthrough`` on (d)'s final/ and the
     perplexity CLI on the written model over 4 blocks, and the named
     refusal (ROADMAP C.16)
     on (b)'s final/; (f) configs/nshot/gpt2_passthrough_ft.json's named
     refusal (ROADMAP C.11) before any step;
 18. XLM-R base (xlm-roberta-base's published config.json, random f32
     weights from a seed, a 250002-id Unigram-Metaspace tokenizer built from
     the repo's artifact tokenizers' pieces and seeded pieces in the scripts
     of 26l.txt, written while nvcc builds): (a) the byte-level
     conversion's vocab, n_added_tokens and host seconds; (b) the MLM
     logits at full depth card vs CPU (bf16 weights, f32, a padded row);
     (c) the training CLI at configs/zeroshot/xlmr_26l.json (batch 128,
     block 128, vocab sample 32768, loss mlm, learnable bias, 26 languages
     of the repo's Markdown drawn by MADLAD size ^ 0.1; 1 identity and 3
     train steps; eval at step 0 and 4 over the four extra_valid_tokenizers
     and sampled tokenizers on XLMR_VALID held-out paragraphs a language,
     n_valid_subsample cut from 4000): finite losses, eval_loss and
     eval_accuracy rows, exact launches of kernels 1, 2 and 3, the masked
     share, step ms, idle share, peak memory; then the run's first two
     train batches through 2 steps at a 2-layer cut with loss_chunk_size 32
     and remat_backbone against the plain steps (phase 13(a)'s tolerance);
     (d) the transfer CLI from (c)'s final/ to roberta0001: 32773 rows, the
     tied decoder, zero lm-head biases, bias.npy, the written model's
     logits, the hypernet per 32k vocab, kernel 1's launches, idle share;
     (e) mlm_probe on (d)'s model over held-out paragraphs, and at a
     2-layer cut card vs CPU;
 19. reference-format hypernet checkpoints (config.json with the hn_*
     arguments and no hidden_act, so erf-gelu; flax_model.msgpack in the
     reference's names with its placeholder tables, written by this
     script's msgpack writer from seeded weights): (a) at
     tinyllama_en_code's hypernet (2048 hidden, 16 heads of 128, I 4096, 3
     layers, f32 leaves) over phase 14's TinyLlama, (b) at Mistral-7B's
     (4096, 32 heads of 128, I 8192, 2 of its 3 layers, bf16 leaves) over
     phase 15's Mistral: the file's size, load_reference_hypernet's
     seconds, transfer() (bf16) to llama0001 with both tables, kernel 4 on
     every non-CLS layer of every batch, the hypernet per 32k vocab; (c)
     kernel 4 at 16 and 32 heads of 128 against its plain version (B 16384,
     L 8 and 7, with and without the prior key bias, bf16 timed at L 8
     beside the bound, the plain version and F.linear x3 + SDPA + F.linear;
     f32 at B 2048); (d) at xlmr_26l's hypernet widths (768, 12 heads of
     64, 26 language ids, 2 layers): language adapters under gelu_new and
     erf-gelu, concat pooling (one position: ROADMAP C.21), relative
     positions and the T5 encoder with gated-gelu, each from a
     reference-format or port checkpoint, 4096 rows card vs CPU (f32,
     within 1e-4 of the scale) with their launches of kernels 1, 2 and 4.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import signal
import struct
import subprocess
import sys
import time
import traceback
import zipfile

if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    # phase 17's FOCUS and OFA bucket char n-grams by Python's string hash,
    # salted per process unless PYTHONHASHSEED is set (ROADMAP C.13): the
    # script runs again under a fixed one, in this process
    os.execve(sys.executable, [sys.executable] + sys.argv,
              dict(os.environ, PYTHONHASHSEED="0"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
REPO = os.path.dirname(os.path.abspath(__file__))
CARD = "not read"  # nvidia-smi's name and power limit, set by main()
WORK = os.path.join(REPO, "build", "zett_tpu_torch", "smoke")

# configs/zeroshot/gpt2_en.json's hypernet
GPT2_EN = dict(
    hidden_size=768, intermediate_size=1536, num_hidden_layers=3, num_attention_heads=12,
    hn_surface_maxlen=7, max_position_embeddings=10, embed_using_source_embeddings=True,
    n_extra_tokens=256, rescale_embeddings=True, predict_bias=True, n_embd=768,
    hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
)
# configs/zeroshot/gpt2_en_priors_inter_token_attn.json's hypernet, and the
# erf-gelu variant of gpt2_en (what reference checkpoints load with)
PITA = dict(GPT2_EN, embed_target_priors=True, add_inter_token_attention=True,
            inter_token_attention_bias_by_priors=True, n_inter_token_blocks=16)
GPT2_EN_GELU = dict(GPT2_EN, hidden_act="gelu")
# surface forms of the hypernet's card-vs-CPU checks (phases 3, 6 and 9;
# cut from 2048 to spare the CPU's side)
HYPERNET_ROWS = 512
# kernels that no main path runs: no JAX path reaches the tier-1 core (only
# its tests call merged_attention_pallas), and the device Viterbi's main
# paths run kernel 6's DP fused with its span scores (viterbi_spans_dp);
# their rows report 0 launches
OFF_PATH = ("merged_attention", "viterbi_dp")


def log(*args):
    print(*args, flush=True)


T_START = time.perf_counter()


def phase(title):
    """A phase's heading, with the seconds since the script started."""
    log(f"{title} [{time.perf_counter() - T_START:.1f} s into the run]")


def step(title):
    """A sub-phase's heading, indented, with the seconds since the start."""
    phase(f"  {title}")


# a timed loop stops once its calls pass this much device time: fast
# kernels still get every call, slow plain versions one or three (cut from
# 250 ms to make room for phase 18)
TIMING_BUDGET_MS = 100.0


def event_ms(fn):
    """One call of ``fn`` between two CUDA events, in ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def median_ms(fn, reps=20, warmup=3):
    """Median of per-call CUDA-event times after warm-up: ``reps`` calls,
    or fewer once they pass TIMING_BUDGET_MS together (at least 3, or one
    call that alone passes it); one warm-up call where that call takes more
    than a tenth of the budget."""
    for _ in range(warmup):
        if event_ms(fn) > TIMING_BUDGET_MS / 10:
            break
    times = []
    for _ in range(reps):
        times.append(event_ms(fn))
        if sum(times) > TIMING_BUDGET_MS and (len(times) >= 3 or times[0] > TIMING_BUDGET_MS):
            break
    return float(np.median(times))


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bf16_ulp(x):
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(torch.clamp(x.abs(), min=2.0 ** -126)))
    return torch.exp2(e - 7)


def compare(got, ref, dtype, what):
    """Tolerances: f32 max abs 2e-5 on outputs of magnitude < 8, and 2e-5 x
    (largest |ref| / 8) above that (sums in another order than the plain
    version's library GEMMs; the card showed 3e-6). bf16, judged at the
    outputs' unit scale: on
    99.9% of elements within 2 ulps of max(|ref|, 1), and everywhere within
    8 ulps of the largest |ref| (an f32 sum in another order can round a
    bf16 intermediate the other way, and a LayerNorm or gelu downstream
    carries that one ulp on). Computed on the card."""
    got = got.float()
    ref = ref.float().to(got.device)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = (got - ref).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    top = float(ref.abs().max()) if ref.numel() else 0.0
    # the relative difference: max abs over the largest |ref| (reported)
    rel = f"max rel {max_err / top:.3g}" if top > 0 else "max rel n/a"
    if dtype == torch.float32:
        tol = 2e-5 * max(1.0, top / 8)
        ok = max_err <= tol
        detail = f"max abs {max_err:.3g} (tol {tol:.3g}), {rel}"
    else:
        within = float((err <= 2 * bf16_ulp(torch.clamp(ref.abs(), min=1.0))).float().mean())
        cap = 8 * float(bf16_ulp(torch.tensor(top)))
        ok = within >= 0.999 and max_err <= cap
        detail = (f"max abs {max_err:.3g} (cap {cap:.3g}), {rel}, within 2 ulps {within:.5f} "
                  f"(tol 0.999)")
    log(f"  {what}: {detail}")
    if not ok:
        raise AssertionError(f"{what}: {detail}")
    return max_err


# --------------------------------------------------------------------- phase 1
# the instructions each redesigned kernel's library must hold: the Hopper
# GEMM's wgmma (HGMMA) and TMA loads (UTMALDG) in kernels 1 and 4, the
# tensor-core mma (HMMA) of the attention core (kernels 1, 2, 4, 5) and of
# kernel 3
SASS_REQUIRED = {"attention_core": ("HMMA",),
                 "attention_block": ("HGMMA", "UTMALDG", "HMMA"),
                 "encoder_layer": ("HGMMA", "UTMALDG", "HMMA"),
                 "merged_attention": ("HMMA",), "attention_core_bwd": ("HMMA",)}
# kernel 1's three bf16 kernels, each on its own: wgmma and TMA loads in
# every one, and the core's mma.sync in the [q|k|v] GEMM
SASS_REQUIRED_IN = {"gemm_qkv_attention_kernel": ("HGMMA", "UTMALDG", "HMMA"),
                    "gemm_ln_kernel": ("HGMMA", "UTMALDG"),
                    "gemm_gelu_kernel": ("HGMMA", "UTMALDG")}


def check_build():
    """ptxas's report (registers, shared memory, spills) of the redesigned
    kernels, and their SASS: a required instruction counted zero times
    fails the run (where the toolkit has no cuobjdump, the report stands).
    The SASS is read by cuobjdump processes that run on while the next
    phases use the card: returns the function that waits for them and
    reports."""
    from zett_tpu_torch.ops import _build

    spills = []
    for name in SASS_REQUIRED:
        lines = [ln.strip() for ln in _build.reports.get(name, "").splitlines()
                 if "entry function" in ln or "Used" in ln or "spill" in ln]
        log(f"  ptxas -v, {name}.cu:")
        for ln in lines or ["(no report: the library was up to date)"]:
            log(f"    {ln}")
        entry = None
        for ln in lines:
            if "entry function" in ln:
                entry = ln.split("'")[1]
            elif "spill stores" in ln and not ln.endswith("0 bytes spill stores, 0 bytes spill loads"):
                spills.append(f"{name}: {entry}: {ln}")
    # every instantiation that spills, the head-width-128 ones (Li128E) among
    # them, on lines of their own
    log(f"  ptxas spills: {len(spills)} kernels" + "".join(f"\n    {x}" for x in spills))
    # each library's SASS, and kernel 1's three kernels in libencoder_layer.so
    # (its core runs in the [q|k|v] GEMM's epilogue: mma.sync there): one
    # cuobjdump process each, all at once
    jobs = [(name, ops, None) for name, ops in SASS_REQUIRED.items()]
    jobs += [("encoder_layer", ops, function) for function, ops in SASS_REQUIRED_IN.items()]
    pool = concurrent.futures.ThreadPoolExecutor(len(jobs))
    futures = [pool.submit(_build.sass_counts, *job) for job in jobs]
    pool.shutdown(wait=False)

    def report():
        for (name, _, function), future in zip(jobs, futures):
            counts = future.result()
            if counts is None:
                log("  cuobjdump is not in the toolkit: SASS not counted")
                return
            what = f"lib{name}.so" if function is None else f"{function} (lib{name}.so)"
            log(f"  SASS of {what}: {counts}")
            if not all(counts.values()):
                raise AssertionError(f"{what} lacks {[op for op, n in counts.items() if not n]}")

    return report


# --------------------------------------------------------------------- phase 2
def layer_inputs(B, L, dtype, gen, H=768, I=1536, fan_in=False):
    """An encoder layer's operands: weights of std 0.03 (about 1/sqrt(768),
    gpt2_en's fan-in), or with ``fan_in`` of std 1/sqrt(fan_in), the scale
    the hypernet's lecun-normal init gives at any width."""
    def mk(shape, s):
        return (torch.randn(shape, generator=gen, device=gen.device) * s).to(dtype).cuda()

    def std(k):
        return k ** -0.5 if fan_in else 0.03

    x = mk((B, L, H), 1.0)
    mask = torch.rand(B, L, generator=gen, device=gen.device) > 0.3
    mask[:, 0] = True
    mask[1::97] = False  # all-padding surface forms
    ws = [mk((H, H), std(H)) for _ in range(4)]
    bs = [mk((H,), 0.01) for _ in range(4)]
    w1, b1, w2, b2 = mk((H, I), std(H)), mk((I,), 0.01), mk((I, H), std(I)), mk((H,), 0.01)
    lns = (1 + 0.1 * torch.randn(H, generator=gen, device=gen.device)).cuda()
    lnb = (0.1 * torch.randn(H, generator=gen, device=gen.device)).cuda()
    return (x, mask.cuda(), ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3],
            lns, lnb, w1, b1, w2, b2, lns, lnb)


def library_encoder_layer(args, h):
    """torch.nn.TransformerEncoderLayer (post-LN, tanh-gelu) loaded with the
    same weights: the library yardstick of kernel 1, timed only."""
    x, mask, wq, bq, wk, bk, wv, bv, wo, bo, l1s, l1b, w1, b1, w2, b2, l2s, l2b = args
    H, I = x.shape[-1], w1.shape[1]
    layer = torch.nn.TransformerEncoderLayer(
        H, h, I, dropout=0.0, batch_first=True, layer_norm_eps=1e-5,
        activation=lambda t: torch.nn.functional.gelu(t, approximate="tanh"),
    ).to(device=x.device, dtype=x.dtype).eval()
    with torch.no_grad():
        layer.self_attn.in_proj_weight.copy_(torch.cat([wq, wk, wv], 1).t())
        layer.self_attn.in_proj_bias.copy_(torch.cat([bq, bk, bv]))
        layer.self_attn.out_proj.weight.copy_(wo.t())
        layer.self_attn.out_proj.bias.copy_(bo)
        layer.linear1.weight.copy_(w1.t())
        layer.linear1.bias.copy_(b1)
        layer.linear2.weight.copy_(w2.t())
        layer.linear2.bias.copy_(b2)
        for ln, s, b in ((layer.norm1, l1s, l1b), (layer.norm2, l2s, l2b)):
            ln.weight.copy_(s)
            ln.bias.copy_(b)
    pad = ~mask
    return lambda: layer(x, src_key_padding_mask=pad)


# kernel 1 at B 16384, L 7, bf16 as the unfused seven-launch sequence that
# the four-launch design replaced ran it (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md), printed beside this run's
K1_UNFUSED = "3.084 ms single-call, 7 device kernels a layer"


def port_kernels_per_call(run, reps=3):
    """The port's device kernels (``zt::``) that one call of ``run``
    launches, from a profile of ``reps`` calls: (count, names)."""
    run()  # warm
    kernels, _ = device_events(lambda: [run() for _ in range(reps)])
    ours = [name for name, _, _ in kernels if "zt::" in name]
    return len(ours) / reps, sorted({n.split("(")[0] for n in ours})


def check_kernel1(B, L, dtype, gen, timed, split=False, H=768, h=12, I=1536, fan_in=False,
                  plain_reps=5):
    """Kernel 1 against its plain version, and (bf16) its plan and the
    device kernels a call launches (at most four); with ``timed``, its
    median single-call time, its back-to-back time and its wrapper's host
    ms beside the plain version's, nn.TransformerEncoderLayer's and the
    bound; with ``split``, its device time by kernel and each GEMM against
    cuBLAS; ``fan_in``: weights at the init's 1/sqrt(fan_in) (layer_inputs),
    and in bf16 both the kernel and the plain version beside the same layer
    evaluated in f32 on the same bf16 operands."""
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.ops.encoder_layer import (encoder_layer, encoder_layer_reference,
                                                   layer_plan)

    eps = 1e-5
    args = layer_inputs(B, L, dtype, gen, H, I, fan_in=fan_in)
    before = _build.launch_counts["encoder_layer"]
    got = encoder_layer(*args, num_heads=h, eps=eps)
    torch.cuda.synchronize()
    if _build.launch_counts["encoder_layer"] != before + 1:
        raise AssertionError("encoder_layer did not count its launch")
    with torch.no_grad():
        ref = encoder_layer_reference(*args, h, eps)
    tag = f"kernel 1 B={B} L={L} {str(dtype)[6:]}" + ("" if H == 768 else f" H={H} h={h} I={I}")
    if fan_in and dtype == torch.bfloat16:
        with torch.no_grad():
            exact = encoder_layer_reference(
                *[a.float() if torch.is_tensor(a) and a.dtype == dtype else a for a in args],
                h, eps)

        def off(t):
            e = (t.float() - exact).abs().flatten()
            p999 = torch.topk(e, max(1, e.numel() // 1000)).values[-1]
            return f"mean {float(e.mean()):.4g}, p99.9 {float(p999):.4g}, max {float(e.max()):.4g}"

        log(f"  {tag}: against the layer in f32 on the same bf16 operands: kernel {off(got)}; "
            f"plain version {off(ref)}")
        del exact
    err = compare(got, ref, dtype, tag)
    del got, ref

    def run():
        return encoder_layer(*args, num_heads=h, eps=eps)

    # the profile may drop a window's first launches, never add one: a count
    # over the plan's launches is a fault
    plan = layer_plan(dtype, L, H, h, I)
    n_kernels, names = port_kernels_per_call(run)
    log(f"  {tag}: plan {plan}; {n_kernels:g} device kernels of the port a call: {names}")
    if plan.cluster:
        fit = _build.load("encoder_layer").zt_encoder_layer_ln_clusters(plan.cluster)
        log(f"  {tag}: {fit} LayerNorm clusters of {plan.cluster} resident at once "
            f"({fit * plan.cluster} of {torch.cuda.get_device_properties(0).multi_processor_count}"
            f" SMs)")
    if n_kernels > plan.launches:
        raise AssertionError(f"{tag}: {n_kernels} device kernels a call (the plan's "
                             f"{plan.launches})")
    if not timed:
        return None
    M = B * L
    ms = median_ms(run)
    b2b = burst_ms(run)
    torch.cuda.synchronize()
    n_host = min(20, max(3, int(TIMING_BUDGET_MS / ms)))
    t0 = time.perf_counter()
    for _ in range(n_host):
        run()
    host_ms = (time.perf_counter() - t0) / n_host * 1e3  # enqueue: the repack, allocations, launch
    torch.cuda.synchronize()
    with torch.no_grad():
        # the plain versions' timings take no warm-up: the comparison above
        # ran each on the same inputs
        plain_ms = median_ms(lambda: encoder_layer_reference(*args, h, eps), reps=plain_reps,
                             warmup=0)
        lib = library_encoder_layer(args, h)
        library_ms = median_ms(lib, reps=10)
    size = torch.finfo(dtype).bits // 8
    flops = 2 * M * (4 * H * H + 2 * H * I) + 2 * 2 * B * h * L * L * (H // h)
    nbytes = (2 * M * H + 4 * H * H + 2 * H * I + 6 * H + I) * size + B * L * 4 + 4 * H * 4
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    log(f"  {tag}: {ms:.4f} ms (back to back {b2b:.4f} ms; wrapper host {host_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, TransformerEncoderLayer {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); back to back at {bound_ms / b2b:.3f} of the bound")
    if split:
        log(f"  {tag}: the unfused sequence: {K1_UNFUSED}")
        if dtype == torch.bfloat16:
            shapes = [("[q|k|v] + core", M, H, 3 * H), ("out + LN1", M, H, H),
                      ("FFN in + gelu", M, H, I), ("FFN out + LN2", M, I, H)]
        else:
            shapes = [("[q|k|v]", M, H, 3 * H), ("out", M, H, H), ("FFN in", M, H, I),
                      ("FFN out", M, I, H)]
        gemm_split(run, shapes, dtype, f"kernel 1 B={B} L={L}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def check_kernel2(B, Lk, dtype, gen, timed, h=12, d=64):
    """Kernel 2 at the transfer's CLS-only layer (one query position over
    Lk keys, h heads of d) against its plain version; with ``timed``, times
    beside the plain version, SDPA and the bound."""
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.ops.attention_core import attention_core, attention_core_reference

    qm = (torch.randn(B, h, d, generator=gen, device=gen.device)).to(dtype).cuda()
    km = (torch.randn(B, Lk * h, d, generator=gen, device=gen.device)).to(dtype).cuda()
    vm = (torch.randn(B, Lk * h, d, generator=gen, device=gen.device)).to(dtype).cuda()
    mask = torch.rand(B, Lk, generator=gen, device=gen.device) > 0.3
    mask[:, 0] = True
    mask[1::97] = False
    kmaskf = mask.repeat_interleave(h, dim=-1).float().cuda()
    before = _build.launch_counts["attention_core"]
    got = attention_core(qm, km, vm, kmaskf, h)
    torch.cuda.synchronize()
    if _build.launch_counts["attention_core"] != before + 1:
        raise AssertionError("attention_core did not count its launch")
    ref = attention_core_reference(qm, km, vm, kmaskf, h)
    tag = f"kernel 2 B={B} Lk*h={Lk * h} {str(dtype)[6:]}" + ("" if h == 12 else f" h={h} d={d}")
    err = compare(got, ref, dtype, tag)
    if not timed:
        return None
    ms = median_ms(lambda: attention_core(qm, km, vm, kmaskf, h))
    b2b = burst_ms(lambda: attention_core(qm, km, vm, kmaskf, h))
    plain_ms = median_ms(lambda: attention_core_reference(qm, km, vm, kmaskf, h), reps=10)
    q4 = qm.view(B, 1, h, d).transpose(1, 2)
    k4 = km.view(B, Lk, h, d).transpose(1, 2)
    v4 = vm.view(B, Lk, h, d).transpose(1, 2)
    amask = mask.cuda()[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = median_ms(lambda: sdpa(q4, k4, v4, attn_mask=amask))
    size = torch.finfo(dtype).bits // 8
    flops = 2 * 2 * B * h * Lk * d
    nbytes = (2 * B * h * d + 2 * B * Lk * h * d) * size + B * Lk * h * 4
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    log(f"  {tag}: {ms:.4f} ms (back to back "
        f"{b2b:.4f} ms), plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for L in (7, 4):
            main = dtype == torch.bfloat16 and L == 7
            r = check_kernel1(16384, L, dtype, gen, timed=True, split=main)
            if main:
                results["encoder_layer"] = r
        check_kernel1(1000, 7, dtype, gen, timed=False)  # ragged: 7000 rows, not a tile multiple
        # widths off the GEMMs' tiles: partial last N (and k) tiles and
        # LayerNorm slices
        for H, h in ((640, 10), (896, 14)):
            check_kernel1(16384, 7, dtype, gen, timed=dtype == torch.bfloat16, H=H, h=h, I=1600)
        # the widest bf16 width: 16 heads, the largest LayerNorm cluster
        check_kernel1(4096, 7, dtype, gen, timed=dtype == torch.bfloat16, H=1024, h=16, I=4096)
        for Lk in (7, 4):
            r = check_kernel2(16384, Lk, dtype, gen, timed=True)
            if dtype == torch.bfloat16 and Lk == 7:
                results["attention_core"] = r
        check_kernel2(1001, 7, dtype, gen, timed=False)
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------------- phase 5
def core_inputs(B, Lq, Lk, dtype, gen, h=12, d=64, padding_rows=0):
    """Kernel 2/3 operands at a training shape: merged q/k/v/dout, a ragged
    key mask with all-padding rows (every 97th, or ``padding_rows`` rows
    drawn at random)."""
    def mk(L):
        return torch.randn(B, L * h, d, generator=gen, device=gen.device).to(dtype).cuda()

    qm, km, vm, dout = mk(Lq), mk(Lk), mk(Lk), mk(Lq)
    mask = torch.rand(B, Lk, generator=gen, device=gen.device) > 0.3
    mask[:, 0] = True
    mask[1::97] = False  # all-padding surface forms
    if padding_rows:
        mask[torch.randperm(B, generator=gen, device=gen.device)[:padding_rows]] = False
    return qm, km, vm, dout, mask.repeat_interleave(h, dim=-1).float().cuda(), mask.cuda()


def core_bound(B, Lq, Lk, dtype, backward, h=12, d=64):
    size = torch.finfo(dtype).bits // 8
    n_q, n_k = B * Lq * h * d, B * Lk * h * d
    mask_bytes = B * Lk * h * 4
    if backward:  # q, k, v, dout in; dq, dk, dv out; five products
        nbytes = (2 * n_q + 2 * n_k) * size + (n_q + 2 * n_k) * size + mask_bytes
        flops = 5 * 2 * B * h * Lq * Lk * d
    else:  # q, k, v in; out; two products
        nbytes = (2 * n_q + 2 * n_k) * size + mask_bytes
        flops = 2 * 2 * B * h * Lq * Lk * d
    return bound(flops, nbytes, dtype)


def sdpa_layout(qm, km, vm, mask, Lq, Lk, h=12, d=64):
    B = qm.shape[0]
    q4 = qm.view(B, Lq, h, d).transpose(1, 2)
    k4 = km.view(B, Lk, h, d).transpose(1, 2)
    v4 = vm.view(B, Lk, h, d).transpose(1, 2)
    return q4, k4, v4, mask[:, None, None, :]


def check_train_core(B, Lq, Lk, dtype, rate, gen, timed, seed=1234, padding_rows=0, h=12,
                     d=64, plain_reps=5, reps=20):
    """Kernels 2 and 3 against their plain versions at one training shape,
    dtype, head count and width and dropout rate; with ``timed``, their
    median times beside the plain versions' (median of ``plain_reps``),
    SDPA's (forward; backward) and the bounds."""
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.ops.attention_core import (
        attention_core, attention_core_bwd, attention_core_bwd_reference,
        attention_core_reference)

    qm, km, vm, dout, kmaskf, mask = core_inputs(B, Lq, Lk, dtype, gen, h=h, d=d,
                                                 padding_rows=padding_rows)
    tag = f"B={B} Lq*h={Lq * h} Lk*h={Lk * h} {str(dtype)[6:]} rate {rate}"
    if (h, d) != (12, 64):
        tag += f" h={h} d={d}"
    if padding_rows:
        tag += f" ({int((~mask).all(1).sum())} all-padding rows)"
    before = dict(_build.launch_counts)
    out = attention_core(qm, km, vm, kmaskf, h, rate, seed)
    grads = attention_core_bwd(qm, km, vm, kmaskf, dout, h, rate, seed)
    torch.cuda.synchronize()
    for name in ("attention_core", "attention_core_bwd"):
        if _build.launch_counts[name] != before[name] + 1:
            raise AssertionError(f"{name} did not count its launch")
    err_f = compare(out, attention_core_reference(qm, km, vm, kmaskf, h, rate, seed), dtype,
                    f"kernel 2 {tag}")
    refs = attention_core_bwd_reference(qm, km, vm, kmaskf, dout, h, rate, seed)
    err_b = max(compare(g, r, dtype, f"kernel 3 {tag} {n}")
                for n, g, r in zip(("dq", "dk", "dv"), grads, refs))
    del out, grads, refs
    if not timed:
        return None
    ms_f = median_ms(lambda: attention_core(qm, km, vm, kmaskf, h, rate, seed), reps=reps)
    b2b = burst_ms(lambda: attention_core(qm, km, vm, kmaskf, h, rate, seed), n=reps)
    ms_b = median_ms(lambda: attention_core_bwd(qm, km, vm, kmaskf, dout, h, rate, seed),
                     reps=reps)
    b2b_b = burst_ms(lambda: attention_core_bwd(qm, km, vm, kmaskf, dout, h, rate, seed), n=reps)
    plain_f = median_ms(lambda: attention_core_reference(qm, km, vm, kmaskf, h, rate, seed),
                        reps=plain_reps, warmup=0)
    plain_b = median_ms(
        lambda: attention_core_bwd_reference(qm, km, vm, kmaskf, dout, h, rate, seed),
        reps=plain_reps, warmup=0)
    q4, k4, v4, amask = sdpa_layout(qm, km, vm, mask, Lq, Lk, h, d)
    q4, k4, v4 = (t.detach().requires_grad_() for t in (q4, k4, v4))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_f = median_ms(lambda: sdpa(q4, k4, v4, attn_mask=amask, dropout_p=rate))
    o4 = sdpa(q4, k4, v4, attn_mask=amask, dropout_p=rate)
    g4 = dout.view(B, Lq, h, d).transpose(1, 2)
    lib_b = median_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4, retain_graph=True))
    del o4
    bound_f, by_f = core_bound(B, Lq, Lk, dtype, backward=False, h=h, d=d)
    bound_b, by_b = core_bound(B, Lq, Lk, dtype, backward=True, h=h, d=d)
    log(f"  kernel 2 {tag}: {ms_f:.4f} ms (back to back {b2b:.4f} ms), plain {plain_f:.4f} ms, "
        f"SDPA {lib_f:.4f} ms, bound {bound_f:.4f} ms ({by_f})")
    log(f"  kernel 3 {tag}: {ms_b:.4f} ms (back to back {b2b_b:.4f} ms), plain {plain_b:.4f} ms, "
        f"SDPA backward {lib_b:.4f} ms, bound {bound_b:.4f} ms ({by_b})")
    fwd = dict(max_abs_err=err_f, ms=ms_f, plain_ms=plain_f, bound_ms=bound_f, bound_by=by_f,
               library_ms=lib_f)
    bwd = dict(max_abs_err=err_b, ms=ms_b, plain_ms=plain_b, bound_ms=bound_b, bound_by=by_b,
               library_ms=lib_b)
    return fwd, bwd


def observed_keep(B, Lq, Lk, rate, seed, gen, h=12):
    """Kernel 2's own keep mask, read off its output: with each key's value
    row the one-hot e_j, output column j of query i is the dropped weight
    (0 where dropped). Returns bool (B, h, Lq, Lk)."""
    from zett_tpu_torch.ops.attention_core import attention_core

    qm = torch.randn(B, Lq * h, 64, generator=gen, device=gen.device).cuda()
    km = torch.randn(B, Lk * h, 64, generator=gen, device=gen.device).cuda()
    vm = torch.zeros(B, Lk, h, 64)
    for j in range(Lk):
        vm[:, j, :, j] = 1.0
    vm = vm.view(B, Lk * h, 64).cuda()
    kmaskf = torch.ones(B, Lk * h).cuda()
    out = attention_core(qm, km, vm, kmaskf, h, rate, seed)
    return out.view(B, Lq, h, 64)[..., :Lk].permute(0, 2, 1, 3) != 0, out


def check_dropout(gen, rate=0.1):
    """Kernel 2's mask: kept fraction within 5 sigma of 1 - rate; the same
    seed gives bitwise the same output, another seed another mask."""
    B, L = 32896, 7
    keep, out = observed_keep(B, L, L, rate, 99, gen)
    n = keep.numel()
    frac = keep.float().mean().item()
    sigma = math.sqrt(rate * (1 - rate) / n)
    log(f"  dropout: kept fraction {frac:.6f} of {n} weights (expected {1 - rate}, "
        f"5 sigma {5 * sigma:.2e})")
    if abs(frac - (1 - rate)) > 5 * sigma:
        raise AssertionError(f"kept fraction {frac} is not within 5 sigma of {1 - rate}")
    gen2 = torch.Generator().manual_seed(SEED + 5)
    keep_a, out_a = observed_keep(64, L, L, rate, 99, gen2)
    gen2 = torch.Generator().manual_seed(SEED + 5)
    keep_b, out_b = observed_keep(64, L, L, rate, 99, gen2)
    gen2 = torch.Generator().manual_seed(SEED + 5)
    keep_c, _ = observed_keep(64, L, L, rate, 100, gen2)
    if not torch.equal(out_a, out_b):
        raise AssertionError("the same seed gave different outputs")
    if torch.equal(keep_a, keep_c):
        raise AssertionError("another seed gave the same mask")
    log("  dropout: same seed bitwise equal, another seed another mask")


def phase_train_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for rate in (0.0, 0.1):
            for B, Lq, Lk in ((32896, 7, 7), (32896, 1, 7), (16384, 1, 1)):
                main = dtype == torch.bfloat16 and rate == 0.0 and (Lq, Lk) == (7, 7)
                r = check_train_core(B, Lq, Lk, dtype, rate, gen, timed=dtype == torch.bfloat16)
                if main:
                    results["attention_core"], results["attention_core_bwd"] = r
            check_train_core(1001, 7, 7, dtype, rate, gen, timed=False)  # ragged batch
            # the core's other tilings: Lq 16 in one m16 tile with two n8 key
            # tiles; two m16 tiles, four n8 tiles and a row too large for two
            # shared-memory buffers
            check_train_core(777, 16, 9, dtype, rate, gen, timed=False)
            check_train_core(300, 20, 32, dtype, rate, gen, timed=False)
            torch.cuda.empty_cache()
    # a train batch's share of all-padding surface forms (phase 7's last
    # batch: 18991 of 32896); the train step runs the core at rate 0
    # (deterministic unless the backbone trains), and dropout at 0.1
    for rate in (0.0, 0.1):
        check_train_core(32896, 7, 7, torch.bfloat16, rate, gen, timed=True, padding_rows=18991)
    torch.cuda.empty_cache()
    check_dropout(gen)
    return results


# --------------------------------------------------------------------- phase 6
def phase_hypernet_train(config=GPT2_EN):
    """The hypernet's training route (inference=False: torch projections
    around kernels 2 and 3) at ``config``'s widths on HYPERNET_ROWS rows, f32: loss
    and every parameter gradient on the card against the CPU's (plain
    versions), from the same weights and inputs."""
    from zett_tpu_torch.models import Hypernet, HypernetConfig
    from zett_tpu_torch.models.convert import flax_to_torch
    from zett_tpu_torch.ops import _build

    rng = np.random.default_rng(SEED + 2)
    vocab = 50001
    cfg = HypernetConfig(**config, original_vocab_size=vocab)
    cpu_model = Hypernet(cfg, dtype=torch.float32)
    cpu_model.load_state_dict(flax_to_torch(flax_layout(cpu_model, rng)))
    gpu_model = Hypernet(cfg, dtype=torch.float32)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model = gpu_model.cuda()
    src = 0.1 * rng.standard_normal((vocab + (-vocab) % 128, 768), dtype=np.float32)
    sf = torch.from_numpy(hypernet_inputs(rng, HYPERNET_ROWS, vocab, cfg.hn_surface_maxlen,
                                          cfg.n_extra_tokens))
    priors = torch.from_numpy(hypernet_priors(rng, HYPERNET_ROWS))
    w_in = torch.from_numpy(rng.standard_normal((HYPERNET_ROWS, 768), dtype=np.float32))
    w_b = torch.from_numpy(rng.standard_normal(HYPERNET_ROWS, dtype=np.float32))

    def loss_of(model, dev):
        e, _, b = model(sf.to(dev), priors.to(dev), torch.from_numpy(src).to(dev), None,
                        deterministic=True, inference=False)
        return (e * w_in.to(dev)).sum() + (b * w_b.to(dev)).sum()

    before = dict(_build.launch_counts)
    got = loss_of(gpu_model, "cuda")
    got.backward()
    torch.cuda.synchronize()
    for name in ("attention_core", "attention_core_bwd"):
        if _build.launch_counts[name] == before[name]:
            raise AssertionError(f"the training route on the card did not launch {name}")
    ref = loss_of(cpu_model, "cpu")
    ref.backward()
    got, ref = float(got.detach()), float(ref.detach())
    err = abs(got - ref)
    log(f"  loss: card {got:.6f} CPU {ref:.6f} (tol 1e-5 x max(|loss|, 1))")
    if not math.isfinite(got) or err > 1e-5 * max(abs(ref), 1.0):
        raise AssertionError(f"training-route loss differs: {err}")
    grads = {n: (p.grad, dict(cpu_model.named_parameters())[n].grad)
             for n, p in gpu_model.named_parameters()}
    top = max(float(r.abs().max()) for _, r in grads.values())
    worst, worst_name = 0.0, ""
    for name, (g, r) in grads.items():
        scale = max(float(r.abs().max()), 1e-2 * top)
        ratio = float((g.cpu() - r).abs().max()) / scale
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite gradient of {name}")
        if ratio > worst:
            worst, worst_name = ratio, name
    # f32 sums over the rows in another order, through three layers and
    # the projector blocks; leaves whose exact gradient is 0 (the key
    # biases) are judged at 1% of the largest gradient
    log(f"  gradients of {len(grads)} parameters: worst max abs error / scale {worst:.3g} "
        f"({worst_name}; tol 2e-4)")
    if worst > 2e-4:
        raise AssertionError(f"training-route gradient of {worst_name} differs: {worst}")


# --------------------------------------------------------------------- phase 7
TRAIN_TEXT_SOURCES = ("SURVEY.md", "PAPER.md", "PAPERS.md", "VERDICT.md")


def write_training_text(directory, valid_directory=None, hold_out_every=0):
    """en.txt from Markdown files of the repo, one paragraph per line; with
    ``hold_out_every`` = k, every k-th paragraph goes to
    ``valid_directory``/en.txt instead. Returns (paragraphs, characters) of
    the training text, or (training, held-out) paragraph counts with a
    hold-out."""
    import glob

    paths = [os.path.join(REPO, f) for f in TRAIN_TEXT_SOURCES]
    paths += sorted(glob.glob(os.path.join(REPO, "docs", "*.md")))
    paragraphs = []
    for path in paths:
        with open(path) as f:
            for block in f.read().split("\n\n"):
                line = " ".join(part.strip() for part in block.splitlines() if part.strip())
                if line:
                    paragraphs.append(line)
    if hold_out_every:
        held = paragraphs[hold_out_every - 1::hold_out_every]
        paragraphs = [p for i, p in enumerate(paragraphs) if (i + 1) % hold_out_every]
        os.makedirs(valid_directory, exist_ok=True)
        with open(os.path.join(valid_directory, "en.txt"), "w") as f:
            f.write("\n".join(held) + "\n")
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "en.txt"), "w") as f:
        f.write("\n".join(paragraphs) + "\n")
    if hold_out_every:
        return len(paragraphs), len(held)
    return len(paragraphs), sum(map(len, paragraphs))


def phase_training(model_dir):
    """python -m zett_tpu_torch.training at configs/zeroshot/gpt2_en.json's
    widths through its ``main`` on the default device, then a transfer from
    the written final/."""
    from zett_tpu_torch.models.backbones.hf_io import load_hf_state_dict
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.training.__main__ import load_config_file
    from zett_tpu_torch.training.__main__ import main as train_main
    from zett_tpu_torch.transfer.__main__ import main as transfer_main

    train_dir, out = os.path.join(WORK, "train_text"), os.path.join(WORK, "train_out")
    n_par, n_chars = write_training_text(train_dir)
    config = load_config_file(os.path.join(REPO, "configs", "zeroshot", "gpt2_en.json"))
    for key in ("valid_directory", "extra_valid_tokenizers"):
        config.pop(key)
    reduced = dict(model_dir=model_dir, train_directory=train_dir, output_dir=out, steps=6,
                   identity_steps=2, warmup_steps=[2, 4], random_warmup_steps=0,
                   logging_steps=1, save_steps=0, num_workers=0, prefetch_batches=0,
                   eval_at_step_zero=False)
    config.update(reduced)
    config_path = os.path.join(WORK, "gpt2_en_smoke.json")
    with open(config_path, "w") as f:
        json.dump(config, f)
    log(f"  training text: {n_par} paragraphs, {n_chars} characters; overrides {reduced}")

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    trainer, history = train_main([config_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    steps = config["steps"]
    n_layers = config["num_hidden_layers"]
    expected = dict.fromkeys(_build.launch_counts, 0)
    expected["attention_core"] = expected["attention_core_bwd"] = steps * n_layers
    kinds = [r["kind"] for r in trainer.records]
    log(f"  trained {steps} steps ({kinds.count('identity')} identity) in {wall:.3f} s wall, "
        f"launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    if kinds.count("identity") != 2 or kinds.count("train") != steps - 2:
        raise AssertionError(f"step kinds {kinds}")
    losses = [h.get("loss", h.get("identity_loss")) for h in history]
    log(f"  logged losses {['%.4f' % x for x in losses]}")
    if len(history) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bad training history {history}")

    # frozen weights bitwise unchanged, trainable ones moved
    source = load_hf_state_dict(model_dir)
    for key, p in trainer.backbone.named_hf_parameters():
        if not torch.equal(p.detach().cpu(), source[key].to(torch.bfloat16)):
            raise AssertionError(f"backbone weight {key} changed")
    hn = trainer.hypernet
    for scaler in (hn.in_scaler, hn.scaler):
        if not (bool((scaler.w == 1).all()) and bool((scaler.b == 0).all())):
            raise AssertionError("a rescaler changed")
    from zett_tpu_torch.models import Hypernet

    init = Hypernet(trainer.hn_config, dtype=trainer.dtype)
    init.init_weights(torch.Generator().manual_seed(trainer.cfg.seed))
    init_params = dict(init.named_parameters())
    # every trainable parameter moves except those whose exact gradient is
    # 0: the attention key biases (the softmax ignores a per-query constant)
    # and the bias head's bias (the predicted bias is unused without
    # learnable_bias); decay moves the bias head's kernel
    exempt = ("attention.key.bias", "bias_projection.bias")
    required = [n for n, _ in hn.named_parameters()
                if "scaler" not in n and not n.endswith(exempt)]
    still = [n for n in required
             if torch.equal(dict(hn.named_parameters())[n].detach().cpu(), init_params[n])]
    log(f"  {len(required) - len(still)} of {len(required)} trainable hypernet parameters "
        f"changed (exempt: {exempt})")
    if still:
        raise AssertionError(f"trainable hypernet parameters did not change: {still}")

    records = trainer.records
    train_ms = [r["device_ms"] for r in records if r["kind"] == "train"][1:]
    ident_ms = [r["device_ms"] for r in records if r["kind"] == "identity"][1:]
    collate_ms = [r["collate_ms"] for r in records if r["kind"] == "train"]
    step_wall = [r["collate_ms"] + r["host_ms"] for r in records if r["kind"] == "train"][1:]
    log(f"  on {CARD}: train step {np.median(train_ms):.3f} ms (CUDA events, median of the "
        f"steps after the first: {['%.3f' % x for x in train_ms]}); identity step "
        f"{['%.3f' % x for x in ident_ms]} ms; host collate per train batch "
        f"{['%.1f' % x for x in collate_ms]} ms; peak memory {peak_gb:.2f} GiB")

    batch = trainer.last_train_batch
    sf = batch["target_surface_forms"]
    log(f"  last train batch: {int(batch['mask'].sum())} sampled vocab rows of {len(sf)}, "
        f"{int((sf == 0).all(1).sum())} all-padding surface forms")
    trainer.train_step(batch)  # warm the exact shapes, outside the counted run
    busy, prof_wall, by_name = device_breakdown(lambda: trainer.train_step(batch), top=16)
    if busy is not None:
        def share(pred):
            return sum(ms for n, (ms, _) in by_name.items() if pred(n))

        # kernel 2: zt::attention_mma_kernel (bf16), zt::attention_kernel (f32)
        k2 = share(lambda n: "zt::attention_" in n and "bwd" not in n)
        k3 = share(lambda n: "attention_bwd" in n)
        # cuBLAS's Hopper GEMMs are named nvjet_*; older ones gemm/cutlass/xmma
        gemm = share(lambda n: any(t in n.lower() for t in ("nvjet", "gemm", "cutlass", "xmma")))
        elementwise = share(lambda n: "at::native" in n)
        total = sum(ms for ms, _ in by_name.values())
        log(f"  train step breakdown (device ms): kernel 2 {k2:.3f}, kernel 3 {k3:.3f}, "
            f"cuBLAS GEMMs {gemm:.3f}, PyTorch elementwise/reduction/copy kernels "
            f"{elementwise:.3f}, other {total - k2 - k3 - gemm - elementwise:.3f}; idle share "
            f"of the loop (collate included) {1 - busy / float(np.median(step_wall)):.3f}")

    t0 = time.perf_counter()
    target = os.path.join(REPO, "artifacts", "tokenizers", "gpt_neox0001", "tokenizer.json")
    transfer_main(["--checkpoint", os.path.join(out, "final"), "--model", model_dir,
                   "--target-tokenizer", target, "--output", os.path.join(WORK, "trained_out")])
    if not os.path.exists(os.path.join(WORK, "trained_out", "model.safetensors")):
        raise AssertionError("the transfer from final/ wrote no model")
    log(f"  transfer from the trained final/: {time.perf_counter() - t0:.3f} s")
    return launches, float(np.median(train_ms)), wall


# --------------------------------------------------------------------- phase 3
def flax_layout(model, rng):
    """Seeded parameters for a port Hypernet, keyed by Flax path (the layout
    of a checkpoint's params.npz): kernels (in, out), embeddings, scales, as
    numpy arrays. ``rng`` is a numpy Generator, or a torch Generator whose
    device draws them (the card draws Mistral's 0.7 G parameters in about a
    second, numpy in about ten)."""
    from zett_tpu_torch.models.hypernet import Dense, LayerNorm
    from zett_tpu_torch.models.hypernet_t5 import T5LayerNorm

    def normal(shape):
        if isinstance(rng, torch.Generator):
            return torch.randn(shape, generator=rng, device=rng.device)
        return rng.standard_normal(shape, dtype=np.float32)

    kinds = {}
    for name, mod in model.named_modules():
        if isinstance(mod, Dense):
            kinds[name] = "dense"
        elif isinstance(mod, LayerNorm):
            kinds[name] = "ln"
        elif isinstance(mod, T5LayerNorm):
            kinds[name] = "rms"
        elif isinstance(mod, torch.nn.Embedding):
            kinds[name] = "embed"
    flat = {}
    for name, p in model.state_dict().items():
        mod, leaf = name.rpartition(".")[::2]
        kind = kinds.get(mod)
        shape = tuple(p.shape)
        if kind == "dense" and leaf == "weight":
            fan_in = shape[1]
            value = normal(shape[::-1]) / math.sqrt(fan_in)
            leaf = "kernel"
        elif kind == "ln" and leaf == "weight":
            value = 1 + 0.1 * normal(shape)
            leaf = "scale"
        elif kind == "rms":
            value = 1 + 0.1 * normal(shape)
        elif kind == "embed":
            value = 0.02 * normal(shape)
            leaf = "embedding"
        elif leaf == "w":
            value = 1 + 0.1 * normal(shape)
        else:
            value = 0.02 * normal(shape)
        parts = mod.split(".") if mod else []
        path, i = [], 0
        while i < len(parts):
            if parts[i] == "layers" and path == ["encoder"]:
                path.append(f"layer_{parts[i + 1]}")
                i += 2
                continue
            path.append(f"layers_{parts[i]}" if parts[i].isdigit() else parts[i])
            i += 1
        flat["/".join(path + [leaf])] = value if isinstance(value, np.ndarray) else \
            value.cpu().numpy()
    return flat


def hypernet_inputs(rng, n, vocab, maxlen, n_extra):
    sf = rng.integers(1, vocab + n_extra, size=(n, maxlen))
    lens = rng.integers(1, maxlen + 1, size=n)
    sf[np.arange(maxlen)[None] >= lens[:, None]] = 0
    sf[5::211] = 0
    return sf


def hypernet_priors(rng, n):
    """Unigram-log-prob-like priors, the padding fill on every 97th row."""
    from zett_tpu_torch.constants import NEGATIVE_INF_FILL_VALUE

    priors = (rng.standard_normal(n) * 2.0 - 9.0).astype(np.float32)
    priors[3::97] = NEGATIVE_INF_FILL_VALUE
    return priors


def phase_hypernet(config=GPT2_EN, launched=None):
    """The Hypernet's inference route on HYPERNET_ROWS rows at ``config``'s widths,
    card against CPU, f32; ``launched`` maps each kernel to the launches the
    forward must count (default: kernel 1 on the non-CLS layers, kernel 2
    on the CLS layer)."""
    from zett_tpu_torch.models import Hypernet, HypernetConfig
    from zett_tpu_torch.models.convert import flax_to_torch
    from zett_tpu_torch.ops import _build

    rng = np.random.default_rng(SEED)
    vocab = 50001
    cfg = HypernetConfig(**config, original_vocab_size=vocab)
    n_layers = cfg.num_hidden_layers
    if launched is None:
        launched = {"encoder_layer": n_layers - 1, "attention_core": 1, "attention_block": 0}
    cpu_model = Hypernet(cfg, dtype=torch.float32)
    cpu_model.load_state_dict(flax_to_torch(flax_layout(cpu_model, rng)))
    gpu_model = Hypernet(cfg, dtype=torch.float32)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model = gpu_model.cuda().eval()
    src = 0.1 * rng.standard_normal((vocab + (-vocab) % 128, 768), dtype=np.float32)
    sf = hypernet_inputs(rng, HYPERNET_ROWS, vocab, cfg.hn_surface_maxlen, cfg.n_extra_tokens)
    sf_t, src_t = torch.from_numpy(sf), torch.from_numpy(src)
    priors = torch.from_numpy(hypernet_priors(rng, HYPERNET_ROWS))
    before = dict(_build.launch_counts)
    with torch.inference_mode():
        got = gpu_model(sf_t.cuda(), priors.cuda(), src_t.cuda())
        torch.cuda.synchronize()
        counts = {k: _build.launch_counts[k] - before[k] for k in launched}
        ref = cpu_model(sf_t, priors, src_t)
    log(f"  launches of one forward: {counts} (expected {launched})")
    if counts != launched:
        raise AssertionError(f"the Hypernet on the card launched {counts}, expected {launched}")
    for name, g, r in (("emb_in", got[0], ref[0]), ("bias", got[2], ref[2])):
        g, r = g.float().cpu().numpy(), r.float().numpy()
        err = np.abs(g - r).max()
        scale = np.abs(r).max()
        # three layers and four projection blocks of f32 sums in another
        # order than the CPU's (the card showed 1.6e-6 x scale)
        log(f"  hypernet {name}: max abs {err:.3g} at output scale {scale:.3g} (tol 1e-5 x scale)")
        if not np.isfinite(g).all() or err > 1e-5 * max(scale, 1.0):
            raise AssertionError(f"hypernet {name} differs: {err}")


# --------------------------------------------------------------------- phase 4
def write_source_model(path, vocab, rng):
    """A GPT-2-small-shaped HF directory (12 layers, 768 wide, 12 heads)
    with seeded weights and gpt2_raw's tokenizer."""
    from zett_tpu_torch.models.backbones.hf_io import save_safetensors

    E, n_pos, n_layer = 768, 1024, 12

    def normal(shape, s):
        return torch.from_numpy(s * rng.standard_normal(shape, dtype=np.float32))

    sd = {
        "transformer.wte.weight": normal((vocab, E), 0.1),
        "transformer.wpe.weight": normal((n_pos, E), 0.01),
        "transformer.ln_f.weight": 1 + normal((E,), 0.1),
        "transformer.ln_f.bias": normal((E,), 0.1),
    }
    for i in range(n_layer):
        for name, shape in (("ln_1.weight", (E,)), ("ln_1.bias", (E,)),
                            ("ln_2.weight", (E,)), ("ln_2.bias", (E,)),
                            ("attn.c_attn.weight", (E, 3 * E)), ("attn.c_attn.bias", (3 * E,)),
                            ("attn.c_proj.weight", (E, E)), ("attn.c_proj.bias", (E,)),
                            ("mlp.c_fc.weight", (E, 4 * E)), ("mlp.c_fc.bias", (4 * E,)),
                            ("mlp.c_proj.weight", (4 * E, E)), ("mlp.c_proj.bias", (E,))):
            sd[f"transformer.h.{i}.{name}"] = normal(shape, 0.02)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    os.makedirs(path, exist_ok=True)
    save_safetensors(sd, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "gpt2", "vocab_size": vocab, "n_positions": n_pos,
                   "n_embd": E, "n_layer": n_layer, "n_head": 12,
                   "layer_norm_epsilon": 1e-5, "tie_word_embeddings": True}, f)
    shutil.copy(os.path.join(REPO, "artifacts", "tokenizers", "gpt2_raw", "tokenizer.json"),
                os.path.join(path, "tokenizer.json"))
    return sd["transformer.wte.weight"]


def write_checkpoint(path, vocab, rng, config=GPT2_EN):
    from zett_tpu_torch.models import Hypernet, HypernetConfig

    cfg = HypernetConfig(**config, original_vocab_size=vocab)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "hn_config.json"), "w") as f:
        json.dump({**cfg.to_dict(), "dtype": "bfloat16"}, f)
    np.savez(os.path.join(path, "params.npz"),
             **flax_layout(Hypernet(cfg, dtype=torch.bfloat16), rng))
    shutil.copy(os.path.join(REPO, "artifacts", "tokenizers", "gpt2_raw", "tokenizer.json"),
                os.path.join(path, "tokenizer.json"))
    return cfg


@contextlib.contextmanager
def captured_transfer():
    """Inside the block, the transfer CLI's ``core.transfer`` also records
    its hypernet and that hypernet's first call ((arguments), outputs), and
    ``batched_inference`` its predict function, the vocab size and each
    batch's (surface forms, priors): timed passes over the transfer's own
    batches after the CLI returns, with no second load."""
    from zett_tpu_torch.transfer import core

    captured = {}
    orig_transfer, orig_batched = core.transfer, core.batched_inference

    def transfer(**kw):
        def first_call(module, args, out):
            captured.setdefault("first", (args, out))

        captured["hypernet"] = kw["hypernet"]
        handle = kw["hypernet"].register_forward_hook(first_call)
        try:
            return orig_transfer(**kw)
        finally:
            handle.remove()

    def batched(predict_fn, surface_forms, priors, **kw):
        calls = []

        def predict(sf, pr):
            calls.append((sf, pr))
            return predict_fn(sf, pr)

        captured.update(predict=predict_fn, calls=calls, n=len(surface_forms))
        return orig_batched(predict, surface_forms, priors, **kw)

    core.transfer, core.batched_inference = transfer, batched
    try:
        yield captured
    finally:
        core.transfer, core.batched_inference = orig_transfer, orig_batched


def timed_passes(captured, reps):
    """The captured transfer's batches through its predict function (the
    CLI's pass warmed them up): (the pass as a callable, median ms of
    ``reps`` passes between CUDA events, all times, vocab, batch shapes)."""
    predict, calls = captured["predict"], captured["calls"]

    def run():
        for sf, pr in calls:
            predict(sf, pr)

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return run, float(np.median(times)), times, captured["n"], [sf.shape for sf, _ in calls]


def device_events(run):
    """The device kernels of one run (torch.profiler) in launch order, as
    (name, start us, ms), and the run's host wall time in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the profiler's raw events: its FunctionEvent list (prof.events()) takes
    # seconds of host time to build for a train step's thousands of ops
    events = [e for e in prof.profiler.kineto_results.events() if not e.is_hidden_event()]
    # the device timeline also carries annotations named after the host ops
    # that enclose its kernels: keep device events no host op is named as
    host_names = {e.name() for e in events if e.device_type() != DeviceType.CUDA}
    kernels = [(torch._C._demangle(e.name()), e.start_ns() / 1e3, e.duration_ns() / 1e6)
               for e in events if e.device_type() == DeviceType.CUDA and e.name() not in host_names]
    return sorted(kernels, key=lambda k: k[1]), wall_ms


def device_breakdown(run, top=12):
    """Device time by kernel over one run (torch.profiler), the device's
    busy time and its idle share of the run's host wall time. Returns
    (busy_ms, wall_ms, {kernel name: (ms, launches)}); busy_ms is None when
    the profiler recorded no device time."""
    kernels, wall_ms = device_events(run)
    by_name = {}
    busy_ms, reach = 0.0, float("-inf")  # union of the kernels' spans
    for name, start, ms in kernels:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + ms, n + 1)
        end = start + ms * 1e3
        busy_ms += max(0.0, end - max(start, reach)) / 1e3
        reach = max(reach, end)
    if busy_ms == 0:
        log("  profile: no device time recorded (not measured)")
        return None, wall_ms, by_name
    log(f"  profile: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"(idle share {1 - busy_ms / wall_ms:.3f})")
    total = sum(ms for ms, _ in by_name.values())
    ours = sum(ms for name, (ms, _) in by_name.items() if "zt::" in name)
    log(f"  profile: the port's kernels {ours:.3f} ms ({100 * ours / total:.1f}% of device "
        f"time), library and elementwise kernels {total - ours:.3f} ms")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"    {ms:9.3f} ms {100 * ms / total:5.1f}% x{count:<4d} {name[:90]}")
    return busy_ms, wall_ms, by_name


def burst_ms(run, n=20):
    """Per-call time of ``n`` back-to-back calls between two CUDA events:
    while a call's kernel runs longer than the wrapper's host time, the card
    never waits for the host, and this is the kernel's own time (a median of
    single timed calls also holds the host time of a short call). Fewer
    calls (at least 2) where ``n`` would pass TIMING_BUDGET_MS."""
    n = min(n, max(2, int(TIMING_BUDGET_MS / event_ms(run))))  # the warm call
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def gemm_split(run, shapes, dtype, what, reps=5):
    """One call of a kernel wrapper split by device kernel name (mean over
    ``reps`` profiled calls), with each launch of the port's GEMM (median
    per position in launch order, ``shapes`` = [(label, M, K, N)]) beside
    torch.matmul on
    the same shapes: cuBLAS, a timed-only yardstick that the port never
    calls. Returns {label: (port ms, port TFLOP/s, cuBLAS ms, cuBLAS
    TFLOP/s)}, or None when the profile holds no whole calls."""
    run()  # warm
    kernels, _ = device_events(lambda: [run() for _ in range(reps)])
    gemms = [ms for name, _, ms in kernels if "gemm_" in name and "zt::" in name]
    calls = len(gemms) // len(shapes)
    # the profiler may drop the first launches of its window: use whole calls
    if not calls or len(gemms) % len(shapes):
        log(f"  {what}: the profile holds {len(gemms)} GEMM launches of {reps} calls "
            f"(not whole calls): GEMM split not measured")
        return None
    by_name = {}
    for name, _, ms in kernels:
        by_name.setdefault(name, []).append(ms)
    parts = ", ".join(f"{name.split('(')[0][:48]} {sum(t) / calls:.4f} ms"
                      for name, t in sorted(by_name.items(), key=lambda kv: -sum(kv[1])))
    log(f"  {what} device time per call by kernel (mean of {calls} profiled calls): {parts}")
    out = {}
    for i, (label, M, K, N) in enumerate(shapes):
        ours = float(np.median(gemms[i::len(shapes)]))
        a = torch.randn(M, K, device="cuda").to(dtype)
        w = torch.randn(K, N, device="cuda").to(dtype)
        lib = median_ms(lambda: torch.matmul(a, w))
        del a, w
        flops = 2.0 * M * K * N
        rate, lib_rate = flops / ours / 1e9, flops / lib / 1e9
        log(f"    {what} {label} GEMM ({M}x{K})({K}x{N}): port {ours:.4f} ms, {rate:.1f} "
            f"TFLOP/s; cuBLAS torch.matmul {lib:.4f} ms, {lib_rate:.1f} TFLOP/s; port at "
            f"{rate / lib_rate:.3f} of cuBLAS's rate, {rate / PEAK_FLOPS[dtype] * 1e12:.3f} of "
            f"the {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s peak")
        out[label] = (ours, rate, lib, lib_rate)
    return out


def write_transfer_inputs(config, tag):
    """Phase 4's (and 10's) seeded GPT-2-small-shaped source model in
    WORK/gpt2 (the same weights for every ``tag``) and a seeded hypernet
    checkpoint at ``config`` in WORK/``tag``. Returns (the source table,
    the checkpoint's config)."""
    from zett_tpu_torch.tokenization.core import Tokenizer

    vocab = len(Tokenizer.from_file(
        os.path.join(REPO, "artifacts", "tokenizers", "gpt2_raw", "tokenizer.json")))
    rng = np.random.default_rng(SEED)
    wte = write_source_model(os.path.join(WORK, "gpt2"), vocab, rng)
    cfg = write_checkpoint(os.path.join(WORK, tag), vocab, rng, config)
    return wte, cfg


def phase_transfer(config=GPT2_EN, tag="ckpt"):
    """Zero-shot transfer through the CLI at ``config`` (bf16 checkpoint,
    gpt_neox0001 target, batch 16384) from phase 4's seeded source model.
    Returns (launches, wall s, hypernet ms for the whole vocab, vocab)."""
    from zett_tpu_torch.models.backbones.hf_io import load_safetensors
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.tokenization.core import Tokenizer
    from zett_tpu_torch.transfer.__main__ import main as transfer_main

    source_tok = Tokenizer.from_file(
        os.path.join(REPO, "artifacts", "tokenizers", "gpt2_raw", "tokenizer.json"))
    vocab = len(source_tok)
    model_dir, ckpt, out = (os.path.join(WORK, d) for d in ("gpt2", tag, f"{tag}_out"))
    target_path = os.path.join(REPO, "artifacts", "tokenizers", "gpt_neox0001", "tokenizer.json")
    batch = 16384
    wte, cfg = PREPARED.pop(tag)[:2] if tag in PREPARED else write_transfer_inputs(config, tag)

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with captured_transfer() as captured:
        transfer_main(["--checkpoint", ckpt, "--model", model_dir,
                       "--target-tokenizer", target_path, "--output", out,
                       "--batch-size", str(batch), "--seed", str(SEED)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)

    for name in ("model.safetensors", "config.json", "tokenizer.json", "bias.npy"):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"transfer wrote no {name}")
    target = Tokenizer.from_file(os.path.join(out, "tokenizer.json"))
    with open(os.path.join(out, "config.json")) as f:
        if json.load(f)["vocab_size"] != len(target):
            raise AssertionError("config.json vocab_size is not the converted tokenizer's length")
    sd = load_safetensors(os.path.join(out, "model.safetensors"))
    emb = sd["transformer.wte.weight"]
    bias = np.load(os.path.join(out, "bias.npy"))
    if emb.shape != (len(target), 768) or not torch.isfinite(emb).all() \
            or not np.isfinite(bias).all():
        raise AssertionError(f"bad output table {tuple(emb.shape)}")
    if not torch.equal(sd["lm_head.weight"], emb):
        raise AssertionError("lm_head is not tied to the new table")
    for token in target.all_special_tokens:
        if not torch.equal(emb[target.token_to_id(token)], wte[source_tok.token_to_id(token)]):
            raise AssertionError(f"special token {token!r} row is not the source row")
    n_batches = -(-len(target) // batch)
    n_layers = cfg.num_hidden_layers
    expected = dict.fromkeys(_build.launch_counts, 0)
    if cfg.add_inter_token_attention:  # no CLS-only layer: kernel 4 on every layer
        expected["attention_block"] = n_batches * n_layers
    else:
        expected["encoder_layer"] = n_batches * (n_layers - 1)
        expected["attention_core"] = n_batches
    log(f"  transfer: {len(target)} tokens in {wall:.3f} s wall, launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")

    run, ms, times, n_vocab, shapes = timed_passes(captured, 5)
    log(f"  hypernet: median of 5 passes {ms:.3f} ms (min {min(times):.3f}, max "
        f"{max(times):.3f}) for the {n_vocab}-token vocab in batches {shapes} "
        f"({ms * 32768 / n_vocab:.3f} ms per 32k vocab)")
    device_breakdown(run)
    return launches, wall, ms, n_vocab


# --------------------------------------------------------------------- phase 8
def block_bias(B, L, dtype, gen):
    """Prior-like key bias (B, L): Unigram log-probs, the padding fill on
    the last key of every 13th row."""
    kb = torch.randn(B, L, generator=gen, device=gen.device) * 2.0 - 9.0
    kb[::13, -1] = -100000.0
    return kb.to(dtype).cuda()


def check_kernel4(B, L, dtype, with_bias, gen, timed, split=False, H=768, h=12, fan_in=False):
    """Kernel 4 (the tier-2 block) against its plain version at head width
    H / h; with ``timed``, its median time beside the plain version's, the
    library calls' (F.linear x3 + SDPA + F.linear) and the bound; with
    ``split``, its device time by kernel and each GEMM against cuBLAS.
    ``fan_in``: weights at 1/sqrt(H) (``layer_inputs``)."""
    import torch.nn.functional as F

    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.ops.attention_block import attention_block, attention_block_reference

    d = H // h
    args = layer_inputs(B, L, dtype, gen, H, fan_in=fan_in)
    x, mask, w = args[0], args[1], args[2:10]
    kb = block_bias(B, L, dtype, gen) if with_bias else None
    tag = f"kernel 4 B={B} L={L} {str(dtype)[6:]} {'key bias' if with_bias else 'no bias'}"
    if H != 768:
        tag += f" H={H} h={h}"
    before = _build.launch_counts["attention_block"]
    got = attention_block(x, mask, kb, *w, num_heads=h)
    torch.cuda.synchronize()
    if _build.launch_counts["attention_block"] != before + 1:
        raise AssertionError("attention_block did not count its launch")
    with torch.no_grad():
        ref = attention_block_reference(x, mask, kb, *w, h)
    err = compare(got, ref, dtype, tag)
    del got, ref
    if not timed:
        return None
    ms = median_ms(lambda: attention_block(x, mask, kb, *w, num_heads=h))
    b2b = burst_ms(lambda: attention_block(x, mask, kb, *w, num_heads=h))
    with torch.no_grad():
        plain_ms = median_ms(lambda: attention_block_reference(x, mask, kb, *w, h), reps=5)
    wq, bq, wk, bk, wv, bv, wo, bo = w
    wt = [t.t().contiguous() for t in (wq, wk, wv, wo)]
    amask = sdpa_mask(mask, kb, dtype)
    sdpa = F.scaled_dot_product_attention

    def library():
        q, k, v = (F.linear(x, wi, bi).view(B, L, h, d).transpose(1, 2)
                   for wi, bi in zip(wt[:3], (bq, bk, bv)))
        ctx = sdpa(q, k, v, attn_mask=amask).transpose(1, 2).reshape(B, L, H)
        return F.linear(ctx, wt[3], bo)

    with torch.no_grad():
        library_ms = median_ms(library)
    size = torch.finfo(dtype).bits // 8
    M = B * L
    flops = 2 * M * 4 * H * H + 2 * 2 * B * h * L * L * d
    nbytes = (2 * M * H + 4 * H * H + 4 * H + (B * L if with_bias else 0)) * size + B * L * 4
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    log(f"  {tag}: {ms:.4f} ms (back to back {b2b:.4f} ms), plain {plain_ms:.4f} ms, F.linear "
        f"x3 + SDPA + F.linear {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if split:
        gemm_split(lambda: attention_block(x, mask, kb, *w, num_heads=h),
                   [("[q|k|v]", M, H, 3 * H), ("out", M, H, H)], dtype, tag)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def sdpa_mask(mask, kb, dtype):
    """The key mask (and bias) as SDPA's float mask (B, 1, 1, L); a masked
    key gets the lowest finite value, as the port's select does."""
    low = torch.finfo(dtype).min
    add = kb if kb is not None else torch.zeros(mask.shape, dtype=dtype, device=mask.device)
    return torch.where(mask, add, torch.tensor(low, dtype=dtype, device=mask.device))[:, None, None, :]


def check_kernel5(B, L, dtype, with_bias, gen, timed, h=12):
    """Kernel 5 (the tier-1 core with key bias) against its plain version;
    with ``timed``, times beside the plain version, SDPA with the same float
    mask, and the bound."""
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.ops.attention_core import merged_attention, merged_attention_reference

    d = 64
    qm, km, vm = (torch.randn(B, L * h, d, generator=gen, device=gen.device).to(dtype).cuda()
                  for _ in range(3))
    mask = torch.rand(B, L, generator=gen, device=gen.device) > 0.3
    mask[:, 0] = True
    mask[1::97] = False  # all-padding surface forms
    mask = mask.cuda()
    kb = block_bias(B, L, dtype, gen) if with_bias else None
    kmask = mask.repeat_interleave(h, dim=-1)
    kbm = kb.repeat_interleave(h, dim=-1) if with_bias else None
    tag = (f"kernel 5 B={B} Lq*h=Lk*h={L * h} h={h} {str(dtype)[6:]} "
           f"{'key bias' if with_bias else 'no bias'}")
    before = _build.launch_counts["merged_attention"]
    got = merged_attention(qm, km, vm, kmask, kbm, num_heads=h)
    torch.cuda.synchronize()
    if _build.launch_counts["merged_attention"] != before + 1:
        raise AssertionError("merged_attention did not count its launch")
    ref = merged_attention_reference(qm, km, vm, kmask, kbm, num_heads=h)
    err = compare(got, ref, dtype, tag)
    del got, ref
    if not timed:
        return None
    ms = median_ms(lambda: merged_attention(qm, km, vm, kmask, kbm, num_heads=h))
    b2b = burst_ms(lambda: merged_attention(qm, km, vm, kmask, kbm, num_heads=h))
    plain_ms = median_ms(lambda: merged_attention_reference(qm, km, vm, kmask, kbm, num_heads=h),
                         reps=5)
    q4, k4, v4, _ = sdpa_layout(qm, km, vm, mask, L, L, h)
    amask = sdpa_mask(mask, kb, dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = median_ms(lambda: sdpa(q4, k4, v4, attn_mask=amask))
    size = torch.finfo(dtype).bits // 8
    flops = 2 * 2 * B * h * L * L * d
    nbytes = 4 * B * L * h * d * size + B * L * h * 4 + (B * L * h * size if with_bias else 0)
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    log(f"  {tag}: {ms:.4f} ms (back to back {b2b:.4f} ms), plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def check_block_backward(gen, B=2048, L=8, h=12):
    """attention_block_fused's backward without key bias on the card (torch
    matmuls around kernels 2 and 3) against the CPU's (the same around their
    plain versions), f32, ragged mask with all-padding rows: every input's
    gradient within 2e-4 of its scale (the key bias's, whose exact value is
    0, judged at 1% of the largest)."""
    from zett_tpu_torch.ops.attention_block import attention_block_fused

    args = layer_inputs(B, L, torch.float32, gen)
    x, mask, w = args[0], args[1], args[2:10]
    cot = torch.randn(B, L, x.shape[-1], generator=gen, device=gen.device)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).clone().requires_grad_() for t in (x, *w)]
        out = attention_block_fused(leaves[0], mask.float().to(dev), None, *leaves[1:], h, True,
                                    False)
        (out * cot.to(dev)).sum().backward()
        grads[dev] = [leaf.grad.cpu() for leaf in leaves]
    top = max(float(g.abs().max()) for g in grads["cpu"])
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-2 * top)
                for a, b in zip(grads["cuda"], grads["cpu"]))
    log(f"  attention_block_fused backward B={B} L={L} float32, card vs CPU: worst max abs "
        f"error / scale {worst:.3g} over x and the 8 weights (tol 2e-4)")
    if worst > 2e-4:
        raise AssertionError(f"attention_block_fused gradients differ: {worst}")


def phase_block_kernels():
    """Kernels 4 and 5 at the transfer's B = 16384 (L = 8, and L = 5, the
    bucketed width below it) and the eval's fixed vocab (gpt_neox0001's
    32769 tokens padded to 32896 rows, L = 8), plus a ragged batch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for B, L in ((16384, 8), (16384, 5), (32896, 8)):
            for with_bias in (False, True):
                timed = dtype == torch.bfloat16
                r4 = check_kernel4(B, L, dtype, with_bias, gen, timed,
                                   split=timed and L == 8 and not with_bias)
                r5 = check_kernel5(B, L, dtype, with_bias, gen, timed)
                if timed and (B, L) == (16384, 8):
                    # the path's block has a mask and no key bias; the tier-1
                    # core's row is the one with its key bias
                    if not with_bias:
                        results["attention_block"] = r4
                        log(f"  kernel 4 B=16384 L=8: {r4['ms']:.4f} ms single-call; before "
                            f"the GEMM's ring was shared with kernel 1's kernels: 1.482-1.561 "
                            f"ms (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md)")
                    else:
                        results["merged_attention"] = r5
            torch.cuda.empty_cache()
        for with_bias in (False, True):
            check_kernel4(1001, 7, dtype, with_bias, gen, timed=False)
            check_kernel5(1001, 7, dtype, with_bias, gen, timed=False)
        # widths off the GEMM's 256 tile; the core at 14 heads
        for H, h in ((640, 10), (896, 14)):
            check_kernel4(16384, 8, dtype, False, gen, timed=dtype == torch.bfloat16, H=H, h=h)
        check_kernel5(16384, 8, dtype, True, gen, timed=False, h=14)
        torch.cuda.empty_cache()
    check_block_backward(gen)
    return results


# -------------------------------------------------------------------- phase 11
PITA_LEVERS = dict(remat_hypernet=True, loss_chunk_size=32, remat_backbone=True)


def run_training_config(config, name):
    """The training CLI's ``main`` on a config written to WORK: (trainer,
    history, peak GiB, wall s), or None when it ran out of memory."""
    from zett_tpu_torch.training.__main__ import main as train_main

    path = os.path.join(WORK, f"{name}.json")
    with open(path, "w") as f:
        json.dump(config, f)
    shutil.rmtree(config["output_dir"], ignore_errors=True)
    gc_free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        trainer, history = train_main([path])
    except torch.cuda.OutOfMemoryError as exc:
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"    out of memory (peak {peak:.2f} GiB allocated): {str(exc).splitlines()[0][:160]}")
        return None
    torch.cuda.synchronize()
    return trainer, history, torch.cuda.max_memory_allocated() / 2**30, time.perf_counter() - t0


def train_peak(config, name):
    """``run_training_config``'s run as (peak GiB, median train-step device
    ms after the first, or None), or None when it ran out of memory."""
    got = run_training_config(config, name)
    if got is None:
        return None
    trainer, _, peak, _ = got
    ms = [r["device_ms"] for r in trainer.records if r["kind"] == "train"][1:]
    return peak, (float(np.median(ms)) if ms else None)


def gc_free():
    gc.collect()
    torch.cuda.empty_cache()


def phase_training_eval(model_dir):
    """python -m zett_tpu_torch.training at the prior + inter-token-attention
    config with phase 7's widths and text (every 8th paragraph held out as
    the validation set) at its own batch 128: first each memory lever alone
    (two train steps, peak memory or out of memory), then all three with
    eval at step 0 and at the last step."""
    import zett_tpu_torch.evaluation as evaluation
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.training import engine
    from zett_tpu_torch.training.__main__ import load_config_file
    from zett_tpu_torch.training.__main__ import main as train_main

    train_dir, valid_dir = os.path.join(WORK, "pita_train"), os.path.join(WORK, "pita_valid")
    out = os.path.join(WORK, "pita_out")
    shutil.rmtree(out, ignore_errors=True)  # metrics.jsonl is appended to
    n_train, n_valid = write_training_text(train_dir, valid_dir, hold_out_every=8)
    config = load_config_file(os.path.join(REPO, "configs", "zeroshot",
                                           "gpt2_en_priors_inter_token_attn.json"))
    tokenizers = [os.path.join(REPO, "artifacts", "tokenizers", t)
                  for t in ("gpt_neox0001", "en_raw")]
    steps = 4
    if config["batch_size"] != 128:
        raise AssertionError(f"the pita config's batch is {config['batch_size']}, not 128")
    reduced = dict(model_dir=model_dir, train_directory=train_dir, valid_directory=valid_dir,
                   output_dir=out, steps=steps, identity_steps=1, warmup_steps=[1, 2],
                   random_warmup_steps=0, logging_steps=1, save_steps=0, num_workers=0,
                   eval_steps=steps, eval_at_step_zero=True, extra_valid_tokenizers=tokenizers)
    config.update(reduced)
    log(f"  {n_train} training and {n_valid} held-out paragraphs; batch "
        f"{config['batch_size']}; overrides "
        f"{ {k: v for k, v in reduced.items() if k != 'extra_valid_tokenizers'} }, "
        f"extra_valid_tokenizers {[os.path.basename(t) for t in tokenizers]}")

    # each lever alone at batch 128: 2 train steps (the second timed), no eval
    peaks = {}
    for name, value in PITA_LEVERS.items():
        one = dict(config, steps=2, identity_steps=0, eval_steps=0, eval_at_step_zero=False,
                   valid_directory=None, extra_valid_tokenizers=[],
                   output_dir=os.path.join(WORK, f"pita_{name}"), **{name: value})
        t0 = time.perf_counter()
        got = train_peak(one, "gpt2_en_pita_" + name)
        peaks[name] = got
        shown = ("out of memory" if got is None else
                 f"peak {got[0]:.2f} GiB, train step {got[1]:.3f} ms (CUDA events)")
        log(f"  on {CARD}: batch 128 with {name}={value} alone: {shown}; "
            f"{time.perf_counter() - t0:.3f} s wall")
    gc_free()

    config.update(PITA_LEVERS)
    config_path = os.path.join(WORK, "gpt2_en_pita_smoke.json")
    with open(config_path, "w") as f:
        json.dump(config, f)
    evals = []  # (name, wall s, embedding passes, kernel 4 launches)
    passes = [0]
    orig_loop, orig_embed = evaluation.eval_loop, engine.Trainer.compute_embeddings

    def timed_loop(trainer, batches, name="eval", **kw):
        torch.cuda.synchronize()
        t0, p0 = time.perf_counter(), passes[0]
        k0 = _build.launch_counts["attention_block"]
        result = orig_loop(trainer, batches, name=name, **kw)
        torch.cuda.synchronize()
        evals.append((name, time.perf_counter() - t0, passes[0] - p0,
                      _build.launch_counts["attention_block"] - k0))
        return result

    def counted_embed(self, b):
        passes[0] += 1
        return orig_embed(self, b)

    evaluation.eval_loop, engine.Trainer.compute_embeddings = timed_loop, counted_embed
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        trainer, history = train_main([config_path])
    finally:
        evaluation.eval_loop, engine.Trainer.compute_embeddings = orig_loop, orig_embed
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    n_layers = config["num_hidden_layers"]
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    eval_rows = [r for r in rows if any(k.startswith("eval") for k in r)]
    train_rows = [r for r in rows if r not in eval_rows]
    losses = [r.get("loss", r.get("identity_loss")) for r in train_rows]
    train_ms = [r["device_ms"] for r in trainer.records if r["kind"] == "train"][1:]
    log(f"  batch 128 with {PITA_LEVERS}: trained {steps} steps in {wall:.3f} s wall (evals "
        f"included); logged losses {['%.4f' % x for x in losses]}")
    log(f"  on {CARD}: peak memory {peak_gb:.2f} GiB; train step "
        f"{float(np.median(train_ms)):.3f} ms (CUDA events, median of "
        f"{['%.3f' % x for x in train_ms]})")
    if len(train_rows) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bad training rows {train_rows}")
    names = [f"eval_{os.path.basename(t)}" for t in tokenizers] + ["eval"]
    # the step-0 row carries no "step" key (as in the JAX CLI)
    if [r.get("step", 0) for r in eval_rows] != [0, steps]:
        raise AssertionError(f"eval rows at steps {[r.get('step') for r in eval_rows]}")
    for r in eval_rows:
        for name in names:
            for metric in ("eval_loss", "eval_bpb"):
                v = r.get(f"{name}/{metric}")
                if v is None or not math.isfinite(v):
                    raise AssertionError(f"eval row {r.get('step', 0)}: {name}/{metric} = {v}")
        log(f"  eval at step {r.get('step', 0)}: " + ", ".join(
            f"{n} loss {r[n + '/eval_loss']:.4f} bpb {r[n + '/eval_bpb']:.4f}" for n in names))
    n_sampled = None
    for name, secs, n_pass, k4 in evals:
        log(f"  {name}: {secs:.3f} s wall, {n_pass} embedding passes, kernel 4 launches {k4}")
        if name == "eval":
            n_sampled = n_pass
        elif n_pass != 1:
            raise AssertionError(f"{name}: {n_pass} embedding passes, expected 1 (cached)")
        if k4 != n_pass * n_layers:
            raise AssertionError(f"{name}: kernel 4 launched {k4} times for {n_pass} passes")
    n_evals = len(eval_rows)
    n_ident = config["identity_steps"]
    expected = dict.fromkeys(_build.launch_counts, 0)
    # remat_hypernet runs a train step's hypernet forward twice (the
    # identity step's once)
    expected["attention_core"] = (n_ident + 2 * (steps - n_ident)) * n_layers
    expected["attention_core_bwd"] = steps * n_layers
    expected["attention_block"] = n_evals * (len(tokenizers) + n_sampled) * n_layers
    log(f"  launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    per_tok = {name: [secs for n, secs, _, _ in evals if n == name] for name in names[:-1]}
    log(f"  on {CARD}: eval wall per fixed tokenizer (s, step 0 then step {steps}): "
        + ", ".join(f"{n} {['%.3f' % t for t in ts]}" for n, ts in per_tok.items()))
    if peak_gb > 80:
        raise AssertionError(f"peak {peak_gb:.2f} GiB")
    return launches, wall, peak_gb, peaks


# -------------------------------------------------------------------- phase 12
NEOX = os.path.join(REPO, "artifacts", "tokenizers", "gpt_neox0001")
N_PRETOKENS = 1 << 20
# kernel 6's shapes (B, L, K): timed, and with exact ties, ragged B
K6_TIMED = ((65536, 48, 16), (65536, 8, 8), (65536, 24, 7), (N_PRETOKENS, 48, 16))
K6_TIES = ((4099, 48, 16), (4099, 8, 8), (333, 20, 13), (65, 64, 32), (7, 5, 1), (100, 100, 100))


def neox_vocab(drop_bytes=()):
    """gpt_neox0001's pieces in its byte domain (specials as b""), as the
    prior CLI builds them, and its scores; the single-byte pieces of
    ``drop_bytes`` are left out (b""), so those bytes take the unk path."""
    from zett_tpu_torch.tokenization import Tokenizer
    from zett_tpu_torch.tokenization.bytemaps import CHARS_TO_BYTES

    tok = Tokenizer.from_file(os.path.join(NEOX, "tokenizer.json"))
    special = set(tok.all_special_tokens)
    scores = tok.model.get_scores()
    pieces = []
    for i in range(len(scores)):
        t = tok.id_to_token(i) or ""
        p = b"" if t in special or not t else bytes(CHARS_TO_BYTES[c] for c in t)
        pieces.append(b"" if len(p) == 1 and p[0] in drop_bytes else p)
    return tok, pieces, scores


def synthetic_pretokens(pieces, n, rng):
    """n unique pretokens with Zipf weights max(1, 6e7 // rank): each is 1-4
    random vocab pieces, 80% with a leading space; 2% carry 1-3 random bytes;
    1% are four pieces of >= 13 bytes, cut at 64 bytes (over 48: the overlong
    tail), the rest cut at 48."""
    usable = [p for p in pieces if p]
    long_pool = np.flatnonzero(np.array([len(p) for p in usable]) >= 13)
    out = {}
    while len(out) < n:
        m = 2 * (n - len(out)) + 1024
        n_p = rng.integers(1, 5, size=m)
        ids = rng.integers(0, len(usable), size=(m, 4))
        is_long = rng.random(m) < 0.01
        ids[is_long] = long_pool[rng.integers(0, len(long_pool), size=(int(is_long.sum()), 4))]
        n_p[is_long] = 4
        space = rng.random(m) < 0.8
        noisy = rng.random(m) < 0.02
        noise_len = rng.integers(1, 4, size=m)
        noise_pos = rng.random(m)
        for i in range(m):
            p = b"".join(usable[t] for t in ids[i, :n_p[i]])
            if space[i]:
                p = b" " + p
            if noisy[i]:
                at = int(noise_pos[i] * (len(p) + 1))
                p = p[:at] + rng.bytes(int(noise_len[i])) + p[at:]
            out.setdefault(p[:64] if is_long[i] else p[:48], None)
            if len(out) == n:
                break
    weights = np.maximum(1, 60_000_000 // np.arange(1, n + 1, dtype=np.int64))
    return dict(zip(out, weights.tolist()))


def native_counts(native, pretoken_counts, n_pieces):
    """The oracle: every pretoken encoded whole by the native C++ Viterbi,
    ids counted with their pretoken's weight."""
    keys = list(pretoken_counts)
    flat, n_ids = native.encode_flat(keys)
    w = np.repeat(np.fromiter(pretoken_counts.values(), dtype=np.int64, count=len(keys)), n_ids)
    real = flat >= 0
    # float64 weights are exact here: the total stays far below 2^53
    return np.bincount(flat[real], weights=w[real], minlength=n_pieces).astype(np.int64)


def dp_inputs(B, L, K, gen, ties=False):
    """Random span scores on the card: 60% of spans absent (NEG), single-byte
    spans always present, every 97th row all NEG; with ``ties`` the scores
    take four values, so candidates tie exactly."""
    from zett_tpu_torch.ops.viterbi_dp import NEG

    if ties:
        vals = torch.randint(-4, 0, (B, L, K), generator=gen, device="cuda").float()
    else:
        vals = torch.randn(B, L, K, generator=gen, device="cuda") - 2
    S = torch.where(torch.rand(B, L, K, generator=gen, device="cuda") < 0.4, vals, NEG)
    S[:, :, 0] = vals[:, :, 0] - 3
    S[::97] = NEG
    del vals
    I = torch.randint(0, 32769, (B, L, K), generator=gen, device="cuda", dtype=torch.int32)
    return S, I


def check_kernel6(S, I, tag, timed):
    """Kernel 6 against its plain version: dp, bk and bi bit-equal."""
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.ops.viterbi_dp import viterbi_dp, viterbi_dp_plain

    before = _build.launch_counts["viterbi_dp"]
    got = viterbi_dp(S, I)
    torch.cuda.synchronize()
    if _build.launch_counts["viterbi_dp"] != before + 1:
        raise AssertionError("viterbi_dp did not count its launch")
    ref = viterbi_dp_plain(S, I)
    for name, g, r in zip(("dp", "bk", "bi"), got, ref):
        if not torch.equal(g, r):
            raise AssertionError(f"kernel 6 {tag}: {name} differs from the plain version at "
                                 f"{int((g != r).sum())} entries")
    err = float((got[0] - ref[0]).abs().max())
    del got, ref
    if not timed:
        log(f"  kernel 6 {tag}: dp, bk, bi bit-equal to the plain version")
        return None
    B, L, K = S.shape
    ms = median_ms(lambda: viterbi_dp(S, I))
    b2b = burst_ms(lambda: viterbi_dp(S, I))
    plain_ms = median_ms(lambda: viterbi_dp_plain(S, I), reps=5, warmup=0)
    nbytes = B * L * K * 8 + B * (L + K) * 12  # S + I read, dp/bk/bi written
    bound_ms, bound_by = bound(B * L * K, nbytes, torch.float32)
    log(f"  kernel 6 {tag}: bit-equal; {ms:.4f} ms (back to back {b2b:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), library none")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def span_lookups(lens, K):
    """The spans inside the pretokens (start j, length k <= K, j + k <=
    len): the fused kernel's table lookups."""
    n = lens.long()
    part = torch.clamp(n, max=K)
    return int((torch.clamp(n - K, min=0) * K + part * (part + 1) // 2).sum())


def check_fused(r, ln, table, unk, K, tag, timed):
    """The span scores fused into kernel 6 against their plain composition
    (compute_span_scores, then kernel 6's plain DP) on the card: dp, bk and
    bi bit-equal. With ``timed``, the times beside the bound (rows, lens,
    dp/bk/bi and the table, each once) and the lookups L2 serves."""
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.ops.device_viterbi import viterbi_spans_dp, viterbi_spans_dp_plain

    tab, salt = torch.from_numpy(table.table).cuda(), table.salt
    before = _build.launch_counts["viterbi_spans_dp"]
    got = viterbi_spans_dp(r, ln, tab, salt, unk, K)
    torch.cuda.synchronize()
    if _build.launch_counts["viterbi_spans_dp"] != before + 1:
        raise AssertionError("viterbi_spans_dp did not count its launch")
    ref = viterbi_spans_dp_plain(r, ln, tab, salt, unk, K)
    for name, g, w in zip(("dp", "bk", "bi"), got, ref):
        if not torch.equal(g, w):
            raise AssertionError(f"fused spans + DP {tag}: {name} differs from the plain "
                                 f"composition at {int((g != w).sum())} entries")
    n_unk = int((got[2] == -2).sum())
    err = float((got[0] - ref[0]).abs().max())
    del got, ref
    B, L = r.shape
    lookups = span_lookups(ln, K)
    if not timed:
        log(f"  fused spans + DP {tag}: dp, bk, bi bit-equal to the plain composition "
            f"({n_unk} unk-byte backpointers)")
        return None
    ms = median_ms(lambda: viterbi_spans_dp(r, ln, tab, salt, unk, K))
    b2b = burst_ms(lambda: viterbi_spans_dp(r, ln, tab, salt, unk, K))
    plain_ms = median_ms(lambda: viterbi_spans_dp_plain(r, ln, tab, salt, unk, K), reps=3,
                         warmup=0)
    nbytes = B * L * 4 + B * 4 + B * (L + K) * 12 + tab.numel() * 4
    bound_ms, bound_by = bound(lookups, nbytes, torch.float32)
    log(f"  fused spans + DP {tag}: bit-equal ({n_unk} unk-byte backpointers); {ms:.4f} ms "
        f"(back to back {b2b:.4f} ms), plain (spans, then the plain DP) {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes / 1e9:.4f} GB), {lookups} lookups inside the pretokens "
        f"(32 or 64 bytes of table each, at most {lookups * 64 / 1e9:.4f} GB, from L2; "
        f"{B * L * K} spans in the (B, L, K) grid), library none")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def write_repo_text(path):
    """The repo's Markdown and Python files, one paragraph per line."""
    paragraphs = []
    for d, dirs, files in os.walk(REPO):
        dirs[:] = sorted(x for x in dirs
                         if not x.startswith(".") and x not in ("build", "__pycache__"))
        for name in sorted(files):
            if name.endswith((".md", ".py")):
                with open(os.path.join(d, name), errors="replace") as f:
                    for block in f.read().split("\n\n"):
                        line = " ".join(p.strip() for p in block.splitlines() if p.strip())
                        if line:
                            paragraphs.append(line)
    with open(path, "w") as f:
        f.write("\n".join(paragraphs) + "\n")
    return len(paragraphs), sum(map(len, paragraphs))


def phase_prior_pipeline():
    """Kernel 6 against its plain version, the span scores card vs CPU, the
    fused span scores + DP against their plain composition,
    count_tokens_device and DeviceRetokenizer on 2^20 synthetic unique
    pretokens against the native C++ Viterbi, and compute_prior's CLI on its
    default device. Returns (kernel 6's row, the fused kernel's row, the
    fused kernel's launches on the main paths)."""
    import zett_tpu_torch.ops.device_viterbi as dv
    import zett_tpu_torch.tokenization.priors as priors
    from zett_tpu_torch.csrc import host_lib
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.ops.viterbi_dp import viterbi_dp
    from zett_tpu_torch.tokenization.compute_prior import main as prior_main

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # 12.1: the kernel at its shapes, K = 7, ties, all-NEG rows, ragged B
    for B, L, K in K6_TIMED:
        check_kernel6(*dp_inputs(B, L, K, gen), f"B={B} L={L} K={K}", timed=True)
        torch.cuda.empty_cache()
    for B, L, K in K6_TIES:
        check_kernel6(*dp_inputs(B, L, K, gen, ties=True), f"B={B} L={L} K={K} ties",
                      timed=False)

    tok, pieces, scores = neox_vocab()
    pretoken_counts, made_s = PREPARED.pop("pretokens")
    keys = list(pretoken_counts)
    lengths = np.fromiter(map(len, keys), dtype=np.int64, count=len(keys))
    log(f"  {len(keys)} synthetic unique pretokens ({int(lengths.sum())} bytes, "
        f"{(lengths > 48).mean():.4f} over 48 bytes, longest {lengths.max()}) with "
        f"{sum(pretoken_counts.values())} occurrences, made in {made_s:.2f} s while the "
        f"kernels built")

    # 12.2: span scores card vs CPU, with unk bytes (0xF5..0xFF have no
    # single-byte piece here), bytes >= 0x80, lens 0 and lens = L
    _, unk_pieces, _ = neox_vocab(drop_bytes=range(0xF5, 0x100))
    table = dv.build_vocab_table(unk_pieces, scores)
    rng = np.random.default_rng(SEED)
    rows_pt = keys[:4088] + [b"", b"\xff" * 48, rng.bytes(48), bytes(range(0x80, 0xB0)),
                             bytes(range(0xD0, 0x100)), b" " + rng.bytes(47), rng.bytes(7),
                             b"\xf5\xf6 the\xfe"]
    rows, lens = dv.pack_pretokens(rows_pt, 48)
    unk = min(scores) - 10.0
    K = min(16, table.max_piece_len)
    S_c, I_c = dv.compute_span_scores(*(torch.from_numpy(a).cuda() for a in (rows, lens)),
                                      torch.from_numpy(table.table).cuda(), table.salt, unk, K)
    S_h, I_h = dv.compute_span_scores(torch.from_numpy(rows), torch.from_numpy(lens),
                                      torch.from_numpy(table.table), table.salt, unk, K)
    n_unk = int((I_h == -2).sum())
    if not (torch.equal(S_c.cpu(), S_h) and torch.equal(I_c.cpu(), I_h)) or n_unk == 0:
        raise AssertionError(f"span scores card vs CPU differ (unk spans {n_unk})")
    log(f"  span scores on {len(rows_pt)} rows: card equal to CPU (S and I), {n_unk} unk spans")
    check_fused(torch.from_numpy(rows).cuda(), torch.from_numpy(lens).cuda(), table, unk, K,
                f"{len(rows_pt)} rows of 12.2 (unk bytes, empty and full rows)", timed=False)

    # 12.3: count_tokens_device against the native oracle
    native = host_lib.NativeUnigram(pieces, scores, unk_id=-1)
    t0 = time.perf_counter()
    oracle = native_counts(native, pretoken_counts, len(pieces))
    oracle_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    counts = dv.count_tokens_device(pieces, scores, pretoken_counts, max_pretoken_len=48)
    torch.cuda.synchronize()
    count_wall = time.perf_counter() - t0
    launches = _build.launch_counts["viterbi_spans_dp"]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if not np.array_equal(counts, oracle):
        bad = np.flatnonzero(counts != oracle)
        raise AssertionError(f"count_tokens_device differs from the native oracle at {len(bad)} "
                             f"pieces, e.g. {bad[:5].tolist()}")
    log(f"  count_tokens_device (max_pretoken_len 48): equal to the native oracle on all "
        f"{len(pieces)} pieces ({int(counts.sum())} tokens); {count_wall:.3f} s wall, peak "
        f"{peak_gb:.2f} GiB, {launches} fused kernel launch(es); native oracle {oracle_s:.3f} s")

    # device time by stage, on the same rows (the device part of that run)
    short = {k: w for k, w in pretoken_counts.items() if len(k) <= 48}
    rows, lens = dv.pack_pretokens(list(short), 48)
    r, ln = torch.from_numpy(rows).cuda(), torch.from_numpy(lens).cuda()
    w = torch.from_numpy(np.fromiter(short.values(), dtype=np.int64, count=len(short))).cuda()
    vocab_table = dv.build_vocab_table(pieces, scores)
    tab, salt = torch.from_numpy(vocab_table.table).cuda(), vocab_table.salt
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    events[0].record()
    S, I = dv.compute_span_scores(r, ln, tab, salt, unk, 16)
    events[1].record()
    viterbi_dp(S, I)
    events[2].record()
    dp, bk, bi = dv.viterbi_spans_dp(r, ln, tab, salt, unk, 16)
    events[3].record()
    dv.count_token_usage(bk[:, :49], bi[:, :49], ln, len(pieces), weights=w)
    events[4].record()
    torch.cuda.synchronize()
    stages = [events[i].elapsed_time(events[i + 1]) for i in range(4)]
    log(f"  device ms by stage at B={len(short)} L=48 K=16: unfused spans {stages[0]:.3f} + "
        f"kernel 6 {stages[1]:.3f} = spans + DP {stages[0] + stages[1]:.3f}; fused spans + DP "
        f"{stages[2]:.3f}; backtrack-count {stages[3]:.3f}")
    del dp, bk, bi

    # the fused kernel against its plain composition: gpt_neox0001's vocab,
    # and one of exact ties (scores rounded to integers) and unk bytes
    # (0xF5..0xFF without a single-byte piece), at B = 65536 and on all rows
    tie_table = dv.build_vocab_table(unk_pieces, np.round(scores).tolist())
    tie_unk = float(np.round(scores).min()) - 10.0
    n_head = 65536
    check_fused(r[:n_head], ln[:n_head], vocab_table, unk, 16, f"B={n_head} L=48 K=16",
                timed=True)
    check_fused(r[:n_head], ln[:n_head], tie_table, tie_unk, 16,
                f"B={n_head} L=48 K=16, ties and unk bytes", timed=False)
    check_fused(r, ln, tie_table, tie_unk, 16, f"B={len(short)} L=48 K=16, ties and unk bytes",
                timed=False)
    fused_row = check_fused(r, ln, vocab_table, unk, 16, f"B={len(short)} L=48 K=16",
                            timed=True)
    torch.cuda.empty_cache()
    row = check_kernel6(S, I, f"B={len(short)} L=48 K=16 (gpt_neox0001 span scores)",
                        timed=True)
    del S, I
    torch.cuda.empty_cache()

    # 12.4: DeviceRetokenizer against the native segmentation of every row
    flat, n_ids = native.encode_flat(keys)
    flat = np.where(flat >= 0, flat, -2)  # the DP marks unk bytes -2, native -1
    nat_segs = [s.tolist() for s in np.split(flat, np.cumsum(n_ids)[:-1])]
    retok = dv.DeviceRetokenizer(pieces, scores, max_pretoken_len=64)
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    segs = retok.encode(keys)
    torch.cuda.synchronize()
    enc_wall = time.perf_counter() - t0
    enc_launches = _build.launch_counts["viterbi_spans_dp"]
    launches += enc_launches
    differ = [i for i, (a, b) in enumerate(zip(segs, nat_segs)) if a != b]
    # The f32 DP and the f64 native encoder may break an exact tie (two
    # orders of the same pieces, ROADMAP C) apart; any other difference fails,
    # and on tie rows the card must give the CPU's (the JAX DP's) answer.
    not_ties = [i for i in differ if sorted(segs[i]) != sorted(nat_segs[i])]
    if not_ties:
        i = not_ties[0]
        raise AssertionError(f"DeviceRetokenizer differs from native on {len(not_ties)} rows "
                             f"beyond exact ties, e.g. {keys[i]!r}: {segs[i]} vs {nat_segs[i]}")
    cpu_retok = dv.DeviceRetokenizer(pieces, scores, max_pretoken_len=64, device="cpu")
    if cpu_retok.encode([keys[i] for i in differ]) != [segs[i] for i in differ]:
        raise AssertionError("DeviceRetokenizer card and CPU disagree on the tie rows")
    log(f"  DeviceRetokenizer(max_pretoken_len=64).encode: {len(keys)} rows in {enc_wall:.3f} s "
        f"wall ({lengths.sum() / enc_wall / 1e6:.3f} MB/s of unique bytes), {enc_launches} "
        f"fused kernel launches; native segmentation on {len(keys) - len(differ)} rows, an exact "
        f"tie ordered otherwise (same pieces, card = CPU) on {len(differ)}")
    for i in differ[:3]:
        log(f"    tie {keys[i]!r}: DP {segs[i]}, native {nat_segs[i]}")
    _build.reset_launch_counts()
    if retok.encode(keys[::-1]) != segs[::-1] or any(_build.launch_counts.values()):
        raise AssertionError("a second encode reached the device (the memo missed)")
    del segs, nat_segs, retok

    # 12.5: the CLI on its default device
    text = os.path.join(WORK, "prior_text.txt")
    os.makedirs(WORK, exist_ok=True)
    n_par, n_chars = write_repo_text(text)
    out = os.path.join(WORK, "priors_neox.npy")
    timed = {}
    orig_split, orig_count = priors.get_pretoken_counts, dv.count_tokens_device

    def timed_split(*a, **kw):
        t = time.perf_counter()
        timed["pretoken_counts"] = orig_split(*a, **kw)
        timed["split_s"] = time.perf_counter() - t
        return timed["pretoken_counts"]

    def timed_count(*a, **kw):
        t = time.perf_counter()
        result = orig_count(*a, **kw)
        torch.cuda.synchronize()
        timed["count_s"] = time.perf_counter() - t
        return result

    priors.get_pretoken_counts, dv.count_tokens_device = timed_split, timed_count
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        prior_main(["--tokenizer", NEOX, "--data", text, "--device", "--output", out])
    finally:
        priors.get_pretoken_counts, dv.count_tokens_device = orig_split, orig_count
    torch.cuda.synchronize()
    cli_wall = time.perf_counter() - t0
    cli_launches = _build.launch_counts["viterbi_spans_dp"]
    launches += cli_launches
    written = np.load(out, allow_pickle=True).item()
    prior = native_counts(native, timed["pretoken_counts"], len(pieces)).astype(np.float64) + 1.0
    prior /= prior.sum()
    prior = np.log(prior)
    prior[np.asarray(tok.all_special_ids)] = 0.0
    sub = written["substring"]
    if not np.array_equal(written["token"], prior):
        raise AssertionError("the CLI's token prior differs from the native oracle's")
    if (sub.shape != (len(tok),) or not np.isfinite(sub).all()
            or np.any(sub[tok.all_special_ids] != 0)):
        raise AssertionError("the CLI's substring prior is not finite with specials at 0")
    if cli_launches == 0:
        raise AssertionError("the prior CLI did not launch the fused kernel")
    log(f"  compute_prior --device on {n_par} paragraphs ({n_chars} characters, "
        f"{len(timed['pretoken_counts'])} unique pretokens): token prior equal to the native "
        f"oracle's, substring prior finite; {cli_wall:.3f} s wall, host pretokenize "
        f"{timed['split_s']:.3f} s, device count {timed['count_s']:.3f} s, {cli_launches} "
        f"fused kernel launch(es)")
    return row, fused_row, launches


# -------------------------------------------------------------------- phase 13
# (a) and (b) run at this LM batch, where the plain step fits as well as the
# levered one; (d) at the config's own 128
LEVER_BATCH = 32
LEVER_LOSS_TOL, LEVER_GRAD_TOL = 2e-3, 5e-2  # bf16: the chunked loss, see phase 13
PREFETCH_WORKERS = 4


def lever_config(model_dir, train_dir, name, **overrides):
    """configs/zeroshot/gpt2_en.json cut as phase 7 cuts it, with
    ``overrides``, written to a file of its own; returns its path."""
    from zett_tpu_torch.training.__main__ import load_config_file

    config = load_config_file(os.path.join(REPO, "configs", "zeroshot", "gpt2_en.json"))
    for key in ("valid_directory", "extra_valid_tokenizers"):
        config.pop(key)
    out = os.path.join(WORK, "levers", name)
    shutil.rmtree(out, ignore_errors=True)
    # final/ without the optimizer state: no run here resumes from it, and
    # it keeps the run's disk writes small (a preemption saves the full
    # state regardless)
    config.update(model_dir=model_dir, train_directory=train_dir, output_dir=out,
                  warmup_steps=[2, 4], random_warmup_steps=0, logging_steps=1, save_steps=0,
                  save_state=False, num_workers=0, eval_at_step_zero=False)
    config.update(overrides)
    path = os.path.join(WORK, "levers", f"{name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def grad_gap(got, ref):
    """The largest |difference| over the steps and hypernet leaves, each
    over its leaf's largest |gradient| (at least 1% of the model's largest:
    the key biases' exact gradient is 0)."""
    worst = 0.0
    for g_step, r_step in zip(got, ref):
        floor = 1e-2 * max(float(g.abs().max()) for g in r_step.values())
        for path, r in r_step.items():
            d = float((g_step[path].float() - r.float()).abs().max())
            worst = max(worst, d / max(float(r.abs().max()), floor))
    return worst


def loss_gap(got, ref):
    return max(abs(a - b) / abs(b) for a, b in zip(got, ref))


def phase_trainer_levers(model_dir):
    """The trainer's levers through ``zett_tpu_torch.training``'s CLI at
    configs/zeroshot/gpt2_en.json's widths on phase 7's text: (a) remat and
    the chunked loss against the plain run with dropout on, (b) preemption
    by SIGTERM and resume, (c) Adafactor, (d) the prefetcher with and
    without DataLoader workers. Returns the kernel launches of its runs."""
    import multiprocessing

    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.training import engine
    from zett_tpu_torch.training.__main__ import main as train_main

    t_phase = time.perf_counter()
    train_dir = os.path.join(WORK, "train_text")
    write_training_text(train_dir)
    launches = dict.fromkeys(_build.launch_counts, 0)
    n_layers = GPT2_EN["num_hidden_layers"]

    def run(path):
        """The CLI on ``path``: (trainer, history, this run's launches)."""
        gc_free()
        _build.reset_launch_counts()
        trainer, history = train_main([path])
        torch.cuda.synchronize()
        counted = dict(_build.launch_counts)
        for k, v in counted.items():
            launches[k] += v
        return trainer, history, counted

    # (a) each lever against the plain run, dropout on (kernels 2 and 3 at
    # rate 0.1), 2 steps (cut from 3 for phase 18); the plain run twice for
    # the card's own gap
    steps = 2
    common = dict(batch_size=LEVER_BATCH, steps=steps, identity_steps=0,
                  run_backbone_in_training_mode=True)
    variants = {"plain": {}, "plain again": {}, "remat_hypernet": dict(remat_hypernet=True),
                "remat_backbone": dict(remat_backbone=True), "chunked": dict(loss_chunk_size=32),
                "all three": dict(PITA_LEVERS)}
    captured = []
    orig_apply = engine.Trainer._apply_gradients

    def capture(self, loss):
        orig_apply(self, loss)
        captured.append({p: g.detach().clone() for p, g in self.last_grads.items()
                         if p[0] == "hypernet" and g is not None})

    results = {}
    engine.Trainer._apply_gradients = capture
    try:
        for name, lever in variants.items():
            captured.clear()
            trainer, history, counted = run(lever_config(model_dir, train_dir, f"a_{name}",
                                                         **common, **lever))
            losses = [h["loss"] for h in history]
            results[name] = (losses, list(captured))
            core = steps * n_layers * (2 if lever.get("remat_hypernet") else 1)
            log(f"  (a) {name}: losses {['%.6f' % x for x in losses]}, kernel 2 launches "
                f"{counted['attention_core']} (expected {core}), kernel 3 "
                f"{counted['attention_core_bwd']}")
            if (counted["attention_core"], counted["attention_core_bwd"]) != \
                    (core, steps * n_layers):
                raise AssertionError(f"(a) {name}: launches {counted}")
            if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
                raise AssertionError(f"(a) {name}: history {history}")
            del trainer
    finally:
        engine.Trainer._apply_gradients = orig_apply
    ref = results["plain"]
    gap_loss = loss_gap(results["plain again"][0], ref[0])
    gap_grad = grad_gap(results["plain again"][1], ref[1])
    log(f"  (a) on {CARD}: the plain run against itself: loss {gap_loss:.3e}, hypernet "
        f"gradients {gap_grad:.3e} (relative)")
    for name in ("remat_hypernet", "remat_backbone", "chunked", "all three"):
        dl, dg = loss_gap(results[name][0], ref[0]), grad_gap(results[name][1], ref[1])
        # remat recomputes the same operations: within twice the card's
        # own gap (bitwise where the plain run repeats bitwise); the chunked
        # loss also rounds its bf16 logits chunk by chunk
        chunked = "remat" not in name
        tol_l = max(2 * gap_loss, LEVER_LOSS_TOL if chunked else 0.0)
        tol_g = max(2 * gap_grad, LEVER_GRAD_TOL if chunked else 0.0)
        log(f"  (a) {name} against plain over {steps} steps: largest loss difference "
            f"{dl:.3e} (limit {tol_l:.3e}), largest hypernet gradient difference {dg:.3e} "
            f"(limit {tol_g:.3e}), relative")
        if dl > tol_l or dg > tol_g:
            raise AssertionError(f"(a) {name} differs from the plain run")
    results.clear()

    # (b) preemption by SIGTERM at step 2 and resume through the CLI
    common = dict(batch_size=LEVER_BATCH, steps=4, identity_steps=1,
                  run_backbone_in_training_mode=True)
    _, hist_a, _ = run(lever_config(model_dir, train_dir, "b_uninterrupted", **common))
    _, hist_a2, _ = run(lever_config(model_dir, train_dir, "b_uninterrupted_again", **common))
    orig_fit = engine.Trainer.fit

    def fit_killed_at_2(self, *args, on_log=None, **kw):
        def kill(step, metrics):
            on_log(step, metrics)
            if step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
        return orig_fit(self, *args, on_log=kill, **kw)

    engine.Trainer.fit = fit_killed_at_2
    try:
        path_b = lever_config(model_dir, train_dir, "b_preempted", preempt_signal="SIGTERM",
                              **common)
        _, hist_b, _ = run(path_b)
    finally:
        engine.Trainer.fit = orig_fit
    out_b = os.path.join(WORK, "levers", "b_preempted")
    ckpt = os.path.join(out_b, "preempt_step_2")
    if hist_b[-1] != {"step": 2, "preempted": 1.0} or not os.path.isdir(
            os.path.join(ckpt, "resume")) or os.path.exists(os.path.join(out_b, "final")):
        raise AssertionError(f"(b) the preempted run: history {hist_b[-2:]}, "
                             f"{sorted(os.listdir(out_b))}")
    if signal.getsignal(signal.SIGTERM) != signal.SIG_DFL:
        raise AssertionError("(b) SIGTERM's handler was not restored")
    t0 = time.perf_counter()
    trainer, hist_c, _ = run(lever_config(model_dir, train_dir, "b_resumed",
                                          resume_from_checkpoint=ckpt, **common))
    resume_wall = time.perf_counter() - t0
    loss_a = {h["step"]: h.get("loss", h.get("identity_loss")) for h in hist_a}
    loss_a2 = {h["step"]: h.get("loss", h.get("identity_loss")) for h in hist_a2}
    loss_c = {h["step"]: h["loss"] for h in hist_c}
    gap = max(abs(loss_a2[s] - loss_a[s]) for s in (3, 4))
    diff = max(abs(loss_c[s] - loss_a[s]) for s in (3, 4)) if sorted(loss_c) == [3, 4] else None
    log(f"  (b) uninterrupted losses {[loss_a[s] for s in sorted(loss_a)]}; again "
        f"{[loss_a2[s] for s in sorted(loss_a2)]}; preempted at step 2 into "
        f"preempt_step_2; resumed steps {sorted(loss_c)}: {[loss_c[s] for s in sorted(loss_c)]}")
    log(f"  (b) on {CARD}: steps 3-4, resumed against uninterrupted: largest |difference| "
        f"{diff}; two uninterrupted runs: {gap} (bit-identical: "
        f"{diff == 0.0}); the resumed run {resume_wall:.3f} s wall, step {trainer.state.step}")
    if diff is None or diff > 2 * gap or trainer.state.step != 4:
        raise AssertionError("(b) the resumed run does not continue the uninterrupted one")
    del trainer

    # (c) Adafactor on a repeated batch
    trainer, hist, _ = run(lever_config(model_dir, train_dir, "c_adafactor",
                                        batch_size=LEVER_BATCH, steps=1, identity_steps=0,
                                        use_adafactor=True, learning_rate=1e-2,
                                        warmup_steps=0, weight_decay=0.0))
    losses = [hist[0]["loss"]]
    for _ in range(4):
        losses.append(trainer.train_step(trainer.last_train_batch)["loss"])
    n_factored = len(trainer.optimizer.state["v_row"])
    log(f"  (c) Adafactor (learning rate 1e-2, no weight decay) on one batch: losses "
        f"{['%.5f' % x for x in losses]}; {n_factored} factored second moments")
    if not all(math.isfinite(x) for x in losses) or \
            not all(b < a for a, b in zip(losses, losses[1:])) or n_factored == 0:
        raise AssertionError(f"(c) Adafactor losses {losses}")
    del trainer

    # (d) the prefetcher and DataLoader workers at the config's batch 128
    for depth, workers in ((0, 0), (2, 0), (0, PREFETCH_WORKERS), (2, PREFETCH_WORKERS)):
        t0 = time.perf_counter()
        trainer, hist, _ = run(lever_config(model_dir, train_dir, f"d_{depth}_{workers}",
                                            steps=4, identity_steps=1,
                                            prefetch_batches=depth, num_workers=workers))
        wall = time.perf_counter() - t0
        recs = [r for r in trainer.records if r["kind"] == "train"][1:]
        losses = [h["loss"] for h in hist if "loss" in h]
        if len(recs) < 2 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"(d) prefetch {depth}, workers {workers}: {hist}")
        loop = float(np.mean([r["loop_ms"] for r in recs]))

        def med(key):
            return float(np.median([r[key] for r in recs]))

        # the step's device work from a trace of one step on the run's last
        # batch, alone (after the run, outside the counted launches): a
        # step's CUDA-event span also holds the time its launching thread
        # waits for the interpreter lock while the prefetch thread collates
        batch = trainer.last_train_batch
        trainer.train_step(batch)
        busy, _, _ = device_breakdown(lambda: trainer.train_step(batch), top=0)
        traced = ("not measured" if busy is None else
                  f"{1 - busy / loop:.3f} (1 - traced device busy of one step, {busy:.3f} ms, "
                  f"/ loop wall)")
        log(f"  (d) on {CARD}: prefetch_batches {depth}, num_workers {workers}: loop "
            f"{loop:.3f} ms a train step (mean of {len(recs)} after the first), loop idle "
            f"share {traced}; "
            f"step CUDA-event span median {med('device_ms'):.3f}, mean "
            f"{float(np.mean([r['device_ms'] for r in recs])):.3f} ms; medians: collate "
            f"{med('collate_ms'):.3f}, wait {med('wait_ms'):.3f}, step host "
            f"{med('host_ms'):.3f} ms; {wall:.3f} s wall")
        del trainer, batch
        gc_free()
        if multiprocessing.active_children():
            raise AssertionError(f"(d) worker processes left: {multiprocessing.active_children()}")

    # (e) the in-training eval with the chunked loss: kernel 1 on gpt2_en's
    # inference route, the CLM loss from the final hidden states chunk by
    # chunk
    train_e, valid_e = os.path.join(WORK, "levers_train"), os.path.join(WORK, "levers_valid")
    write_training_text(train_e, valid_e, hold_out_every=8)
    steps = 2
    passes, first_eval, routes = [0], [], {"chunked": 0, "logits": 0}
    orig_embed, orig_cached = engine.Trainer.compute_embeddings, engine.Trainer.eval_step_cached
    orig_chunked, orig_logits = engine.chunked_clm_eval, engine.Trainer._logits

    def counted_embed(self, b):
        passes[0] += 1
        return orig_embed(self, b)

    def kept_cached(self, b, *embeddings):
        if not first_eval:
            first_eval.append((b, *embeddings))
        return orig_cached(self, b, *embeddings)

    def counted_chunked(*args, **kw):
        routes["chunked"] += 1
        return orig_chunked(*args, **kw)

    def counted_logits(self, *args):
        routes["logits"] += 1
        return orig_logits(self, *args)

    (engine.Trainer.compute_embeddings, engine.Trainer.eval_step_cached, engine.chunked_clm_eval,
     engine.Trainer._logits) = counted_embed, kept_cached, counted_chunked, counted_logits
    try:
        trainer, _, counted = run(lever_config(
            model_dir, train_e, "e_chunked_eval", valid_directory=valid_e, steps=steps,
            identity_steps=0, eval_steps=steps, eval_at_step_zero=True, loss_chunk_size=32))
    finally:
        (engine.Trainer.compute_embeddings, engine.Trainer.eval_step_cached,
         engine.chunked_clm_eval, engine.Trainer._logits) = \
            orig_embed, orig_cached, orig_chunked, orig_logits
    # the step-0 row goes to metrics.jsonl only, and carries no "step" key
    rows = [json.loads(line) for line in
            open(os.path.join(WORK, "levers", "e_chunked_eval", "metrics.jsonl"))]
    evals = [(r.get("step", 0), r["eval/eval_loss"], r["eval/eval_bpb"])
             for r in rows if "eval/eval_loss" in r]
    expected = dict.fromkeys(counted, 0)
    expected["encoder_layer"] = passes[0] * (n_layers - 1)
    expected["attention_core"] = steps * n_layers + passes[0]
    expected["attention_core_bwd"] = steps * n_layers
    log(f"  (e) in-training evals with loss_chunk_size 32 (step, loss, bpb): {evals}; "
        f"{passes[0]} embedding passes, {routes['chunked']} chunked evals, "
        f"{routes['logits']} whole-logits builds; launches {counted} (expected {expected})")
    if counted != expected or routes["logits"] or not routes["chunked"] or \
            [e[0] for e in evals] != [0, steps] or \
            not all(math.isfinite(x) for e in evals for x in e[1:]):
        raise AssertionError(f"(e) the chunked in-training eval: {evals}, {counted}, {routes}")
    # on the first eval batch and its embeddings (no kernel launches): the
    # whole-logits eval against the chunked one
    chunked = orig_cached(trainer, *first_eval[0])
    trainer.cfg = dataclasses.replace(trainer.cfg, loss_chunk_size=0)
    full = orig_cached(trainer, *first_eval[0])
    gaps = {k: abs(float(chunked[k]) - float(full[k])) / abs(float(full[k])) for k in full}
    log(f"  (e) on {CARD}: chunked eval (chunks of 32) vs whole-logits eval on the first eval "
        f"batch: relative differences {gaps} (limit {LEVER_LOSS_TOL})")
    if max(gaps.values()) > LEVER_LOSS_TOL:
        raise AssertionError(f"(e) chunked eval: {gaps}")
    del trainer, first_eval[:]
    log(f"  phase 13: {time.perf_counter() - t_phase:.3f} s wall")
    return launches


# -------------------------------------------------------------------- phase 14
# TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T's published config.json
# (HF hub; named here, not fetched): the weights are random, from a seed
TINYLLAMA = dict(
    model_type="llama", architectures=["LlamaForCausalLM"], hidden_act="silu",
    hidden_size=2048, num_hidden_layers=22, num_attention_heads=32, num_key_value_heads=4,
    intermediate_size=5632, vocab_size=32000, max_position_embeddings=2048,
    rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
    bos_token_id=1, eos_token_id=2, torch_dtype="bfloat16",
)
TINYLLAMA_RUN = os.path.join(REPO, "configs", "zeroshot", "tinyllama_en_code_lw0.5_long.json")
# the trainer's memory levers, and the port's own remat of the hypernet's
# f32 glue (what XLA fuses away in the reference)
LLAMA_LEVERS = dict(remat_hypernet=True, remat_backbone=True, loss_chunk_size=32,
                    remat_hypernet_glue=True)
LLAMA_BATCH, LLAMA_VOCAB_SAMPLE = 128, 32768  # the config's, kept


def metaspace_tokenizer_json(n_vocab=32000):
    """A sentencepiece-style BPE tokenizer.json (Llama's layout: byte
    fallback, <unk>/<s>/</s>, 256 <0xNN> pieces, a Prepend("▁") +
    Replace(" ", "▁") normalizer, no pre-tokenizer) from gpt2_raw's BPE: its
    byte-level pieces in id order, decoded to text with spaces as "▁"
    (pieces that are not whole UTF-8 characters left out), and the merges
    among the kept pieces. Standard library only."""
    from zett_tpu_torch.tokenization.bytemaps import CHARS_TO_BYTES

    with open(os.path.join(REPO, "artifacts", "tokenizers", "gpt2_raw", "tokenizer.json")) as f:
        raw = json.load(f)

    def meta(token):
        return bytes(CHARS_TO_BYTES[c] for c in token).decode("utf-8").replace(" ", "▁")

    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{i:02X}>" for i in range(256)]
    seen = set(pieces)
    for token, _ in sorted(raw["model"]["vocab"].items(), key=lambda kv: kv[1]):
        try:
            piece = meta(token)
        except UnicodeDecodeError:
            continue
        if piece and piece not in seen:
            pieces.append(piece)
            seen.add(piece)
            if len(pieces) == n_vocab:
                break
    vocab = {p: i for i, p in enumerate(pieces)}
    merges = []
    for merge in raw["model"]["merges"]:
        a, b = merge.split(" ") if isinstance(merge, str) else merge
        try:
            a, b = meta(a), meta(b)
        except UnicodeDecodeError:
            continue
        if a in vocab and b in vocab and a + b in vocab:
            merges.append([a, b])
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True} for i, t in enumerate(pieces[:3])]
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }


def write_tinyllama(path):
    """The TinyLlama directory (``write_llama`` at TINYLLAMA)."""
    return write_llama(path, TINYLLAMA, SEED + 14)


def write_llama(path, hf_config, seed):
    """A Llama-family directory: ``hf_config`` as config.json, seeded
    random bf16 weights drawn on the card (projections and tables N(0,
    0.02), the RMSNorm weights 1) written as model.safetensors, and the
    metaspace tokenizer.json. Returns (the config, the state dict)."""
    from zett_tpu_torch.models.backbones.hf_io import save_safetensors
    from zett_tpu_torch.models.backbones.llama import LlamaConfig, weight_keys

    cfg = LlamaConfig.from_hf(hf_config)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.kv_heads * cfg.dims_per_head
    shapes = {"q_proj": (H, H), "k_proj": (kv, H), "v_proj": (kv, H), "o_proj": (H, H),
              "gate_proj": (I, H), "up_proj": (I, H), "down_proj": (H, I)}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = {}
    for key in weight_keys(cfg):
        if key.endswith("norm.weight"):
            sd[key] = torch.ones(H, dtype=torch.bfloat16)
            continue
        shape = (V, H) if key in ("model.embed_tokens.weight", "lm_head.weight") \
            else shapes[key.split(".")[-2]]
        sd[key] = (0.02 * torch.randn(shape, generator=gen, device="cuda")).to(
            torch.bfloat16).cpu()
    os.makedirs(path, exist_ok=True)
    save_safetensors(sd, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(metaspace_tokenizer_json(V), f, ensure_ascii=False)
    return cfg, sd


def write_code_text(train_dir, valid_dir, langs, hold_out_every=8, n_valid=128):
    """<lang>.txt for the code languages of en+code.txt: the non-blank lines
    of the repo's Python sources (one line a text; the stream packs them),
    every ``hold_out_every``-th held out, the first ``n_valid`` of those
    (one eval batch a language) into ``valid_dir``. Returns (training,
    held-out) lines."""
    import glob

    lines = []
    for pattern in ("zett_tpu_torch/**/*.py", "zett_tpu/**/*.py"):
        for path in sorted(glob.glob(os.path.join(REPO, pattern), recursive=True)):
            with open(path) as f:
                lines += [ln.rstrip() for ln in f if ln.strip()]
    held = lines[hold_out_every - 1::hold_out_every][:n_valid]
    train = [ln for i, ln in enumerate(lines) if (i + 1) % hold_out_every]
    for lang in langs:
        for directory, rows in ((train_dir, train), (valid_dir, held)):
            with open(os.path.join(directory, f"{lang}.txt"), "w") as f:
                f.write("\n".join(rows) + "\n")
    return len(train), len(held)


def phase_head128_kernels():
    """Kernels 1, 2 and 3 at head width 128 against their plain versions:
    kernel 1 at TinyLlama's hypernet (B 16384, L 7, H 2048, 16 heads, I
    4096), kernels 2 and 3 at a train batch (B 32896, L 7 and CLS-only, 16
    heads), rates 0 and 0.1, and at a train batch's share of all-padding
    rows; bf16 timed, f32 at a smaller batch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    results = {}
    H, h, I = 2048, 16, 4096
    for dtype, B in ((torch.bfloat16, 16384), (torch.float32, 2048)):
        r = check_kernel1(B, 7, dtype, gen, timed=dtype == torch.bfloat16, H=H, h=h, I=I)
        if r is not None:
            results["encoder_layer_d128"] = r
        gc_free()
    for dtype, B in ((torch.bfloat16, 32896), (torch.float32, 4096)):
        timed = dtype == torch.bfloat16
        for rate in (0.0, 0.1):
            for Lq in (7, 1):
                r = check_train_core(B, Lq, 7, dtype, rate, gen, timed=timed, h=h, d=128)
                if timed and rate == 0.0 and Lq == 7:
                    results["attention_core_d128"], results["attention_core_bwd_d128"] = r
            gc_free()
    # a train batch's share of all-padding surface forms (phase 7's last
    # batch: 18991 of 32896)
    for rate in (0.0, 0.1):
        check_train_core(32896, 7, 7, torch.bfloat16, rate, gen, timed=True, h=h, d=128,
                         padding_rows=18991)
        gc_free()
    return results


def phase_tinyllama():
    """TinyLlama through the port: (a) the model directory; (b) kernels 1,
    2 and 3 at head width 128; (c) the Llama backbone card vs CPU at full
    depth; (d) the training CLI at tinyllama_en_code_lw0.5_long.json; (e)
    the transfer CLI to llama0001 from the trained final/."""
    from zett_tpu_torch.models.backbones.llama import LlamaForCausalLM
    from zett_tpu_torch.tokenization.convert import convert_to_byte_level
    from zett_tpu_torch.tokenization.core import Tokenizer

    t_phase = time.perf_counter()
    model_dir = os.path.join(WORK, "tinyllama")
    cfg, sd, written_s = PREPARED.pop("tinyllama")
    n_params = sum(t.numel() for t in sd.values())
    source = Tokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))
    converted, n_added = convert_to_byte_level(source)
    log(f"  (a) wrote TinyLlama's published config ({n_params} parameters, bf16, "
        f"{os.path.getsize(os.path.join(model_dir, 'model.safetensors')) / 2**30:.3f} GiB) and a "
        f"{len(source)}-piece metaspace tokenizer in {written_s:.3f} s, while the kernels "
        f"built; the byte-level conversion: {len(converted)} tokens, n_added_tokens {n_added}")
    if len(source) != cfg.vocab_size or n_added is None or n_added < 0:
        raise AssertionError(f"tokenizer: {len(source)} pieces, n_added {n_added}")

    step("(b) kernels 1, 2 and 3 at head width 128")
    kernels = phase_head128_kernels()
    step("(c) the backbone card vs CPU")

    # (c) the backbone on the card against the CPU, f32, all 22 layers
    rng = np.random.default_rng(SEED + 16)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 64)))
    mask = torch.ones(2, 64, dtype=torch.long)
    mask[1, 48:] = 0
    tables = (sd["model.embed_tokens.weight"], sd["lm_head.weight"])
    with torch.no_grad():
        ref = LlamaForCausalLM(cfg, sd, torch.float32)(ids, mask, *tables)
        card = LlamaForCausalLM(cfg, sd, torch.float32).cuda()
        got = card(ids.cuda(), mask.cuda(), *(t.cuda() for t in tables)).cpu()
        del card
    gc_free()
    valid = mask.bool()
    err = float((got - ref).abs()[valid].max())
    scale = float(ref.abs()[valid].max())
    # f32 (no TF32) sums in another order than the CPU's through 22 layers
    log(f"  (c) TinyLlama logits (2, 64) at full depth, card vs CPU, f32: max abs {err:.3g} "
        f"at logit scale {scale:.3g} (tol 1e-4 x scale)")
    if not bool(torch.isfinite(got).all()) or err > 1e-4 * scale:
        raise AssertionError(f"the Llama backbone differs on the card: {err}")

    step("(d) the training CLI")
    train = phase_tinyllama_training(model_dir)
    step("(e) the transfer CLI")
    transfer = phase_tinyllama_transfer(model_dir, train["final"])
    log(f"  phase 14: {time.perf_counter() - t_phase:.3f} s wall")
    return kernels, train, transfer


def phase_tinyllama_training(model_dir):
    """(d) python -m zett_tpu_torch.training at
    configs/zeroshot/tinyllama_en_code_lw0.5_long.json through its ``main``:
    the config's batch 128 and vocab sample 32768 kept; first with no lever
    and each of the trainer's memory levers alone (two train steps: peak
    memory or out of memory), then 4 steps (1 identity step) with the
    levers and in-training eval at step 0 and at the end on held-out text.
    Cut to make room for phase 17: 2 of the 6 steps (1 of the 2 identity
    steps); for phase 18: final/ without the optimizer state (the transfer
    reads the parameters; 13(b) and 17(c) resume from full states)."""
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.training import engine
    from zett_tpu_torch.training.__main__ import load_config_file, load_language_list
    from zett_tpu_torch.training.__main__ import main as train_main

    config = load_config_file(TINYLLAMA_RUN)
    langs, _ = load_language_list(os.path.join(REPO, config["langs"]))
    train_dir, valid_dir = os.path.join(WORK, "llama_train"), os.path.join(WORK, "llama_valid")
    out = os.path.join(WORK, "llama_out")
    shutil.rmtree(out, ignore_errors=True)  # metrics.jsonl is appended to
    n_en, n_en_valid = write_training_text(train_dir, valid_dir, hold_out_every=8)
    n_code, n_code_valid = write_code_text(train_dir, valid_dir, [l for l in langs if l != "en"])
    if config["batch_size"] != LLAMA_BATCH or config["tokenizer_sample_max"] != LLAMA_VOCAB_SAMPLE:
        raise AssertionError("the TinyLlama config's batch or vocab sample changed")
    steps, n_ident = 4, 1
    tokenizers = [os.path.join(REPO, t) for t in config["extra_valid_tokenizers"]]
    reduced = dict(model_dir=model_dir, train_directory=train_dir, valid_directory=valid_dir,
                   output_dir=out, steps=steps, identity_steps=n_ident, warmup_steps=[1, 2],
                   random_warmup_steps=0, logging_steps=1, save_steps=0, save_state=False,
                   num_workers=0, prefetch_batches=0, eval_steps=steps, eval_at_step_zero=True,
                   langs=os.path.join(REPO, config["langs"]), extra_valid_tokenizers=tokenizers)
    config.update(reduced)
    log(f"  (d) langs {langs} (en: {n_en} training and {n_en_valid} held-out Markdown "
        f"paragraphs; the others: {n_code} and {n_code_valid} lines of the repo's Python); "
        f"batch {config['batch_size']}, vocab sample "
        f"{config['tokenizer_sample_max']}; overrides "
        f"{ {k: v for k, v in reduced.items() if k not in ('extra_valid_tokenizers', 'langs')} }")

    peaks = {}
    for name, levers in (("no lever", {}),
                         *((f"{k} alone", {k: v}) for k, v in LLAMA_LEVERS.items())):
        # no eval runs here: no validation text or fixed tokenizers to set up
        one = dict(config, steps=2, identity_steps=0, eval_steps=0, eval_at_step_zero=False,
                   valid_directory=None, extra_valid_tokenizers=[],
                   output_dir=os.path.join(WORK, "llama_lever"), **levers)
        t0 = time.perf_counter()
        got = train_peak(one, "tinyllama_lever")
        peaks[name] = got
        shown = ("out of memory" if got is None else
                 f"peak {got[0]:.2f} GiB, train step {got[1]:.3f} ms (CUDA events)")
        log(f"  (d) on {CARD}: batch 128 with {name}: {shown}; "
            f"{time.perf_counter() - t0:.3f} s wall")
    gc_free()

    config.update(LLAMA_LEVERS)
    config_path = os.path.join(WORK, "tinyllama_smoke.json")
    with open(config_path, "w") as f:
        json.dump(config, f)
    passes = [0]
    orig_embed = engine.Trainer.compute_embeddings

    def counted_embed(self, b):
        passes[0] += 1
        return orig_embed(self, b)

    engine.Trainer.compute_embeddings = counted_embed
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        trainer, history = train_main([config_path])
    finally:
        engine.Trainer.compute_embeddings = orig_embed
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    n_layers = config["num_hidden_layers"]
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    eval_rows = [r for r in rows if any(k.startswith("eval") for k in r)]
    train_rows = [r for r in rows if r not in eval_rows]
    losses = [r.get("loss", r.get("identity_loss")) for r in train_rows]
    recs = trainer.records
    train_ms = [r["device_ms"] for r in recs if r["kind"] == "train"][1:]
    ident_ms = [r["device_ms"] for r in recs if r["kind"] == "identity"]
    log(f"  (d) {steps} steps ({n_ident} identity) with {LLAMA_LEVERS} in {wall:.3f} s wall "
        f"(loading, conversion and evals included); logged losses "
        f"{['%.4f' % x for x in losses]}")
    if len(train_rows) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bad training rows {train_rows}")
    names = [f"eval_{os.path.basename(t)}" for t in tokenizers] + ["eval"]
    if [r.get("step", 0) for r in eval_rows] != [0, steps]:
        raise AssertionError(f"eval rows at steps {[r.get('step') for r in eval_rows]}")
    for r in eval_rows:
        for name in names:
            for metric in ("eval_loss", "eval_bpb"):
                v = r.get(f"{name}/{metric}")
                if v is None or not math.isfinite(v):
                    raise AssertionError(f"eval row {r.get('step', 0)}: {name}/{metric} = {v}")
        log(f"  (d) eval at step {r.get('step', 0)}: " + ", ".join(
            f"{n} loss {r[n + '/eval_loss']:.4f} bpb {r[n + '/eval_bpb']:.4f}" for n in names))
    # remat_hypernet runs a train step's hypernet forward twice (the
    # identity step's once); every eval pass runs kernel 1 on the layers
    # before the CLS-only last one and kernel 2 on that one
    expected = dict.fromkeys(_build.launch_counts, 0)
    expected["attention_core"] = (n_ident + 2 * (steps - n_ident)) * n_layers + passes[0]
    expected["attention_core_bwd"] = steps * n_layers
    expected["encoder_layer"] = passes[0] * (n_layers - 1)
    log(f"  (d) launches {launches} (expected {expected}; {passes[0]} eval embedding passes)")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")

    batch = trainer.last_train_batch
    trainer.train_step(batch)  # warm the exact shapes, outside the counted run
    busy, _, _ = device_breakdown(lambda: trainer.train_step(batch), top=12)
    step = float(np.median(train_ms))
    idle = "not measured" if busy is None else f"{1 - busy / step:.3f}"
    log(f"  (d) on {CARD}: train step {step:.3f} ms (CUDA events, median of "
        f"{['%.3f' % x for x in train_ms]}); identity steps {['%.3f' % x for x in ident_ms]} "
        f"ms; idle share of a train step {idle} (1 - traced device busy / step span); peak "
        f"memory {peak_gb:.2f} GiB")
    del trainer, batch
    gc_free()
    return dict(launches=launches, step_ms=step, ident_ms=ident_ms, wall=wall,
                peak_gb=peak_gb, peaks=peaks, final=os.path.join(out, "final"))


def phase_tinyllama_transfer(model_dir, checkpoint):
    """(e) python -m zett_tpu_torch.transfer from the trained final/ to
    llama0001 (32771 tokens); the written model read back through the
    port's Llama."""
    from zett_tpu_torch.models.backbones.hf_io import load_hf_state_dict
    from zett_tpu_torch.models.backbones.llama import LlamaConfig, LlamaForCausalLM
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.tokenization.core import Tokenizer
    from zett_tpu_torch.transfer.__main__ import main as transfer_main

    target_path = os.path.join(REPO, "artifacts", "tokenizers", "llama0001", "tokenizer.json")
    out = os.path.join(WORK, "tinyllama_llama0001")
    batch = 16384
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with captured_transfer() as captured:
        transfer_main(["--checkpoint", checkpoint, "--model", model_dir,
                       "--target-tokenizer", target_path, "--output", out,
                       "--batch-size", str(batch), "--seed", str(SEED)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)

    target = Tokenizer.from_file(os.path.join(out, "tokenizer.json"))
    with open(os.path.join(out, "config.json")) as f:
        written = json.load(f)
    sd = load_hf_state_dict(out)
    emb, head = sd["model.embed_tokens.weight"], sd["lm_head.weight"]
    n, width = len(target), TINYLLAMA["hidden_size"]
    log(f"  (e) transfer to llama0001: {n} tokens in {wall:.3f} s wall; embed_tokens "
        f"{tuple(emb.shape)}, lm_head {tuple(head.shape)}, config vocab_size "
        f"{written['vocab_size']}; max |embed_tokens - lm_head| "
        f"{float((emb - head).abs().max()):.4g}")
    if n != 32771 or emb.shape != (n, width) or head.shape != (n, width) \
            or written["vocab_size"] != n:
        raise AssertionError("the transferred TinyLlama has the wrong vocab")
    if torch.equal(emb, head) or not (bool(torch.isfinite(emb).all())
                                      and bool(torch.isfinite(head).all())):
        raise AssertionError("embed_tokens and lm_head are not two finite predicted tables")
    with open(os.path.join(checkpoint, "hn_config.json")) as f:
        n_layers = json.load(f)["num_hidden_layers"]
    n_batches = -(-n // batch)
    expected = dict.fromkeys(_build.launch_counts, 0)
    expected["encoder_layer"] = n_batches * (n_layers - 1)
    expected["attention_core"] = n_batches
    log(f"  (e) launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")

    cfg = LlamaConfig.from_hf(written)
    ids = torch.from_numpy(np.random.default_rng(SEED + 17).integers(0, n, size=(2, 64))).cuda()
    mask = torch.ones_like(ids)
    with torch.no_grad():
        model = LlamaForCausalLM(cfg, sd, torch.bfloat16).cuda()
        logits = model(ids, mask, emb.cuda(), head.cuda())
    if logits.shape != (2, 64, n) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"the written model's logits: {tuple(logits.shape)}")
    log(f"  (e) the written model loads through the port's Llama: logits {tuple(logits.shape)}"
        f", finite, max |logit| {float(logits.float().abs().max()):.4g}")
    del model, sd, logits
    gc_free()

    run, ms, times, n_vocab, shapes = timed_passes(captured, 3)
    log(f"  (e) on {CARD}: hypernet median of 3 passes {ms:.3f} ms (min {min(times):.3f}, max "
        f"{max(times):.3f}) for the {n_vocab}-token vocab in batches {shapes} "
        f"({ms * 32768 / n_vocab:.3f} ms per 32k vocab)")
    busy, pass_wall, _ = device_breakdown(run)
    del run, captured
    gc_free()
    return dict(launches=launches, wall=wall, ms_per_32k=ms * 32768 / n_vocab,
                idle=None if busy is None else 1 - busy / pass_wall)


# -------------------------------------------------------------------- phase 15
# mistralai/Mistral-7B-v0.1's published config.json (HF hub; named here, not
# fetched): the weights are random, from a seed. The sliding window is
# ignored, as the JAX module ignores it (blocks of at most 512 positions).
MISTRAL = dict(
    model_type="mistral", architectures=["MistralForCausalLM"], hidden_act="silu",
    hidden_size=4096, intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, vocab_size=32000, max_position_embeddings=32768,
    rope_theta=10000.0, rms_norm_eps=1e-5, sliding_window=4096, tie_word_embeddings=False,
    bos_token_id=1, eos_token_id=2, torch_dtype="bfloat16",
)
# the depth written (the cut: every width kept; each transfer reads the
# whole model and writes it again, 14.5 GB at 32 layers, and copies its
# layers untouched: one layer keeps the run's disk writes small)
MISTRAL_LAYERS = 1
MISTRAL_RUNS = {name: os.path.join(REPO, "configs", "zeroshot", f"mistral7b_{name}_lw0.5_long.json")
                for name in ("en_code", "multilingual")}
TINYLLAMA_ML_RUN = os.path.join(REPO, "configs", "zeroshot",
                                "tinyllama_multilingual_lw0.5_long.json")
PADDING_ROWS = 18991  # a train batch's all-padding surface forms of 32896 (phase 7)
# layers of the TinyLlama that (e) trains on (cut from 22 for time: the
# hypernet, its launches and the language ids do not depend on the depth)
ML_TRAIN_CUT = 2


def mistral_hypernet_config(name):
    """The hypernet of configs/zeroshot/mistral7b_<name>_lw0.5_long.json as
    the training CLI builds it over Mistral-7B: n_embd 4096, an untied head
    (dual heads), the 32000-row source table, one language id a language."""
    from zett_tpu_torch.training.__main__ import load_config_file, load_configs

    config = load_config_file(MISTRAL_RUNS[name])
    _, _, hn = load_configs(config)
    langs = config["langs"]
    return dataclasses.replace(
        hn, n_embd=MISTRAL["hidden_size"], separate_out_embeddings=True,
        original_vocab_size=MISTRAL["vocab_size"],
        n_langs=len(langs) if isinstance(langs, list) else 1)


def phase_heads32_kernels():
    """Kernels 1 to 5 at 32 heads against their plain versions: kernel 1 at
    Mistral-7B's hypernet (B 16384, H 4096, 32 heads of 128, I 8192) at L 7
    and 8, kernel 2 at the transfer's CLS shape (B 16384, Lk 7 and 8),
    kernels 2 and 3 at a train batch (B 32896, L 7) with its all-padding
    share at rates 0 and 0.1, kernel 1 past the fused route's 16 heads of 64
    and kernels 4 and 5 at 32 heads of 64; bf16 timed, f32 at a smaller
    batch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    results = {}
    H, h, I = 4096, 32, 8192
    for L in (7, 8):
        for dtype, B in ((torch.bfloat16, 16384), (torch.float32, 1024)):
            # weights at the init's 1/sqrt(fan_in): at std 0.03 the
            # activations grow with H, and at H 4096 the kernel and the plain
            # version, equally close to the f32 layer, round 0.12% of outputs
            # more than 2 ulps apart (NVIDIA H100 80GB HBM3, 700 W)
            r = check_kernel1(B, L, dtype, gen, timed=dtype == torch.bfloat16, H=H, h=h, I=I,
                              fan_in=True, plain_reps=2)
            if r is not None and L == 8:
                results["encoder_layer_h32"] = r
            gc_free()
        for dtype, B in ((torch.bfloat16, 16384), (torch.float32, 2048)):
            r = check_kernel2(B, L, dtype, gen, timed=dtype == torch.bfloat16, h=h, d=128)
            if r is not None and L == 8:
                results["attention_core_h32"] = r
        gc_free()
    for rate in (0.0, 0.1):
        # the plain versions take 2.6 s a call at rate 0.1 and kernel 3 0.4 s
        # (NVIDIA H100 80GB HBM3, 700 W): fewer timed calls than the earlier phases' 20
        _, bwd = check_train_core(32896, 7, 7, torch.bfloat16, rate, gen, timed=True, h=h,
                                  d=128, padding_rows=PADDING_ROWS, plain_reps=1, reps=5)
        if rate == 0.0:
            results["attention_core_bwd_h32"] = bwd
        gc_free()
        check_train_core(2048, 7, 7, torch.float32, rate, gen, timed=False, h=h, d=128,
                         padding_rows=1000)
        gc_free()
    # 32 heads of 64: kernel 1 past the fused route (the seven launches),
    # kernels 4 and 5 at the transfer's L 8
    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        check_kernel1(4096, 8, dtype, gen, timed=False, H=2048, h=h, I=4096, fan_in=True)
        check_kernel4(16384 if timed else 2048, 8, dtype, False, gen, timed, H=2048, h=h)
        check_kernel5(16384 if timed else 2048, 8, dtype, True, gen, timed, h=h)
        gc_free()
    return results


def phase_mistral_hypernet(n=64):
    """(c) The Mistral hypernet (both configs' widths), card against CPU,
    f32, on ``n`` surface forms: the multilingual one at a language id (L 8:
    kernel 1 on the two full layers, kernel 2 on the CLS one; its
    prediction differs at language id 0), then the same weights without the
    language-id table at en_code's config (L 7)."""
    from zett_tpu_torch.models.convert import flax_to_torch
    from zett_tpu_torch.ops import _build

    rng = np.random.default_rng(SEED + 21)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)  # the weights, on the card
    configs = {name: mistral_hypernet_config(name) for name in MISTRAL_RUNS}
    vocab = MISTRAL["vocab_size"]
    src_card = 0.02 * torch.randn((vocab, 2 * MISTRAL["hidden_size"]), generator=gen,
                                  device="cuda")
    src = src_card.cpu()
    state = flax_to_torch(flax_layout(meta_hypernet(configs["multilingual"]), gen))
    for name, lang in (("multilingual", 7), ("en_code", None)):
        cfg = configs[name]
        cpu_model = meta_hypernet(cfg)
        cpu_model.load_state_dict({k: state[k] for k in cpu_model.state_dict()}, assign=True)
        sf = torch.from_numpy(hypernet_inputs(rng, n, vocab, cfg.hn_surface_maxlen,
                                              cfg.n_extra_tokens))
        gpu_model = meta_hypernet(cfg)
        gpu_model.load_state_dict({k: v.cuda() for k, v in cpu_model.state_dict().items()},
                                  assign=True)
        gpu_model.eval()
        n_layers = cfg.num_hidden_layers
        launched = {"encoder_layer": n_layers - 1, "attention_core": 1, "attention_block": 0}
        before = dict(_build.launch_counts)
        with torch.inference_mode():
            got = gpu_model(sf.cuda(), None, src_card, lang)
            torch.cuda.synchronize()
            counts = {k: _build.launch_counts[k] - before[k] for k in launched}
            t0 = time.perf_counter()
            ref = cpu_model(sf, None, src, lang)
            cpu_s = time.perf_counter() - t0
            if lang is not None:
                other = gpu_model(sf.cuda(), None, src_card, 0)[0]
                diff = float((other.float() - got[0].float()).abs().max())
                log(f"  (c) {name}: emb_in at language ids 0 and {lang} on the card: max "
                    f"difference {diff:.4g}")
                if diff == 0:
                    raise AssertionError("the language id does not change the prediction")
                del other
        L = cfg.hn_surface_maxlen + int(cfg.embed_lang_id)
        log(f"  (c) {name} (L {L}, language id {lang}): launches {counts} (expected "
            f"{launched}); the CPU forward {cpu_s:.3f} s")
        if counts != launched:
            raise AssertionError(f"the Mistral hypernet launched {counts}, expected {launched}")
        for what, g, r in zip(("emb_in", "emb_out", "bias"), got, ref):
            g, r = g.float().cpu().numpy(), r.float().numpy()
            err = np.abs(g - r).max()
            scale = np.abs(r).max()
            # the tolerance of phase 3: f32 sums in another order
            log(f"  (c) {name} {what}: max abs {err:.3g} at output scale {scale:.3g} "
                f"(tol 1e-5 x scale)")
            if not np.isfinite(g).all() or err > 1e-5 * max(scale, 1.0):
                raise AssertionError(f"the Mistral hypernet's {what} differs: {err}")
        del cpu_model, gpu_model, got, ref
        gc_free()


def meta_hypernet(cfg, dtype=torch.float32):
    """A port Hypernet on the meta device: its parameters' shapes and
    dtypes without the default init of ~0.7 G parameters (load a state with
    ``assign=True``)."""
    from zett_tpu_torch.models import Hypernet

    with torch.device("meta"):
        return Hypernet(cfg, dtype=dtype)


def write_mistral_checkpoint(path, name, flat, hn_tokenizer):
    """A hypernet checkpoint at mistral7b_<name>'s config (bf16 compute)
    holding ``flat`` (f32, Flax paths) and the byte-level hn tokenizer, as
    the training CLI's final/ holds them."""
    cfg = mistral_hypernet_config(name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "hn_config.json"), "w") as f:
        json.dump({**cfg.to_dict(), "dtype": "bfloat16"}, f)
    np.savez(os.path.join(path, "params.npz"), **flat)
    hn_tokenizer.save(os.path.join(path, "tokenizer.json"))
    return cfg


def add_language_table(path, name, rng):
    """mistral7b_<name>'s checkpoint made from en_code's at ``path`` in
    place: its config, and a seeded language table appended to params.npz
    (np.savez's zip layout), rather than a second 2.5 GB file, to keep the
    run's disk writes small."""
    cfg = mistral_hypernet_config(name)
    with open(os.path.join(path, "hn_config.json"), "w") as f:
        json.dump({**cfg.to_dict(), "dtype": "bfloat16"}, f)
    table = 0.02 * rng.standard_normal((cfg.n_langs, cfg.hidden_size), dtype=np.float32)
    with zipfile.ZipFile(os.path.join(path, "params.npz"), "a") as z, \
            z.open("encoder/lang_embedding/embedding.npy", "w") as f:
        np.lib.format.write_array(f, table)
    return cfg


def phase_mistral_transfer(model_dir):
    """(d) python -m zett_tpu_torch.transfer on its default device from a
    seeded hypernet checkpoint at each Mistral config to llama0001: exact
    launches, both tables at 32771 rows; the multilingual config at
    --lang-index 5: its hypernet ran at that language id, and the first
    batch at language id 0 gives another table; the hypernet per 32k vocab
    over the transfer's own batches (captured from the CLI run), its idle
    share and device time by kernel; wall and peak memory. Cut to make room
    for phase 17: the multilingual transfer at --lang-index 0 (its first
    batch through the same hypernet instead) and the products by input
    shape."""
    from zett_tpu_torch.models.backbones.hf_io import load_hf_state_dict
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.transfer.__main__ import main as transfer_main

    target_path = os.path.join(REPO, "artifacts", "tokenizers", "llama0001", "tokenizer.json")
    rng = np.random.default_rng(SEED + 22)
    batch, n_target = 16384, 32771
    # en_code's checkpoint (written while the kernels built); the
    # multilingual one: en_code's parameters and a language table
    cfg, written_s = PREPARED.pop("mistral_ckpt")
    ckpt = os.path.join(WORK, "mistral_ckpt")
    launches, rows = {}, {}
    for name, index in (("en_code", 0), ("multilingual", 5)):
        t0 = time.perf_counter()
        if name == "multilingual":
            cfg = add_language_table(ckpt, name, rng)
            written_s = time.perf_counter() - t0
        log(f"  (d) wrote a seeded {name} checkpoint (params.npz "
            f"{os.path.getsize(os.path.join(ckpt, 'params.npz')) / 2**30:.3f} GiB, f32) in "
            f"{written_s:.3f} s")
        out = os.path.join(WORK, f"mistral_{name}_{index}")
        _build.reset_launch_counts()
        gc_free()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with captured_transfer() as captured:
            transfer_main(["--checkpoint", ckpt, "--model", model_dir,
                           "--target-tokenizer", target_path, "--output", out,
                           "--batch-size", str(batch), "--seed", str(SEED),
                           "--lang-index", str(index)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = dict(_build.launch_counts)
        n_batches = -(-n_target // batch)
        expected = dict.fromkeys(_build.launch_counts, 0)
        expected["encoder_layer"] = n_batches * (cfg.num_hidden_layers - 1)
        expected["attention_core"] = n_batches
        sd = load_hf_state_dict(out)
        emb, head = sd["model.embed_tokens.weight"], sd["lm_head.weight"]
        log(f"  (d) {name} --lang-index {index}: {wall:.3f} s wall, peak memory {peak:.2f} "
            f"GiB; embed_tokens {tuple(emb.shape)}, lm_head {tuple(head.shape)}; launches "
            f"{got} (expected {expected})")
        if got != expected:
            raise AssertionError(f"kernel launches {got}, expected {expected}")
        width = MISTRAL["hidden_size"]
        if emb.shape != (n_target, width) or head.shape != (n_target, width) \
                or torch.equal(emb, head) or not bool(torch.isfinite(emb).all()) \
                or not bool(torch.isfinite(head).all()):
            raise AssertionError("the transferred Mistral does not hold two finite tables")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        rows[(name, index)] = dict(wall=wall, peak=peak)
        del sd, emb, head
        shutil.rmtree(out, ignore_errors=True)
        if cfg.embed_lang_id:
            # the language id the CLI's hypernet ran at, and its first batch
            # at language id 0 through the same hypernet (outside the
            # counted run)
            (sf, pr, src, lang), (emb_at, _, _) = captured["first"]
            with torch.inference_mode():
                emb_0 = captured["hypernet"](sf, pr, src, 0)[0]
            diff = float((emb_0.float() - emb_at.float()).abs().max())
            log(f"  (d) {name}: the CLI's hypernet ran at language id {lang}; its first batch "
                f"({len(sf)} rows) at language id 0: emb_in max difference {diff:.4g}")
            if lang != index or diff == 0:
                raise AssertionError("--lang-index does not reach the hypernet")
            del sf, pr, src, emb_at, emb_0
        run, ms, times, n_vocab, shapes = timed_passes(captured, 2)
        log(f"  (d) {name} on {CARD}: hypernet median of 2 passes {ms:.3f} ms (min "
            f"{min(times):.3f}, max {max(times):.3f}) for the {n_vocab}-token vocab in batches "
            f"{shapes} ({ms * 32768 / n_vocab:.3f} ms per 32k vocab)")
        busy, pass_wall, _ = device_breakdown(run)
        rows[name] = dict(ms_per_32k=ms * 32768 / n_vocab,
                          idle=None if busy is None else 1 - busy / pass_wall)
        del run, captured
        gc_free()
    shutil.rmtree(ckpt, ignore_errors=True)
    return launches, rows


def allocator_settings(setting):
    """Set the CUDA caching allocator's ``setting`` at run time (what
    PYTORCH_CUDA_ALLOC_CONF sets at start-up), through torch's private
    setter: the accelerator one where this torch has it."""
    setter = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (setter or torch.cuda.memory._set_allocator_settings)(setting)


def phase_multilingual_training(model_dir):
    """(e) python -m zett_tpu_torch.training at
    configs/zeroshot/tinyllama_multilingual_lw0.5_long.json through its
    ``main`` on phase 14's TinyLlama cut to ML_TRAIN_CUT layers: 26
    <lang>.txt files of the repo's Markdown, batch 128, vocab sample 32768
    and every width kept, the four levers; 1 identity step and 2 train
    steps. Finite losses, exact launches, a nonzero gradient of
    lang_embedding."""
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.training.__main__ import load_config_file
    from zett_tpu_torch.training.__main__ import main as train_main

    config = load_config_file(TINYLLAMA_ML_RUN)
    langs = config["langs"]
    train_dir = os.path.join(WORK, "ml_train")
    n_par, _ = write_training_text(train_dir)
    for lang in langs:
        if lang != "en":
            shutil.copy(os.path.join(train_dir, "en.txt"), os.path.join(train_dir, f"{lang}.txt"))
    if config["batch_size"] != LLAMA_BATCH or config["tokenizer_sample_max"] != LLAMA_VOCAB_SAMPLE \
            or not config["embed_lang_id"]:
        raise AssertionError("the multilingual TinyLlama config changed")
    out = os.path.join(WORK, "ml_out")
    steps, n_ident = 3, 1
    config.update(model_dir=write_depth_cut(model_dir, ML_TRAIN_CUT),
                  train_directory=train_dir, valid_directory=None, output_dir=out, steps=steps,
                  identity_steps=n_ident, warmup_steps=[1, 2], random_warmup_steps=0,
                  logging_steps=1, save_steps=0, save_state=False, num_workers=0,
                  prefetch_batches=0, eval_steps=0, eval_at_step_zero=False,
                  extra_valid_tokenizers=[], **LLAMA_LEVERS)
    path = os.path.join(WORK, "tinyllama_multilingual.json")
    with open(path, "w") as f:
        json.dump(config, f)
    log(f"  (e) {len(langs)} languages {langs}, each {n_par} paragraphs of the repo's "
        f"Markdown; TinyLlama at {ML_TRAIN_CUT} layers; batch {config['batch_size']}, vocab "
        f"sample {config['tokenizer_sample_max']}, levers {LLAMA_LEVERS}")
    gc_free()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    # without expandable segments the first train step ran out of memory
    # with 59.81 GiB allocated and 15.06 GiB reserved but unallocated
    # (NVIDIA H100 80GB HBM3, 700 W): the allocator's fragmentation, not the step's need
    allocator_settings("expandable_segments:True")
    t0 = time.perf_counter()
    try:
        trainer, history = train_main([path])
        torch.cuda.synchronize()
    finally:
        allocator_settings("expandable_segments:False")
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r.get("loss", r.get("identity_loss")) for r in history]
    n_layers = trainer.hn_config.num_hidden_layers
    expected = dict.fromkeys(_build.launch_counts, 0)
    expected["attention_core"] = (n_ident + 2 * (steps - n_ident)) * n_layers
    expected["attention_core_bwd"] = steps * n_layers
    grad = trainer.last_grads[("hypernet", "encoder", "lang_embedding", "embedding")]
    rows = sorted(int(i) for i in torch.nonzero(grad.abs().sum(-1)).flatten())
    log(f"  (e) {steps} steps ({n_ident} identity) in {wall:.3f} s wall; losses "
        f"{['%.4f' % x for x in losses]}; peak memory {peak:.2f} GiB; launches {launches} "
        f"(expected {expected}); lang_embedding {tuple(grad.shape)}, nonzero gradient on "
        f"rows {rows}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bad losses {losses}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    if tuple(grad.shape) != (len(langs), TINYLLAMA["hidden_size"]) or not rows:
        raise AssertionError("lang_embedding has no gradient")
    del trainer
    gc_free()
    return launches


def phase_mistral(tinyllama_dir):
    """Mistral-7B's hypernets (en+code and multilingual) through transfer,
    and language ids through training: (a) the model directory; (b) kernels
    1 to 5 at 32 heads; (c) the hypernet card vs CPU; (d) the transfer CLI
    at both configs; (e) the multilingual TinyLlama config through the
    training CLI."""
    t_phase = time.perf_counter()
    model_dir = os.path.join(WORK, "mistral")
    n_params, written_s = PREPARED.pop("mistral")
    log(f"  (a) wrote Mistral-7B's published config cut to {MISTRAL_LAYERS} of "
        f"{MISTRAL['num_hidden_layers']} layers, every width kept ({n_params} parameters, bf16, "
        f"{os.path.getsize(os.path.join(model_dir, 'model.safetensors')) / 2**30:.3f} GiB) and "
        f"a 32000-piece metaspace tokenizer in {written_s:.3f} s, while the kernels built")
    step("(b) kernels 1 to 5 at 32 heads")
    kernels = phase_heads32_kernels()
    step("(c) the Mistral hypernets card vs CPU")
    phase_mistral_hypernet()
    step("(d) the transfer CLI at both Mistral configs")
    transfer_launches, transfer = phase_mistral_transfer(model_dir)
    step("(e) language ids through the training CLI")
    train_launches = phase_multilingual_training(tinyllama_dir)
    log(f"  phase 15: {time.perf_counter() - t_phase:.3f} s wall")
    return kernels, transfer_launches, train_launches, transfer


EVAL_BLOCK, EVAL_BATCH = 512, 8  # the perplexity CLI's defaults
EVAL_CUT = 2  # layers of the card-vs-CPU comparisons of phase 16 (c) and (d)
CHOICE_CPU_ITEMS = 4  # items of each task that (d) scores on the CPU too (cut from 8)
COPA = os.path.join(REPO, "out", "multilingual_eval", "copa_{}.jsonl")


def write_depth_cut(src_dir, n_layers):
    """A copy of the Llama-family directory ``src_dir`` cut to its first
    ``n_layers`` layers (config.json, the weights those layers and the
    tables need, the tokenizer), for the card-vs-CPU comparisons. Returns
    its path; a cut written before is used again."""
    from zett_tpu_torch.models.backbones.hf_io import load_hf_state_dict, save_hf_model

    dst_dir = f"{src_dir}_{n_layers}layers"
    if os.path.isdir(dst_dir):
        return dst_dir
    with open(os.path.join(src_dir, "config.json")) as f:
        config = dict(json.load(f), num_hidden_layers=n_layers)
    state = {k: v for k, v in load_hf_state_dict(src_dir).items()
             if not k.startswith("model.layers.") or int(k.split(".")[2]) < n_layers}
    save_hf_model(dst_dir, state, config)
    shutil.copy(os.path.join(src_dir, "tokenizer.json"), dst_dir)
    return dst_dir


def timed_eval_cli(cli_main, argv):
    """Run an eval CLI's ``main`` on the card with its stages timed: the
    host encode (``chunked_tokenize``), the eval loop (``evaluate_lm``,
    synchronised) and the peak memory. Returns (metrics, stages), where
    stages holds the loop's arguments to run it again."""
    import zett_tpu_torch.evaluation.perplexity as ppl

    stages = {}
    encode, evaluate = ppl.chunked_tokenize, ppl.evaluate_lm

    def timed_encode(tokenizer, texts, block_size):
        t0 = time.perf_counter()
        data = encode(tokenizer, texts, block_size)
        stages["encode_s"] = time.perf_counter() - t0
        stages["encode_mb"] = sum(len(t.encode("utf-8")) for t in texts) / 1e6
        stages["text_chars"] = sum(len(t.replace("\x00", "").strip()) for t in texts)
        return data

    def timed_evaluate(apply_fn, data, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate(apply_fn, data, **kw)
        torch.cuda.synchronize()
        stages["eval_s"] = time.perf_counter() - t0
        stages["rerun"] = lambda: evaluate(apply_fn, data, **kw)
        return out

    ppl.chunked_tokenize, ppl.evaluate_lm = timed_encode, timed_evaluate
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        metrics = cli_main(argv)
    finally:
        ppl.chunked_tokenize, ppl.evaluate_lm = encode, evaluate
    stages["wall_s"] = time.perf_counter() - t0
    stages["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return metrics, stages


def eval_report(tag, metrics, stages):
    """Print a perplexity CLI run's metrics and rates; fail on non-finite
    metrics."""
    n_tokens = metrics["n_tokens"]
    busy, wall_ms, _ = device_breakdown(stages.pop("rerun"), top=6)
    idle = "not measured" if busy is None else f"{1 - busy / wall_ms:.3f}"
    log(f"  ({tag}) loss {metrics['loss']:.6f} ppl {metrics['perplexity']:.6g} bpc "
        f"{metrics['bits_per_char']:.6g} cpt {metrics['chars_per_token']:.6g} n_tokens "
        f"{n_tokens:.0f} ({n_tokens / (EVAL_BLOCK - 1):.0f} blocks); the texts' own chars per "
        f"scored token {stages['text_chars'] / n_tokens:.4f}")
    log(f"  ({tag}) host encode {stages['encode_mb']:.4f} MB in {stages['encode_s']:.3f} s "
        f"({stages['encode_mb'] / stages['encode_s']:.4f} MB/s); eval loop "
        f"{stages['eval_s']:.3f} s ({n_tokens / stages['eval_s']:.1f} tokens/s on the card); "
        f"idle share of the eval loop {idle} (1 - traced device busy / loop wall, a second "
        f"run); CLI wall {stages['wall_s']:.3f} s; peak memory {stages['peak_gib']:.2f} GiB")
    if not all(math.isfinite(float(metrics[k])) for k in
               ("loss", "perplexity", "bits_per_char", "chars_per_token")) or n_tokens <= 0:
        raise AssertionError(f"({tag}) eval metrics: {metrics}")


def phase_eval(tinyllama_dir, transferred_dir, card="cuda"):
    """The eval CLIs on the card: (a) the perplexity CLI on TinyLlama under
    its own metaspace BPE (the general encode pipeline); (b) on the
    transferred model under llama0001 (the native fast path); (c)
    evaluate_lm card vs CPU at a 2-layer cut; (d) the choice CLI on the
    transferred model over COPA-style en and code tasks, and card vs CPU at
    the 2-layer cut."""
    from zett_tpu_torch.evaluation import choice
    from zett_tpu_torch.evaluation.__main__ import main as ppl_main
    from zett_tpu_torch.evaluation.perplexity import chunked_tokenize, evaluate_lm, load_causal_lm
    from zett_tpu_torch.tokenization.core import Tokenizer
    from zett_tpu_torch.tokenization.fast_encode import fast_encoder_or_none

    t_phase = time.perf_counter()
    text_dir = os.path.join(WORK, "eval_text")
    n_par, n_chars = write_training_text(text_dir)
    text = os.path.join(text_dir, "en.txt")
    log(f"  the repo's Markdown: {n_par} paragraphs, {n_chars} characters, one a line")
    argv = ["--data", text, "--block-size", str(EVAL_BLOCK), "--batch-size", str(EVAL_BATCH),
            "--device", card]
    source = Tokenizer.from_file(os.path.join(tinyllama_dir, "tokenizer.json"))
    target = Tokenizer.from_file(os.path.join(transferred_dir, "tokenizer.json"))
    if fast_encoder_or_none(source) is not None or fast_encoder_or_none(target) is None:
        raise AssertionError("(a) must take the general encode pipeline and (b) the fast path")

    step("(a) the perplexity CLI on TinyLlama under its own metaspace BPE")
    metrics_a, stages = timed_eval_cli(ppl_main, ["--model", tinyllama_dir] + argv)
    eval_report("a", metrics_a, stages)
    out = {"a": dict(metrics_a, **stages)}

    step("(b) the perplexity CLI on the transferred TinyLlama under llama0001")
    bias = os.path.join(transferred_dir, "bias.npy")
    extra = ["--bias", bias] if os.path.exists(bias) else []
    metrics_b, stages = timed_eval_cli(ppl_main, ["--model", transferred_dir] + argv + extra)
    eval_report("b", metrics_b, stages)
    log(f"  (b) with the transfer's lm-head bias: {bool(extra)}")
    out["b"] = dict(metrics_b, **stages)

    step(f"(c) evaluate_lm card vs CPU at {EVAL_CUT} layers, f32")
    with open(text) as f:
        texts = [line.rstrip("\n") for line in f if line.strip()]
    data = chunked_tokenize(source, texts, EVAL_BLOCK)
    data = {k: v[:4] for k, v in data.items()}
    cut_dir = write_depth_cut(tinyllama_dir, EVAL_CUT)
    results = []
    for device in (card, "cpu"):
        fn = load_causal_lm(cut_dir, device)
        results.append(evaluate_lm(fn, data, special_ids=source.all_special_ids,
                                   batch_size=EVAL_BATCH, device=device))
        del fn
        gc_free()
    on_card, cpu = results
    rel = abs(on_card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    # the char totals are not compared: both sides sum the host encode's
    # char_lengths, which the CPU tests hold against JAX
    log(f"  (c) 4 blocks of (a): loss card {on_card['loss']:.9f} CPU {cpu['loss']:.9f} (rel "
        f"{rel:.3g}, tol 1e-5); n_tokens {on_card['n_tokens']:.0f} / {cpu['n_tokens']:.0f}")
    if rel > 1e-5 or on_card["n_tokens"] != cpu["n_tokens"]:
        raise AssertionError(f"evaluate_lm differs on the card: {on_card} vs {cpu}")

    step("(d) the choice CLI on the transferred TinyLlama")
    out["d"] = {}
    for task in ("en", "code"):
        items = choice.read_items(COPA.format(task))
        n_requests = sum(len(item["choices"]) for item in items)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = choice.main(["--model", transferred_dir, "--data", COPA.format(task),
                               "--device", card])
        wall = time.perf_counter() - t0
        log(f"  (d) copa_{task}: {len(items)} items, {n_requests} requests: acc "
            f"{metrics['acc']:.4f} acc_norm {metrics['acc_norm']:.4f}; CLI wall {wall:.3f} s "
            f"({n_requests / wall:.1f} requests/s, the model's load included)")
        out["d"][task] = dict(metrics, wall_s=wall, requests=n_requests)
    requests = [(item["query"], c) for task in ("en", "code")
                for item in choice.read_items(COPA.format(task), CHOICE_CPU_ITEMS)
                for c in item["choices"]]
    cut_dir = write_depth_cut(transferred_dir, EVAL_CUT)
    scores = []
    for device in (card, "cpu"):
        fn = load_causal_lm(cut_dir, device)
        t0 = time.perf_counter()
        scores.append(choice.score_loglikelihoods(fn, target, requests, device=device))
        if device == card:
            torch.cuda.synchronize()
            log(f"  (d) score_loglikelihoods at {EVAL_CUT} layers on the card: {len(requests)} "
                f"requests in {time.perf_counter() - t0:.3f} s")
            # a control for the bound below: the same requests with TF32
            # matmuls, a precision the f32 comparison must tell apart
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                control = choice.score_loglikelihoods(fn, target, requests, device=device)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
        del fn
        gc_free()
    pairs = list(zip(*scores))
    # 1e-4 absolute, or 1e-5 of |ll| where that is more (as (c) holds the
    # loss): the random hypernet's tables give the transferred model token
    # log-probs of about -100 ((b)'s loss), so a request's ll runs to the
    # thousands, where 1e-4 is under f32's rounding of 2048-long products
    gaps = [(abs(a["ll"] - b["ll"]), max(1e-4, 1e-5 * abs(b["ll"])), b["ll"]) for a, b in pairs]
    worst = max(gaps, key=lambda g: g[0] / g[1])
    same = all((a["n_tokens"], a["n_bytes"], a["greedy"]) == (b["n_tokens"], b["n_bytes"],
                                                              b["greedy"]) for a, b in pairs)
    log(f"  (d) {len(requests)} requests ({CHOICE_CPU_ITEMS} items a task) at {EVAL_CUT} "
        f"layers, card vs CPU, f32: max |ll| gap {max(g[0] for g in gaps):.3g}, |ll| from "
        f"{min(abs(g[2]) for g in gaps):.4g} to {max(abs(g[2]) for g in gaps):.4g}; closest "
        f"to its bound: gap {worst[0]:.3g} at ll {worst[2]:.6g} (tol {worst[1]:.3g}: 1e-4 or "
        f"1e-5 x |ll|); n_tokens, n_bytes, greedy equal {same}; greedy "
        f"{sum(a['greedy'] for a, _ in pairs)} of {len(requests)}")
    over = [abs(a["ll"] - b["ll"]) / max(1e-4, 1e-5 * abs(b["ll"]))
            for a, b in zip(control, scores[1])]
    log(f"  (d) control, TF32 matmuls on the card vs the CPU's f32: max |ll| gap "
        f"{max(abs(a['ll'] - b['ll']) for a, b in zip(control, scores[1])):.3g}, worst gap over "
        f"its bound {max(over):.3g}, requests over their bound {sum(x > 1 for x in over)} of "
        f"{len(over)} (reported, not held)")
    if any(g > tol for g, tol, _ in gaps) or not same:
        raise AssertionError("score_loglikelihoods differs on the card")
    log(f"  phase 16: {time.perf_counter() - t_phase:.3f} s wall")
    return out


BASELINE_RUN = os.path.join(REPO, "configs", "baseline", "tinyllama_code_original.json")
FROM_FOCUS_RUN = os.path.join(REPO, "configs", "baseline",
                              "tinyllama_code_starcoder_from_focus.json")
NSHOT_RUN = os.path.join(REPO, "configs", "nshot", "gpt2_passthrough_ft.json")
STARCODER = os.path.join(REPO, "artifacts", "tokenizers", "starcoder0001")
BASELINE_METHODS = ("lexical", "bfvt", "focus", "ofa")
BASELINE_ROWS = 4096  # seeded target rows of (a)'s card-vs-plain comparisons
BASELINE_STEPS, FROM_FOCUS_STEPS = 3, 2
RESUME_CUT = 2  # layers of (c)'s resume check
TIE_GAP = 1e-6  # a k-th and (k+1)-th similarity this close are a tie
# the memory levers (b) tries in turn when the config's own settings run out
# of memory
FT_LEVERS = (("remat_backbone", True), ("loss_chunk_size", 32))


def compare_search(tag, card, plain, queries, keys, k):
    """Card against plain top-k sets of a similarity search, row by row: a
    row may pick other anchors only where its k-th and (k+1)-th plain
    similarities tie (within TIE_GAP). Returns the rows whose sets agree."""
    same = np.array([set(a) == set(b) for a, b in zip(card, plain)])
    ties = 0
    for r in np.nonzero(~same)[0]:
        sims = np.sort(queries[r] @ keys.T)[::-1]
        if sims[k - 1] - sims[k] > TIE_GAP:
            raise AssertionError(f"{tag}: row {r} picks other anchors on the card without a "
                                 f"tie ({sims[k - 1]} vs {sims[k]})")
        ties += 1
    log(f"  (a) {tag}: top-{k} sets equal on {int(same.sum())} of {len(same)} rows; {ties} "
        f"rows differ at a tie of the k-th similarity (within {TIE_GAP})")
    return same


def baseline_config(model_dir, out, train_dir, run=BASELINE_RUN, **overrides):
    """A baseline config with the run's reductions: the repo's Python as
    code text, no validation text (ROADMAP C.15), no periodic saves."""
    from zett_tpu_torch.training.__main__ import load_config_file

    config = load_config_file(run)
    config.update(model_dir=model_dir, output_dir=out, train_directory=train_dir,
                  valid_directory=None, extra_valid_tokenizers=[], logging_steps=1,
                  save_steps=0, eval_steps=0, eval_at_step_zero=False, num_workers=0,
                  prefetch_batches=0, steps=BASELINE_STEPS)
    config.update(overrides)
    return config


def check_losses(tag, history, steps):
    losses = [h["loss"] for h in history if "loss" in h]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: losses {losses}")
    return losses


def phase_baselines(tinyllama_dir):
    """Phase 17, the n-shot and baseline path on phase 14's TinyLlama: (a)
    the baselines CLI to starcoder0001 (lexical, bfvt, focus, ofa), FOCUS's
    and OFA's similarity search and combination card vs plain on
    BASELINE_ROWS seeded target rows; (b) the training CLI at
    tinyllama_code_original.json (passthrough tables, full fine-tuning,
    batch 32, block 512, lr 1e-6, lexical weight 0) for BASELINE_STEPS steps
    on the repo's Python, at the config's own settings first, then with the
    memory levers in turn (FT_LEVERS) where it runs out of memory, final/
    with the tables only; (c) at a RESUME_CUT-layer cut, step 2 resumed from
    a 1-step run's full state through the CLI against a 2-step run; (d)
    the training CLI at
    tinyllama_code_starcoder_from_focus.json on (a)'s FOCUS model; (e)
    --method passthrough on (d)'s final/ and the perplexity CLI on the
    written model; on (b)'s final/ the named refusal of ROADMAP C.16; (f)
    gpt2_passthrough_ft.json's named refusal (ROADMAP C.11). Launches no
    port kernel: the passthrough tables are lookups and the backbone runs
    cuBLAS and PyTorch; the search runs torch.matmul and torch.topk.
    Reductions: 3 and 2 steps (the configs: 50000); no validation text or
    extra tokenizers (C.15); (b) and (d) without a full-state save (the
    full state is (c)'s, at 2 layers); (a) (which reads the tables only),
    (c), (d) and (e) at 2 of 22 layers."""
    from zett_tpu_torch.evaluation.__main__ import main as ppl_main
    from zett_tpu_torch.models.backbones.hf_io import load_hf_state_dict
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.tokenization.convert import convert_to_byte_level
    from zett_tpu_torch.tokenization.core import Tokenizer
    from zett_tpu_torch.training.__main__ import main as train_main
    from zett_tpu_torch.transfer import baselines as tb
    from zett_tpu_torch.transfer.baselines_cli import main as baselines_main

    t_phase = time.perf_counter()
    launches_before = dict(_build.launch_counts)
    log(f"  PYTHONHASHSEED {os.environ.get('PYTHONHASHSEED')} (the char-n-gram space "
        "depends on it, ROADMAP C.13)")

    step("(a) the baselines CLI to starcoder0001")
    # the methods read the tables only: they run on a cut of the model (its
    # tables whole), as do (c), (d) and (e)
    cut = write_depth_cut(tinyllama_dir, RESUME_CUT)
    outputs = {}
    for method in BASELINE_METHODS:
        out = os.path.join(WORK, f"tinyllama_starcoder_{method}")
        t0 = time.perf_counter()
        summary = baselines_main(["--method", method, "--model", cut,
                                  "--target-tokenizer", STARCODER, "--output", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"  (a) {method} on {CARD} ({RESUME_CUT} layers): {wall:.3f} s wall; {summary['n_target']} tokens, "
            f"overlap {summary['overlap']}, rows per route {summary['routes']}, finite "
            f"{summary['finite']}")
        if not summary["finite"] or summary["routes"]["in"] != summary["routes"]["out"]:
            raise AssertionError(f"(a) {method}: {summary}")
        outputs[method] = out
    sd = load_hf_state_dict(cut)  # the tables and layers 0-1
    emb = sd["model.embed_tokens.weight"].float().numpy()
    source, _ = convert_to_byte_level(
        Tokenizer.from_file(os.path.join(tinyllama_dir, "tokenizer.json")))
    target, _ = convert_to_byte_level(
        Tokenizer.from_file(os.path.join(STARCODER, "tokenizer.json")),
        match_special_tokens_to=source, make_whitespace_consistent=True)
    rng = np.random.default_rng(SEED + 17)
    k = 10

    _, source_ids, new_ids, aux_overlap, aux_new = tb.focus_anchors(source, target, len(emb))
    rows = rng.choice(len(new_ids), min(BASELINE_ROWS, len(new_ids)), replace=False)
    q = aux_new[rows]
    same = compare_search("FOCUS", tb.top_k_similar(q, aux_overlap, k, "cuda")[0],
                          tb.top_k_similar(q, aux_overlap, k, "cpu")[0], q, aux_overlap, k)
    anchors = emb[np.asarray(source_ids)]
    (card, card_cov), (plain, plain_cov) = (tb.focus_rows(q, aux_overlap, anchors, device=d)
                                            for d in ("cuda", "cpu"))
    err = np.abs(card - plain)[same].max()
    scale = np.abs(plain).max()
    log(f"  (a) FOCUS rows card vs plain on {len(rows)} seeded new tokens: covered "
        f"{int(plain_cov.sum())}, max abs {err:.3g} at scale {scale:.3g} on the rows whose "
        f"sets agree (tol 1e-5 x scale)")
    if (card_cov != plain_cov)[same].any() or err > 1e-5 * scale:
        raise AssertionError("(a) FOCUS differs on the card")

    src_reps, src_has, tgt_reps, tgt_has = tb.ofa_anchors(source, target, len(emb))
    vocab = source.get_vocab()
    candidates = [i for i in range(len(target)) if tgt_has[i]
                  and not (vocab.get(target.id_to_token(i) or "", len(emb)) < len(emb))]
    rows = rng.choice(candidates, min(BASELINE_ROWS, len(candidates)), replace=False)
    src_ids = np.nonzero(src_has)[0]
    q, keys = tgt_reps[rows], src_reps[src_ids]
    same = compare_search("OFA", tb.top_k_similar(q, keys, k, "cuda")[0],
                          tb.top_k_similar(q, keys, k, "cpu")[0], q, keys, k)
    card, plain = (tb.ofa_rows(q, keys, emb[src_ids], None, device=d) for d in ("cuda", "cpu"))
    err = np.abs(card - plain)[same].max()
    scale = np.abs(plain).max()
    log(f"  (a) OFA rows card vs plain on {len(rows)} seeded new tokens: max abs {err:.3g} "
        f"at scale {scale:.3g} on the rows whose sets agree (tol 1e-5 x scale)")
    if err > 1e-5 * scale:
        raise AssertionError("(a) OFA differs on the card")
    for method in ("lexical", "bfvt", "ofa"):
        shutil.rmtree(outputs[method], ignore_errors=True)

    step("(b) the training CLI at tinyllama_code_original.json")
    train_dir, valid_dir = os.path.join(WORK, "code_train"), os.path.join(WORK, "code_valid")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(valid_dir, exist_ok=True)
    n_lines, _ = write_code_text(train_dir, valid_dir, ["code"])
    out_b = os.path.join(WORK, "baseline_original")
    # final/ with the tables only: the full state (13.55 GiB at 22 layers,
    # chip, PR 13) is written and resumed in (c), at a 2-layer cut
    config = baseline_config(tinyllama_dir, out_b, train_dir, save_state=False)
    shown = {key: config[key] for key in ("batch_size", "block_size", "learning_rate",
                                          "lexical_loss_weight", "backbone_training",
                                          "use_passthrough_hypernet", "max_grad_norm", "dtype")}
    log(f"  (b) {n_lines} lines of the repo's Python as langs ['code']; {shown}")
    levers = {}
    got = run_training_config(config, "baseline_original")
    for key, value in FT_LEVERS:
        if got is not None:
            break
        log(f"  (b) on {CARD}: the config's settings{' + ' if levers else ''}"
            f"{', '.join(levers)} ran out of memory; adding {key}={value}")
        levers[key] = value
        got = run_training_config(dict(config, **levers), "baseline_original")
    if got is None:
        raise AssertionError("(b) out of memory with every lever")
    trainer, history, peak_b, wall = got
    del got
    losses_b = check_losses("(b)", history, BASELINE_STEPS)
    ms = [r["device_ms"] for r in trainer.records if r["kind"] == "train"]
    rows_src = len(emb)
    moved = {}
    for name, key in (("input", "model.embed_tokens.weight"), ("output", "lm_head.weight")):
        table = getattr(trainer.hypernet, f"{name}_embeddings").weight.detach().float().cpu()
        start = torch.zeros_like(table)
        start[:rows_src] = sd[key].to(trainer.dtype).float()
        changed = table != start
        moved[f"{name} table, source rows"] = float(changed[:rows_src].float().mean())
        # informational: an input row past the source moves only where the
        # text uses its token
        moved[f"{name} table, rows past the source"] = float(changed[rows_src:].float().mean())
    last = f"model.layers.{trainer.backbone.config.num_hidden_layers - 1}.mlp.down_proj.weight"
    sd.update({last: load_hf_state_dict(tinyllama_dir)[last]})
    for key in ("model.layers.0.mlp.down_proj.weight", last):
        delta = (trainer.backbone.raw(key).detach().cpu() - sd[key].float()).abs()
        moved[key] = float((delta > 0).float().mean())
        log(f"  (b) {key}: max |change| {float(delta.max()):.3g}")
    log(f"  (b) on {CARD}: {BASELINE_STEPS} steps with levers {levers or 'none'} in {wall:.3f} "
        f"s wall (loading, conversion and final/ included); losses "
        f"{['%.4f' % x for x in losses_b]}; train steps {['%.3f' % x for x in ms]} ms (CUDA "
        f"events); peak memory {peak_b:.2f} GiB; tables {tuple(table.shape)} in "
        f"{trainer.hypernet.input_embeddings.weight.dtype}; share of elements moved {moved}")
    if not all(v > 0 for k, v in moved.items() if "past the source" not in k):
        raise AssertionError(f"(b) weights that did not move: {moved}")
    final_b = os.path.join(out_b, "final")
    batch = trainer.last_train_batch
    busy, _, _ = device_breakdown(lambda: trainer.train_step(batch), top=8)
    step_ms = float(np.median(ms[1:])) if len(ms) > 1 else ms[0]
    idle = "not measured" if busy is None else f"{1 - busy / step_ms:.3f}"
    log(f"  (b) on {CARD}: train step {step_ms:.3f} ms (median after the first), idle share "
        f"{idle} (1 - traced device busy / step)")
    del trainer, batch, table, start, changed
    gc_free()

    step(f"(c) a one-step resume at a {RESUME_CUT}-layer cut")
    # one step with its full state in final/, step 2 resumed from it
    # through the CLI, and two continuous steps through the CLI: the same
    # step-2 batch (the data replay), loss and weight (one full-state save,
    # to keep the run's disk writes small)
    weight = f"model.layers.{RESUME_CUT - 1}.mlp.down_proj.weight"
    saved = os.path.join(WORK, "baseline_step_1")
    cfg_c = baseline_config(cut, saved, train_dir, steps=1, save_state=True, **levers)
    check_losses("(c) first step", run_training_config(cfg_c, "baseline_step_1")[1], 1)
    gc_free()
    res = run_training_config(dict(cfg_c, output_dir=saved + "_resumed", steps=2,
                                   save_state=False,
                                   resume_from_checkpoint=os.path.join(saved, "final")),
                              "baseline_resumed")
    got_loss = check_losses("(c) resumed", res[1], 1)[0]
    cont = run_training_config(dict(cfg_c, output_dir=saved + "_continuous", steps=2,
                                    save_state=False), "baseline_continuous")
    ref_loss = check_losses("(c) continuous", cont[1], 2)[1]
    ref_batch, got_batch = cont[0].last_train_batch, res[0].last_train_batch
    keys = sorted(k for k, v in ref_batch.items() if hasattr(v, "shape"))
    same_batch = keys == sorted(k for k, v in got_batch.items() if hasattr(v, "shape")) and all(
        np.array_equal(np.asarray(ref_batch[k]), np.asarray(got_batch[k])) for k in keys)
    ref_w = cont[0].backbone.raw(weight).detach().cpu()
    got_w = res[0].backbone.raw(weight).detach().cpu()
    w_err = float((got_w - ref_w).abs().max())
    log(f"  (c) step 2 continuous vs resumed from step 1's full state: batch {keys} equal "
        f"{same_batch}; loss {ref_loss!r} vs {got_loss!r}; {weight} max abs {w_err:.3g} "
        f"(bit-equal {bool(torch.equal(got_w, ref_w))})")
    del cont, res, ref_batch, got_batch
    if not same_batch or abs(got_loss - ref_loss) > 1e-6 * abs(ref_loss) or w_err > 1e-6:
        raise AssertionError("(c) the resumed step differs")
    gc_free()

    step("(d) the training CLI at tinyllama_code_starcoder_from_focus.json")
    out_d = os.path.join(WORK, "baseline_from_focus")
    cfg_d = baseline_config(outputs["focus"], out_d, train_dir, run=FROM_FOCUS_RUN,
                            steps=FROM_FOCUS_STEPS, save_state=False, **levers)
    got = run_training_config(cfg_d, "baseline_from_focus")
    if got is None:
        raise AssertionError("(d) out of memory")
    trainer, history, peak, wall = got
    del got
    losses = check_losses("(d)", history, FROM_FOCUS_STEPS)
    log(f"  (d) on {CARD}: {FROM_FOCUS_STEPS} steps on the FOCUS model "
        f"({trainer.hypernet.input_embeddings.weight.shape[0]} table rows) in {wall:.3f} s "
        f"wall; losses {['%.4f' % x for x in losses]}; train steps "
        f"{['%.3f' % r['device_ms'] for r in trainer.records]} ms; peak {peak:.2f} GiB")
    del trainer
    gc_free()

    step("(e) --method passthrough, then the perplexity CLI")
    out_e = os.path.join(WORK, "tinyllama_passthrough")
    t0 = time.perf_counter()
    summary = baselines_main(["--method", "passthrough", "--checkpoint",
                              os.path.join(out_d, "final"), "--model", outputs["focus"],
                              "--target-tokenizer", STARCODER, "--output", out_e])
    log(f"  (e) passthrough from (d)'s final/: {summary['n_target']} tokens in "
        f"{time.perf_counter() - t0:.3f} s wall, finite {summary['finite']}")
    try:
        baselines_main(["--method", "passthrough", "--checkpoint", final_b, "--model",
                        cut, "--target-tokenizer", tinyllama_dir, "--output",
                        os.path.join(WORK, "tinyllama_passthrough_original")])
        raise AssertionError("(e) (b)'s tables were sliced to a tokenizer they were not "
                             "trained on")
    except ValueError as exc:
        if "C.16" not in str(exc):
            raise
        log(f"  (e) on (b)'s final/: {str(exc)[:150]}...")
    shutil.rmtree(os.path.join(WORK, "tinyllama_passthrough_original"), ignore_errors=True)
    text = os.path.join(WORK, "passthrough_eval.txt")
    tok = Tokenizer.from_file(os.path.join(out_e, "tokenizer.json"))
    lines, n = [], 0
    with open(os.path.join(train_dir, "code.txt")) as f:
        for line in f:
            lines.append(line.rstrip("\n"))
            n += len(tok.encode(lines[-1], add_special_tokens=False).ids)
            if n >= 4 * 512 + 256:
                break
    with open(text, "w") as f:
        f.write("\n".join(lines) + "\n")
    metrics, stages = timed_eval_cli(ppl_main, ["--model", out_e, "--data", text,
                                                "--block-size", "512", "--batch-size", "4"])
    blocks = int(metrics["n_tokens"]) // 511  # a block of 512 scores 511 next tokens
    log(f"  (e) the perplexity CLI on the passthrough model: {int(metrics['n_tokens'])} scored "
        f"tokens ({blocks} blocks of 512), loss {metrics['loss']:.4f}, "
        f"{stages['wall_s']:.3f} s wall")
    if blocks < 4 or not math.isfinite(metrics["loss"]):
        raise AssertionError(f"(e) {metrics}")

    step("(f) gpt2_passthrough_ft.json")
    try:
        train_main([NSHOT_RUN])
        raise AssertionError("(f) the nshot config trained")
    except ValueError as exc:
        if "C.11" not in str(exc):
            raise
        log(f"  (f) refused before any step: {str(exc)[:120]}...")
    if dict(_build.launch_counts) != launches_before:
        raise AssertionError("phase 17 launched a port kernel")
    log(f"  phase 17: {time.perf_counter() - t_phase:.3f} s wall; no port kernel launched")
    return {"step_ms": step_ms, "peak_gib": peak_b, "levers": levers,
            "wall_s": time.perf_counter() - t_phase}


# --------------------------------------------------------------------- phase 18
# xlm-roberta-base's published config.json (HF hub; named here, not fetched):
# the weights are random, from a seed
XLMR = dict(
    model_type="xlm-roberta", architectures=["XLMRobertaForMaskedLM"], vocab_size=250002,
    hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
    max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5, pad_token_id=1,
    bos_token_id=0, eos_token_id=2, hidden_act="gelu", hidden_dropout_prob=0.1,
    attention_probs_dropout_prob=0.1, initializer_range=0.02,
    position_embedding_type="absolute",
)
XLMR_RUN = os.path.join(REPO, "configs", "zeroshot", "xlmr_26l.json")
XLMR_SPECIALS = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}  # and <mask> last, as XLM-R
# code points of the scripts of 26l.txt's languages: Latin (with its
# accented letters), Cyrillic, Greek, Hangul, Arabic (Arabic and Urdu),
# Devanagari, Bengali, Tamil, Telugu
XLMR_SCRIPTS = ((0x61, 0x7A), (0xE0, 0xFF), (0x430, 0x44F), (0x3B1, 0x3C9), (0xAC00, 0xD7A3),
                (0x621, 0x64A), (0x915, 0x939), (0x995, 0x9B9), (0xB95, 0xBB9), (0xC15, 0xC39))


def xlmr_tokenizer_json(n_vocab=250002, seed=SEED + 30):
    """An XLM-R-shaped tokenizer.json with exactly ``n_vocab`` ids: a Unigram
    model (<s> 0, <pad> 1, </s> 2, <unk> 3, <mask> last), a Metaspace
    pre-tokenizer ("▁", prepend always), the normalizer Replace(" {2,}", " ")
    (XLM-R's Precompiled charsmap exists in neither package), the
    post-processor <s> $A </s> and the Metaspace decoder. Pieces: those of
    the repo's artifact tokenizers decoded to metaspace text (spaces as
    "▁"; pieces that are not whole UTF-8 characters left out), then seeded
    synthetic pieces of 1-6 letters of one script each (with "▁" in front
    half the time); scores decrease with the id. Standard library and numpy
    only."""
    import glob

    from zett_tpu_torch.tokenization.bytemaps import CHARS_TO_BYTES

    pieces = list(XLMR_SPECIALS)
    seen = set(pieces) | {"<mask>"}
    for path in sorted(glob.glob(os.path.join(REPO, "artifacts", "tokenizers", "*",
                                              "tokenizer.json"))):
        with open(path) as f:
            model = json.load(f)["model"]
        vocab = model["vocab"]
        tokens = ([t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
                  if isinstance(vocab, dict) else [t for t, _ in vocab])
        for token in tokens:
            try:
                piece = bytes(CHARS_TO_BYTES[c] for c in token).decode("utf-8")
            except (KeyError, UnicodeDecodeError):
                continue
            piece = piece.replace(" ", "▁")
            if piece and piece not in seen and len(pieces) < n_vocab - 1:
                pieces.append(piece)
                seen.add(piece)
    n_real = len(pieces) - len(XLMR_SPECIALS)
    rng = np.random.default_rng(seed)
    while len(pieces) < n_vocab - 1:
        lo, hi = XLMR_SCRIPTS[int(rng.integers(len(XLMR_SCRIPTS)))]
        n = int(rng.integers(1, 7))
        piece = ("▁" if rng.random() < 0.5 else "") + "".join(
            chr(int(c)) for c in rng.integers(lo, hi + 1, size=n))
        if piece not in seen:
            pieces.append(piece)
            seen.add(piece)
    pieces.append("<mask>")
    vocab = [[p, 0.0] for p in pieces[:len(XLMR_SPECIALS)]]
    vocab += [[p, -2.0 - 14.0 * i / n_vocab] for i, p in enumerate(pieces[len(XLMR_SPECIALS):-1])]
    vocab.append(["<mask>", 0.0])
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True}
             for i, t in ((i, pieces[i]) for i in (0, 1, 2, 3, n_vocab - 1))]
    meta = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True}
    data = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        "pre_tokenizer": meta,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": {"id": "</s>", "type_id": 1}}],
            "special_tokens": {t: {"id": t, "ids": [XLMR_SPECIALS[t]], "tokens": [t]}
                               for t in ("<s>", "</s>")}},
        "decoder": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                    "split": True},
        "model": {"type": "Unigram", "unk_id": 3, "vocab": vocab, "byte_fallback": False},
    }
    return data, n_real
XLMR_BATCH, XLMR_VOCAB_SAMPLE = 128, 32768  # the config's, kept
XLMR_STEPS, XLMR_IDENT = 4, 1  # 1 identity step and 3 train steps
# held-out paragraphs a language (n_valid_subsample, cut from 4000; 32 before phase 19)
XLMR_VALID = 16
XLMR_CUT = 2  # layers of (c)'s lever comparison and (e)'s card-vs-CPU probe
XLMR_LEVERS = dict(remat_backbone=True, loss_chunk_size=32)
XLMR_PROBE_TEXTS = 64  # held-out paragraphs (e) scores (32 of them at the cut, card vs CPU)
XLMR_PROBE_BLOCK = 128
ROBERTA0001 = os.path.join(REPO, "artifacts", "tokenizers", "roberta0001")


def write_xlmr(path, seed=SEED + 31):
    """The XLM-R directory: XLMR as config.json, seeded random weights
    drawn on the card (tables and projections N(0, 0.02), LayerNorm scales 1
    and biases 0, the lm-head bias 0) written as f32 model.safetensors (with
    the decoder's bias and the position_ids buffer; the decoder's weight is
    the word table's, left out as HF leaves out tied weights), and
    ``xlmr_tokenizer_json``. Returns (the config, the state dict, the
    tokenizer's pieces taken from the repo)."""
    from zett_tpu_torch.models.backbones.hf_io import save_hf_model
    from zett_tpu_torch.models.backbones.roberta import RobertaConfig, weight_keys

    cfg = RobertaConfig.from_hf(XLMR)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tables = {"word_embeddings": V, "position_embeddings": cfg.max_position_embeddings,
              "token_type_embeddings": cfg.type_vocab_size}
    sd = {}
    for key in weight_keys(cfg):
        module, leaf = key.rsplit(".", 1)
        width = (I if module.endswith("intermediate.dense") else
                 V if key == "lm_head.bias" else H)
        if "LayerNorm" in module or "layer_norm" in module or leaf == "bias":
            sd[key] = torch.full((width,), 1.0 if leaf == "weight" else 0.0)
            continue
        name = module.split(".")[-1]
        if name in tables:
            shape = (tables[name], H)
        elif module.endswith("intermediate.dense"):
            shape = (I, H)
        elif module.endswith(".output.dense") and ".attention." not in module:
            shape = (H, I)
        else:
            shape = (H, H)
        sd[key] = (0.02 * torch.randn(shape, generator=gen, device="cuda")).cpu()
    sd["lm_head.decoder.bias"] = sd["lm_head.bias"]
    sd["roberta.embeddings.position_ids"] = torch.arange(cfg.max_position_embeddings)[None]
    save_hf_model(path, sd, XLMR)
    data, n_real = xlmr_tokenizer_json(cfg.vocab_size)
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(data, f, ensure_ascii=False)
    return cfg, sd, n_real


def xlmr_cut_state(sd, n_layers):
    """``sd`` without the layers from ``n_layers`` on."""
    return {k: v for k, v in sd.items()
            if not k.startswith("roberta.encoder.layer.") or int(k.split(".")[3]) < n_layers}


def write_language_text(train_dir, valid_dir, langs):
    """<lang>.txt for each of ``langs``: phase 7's Markdown paragraphs, every
    8th held out into ``valid_dir`` (the same text in every language).
    Returns (training, held-out) paragraph counts."""
    n_train, n_held = write_training_text(train_dir, valid_dir, hold_out_every=8)
    for lang in langs:
        if lang != "en":
            for d in (train_dir, valid_dir):
                shutil.copy(os.path.join(d, "en.txt"), os.path.join(d, f"{lang}.txt"))
    return n_train, n_held


def phase_xlmr():
    """XLM-R base through the MLM path: (a) the model directory and its
    tokenizer's byte-level conversion; (b) the backbone card vs CPU; (c)
    the training CLI at configs/zeroshot/xlmr_26l.json and the levers at a
    2-layer cut; (d) the transfer CLI to roberta0001 from (c)'s final/; (e)
    mlm_probe on (d)'s model."""
    from zett_tpu_torch.models.backbones.roberta import RobertaForMaskedLM
    from zett_tpu_torch.tokenization.convert import convert_to_byte_level
    from zett_tpu_torch.tokenization.core import Tokenizer

    t_phase = time.perf_counter()
    model_dir = os.path.join(WORK, "xlmr")
    cfg, sd, n_real, written_s = PREPARED.pop("xlmr")
    n_params = sum(t.numel() for k, t in sd.items()
                   if k not in ("lm_head.decoder.bias", "roberta.embeddings.position_ids"))
    t0 = time.perf_counter()
    source = Tokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    converted, n_added = convert_to_byte_level(source)
    convert_s = time.perf_counter() - t0
    log(f"  (a) wrote xlm-roberta-base's published config ({n_params} parameters, f32, "
        f"{os.path.getsize(os.path.join(model_dir, 'model.safetensors')) / 2**30:.3f} GiB) and a "
        f"{len(source)}-id Unigram-Metaspace tokenizer ({n_real} pieces from the repo's "
        f"tokenizers, the rest synthetic) in {written_s:.3f} s, while the kernels built; "
        f"loading the tokenizer {load_s:.3f} s; the byte-level conversion: {len(converted)} "
        f"tokens, n_added_tokens {n_added}, {convert_s:.3f} s on the host; the hypernet's "
        f"vocab_size {len(converted) + 256}")
    if len(source) != cfg.vocab_size or source.token_to_id("<mask>") != cfg.vocab_size - 1 \
            or converted.token_to_id("<mask>") is None:
        raise AssertionError(f"tokenizer: {len(source)} ids, <mask> at "
                             f"{source.token_to_id('<mask>')}")

    step("(b) the backbone card vs CPU")
    # the frozen backbone's bf16 weights, computed in f32 on both sides
    held = {k: (v.to(torch.bfloat16) if v.is_floating_point() else v) for k, v in sd.items()}
    rng = np.random.default_rng(SEED + 32)
    ids = torch.from_numpy(rng.integers(4, cfg.vocab_size - 1, size=(2, 64)))
    ids[:, 0] = 0
    mask = torch.ones(2, 64, dtype=torch.long)
    ids[1, 47], ids[1, 48:], mask[1, 48:] = 2, cfg.pad_token_id, 0
    with torch.no_grad():
        ref = RobertaForMaskedLM(cfg, held, torch.float32).mlm_logits(ids, mask)
        card = RobertaForMaskedLM(cfg, held, torch.float32).cuda()
        got = card.mlm_logits(ids.cuda(), mask.cuda()).cpu()
        del card
    gc_free()
    valid = mask.bool()
    err = float((got - ref).abs()[valid].max())
    scale = float(ref.abs()[valid].max())
    log(f"  (b) XLM-R MLM logits (2, 64, {cfg.vocab_size}) at full depth, bf16 weights, f32, "
        f"a padded row: card vs CPU max abs {err:.3g} at logit scale {scale:.3g} (tol 1e-4 x "
        f"scale)")
    if not bool(torch.isfinite(got).all()) or err > 1e-4 * scale:
        raise AssertionError(f"the RoBERTa backbone differs on the card: {err}")
    del ref, got, held

    step("(c) the training CLI at xlmr_26l.json")
    train = phase_xlmr_training(model_dir, sd)
    step("(d) the transfer CLI to roberta0001")
    transfer = phase_xlmr_transfer(model_dir, train["final"])
    step("(e) mlm_probe on the transferred model")
    probe = phase_xlmr_probe(transfer["out"], train["held_out"])
    wall = time.perf_counter() - t_phase
    log(f"  phase 18: {wall:.3f} s wall")
    return dict(train=train, transfer=transfer, probe=probe, wall=wall)


def phase_xlmr_training(model_dir, sd):
    """(c) python -m zett_tpu_torch.training at configs/zeroshot/xlmr_26l.json
    through its ``main``: batch 128, block 128, vocab sample 32768 and every
    width kept; 26 languages of the repo's Markdown drawn by corpus size
    (the MADLAD metadata at alpha 0.1); 1 identity step and 3 train steps,
    eval at step 0 and at the last step over the four extra_valid_tokenizers
    and sampled validation tokenizers on held-out paragraphs
    (n_valid_subsample cut to XLMR_VALID), final/ without the optimizer
    state (the transfer reads the parameters). Then the levers: the run's first
    two train batches through two steps of a Trainer at a 2-layer cut of the
    backbone, with loss_chunk_size 32 and remat_backbone and without."""
    from zett_tpu_torch.data.datasets import (language_probs_from_sizes,
                                              language_sizes_from_metadata)
    from zett_tpu_torch.models.backbones.roberta import RobertaConfig
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.training import engine
    from zett_tpu_torch.training.__main__ import load_config_file, load_language_list
    from zett_tpu_torch.training.__main__ import main as train_main

    config = load_config_file(XLMR_RUN)
    langs, _ = load_language_list(os.path.join(REPO, config["langs"]))
    csv = os.path.join(REPO, config["language_metadata_csv"])
    probs = language_probs_from_sizes(language_sizes_from_metadata(langs, csv),
                                      config["language_sampling_alpha"])
    if config["batch_size"] != XLMR_BATCH or config["tokenizer_sample_max"] != \
            XLMR_VOCAB_SAMPLE or config["loss"] != "mlm" or not config["learnable_bias"]:
        raise AssertionError("the xlmr_26l config changed")
    train_dir, valid_dir = os.path.join(WORK, "xlmr_train"), os.path.join(WORK, "xlmr_valid")
    n_train, n_held = write_language_text(train_dir, valid_dir, langs)
    out = os.path.join(WORK, "xlmr_out")
    shutil.rmtree(out, ignore_errors=True)
    steps, n_ident = XLMR_STEPS, XLMR_IDENT
    tokenizers = [os.path.join(REPO, t) for t in config["extra_valid_tokenizers"]]
    reduced = dict(model_dir=model_dir, train_directory=train_dir, valid_directory=valid_dir,
                   output_dir=out, steps=steps, identity_steps=n_ident, warmup_steps=[1, 2],
                   random_warmup_steps=0, logging_steps=1, save_steps=0, save_state=False,
                   num_workers=0, prefetch_batches=0, eval_steps=steps, eval_at_step_zero=True,
                   n_valid_subsample=XLMR_VALID, langs=os.path.join(REPO, config["langs"]),
                   language_metadata_csv=csv, extra_valid_tokenizers=tokenizers)
    config.update(reduced)
    log(f"  (c) {len(langs)} languages, each {n_train} training and {n_held} held-out "
        f"paragraphs of the repo's Markdown, drawn with probabilities (MADLAD n_pages ^ "
        f"{config['language_sampling_alpha']}) " + ", ".join(
            f"{lang} {p:.4f}" for lang, p in zip(langs, probs)))
    shown = {k: v for k, v in reduced.items()
             if k not in ("extra_valid_tokenizers", "langs", "language_metadata_csv")}
    log(f"  (c) batch {config['batch_size']}, block {config['block_size']}, vocab sample "
        f"{config['tokenizer_sample_max']}; overrides {shown}")
    config_path = os.path.join(WORK, "xlmr_smoke.json")
    with open(config_path, "w") as f:
        json.dump(config, f)

    passes, batches = [0], []
    orig_embed, orig_step = engine.Trainer.compute_embeddings, engine.Trainer._train_step

    def counted_embed(self, b):
        passes[0] += 1
        return orig_embed(self, b)

    def kept_step(self, b):
        if len(batches) < 2:
            batches.append(b)
        return orig_step(self, b)

    engine.Trainer.compute_embeddings, engine.Trainer._train_step = counted_embed, kept_step
    gc_free()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        trainer, history = train_main([config_path])
    finally:
        engine.Trainer.compute_embeddings, engine.Trainer._train_step = orig_embed, orig_step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    n_layers = trainer.hn_config.num_hidden_layers
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    eval_rows = [r for r in rows if any(k.startswith("eval") for k in r)]
    train_rows = [r for r in rows if r not in eval_rows]
    losses = [r.get("loss", r.get("identity_loss")) for r in train_rows]
    log(f"  (c) {steps} steps ({n_ident} identity) in {wall:.3f} s wall (loading, the "
        f"conversion, samplers and evals included); logged losses "
        f"{['%.4f' % x for x in losses]}")
    if len(train_rows) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bad training rows {train_rows}")
    names = [f"eval_{os.path.basename(t)}" for t in tokenizers] + ["eval"]
    if [r.get("step", 0) for r in eval_rows] != [0, steps]:
        raise AssertionError(f"eval rows at steps {[r.get('step') for r in eval_rows]}")
    for r in eval_rows:
        for name in names:
            for metric in ("eval_loss", "eval_accuracy"):
                v = r.get(f"{name}/{metric}")
                if v is None or not math.isfinite(v):
                    raise AssertionError(f"eval row {r.get('step', 0)}: {name}/{metric} = {v}")
        log(f"  (c) eval at step {r.get('step', 0)} (labels unmasked, ROADMAP C.19): " + ", ".join(
            f"{n} loss {r[n + '/eval_loss']:.4f} accuracy {r[n + '/eval_accuracy']:.4f}"
            for n in names))
    expected = dict.fromkeys(_build.launch_counts, 0)
    expected["attention_core"] = steps * n_layers + passes[0]
    expected["attention_core_bwd"] = steps * n_layers
    expected["encoder_layer"] = passes[0] * (n_layers - 1)
    log(f"  (c) launches {launches} (expected {expected}: kernels 2 and 3 {n_layers} times a "
        f"step, kernel 1 {n_layers - 1} times and kernel 2 once an eval pass; "
        f"{passes[0]} eval embedding passes)")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")

    # the masked share of the last train batch's non-special labels
    batch = trainer.last_train_batch
    labels, ids = np.asarray(batch["labels"]), np.asarray(batch["input_ids"])
    picked = labels != -100
    original = np.where(picked, labels, ids)
    special = np.isin(original, np.asarray(batch["special_indices"]))
    attended = np.asarray(batch["attention_mask"]) == 1
    share = picked.sum() / (attended & ~special).sum()
    log(f"  (c) the last train batch ({batch['lang_code']}): {int(picked.sum())} masked of "
        f"{int((attended & ~special).sum())} non-special attended positions, share "
        f"{share:.4f} (expected near 0.15)")
    if not 0.13 < share < 0.17 or (picked & ~attended).any():
        raise AssertionError(f"masked share {share}")

    recs = trainer.records
    train_ms = [r["device_ms"] for r in recs if r["kind"] == "train"][1:]
    ident_ms = [r["device_ms"] for r in recs if r["kind"] == "identity"]
    trainer.train_step(batch)  # warm the exact shapes, outside the counted run
    busy, _, _ = device_breakdown(lambda: trainer.train_step(batch), top=10)
    step_ms = float(np.median(train_ms))
    idle = None if busy is None else 1 - busy / step_ms
    log(f"  (c) on {CARD}: train step {step_ms:.3f} ms (CUDA events, median of "
        f"{['%.3f' % x for x in train_ms]}); identity step {['%.3f' % x for x in ident_ms]} ms; "
        f"idle share of a train step "
        f"{'not measured' if idle is None else f'{idle:.3f}'} (1 - traced device busy / step "
        f"span); peak memory {peak_gb:.2f} GiB")
    hn_config, train_cfg = trainer.hn_config, trainer.cfg
    del trainer, batch
    gc_free()

    # the levers at a 2-layer cut on the run's first two train batches
    cut_cfg = dataclasses.replace(RobertaConfig.from_hf(XLMR), num_hidden_layers=XLMR_CUT)
    cut_sd = xlmr_cut_state(sd, XLMR_CUT)
    results = {}
    for name, levers in (("plain", {}), ("levers", XLMR_LEVERS)):
        cfg = dataclasses.replace(train_cfg, steps=2, identity_steps=0, **levers)
        tr = engine.Trainer(hn_config=hn_config, backbone_config=cut_cfg, backbone_state=cut_sd,
                            model_type="xlm-roberta", train_config=cfg, device="cuda",
                            hn_pad_token_id=hn_config.pad_token_id)
        torch.cuda.reset_peak_memory_stats()
        results[name] = ([tr._train_step(b)["loss"] for b in batches],
                         torch.cuda.max_memory_allocated() / 2**30)
        del tr
        gc_free()
    ref = results["plain"][0]
    dl = loss_gap(results["levers"][0], ref)
    # phase 13(a)'s limit for the chunked loss (its plain runs repeat bit for
    # bit on the card, so the card's own gap adds nothing to it)
    tol = LEVER_LOSS_TOL
    log(f"  (c) at {XLMR_CUT} layers, the run's first two train batches: plain losses "
        f"{['%.6f' % x for x in ref]} (peak {results['plain'][1]:.2f} GiB); with {XLMR_LEVERS} "
        f"{['%.6f' % x for x in results['levers'][0]]} (peak {results['levers'][1]:.2f} GiB): "
        f"largest loss difference {dl:.3e} (limit {tol:.3e}, phase 13(a)'s), relative")
    if dl > tol or not all(math.isfinite(x) for x in results["levers"][0]):
        raise AssertionError("the levers differ from the plain run under MLM")
    del batches
    gc_free()
    held = [line.rstrip("\n") for line in open(os.path.join(valid_dir, "en.txt")) if line.strip()]
    return dict(launches=launches, step_ms=step_ms, idle=idle, peak_gb=peak_gb, wall=wall,
                share=share, final=os.path.join(out, "final"), held_out=held)


def phase_xlmr_transfer(model_dir, checkpoint):
    """(d) python -m zett_tpu_torch.transfer from (c)'s final/ to roberta0001
    (32773 tokens): the rows, the tied decoder, both lm-head biases zero,
    bias.npy, the written model's logits through the port's
    RobertaForMaskedLM; the hypernet per 32k vocab over the CLI's own
    batches, kernel 1's launches, the idle share."""
    from zett_tpu_torch.models.backbones.hf_io import load_hf_state_dict
    from zett_tpu_torch.models.backbones.roberta import RobertaConfig, RobertaForMaskedLM
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.tokenization.core import Tokenizer
    from zett_tpu_torch.transfer.__main__ import main as transfer_main

    out = os.path.join(WORK, "xlmr_roberta0001")
    batch = 16384
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with captured_transfer() as captured:
        transfer_main(["--checkpoint", checkpoint, "--model", model_dir,
                       "--target-tokenizer", ROBERTA0001, "--output", out,
                       "--batch-size", str(batch), "--seed", str(SEED)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)

    target = Tokenizer.from_file(os.path.join(out, "tokenizer.json"))
    with open(os.path.join(out, "config.json")) as f:
        written = json.load(f)
    sd = load_hf_state_dict(out)
    table = sd["roberta.embeddings.word_embeddings.weight"]
    n, width = len(target), XLMR["hidden_size"]
    bias_npy = np.load(os.path.join(out, "bias.npy"))
    log(f"  (d) transfer to roberta0001: {n} tokens in {wall:.3f} s wall; word_embeddings "
        f"{tuple(table.shape)}, config vocab_size {written['vocab_size']}; decoder equal to "
        f"the table {torch.equal(sd['lm_head.decoder.weight'], table)}; lm_head.bias and "
        f"lm_head.decoder.bias zero {not sd['lm_head.bias'].any()} "
        f"{not sd['lm_head.decoder.bias'].any()}; bias.npy {bias_npy.shape}, finite "
        f"{bool(np.isfinite(bias_npy).all())}")
    if n != 32773 or table.shape != (n, width) or written["vocab_size"] != n \
            or not torch.equal(sd["lm_head.decoder.weight"], table) \
            or sd["lm_head.bias"].any() or sd["lm_head.decoder.bias"].any() \
            or bias_npy.shape != (n,) or not bool(torch.isfinite(table).all()):
        raise AssertionError("the transferred XLM-R is not as the JAX CLI writes it")
    with open(os.path.join(checkpoint, "hn_config.json")) as f:
        n_layers = json.load(f)["num_hidden_layers"]
    n_batches = -(-n // batch)
    expected = dict.fromkeys(_build.launch_counts, 0)
    expected["encoder_layer"] = n_batches * (n_layers - 1)
    expected["attention_core"] = n_batches
    log(f"  (d) launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")

    cfg = RobertaConfig.from_hf(written)
    ids = torch.from_numpy(np.random.default_rng(SEED + 33).integers(4, n, size=(2, 64))).cuda()
    with torch.no_grad():
        model = RobertaForMaskedLM(cfg, sd, torch.bfloat16).cuda()
        logits = model.mlm_logits(ids, torch.ones_like(ids))
    if logits.shape != (2, 64, n) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"the written model's logits: {tuple(logits.shape)}")
    log(f"  (d) the written model loads through the port's RobertaForMaskedLM (bf16): logits "
        f"{tuple(logits.shape)}, finite, max |logit| {float(logits.float().abs().max()):.4g}")
    del model, sd, logits
    gc_free()

    run, ms, times, n_vocab, shapes = timed_passes(captured, 5)
    log(f"  (d) on {CARD}: hypernet median of 5 passes {ms:.3f} ms (min {min(times):.3f}, max "
        f"{max(times):.3f}) for the {n_vocab}-token vocab in batches {shapes} "
        f"({ms * 32768 / n_vocab:.3f} ms per 32k vocab)")
    busy, pass_wall, _ = device_breakdown(run, top=6)
    del run, captured
    gc_free()
    return dict(launches=launches, wall=wall, ms_per_32k=ms * 32768 / n_vocab, out=out,
                idle=None if busy is None else 1 - busy / pass_wall)


def phase_xlmr_probe(model_dir, held_out):
    """(e) mlm_probe on (d)'s model (f32) under its tokenizer (roberta0001,
    converted) over XLMR_PROBE_TEXTS held-out paragraphs; then at a 2-layer
    cut, card vs CPU on half of them."""
    from zett_tpu_torch.evaluation import mlm_probe
    from zett_tpu_torch.models.backbones.hf_io import load_hf_state_dict
    from zett_tpu_torch.models.backbones.roberta import RobertaConfig, RobertaForMaskedLM
    from zett_tpu_torch.tokenization.core import Tokenizer

    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = RobertaConfig.from_hf(json.load(f))
    sd = load_hf_state_dict(model_dir)
    tok = Tokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))
    texts = held_out[:XLMR_PROBE_TEXTS]
    with torch.no_grad():
        model = RobertaForMaskedLM(cfg, sd, torch.float32).cuda()
    t0 = time.perf_counter()
    full = mlm_probe(model, tok, texts, block_size=XLMR_PROBE_BLOCK, batch_size=8, seed=SEED)
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    del model
    gc_free()
    log(f"  (e) mlm_probe at full depth (f32) over {len(texts)} held-out paragraphs, block "
        f"{XLMR_PROBE_BLOCK}: "
        f"mlm_loss {full['mlm_loss']:.4f}, mlm_accuracy {full['mlm_accuracy']:.4f}, n_masked "
        f"{full['n_masked']:.0f} in {probe_s:.3f} s")
    if not (math.isfinite(full["mlm_loss"]) and full["n_masked"] > 0):
        raise AssertionError(f"mlm_probe: {full}")

    cut = dataclasses.replace(cfg, num_hidden_layers=XLMR_CUT)
    cut_sd = xlmr_cut_state(sd, XLMR_CUT)
    half = texts[:max(1, len(texts) // 2)]
    got = {}
    for dev in ("cuda", "cpu"):
        with torch.no_grad():
            model = RobertaForMaskedLM(cut, cut_sd, torch.float32).to(dev)
        got[dev] = mlm_probe(model, tok, half, block_size=XLMR_PROBE_BLOCK, batch_size=8,
                             seed=SEED)
        del model
    gc_free()
    a, b = got["cuda"], got["cpu"]
    rel = abs(a["mlm_loss"] - b["mlm_loss"]) / abs(b["mlm_loss"])
    log(f"  (e) at {XLMR_CUT} layers over {len(half)} paragraphs, card vs CPU (f32): mlm_loss "
        f"{a['mlm_loss']:.6f} vs {b['mlm_loss']:.6f} (relative {rel:.3g}, tol 1e-5), accuracy "
        f"{a['mlm_accuracy']:.6f} vs {b['mlm_accuracy']:.6f}, n_masked {a['n_masked']:.0f} vs "
        f"{b['n_masked']:.0f}")
    if rel > 1e-5 or a["n_masked"] != b["n_masked"] or a["mlm_accuracy"] != b["mlm_accuracy"]:
        raise AssertionError("mlm_probe differs on the card")
    return dict(full=full, probe_s=probe_s, cut=got)


# -------------------------------------------------------------------- phase 19
# reference-format hypernet checkpoints (the reference's HF save layout:
# config.json with the hn_* arguments, flax_model.msgpack in the reference's
# names), written here by a small msgpack writer (the port has none) and
# read by the port's load_reference_hypernet
LLAMA0001 = os.path.join(REPO, "artifacts", "tokenizers", "llama0001", "tokenizer.json")
REF_LAYERS = {"tinyllama": 3, "mistral": 2}  # hypernet layers of (a) and (b)
VARIANT_ROWS = 4096  # surface forms of (d)'s card-vs-CPU checks
VARIANT_LAYERS = 2
ADAPTER_DIM = 64  # (d)'s language-adapter bottleneck


def _mp_uint(n):
    for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32)):
        if n < 128:
            return bytes([n])
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    return b"\xcf" + struct.pack(">Q", n)


def _mp_sized(n, fix, fix_max, codes):
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit
    (``codes`` holds the codes that exist, None where a width does not)."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n}")


def _mp_str(s):
    b = s.encode()
    return _mp_sized(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b


def write_msgpack(f, tree):
    """flax's msgpack layout of a tree of dicts with array leaves: maps
    with str keys, each leaf flax's ndarray ext (type 1: a msgpack array of
    shape, dtype name and the raw bytes). numpy leaves, or torch bf16
    tensors for "bfloat16". Leaves past flax's 1 GiB chunk size are not
    written here."""
    if isinstance(tree, dict):
        f.write(_mp_sized(len(tree), 0x80, 16, (None, 0xDE, 0xDF)))
        for k, v in tree.items():
            f.write(_mp_str(k))
            write_msgpack(f, v)
        return
    if isinstance(tree, torch.Tensor):
        name, data = "bfloat16", tree.contiguous().view(torch.int16).numpy()
    else:
        data = np.ascontiguousarray(tree)
        name = data.dtype.name
    if data.nbytes > 1 << 30:
        raise ValueError("a leaf past flax's MAX_CHUNK_SIZE")
    head = (b"\x93" + _mp_sized(data.ndim, 0x90, 16, (None, 0xDC, 0xDD))
            + b"".join(_mp_uint(int(n)) for n in data.shape) + _mp_str(name)
            + _mp_sized(data.nbytes, None, 0, (0xC4, 0xC5, 0xC6)))
    f.write(_mp_sized(len(head) + data.nbytes, None, 0, (0xC7, 0xC8, 0xC9)) + b"\x01" + head)
    f.write(memoryview(data).cast("B"))


# The reference's own parameter names, HF FlaxRobertaModel's and
# FlaxT5EncoderModel's paths with the reference's hypernet extensions, typed
# here rather than taken from the port's rename tables: a wrong entry there
# then fails on the card as well as in the CPU tests. Port name (under
# encoder/ or encoder/layer_N/) -> the reference's (under model/embeddings/
# or model/encoder/{layer,block}/N/).
REF_EMBED_NAMES = {"word_embeddings": ("embeddings", "word_embeddings"),
                   "embeddings_ln": ("embeddings", "LayerNorm"),
                   "prior_projection": ("embeddings", "target_priors_projection"),
                   "lang_embedding": ("embeddings", "lang_embedding")}
REF_LAYER_NAMES = {
    ("attention", "query"): ("attention", "self", "query"),
    ("attention", "key"): ("attention", "self", "key"),
    ("attention", "value"): ("attention", "self", "value"),
    ("attention", "out"): ("attention", "output", "dense"),
    ("attention_ln",): ("attention", "output", "LayerNorm"),
    ("intermediate",): ("intermediate", "dense"),
    ("output",): ("output", "dense"),
    ("output_ln",): ("output", "LayerNorm"),
    ("lang_adapter_down_weights",): ("output", "lang_adapter_down_weights"),
    ("lang_adapter_down_bias",): ("output", "lang_adapter_down_bias"),
    ("lang_adapter_up_weights",): ("output", "lang_adapter_up_weights"),
    ("lang_adapter_up_bias",): ("output", "lang_adapter_up_bias"),
    ("inter_token_down", "query"): ("inter_token_attention_down", "self", "query"),
    ("inter_token_down", "key"): ("inter_token_attention_down", "self", "key"),
    ("inter_token_down", "value"): ("inter_token_attention_down", "self", "value"),
    ("inter_token_down", "out"): ("inter_token_attention_down", "output", "dense"),
    ("inter_token_down_ln",): ("inter_token_attention_down", "output", "LayerNorm"),
    ("inter_token_up", "query"): ("inter_token_attention_up", "self", "query"),
    ("inter_token_up", "key"): ("inter_token_attention_up", "self", "key"),
    ("inter_token_up", "value"): ("inter_token_attention_up", "self", "value"),
    ("inter_token_up", "out"): ("inter_token_attention_up", "output", "dense"),
    ("inter_token_up_ln",): ("inter_token_attention_up", "output", "LayerNorm"),
}
REF_T5_NAMES = {"word_embeddings": ("shared",),
                "prior_projection": ("encoder", "target_priors_projection"),
                "final_ln": ("encoder", "final_layer_norm")}
REF_T5_LAYER_NAMES = {
    ("attention", "q"): ("layer", "0", "SelfAttention", "q"),
    ("attention", "k"): ("layer", "0", "SelfAttention", "k"),
    ("attention", "v"): ("layer", "0", "SelfAttention", "v"),
    ("attention", "o"): ("layer", "0", "SelfAttention", "o"),
    ("attention", "relative_attention_bias"): ("layer", "0", "SelfAttention",
                                               "relative_attention_bias"),
    ("attn_ln",): ("layer", "0", "layer_norm"),
    ("ff", "wi"): ("layer", "1", "DenseReluDense", "wi"),
    ("ff", "wi_0"): ("layer", "1", "DenseReluDense", "wi_0"),
    ("ff", "wi_1"): ("layer", "1", "DenseReluDense", "wi_1"),
    ("ff", "wo"): ("layer", "1", "DenseReluDense", "wo"),
    ("ff_ln",): ("layer", "1", "layer_norm"),
    ("inter_token_down", "q"): ("layer", "inter_token_attention_down", "q"),
    ("inter_token_down", "k"): ("layer", "inter_token_attention_down", "k"),
    ("inter_token_down", "v"): ("layer", "inter_token_attention_down", "v"),
    ("inter_token_down", "o"): ("layer", "inter_token_attention_down", "o"),
    ("inter_token_up", "q"): ("layer", "inter_token_attention_up", "q"),
    ("inter_token_up", "k"): ("layer", "inter_token_attention_up", "k"),
    ("inter_token_up", "v"): ("layer", "inter_token_attention_up", "v"),
    ("inter_token_up", "o"): ("layer", "inter_token_attention_up", "o"),
    ("inter_token_ln1",): ("layer", "inter_token_layer_norm1"),
    ("inter_token_ln2",): ("layer", "inter_token_layer_norm2"),
}


def reference_layout(flat, cfg, gen):
    """The port's Flax-layout parameters ("/"-joined paths) under the
    reference's names (REF_*_NAMES): the position table split into the
    reference's table and its token-type row, no adapter LayerNorm (the
    reference reuses the output one), and the tables the reference
    allocates whatever the config says, seeded from ``gen``. A nested dict
    of f32 numpy arrays."""
    from zett_tpu_torch.models.convert import unflatten

    def table(*shape):
        return (0.02 * torch.randn(shape, generator=gen, device=gen.device)).cpu().numpy()

    t5 = cfg.encoder_type == "t5"
    layer = REF_T5_LAYER_NAMES if t5 else REF_LAYER_NAMES
    stack = ("model", "encoder", "block" if t5 else "layer")
    ref = {}
    for key, value in flat.items():
        path = tuple(key.split("/"))
        if path[0] != "encoder":
            ref[path] = value
        elif t5 and path[1] in REF_T5_NAMES:
            ref[("model",) + REF_T5_NAMES[path[1]] + path[2:]] = value
        elif path[1] == "inter_token_blocks":
            ref[stack + ("inter_token_blocks",)] = value
        elif path[1] == "position_embeddings":
            token_type = table(1, cfg.hidden_size)
            ref[("model", "embeddings", "token_type_embeddings", "embedding")] = token_type
            ref[("model", "embeddings", "position_embeddings", "embedding")] = value - token_type[0]
        elif path[1] in REF_EMBED_NAMES:
            ref[("model",) + REF_EMBED_NAMES[path[1]] + path[2:]] = value
        elif path[2] != "adapter_ln":
            for n in range(len(path) - 2, 0, -1):
                if path[2:2 + n] in layer:
                    ref[stack + (path[1][len("layer_"):],) + layer[path[2:2 + n]]
                        + path[2 + n:]] = value
                    break
            else:
                raise KeyError(key)
    H = cfg.hidden_size
    if t5:
        placeholders = {("model", "shared", "embedding"): (1, H),
                        ("model", "encoder", "target_priors_projection", "kernel"): (1, H),
                        ("model", "encoder", "target_priors_projection", "bias"): (H,)}
    else:
        placeholders = {("model", "embeddings", "word_embeddings", "embedding"): (1, H),
                        ("model", "embeddings", "target_priors_projection", "kernel"): (1, H),
                        ("model", "embeddings", "target_priors_projection", "bias"): (H,),
                        ("model", "embeddings", "lang_embedding", "embedding"): (1, H)}
    placeholders[stack + ("inter_token_blocks",)] = (cfg.n_inter_token_blocks, H)
    for path, shape in placeholders.items():
        if path not in ref:
            ref[path] = table(*shape)
    return unflatten(ref)


def reference_config(cfg, backbone_vocab, **extra):
    """A reference config.json for ``cfg``: the hn_* arguments (the port's
    _CONFIG_KEYMAP inverted), the backbone's vocab and position sizes (which
    the loader replaces by the tables' sizes), no hidden_act (HF roberta's
    erf-gelu) unless ``extra`` names one."""
    from zett_tpu_torch.models import reference_io as rio

    out = {src: getattr(cfg, dst) for src, dst in rio._CONFIG_KEYMAP.items()}
    out.update(vocab_size=backbone_vocab, max_position_embeddings=2048,
               hn_model_type="t5" if cfg.encoder_type == "t5" else "roberta")
    if cfg.encoder_type == "t5":
        out.update(d_model=cfg.hidden_size, d_ff=cfg.intermediate_size,
                   num_layers=cfg.num_hidden_layers, num_heads=cfg.num_attention_heads,
                   d_kv=cfg.hidden_size // cfg.num_attention_heads,
                   layer_norm_epsilon=cfg.layer_norm_eps, feed_forward_proj=cfg.hidden_act)
    out.update(extra)
    return out


def write_reference_checkpoint(path, cfg, backbone_vocab, gen, bf16=False, **extra):
    """A seeded reference-format checkpoint of ``cfg`` at ``path``:
    config.json and flax_model.msgpack (f32 leaves, or bf16). Returns the
    file's bytes and the seconds the draw and the write took."""
    t0 = time.perf_counter()
    tree = reference_layout(flax_layout(meta_hypernet(cfg), gen), cfg, gen)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(reference_config(cfg, backbone_vocab, **extra), f)

    def leaves(node):
        return {k: leaves(v) if isinstance(v, dict) else
                (torch.from_numpy(v).to(torch.bfloat16) if bf16 else v)
                for k, v in node.items()}

    with open(os.path.join(path, "flax_model.msgpack"), "wb") as f:
        write_msgpack(f, leaves(tree))
    return os.path.getsize(os.path.join(path, "flax_model.msgpack")), time.perf_counter() - t0


def load_reference_on(path, device, dtype):
    """``load_reference_hypernet`` and the port's Hypernet holding its
    parameters on ``device`` in ``dtype``: (hypernet, seconds of the load
    and of the move)."""
    from zett_tpu_torch.models import load_reference_hypernet
    from zett_tpu_torch.models.convert import flax_to_torch

    t0 = time.perf_counter()
    cfg, params = load_reference_hypernet(path)
    state = flax_to_torch(params)
    load_s = time.perf_counter() - t0
    model = meta_hypernet(cfg, dtype)
    own = model.state_dict()
    model.load_state_dict({k: v.to(device).to(own[k].dtype) for k, v in state.items()},
                          assign=True)
    if device != "cpu":
        torch.cuda.synchronize()
    return model.to(device).eval(), load_s, time.perf_counter() - t0 - load_s


def reference_transfer(tag, cfg, model_dir, heads, reps):
    """(a)/(b): the seeded reference-format checkpoint of ``cfg``
    (``prepare_inputs`` wrote it while the kernels built) over the
    Llama-family source at ``model_dir``, loaded by the port, through
    ``transfer()`` (bf16) to llama0001: both tables at 32771 rows, kernel
    4's launches (every non-CLS layer of every batch: erf-gelu), the
    hypernet per 32k vocab over the transfer's own batches (median of
    ``reps`` passes)."""
    from zett_tpu_torch.models.backbones.hf_io import load_hf_state_dict
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.tokenization.convert import convert_to_byte_level
    from zett_tpu_torch.tokenization.core import Tokenizer
    from zett_tpu_torch.transfer import core

    ckpt = os.path.join(WORK, f"reference_{tag}")
    nbytes, write_s, leaf_dtype = PREPARED.pop(f"reference_{tag}")
    hypernet, load_s, move_s = load_reference_on(ckpt, "cuda", torch.bfloat16)
    shutil.rmtree(ckpt, ignore_errors=True)
    sd = load_hf_state_dict(model_dir)
    got_cfg = hypernet.config
    log(f"  ({tag}) reference checkpoint: flax_model.msgpack {nbytes / 2**30:.3f} GiB "
        f"({leaf_dtype} leaves, drawn and written in {write_s:.3f} s while the kernels built); "
        f"load_reference_hypernet {load_s:.3f} s, to the card {move_s:.3f} s; hidden_act "
        f"{got_cfg.hidden_act!r}, {got_cfg.num_hidden_layers} layers, {got_cfg.hidden_size} "
        f"hidden, {got_cfg.num_attention_heads} heads of "
        f"{got_cfg.hidden_size // got_cfg.num_attention_heads}")
    if got_cfg.hidden_act != "gelu" or got_cfg.num_attention_heads != heads:
        raise AssertionError(f"the reference config read as {got_cfg}")
    source, _ = convert_to_byte_level(Tokenizer.from_file(os.path.join(model_dir,
                                                                       "tokenizer.json")))
    emb_in = sd["model.embed_tokens.weight"].float().numpy()
    emb_out = sd["lm_head.weight"].float().numpy()
    del sd
    batch = 16384
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with captured_transfer() as captured:
        new_in, new_out, bias, target = core.transfer(
            hypernet=hypernet, hn_tokenizer=source, source_tokenizer=source,
            source_embeddings_in=emb_in, source_embeddings_out=emb_out,
            target_tokenizer=Tokenizer.from_file(LLAMA0001), batch_size=batch, seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    n = len(target)
    n_batches = -(-n // batch)
    expected = dict.fromkeys(_build.launch_counts, 0)
    expected["attention_block"] = n_batches * (cfg.num_hidden_layers - 1)
    expected["attention_core"] = n_batches
    log(f"  ({tag}) transfer() to llama0001: {n} rows in {wall:.3f} s; emb_in "
        f"{new_in.shape}, emb_out {new_out.shape}; launches {launches} (expected {expected}: "
        f"kernel 4 at {heads} heads of 128 on {cfg.num_hidden_layers - 1} of "
        f"{cfg.num_hidden_layers} layers a batch)")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    width = cfg.n_embd
    if n != 32771 or new_in.shape != (n, width) or new_out.shape != (n, width) \
            or not (np.isfinite(new_in).all() and np.isfinite(new_out).all()
                    and np.isfinite(bias).all()) or np.array_equal(new_in, new_out):
        raise AssertionError("the transfer did not give two finite predicted tables")
    run, ms, times, n_vocab, shapes = timed_passes(captured, reps)
    log(f"  ({tag}) on {CARD}: hypernet median of {reps} passes {ms:.3f} ms (min {min(times):.3f}, "
        f"max {max(times):.3f}) for the {n_vocab}-token vocab in batches {shapes} "
        f"({ms * 32768 / n_vocab:.3f} ms per 32k vocab)")
    del run, captured, hypernet
    gc_free()
    return dict(launches=launches, wall=wall, ms_per_32k=ms * 32768 / n_vocab,
                file_gib=nbytes / 2**30, load_s=load_s)


def mistral_reference_config():
    """mistral7b_en_code's hypernet at REF_LAYERS["mistral"] of its 3 layers."""
    return dataclasses.replace(mistral_hypernet_config("en_code"),
                               num_hidden_layers=REF_LAYERS["mistral"])


def write_reference_inputs():
    """(a) and (b)'s reference checkpoints (f32 leaves at TinyLlama's
    hypernet, bf16 at Mistral-7B's), for ``prepare_inputs``."""
    for tag, cfg, vocab, bf16 in (
            ("a", tinyllama_reference_config(), TINYLLAMA["vocab_size"], False),
            ("b", mistral_reference_config(), MISTRAL["vocab_size"], True)):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 42 + ord(tag))
        nbytes, seconds = write_reference_checkpoint(os.path.join(WORK, f"reference_{tag}"), cfg,
                                                     vocab, gen, bf16=bf16)
        PREPARED[f"reference_{tag}"] = (nbytes, seconds, "bf16" if bf16 else "f32")


def tinyllama_reference_config():
    """tinyllama_en_code_lw0.5_long.json's hypernet as a reference
    checkpoint holds it over TinyLlama: n_embd 2048, the untied head (dual
    heads), the 32000-row source table, REF_LAYERS layers."""
    from zett_tpu_torch.training.__main__ import load_config_file, load_configs

    _, _, hn = load_configs(load_config_file(TINYLLAMA_RUN))
    return dataclasses.replace(hn, n_embd=TINYLLAMA["hidden_size"], separate_out_embeddings=True,
                               original_vocab_size=TINYLLAMA["vocab_size"],
                               num_hidden_layers=REF_LAYERS["tinyllama"])


def xlmr_hypernet_config(**overrides):
    """configs/zeroshot/xlmr_26l.json's hypernet over XLM-R base (n_embd
    768, the 250002-row source table, 26 language ids) at VARIANT_LAYERS
    layers, with ``overrides``."""
    from zett_tpu_torch.training.__main__ import load_config_file, load_configs

    config = load_config_file(XLMR_RUN)
    _, _, hn = load_configs(config)
    with open(os.path.join(REPO, config["langs"])) as f:
        n_langs = len([line for line in f if line.strip()])
    return dataclasses.replace(hn, n_embd=XLMR["hidden_size"],
                               original_vocab_size=XLMR["vocab_size"], n_langs=n_langs,
                               num_hidden_layers=VARIANT_LAYERS, **overrides)


def phase_heads128_block():
    """(c) kernel 4 at 16 and 32 heads of 128 against its plain version at
    the transfer's shapes: B 16384, L 8 and 7, a key mask with all-padding
    rows, with and without the prior key bias; bf16 (L 8 without the bias
    timed: single call, back to back, the bound, the plain version, F.linear
    x3 + SDPA + F.linear) and f32 at B 2048; weights at 1/sqrt(H)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    results = {}
    for name, H, h in (("attention_block_d128", 2048, 16), ("attention_block_d128_h32", 4096, 32)):
        for L in (8, 7):
            for with_bias in (False, True):
                for dtype, B in ((torch.bfloat16, 16384), (torch.float32, 2048)):
                    timed = dtype == torch.bfloat16 and L == 8 and not with_bias
                    r = check_kernel4(B, L, dtype, with_bias, gen, timed, H=H, h=h, fan_in=True)
                    if r is not None and not with_bias:
                        results[name] = r
                    gc_free()
    return results


def phase_variants():
    """(d) the hypernet variants at xlmr_26l's widths (768, 12 heads of 64,
    26 language ids) at VARIANT_LAYERS layers, each from a checkpoint the
    port loads: language adapters under gelu_new and under erf-gelu
    (reference format), concat pooling at one position (a port checkpoint;
    ROADMAP C.21), relative positions (a port checkpoint: the reference
    format cannot say it) and the T5 encoder with gated-gelu (reference
    format). VARIANT_ROWS rows on the card against the same rows on the
    CPU, f32, within 1e-4 of the output scale; the launches of kernels 1, 2
    and 4, none where the JAX module routes none."""
    from zett_tpu_torch.ops import _build
    from zett_tpu_torch.transfer.__main__ import load_hypernet

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    rng = np.random.default_rng(SEED + 41)
    vocab = XLMR["vocab_size"]
    src_card = 0.02 * torch.randn((vocab, XLMR["hidden_size"]), generator=gen, device="cuda")
    src = src_card.cpu()
    adapters = dict(language_adapter_bottleneck_dim=ADAPTER_DIM)
    variants = (  # name, config, reference format?, extra config.json keys, launches
        ("adapters_gelu_new", xlmr_hypernet_config(**adapters, hidden_act="gelu_new"), True,
         {"hidden_act": "gelu_new"}, {"encoder_layer": 1, "attention_core": 1}),
        ("adapters_erf_gelu", xlmr_hypernet_config(**adapters, hidden_act="gelu"), True, {},
         {"attention_block": 1, "attention_core": 1}),
        ("concat", xlmr_hypernet_config(concat_last_hidden_state=True, hn_surface_maxlen=1,
                                        embed_lang_id=False), False, {},
         {"encoder_layer": VARIANT_LAYERS}),
        ("relative", xlmr_hypernet_config(position_embedding_type="relative"), False, {}, {}),
        ("t5_gated_gelu", xlmr_hypernet_config(encoder_type="t5", hidden_act="gated-gelu",
                                               layer_norm_eps=1e-6, embed_lang_id=False),
         True, {}, {}),
    )
    launched = {}
    for name, cfg, reference, extra, want in variants:
        path = os.path.join(WORK, f"variant_{name}")
        t0 = time.perf_counter()
        if reference:
            write_reference_checkpoint(path, cfg, vocab, gen, **extra)
            card, _, _ = load_reference_on(path, "cuda", torch.float32)
            cpu, _, _ = load_reference_on(path, "cpu", torch.float32)
        else:
            os.makedirs(path)
            with open(os.path.join(path, "hn_config.json"), "w") as f:
                json.dump(cfg.to_dict(), f)
            np.savez(os.path.join(path, "params.npz"), **flax_layout(meta_hypernet(cfg), gen))
            card, cpu = load_hypernet(path, torch.device("cuda")), load_hypernet(path, "cpu")
        shutil.rmtree(path, ignore_errors=True)
        sf = torch.from_numpy(hypernet_inputs(rng, VARIANT_ROWS, vocab, cfg.hn_surface_maxlen,
                                              cfg.n_extra_tokens))
        priors = torch.from_numpy(hypernet_priors(rng, VARIANT_ROWS))
        lang = 3 if cfg.embed_lang_id or cfg.language_adapter_bottleneck_dim else 0
        expected = {k: want.get(k, 0) for k in ("encoder_layer", "attention_block",
                                                "attention_core")}
        before = dict(_build.launch_counts)
        with torch.inference_mode():
            got = card(sf.cuda(), priors.cuda(), src_card, lang)
            torch.cuda.synchronize()
            counts = {k: _build.launch_counts[k] - before[k] for k in expected}
            ref = cpu(sf, priors, src, lang)
        log(f"  (d) {name} ({'reference format' if reference else 'port checkpoint'}, "
            f"{time.perf_counter() - t0:.3f} s with the CPU's side): launches {counts} "
            f"(expected {expected})")
        if counts != expected:
            raise AssertionError(f"{name} launched {counts}, expected {expected}")
        for what, g, r in zip(("emb_in", "emb_out", "bias"), got, ref):
            if r is None:
                continue
            g, r = g.float().cpu().numpy(), r.float().numpy()
            err, scale = float(np.abs(g - r).max()), max(float(np.abs(r).max()), 1.0)
            log(f"  (d) {name} {what}: max abs {err:.3g} at scale {scale:.3g} (tol 1e-4 x scale)")
            if not np.isfinite(g).all() or err > 1e-4 * scale:
                raise AssertionError(f"{name}'s {what} differs on the card: {err}")
        for k, v in counts.items():
            launched[k] = launched.get(k, 0) + v
        del card, cpu, got, ref
        gc_free()
    return launched


def phase_reference():
    """Phase 19: (a) a TinyLlama-shaped reference checkpoint at full width
    and depth through transfer(); (b) Mistral-7B's hypernet widths the same
    way; (c) kernel 4 at 16 and 32 heads of 128; (d) the hypernet variants."""
    t_phase = time.perf_counter()
    step("(a) a TinyLlama reference checkpoint (erf-gelu, 16 heads of 128) through transfer()")
    tinyllama = reference_transfer("a", tinyllama_reference_config(),
                                   os.path.join(WORK, "tinyllama"), 16, 3)
    step("(b) Mistral-7B's hypernet widths (32 heads of 128) through transfer()")
    mistral = reference_transfer("b", mistral_reference_config(), os.path.join(WORK, "mistral"),
                                 32, 2)
    step("(c) kernel 4 at 16 and 32 heads of 128 against its plain version")
    kernels = phase_heads128_block()
    step("(d) the hypernet variants at xlmr_26l's widths, card vs CPU")
    variants = phase_variants()
    wall = time.perf_counter() - t_phase
    log(f"  phase 19: {wall:.3f} s wall")
    return kernels, tinyllama, mistral, variants, wall


PREPARED = {}  # prepare_inputs' entries, each taken by its phase


def prepare_inputs():
    """The inputs of later phases that no port kernel makes, written while
    nvcc builds the kernels (one nvcc process holds the build up for its
    last half, the card idles): phases 4 and 10's source model and
    checkpoints, phase 12's synthetic pretokens, phase 14's
    TinyLlama and its 2-layer cut, phase 15's Mistral and its seeded
    en_code hypernet checkpoint, phase 18's XLM-R and its 250002-id
    tokenizer, phase 19's two reference checkpoints. Each PREPARED entry
    holds its seconds."""
    from zett_tpu_torch.tokenization.convert import convert_to_byte_level
    from zett_tpu_torch.tokenization.core import Tokenizer

    for config, tag in ((GPT2_EN, "ckpt"), (PITA, "pita_ckpt")):
        t0 = time.perf_counter()
        PREPARED[tag] = (*write_transfer_inputs(config, tag), time.perf_counter() - t0)
    t0 = time.perf_counter()
    _, pieces, _ = neox_vocab()
    PREPARED["pretokens"] = (
        synthetic_pretokens(pieces, N_PRETOKENS, np.random.default_rng(SEED)),
        time.perf_counter() - t0)
    t0 = time.perf_counter()
    tinyllama = os.path.join(WORK, "tinyllama")
    PREPARED["tinyllama"] = (*write_tinyllama(tinyllama), time.perf_counter() - t0)
    write_depth_cut(tinyllama, EVAL_CUT)  # 15(e), 16 and 17 use it
    t0 = time.perf_counter()
    mistral = os.path.join(WORK, "mistral")
    _, sd = write_llama(mistral, dict(MISTRAL, num_hidden_layers=MISTRAL_LAYERS), SEED + 23)
    PREPARED["mistral"] = (sum(t.numel() for t in sd.values()), time.perf_counter() - t0)
    del sd
    t0 = time.perf_counter()
    hn_tokenizer, _ = convert_to_byte_level(
        Tokenizer.from_file(os.path.join(mistral, "tokenizer.json")))
    flat = flax_layout(meta_hypernet(mistral_hypernet_config("en_code")),
                       torch.Generator(device="cuda").manual_seed(SEED + 22))
    cfg = write_mistral_checkpoint(os.path.join(WORK, "mistral_ckpt"), "en_code", flat,
                                   hn_tokenizer)
    PREPARED["mistral_ckpt"] = (cfg, time.perf_counter() - t0)
    del flat
    t0 = time.perf_counter()
    PREPARED["xlmr"] = (*write_xlmr(os.path.join(WORK, "xlmr")), time.perf_counter() - t0)
    write_reference_inputs()


def main():
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import zett_tpu_torch  # noqa: F401
    except ImportError:
        traceback.print_exc()
        print("chip_smoke: the zett_tpu_torch package is not beside this script", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 comparisons at full precision
    torch.backends.cudnn.allow_tf32 = False
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
        CARD = smi
        log(smi)
        log(f"torch {torch.__version__} cuda {torch.version.cuda}")
        from zett_tpu_torch.ops import _build

        from zett_tpu_torch.csrc import host_lib

        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(WORK)
        # nvcc and g++ in threads of their own, the inputs meanwhile here
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            t0 = time.perf_counter()
            built = pool.submit(_build.build, verbose=True)
            host_built = pool.submit(lambda: (host_lib.build(), time.perf_counter() - t0)[1])
            prepare_inputs()
            prepared_s = time.perf_counter() - t0
            build_s, host_s = built.result(), host_built.result()
        # what is alive now (the modules, the prepared inputs) lives to the
        # end: the later full collections, gc_free's among them, skip it
        gc.collect()
        gc.freeze()
        phase(f"phase 1: built {list(_build.SOURCES)} in {build_s:.2f} s; the native host "
              f"library (g++) beside it in {host_s:.2f} s; later phases' inputs written "
              f"meanwhile in {prepared_s:.2f} s")
        sass_report = check_build()
        phase("phase 2: kernels against their plain versions")
        kernels = phase_kernels()
        phase("phase 3: hypernet at gpt2_en widths, card vs CPU (f32)")
        phase_hypernet()
        phase("phase 4: transfer through the CLI on its default device")
        transfer_launches, wall, hn_ms, _ = phase_transfer()
        step("phase 1's SASS check, read meanwhile")
        sass_report()
        phase("phase 5: kernels 2 and 3 against their plain versions at the training shapes")
        kernels.update(phase_train_kernels())
        phase("phase 6: the hypernet's training route at gpt2_en widths, card vs CPU (f32)")
        phase_hypernet_train()
        phase("phase 7: training through the CLI on its default device")
        model_dir = os.path.join(WORK, "gpt2")
        train_launches, step_ms, train_wall = phase_training(model_dir)
        phase("phase 8: kernels 4 and 5 against their plain versions")
        kernels.update(phase_block_kernels())
        phase("phase 9: hypernet at the prior + inter-token-attention config and at erf-gelu, "
            "card vs CPU (f32)")
        n_layers = GPT2_EN["num_hidden_layers"]
        phase_hypernet(PITA, launched={"attention_block": n_layers, "encoder_layer": 0,
                                       "attention_core": 0})
        phase_hypernet_train(PITA)
        phase_hypernet(GPT2_EN_GELU, launched={"attention_block": n_layers - 1,
                                               "encoder_layer": 0, "attention_core": 1})
        phase_hypernet_train(GPT2_EN_GELU)
        phase("phase 10: transfer through the CLI at the prior + inter-token-attention config")
        pita_launches, pita_wall, pita_ms, pita_vocab = phase_transfer(PITA, tag="pita_ckpt")
        phase("phase 11: training with eval through the CLI at the prior + "
            "inter-token-attention config, batch 128, with the memory levers")
        eval_launches, eval_wall, eval_peak, _ = phase_training_eval(model_dir)
        phase("phase 12: the device prior pipeline")
        kernels["viterbi_dp"], kernels["viterbi_spans_dp"], prior_launches = \
            phase_prior_pipeline()
        phase("phase 13: the trainer's levers through the CLI at gpt2_en's widths")
        lever_launches = phase_trainer_levers(model_dir)
        gc_free()
        phase("phase 14: TinyLlama (random weights at its published config) through "
            "training and transfer, kernels 1, 2 and 3 at head width 128")
        kernels128, llama_train, llama_transfer = phase_tinyllama()
        kernels.update(kernels128)
        phase("phase 15: Mistral-7B (random weights at its published config, cut in depth) "
            "through transfer at both hypernet configs, kernels 1 to 5 at 32 heads, language "
            "ids through training")
        kernels32, mistral_launches, ml_launches, mistral = phase_mistral(
            os.path.join(WORK, "tinyllama"))
        kernels.update(kernels32)
        phase("phase 16: the eval CLIs (perplexity and multiple choice) on TinyLlama under its "
              "own metaspace tokenizer and, after transfer, under llama0001")
        evals = phase_eval(os.path.join(WORK, "tinyllama"),
                           os.path.join(WORK, "tinyllama_llama0001"))
        phase("phase 17: the n-shot and baseline path on TinyLlama: the baselines CLI, "
              "passthrough tables with full fine-tuning through the training CLI")
        baselines = phase_baselines(os.path.join(WORK, "tinyllama"))
        phase("phase 18: XLM-R base (random weights at its published config) through MLM "
              "training at xlmr_26l, transfer to roberta0001 and mlm_probe")
        xlmr = phase_xlmr()
        phase("phase 19: reference-format hypernet checkpoints through transfer(), kernel 4 at "
              "head width 128, the hypernet variants")
        kernels_ref, ref_tinyllama, ref_mistral, ref_variants, ref_wall = phase_reference()
        kernels.update(kernels_ref)
    except Exception:  # noqa: BLE001 — any failure fails the run
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    sources = {
        "encoder_layer": ("zett_tpu_torch/csrc/encoder_layer.cu",
                          "zett_tpu/ops/pallas_attention.py:727"),
        "attention_core": ("zett_tpu_torch/csrc/attention_core.cu",
                           "zett_tpu/ops/pallas_attention.py:215"),
        "attention_core_bwd": ("zett_tpu_torch/csrc/attention_core_bwd.cu",
                               "zett_tpu/ops/pallas_attention.py:254"),
        "attention_block": ("zett_tpu_torch/csrc/attention_block.cu",
                            "zett_tpu/ops/pallas_attention.py:530"),
        "merged_attention": ("zett_tpu_torch/csrc/merged_attention.cu",
                             "zett_tpu/ops/pallas_attention.py:87"),
        "viterbi_dp": ("zett_tpu_torch/csrc/viterbi_dp.cu", "zett_tpu/ops/pallas_viterbi.py:25"),
        "viterbi_spans_dp": ("zett_tpu_torch/csrc/viterbi_dp.cu",
                             "zett_tpu/ops/pallas_viterbi.py:25"),
    }
    # the head-width-128 instantiations of kernels 1, 2 and 3 (phase 14; the
    # multilingual TinyLlama's training in phase 15(e)) and their 32-head
    # ones (phase 15; kernel 3 at 32 heads is off the main paths: Mistral
    # training waits for more than one card)
    for name in ("encoder_layer", "attention_core", "attention_core_bwd"):
        sources[f"{name}_d128"] = sources[name]
        sources[f"{name}_h32"] = sources[name]
    # kernel 4 at head width 128 (phase 19's reference checkpoints: 16
    # heads over TinyLlama, 32 at Mistral-7B's widths)
    sources["attention_block_d128"] = sources["attention_block_d128_h32"] = \
        sources["attention_block"]
    reference_runs = {"attention_block_d128": ref_tinyllama["launches"],
                      "attention_block_d128_h32": ref_mistral["launches"]}
    llama_runs = (llama_train["launches"], llama_transfer["launches"], ml_launches)
    off_path = OFF_PATH + ("attention_core_bwd_h32",)
    rows = []
    for name, (source, replaces) in sources.items():
        # launches: the main paths' runs, transfer (phases 4, 10 and
        # 18(d)), training (phases 7, 11, 13 and 18(c)) and the prior
        # pipeline (phase 12) at head width 64; TinyLlama's training and
        # transfer (phase 14) at 128
        if name in reference_runs:
            n = reference_runs[name].get("attention_block", 0)
        elif name.endswith("_d128"):
            n = sum(run.get(name[:-len("_d128")], 0) for run in llama_runs)
        elif name.endswith("_h32"):
            n = mistral_launches.get(name[:-len("_h32")], 0)
        else:
            n = sum(run.get(name, 0) for run in (transfer_launches, train_launches,
                                                  pita_launches, eval_launches, lever_launches,
                                                  {"viterbi_spans_dp": prior_launches},
                                                  xlmr["train"]["launches"],
                                                  xlmr["transfer"]["launches"]))
        if n == 0 and name not in off_path:
            log(f"{name} never launched on the main paths")
            return 1
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": n, **kernels[name]})
    log(f"transfer_wall_s {wall:.3f} hypernet_ms_per_vocab {hn_ms:.3f} "
        f"train_step_ms {step_ms:.3f} train_wall_s {train_wall:.3f} "
        f"pita_transfer_wall_s {pita_wall:.3f} pita_hypernet_ms_per_32k "
        f"{pita_ms * 32768 / pita_vocab:.3f} pita_train_eval_wall_s {eval_wall:.3f} "
        f"pita_train_eval_peak_gib {eval_peak:.2f} "
        f"tinyllama_train_step_ms {llama_train['step_ms']:.3f} tinyllama_train_peak_gib "
        f"{llama_train['peak_gb']:.2f} tinyllama_transfer_wall_s {llama_transfer['wall']:.3f} "
        f"tinyllama_hypernet_ms_per_32k {llama_transfer['ms_per_32k']:.3f} "
        f"mistral_en_code_hypernet_ms_per_32k {mistral['en_code']['ms_per_32k']:.3f} "
        f"mistral_multilingual_hypernet_ms_per_32k "
        f"{mistral['multilingual']['ms_per_32k']:.3f} "
        f"mistral_en_code_transfer_wall_s {mistral[('en_code', 0)]['wall']:.3f} "
        f"eval_source_tokens_per_s {evals['a']['n_tokens'] / evals['a']['eval_s']:.1f} "
        f"eval_transferred_tokens_per_s {evals['b']['n_tokens'] / evals['b']['eval_s']:.1f} "
        f"eval_source_encode_mb_per_s {evals['a']['encode_mb'] / evals['a']['encode_s']:.4f} "
        f"baseline_ft_step_ms {baselines['step_ms']:.3f} baseline_ft_peak_gib "
        f"{baselines['peak_gib']:.2f} baseline_ft_levers {sorted(baselines['levers'])} "
        f"phase17_wall_s {baselines['wall_s']:.3f} "
        f"xlmr_train_step_ms {xlmr['train']['step_ms']:.3f} xlmr_train_peak_gib "
        f"{xlmr['train']['peak_gb']:.2f} xlmr_masked_share {xlmr['train']['share']:.4f} "
        f"xlmr_transfer_wall_s {xlmr['transfer']['wall']:.3f} xlmr_hypernet_ms_per_32k "
        f"{xlmr['transfer']['ms_per_32k']:.3f} xlmr_mlm_loss "
        f"{xlmr['probe']['full']['mlm_loss']:.4f} phase18_wall_s {xlmr['wall']:.3f} "
        f"reference_tinyllama_hypernet_ms_per_32k {ref_tinyllama['ms_per_32k']:.3f} "
        f"reference_tinyllama_load_s {ref_tinyllama['load_s']:.3f} "
        f"reference_mistral_hypernet_ms_per_32k {ref_mistral['ms_per_32k']:.3f} "
        f"reference_mistral_load_s {ref_mistral['load_s']:.3f} variant_launches "
        f"{ref_variants} phase19_wall_s {ref_wall:.3f}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
