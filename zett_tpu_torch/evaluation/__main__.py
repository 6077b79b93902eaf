"""Eval CLI: perplexity / bits-per-char of a (transferred) causal LM
(counterpart of ``zett_tpu/evaluation/__main__.py``; reference:
eval.py:42-209).

Usage:
  python -m zett_tpu_torch.evaluation --model MODEL_DIR --data TEXTFILE \\
      [--tokenizer TOK] [--block-size 512] [--batch-size 8] [--bias bias.npy] \\
      [--max-texts N] [--device {cuda,cpu}]

The backbone (gpt2 or the Llama family) is built in f32, as the JAX CLI
builds it; the CLI leaves PyTorch's TF32 switch as it finds it (off by
default, so f32 products run in full f32) and names it on stderr. It runs on
the card unless ``--device cpu`` is given, and raises when there is none.
Prints one JSON line with the JAX CLI's keys: loss, perplexity,
bits_per_char, chars_per_token, n_tokens.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True)
    p.add_argument("--data", required=True, help="text file, one document per line")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--block-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--bias", default=None, help="external lm-head bias .npy")
    p.add_argument("--max-texts", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..tokenization.core import Tokenizer
    from .perplexity import (chunked_tokenize, evaluate_lm, load_causal_lm, resolve_device,
                             tf32_note)

    device = resolve_device(args.device)
    apply_fn = load_causal_lm(args.model, device)
    print(tf32_note(device), file=sys.stderr)
    tokenizer = Tokenizer.from_file(args.tokenizer or os.path.join(args.model, "tokenizer.json"))

    with open(args.data) as f:
        texts = [line.rstrip("\n") for line in f if line.strip()]
    if args.max_texts:
        texts = texts[:args.max_texts]

    data = chunked_tokenize(tokenizer, texts, args.block_size)
    metrics = evaluate_lm(apply_fn, data, special_ids=tokenizer.all_special_ids,
                          external_bias=np.load(args.bias) if args.bias else None,
                          batch_size=args.batch_size, device=device)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
