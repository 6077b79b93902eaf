"""Zero-shot multiple-choice evaluation: lm_eval-style loglikelihood scoring
(counterpart of ``zett_tpu/evaluation/choice.py``).

Every choice is scored by the summed log-probability of its continuation
tokens given the context, reported as

  acc       argmax of raw continuation log-likelihood
  acc_norm  argmax of log-likelihood / continuation byte length
            (lm_eval's byte-length normalization)

Task format (jsonl, one item per line):
  {"query": "...", "choices": ["...", "..."], "gold": 0}

CLI:  python -m zett_tpu_torch.evaluation.choice --model DIR --data task.jsonl \\
          [--tokenizer TOK] [--batch-size 8] [--max-length 1024] [--max-items N] \\
          [--device {cuda,cpu}]

Batches are padded to JAX's power-of-two width buckets and a fixed row
count. The per-token log-probs and argmax flags are gathered on the device
and copied back once at the end; the JAX package copies whole (B, W, V)
logits to the host every batch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..tokenization.core import Tokenizer


def _encode_pair(tokenizer: Tokenizer, context: str, continuation: str):
    """lm_eval convention: tokenize the WHOLE string and split at the
    context's token count (continuation tokens may differ from encoding the
    continuation alone — merges can cross the boundary)."""
    ctx_ids = tokenizer.encode(context, add_special_tokens=False).ids
    all_ids = tokenizer.encode(context + continuation, add_special_tokens=False).ids
    # longest shared prefix: the boundary token may merge across the split
    n_ctx = 0
    while n_ctx < min(len(ctx_ids), len(all_ids)) and ctx_ids[n_ctx] == all_ids[n_ctx]:
        n_ctx += 1
    # at least one context token must remain to predict from (and at least
    # one continuation token must be scored)
    n_ctx = max(1, min(n_ctx, len(all_ids) - 1))
    return all_ids, n_ctx, all_ids[n_ctx:]


def bucket_width(n: int, max_length: int) -> int:
    """A batch's width: the power of two from 32 that holds ``n``, capped
    at ``max(max_length, n)`` (JAX's buckets, one compile a width there)."""
    w = 32
    while w < n:
        w *= 2
    return min(w, max(max_length, n))


def score_loglikelihoods(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                         tokenizer: Tokenizer, requests: Sequence[Tuple[str, str]],
                         batch_size: int = 8, max_length: int = 1024,
                         device="cpu") -> List[Dict[str, float]]:
    """For each (context, continuation): summed log-prob of the continuation
    tokens given everything before them. Returns dicts with ll, n_tokens,
    n_bytes, greedy (whether every continuation token is the argmax)."""
    device = torch.device(device)
    encoded = []
    for context, continuation in requests:
        all_ids, n_ctx, cont_ids = _encode_pair(tokenizer, context, continuation)
        all_ids = all_ids[-max_length:]  # keep the continuation, clip context
        n_ctx = max(1, len(all_ids) - len(cont_ids))
        encoded.append((all_ids, n_ctx, len(continuation.encode("utf-8"))))

    gathered_lp, gathered_hit = [], []
    with torch.inference_mode():
        for lo in range(0, len(encoded), batch_size):
            chunk = encoded[lo:lo + batch_size]
            width = bucket_width(max(len(ids) for ids, _, _ in chunk), max_length)
            batch = np.zeros((batch_size, width), dtype=np.int64)
            rows, positions, targets = [], [], []
            for r, (ids, n_ctx, _) in enumerate(chunk):
                batch[r, :len(ids)] = ids
                # the token at position t is predicted by the logits at t - 1
                rows += [r] * (len(ids) - n_ctx)
                positions += range(n_ctx - 1, len(ids) - 1)
                targets += ids[n_ctx:]
            logits = apply_fn(torch.from_numpy(batch).to(device)).float()
            index = [torch.as_tensor(x, dtype=torch.long).to(device)
                     for x in (rows, positions, targets)]
            picked = torch.log_softmax(logits[index[0], index[1]], dim=-1)
            del logits
            gathered_lp.append(picked.gather(-1, index[2][:, None])[:, 0])
            gathered_hit.append(picked.argmax(-1) == index[2])
    lp = torch.cat(gathered_lp).cpu().numpy() if gathered_lp else np.zeros(0, np.float32)
    hit = torch.cat(gathered_hit).cpu().numpy() if gathered_hit else np.zeros(0, bool)

    results: List[Dict[str, float]] = []
    at = 0
    for ids, n_ctx, n_bytes in encoded:
        n = len(ids) - n_ctx
        results.append({
            "ll": float(lp[at:at + n].sum()),
            "n_tokens": int(n),
            "n_bytes": int(n_bytes),
            "greedy": bool(hit[at:at + n].all()),
        })
        at += n
    return results


def evaluate_choice_task(apply_fn, tokenizer: Tokenizer, items: Sequence[dict],
                         batch_size: int = 8, max_length: int = 1024,
                         device="cpu") -> Dict[str, float]:
    """items: [{"query", "choices", "gold"}]. Returns acc / acc_norm /
    n_items."""
    requests = []
    spans = []
    for item in items:
        start = len(requests)
        for choice in item["choices"]:
            requests.append((item["query"], choice))
        spans.append((start, len(requests), int(item["gold"])))
    scores = score_loglikelihoods(apply_fn, tokenizer, requests, batch_size=batch_size,
                                  max_length=max_length, device=device)
    n_correct = n_correct_norm = 0
    for start, stop, gold in spans:
        lls = [scores[i]["ll"] for i in range(start, stop)]
        norm = [scores[i]["ll"] / max(scores[i]["n_bytes"], 1) for i in range(start, stop)]
        n_correct += int(int(np.argmax(lls)) == gold)
        n_correct_norm += int(int(np.argmax(norm)) == gold)
    n = len(spans)
    return {
        "acc": n_correct / max(n, 1),
        "acc_norm": n_correct_norm / max(n, 1),
        "n_items": n,
    }


def read_items(path: str, max_items=None) -> List[dict]:
    with open(path) as f:
        items = [json.loads(line) for line in f if line.strip()]
    return items[:max_items] if max_items else items


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True)
    p.add_argument("--data", required=True, help="jsonl: {query, choices, gold}")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-length", type=int, default=1024)
    p.add_argument("--max-items", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    from .perplexity import load_causal_lm, resolve_device, tf32_note

    device = resolve_device(args.device)
    apply_fn = load_causal_lm(args.model, device)
    print(tf32_note(device), file=sys.stderr)
    tokenizer = Tokenizer.from_file(args.tokenizer or os.path.join(args.model, "tokenizer.json"))
    metrics = evaluate_choice_task(apply_fn, tokenizer, read_items(args.data, args.max_items),
                                   batch_size=args.batch_size, max_length=args.max_length,
                                   device=device)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
