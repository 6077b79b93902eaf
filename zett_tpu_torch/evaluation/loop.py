"""The in-training eval loop (counterpart of ``zett_tpu/evaluation/loop.py``).

Runs a trainer's eval steps over a stream of collated validation batches and
averages the metrics per tokenizer and per language. With a fixed tokenizer
the surface forms and priors do not change across batches, so the
hypernet's vocab forward runs once, on the first batch, and its embeddings
are reused (``eval_step_cached``). Under a process group every rank runs
the loop over the same batches: ``_device_batch`` keeps the rank's LM rows
and the trainer sums each metric's parts over the ranks, so every rank
gets one process's rows.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Optional


def eval_loop(trainer, eval_batches: Iterable[dict], name: str = "eval",
              max_batches: Optional[int] = None, fixed_tokenizer: bool = False,
              ) -> Dict[str, float]:
    """``{name}/{metric}`` means over the batches, ``{name}/{lang}_{metric}``
    per language, and the collator's host metrics (``loop.py:17``)."""
    sums: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    per_lang: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    per_lang_counts: Dict[str, int] = defaultdict(int)
    cached = None

    for i, batch in enumerate(eval_batches):
        if max_batches is not None and i >= max_batches:
            break
        lang = batch.get("lang_code") or "all"
        b = trainer._device_batch(batch)
        if fixed_tokenizer:
            if cached is None:
                cached = trainer.compute_embeddings(b)
            metrics = trainer.eval_step_cached(b, *cached)
        else:
            metrics = trainer.eval_step(b)
        for k, v in metrics.items():
            v = float(v)
            sums[k] += v
            counts[k] += 1
            per_lang[lang][k] += v
        per_lang_counts[lang] += 1
        for k, v in (batch.get("metrics") or {}).items():
            sums[k] += float(v)
            counts[k] += 1

    out = {f"{name}/{k}": sums[k] / counts[k] for k in sums}
    for lang, lang_sums in per_lang.items():
        n = per_lang_counts[lang]
        for k, v in lang_sums.items():
            out[f"{name}/{lang}_{k}"] = v / n
    return out
