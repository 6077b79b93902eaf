"""The MLM masker (counterpart of ``zett_tpu/data/mlm.py``): the
Collator's ``inner_collator`` for masked-LM backbones.

``MLMCollator(mlm_probability, seed)(tokenizer, input_ids)`` picks each
non-special position with probability ``mlm_probability`` (special ids are
``tokenizer.all_special_ids``); a picked position keeps its id as its
label, every other label is -100. Of the picked positions, 80% become the
mask token (``<mask>``, else ``[MASK]``; a tokenizer with neither raises),
half of the rest a uniform random id. The draws are numpy's, in the JAX
masker's order, so a masker with the same seed gives the same batch bit
for bit. ``reseed`` restarts the generator from a seed: the port's
Collator calls it before each batch, so the masks of batch k are a pure
function of (the Collator's seed, k), as its own draws are (ROADMAP C.18).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

MASK_TOKENS = ("<mask>", "[MASK]")


class MLMCollator:
    def __init__(self, mlm_probability: float = 0.15, seed=None):
        self.mlm_probability = mlm_probability
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed) -> None:
        """Restart the generator from ``seed`` (an int or a sequence of ints,
        as ``np.random.default_rng`` takes)."""
        self.rng = np.random.default_rng(seed)

    def __call__(self, tokenizer, input_ids: np.ndarray) -> Dict[str, np.ndarray]:
        labels = input_ids.copy()
        special_ids = np.array(tokenizer.all_special_ids, dtype=input_ids.dtype)
        special_mask = np.isin(input_ids, special_ids)

        prob = np.full(input_ids.shape, self.mlm_probability)
        prob[special_mask] = 0.0
        masked = self.rng.random(input_ids.shape) < prob
        labels[~masked] = -100

        mask_token_id = None
        for cand in MASK_TOKENS:
            mask_token_id = tokenizer.token_to_id(cand)
            if mask_token_id is not None:
                break
        if mask_token_id is None:
            raise ValueError("tokenizer has no mask token for MLM")

        out = input_ids.copy()
        replace = masked & (self.rng.random(input_ids.shape) < 0.8)
        out[replace] = mask_token_id
        rand = masked & ~replace & (self.rng.random(input_ids.shape) < 0.5)
        out[rand] = self.rng.integers(0, len(tokenizer), size=int(rand.sum()))
        return {"input_ids": out, "labels": labels}
