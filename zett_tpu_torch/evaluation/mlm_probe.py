"""The MLM loss and accuracy probe of a masked-LM model (counterpart of
``zett_tpu/evaluation/mlm_probe.py``).

``mlm_probe(model, tokenizer, texts)`` encodes the texts truncated and
padded to ``block_size`` with ``<pad>`` (id 0 where there is none), masks
them with ``MLMCollator(mlm_probability, seed)`` in one call, as the JAX
probe does, and scores the model's logits (its own table and lm-head bias:
``RobertaForMaskedLM.mlm_logits``) in batches under ``inference_mode`` on
the model's device: the mean negative log-likelihood and the argmax
accuracy over the masked, attended positions, and their count.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..data.mlm import MLMCollator


def mlm_probe(model, tokenizer, texts: List[str], block_size: int = 128, batch_size: int = 8,
              mlm_probability: float = 0.15, seed: int = 0) -> Dict[str, float]:
    """{"mlm_loss", "mlm_accuracy", "n_masked"} (``mlm_probe.py:17``)."""
    collator = MLMCollator(mlm_probability, seed=seed)
    pad_id = tokenizer.token_to_id("<pad>") or 0
    tokenizer.enable_truncation(block_size)
    tokenizer.enable_padding(length=block_size, pad_id=pad_id, pad_token="<pad>")
    encs = tokenizer.encode_batch(texts)
    tokenizer.no_truncation()
    tokenizer.no_padding()
    input_ids = np.array([e.ids for e in encs], dtype=np.int32)
    attention_mask = np.array([e.attention_mask for e in encs], dtype=np.int32)
    masked = collator(tokenizer, input_ids)
    device = next(model.parameters()).device

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).long().to(device)

    total_loss = total_acc = total_n = 0.0
    with torch.inference_mode():
        for start in range(0, len(input_ids), batch_size):
            sl = slice(start, start + batch_size)
            ids, mask, labels = (dev(masked["input_ids"][sl]), dev(attention_mask[sl]),
                                 dev(masked["labels"][sl]))
            logits = model.mlm_logits(ids, mask).float()
            label_mask = (labels != -100) & (mask == 1)
            logp = torch.log_softmax(logits, dim=-1)
            tok_logp = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
            loss_sum = -(tok_logp * label_mask).sum()
            acc_sum = ((logits.argmax(-1) == labels) & label_mask).sum()
            total_loss += float(loss_sum)
            total_acc += float(acc_sum)
            total_n += float(label_mask.sum())
    return {
        "mlm_loss": total_loss / max(total_n, 1),
        "mlm_accuracy": total_acc / max(total_n, 1),
        "n_masked": total_n,
    }
