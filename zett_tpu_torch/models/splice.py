"""Splice hypernet-predicted embeddings into a frozen backbone's HF state
dict (counterpart of ``zett_tpu/models/splice.py`` and of the save path's
``invert_gpt2``).

The port works on the HF state dict directly: the predicted input table
replaces the embedding weight, a tied lm head gets the same table, and the
keys the JAX package's converter drops are dropped, so the output holds
exactly the keys the JAX transfer writes.
"""

from __future__ import annotations

from typing import Dict

import torch

from .backbones.registry import IN_EMBEDDING_KEYS, KEEP_KEYS, check_supported


def splice_embeddings(
    state_dict: Dict[str, torch.Tensor],
    model_type: str,
    embeddings_in: torch.Tensor,
    tie_word_embeddings: bool = True,
) -> Dict[str, torch.Tensor]:
    """A new state dict with the vocab-dependent weights replaced.

    embeddings_in: (V, E). With tied embeddings the lm head is the same
    table; an untied GPT-2 head is not vocab-spliced and keeps its weight,
    as in the JAX package."""
    check_supported(model_type)
    keep = KEEP_KEYS[model_type]
    in_key = IN_EMBEDDING_KEYS[model_type]
    new = {}
    for k, v in state_dict.items():
        if not keep.fullmatch(k):
            continue
        if k == "lm_head.weight" and tie_word_embeddings:
            continue
        new[k] = v
    new[in_key] = embeddings_in
    if tie_word_embeddings:
        new["lm_head.weight"] = embeddings_in
    return new


def extract_embeddings(state_dict: Dict[str, torch.Tensor], model_type: str,
                       pad_to_multiple_of: int = 128):
    """(source_embeddings, original_vocab_size): the input table (tied
    gpt2: no output table to append) padded with zero rows to a multiple of
    ``pad_to_multiple_of`` (``zett_tpu/models/splice.py:78``)."""
    check_supported(model_type)
    emb_in = state_dict[IN_EMBEDDING_KEYS[model_type]]
    n = emb_in.shape[0]
    pad = (-n) % pad_to_multiple_of
    source = torch.cat([emb_in, emb_in.new_zeros(pad, emb_in.shape[1])]) if pad else emb_in
    return source, n
