"""Splice hypernet-predicted embeddings into a frozen backbone's HF state
dict (counterpart of ``zett_tpu/models/splice.py`` and of the save path's
``invert_gpt2``/``invert_llama``).

The port works on the HF state dict directly: the predicted input table
replaces the embedding weight; a tied head gets the same table (RoBERTa's
as ``lm_head.decoder.weight``); an untied Llama-family head
(``lm_head.weight``) gets the predicted output table; RoBERTa's lm-head
bias (both of its keys) gets the given bias, or zeros. The keys the JAX
package's converters drop are dropped, so the output holds exactly the
keys the JAX transfer writes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .backbones.registry import (BIAS_KEYS, IN_EMBEDDING_KEYS, KEEP_KEYS, TIED_HEAD_KEYS,
                                 check_supported, resolve_out_path)


def splice_embeddings(
    state_dict: Dict[str, torch.Tensor],
    model_type: str,
    embeddings_in: torch.Tensor,
    embeddings_out: Optional[torch.Tensor] = None,
    tie_word_embeddings: bool = True,
    bias: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """A new state dict with the vocab-dependent weights replaced
    (``splice.py:35-75``).

    embeddings_in, embeddings_out: (V, E). With tied embeddings the lm head
    is the input table; an untied Llama-family head becomes
    ``embeddings_out`` (required then); an untied GPT-2 head is not
    vocab-spliced and keeps its weight, as in the JAX package. bias: (V,)
    for a family with an lm-head bias, or None for zeros in the input
    table's dtype (``splice.py:63-70``)."""
    check_supported(model_type)
    keep = KEEP_KEYS[model_type]
    out_key = resolve_out_path(model_type, state_dict, {"tie_word_embeddings":
                                                        tie_word_embeddings})
    new = {}
    for k, v in state_dict.items():
        if not keep.fullmatch(k):
            continue
        if k == TIED_HEAD_KEYS[model_type] and tie_word_embeddings:
            continue
        new[k] = v
    new[IN_EMBEDDING_KEYS[model_type]] = embeddings_in
    if out_key is not None:
        if embeddings_out is None:
            raise ValueError(f"{model_type} has untied output embeddings: pass embeddings_out")
        new[out_key] = embeddings_out
    if tie_word_embeddings:
        new[TIED_HEAD_KEYS[model_type]] = embeddings_in
    for key in BIAS_KEYS.get(model_type, ()):
        new[key] = bias if bias is not None else embeddings_in.new_zeros(embeddings_in.shape[0])
    return new


def extract_embeddings(state_dict: Dict[str, torch.Tensor], model_type: str,
                       pad_to_multiple_of: int = 128, config=None):
    """(source_embeddings, original_vocab_size): [input table | output
    table] for an untied head (the input table alone when tied), padded with
    zero rows to a multiple of ``pad_to_multiple_of``
    (``zett_tpu/models/splice.py:78-106``). ``config`` (``config.json``'s
    dict or a backbone config) says whether the head is tied."""
    check_supported(model_type)
    emb_in = state_dict[IN_EMBEDDING_KEYS[model_type]]
    out_key = resolve_out_path(model_type, state_dict, config)
    source = emb_in if out_key is None else torch.cat([emb_in, state_dict[out_key]], dim=1)
    n = source.shape[0]
    pad = (-n) % pad_to_multiple_of
    if pad:
        source = torch.cat([source, source.new_zeros(pad, source.shape[1])])
    return source, emb_in.shape[0]
