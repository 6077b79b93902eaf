"""Chunked tokenization for LM evaluation (counterpart of
``chunked_tokenize`` in ``zett_tpu/evaluation/perplexity.py``; the rest of
that module, the standalone perplexity evaluation, is not ported yet)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..tokenization.core import Tokenizer
from ..tokenization.fast_encode import fast_encoder_or_none


def chunked_tokenize(tokenizer: Tokenizer, texts: List[str],
                     block_size: int) -> Dict[str, np.ndarray]:
    """Tokenize, concatenate and chunk to block_size (reference
    zett/utils.py:318-347 tokenize_function): input_ids and the char length
    of every token, each (n_blocks, block_size) int32. Only canonical
    byte-level tokenizers (the native fast encoder) are supported."""
    fast = fast_encoder_or_none(tokenizer)
    if fast is None:
        raise NotImplementedError(
            "chunked_tokenize needs a canonical byte-level tokenizer (the native fast "
            "encoder); the general encode pipeline is not ported (ROADMAP A.15)")
    texts = [t.replace("\x00", "").strip() for t in texts]
    ids_arr, mask = fast.encode_batch(texts, add_special_tokens=False)
    byte_len = np.zeros(len(tokenizer), dtype=np.int32)
    for token, idx in tokenizer.get_vocab().items():
        if idx < len(byte_len):
            byte_len[idx] = len(token)
    ids = ids_arr[mask == 1]  # row-major: the texts' ids, concatenated
    total = (len(ids) // block_size) * block_size
    return {"input_ids": ids[:total].astype(np.int32).reshape(-1, block_size),
            "char_lengths": byte_len[ids[:total]].reshape(-1, block_size)}
