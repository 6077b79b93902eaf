"""Surface-form matrices: encode each target-vocab token's byte string with
the hypernetwork tokenizer into a fixed-width int32 matrix.

Counterpart of ``zett_tpu/tokenization/surface_forms.py``. Special tokens are
encoded as their single id in the hn tokenizer; all other tokens are
byte-char strings segmented by the hn tokenizer's model.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .core import Tokenizer


def get_surface_form_matrix(
    tok: Tokenizer, maxlen: int, hn_tokenizer: Tokenizer
) -> Tuple[np.ndarray, int]:
    """Returns (surface_forms[vocab, maxlen] int32, n_truncated)."""
    tokens = [tok.id_to_token(i) for i in range(len(tok))]
    pad_id = hn_tokenizer.token_to_id("<pad>")
    if pad_id is None:
        pad_id = 0
    special_set = set(hn_tokenizer.all_special_tokens)

    out = np.full((len(tokens), maxlen), pad_id, dtype=np.int32)
    n_truncated = 0
    tokenize = hn_tokenizer.model.tokenize
    for i, token in enumerate(tokens):
        if token is None:
            continue
        if token in special_set:
            out[i, 0] = hn_tokenizer.token_to_id(token)
            continue
        ids = [tid for tid, _ in tokenize(token)]
        if len(ids) > maxlen:
            ids = ids[:maxlen]
            n_truncated += 1
        out[i, : len(ids)] = ids
    return out, n_truncated
