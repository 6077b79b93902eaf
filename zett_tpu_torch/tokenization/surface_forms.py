"""Surface-form matrices: encode each target-vocab token's byte string with
the hypernetwork tokenizer into a fixed-width int32 matrix.

Counterpart of ``zett_tpu/tokenization/surface_forms.py``. Special tokens are
encoded as their single id in the hn tokenizer; all other tokens are
byte-char strings segmented by the hn tokenizer's model.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

from .core import Tokenizer


def get_surface_form_matrix(
    tokenizer_or_tokens: Union[Tokenizer, Sequence[str]], maxlen: int,
    hn_tokenizer: Tokenizer, cache: Optional[dict] = None,
) -> Tuple[np.ndarray, int]:
    """Returns (surface_forms[vocab, maxlen] int32, n_truncated).

    cache (optional): token -> tuple(ids) memo persisted by the caller
    across calls (sampled vocabularies repeat pieces heavily, so each
    distinct piece is segmented once)."""
    if isinstance(tokenizer_or_tokens, Tokenizer):
        tok = tokenizer_or_tokens
        tokens = [tok.id_to_token(i) for i in range(len(tok))]
    else:
        tokens = list(tokenizer_or_tokens)
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
        if cache is not None:
            ids = cache.get(token)
            if ids is None:
                ids = tuple(tid for tid, _ in tokenize(token))
                cache[token] = ids
        else:
            ids = [tid for tid, _ in tokenize(token)]
        if len(ids) > maxlen:
            ids = ids[:maxlen]
            n_truncated += 1
        out[i, : len(ids)] = ids
    return out, n_truncated
