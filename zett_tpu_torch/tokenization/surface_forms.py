"""Surface-form matrices: encode each target-vocab token's byte string with
the hypernetwork tokenizer into a fixed-width int32 matrix.

Counterpart of ``zett_tpu/tokenization/surface_forms.py``. Special tokens are
encoded as their single id in the hn tokenizer; all other tokens are
byte-char strings segmented by the hn tokenizer's model: a canonical
byte-level Unigram's on the native host library (the same Viterbi in C++;
a 250k-piece hn tokenizer segments a 250k vocab in seconds, not minutes),
any other in Python.
"""

from __future__ import annotations

import weakref
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from .core import Tokenizer
from .fast_encode import fast_encoder_or_none
from .models import Unigram

# hn model -> its native encoder (or None), built at its first use
_SEGMENTERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _native_segmenter(hn_tokenizer: Tokenizer):
    model = hn_tokenizer.model
    if not isinstance(model, Unigram):
        return None
    if model not in _SEGMENTERS:
        _SEGMENTERS[model] = fast_encoder_or_none(hn_tokenizer)
    return _SEGMENTERS[model]


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
    native = {}
    segmenter = _native_segmenter(hn_tokenizer)
    if segmenter is not None:
        todo = sorted({t for t in tokens if t is not None and t not in special_set
                       and (cache is None or t not in cache)})
        native = dict(zip(todo, segmenter.segment(todo)))
    for i, token in enumerate(tokens):
        if token is None:
            continue
        if token in special_set:
            out[i, 0] = hn_tokenizer.token_to_id(token)
            continue
        ids = cache.get(token) if cache is not None else None
        if ids is None:
            seg = native.get(token)
            ids = (tuple(seg.tolist()) if seg is not None
                   else tuple(tid for tid, _ in tokenize(token)))
            if cache is not None:
                cache[token] = ids
        if len(ids) > maxlen:
            ids = ids[:maxlen]
            n_truncated += 1
        out[i, : len(ids)] = ids
    return out, n_truncated
