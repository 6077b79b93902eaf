"""Token priors (counterpart of ``zett_tpu/tokenization/priors.py``).

``get_prior`` has the reference's two modes (zett/utils.py:291-315):
"reestimate", Laplace-smoothed corpus counts, and "use_tokenizer", the
Unigram scores. The substring prior counts, for every vocab token, how often
it occurs as a substring of the corpus' pretokens (reference:
zett/compute_prior.py:25-136), with the native Aho-Corasick automaton of
``csrc/host_lib``. The JAX package falls back to a Python automaton when its
host library is missing; the port has no such fallback, since its host
library is built at first use or raises.

Pretoken counts of the canonical byte-level structure that ``fast_encode``
accepts (a Prepend normalizer or none, Split + ByteLevel or a plain
ByteLevel with use_regex) come from the native GPT-2 split and are keyed
by raw bytes. Any other tokenizer runs its own normalizer and
pre-tokenizer, as the JAX package does, and its counts are keyed by the
pretoken strings.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Mapping, Optional

import numpy as np

from ..constants import NEGATIVE_INF_FILL_VALUE
from ..csrc import host_lib
from .bytemaps import bytes_to_byte_chars
from .core import Tokenizer
from .fast_encode import SplitConfig


def get_prior(mode: str, input_ids: Optional[np.ndarray], tokenizer: Tokenizer,
              padding: int = 0) -> Optional[np.ndarray]:
    if mode == "keep":
        return None
    if mode == "reestimate":
        uniq, counts = np.unique(input_ids, return_counts=True)
        priors = np.ones(len(tokenizer) + padding)  # laplace smoothing
        priors[uniq] += counts
        priors /= priors.sum()
        priors = np.log(priors)
    elif mode == "use_tokenizer":
        scores = np.asarray(tokenizer.model.get_scores(), dtype=np.float64)
        priors = np.pad(scores, (0, len(tokenizer) + padding - len(scores)),
                        constant_values=NEGATIVE_INF_FILL_VALUE)
    else:
        raise ValueError(f"Unknown prior mode: {mode}")
    special_ids = tokenizer.all_special_ids
    if special_ids:
        priors[np.asarray(special_ids)] = 0.0  # special tokens: 0 by convention
    return priors


def get_pretoken_counts(tokenizer: Tokenizer, texts: Iterable[str]) -> Counter:
    """Counts of a corpus' pretokens under the tokenizer's own normalizer
    and pre-tokenizer (reference compute_prior.py:35-63): raw bytes for a
    canonical byte-level tokenizer, else the pretoken strings."""
    counts: Counter = Counter()
    try:
        split = SplitConfig.of(tokenizer)
    except ValueError:
        norm, pretok = tokenizer.normalizer, tokenizer.pre_tokenizer
        for text in texts:
            t = norm.normalize_str(text) if norm is not None else text
            if pretok is not None:
                counts.update(p for p, _ in pretok.pre_tokenize_str(t))
            else:
                counts[t] += 1
        return counts
    for raw in split.raw_texts(list(texts)):
        counts.update(host_lib.split_pretokens_native(raw, use_marks=split.use_marks))
    return counts


def compute_substring_prior(tokenizer: Tokenizer, texts: Optional[Iterable[str]] = None,
                            pretoken_counts: Optional[Mapping[bytes, int]] = None,
                            return_pretoken_counts: bool = False):
    """log-prior over the vocab from substring occurrence counts in the
    pretokens (keyed as ``get_pretoken_counts`` returns them)."""
    if pretoken_counts is None:
        if texts is None:
            raise ValueError("compute_substring_prior needs texts or pretoken_counts")
        pretoken_counts = get_pretoken_counts(tokenizer, texts)

    # a byte-level vocab holds byte-char strings: match raw-byte pretokens
    # in the same domain
    as_chars = {bytes_to_byte_chars(p) if isinstance(p, bytes) else p: c
                for p, c in pretoken_counts.items()}
    acc = np.zeros(len(tokenizer), dtype=np.int64)
    host_lib.substring_counts(tokenizer.get_vocab(), as_chars, acc)

    prior = acc.astype(np.float64) + 1.0  # laplace smoothing
    prior /= prior.sum()
    prior = np.log(prior)
    special_ids = tokenizer.all_special_ids
    if special_ids:
        prior[np.asarray(special_ids)] = 0.0
    if return_pretoken_counts:
        return prior, pretoken_counts
    return prior
