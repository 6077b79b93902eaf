"""Noisy Unigram-tokenizer sampling from corpus substrings (counterpart of
``zett_tpu/tokenization/sampler.py``, native path only).

Enumerate substrings of pre-tokenized text, score = frequency * byte-length
of the byte-char form, keep a sliding window of per-batch count maps,
normalize to log-probs with Gaussian noise, always include the 256-byte
alphabet and whitespace-run pieces, truncate to seed_size. The counting
runs in the native host library (``csrc/host_lib.py``); the JAX package's
pure-Python counting path needs the ``regex`` module for ``\\p{L}`` and is
not carried over.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..constants import EXTRA_WHITESPACE_CHARS
from ..csrc import host_lib
from .bytemaps import BYTE_ALPHABET, bytes_to_byte_chars


class TokenizerSampler:
    """Stateful sampler with a sliding cache of per-batch substring counts."""

    def __init__(self):
        self.seed_cache: deque = deque()

    def sample_tokenizer(
        self,
        texts_with_counts: Dict[str, int],
        seed_size: int,
        max_length: int = 16,
        stride: int = 1,
        noise_std: float = 0.0,
        pop_prev: bool = True,
        push_current: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> List[Tuple[str, float]]:
        rng = rng or np.random.default_rng()
        texts_b = [(" " + t).encode("utf-8") for t in texts_with_counts]
        current = host_lib.count_substrings_texts_native(
            texts_b, list(texts_with_counts.values()), max_length, stride
        )

        maybe_prev = self.seed_cache.pop() if (pop_prev and self.seed_cache) else None
        self.seed_cache.appendleft(current)

        seed_pieces: List[Tuple[str, float]] = []
        if pop_prev:
            keys_blob, key_offsets, values_u = host_lib.merge_counts(list(self.seed_cache))
            values = values_u.astype(np.float64)

            score_sum = float(values.sum()) if len(values) else 1.0
            min_score = float(values.min()) if len(values) else 1.0
            min_log_prob = float(np.log(min_score / score_sum)) if score_sum else 0.0

            for char in BYTE_ALPHABET:
                seed_pieces.append((char, min_log_prob))

            probs = values / score_sum
            if noise_std > 0:
                probs = probs + rng.normal(0.0, noise_std, size=len(probs))
            with np.errstate(divide="ignore", invalid="ignore"):
                scores = np.where(probs > 0, np.log(np.maximum(probs, 1e-300)), -100000.0)
            order = np.argsort(-scores, kind="stable")

            ws = EXTRA_WHITESPACE_CHARS
            for c1 in ws:
                for i in range(1, max_length):
                    for c2 in ws:
                        seed_pieces.append((c2 + c1 * i, 0.0))

            # skip 1-byte pieces (the alphabet covers them) and pieces with
            # >= 2 whitespace bytes (the runs cover them)
            lens = key_offsets[1:] - key_offsets[:-1]
            blob = np.frombuffer(keys_blob, dtype=np.uint8)
            is_ws = (blob == 0x20) | (blob == 0x0A) | (blob == 0x09)
            ws_cum = np.concatenate([[0], np.cumsum(is_ws, dtype=np.int64)])
            n_ws = ws_cum[key_offsets[1:]] - ws_cum[key_offsets[:-1]]
            eligible = (lens > 1) & (n_ws < 2)
            order_f = order[eligible[order]]
            if len(order_f):
                n_take = max(1, seed_size - len(seed_pieces))
                for idx in order_f[:n_take]:
                    raw = keys_blob[key_offsets[idx]: key_offsets[idx + 1]]
                    seed_pieces.append((bytes_to_byte_chars(raw), float(scores[idx])))

        if not push_current:
            self.seed_cache.popleft()
            if maybe_prev is not None:
                self.seed_cache.append(maybe_prev)
        return seed_pieces
