"""Data-pipeline configuration (counterpart of ``zett_tpu/data/config.py``;
the same fields and defaults)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class DataConfig:
    block_size: int = 128
    do_tokenizer_sampling: bool = True
    use_passthrough_hypernet: bool = False
    hn_surface_maxlen: int = 7
    n_token_subsample: Optional[int] = 16384
    # identity-warmup batches subsample the reference vocab to this size when
    # set (reference identity_n_subsample, train.py:160,501-502)
    identity_n_subsample: Optional[int] = None
    pad_to_multiple_of: int = 128
    subsample_mode: str = "random"  # "random" | "positives_only"
    tokenizer_sample_mean: float = 32768.0
    tokenizer_sample_std: float = 0.0
    tokenizer_sample_min: int = 32768
    tokenizer_sample_max: int = 32768
    tokenizer_noise_mean: float = 1e-5
    tokenizer_noise_std: float = 2.0
    tokenizer_batch_size: int = 512
    sample_text_span: bool = True
    n_pools: int = 1
    add_prefix_space: bool = True
    do_sequence_packing: bool = True
    langs: List[str] = field(default_factory=lambda: ["en"])
    language_sampling_alpha: float = 0.3
    # interleave languages within each batch (lang_code="all") instead of the
    # default single-language batches (reference mix_languages, train.py:90)
    mix_languages: bool = False
