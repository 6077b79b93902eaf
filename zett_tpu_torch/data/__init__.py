"""The training data path: text streams, tokenizer sampling and batches."""

from .collator import Collator, build_sampled_tokenizer
from .config import DataConfig
from .datasets import LanguageStream, TrainDataset

__all__ = ["Collator", "DataConfig", "LanguageStream", "TrainDataset",
           "build_sampled_tokenizer"]
