"""The training data path: text streams, tokenizer sampling and batches."""

from .collator import Collator, build_sampled_tokenizer
from .config import DataConfig
from .datasets import LanguageStream, TrainDataset, ValidDataset

__all__ = ["Collator", "DataConfig", "LanguageStream", "TrainDataset", "ValidDataset",
           "build_sampled_tokenizer"]
