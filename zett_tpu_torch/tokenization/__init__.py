"""Host tokenization of the transfer path (no third-party dependencies)."""

from .core import AddedToken, Tokenizer
from .models import BPE, Model, Unigram, WordPiece

__all__ = ["AddedToken", "BPE", "Model", "Tokenizer", "Unigram", "WordPiece"]
