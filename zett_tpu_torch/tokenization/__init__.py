"""Host tokenization (no third-party dependencies): tokenizer.json load and
save, the general encode pipeline and decode."""

from .core import AddedToken, Encoding, Tokenizer
from .models import BPE, Model, Unigram, WordPiece

__all__ = ["AddedToken", "BPE", "Encoding", "Model", "Tokenizer", "Unigram", "WordPiece"]
