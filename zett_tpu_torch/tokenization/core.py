"""The top-level Tokenizer: tokenizer.json load/save, vocab, added and
special tokens.

Counterpart of ``zett_tpu/tokenization/core.py``. The normalizer,
pre-tokenizer, post-processor and decoder are kept as their tokenizer.json
dicts and written back unchanged. Text is encoded only by the native fast
path of canonical byte-level tokenizers (``fast_encode.py``); the general
``encode`` pipeline needs ``regex`` and is not ported.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import models as _models


@dataclass
class AddedToken:
    content: str
    single_word: bool = False
    lstrip: bool = False
    rstrip: bool = False
    normalized: bool = True
    special: bool = False

    @staticmethod
    def from_json(x: dict) -> "AddedToken":
        return AddedToken(
            x["content"],
            single_word=x.get("single_word", False),
            lstrip=x.get("lstrip", False),
            rstrip=x.get("rstrip", False),
            normalized=x.get("normalized", True),
            special=x.get("special", False),
        )

    def to_json(self, idx: int) -> dict:
        return {
            "id": idx,
            "content": self.content,
            "single_word": self.single_word,
            "lstrip": self.lstrip,
            "rstrip": self.rstrip,
            "normalized": self.normalized,
            "special": self.special,
        }


class Tokenizer:
    def __init__(
        self,
        model: _models.Model,
        normalizer: Optional[dict] = None,
        pre_tokenizer: Optional[dict] = None,
        post_processor: Optional[dict] = None,
        decoder: Optional[dict] = None,
    ):
        self.model = model
        self.normalizer = copy.deepcopy(normalizer)
        self.pre_tokenizer = copy.deepcopy(pre_tokenizer)
        self.post_processor = copy.deepcopy(post_processor)
        self.decoder = copy.deepcopy(decoder)
        # content -> (id, AddedToken)
        self._added: Dict[str, Tuple[int, AddedToken]] = {}

    # ------------------------------------------------------------------ vocab
    def get_vocab(self, with_added_tokens: bool = True) -> Dict[str, int]:
        vocab = dict(self.model.get_vocab())
        if with_added_tokens:
            for content, (idx, _) in self._added.items():
                vocab.setdefault(content, idx)
        return vocab

    def get_vocab_size(self, with_added_tokens: bool = True) -> int:
        vocab = self.get_vocab(with_added_tokens)
        return max(vocab.values()) + 1 if vocab else 0

    def token_to_id(self, token: str) -> Optional[int]:
        hit = self._added.get(token)
        if hit is not None:
            return hit[0]
        return self.model.token_to_id(token)

    def id_to_token(self, idx: int) -> Optional[str]:
        for content, (i, _) in self._added.items():
            if i == idx:
                return content
        return self.model.id_to_token(idx)

    # ----------------------------------------------------------- added tokens
    def register_added_token(self, at: AddedToken, idx: int):
        """Register an added token at an explicit id."""
        self._added[at.content] = (idx, at)

    @property
    def added_tokens(self) -> List[Tuple[int, AddedToken]]:
        return sorted(((i, at) for i, at in self._added.values()), key=lambda x: x[0])

    @property
    def all_special_tokens(self) -> List[str]:
        return [at.content for _, at in self.added_tokens if at.special]

    @property
    def all_special_ids(self) -> List[int]:
        return [i for i, at in self.added_tokens if at.special]

    def __len__(self) -> int:
        return self.get_vocab_size(with_added_tokens=True)

    # ----------------------------------------------------------------- (de)ser
    def to_json(self) -> dict:
        return {
            "version": "1.0",
            "truncation": None,
            "padding": None,
            "added_tokens": [at.to_json(i) for i, at in self.added_tokens],
            "normalizer": copy.deepcopy(self.normalizer),
            "pre_tokenizer": copy.deepcopy(self.pre_tokenizer),
            "post_processor": copy.deepcopy(self.post_processor),
            "decoder": copy.deepcopy(self.decoder),
            "model": self.model.to_json(),
        }

    def to_str(self, pretty: bool = False) -> str:
        return json.dumps(self.to_json(), indent=2 if pretty else None, ensure_ascii=False)

    def save(self, path: str, pretty: bool = True):
        with open(path, "w") as f:
            f.write(self.to_str(pretty))

    @staticmethod
    def from_json(data: dict) -> "Tokenizer":
        tok = Tokenizer(
            model=_models.Model.from_json(data["model"]),
            normalizer=data.get("normalizer"),
            pre_tokenizer=data.get("pre_tokenizer"),
            post_processor=data.get("post_processor"),
            decoder=data.get("decoder"),
        )
        for at_json in data.get("added_tokens", []):
            tok.register_added_token(AddedToken.from_json(at_json), at_json["id"])
        return tok

    def copy(self) -> "Tokenizer":
        return Tokenizer.from_json(copy.deepcopy(self.to_json()))

    @staticmethod
    def from_str(s: str) -> "Tokenizer":
        # parse floats from their raw decimal bytes with serde_json semantics
        # (see jsonfloat.py), as HF and the JAX package do
        from .jsonfloat import serde_parse_float

        return Tokenizer.from_json(json.loads(s, parse_float=serde_parse_float))

    @staticmethod
    def from_file(path: str) -> "Tokenizer":
        with open(path) as f:
            return Tokenizer.from_str(f.read())
