"""Text normalizers, JSON-compatible with HF tokenizers' serialization
(counterpart of ``zett_tpu/tokenization/normalizers.py``): ``Prepend``,
``Sequence``, the unicode forms, ``Lowercase``, ``Replace`` with a
``String`` or a ``Regex`` pattern, ``Strip`` and ``BertNormalizer``.

Standard library only. A ``Regex`` pattern runs as ``patterns.py`` says:
the stdlib ``re`` on its translation (Unicode classes as code-point
ranges), else it raises ``NotImplementedError`` naming ROADMAP A.16 when
first used. Any other unknown type raises ``ValueError``.
"""

from __future__ import annotations

import unicodedata
from typing import Optional

from .patterns import compile_pattern


class Normalizer:
    def normalize_str(self, text: str) -> str:
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_json(data: Optional[dict]) -> Optional["Normalizer"]:
        if data is None:
            return None
        t = data["type"]
        if t == "Prepend":
            return Prepend(data["prepend"])
        if t == "Sequence":
            return Sequence([Normalizer.from_json(n) for n in data["normalizers"]])
        if t in ("NFC", "NFD", "NFKC", "NFKD"):
            return UnicodeForm(t)
        if t == "Lowercase":
            return Lowercase()
        if t == "Replace":
            return Replace(data["pattern"], data["content"])
        if t == "Strip":
            return Strip(data.get("strip_left", True), data.get("strip_right", True))
        if t == "BertNormalizer":
            return BertNormalizer(
                clean_text=data.get("clean_text", True),
                handle_chinese_chars=data.get("handle_chinese_chars", True),
                strip_accents=data.get("strip_accents"),
                lowercase=data.get("lowercase", True),
            )
        raise ValueError(f"Unsupported normalizer type: {t}")


class Prepend(Normalizer):
    def __init__(self, prepend: str):
        self.prepend = prepend

    def normalize_str(self, text: str) -> str:
        return self.prepend + text if text else text

    def to_json(self) -> dict:
        return {"type": "Prepend", "prepend": self.prepend}


class Sequence(Normalizer):
    def __init__(self, normalizers):
        self.normalizers = [n for n in normalizers if n is not None]

    def normalize_str(self, text: str) -> str:
        for n in self.normalizers:
            text = n.normalize_str(text)
        return text

    def to_json(self) -> dict:
        return {"type": "Sequence", "normalizers": [n.to_json() for n in self.normalizers]}


class UnicodeForm(Normalizer):
    def __init__(self, form: str):
        assert form in ("NFC", "NFD", "NFKC", "NFKD")
        self.form = form

    def normalize_str(self, text: str) -> str:
        return unicodedata.normalize(self.form, text)

    def to_json(self) -> dict:
        return {"type": self.form}


class Lowercase(Normalizer):
    def normalize_str(self, text: str) -> str:
        return text.lower()

    def to_json(self) -> dict:
        return {"type": "Lowercase"}


class Replace(Normalizer):
    def __init__(self, pattern, content: str):
        # pattern is either {"String": s} or {"Regex": r}
        self.pattern = pattern
        self.content = content
        if isinstance(pattern, dict) and "Regex" in pattern:
            self._rx = compile_pattern(pattern["Regex"], "Replace normalizer")
            self._lit = None
        else:
            self._rx = None
            self._lit = pattern["String"] if isinstance(pattern, dict) else pattern

    def normalize_str(self, text: str) -> str:
        if self._rx is not None:
            return self._rx.sub(self.content, text)
        return text.replace(self._lit, self.content)

    def to_json(self) -> dict:
        pattern = self.pattern if isinstance(self.pattern, dict) else {"String": self.pattern}
        return {"type": "Replace", "pattern": pattern, "content": self.content}


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BertNormalizer(Normalizer):
    def __init__(
        self,
        clean_text: bool = True,
        handle_chinese_chars: bool = True,
        strip_accents: Optional[bool] = None,
        lowercase: bool = True,
    ):
        self.clean_text = clean_text
        self.handle_chinese_chars = handle_chinese_chars
        self.strip_accents = strip_accents
        self.lowercase = lowercase

    def normalize_str(self, text: str) -> str:
        if self.clean_text:
            out = []
            for c in text:
                cp = ord(c)
                if cp == 0 or cp == 0xFFFD or (unicodedata.category(c).startswith("C")
                                               and c not in "\t\n\r"):
                    continue
                out.append(" " if c.isspace() else c)
            text = "".join(out)
        if self.handle_chinese_chars:
            text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
        strip_accents = self.strip_accents
        if strip_accents is None:
            strip_accents = self.lowercase
        if self.lowercase:
            text = text.lower()
        if strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        return text

    def to_json(self) -> dict:
        return {
            "type": "BertNormalizer",
            "clean_text": self.clean_text,
            "handle_chinese_chars": self.handle_chinese_chars,
            "strip_accents": self.strip_accents,
            "lowercase": self.lowercase,
        }


class Strip(Normalizer):
    def __init__(self, left: bool = True, right: bool = True):
        self.left = left
        self.right = right

    def normalize_str(self, text: str) -> str:
        if self.left:
            text = text.lstrip()
        if self.right:
            text = text.rstrip()
        return text

    def to_json(self) -> dict:
        return {"type": "Strip", "strip_left": self.left, "strip_right": self.right}
