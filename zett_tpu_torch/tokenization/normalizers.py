"""Text normalizers over the dict-held ``normalizer`` of a tokenizer.json
(counterpart of ``zett_tpu/tokenization/normalizers.py``), the subset the
byte-level conversion's metaspace probe runs: ``Prepend``, ``Replace``
with a ``String`` pattern, ``Sequence``, ``Strip``, ``Lowercase``, the
unicode forms (``unicodedata``) and ``BertNormalizer``.

Standard library only. A ``Replace`` with a ``Regex`` pattern raises
``NotImplementedError`` naming the pattern: the card's machine has no
``regex`` module, and an approximation with ``re`` could silently differ.
Any other unknown type raises ``ValueError``.
"""

from __future__ import annotations

import unicodedata
from typing import Optional


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


def _bert_normalize(data: dict, text: str) -> str:
    if data.get("clean_text", True):
        out = []
        for c in text:
            cp = ord(c)
            if cp == 0 or cp == 0xFFFD or (unicodedata.category(c).startswith("C")
                                           and c not in "\t\n\r"):
                continue
            out.append(" " if c.isspace() else c)
        text = "".join(out)
    if data.get("handle_chinese_chars", True):
        text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
    lowercase = data.get("lowercase", True)
    strip_accents = data.get("strip_accents")
    if strip_accents is None:
        strip_accents = lowercase
    if lowercase:
        text = text.lower()
    if strip_accents:
        text = "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")
    return text


def normalize_str(data: Optional[dict], text: str) -> str:
    """``text`` through the normalizer ``data`` (None: unchanged)."""
    if data is None:
        return text
    t = data["type"]
    if t == "Prepend":
        return data["prepend"] + text if text else text
    if t == "Sequence":
        for n in data["normalizers"]:
            text = normalize_str(n, text)
        return text
    if t in ("NFC", "NFD", "NFKC", "NFKD"):
        return unicodedata.normalize(t, text)
    if t == "Lowercase":
        return text.lower()
    if t == "Strip":
        if data.get("strip_left", True):
            text = text.lstrip()
        if data.get("strip_right", True):
            text = text.rstrip()
        return text
    if t == "Replace":
        pattern = data["pattern"]
        if isinstance(pattern, dict) and "Regex" in pattern:
            raise NotImplementedError(
                f"Replace normalizer with the Regex pattern {pattern['Regex']!r}: regular "
                "expressions of tokenizer.json need the regex module, which the port does "
                "not use")
        literal = pattern["String"] if isinstance(pattern, dict) else pattern
        return text.replace(literal, data["content"])
    if t == "BertNormalizer":
        return _bert_normalize(data, text)
    raise ValueError(f"Unsupported normalizer type: {t}")
