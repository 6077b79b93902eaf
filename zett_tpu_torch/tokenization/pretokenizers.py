"""Pre-tokenizers over the dict-held ``pre_tokenizer`` of a tokenizer.json
(counterpart of ``zett_tpu/tokenization/pretokenizers.py``), the subset the
byte-level conversion's metaspace probe runs: ``Metaspace``, ``Sequence``,
``ByteLevel`` without its regex split, ``Whitespace`` and
``BertPreTokenizer``.

Standard library only. A ``Split`` with a ``Regex`` pattern, and a
``ByteLevel`` with ``use_regex`` (the GPT-2 split), raise
``NotImplementedError`` naming the pattern: the card's machine has no
``regex`` module, and an approximation with ``re`` could silently differ.
(Byte-level tokenizers never reach the probe: their surface forms are
their tokens.) ``Whitespace`` is ``\\w+|[^\\w\\s]+`` under ``re``'s Unicode
``\\w``.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Optional, Tuple

from ..constants import SPLIT_REGEX_NO_MARKS
from .bytemaps import BYTES_TO_CHARS

# (pretoken, (char_start, char_end)) relative to the text
Pretoken = Tuple[str, Tuple[int, int]]

_WHITESPACE = re.compile(r"\w+|[^\w\s]+")


def _regex_unsupported(what: str, pattern: str):
    return NotImplementedError(
        f"{what} with the Regex pattern {pattern!r}: regular expressions of "
        "tokenizer.json need the regex module, which the port does not use")


def _is_bert_punct(c: str) -> bool:
    # HF/bert punctuation: unicode P plus the ASCII symbols $ + < = > ^ ` | ~
    return unicodedata.category(c).startswith("P") or c in "$+<=>^`|~"


def _matches(rx, text: str) -> List[Pretoken]:
    return [(m.group(), (m.start(), m.end())) for m in rx.finditer(text)]


def _metaspace(data: dict, text: str) -> List[Pretoken]:
    repl = data.get("replacement", "▁")
    if data.get("prepend_scheme", "always") in ("always", "first") and text \
            and not text.startswith(" "):
        text = " " + text
    replaced = text.replace(" ", repl)
    if not data.get("split", True):
        return [(replaced, (0, len(text)))] if replaced else []
    out = _matches(re.compile(re.escape(repl) + "[^" + re.escape(repl) + "]*"), replaced)
    if not out and replaced:
        out = [(replaced, (0, len(replaced)))]
    return out


def _bert_pretokenize(text: str) -> List[Pretoken]:
    """Whitespace split, each punctuation character its own pretoken."""
    out: List[Pretoken] = []
    start = None
    for i, c in enumerate(text):
        if c.isspace() or _is_bert_punct(c):
            if start is not None:
                out.append((text[start:i], (start, i)))
                start = None
            if not c.isspace():
                out.append((c, (i, i + 1)))
        elif start is None:
            start = i
    if start is not None:
        out.append((text[start:], (start, len(text))))
    return out


def _byte_level(data: dict, text: str) -> List[Pretoken]:
    if data.get("use_regex", True):
        raise _regex_unsupported("ByteLevel pre-tokenizer", SPLIT_REGEX_NO_MARKS)
    shift = 0
    if data.get("add_prefix_space", True) and text and not text.startswith(" "):
        text = " " + text
        shift = -1  # offsets refer to the original string
    if not text:
        return []
    mapped = "".join(BYTES_TO_CHARS[b] for b in text.encode("utf-8"))
    return [(mapped, (0, max(len(text) + shift, 0)))]


def pre_tokenize_str(data: Optional[dict], text: str) -> List[Pretoken]:
    """``text`` through the pre-tokenizer ``data`` (None: one pretoken)."""
    if data is None:
        return [(text, (0, len(text)))]
    t = data["type"]
    if t == "Sequence":
        pieces: List[Pretoken] = [(text, (0, len(text)))]
        for p in data["pretokenizers"]:
            nxt: List[Pretoken] = []
            for piece, (start, _) in pieces:
                for sub, (s, e) in pre_tokenize_str(p, piece):
                    nxt.append((sub, (start + s, start + e)))
            pieces = nxt
        return pieces
    if t == "Metaspace":
        return _metaspace(data, text)
    if t == "ByteLevel":
        return _byte_level(data, text)
    if t == "Whitespace":
        return _matches(_WHITESPACE, text)
    if t == "BertPreTokenizer":
        return _bert_pretokenize(text)
    if t == "Split" and "Regex" in data["pattern"]:
        raise _regex_unsupported("Split pre-tokenizer", data["pattern"]["Regex"])
    raise ValueError(f"Unsupported pre_tokenizer type: {t}")
