"""Pre-tokenizers, JSON-compatible with HF tokenizers' serialization
(counterpart of ``zett_tpu/tokenization/pretokenizers.py``): ``Sequence``,
``Split`` (every ``behavior``, ``invert``), ``ByteLevel``
(``add_prefix_space``, ``use_regex``), ``Metaspace`` (``prepend_scheme``,
``split``), ``BertPreTokenizer``, ``Digits``, and ``Whitespace``,
``WhitespaceSplit`` and ``Punctuation`` as the ``Split`` JAX maps them to.
Each returns ``(pretoken, (start, end))`` in characters of its input, as
JAX's ``pre_tokenize_str`` does.

Standard library only: the patterns run as ``patterns.py`` says (the GPT-2
split on the native scanner, other ``Regex`` patterns on ``re`` as
``patterns.translate`` rewrites them, Unicode classes as code-point ranges,
else ``NotImplementedError`` naming ROADMAP A.16 when used), JAX's
``Whitespace``, ``WhitespaceSplit`` and ``Digits`` patterns among them.
``Punctuation``'s ``\\p{P}`` and ``BertPreTokenizer`` are scanners over
``unicodedata``'s categories and ``regex``'s ``\\s``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..constants import SPLIT_REGEX_NO_MARKS
from .bytemaps import bytes_to_byte_chars
from .patterns import (CharRuns, Gpt2Split, Matcher, compile_pattern, is_punctuation, is_space,
                       regex_escape)

# (pretoken, (char_start, char_end)) relative to the normalized text
Pretoken = Tuple[str, Tuple[int, int]]


class PreTokenizer:
    def pre_tokenize_str(self, text: str) -> List[Pretoken]:
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_json(data: Optional[dict]) -> Optional["PreTokenizer"]:
        if data is None:
            return None
        t = data["type"]
        if t == "Sequence":
            return Sequence([PreTokenizer.from_json(p) for p in data["pretokenizers"]])
        if t == "Split":
            pattern = data["pattern"]
            pattern = pattern["Regex"] if "Regex" in pattern else regex_escape(pattern["String"])
            return Split(pattern, behavior=data["behavior"], invert=data["invert"])
        if t == "ByteLevel":
            return ByteLevel(
                add_prefix_space=data.get("add_prefix_space", True),
                use_regex=data.get("use_regex", True),
                trim_offsets=data.get("trim_offsets", True),
            )
        if t == "Whitespace":
            return Split(r"\w+|[^\w\s]+", behavior="Removed", invert=True)
        if t == "WhitespaceSplit":
            return Split(r"\S+", behavior="Removed", invert=True)
        if t == "Metaspace":
            return Metaspace(
                replacement=data.get("replacement", "▁"),
                prepend_scheme=data.get("prepend_scheme", "always"),
                split=data.get("split", True),
            )
        if t == "Digits":
            return Digits(individual_digits=data.get("individual_digits", False))
        if t == "BertPreTokenizer":
            return BertPreTokenizer()
        if t == "Punctuation":
            return Split(r"\p{P}", behavior=data.get("behavior", "Isolated"), invert=False,
                         matcher=CharRuns(is_punctuation, runs=False))
        raise ValueError(f"Unsupported pre_tokenizer type: {t}")


class Sequence(PreTokenizer):
    def __init__(self, pretokenizers):
        self.pretokenizers = [p for p in pretokenizers if p is not None]

    def pre_tokenize_str(self, text: str) -> List[Pretoken]:
        pieces: List[Pretoken] = [(text, (0, len(text)))]
        for p in self.pretokenizers:
            nxt: List[Pretoken] = []
            for piece, (start, _) in pieces:
                for sub, (s, e) in p.pre_tokenize_str(piece):
                    nxt.append((sub, (start + s, start + e)))
            pieces = nxt
        return pieces

    def to_json(self) -> dict:
        return {
            "type": "Sequence",
            "pretokenizers": [p.to_json() for p in self.pretokenizers],
        }


def _split(spans, text: str, behavior: str, invert: bool) -> List[Pretoken]:
    """JAX's ``Split.pre_tokenize_str`` over the pattern's match spans."""
    behavior = behavior.lower()
    out: List[Pretoken] = []
    if invert:
        # matches become the pretokens; gaps are dropped
        return [(text[s:e], (s, e)) for s, e in spans if s != e]
    prev = 0
    for s, e in spans:
        if s == e:
            continue
        if prev < s:
            out.append((text[prev:s], (prev, s)))
        if behavior in ("isolated", "merged_with_next"):
            out.append((text[s:e], (s, e)))
        elif behavior == "merged_with_previous" and out:
            last, (ls, _) = out.pop()
            out.append((last + text[s:e], (ls, e)))
        # "removed": drop the delimiter
        prev = e
    if prev < len(text):
        out.append((text[prev:], (prev, len(text))))
    return out


class Split(PreTokenizer):
    """Regex split. With invert=True the pattern describes the *tokens*."""

    def __init__(self, pattern: str, behavior: str = "Removed", invert: bool = False,
                 matcher: Optional[Matcher] = None):
        self.pattern = pattern
        self.behavior = behavior
        self.invert = invert
        self._matcher = matcher or compile_pattern(pattern, "Split pre-tokenizer")

    def pre_tokenize_str(self, text: str) -> List[Pretoken]:
        return _split(self._matcher.spans(text), text, self.behavior, self.invert)

    def to_json(self) -> dict:
        return {
            "type": "Split",
            "pattern": {"Regex": self.pattern},
            "behavior": self.behavior.capitalize() if self.behavior.islower() else self.behavior,
            "invert": self.invert,
        }


_BYTE_LEVEL_SPLIT = Gpt2Split(use_marks=False)  # SPLIT_REGEX_NO_MARKS


class ByteLevel(PreTokenizer):
    """Map pretokens to the printable byte alphabet (GPT-2 style).

    With use_regex=True the GPT-2 split (``SPLIT_REGEX_NO_MARKS``) runs
    first; add_prefix_space prepends a space to the text if it doesn't start
    with one.
    """

    pattern = SPLIT_REGEX_NO_MARKS

    def __init__(self, add_prefix_space: bool = True, use_regex: bool = True,
                 trim_offsets: bool = True):
        self.add_prefix_space = add_prefix_space
        self.use_regex = use_regex
        self.trim_offsets = trim_offsets

    def pre_tokenize_str(self, text: str) -> List[Pretoken]:
        offset_shift = 0
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
            offset_shift = -1  # offsets refer to the original string
        if self.use_regex:
            spans = _BYTE_LEVEL_SPLIT.spans(text)
        else:
            spans = [(0, len(text))] if text else []
        return [(bytes_to_byte_chars(text[s:e].encode("utf-8")),
                 (max(s + offset_shift, 0), max(e + offset_shift, 0))) for s, e in spans]

    def to_json(self) -> dict:
        return {
            "type": "ByteLevel",
            "add_prefix_space": self.add_prefix_space,
            "trim_offsets": self.trim_offsets,
            "use_regex": self.use_regex,
        }


class Metaspace(PreTokenizer):
    """SentencePiece-style: replace spaces with the metaspace char; with
    split, each pretoken is a metaspace char and what follows up to the
    next (text before the first is dropped, as in JAX)."""

    def __init__(self, replacement: str = "▁", prepend_scheme: str = "always",
                 split: bool = True):
        self.replacement = replacement
        self.prepend_scheme = prepend_scheme
        self.split = split

    def pre_tokenize_str(self, text: str) -> List[Pretoken]:
        if self.prepend_scheme in ("always", "first") and text and not text.startswith(" "):
            text = " " + text
        replaced = text.replace(" ", self.replacement)
        if not self.split:
            return [(replaced, (0, len(text)))] if replaced else []
        # each replacement char starts a match: "▁▁x" gives "▁", "▁x"
        repl = self.replacement
        out: List[Pretoken] = []
        i, n = 0, len(replaced)
        while i < n:
            if replaced[i] == repl:
                j = i + 1
                while j < n and replaced[j] != repl:
                    j += 1
                out.append((replaced[i:j], (i, j)))
                i = j
            else:
                i += 1
        if not out and replaced:
            out = [(replaced, (0, len(replaced)))]
        return out

    def to_json(self) -> dict:
        return {
            "type": "Metaspace",
            "replacement": self.replacement,
            "prepend_scheme": self.prepend_scheme,
            "split": self.split,
        }


def _is_bert_punct(c: str) -> bool:
    # HF/bert punctuation: unicode P plus the ASCII symbols $ + < = > ^ ` | ~
    return is_punctuation(c) or c in "$+<=>^`|~"


class BertPreTokenizer(PreTokenizer):
    """Whitespace split, then isolate each punctuation character (JAX's
    ``[^\\s{P}]+|{P}`` with P the punctuation above)."""

    def pre_tokenize_str(self, text: str) -> List[Pretoken]:
        out: List[Pretoken] = []
        start = None
        for i, c in enumerate(text):
            if is_space(c) or _is_bert_punct(c):
                if start is not None:
                    out.append((text[start:i], (start, i)))
                    start = None
                if not is_space(c):
                    out.append((c, (i, i + 1)))
            elif start is None:
                start = i
        if start is not None:
            out.append((text[start:], (start, len(text))))
        return out

    def to_json(self) -> dict:
        return {"type": "BertPreTokenizer"}


class Digits(PreTokenizer):
    def __init__(self, individual_digits: bool = False):
        self.individual_digits = individual_digits
        self._matcher = compile_pattern(r"\p{N}" if individual_digits else r"\p{N}+",
                                        "Digits pre-tokenizer")

    def pre_tokenize_str(self, text: str) -> List[Pretoken]:
        return _split(self._matcher.spans(text), text, "Isolated", False)

    def to_json(self) -> dict:
        return {"type": "Digits", "individual_digits": self.individual_digits}
