"""The regular expressions of tokenizer.json without the ``regex`` module.

The JAX package compiles every ``Regex`` pattern of a tokenizer.json with
``regex``, which the card's machine lacks. The port runs a pattern three
ways, and refuses the rest:

- the two GPT-2 splits (``SPLIT_REGEX``, ``SPLIT_REGEX_NO_MARKS``) go to the
  native scanner of ``csrc/zett_host.cpp`` (``split_pretokens``);
- any other pattern goes to the standard library's ``re`` only when it uses
  none of the syntax in which ``re`` and ``regex`` differ
  (``unsupported_syntax``): Unicode properties (``\\p``, ``\\P``), grapheme
  clusters (``\\X``), the shorthand classes whose Unicode sets differ
  (``\\w``, ``\\s``, ``\\d``, ``\\b`` and their negations), possessive
  quantifiers, atomic groups, POSIX classes, set operations and nested sets,
  version and ``regex``-only flags, fuzzy quantifiers and any other escape
  or group that ``re`` reads another way;
- the named pre-tokenizers whose JAX patterns use Unicode classes (``Digits``,
  ``Punctuation``, ``BertPreTokenizer``) are hand-written scanners over the
  class table the native scanner reads (``unicode_classes_v1.npy``, made
  with ``regex``: 1 = \\s, 2 = \\p{L}, 4 = \\p{M}, 8 = \\p{N}) and
  ``unicodedata``'s categories.

A refused pattern raises ``NotImplementedError`` where it is first used,
naming the pattern and ROADMAP A.5's matcher, so that a tokenizer holding
one still loads, converts and transfers.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Optional, Tuple

from ..constants import SPLIT_REGEX, SPLIT_REGEX_NO_MARKS

Span = Tuple[int, int]

SPACE, LETTER, MARK, NUMBER = 1, 2, 4, 8

_CTAB = None


def char_classes():
    """The (0x110000,) uint8 class table of the native scanner."""
    global _CTAB
    if _CTAB is None:
        from ..csrc.host_lib import unicode_class_table

        _CTAB = unicode_class_table()
    return _CTAB


def is_space(c: str) -> bool:
    """``regex``'s ``\\s``."""
    return bool(char_classes()[ord(c)] & SPACE)


def is_number(c: str) -> bool:
    """``regex``'s ``\\p{N}``."""
    return bool(char_classes()[ord(c)] & NUMBER)


def is_punctuation(c: str) -> bool:
    """``\\p{P}`` (``unicodedata``'s Unicode version)."""
    return unicodedata.category(c).startswith("P")


# Other_Alphabetic symbols: circled and squared Latin letters
_ALPHABETIC_SYMBOLS = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
                       (0x1F170, 0x1F189))


def is_word(c: str) -> bool:
    """``regex``'s Unicode ``\\w``: letters, marks, decimal and letter
    numbers, connector punctuation, the joiners and the alphabetic symbols.
    (``re``'s ``\\w`` is ``str.isalnum`` or ``_``, which takes ² and leaves
    combining marks out.)"""
    cp = ord(c)
    k = char_classes()[cp]
    if k & (LETTER | MARK):
        return True
    cat = unicodedata.category(c)
    if (k & NUMBER and cat != "No") or cat == "Pc" or cp in (0x200C, 0x200D):
        return True
    return any(lo <= cp <= hi for lo, hi in _ALPHABETIC_SYMBOLS)


def regex_escape(text: str) -> str:
    """``regex.escape(text)``: ``re.escape`` that also escapes whitespace
    (``str.isspace``)."""
    return "".join("\\" + c if c.isspace() and re.escape(c) == c else re.escape(c)
                   for c in text)


# escapes that mean the same in re and regex: digits (back references) and
# these letters; a backslash before any other character quotes it in both
_SAME_ESCAPES = set("0123456789aftnrvxuUNAZ")
_RE_FLAGS = set("imsxau-")
_QUANTIFIER = re.compile(r"\{(\d*)(,\d*)?\}")


def unsupported_syntax(pattern: str) -> Optional[str]:
    """Why ``pattern`` may match differently under ``re`` than under
    ``regex``, or None when it reads the same under both."""
    i, n = 0, len(pattern)
    in_class = False
    class_start = 0
    prev_quantifier = False
    while i < n:
        c = pattern[i]
        quantifier = False
        if c == "\\":
            if i + 1 >= n:
                return "a trailing backslash"
            e = pattern[i + 1]
            if e.isalnum() and e not in _SAME_ESCAPES:
                return f"the escape \\{e}"
            i += 2
            prev_quantifier = False
            continue
        if in_class:
            if c == "]" and i > class_start:
                in_class = False
            elif c == "[":
                return ("a POSIX class" if pattern.startswith("[:", i)
                        else "a nested set")
            elif pattern.startswith(("&&", "||", "--", "~~"), i):
                return f"the set operation {pattern[i:i + 2]}"
            i += 1
            continue
        if c == "[":
            in_class = True
            i += 1
            if i < n and pattern[i] == "^":
                i += 1
            class_start = i  # a "]" here is a literal
            prev_quantifier = False
            continue
        if c == "(" and pattern.startswith("(?", i):
            rest = pattern[i + 2:]
            if rest.startswith(">"):
                return "an atomic group"
            if not (rest.startswith((":", "=", "!", "<=", "<!", "P<", "P=", "#"))
                    or (rest.startswith("(") and rest[1:2].isalnum())):
                flags = re.match(r"[A-Za-z\-]*", rest).group()
                closed = rest[len(flags):][:1] in (")", ":")
                if not flags or not set(flags) <= _RE_FLAGS or not closed:
                    return f"the group or flags (?{rest[:max(len(flags), 1)]}"
        elif c in "*+?":
            if prev_quantifier and c == "+":
                return "a possessive quantifier"
            quantifier = c != "?" or not prev_quantifier  # lazy "?" ends it
        elif c == "{":
            m = _QUANTIFIER.match(pattern, i)
            if m is None or m.group() == "{}" or m.group() == "{,}":
                return "a brace that is not a counted quantifier (a fuzzy match in regex)"
            i = m.end()
            prev_quantifier = True
            continue
        prev_quantifier = quantifier
        i += 1
    if in_class:
        return "an unterminated set"
    return None


def refusal(what: str, pattern: str, reason: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} with the Regex pattern {pattern!r}: {reason} matches differently under the "
        "standard library's re than under the regex module, which the port does not use "
        "(ROADMAP A.5: a matcher for such patterns)")


class Matcher:
    """Leftmost, non-overlapping matches of one pattern: ``spans(text)``
    gives their (start, end) in characters, ``sub`` replaces them."""

    def spans(self, text: str) -> List[Span]:
        raise NotImplementedError

    def sub(self, repl: str, text: str) -> str:
        out, pos = [], 0
        for s, e in self.spans(text):
            out.append(text[pos:s])
            out.append(repl)
            pos = e
        out.append(text[pos:])
        return "".join(out)


class Gpt2Split(Matcher):
    """The GPT-2 split on the native scanner: its matches tile the text."""

    def __init__(self, use_marks: bool):
        self.use_marks = use_marks

    def spans(self, text: str) -> List[Span]:
        from ..csrc.host_lib import split_pretokens_native

        out, pos = [], 0
        for piece in split_pretokens_native(text.encode("utf-8"), use_marks=self.use_marks):
            end = pos + len(piece.decode("utf-8"))
            out.append((pos, end))
            pos = end
        return out


class StdlibRegex(Matcher):
    def __init__(self, compiled):
        self.rx = compiled

    def spans(self, text: str) -> List[Span]:
        return [m.span() for m in self.rx.finditer(text)]

    def sub(self, repl: str, text: str) -> str:
        return self.rx.sub(repl, text)


class CharRuns(Matcher):
    """Matches of ``[class]`` (single) or ``[class]+`` (runs) for a
    character predicate."""

    def __init__(self, pred, runs: bool):
        self.pred = pred
        self.runs = runs

    def spans(self, text: str) -> List[Span]:
        out: List[Span] = []
        start = None
        for i, c in enumerate(text):
            if self.pred(c):
                if not self.runs:
                    out.append((i, i + 1))
                elif start is None:
                    start = i
            elif start is not None:
                out.append((start, i))
                start = None
        if start is not None:
            out.append((start, len(text)))
        return out


class Refused(Matcher):
    def __init__(self, error: NotImplementedError):
        self.error = error

    def spans(self, text: str) -> List[Span]:
        raise self.error


def compile_pattern(pattern: str, what: str) -> Matcher:
    """The matcher of a tokenizer.json ``Regex`` pattern (see the module
    docstring); a refused one raises when it is used."""
    if pattern in (SPLIT_REGEX, SPLIT_REGEX_NO_MARKS):
        return Gpt2Split(use_marks=pattern == SPLIT_REGEX)
    reason = unsupported_syntax(pattern)
    if reason is None:
        try:
            return StdlibRegex(re.compile(pattern))
        except re.error as exc:
            reason = f"a pattern re cannot compile ({exc})"
    return Refused(refusal(what, pattern, reason))
