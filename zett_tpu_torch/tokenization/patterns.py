"""The regular expressions of tokenizer.json without the ``regex`` module.

The JAX package compiles every ``Regex`` pattern of a tokenizer.json with
``regex``, which the card's machine lacks. The port runs a pattern three
ways, and refuses the rest:

- the two GPT-2 splits (``SPLIT_REGEX``, ``SPLIT_REGEX_NO_MARKS``) go to the
  native scanner of ``csrc/zett_host.cpp`` (``split_pretokens``);
- any other pattern is translated into the standard library's ``re``
  syntax (``translate``) and compiled once: each Unicode class becomes an
  explicit set of code-point ranges read from the class table the native
  scanner reads (``unicode_classes_v1.npy``, made with ``regex``: 1 = \\s,
  2 = \\p{L}, 4 = \\p{M}, 8 = \\p{N}). It translates ``\\p{L}``,
  ``\\p{N}``, ``\\p{M}`` (also ``\\p{Letter}``, ``\\p{Number}``,
  ``\\p{Mark}``, ``\\pL``, ``\\pN``, ``\\pM``) and their ``\\P``
  complements, ``\\s``, ``\\S``, ``\\w`` and ``\\W`` (``is_word``),
  outside a set and inside one, negated or not, and ``\\b`` and
  ``\\B`` as lookarounds over ``\\w``. In an ignore-case scope ``re``
  folds I, i, U+0130 and U+0131 onto each other where ``regex`` does not: a
  literal one becomes the set ``regex`` folds it onto, case-sensitively;
- the named pre-tokenizers whose JAX patterns use other Unicode classes
  (``Punctuation``, ``BertPreTokenizer``: ``\\p{P}``) are hand-written
  scanners over that table and ``unicodedata``'s categories.

It refuses (``unsupported_syntax`` says why) what no table or test holds
equal to ``regex``: ``\\d`` and the other properties (``\\p{Lu}``,
``\\p{P}``, ...), grapheme clusters (``\\X``), any other escape or group
that ``re`` reads another way, possessive quantifiers, atomic groups, POSIX
classes, set operations and nested sets, version and ``regex``-only flags,
fuzzy quantifiers, a translated class inside an ignore-case scope or under
the verbose or ASCII flag, a set that holds one of the four folded letters
in an ignore-case scope, and a set range that ends at a class. A refused
pattern raises ``NotImplementedError`` where it is first used, naming the
pattern and ROADMAP A.16, so that a tokenizer holding one still loads,
converts and transfers.
"""

from __future__ import annotations

import functools
import re
import unicodedata
from typing import List, Optional, Tuple, Union

import numpy as np

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


def is_punctuation(c: str) -> bool:
    """``\\p{P}`` (``unicodedata``'s Unicode version)."""
    return unicodedata.category(c).startswith("P")


# Other_Alphabetic symbols: circled and squared Latin letters
_ALPHABETIC_SYMBOLS = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
                       (0x1F170, 0x1F189))


def is_word(c: str) -> bool:
    """``regex``'s Unicode ``\\w`` (``_word_mask``). (``re``'s ``\\w`` is
    ``str.isalnum`` or ``_``, which takes ² and leaves combining marks out.)"""
    return bool(_word_mask()[ord(c)])


@functools.lru_cache(maxsize=None)
def _word_mask() -> np.ndarray:
    """The (0x110000,) bool mask of ``regex``'s Unicode ``\\w``: letters,
    marks, decimal and letter numbers, connector punctuation, the joiners
    and the alphabetic symbols."""
    ctab = char_classes()
    word = (ctab & (LETTER | MARK)) != 0
    for cp in np.flatnonzero(ctab & NUMBER).tolist():
        word[cp] |= unicodedata.category(chr(cp)) != "No"
    for cp in range(0x110000):
        if unicodedata.category(chr(cp)) == "Pc":
            word[cp] = True
    word[[0x200C, 0x200D]] = True
    for lo, hi in _ALPHABETIC_SYMBOLS:
        word[lo:hi + 1] = True
    return word


def regex_escape(text: str) -> str:
    """``regex.escape(text)``: ``re.escape`` that also escapes whitespace
    (``str.isspace``)."""
    return "".join("\\" + c if c.isspace() and re.escape(c) == c else re.escape(c)
                   for c in text)


# escapes that mean the same in re and regex: digits (back references and
# octal) and these letters; a backslash before any other character quotes it
# in both
_SAME_ESCAPES = set("0123456789aftnrvxuUNAZ")
_RE_FLAGS = set("imsxau-")
_QUANTIFIER = re.compile(r"\{(\d*)(,\d*)?\}")
# one escape: a numeric or named character, else a backslash and one char
_ESCAPE = re.compile(r"\\(?:x[0-9a-fA-F]{2}|u[0-9a-fA-F]{4}|U[0-9a-fA-F]{8}|N\{[^}]*\}|.)",
                     re.DOTALL)
_PROPERTY = re.compile(r"\\[pP](?:\{([^}]*)\}|(.))", re.DOTALL)
_PROPERTIES = {"L": "L", "Letter": "L", "N": "N", "Number": "N", "M": "M", "Mark": "M"}
_TABLE_BITS = {"L": LETTER, "N": NUMBER, "M": MARK, "s": SPACE}
# regex's ignore-case matches of the letters re folds onto each other (re
# takes all four for each)
_FOLDS = {"I": "Iiı", "i": "Iiİ", "İ": "iİ", "ı": "Iı"}
# the groups that may open a pattern: comments and global flags
_LEADING_GROUP = re.compile(r"\(\?#[^)]*\)|\(\?([a-zA-Z]+)\)")
REFUSED_LABEL = "ROADMAP A.16"


def _mask(key: str) -> np.ndarray:
    """The (0x110000,) bool mask of a class: "L", "N", "M", "s" from the
    table, "w" as ``is_word``."""
    if key == "w":
        return _word_mask()
    return (char_classes() & _TABLE_BITS[key]) != 0


def _code(cp: int) -> str:
    if cp < 0x100:
        return f"\\x{cp:02x}"
    return f"\\u{cp:04x}" if cp < 0x10000 else f"\\U{cp:08x}"


_ASTRAL = "\\U00010000-\\U0010ffff"
_IS_ASTRAL = "(?![\\x00-\\uffff])"


@functools.lru_cache(maxsize=None)
def class_bodies(key: str, negated: bool) -> Tuple[str, str]:
    """The inside of a ``re`` set of the class's code points (of its
    complement when ``negated``) as escaped ranges: those below U+10000,
    and those above."""
    mask = _mask(key)
    if negated:
        mask = ~mask
    edges = np.diff(np.concatenate([[0], mask.astype(np.int8), [0]]))
    starts, ends = np.flatnonzero(edges == 1), np.flatnonzero(edges == -1) - 1
    bodies = ["", ""]
    for lo, hi in zip(starts.tolist(), ends.tolist()):
        for a, b, part in ((lo, min(hi, 0xFFFF), 0), (max(lo, 0x10000), hi, 1)):
            if a <= b:
                bodies[part] += _code(a) if a == b else f"{_code(a)}-{_code(b)}"
    return bodies[0], bodies[1]


def _set(literals: str, low: str, high: str, negated: bool) -> str:
    """A set of ``literals`` (its text between the brackets) and classes
    (``low``, ``high``: their ranges below and above U+10000). ``re`` tests
    a character against a set's ranges above U+FFFF one by one, after the
    bitmap of those below: the high ranges go in an alternative that only
    a character above U+FFFF reaches."""
    if not high:
        return f"[{'^' if negated else ''}{literals}{low}]"
    if negated:
        return f"(?:[^{literals}{low}{_ASTRAL}]|{_IS_ASTRAL}[^{literals}{high}])"
    return f"(?:[{literals}{low}]|{_IS_ASTRAL}[{literals}{high}])"


def _boundary(negated: bool) -> str:
    w = _set("", *class_bodies("w", False), False)
    if negated:  # \B: both sides word characters or neither
        return f"(?:(?<={w})(?={w})|(?<!{w})(?!{w}))"
    return f"(?:(?<={w})(?!{w})|(?<!{w})(?={w}))"


def _folded(token: str) -> Optional[str]:
    """Which of I, i, U+0130, U+0131 the literal ``token`` denotes, if any."""
    if len(token) == 1:
        return token if token in _FOLDS else None
    rx = re.compile(token)
    return next((c for c in _FOLDS if rx.fullmatch(c)), None)


def translate(pattern: str) -> Tuple[Optional[str], Optional[str]]:
    """(the ``re`` pattern that matches as ``regex`` matches ``pattern``,
    None), or (None, why the pattern is refused)."""
    out: List[str] = []
    i, n = 0, len(pattern)
    flags_seen = set()  # re takes global flags before anything but comments
    lead = _LEADING_GROUP.match(pattern)
    while lead:
        flags_seen |= set(lead.group(1) or "")
        lead = _LEADING_GROUP.match(pattern, lead.end())
    ignore_case = ["i" in flags_seen]  # each open group's ignore-case state
    in_class = False
    class_start = set_out = 0
    set_low: List[str] = []  # the classes of the open set, below U+10000
    set_high: List[str] = []  # and above
    dash_pending = after_class = False
    prev_quantifier = translated = False
    while i < n:
        c = pattern[i]
        quantifier = False
        if c == "\\":
            if i + 1 >= n:
                return None, "a trailing backslash"
            e = pattern[i + 1]
            key = negated = None
            if e in "pP":
                m = _PROPERTY.match(pattern, i)
                name = m and (m.group(1) if m.group(1) is not None else m.group(2))
                if name not in _PROPERTIES:
                    return None, f"the Unicode property {pattern[i:m.end() if m else i + 2]}"
                key, negated, end = _PROPERTIES[name], e == "P", m.end()
            elif e in "sSwW":
                key, negated, end = e.lower(), e.isupper(), i + 2
            if key is not None:
                if ignore_case[-1]:
                    return None, f"a Unicode class ({pattern[i:end]}) inside an ignore-case scope"
                translated = True
                if in_class:
                    if dash_pending or (pattern.startswith("-", end)
                                        and not pattern.startswith("-]", end)):
                        return None, f"a set range that ends at a class ({pattern[i:end]})"
                    low, high = class_bodies(key, negated)
                    set_low.append(low)
                    set_high.append(high)
                    after_class = True
                else:
                    out.append(_set("", *class_bodies(key, False), negated))
                i = end
                prev_quantifier = dash_pending = False
                continue
            if e in "bB" and not in_class:
                translated = True
                out.append(_boundary(e == "B"))
                i += 2
                prev_quantifier = False
                continue
            if e.isalnum() and e not in _SAME_ESCAPES and not (e == "b" and in_class):
                return None, f"the escape \\{e}"
            m = _ESCAPE.match(pattern, i)
            token = m.group()
            if ignore_case[-1] and not in_class:
                if e.isdigit():
                    return None, "a back reference or octal escape inside an ignore-case scope"
                fold = _folded(token) if e.isalpha() and e != "b" else None
                if fold is not None:
                    token = f"(?-i:[{_FOLDS[fold]}])"
                    translated = True
            out.append(token)
            i = m.end()
            prev_quantifier = dash_pending = after_class = False
            continue
        if in_class:
            if c == "]" and i > class_start:
                in_class = False
                literals = "".join(out[set_out:])
                if ignore_case[-1] and literals and any(
                        re.fullmatch(f"[{literals}]", f) for f in _FOLDS):
                    return None, ("a set that holds I, i, U+0130 or U+0131 inside an "
                                  "ignore-case scope")
                if set_low or set_high:
                    if literals.endswith("-") and not literals.endswith("\\-"):
                        literals = literals[:-1] + "\\-"  # not a range into the classes
                    negated = out[set_out - 1] == "^"
                    del out[set_out - 1 - negated:]
                    out.append(_set(literals, "".join(set_low), "".join(set_high), negated))
                    i += 1
                    continue
            elif c == "[":
                return None, ("a POSIX class" if pattern.startswith("[:", i)
                              else "a nested set")
            elif pattern.startswith(("&&", "||", "--", "~~"), i):
                return None, f"the set operation {pattern[i:i + 2]}"
            elif c == "-" and i > class_start and not pattern.startswith("-]", i):
                if after_class:
                    return None, "a set range that starts at a class"
                dash_pending = True
                out.append(c)
                i += 1
                continue
            out.append(c)
            i += 1
            dash_pending = after_class = False
            continue
        if c == "[":
            in_class = True
            out.append(c)
            i += 1
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            class_start = i  # a "]" here is a literal
            set_out = len(out)
            set_low, set_high = [], []
            prev_quantifier = dash_pending = after_class = False
            continue
        if c == "(" and pattern.startswith("(?", i):
            rest = pattern[i + 2:]
            if rest.startswith(">"):
                return None, "an atomic group"
            if rest.startswith("#"):
                close = pattern.find(")", i)
                if close < 0:
                    return None, "an unterminated comment"
                out.append(pattern[i:close + 1])
                i = close + 1
                continue
            state = ignore_case[-1]
            if rest.startswith(("P=", "P<")) or (rest.startswith("(") and rest[1:2].isalnum()):
                # a named back reference (a whole atom), a named group, a
                # condition: copied up to its name's end
                close = pattern.find(")" if rest[0] != "P" or rest[1] == "=" else ">", i)
                if close < 0:
                    return None, f"the group (?{rest[:2]}"
                if rest.startswith("P=") and state:
                    return None, "a back reference inside an ignore-case scope"
                opener = pattern[i:close + 1]
                if rest.startswith("P="):
                    out.append(opener)
                    i = close + 1
                    prev_quantifier = False
                    continue
            elif rest.startswith((":", "=", "!")):
                opener = pattern[i:i + 3]
            elif rest.startswith(("<=", "<!")):
                opener = pattern[i:i + 4]
            else:
                flags = re.match(r"[A-Za-z\-]*", rest).group()
                closed = rest[len(flags):][:1] in (")", ":")
                if not flags or not set(flags) <= _RE_FLAGS or not closed:
                    return None, f"the group or flags (?{rest[:max(len(flags), 1)]}"
                on, _, off = flags.partition("-")
                flags_seen |= set(on)
                opener = pattern[i:i + 3 + len(flags)]
                if opener.endswith(")"):  # global flags: re takes them at the start only
                    out.append(opener)
                    i += len(opener)
                    continue
                state = ("i" in on or state) and "i" not in off
            ignore_case.append(state)
            out.append(opener)
            i += len(opener)
            prev_quantifier = False
            continue
        elif c == "(":
            ignore_case.append(ignore_case[-1])
        elif c == ")" and len(ignore_case) > 1:
            ignore_case.pop()
        elif c in "*+?":
            if prev_quantifier and c == "+":
                return None, "a possessive quantifier"
            quantifier = c != "?" or not prev_quantifier  # lazy "?" ends it
        elif c == "{":
            m = _QUANTIFIER.match(pattern, i)
            if m is None or m.group() == "{}" or m.group() == "{,}":
                return None, "a brace that is not a counted quantifier (a fuzzy match in regex)"
            out.append(m.group())
            i = m.end()
            prev_quantifier = True
            continue
        elif ignore_case[-1] and c in _FOLDS:
            out.append(f"(?-i:[{_FOLDS[c]}])")
            translated = True
            i += 1
            prev_quantifier = False
            continue
        out.append(c)
        prev_quantifier = quantifier
        i += 1
    if in_class:
        return None, "an unterminated set"
    if translated and flags_seen & set("xa"):
        return None, "a translated class under the verbose or ASCII flag"
    return "".join(out), None


def unsupported_syntax(pattern: str) -> Optional[str]:
    """Why ``pattern`` is refused (see ``translate``), or None when the
    port matches it as ``regex`` does."""
    return translate(pattern)[1]


def refusal(what: str, pattern: str, reason: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} with the Regex pattern {pattern!r}: {reason} matches differently under the "
        "standard library's re than under the regex module, which the port does not use "
        f"({REFUSED_LABEL}: the regex syntax the port's matcher refuses)")


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


@functools.lru_cache(maxsize=None)
def _compiled(pattern: str) -> Union["re.Pattern[str]", str]:
    """The compiled translation of ``pattern``, or why it is refused."""
    translated, reason = translate(pattern)
    if reason is not None:
        return reason
    try:
        return re.compile(translated)
    except re.error as exc:
        return f"a pattern re cannot compile ({exc})"


def compile_pattern(pattern: str, what: str) -> Matcher:
    """The matcher of a tokenizer.json ``Regex`` pattern (see the module
    docstring); a refused one raises when it is used."""
    if pattern in (SPLIT_REGEX, SPLIT_REGEX_NO_MARKS):
        return Gpt2Split(use_marks=pattern == SPLIT_REGEX)
    compiled = _compiled(pattern)
    if isinstance(compiled, str):
        return Refused(refusal(what, pattern, compiled))
    return StdlibRegex(compiled)
