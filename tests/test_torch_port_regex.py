"""The port's matcher for tokenizer.json ``Regex`` patterns
(zett_tpu_torch/tokenization/patterns.py ``translate``) held against the
``regex`` module and the JAX package's ``Split``.

- Every class it translates (``\\p{L}``, ``\\p{N}``, ``\\p{M}`` and their
  long and one-letter names, their ``\\P`` complements, ``\\s``, ``\\S``,
  ``\\w``, ``\\W``), outside a set, inside a set and inside a negated set,
  matches exactly the code points that ``regex`` matches, over U+0000 to
  U+10FFFF with the surrogates left out; so do ``\\b`` and ``\\B`` between
  them.
- In an ignore-case scope, each ASCII letter and digit, the four letters
  ``re`` folds where ``regex`` does not (I, i, U+0130, U+0131) and a few
  sets match what ``regex`` matches over every code point, and each of
  Llama-3's contractions with each of its letters replaced by every
  character that folds onto it.
- The split patterns of Llama-3 (Meta-Llama-3-8B's tokenizer.json) and
  Qwen2 (Qwen2-7B's tokenizer.json), typed in, give ``regex.finditer``'s
  spans and the JAX package's ``Split`` pieces on CORPUS and on seeded texts
  that hold the traps: U+017F, U+212A, U+0130/U+0131, CRLF runs, U+0085,
  U+2028, NBSP, U+001C-U+001F, combining marks, digit runs longer than 3,
  letters and digits above U+FFFF, and the end of a text after spaces.
- What is still refused raises ``NotImplementedError`` where it is first
  used, naming the pattern and ROADMAP A.16.
"""

import re

import numpy as np
import pytest
import regex

from fixtures import CORPUS
from zett_tpu.tokenization.pretokenizers import Split as JaxSplit
from zett_tpu_torch.tokenization import patterns
from zett_tpu_torch.tokenization.pretokenizers import Split

# Meta-Llama-3-8B's tokenizer.json, pre_tokenizer.pretokenizers[0].pattern.Regex
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
# Qwen2-7B's tokenizer.json, the same place: single digits
QWEN2_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
               r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

CODE_POINTS = np.array([cp for cp in range(0x110000) if not 0xD800 <= cp <= 0xDFFF])
ALL = "".join(map(chr, CODE_POINTS.tolist()))

# each class's spellings, then its complement's
SPELLINGS = {"L": ([r"\p{L}", r"\p{Letter}", r"\pL"], [r"\P{L}", r"\P{Letter}", r"\PL"]),
             "N": ([r"\p{N}", r"\p{Number}", r"\pN"], [r"\P{N}", r"\P{Number}", r"\PN"]),
             "M": ([r"\p{M}", r"\p{Mark}", r"\pM"], [r"\P{M}", r"\P{Mark}", r"\PM"]),
             "s": ([r"\s"], [r"\S"]),
             "w": ([r"\w"], [r"\W"])}


def _compiled(pattern):
    translated, why = patterns.translate(pattern)
    assert why is None, why
    return re.compile(translated)


def _matched(rx):
    """The code points a one-character pattern matches: those its ``sub``
    removes from the string of every code point (each appears once)."""
    left = np.frombuffer(rx.sub("", ALL).encode("utf-32-le"), dtype=np.uint32)
    return np.setdiff1d(CODE_POINTS, left)


def _matched_sparse(rx):
    """``_matched`` for a pattern that matches a few code points."""
    return CODE_POINTS[[m.start() for m in rx.finditer(ALL)]]


def _marked(rx, text):
    """``text`` with NUL inserted at every match of a zero-width pattern
    (``text`` holds no NUL, so the result gives the positions)."""
    return rx.sub("\x00", text)


def _forms(spellings, complements):
    """Each spelling outside a set, in a set and in a negated set, and each
    complement's spelling in a set and a negated set."""
    forms = [(s, f"[{s}]", f"[^{s}]") for s in spellings]
    forms += [(f"[{s}]", f"[^{s}]") for s in complements]
    forms += [(s,) for s in complements]
    return [f for group in forms for f in group]


@pytest.mark.parametrize("key", sorted(SPELLINGS))
def test_classes_match_regex_on_every_code_point(key):
    """Every spelling of the class and of its complement, outside a set,
    alone in a set and in a negated set: the code points matched equal
    regex's. Forms that translate to the same re text share one re pass;
    regex runs on each."""
    spellings, complements = SPELLINGS[key]
    forms = _forms(spellings, complements)
    if key == "L":  # Llama-3's sets, literals beside the classes
        forms += [r"[^\r\n\p{L}\p{N}]", r"[^\s\p{L}\p{N}]", r"[\r\nx\p{L}-]"]
    matched = {}
    for form in forms:
        translated = patterns.translate(form)[0]
        if translated not in matched:
            matched[translated] = _matched(_compiled(form))
        got, want = matched[translated], _matched(regex.compile(form))
        assert np.array_equal(got, want), (form, len(got), len(want),
                                           [hex(c) for c in np.setxor1d(got, want)[:10]])
    assert len(matched) >= 4


@pytest.mark.parametrize("pattern", [r"\b", r"\B", r"\w\b", r"\B\W"])
def test_word_boundaries_match_regex(pattern):
    """``\\b`` and ``\\B`` over the string of every code point but NUL
    (each position sits between two neighbours of its own; ``\\b`` also
    over its reverse), with a class beside them over every fifth code
    point, and at the ends of short texts."""
    rx, ref = _compiled(pattern), regex.compile(pattern)
    texts = {r"\b": (ALL[1:], ALL[:0:-1]), r"\B": (ALL[1:],)}.get(pattern, (ALL[1::5],))
    for text in texts:
        assert _marked(rx, text) == _marked(ref, text)
    for text in ("", "a", " ", "ab c", "é̂", "_x_", "x\u200d"):
        assert [m.span() for m in rx.finditer(text)] == [m.span() for m in ref.finditer(text)]


FOLD_LITERALS = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789'") + \
    ["\u0130", "\u0131", "\u017f", "\u212a", r"\x49", r"\u0130"]
# the literals also held after a flag or comment group that opens the pattern
LEADING_FOLDS = ["I", "i", "\u0130", "\u0131", r"\x49"]
FOLD_SETS = ["[a-h]", "[^a-h]", "[j-z0-9]", "[^j-zA-H]", "[sk]", "[^SK']"]


@pytest.mark.parametrize("what", ["literals", "sets"])
def test_ignore_case_matches_regex_on_every_code_point(what):
    """Under ``(?i:...)`` (and a global ``(?i)``, also after another
    leading flag or comment group), every code point each literal or set
    matches equals regex's; re alone folds I, i, U+0130 and U+0131 onto all
    four."""
    items = FOLD_LITERALS if what == "literals" else FOLD_SETS
    for item in items:
        forms = [f"(?i:{item})", f"(?i){item}"]
        if item in LEADING_FOLDS:
            forms += [f"(?s)(?i){item}", f"(?#c)(?i){item}", f"(?i)(?#c){item}"]
        for pattern in forms:
            match = _matched if what == "sets" else _matched_sparse
            got, want = match(_compiled(pattern)), match(regex.compile(pattern))
            assert np.array_equal(got, want), (pattern, [hex(c) for c in got],
                                               [hex(c) for c in want])
    if what == "literals":
        assert len(_matched_sparse(re.compile("(?i:i)"))) == 4  # the fault the translation avoids


def test_contractions_fold_as_in_regex():
    """Each of Llama-3's contractions with each letter replaced by every
    character that either engine folds onto it, inside a text: Llama-3's
    split gives regex's spans."""
    rx, ref = _compiled(LLAMA3_SPLIT), regex.compile(LLAMA3_SPLIT)
    contractions = ["'s", "'t", "'re", "'ve", "'m", "'ll", "'d"]
    n = 0
    for word in contractions:
        for pos in range(1, len(word)):
            folds = set(_matched_sparse(re.compile(f"(?i:{word[pos]})")).tolist()) | \
                set(_matched_sparse(regex.compile(f"(?i:{word[pos]})")).tolist())
            for cp in sorted(folds):
                variant = word[:pos] + chr(cp) + word[pos + 1:]
                for text in (variant, f"it{variant} x", f"I{variant.upper()}"):
                    assert [m.span() for m in rx.finditer(text)] == \
                        [m.span() for m in ref.finditer(text)], text
                    n += 1
    assert n >= 3 * 10 * 2


TRAPS = ["\u017f", "\u212a", "\u0130", "\u0131", "\r\n", "\r\n\r\n", "\r", "\n", "\u0085",
         "\u2028", "\u2029", "\xa0", "\x1c", "\x1d", "\x1e", "\x1f", "\u0301", "\u0308",
         "e\u0301", "1234567", "12", "\u0663\u0664\u0665\u0666", "\U0001d7d9\U0001d7da",
         "\U0001d518", "'s", "'S", "'\u017f", "'RE", "'ll", " ", "  ", "\t", "x", "Hello",
         "don't", "\u65e5\u672c", "\U0001f916", "\u00b2", "_", "-", "!?", "\u3000", "\ufeff"]


def _trap_texts(n=300, seed=0):
    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(n):
        k = int(rng.integers(1, 24))
        text = "".join(TRAPS[i] for i in rng.integers(0, len(TRAPS), size=k))
        texts.append(text + ("   " if rng.random() < 0.2 else ""))
    return texts


@pytest.mark.parametrize("name,pattern", [("llama3", LLAMA3_SPLIT), ("qwen2", QWEN2_SPLIT)])
def test_split_patterns_match_regex_and_jax(name, pattern):
    """Spans equal to regex.finditer's, and the port's Split (Isolated, as
    both tokenizers use it) equal to the JAX package's, on CORPUS and on
    seeded trap texts."""
    rx, ref = _compiled(pattern), regex.compile(pattern)
    port, jax_split = Split(pattern, "Isolated", False), JaxSplit(pattern, "Isolated", False)
    for text in CORPUS + _trap_texts(seed=len(name)):
        assert [m.span() for m in rx.finditer(text)] == [m.span() for m in ref.finditer(text)], \
            repr(text)
        assert port.pre_tokenize_str(text) == jax_split.pre_tokenize_str(text), repr(text)
    assert rx.findall("x  \n") == ref.findall("x  \n") == ["x", "  \n"]
    assert rx.findall("x  ") == ["x", "  "]  # \s+(?!\S) at the end of a text


REFUSED = {
    r"\d+": r"\\d",
    r"\p{Lu}": "Unicode property",
    r"\p{P}+": "Unicode property",
    r"\p{^L}": "Unicode property",
    r"(?i:\p{L}+)": "ignore-case",
    r"(?#x)(?i)\p{L}": "ignore-case",
    r"(?s)(?i)\s+": "ignore-case",
    r"(?i)[a-z]+": "I, i, U\\+0130",
    r"[+-\p{L}]": "range",
    r"[\p{L}-z]": "range",
    r"(?x)\p{L} +": "verbose",
    r"(?a)\w+": "ASCII",
    r"(?i)(a)\1": "back reference",
}


@pytest.mark.parametrize("pattern", sorted(REFUSED))
def test_still_refused_patterns_raise_naming_the_label(pattern):
    """Syntax the matcher does not translate raises NotImplementedError
    naming the pattern and ROADMAP A.16 when it is used, not when it loads."""
    assert regex.search(REFUSED[pattern], patterns.unsupported_syntax(pattern))
    split = Split(pattern, "Isolated", False)
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.16") as e:
        split.pre_tokenize_str("some text")
    assert repr(pattern) in str(e.value)


def test_translation_is_compiled_once():
    """A pattern compiles once per process, whoever asks for it."""
    a = patterns.compile_pattern(LLAMA3_SPLIT, "Split pre-tokenizer")
    b = patterns.compile_pattern(LLAMA3_SPLIT, "Replace normalizer")
    assert a.rx is b.rx
