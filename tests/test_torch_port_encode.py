"""The port's general encode pipeline (zett_tpu_torch/tokenization: core,
normalizers, pretokenizers, models, postprocessors, decoders, patterns)
held against the JAX package field for field: ids, tokens, offsets,
type_ids, attention_mask and special_tokens_mask, with and without special
tokens, for pairs, under truncation and padding, and decode, on every
tokenizer fixture and the repo's ten artifact tokenizers, on CORPUS. Also
the Regex rule (the native GPT-2 split; the stdlib ``re`` on the pattern
as ``patterns.translate`` rewrites it, Unicode classes as code-point
ranges; else NotImplementedError naming ROADMAP A.16) and an encode with
``regex``, ``tokenizers`` and ``jax`` unimportable."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import regex

import fixtures
from fixtures import CORPUS
from zett_tpu.tokenization import Tokenizer as JaxTokenizer
from zett_tpu_torch.tokenization import Tokenizer
from zett_tpu_torch.tokenization import patterns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = sorted(os.listdir(os.path.join(REPO, "artifacts", "tokenizers")))
SMALL = ("gpt2_like", "xlmr_like", "llama_like", "bert_like")
FULL = ("bpe_bytelevel_50k", "unigram_50k", "bpe_metaspace_50k")
NAMES = SMALL + FULL + tuple(ARTIFACTS)
FIELDS = ("ids", "tokens", "offsets", "type_ids", "attention_mask", "special_tokens_mask")

# Llama-3's pre-tokenizer split (its tokenizer.json's Split pattern)
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def _fixture_json(name):
    """A fixture's tokenizer.json; waits for another test process that is
    still writing the shared cache file."""
    build = getattr(fixtures, f"_build_{name}")
    for _ in range(60):
        try:
            return fixtures._cached(name, build)
        except json.JSONDecodeError:
            time.sleep(5)
    return build()


def _json_text(name):
    if name in ARTIFACTS:
        with open(os.path.join(REPO, "artifacts", "tokenizers", name, "tokenizer.json")) as f:
            return f.read()
    return json.dumps(_fixture_json(name))


_PAIRS = {}


def _pair(name):
    if name not in _PAIRS:
        text = _json_text(name)
        _PAIRS[name] = (JaxTokenizer.from_str(text), Tokenizer.from_str(text))
    return _PAIRS[name]


def _assert_same(a, b, what):
    for f in FIELDS:
        got, want = getattr(b, f), getattr(a, f)
        assert [tuple(x) if isinstance(x, (list, tuple)) else x for x in got] == \
            [tuple(x) if isinstance(x, (list, tuple)) else x for x in want], (what, f)


@pytest.mark.parametrize("name", NAMES)
def test_encode_and_decode_match_jax(name):
    """Every CORPUS text, with and without special tokens; decode with and
    without them; the tokenizer.json the port writes."""
    jtok, tok = _pair(name)
    assert tok.to_str() == jtok.to_str()
    for text in CORPUS:
        for special in (True, False):
            a = jtok.encode(text, add_special_tokens=special)
            b = tok.encode(text, add_special_tokens=special)
            _assert_same(a, b, (text, special))
        for skip in (True, False):
            assert tok.decode(b.ids, skip_special_tokens=skip) == \
                jtok.decode(a.ids, skip_special_tokens=skip)
    ids = [jtok.encode(t).ids for t in CORPUS[:16]]
    assert tok.decode_batch(ids) == jtok.decode_batch(ids)


@pytest.mark.parametrize("name", NAMES)
def test_pairs_truncation_and_padding_match_jax(name):
    """Pairs through the post-processor, truncation before it (room left for
    the specials), padding to a length and to the longest, encode_batch."""
    jtok, tok = _pair(name)
    texts = [t for t in CORPUS if t.strip()][:40]
    pairs = list(zip(texts[::2], texts[1::2]))
    for t in (jtok, tok):
        t.enable_truncation(12)
        t.enable_padding(length=16, pad_id=0, pad_token="<pad>")
    try:
        assert tok.num_special_tokens_to_add(True) == jtok.num_special_tokens_to_add(True)
        for p in pairs:
            _assert_same(jtok.encode(*p), tok.encode(*p), p)
        for batch in (pairs, texts):
            for a, b in zip(jtok.encode_batch(batch), tok.encode_batch(batch)):
                _assert_same(a, b, batch)
        for t in (jtok, tok):
            t.no_truncation()
            t.enable_padding(pad_id=1, pad_token="<pad>", pad_type_id=1)
        for a, b in zip(jtok.encode_batch(pairs, add_special_tokens=False),
                        tok.encode_batch(pairs, add_special_tokens=False)):
            _assert_same(a, b, "longest")
    finally:
        for t in (jtok, tok):
            t.no_truncation()
            t.no_padding()


ADDED = [
    {"content": "<mask>", "special": True},
    {"content": "the", "single_word": True},
    {"content": "fox", "lstrip": True, "rstrip": True},
    {"content": "don't"},
]


@pytest.mark.parametrize("name", ["gpt2_like", "llama_like", "bert_like"])
@pytest.mark.parametrize("added", ADDED, ids=lambda a: "-".join(k for k in a if k != "content")
                         or "plain")
def test_added_tokens_match_jax(name, added):
    """add_tokens / add_special_tokens and the added-token split (single_word,
    lstrip, rstrip) against JAX."""
    text = _json_text(name)
    jtok, tok = JaxTokenizer.from_str(text), Tokenizer.from_str(text)
    counts = []
    for t in (jtok, tok):
        add = t.add_special_tokens if added.get("special") else t.add_tokens
        counts.append(add([dict(added)]))
    assert counts[1] == counts[0]
    assert tok.get_vocab() == jtok.get_vocab()
    assert tok.all_special_ids == jtok.all_special_ids
    for text_ in CORPUS[:40] + ["the fox <mask> don't  fox  thee the", "xthe the, fox\n<mask>"]:
        _assert_same(jtok.encode(text_), tok.encode(text_), text_)
        assert tok.decode(tok.encode(text_).ids, False) == \
            jtok.decode(jtok.encode(text_).ids, False)


# ---------------------------------------------------------------- the Regex rule

STDLIB_PATTERNS = [" {2,}", r"\.\.\.", r"[0-9]+", "[a-z]+|[^a-z ]+", "(?:ab|cd)+", r"x(?=y)",
                   "(?i)the", r"[\]\-]", "é|ü+", LLAMA3_SPLIT, r"\w+", r"\s+", r"\bthe"]
REFUSED = {
    r"\p{Zs}+": "Unicode property",
    r"(?i)\s+": "ignore-case",
    r"(?i:[h-j]+)": "ignore-case",
    r"[\w-z]": "range",
    r"\d": r"\\d",
    "a++": "possessive",
    "(?>ab)": "atomic",
    "[[:alpha:]]+": "POSIX",
    "[a-z--aeiou]": "set operation",
    "(?V1)ab": "flags",
    "(?:the){e<=1}": "brace",
    r"\X": r"\\X",
}


@pytest.mark.parametrize("pattern", STDLIB_PATTERNS)
def test_stdlib_patterns_split_as_regex_does(pattern):
    """A pattern the matcher takes (none of the syntax where re and regex
    differ, or Unicode classes and word boundaries that it translates) runs
    on re and splits CORPUS exactly as the JAX package's regex does."""
    from zett_tpu.tokenization.pretokenizers import Split as JaxSplit
    from zett_tpu_torch.tokenization.pretokenizers import Split

    assert patterns.unsupported_syntax(pattern) is None
    for behavior, invert in (("Removed", True), ("Isolated", False), ("Removed", False),
                             ("Merged_with_previous", False)):
        j, p = JaxSplit(pattern, behavior, invert), Split(pattern, behavior, invert)
        for text in CORPUS:
            assert p.pre_tokenize_str(text) == j.pre_tokenize_str(text), (text, behavior)


@pytest.mark.parametrize("pattern", sorted(REFUSED))
def test_refused_patterns_raise_when_used(pattern):
    """A pattern with syntax that reads differently under re and that the
    matcher does not translate raises NotImplementedError naming it and
    ROADMAP A.16 when it is used, not when the tokenizer loads."""
    from zett_tpu_torch.tokenization.normalizers import Replace
    from zett_tpu_torch.tokenization.pretokenizers import Split

    assert regex.search(REFUSED[pattern], patterns.unsupported_syntax(pattern))
    split, replace = Split(pattern), Replace({"Regex": pattern}, " ")
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.16") as e:
        split.pre_tokenize_str("some text")
    assert repr(pattern) in str(e.value)
    with pytest.raises(NotImplementedError, match=r"Replace normalizer"):
        replace.normalize_str("some text")


def test_llama3_split_loads_and_raises_on_encode():
    """A tokenizer.json with Llama-3's Split pre-tokenizer loads and writes
    back the same text as JAX. It used to raise on encode; since the matcher
    translates its Unicode classes, it encodes CORPUS as JAX does, field
    for field, with and without special tokens."""
    data = json.loads(_json_text("gpt2_raw"))
    data["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated",
         "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
         "use_regex": False}]}
    tok, jtok = Tokenizer.from_json(data), JaxTokenizer.from_json(data)
    assert tok.to_str() == jtok.to_str()
    for text in CORPUS:
        for special in (True, False):
            _assert_same(jtok.encode(text, add_special_tokens=special),
                         tok.encode(text, add_special_tokens=special), text)


def test_xlmr_regex_normalizer_encodes():
    """XLM-R's Replace(" {2,}") normalizer runs on re: runs of spaces
    collapse as under regex."""
    _, tok = _pair("xlmr_like")
    assert tok.normalizer.normalize_str("a  b     c d") == "a b c d"


@pytest.mark.parametrize("what", ["word", "space", "number", "escape"])
def test_character_classes_match_regex(what):
    """The hand-written classes (and the matcher's translation of
    \\p{N}) equal regex's \\w, \\s, \\p{N} and regex.escape on every code
    point that Python's unicodedata assigns."""
    import re
    import unicodedata

    number = re.compile(patterns.translate(r"\p{N}")[0])
    test = {"word": (patterns.is_word, regex.compile(r"\w")),
            "space": (patterns.is_space, regex.compile(r"\s")),
            "number": (lambda c: bool(number.fullmatch(c)), regex.compile(r"\p{N}"))}
    chars = [chr(cp) for cp in range(0x110000)
             if not 0xD800 <= cp <= 0xDFFF and unicodedata.category(chr(cp)) != "Cn"]
    if what == "escape":
        assert [patterns.regex_escape(c) for c in chars] == [regex.escape(c) for c in chars]
        return
    pred, rx = test[what]
    bad = [c for c in chars if pred(c) != bool(rx.fullmatch(c))]
    assert not bad, [hex(ord(c)) for c in bad[:10]]


def test_encode_runs_without_regex_tokenizers_or_jax(tmp_path):
    """The port encodes every small fixture in a process where regex,
    tokenizers and jax cannot be imported, and gets JAX's ids."""
    texts = [t for t in CORPUS if t.strip()][:30]
    want = {}
    for name in SMALL:
        path = tmp_path / f"{name}.json"
        path.write_text(_json_text(name))
        want[name] = [JaxTokenizer.from_file(str(path)).encode(t).ids for t in texts]
    (tmp_path / "texts.json").write_text(json.dumps(texts))
    code = f"""
import importlib.abc, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("regex", "tokenizers", "jax", "jaxlib", "zett_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {REPO!r})
from zett_tpu_torch.tokenization import Tokenizer
texts = json.load(open({str(tmp_path / 'texts.json')!r}))
out = {{n: [Tokenizer.from_file({str(tmp_path)!r} + "/" + n + ".json").encode(t).ids
           for t in texts] for n in {list(SMALL)!r}}}
assert not [m for m in sys.modules if m.split(".")[0] in ("regex", "tokenizers", "jax")]
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == want


def test_unigram_byte_fallback_and_unk_match_jax():
    """Unigram's unknown characters: unk fused, and byte_fallback pieces
    where the vocab holds every byte of the character."""
    from zett_tpu.tokenization.models import Unigram as JaxUnigram
    from zett_tpu_torch.tokenization.models import Unigram

    rng = np.random.default_rng(0)
    pieces = ["<unk>", "a", "b", "ab", "abc", "c", "▁", "▁a"] + [f"<0x{b:02X}>" for b in
                                                                  range(0xC3, 0xC5)]
    vocab = [(p, float(-rng.random() * 5)) for p in pieces] + [("ba", -1.0), ("ba", -0.5)]
    for fallback in (False, True):
        j = JaxUnigram(vocab, unk_id=0, byte_fallback=fallback)
        p = Unigram(vocab, unk_id=0, byte_fallback=fallback)
        for text in ["abcab", "▁aäöxyz", "zzaz", "ääb", "ba", "", "🤖a"]:
            assert p.tokenize(text) == j.tokenize(text), (text, fallback)


@pytest.mark.parametrize("seed", range(4))
def test_bpe_heap_merges_match_jax(seed):
    """The port merges on a heap (``models._merge``), JAX in its quadratic
    loop: random words over a few letters and random merge lists
    (overlapping pairs, merges of merged symbols, ranks out of order) give
    the same tokens."""
    import random

    from zett_tpu.tokenization.models import BPE as JaxBPE
    from zett_tpu_torch.tokenization.models import BPE

    rng = random.Random(seed)
    for _ in range(200):
        alphabet = "abcde"[:rng.randint(2, 5)]
        symbols, merges = list(alphabet), []
        for _ in range(rng.randint(1, 30)):
            a, b = rng.choice(symbols), rng.choice(symbols)
            merges.append((a, b))
            symbols.append(a + b)
        if rng.random() < 0.5:
            rng.shuffle(merges)
        vocab = {s: i for i, s in enumerate(dict.fromkeys(symbols))}
        word = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 160)))
        assert BPE(vocab, merges).tokenize(word) == JaxBPE(vocab, merges).tokenize(word)


def test_tinyllama_metaspace_tokenizer_matches_jax():
    """The 32000-piece metaspace BPE of chip_smoke.py's TinyLlama (no
    pre-tokenizer: a text is one word) on the repo's Markdown paragraphs,
    cut to 600 characters (JAX's merge loop is quadratic in a word)."""
    import chip_smoke

    data = chip_smoke.metaspace_tokenizer_json()
    jtok, tok = JaxTokenizer.from_json(data), Tokenizer.from_json(data)
    with open(os.path.join(REPO, "README.md")) as f:
        paragraphs = [p.strip()[:600] for p in f.read().split("\n\n") if p.strip()][:30]
    for text in paragraphs:
        for special in (True, False):
            _assert_same(jtok.encode(text, add_special_tokens=special),
                         tok.encode(text, add_special_tokens=special), text[:40])
        assert tok.decode(tok.encode(text).ids) == jtok.decode(jtok.encode(text).ids)


PRETOKENIZERS = [
    {"type": "Whitespace"},
    {"type": "WhitespaceSplit"},
    {"type": "Punctuation", "behavior": "Isolated"},
    {"type": "Punctuation", "behavior": "Merged_with_previous"},
    {"type": "Digits", "individual_digits": False},
    {"type": "Digits", "individual_digits": True},
    {"type": "BertPreTokenizer"},
    {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "never", "split": True},
    {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": False},
    {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
    {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": False},
    {"type": "Split", "pattern": {"String": " "}, "behavior": "Isolated", "invert": False},
    {"type": "Sequence", "pretokenizers": [{"type": "WhitespaceSplit"},
                                           {"type": "Digits", "individual_digits": True}]},
]


@pytest.mark.parametrize("data", PRETOKENIZERS, ids=lambda d: json.dumps(d, sort_keys=True))
def test_pretokenizers_match_jax(data):
    """Every pre-tokenizer type (the hand-written scanners for regex's
    \\w, \\s, \\p{N} and \\p{P} among them) splits CORPUS as JAX's does, with
    the same offsets, and writes the same JSON."""
    from zett_tpu.tokenization.pretokenizers import PreTokenizer as JaxPreTokenizer
    from zett_tpu_torch.tokenization.pretokenizers import PreTokenizer

    j, p = JaxPreTokenizer.from_json(data), PreTokenizer.from_json(data)
    assert p.to_json() == j.to_json()
    for text in CORPUS + ["a²b ¹ Ⓐbc x́y e‍z _ ½", "x1٣४5y ‥ (a) [b]! ¿c?"]:
        assert p.pre_tokenize_str(text) == j.pre_tokenize_str(text), text


NORMALIZERS = [
    {"type": "NFC"}, {"type": "NFD"}, {"type": "NFKC"}, {"type": "NFKD"},
    {"type": "Lowercase"},
    {"type": "Strip", "strip_left": True, "strip_right": False},
    {"type": "BertNormalizer", "clean_text": True, "handle_chinese_chars": True,
     "strip_accents": None, "lowercase": False},
    {"type": "Sequence", "normalizers": [
        {"type": "Prepend", "prepend": "▁"},
        {"type": "Replace", "pattern": {"Regex": "[0-9]+"}, "content": "#"},
        {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
]


@pytest.mark.parametrize("data", NORMALIZERS, ids=lambda d: json.dumps(d, sort_keys=True))
def test_normalizers_match_jax(data):
    from zett_tpu.tokenization.normalizers import Normalizer as JaxNormalizer
    from zett_tpu_torch.tokenization.normalizers import Normalizer

    j, p = JaxNormalizer.from_json(data), Normalizer.from_json(data)
    assert p.to_json() == j.to_json()
    for text in CORPUS:
        assert p.normalize_str(text) == j.normalize_str(text), text


def test_roberta_sequence_post_processors_and_decoders_match_jax():
    """RobertaProcessing inside a Sequence with ByteLevel, and the BPEDecoder
    and CTC decoders, which no fixture carries."""
    data = json.loads(_json_text("gpt2_like"))
    eot = data["added_tokens"][0]
    data["post_processor"] = {"type": "Sequence", "processors": [
        {"type": "RobertaProcessing", "sep": [eot["content"], eot["id"]],
         "cls": [eot["content"], eot["id"]], "trim_offsets": True, "add_prefix_space": False},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
         "use_regex": True}]}
    texts = [t for t in CORPUS if t.strip()][:30]
    for decoder in ({"type": "BPEDecoder", "suffix": "t"}, {"type": "CTC"}):
        data["decoder"] = decoder
        jtok, tok = JaxTokenizer.from_json(data), Tokenizer.from_json(data)
        assert tok.to_str() == jtok.to_str()
        for a, b in zip(texts, texts[1:]):
            _assert_same(jtok.encode(a, b), tok.encode(a, b), a)
            ids = jtok.encode(a).ids
            assert tok.decode(ids, False) == jtok.decode(ids, False)
