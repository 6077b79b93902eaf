"""Byte-level tokenizer conversion.

Counterpart of ``zett_tpu/tokenization/convert.py``: rewrites a BPE,
Unigram or WordPiece tokenizer (byte-level, metaspace or byte-fallback, with
or without a continuing-subword prefix) into the canonical byte-level
tokenizer over the GPT-2 byte alphabet: the surface-form rewrite (the
metaspace character found by running " test" through the tokenizer's own
normalizer and pre-tokenizer, ``normalizers.py``/``pretokenizers.py``), the
byte-fallback collapse, whitespace canonicalization, special-token alignment
to a reference tokenizer with post-processor id fixup, the Unigram score
transplant and BPE merge re-derivation. A normalizer or pre-tokenizer with
a ``Regex`` pattern that the port's matcher refuses (``patterns.py``) in the
probe's way raises ``NotImplementedError``.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Set, Tuple

from ..constants import EXTRA_WHITESPACE_CHARS, NEGATIVE_INF_FILL_VALUE, SPLIT_REGEX
from .bytemaps import BYTES_TO_CHARS, CHARS_TO_BYTES
from .core import AddedToken, Tokenizer

# The canonical byte-level normalizer/pre-tokenizer installed on converted
# tokenizers.
BYTE_LEVEL_NORMALIZER = {"type": "Prepend", "prepend": " "}
BYTE_LEVEL_PRETOKENIZER = {
    "type": "Sequence",
    "pretokenizers": [
        {
            "type": "Split",
            "pattern": {"Regex": SPLIT_REGEX},
            "behavior": "Removed",
            "invert": True,
        },
        {
            "type": "ByteLevel",
            "add_prefix_space": False,
            "trim_offsets": True,
            "use_regex": False,
        },
    ],
}


def is_byte_level(tokenizer) -> bool:
    """Whether a tokenizer, or its JSON, pre-tokenizes byte-level. A
    ``Tokenizer`` is read through its pre-tokenizer's JSON alone: its whole
    JSON holds the vocab (250k pieces at XLM-R's)."""
    if isinstance(tokenizer, Tokenizer):
        pretok = tokenizer.pre_tokenizer
        tokenizer = {"pre_tokenizer": pretok.to_json() if pretok else None}
    pretok = tokenizer.get("pre_tokenizer") or {}
    if pretok.get("type") == "ByteLevel":
        return True
    return pretok.get("type") == "Sequence" and any(
        p["type"] == "ByteLevel" for p in pretok.get("pretokenizers", [])
    )


def _get_byte_fn(tok: Tokenizer, tokenizer_data: dict):
    """(token -> byte-char surface form, continuing_subword_prefix)
    (``convert.py:55-80``): the identity for byte-level tokenizers; else the
    metaspace character (found by normalizing and pre-tokenizing " test")
    becomes a space, a continuing-subword prefix is stripped (a token without
    it starts a word: a space is prepended), and the UTF-8 bytes map to the
    byte alphabet."""
    if is_byte_level(tokenizer_data):
        assert not (tokenizer_data["model"].get("continuing_subword_prefix") or "")
        return (lambda x: x), None

    probe = " test"
    if tok.normalizer is not None:
        probe = tok.normalizer.normalize_str(probe)
    if tok.pre_tokenizer is not None:
        pieces = tok.pre_tokenizer.pre_tokenize_str(probe)
        probe = pieces[0][0] if pieces else probe
    meta_char = probe[0] if probe and probe[0] != " " and probe != "test" else None

    continuing_subword_prefix = tokenizer_data["model"].get("continuing_subword_prefix")

    def to_byte_fn(token: str) -> str:
        if meta_char is not None:
            token = token.replace(meta_char, " ")
        if continuing_subword_prefix is not None:
            if token.startswith(continuing_subword_prefix):
                token = token[len(continuing_subword_prefix):]
            else:
                token = " " + token
        return "".join(BYTES_TO_CHARS[b] for b in token.encode("utf-8"))

    return to_byte_fn, continuing_subword_prefix


def _fix_postprocessor_data(data: dict, surface_forms: List[str]):
    """Remap special-token ids inside a post-processor to the new vocab."""
    if data["type"] == "TemplateProcessing":
        specials = data["special_tokens"]
        iterable = specials if isinstance(specials, list) else specials.values()
        for entry in iterable:
            entry["ids"] = [surface_forms.index(t) for t in entry["tokens"]]
    elif data["type"] in ("RobertaProcessing", "BertProcessing"):
        data["sep"][1] = surface_forms.index(data["sep"][0])
        data["cls"][1] = surface_forms.index(data["cls"][0])
    elif data["type"] == "Sequence":
        for p in data["processors"]:
            _fix_postprocessor_data(p, surface_forms)


def _rederive_bpe_merges(
    surface_forms: List[str],
    raw_merges: List,
    to_byte_fn,
    special_tokens: Set[str],
    byte_fallback_tokens: Set[str],
    already_byte_level: bool,
    original_length: int,
    make_whitespace_consistent: bool,
) -> Tuple[List[str], List[Tuple[str, str]]]:
    """Remap the merges through ``to_byte_fn``, then derive merges for the
    tokens whose BPE derivation chain the rewrite broke (every token of a
    rewritten tokenizer is checked; of a byte-level one, those the
    conversion appended)."""
    extra_ws = EXTRA_WHITESPACE_CHARS

    inv_merges: Dict[str, List[Tuple[str, str]]] = {}
    merges: List[Tuple[str, str]] = []
    for merge in raw_merges:
        x, y = merge.split(" ") if isinstance(merge, str) else (merge[0], merge[1])
        x, y = to_byte_fn(x), to_byte_fn(y)
        z = x + y
        if make_whitespace_consistent and sum(c in extra_ws for c in z) > 1:
            continue
        inv_merges.setdefault(z, []).append((x, y))
        merges.append((x, y))

    surface_forms_set = set(surface_forms)

    def decompose(token: str) -> Set[str]:
        # fully expand a token through the merge rules; any piece longer
        # than 1 char that survives has no derivation and is problematic
        decompositions = {token}
        done = False
        while not done:
            done = True
            for d in list(decompositions):
                rules = inv_merges.get(d)
                if rules is not None:
                    for x, y in rules:
                        decompositions.add(x)
                        decompositions.add(y)
                    decompositions.remove(d)
                    done = False
                    break
        return decompositions

    def derive_merges(token: str) -> Tuple[List[Tuple[str, str]], Set[str]]:
        # bottom-up: repeatedly merge adjacent equal pairs left-to-right,
        # recording each merge rule and any intermediate vocab entries needed
        new_merges: List[Tuple[str, str]] = []
        new_vocab: Set[str] = set()
        atoms = list(token)
        while len(atoms) > 1:
            frozen = list(atoms)
            for c1, c2 in zip(frozen, frozen[1:]):
                applied = False
                i = 0
                while i < len(atoms) - 1:
                    if atoms[i] == c1 and atoms[i + 1] == c2:
                        atoms[i] = c1 + c2
                        del atoms[i + 1]
                        applied = True
                    i += 1
                if applied:
                    new_merges.append((c1, c2))
                    if c1 + c2 not in surface_forms_set:
                        new_vocab.add(c1 + c2)
        return new_merges, new_vocab

    to_check = surface_forms[original_length:] if already_byte_level else surface_forms
    problematic: Set[str] = set()
    for token in to_check:
        if (
            token in special_tokens
            or token in byte_fallback_tokens
            or token.startswith("<unused_whitespace__")
        ):
            continue
        problematic.update(x for x in decompose(token) if len(x) > 1)

    seen: Set[Tuple[str, str]] = set()
    pre_merges: List[Tuple[str, str]] = []
    post_merges: List[Tuple[str, str]] = []
    extra_vocab: Set[str] = set()
    for token in problematic:
        token_merges, token_vocab = derive_merges(token)
        extra_vocab |= token_vocab
        for m in token_merges:
            if m in seen:
                continue
            seen.add(m)
            if make_whitespace_consistent and sum(c in extra_ws for c in token) > 1:
                post_merges.append(m)
            else:
                pre_merges.append(m)

    surface_forms = surface_forms + sorted(extra_vocab)
    merges = pre_merges + merges + post_merges
    return surface_forms, merges


def convert_to_byte_level(
    tok: Tokenizer,
    make_whitespace_consistent: bool = False,
    match_special_tokens_to: Optional[Tokenizer] = None,
) -> Tuple[Tokenizer, Optional[int]]:
    """Convert `tok` to the canonical byte-level tokenizer.

    Returns (converted_tokenizer, n_added_tokens) where n_added_tokens is the
    number of appended fill tokens, or None when original token indices were
    not preserved (special-token matching reorders the vocab).
    """
    tokenizer_data = tok.to_json()
    tokenizer_data.pop("added_tokens", None)
    # the model's vocab and merges as given: the conversion replaces those
    # lists and never edits them in place, so a shallow copy keeps them
    original_data = {"model": dict(tokenizer_data["model"])}
    preserved_indices = True
    original_length = len(tok)

    to_byte_fn, continuing_subword_prefix = _get_byte_fn(tok, tokenizer_data)
    already_byte_level = is_byte_level(tokenizer_data)
    if continuing_subword_prefix is not None:
        tokenizer_data["model"]["continuing_subword_prefix"] = ""

    all_specials = set(tok.all_special_tokens)
    raw_tokens = [tok.id_to_token(i) for i in range(original_length)]
    surface_forms = [
        t if (t is None or t in all_specials) else to_byte_fn(t) for t in raw_tokens
    ]
    # holes in the id space (can happen with sparse added ids) become unused markers
    surface_forms = [
        s if s is not None else f"<unused_hole__{i}>" for i, s in enumerate(surface_forms)
    ]

    # collapse <0xNN> byte-fallback tokens onto the byte chars they denote
    # when the byte char itself is not already a token
    if tokenizer_data["model"].get("byte_fallback"):
        fallback_to_byte = {f"<0x{i:02X}>": BYTES_TO_CHARS[i] for i in range(255)}
        surface_set = set(surface_forms)
        for i, s in enumerate(surface_forms):
            if s in fallback_to_byte and fallback_to_byte[s] not in surface_set:
                surface_forms[i] = fallback_to_byte[s]
        byte_fallback_tokens = set(fallback_to_byte.keys())
    else:
        byte_fallback_tokens = set()

    # complete the byte alphabet
    present = set(surface_forms)
    surface_forms += [c for c in CHARS_TO_BYTES.keys() if c not in present]

    if make_whitespace_consistent:
        extra_ws = EXTRA_WHITESPACE_CHARS
        allowed_ws: List[str] = []
        for c1 in extra_ws:
            for i in range(1, 16):
                for c2 in extra_ws:
                    allowed_ws.append(c2 + c1 * i)
        for i, s in enumerate(surface_forms):
            if s in allowed_ws:
                allowed_ws.remove(s)
            elif sum(c in extra_ws for c in s) > 1 or len(s.strip()) == 0:
                surface_forms[i] = f"<unused_whitespace__{i}>"
        surface_forms += allowed_ws

    if match_special_tokens_to is not None:
        target = match_special_tokens_to
        target_specials = set(target.all_special_tokens)
        surface_forms = [
            s for s in surface_forms if s not in all_specials and s not in target_specials
        ]
        pairs = sorted(zip(target.all_special_ids, target.all_special_tokens))
        for idx, token in pairs:
            surface_forms.insert(idx, token)
        special_tokens = list(target.all_special_tokens)
        # each special at its place in the vocab: the target's id, or the
        # end of the vocab where that id lies past it (XLM-R's <mask> is id
        # 250001); JAX registers the target's id there, which no table row
        # of the converted vocab holds (ROADMAP C.20)
        special_ids = {t: surface_forms.index(t) for t in special_tokens}
        preserved_indices = False
    else:
        special_tokens = list(tok.all_special_tokens)
        special_ids = {}

    tokenizer_data["normalizer"] = dict(BYTE_LEVEL_NORMALIZER)
    tokenizer_data["pre_tokenizer"] = copy.deepcopy(BYTE_LEVEL_PRETOKENIZER)

    model_type = tokenizer_data["model"]["type"]
    if model_type == "Unigram":
        score_dict = {to_byte_fn(p): s for p, s in original_data["model"]["vocab"]}
        for char in CHARS_TO_BYTES.keys():
            if char not in score_dict:
                score_dict[char] = NEGATIVE_INF_FILL_VALUE
        if make_whitespace_consistent:
            for key in list(score_dict.keys()):
                if sum(c in EXTRA_WHITESPACE_CHARS for c in key) > 1:
                    del score_dict[key]
        tokenizer_data["model"]["vocab"] = [
            [s, score_dict.get(s, 0.0)] for s in surface_forms
        ]
    elif model_type == "BPE":
        surface_forms, merges = _rederive_bpe_merges(
            surface_forms,
            original_data["model"]["merges"],
            to_byte_fn,
            set(special_tokens) | all_specials,
            byte_fallback_tokens,
            already_byte_level,
            original_length,
            make_whitespace_consistent,
        )
        tokenizer_data["model"]["vocab"] = {s: i for i, s in enumerate(surface_forms)}
        tokenizer_data["model"]["merges"] = [list(m) for m in merges]
        tokenizer_data["model"]["byte_fallback"] = False
        tokenizer_data["model"]["unk_token"] = None
        tokenizer_data["model"]["fuse_unk"] = False
    elif model_type == "WordPiece":
        tokenizer_data["model"]["vocab"] = {s: i for i, s in enumerate(surface_forms)}
    else:
        raise ValueError(f"Unknown model type: {model_type}")

    if match_special_tokens_to is not None:
        target_post = match_special_tokens_to.to_json().get("post_processor")
        if target_post is not None:
            _fix_postprocessor_data(target_post, surface_forms)
            tokenizer_data["post_processor"] = target_post

    tokenizer_data["decoder"] = {
        "type": "ByteLevel",
        "add_prefix_space": True,
        "trim_offsets": True,
        "use_regex": True,
    }

    converted = Tokenizer.from_json(tokenizer_data)
    # re-register special tokens at their (possibly re-matched) ids
    vocab = converted.get_vocab(with_added_tokens=False)
    for t in special_tokens:
        idx = special_ids.get(t, vocab.get(t))
        if idx is None:
            idx = surface_forms.index(t) if t in surface_forms else None
        if idx is not None:
            converted.register_added_token(
                AddedToken(t, normalized=False, special=True), idx
            )
    n_added = (len(converted) - original_length) if preserved_indices else None
    return converted, n_added
