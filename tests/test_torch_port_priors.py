"""The prior pipeline of the PyTorch port (zett_tpu_torch/tokenization/
priors.py, compute_prior.py, evaluation/perplexity.py chunked_tokenize) held
against the JAX package on the CPU: pretoken counts, the substring prior,
both token-prior modes, chunked tokenization and the CLI on the device path
(``--device cpu``) and the host path (``--host-encode``), on the repo's
byte-level Unigram tokenizers and a BPE one. All comparisons are exact."""

import os

import numpy as np
import pytest
import torch

from zett_tpu.evaluation.perplexity import chunked_tokenize as jax_chunked_tokenize
from zett_tpu.tokenization import Tokenizer as JaxTokenizer
from zett_tpu.tokenization import compute_prior as jax_cli
from zett_tpu.tokenization import priors as jax_priors
from zett_tpu.tokenization.bytemaps import CHARS_TO_BYTES
from zett_tpu_torch.evaluation.perplexity import chunked_tokenize
from zett_tpu_torch.tokenization import Tokenizer
from zett_tpu_torch.tokenization import compute_prior as cli
from zett_tpu_torch.tokenization import priors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK = os.path.join(REPO, "artifacts", "tokenizers", "{}", "tokenizer.json")
# beyond the corpus fixture: marks, non-Latin scripts, digits, emoji, runs of
# whitespace, a NUL, contractions
EXTRA = [
    "naïve café — Größe 東京タワー 🙂🙂 é ẍy",
    "tabs\tand   spaces  \n  trailing   ",
    "It's 2024: we've 3.14159 reasons, don't we? ---====---",
    "nul\x00byte and ÆØÅ æøå ß Ω ∑ √",
]


@pytest.fixture(scope="module")
def texts(corpus):
    return [t for t in corpus if t.strip()] + EXTRA


def _pair(name):
    return JaxTokenizer.from_file(TOK.format(name)), Tokenizer.from_file(TOK.format(name))


@pytest.mark.parametrize("name", ["en_raw", "gpt_neox0001", "gpt2_raw"])
def test_pretoken_counts_and_substring_prior_match_jax(name, texts):
    jtok, tok = _pair(name)
    want = jax_priors.get_pretoken_counts(jtok, texts)
    got = priors.get_pretoken_counts(tok, texts)
    assert got == {bytes(CHARS_TO_BYTES[c] for c in p): n for p, n in want.items()}
    jprior = jax_priors.compute_substring_prior(jtok, texts=texts)
    prior, counts = priors.compute_substring_prior(tok, texts=texts, return_pretoken_counts=True)
    assert counts == got
    np.testing.assert_array_equal(prior, jprior)
    np.testing.assert_array_equal(priors.compute_substring_prior(tok, pretoken_counts=got),
                                  jprior)


@pytest.mark.parametrize("name", ["en_raw", "gpt_neox0001"])
def test_chunked_tokenize_and_get_prior_match_jax(name, texts):
    jtok, tok = _pair(name)
    want = jax_chunked_tokenize(jtok, texts, 32)
    got = chunked_tokenize(tok, texts, 32)
    for key in ("input_ids", "char_lengths"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    for mode in ("reestimate", "use_tokenizer"):
        np.testing.assert_array_equal(
            priors.get_prior(mode, got["input_ids"], tok, padding=3),
            jax_priors.get_prior(mode, want["input_ids"], jtok, padding=3))
    assert priors.get_prior("keep", got["input_ids"], tok) is None
    with pytest.raises(ValueError, match="Unknown prior mode"):
        priors.get_prior("bogus", got["input_ids"], tok)


def _priors(path):
    return np.load(path, allow_pickle=True).item()


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("name", ["en_raw", "gpt_neox0001"])
def test_cli_matches_jax(name, device, texts, tmp_path):
    """The port's CLI (with --device cpu, or with --host-encode) writes the
    same priors.npy as the JAX CLI (with --device, or without it)."""
    data = tmp_path / "text.txt"
    data.write_text("\n".join(texts + ["", "   "]) + "\n")
    base = ["--tokenizer", os.path.dirname(TOK.format(name)), "--data", str(data)]
    jax_cli.main(base + ["--output", str(tmp_path / "jax.npy")] + (["--device"] if device else []))
    out = cli.main(base + ["--output", str(tmp_path / "port.npy")]
                   + (["--device", "cpu"] if device else ["--host-encode"]))
    got, want = _priors(out), _priors(tmp_path / "jax.npy")
    assert set(got) == set(want) == {"substring", "token"}
    for key in ("substring", "token"):
        np.testing.assert_array_equal(got[key], want[key])


def test_cli_use_tokenizer_and_max_texts_match_jax(texts, tmp_path):
    data = tmp_path / "text.txt"
    data.write_text("\n".join(texts) + "\n")
    base = ["--tokenizer", TOK.format("en_raw"), "--data", str(data), "--mode", "use_tokenizer",
            "--max-texts", "50", "--block-size", "16"]
    jax_cli.main(base + ["--output", str(tmp_path / "jax.npy")])
    cli.main(base + ["--output", str(tmp_path / "port.npy"), "--device", "cpu"])
    got, want = _priors(tmp_path / "port.npy"), _priors(tmp_path / "jax.npy")
    for key in ("substring", "token"):
        np.testing.assert_array_equal(got[key], want[key])


def test_bare_device_flag_means_the_card():
    """The card by default and for a bare --device; the host path only
    with its own flag, never beside --device."""
    base = ["--tokenizer", "t", "--data", "d"]
    assert cli.parse_args(base + ["--device"]).device == "cuda"
    assert cli.parse_args(base + ["--device", "cpu"]).device == "cpu"
    args = cli.parse_args(base)
    assert (args.device, args.host_encode) == ("cuda", False)
    assert cli.parse_args(base + ["--host-encode"]).host_encode
    with pytest.raises(SystemExit):
        cli.parse_args(base + ["--host-encode", "--device", "cpu"])


def test_default_takes_the_card_and_raises_without_one(tmp_path):
    """With no device flag the CLI counts on the card: here, where there
    is none, it raises before reading or writing anything, and names the
    CPU and host flags."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    out = tmp_path / "priors.npy"
    with pytest.raises(RuntimeError, match="--device cpu.*--host-encode"):
        cli.main(["--tokenizer", str(tmp_path / "missing"), "--data",
                  str(tmp_path / "missing.txt"), "--output", str(out)])
    assert not out.exists()


def test_device_path_refuses_bpe_by_naming_the_host_flag(texts, tmp_path):
    """A BPE tokenizer has no Viterbi to count with: the device path
    raises and names --host-encode, and never switches paths itself."""
    data = tmp_path / "text.txt"
    data.write_text("\n".join(texts[:20]) + "\n")
    out = tmp_path / "priors.npy"
    with pytest.raises(SystemExit, match="Unigram tokenizers only.*--host-encode"):
        cli.main(["--tokenizer", TOK.format("gpt2_raw"), "--data", str(data),
                  "--output", str(out), "--device", "cpu"])
    assert not out.exists()


def test_non_canonical_tokenizer_raises(texts):
    """A tokenizer outside the canonical byte-level structure runs its own
    normalizer and pre-tokenizer (held against JAX in
    ``test_torch_port_eval_cli.py``); one whose Split pattern the matcher
    does not translate (a Unicode property other than L, N and M) raises,
    naming ROADMAP A.16."""
    from zett_tpu_torch.tokenization.pretokenizers import PreTokenizer

    tok = Tokenizer.from_file(TOK.format("en_raw"))
    tok.pre_tokenizer = PreTokenizer.from_json({"type": "Split", "pattern": {"Regex": r"\p{Lu}+"},
                                                "behavior": "Isolated", "invert": False})
    with pytest.raises(NotImplementedError, match=r"A\.16"):
        priors.get_pretoken_counts(tok, texts)
    with pytest.raises(NotImplementedError, match=r"A\.16"):
        priors.compute_substring_prior(tok, texts=texts)
    with pytest.raises(NotImplementedError, match=r"A\.16"):
        chunked_tokenize(tok, texts, 32)
