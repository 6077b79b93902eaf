"""The port's stdlib-only tokenization (zett_tpu_torch/tokenization) held
against the JAX package's on the repo's byte-level tokenizers: identical
tokenizer.json text and identical surface-form matrices."""

import os

import numpy as np
import pytest

from zett_tpu.tokenization import Tokenizer as JaxTokenizer
from zett_tpu.tokenization.convert import convert_to_byte_level as jax_convert
from zett_tpu.tokenization.surface_forms import get_surface_form_matrix as jax_surface_forms
from zett_tpu_torch.tokenization import Tokenizer
from zett_tpu_torch.tokenization.convert import convert_to_byte_level
from zett_tpu_torch.tokenization.jsonfloat import serde_f64
from zett_tpu_torch.tokenization.surface_forms import get_surface_form_matrix
from zett_tpu.tokenization.jsonfloat import serde_f64 as jax_serde_f64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK = os.path.join(REPO, "artifacts", "tokenizers", "{}", "tokenizer.json")


@pytest.fixture(scope="module")
def sources():
    return JaxTokenizer.from_file(TOK.format("gpt2_raw")), Tokenizer.from_file(TOK.format("gpt2_raw"))


@pytest.mark.parametrize("name", ["de_raw", "en_raw"])
def test_convert_and_surface_forms_match_jax(name, sources):
    jax_src, src = sources
    jax_tok, jax_n = jax_convert(JaxTokenizer.from_file(TOK.format(name)),
                                 match_special_tokens_to=jax_src,
                                 make_whitespace_consistent=True)
    tok, n = convert_to_byte_level(Tokenizer.from_file(TOK.format(name)),
                                   match_special_tokens_to=src,
                                   make_whitespace_consistent=True)
    assert n == jax_n
    assert tok.to_json() == jax_tok.to_json()
    assert tok.to_str(pretty=True) == jax_tok.to_str(pretty=True)
    assert tok.all_special_tokens == jax_tok.all_special_tokens
    sf, n_trunc = get_surface_form_matrix(tok, 7, src)
    jax_sf, jax_trunc = jax_surface_forms(jax_tok, 7, jax_src)
    assert n_trunc == jax_trunc
    np.testing.assert_array_equal(sf, jax_sf)


@pytest.mark.parametrize("name", ["gpt2_raw", "gpt_neox0001", "bert0001"])
def test_load_save_round_trip_matches_jax(name, tmp_path):
    """Loading and saving writes the same text as the JAX package."""
    tok = Tokenizer.from_file(TOK.format(name))
    jax_tok = JaxTokenizer.from_file(TOK.format(name))
    assert len(tok) == len(jax_tok)
    assert tok.to_str(pretty=True) == jax_tok.to_str(pretty=True)
    tok.save(str(tmp_path / "t.json"))
    assert Tokenizer.from_file(str(tmp_path / "t.json")).to_str() == tok.to_str()


def test_non_byte_level_conversion_raises():
    """A non-byte-level tokenizer whose probe meets a Regex pattern that
    reads differently under re than under regex and that the matcher does
    not translate (``patterns.py``; the port does not use the regex module)
    raises naming ROADMAP A.16; a Metaspace one converts
    (``test_torch_port_llama.py``)."""
    data = Tokenizer.from_file(TOK.format("bert0001")).to_json()
    data["pre_tokenizer"] = {"type": "Metaspace", "replacement": "\u2581",
                             "prepend_scheme": "always", "split": True}
    data["normalizer"] = {"type": "Replace", "pattern": {"Regex": r"\p{Zs}{2,}"}, "content": " "}
    with pytest.raises(NotImplementedError, match=r"Regex pattern.*ROADMAP A\.16"):
        convert_to_byte_level(Tokenizer.from_json(data))


@pytest.mark.parametrize("literal", ["-7.123456789012345", "-0.1", "-12.5e-3", "3", "-100000.0",
                                     "-9.99999999999999999999"])
def test_serde_parse_matches_jax(literal):
    assert serde_f64(literal) == jax_serde_f64(literal)
