"""The port's baseline transfers (zett_tpu_torch/transfer/baselines.py and
baselines_cli.py) held against the JAX package on the CPU: lexical copy
with FVT/BFVT and both fallbacks, the char-n-gram space, FOCUS with and
without auxiliary vectors, OFA with word vectors and an SVD factorization
and without, the chunked similarity search, passthrough slicing and
apply_to_ft, each on the same tokenizers and tables; both CLIs on one tiny
GPT-2 directory; and ROADMAP C.13, the char-n-gram space's dependence on
PYTHONHASHSEED, in subprocesses."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from zett_tpu.tokenization import Tokenizer as JaxTokenizer
from zett_tpu.tokenization.convert import convert_to_byte_level as jax_convert
from zett_tpu.transfer import baselines as jb
from zett_tpu_torch.tokenization.convert import convert_to_byte_level
from zett_tpu_torch.tokenization.core import Tokenizer
from zett_tpu_torch.transfer import baselines as tb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["the", "of", "and", "to", "in", "was", "hello", "world", "test", "der", "die", "das",
         "token", "model", "with", "from"]


@pytest.fixture(scope="module")
def toks(gpt2_like_json, xlmr_like_json):
    """(JAX source, JAX target, port source, port target): the gpt2-like
    source and the xlmr-like target, each converted by its own package as
    the CLIs convert them."""
    jsrc, _ = jax_convert(JaxTokenizer.from_json(gpt2_like_json))
    jtgt, _ = jax_convert(JaxTokenizer.from_json(xlmr_like_json), match_special_tokens_to=jsrc,
                          make_whitespace_consistent=True)
    tsrc, _ = convert_to_byte_level(Tokenizer.from_str(json.dumps(gpt2_like_json)))
    ttgt, _ = convert_to_byte_level(Tokenizer.from_str(json.dumps(xlmr_like_json)),
                                    match_special_tokens_to=tsrc, make_whitespace_consistent=True)
    assert jtgt.get_vocab() == ttgt.get_vocab()
    return jsrc, jtgt, tsrc, ttgt


def _table(n, d=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("fallback", ["unk", "random"])
@pytest.mark.parametrize("fvt", ["no", "fvt", "bfvt"])
def test_lexical_matches_jax(toks, fvt, fallback):
    """Every row and the overlap list equal JAX's exactly (the same numpy)."""
    jsrc, jtgt, tsrc, ttgt = toks
    src = _table(len(jsrc))
    want, want_overlap = jb.lexical_transfer(src, jsrc, jtgt, fvt_mode=fvt,
                                             fallback_mode=fallback, seed=3)
    got, got_overlap = tb.lexical_transfer(src, tsrc, ttgt, fvt_mode=fvt,
                                           fallback_mode=fallback, seed=3)
    assert got_overlap == want_overlap
    np.testing.assert_array_equal(got, want)
    if fvt != "no":
        assert len(got_overlap) > len(tb.lexical_transfer(src, tsrc, ttgt)[1])


def test_char_ngram_embeddings_match_jax_in_one_process():
    tokens = ["hello", "hella", "xyzzy", "", "Ġthe", "▁world"]
    np.testing.assert_array_equal(tb.char_ngram_embeddings(tokens),
                                  jb.char_ngram_embeddings(tokens))
    np.testing.assert_array_equal(tb.char_ngram_embeddings(tokens, dim=32, seed=5),
                                  jb.char_ngram_embeddings(tokens, dim=32, seed=5))


def _hashed_vector(package, hash_seed):
    code = (f"from {package}.transfer.baselines import char_ngram_embeddings; "
            "print(char_ngram_embeddings(['hello'], dim=8).tolist())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONHASHSEED"] = str(hash_seed)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_char_ngrams_depend_on_the_hash_seed():
    """ROADMAP C.13: char_ngram_embeddings(["hello"], dim=8) differs
    between PYTHONHASHSEED 1 and 2 in JAX and in the port, and the two
    packages agree under one seed."""
    jax1, jax2 = _hashed_vector("zett_tpu", 1), _hashed_vector("zett_tpu", 2)
    port1, port2 = _hashed_vector("zett_tpu_torch", 1), _hashed_vector("zett_tpu_torch", 2)
    assert jax1 != jax2 and port1 != port2
    assert port1 == jax1 and port2 == jax2


@pytest.mark.parametrize("aux", ["char_ngrams", "vectors"])
def test_focus_matches_jax(toks, aux):
    """FOCUS on the CPU equals JAX's exactly: the char-n-gram space, or
    auxiliary vectors for every token of both vocabularies."""
    jsrc, jtgt, tsrc, ttgt = toks
    src = _table(len(jsrc), seed=1)
    vectors = None
    if aux == "vectors":
        rng = np.random.default_rng(2)
        tokens = set(jsrc.get_vocab()) | set(jtgt.get_vocab())
        vectors = {t: v / np.linalg.norm(v) for t in sorted(tokens)
                   for v in [rng.normal(size=12).astype(np.float32)]}
    want, want_overlap = jb.focus_transfer(src, jsrc, jtgt, auxiliary_embeddings=vectors,
                                           top_k=5, temperature=0.2)
    got, got_overlap = tb.focus_transfer(src, tsrc, ttgt, auxiliary_embeddings=vectors,
                                         top_k=5, temperature=0.2, device="cpu")
    assert got_overlap == want_overlap and len(got) > len(got_overlap)
    np.testing.assert_array_equal(got, want)


def test_chunked_search_equals_one_block():
    """top_k_similar a few rows at a time gives what one block gives, row
    for row, and JAX's selection (it searches the whole matrix at once),
    with a short last block joined to the one before it."""
    q = tb.char_ngram_embeddings([f"tok{i}x" for i in range(300)])
    k = tb.char_ngram_embeddings([f"x{i}tok" for i in range(400)])
    whole = tb.top_k_similar(q, k, 7, chunk_rows=4096)
    assert tb.row_blocks(300, 64) == [(0, 64), (64, 128), (128, 192), (192, 300)]
    assert tb.row_blocks(300, 8) == tb.row_blocks(300, 64)
    for rows in (64, 100, 150):
        part = tb.top_k_similar(q, k, 7, chunk_rows=rows)
        np.testing.assert_array_equal(part[0], whole[0])
        np.testing.assert_array_equal(part[1], whole[1])
    sims = q @ k.T
    want = np.argpartition(-sims, 6, axis=1)[:, :7]
    np.testing.assert_array_equal(whole[0], want)


def test_card_search_picks_numpys_sets_but_at_ties():
    """The card's block search (torch.matmul, torch.topk) run on CPU
    tensors: each row's top-k set is numpy's selection's unless its k-th and
    (k+1)-th similarities tie within 1e-6 (hashed char n-grams tie often);
    the products within 1e-6."""
    q = tb.char_ngram_embeddings([f"tok{i}x" for i in range(200)])
    k = tb.char_ngram_embeddings([f"x{i}tok" for i in range(400)])
    idx, vals = tb.top_k_similar(q, k, 7)
    top_v, top_i = tb.topk_torch(torch.from_numpy(q), torch.from_numpy(k), 7)
    sims = np.sort(q @ k.T, axis=1)[:, ::-1]
    ties = 0
    for r in range(len(q)):
        if set(top_i[r].tolist()) != set(idx[r].tolist()):
            assert sims[r, 6] - sims[r, 7] <= 1e-6, r
            ties += 1
    assert ties < len(q)
    assert np.abs(np.sort(top_v.numpy(), 1) - np.sort(vals, 1)).max() <= 1e-6


@pytest.mark.parametrize("variant", ["char_ngrams", "word_vectors_factorized"])
def test_ofa_matches_jax(toks, variant):
    """OFA on the CPU: the overlap list, the overlapping rows and the
    random rows equal JAX's exactly; the combined rows within 1e-6 of the
    largest |row| (numpy's einsum and product on row blocks, as JAX on the
    whole matrix)."""
    jsrc, jtgt, tsrc, ttgt = toks
    src = _table(len(jsrc), d=16, seed=5)
    kw = dict(top_k=5, seed=7)
    if variant == "word_vectors_factorized":
        rng = np.random.default_rng(6)
        kw.update(word_embeddings={w: rng.normal(size=12).astype(np.float32) for w in WORDS},
                  factorize_dim=6)
        reps_want, has_want = jb.ofa_subword_embeddings(jsrc, kw["word_embeddings"])
        reps_got, has_got = tb.ofa_subword_embeddings(tsrc, kw["word_embeddings"])
        np.testing.assert_array_equal(reps_got, reps_want)
        np.testing.assert_array_equal(has_got, has_want)
    want, want_overlap = jb.ofa_transfer(src, jsrc, jtgt, **kw)
    got, got_overlap = tb.ofa_transfer(src, tsrc, ttgt, device="cpu", **kw)
    assert got_overlap == want_overlap
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(got[want_overlap], want[want_overlap])


def test_passthrough_slice_matches_jax():
    rng = np.random.default_rng(8)
    nested = {"input_embeddings": {"embedding": rng.normal(size=(10, 4))},
              "output_embeddings": {"embedding": rng.normal(size=(10, 4))},
              "bias": {"embedding": rng.normal(size=(10, 1))}}
    flat = {f"{k}/embedding": v["embedding"] for k, v in nested.items()}
    for got, want in zip(tb.passthrough_transfer(flat, 6), jb.passthrough_transfer(nested, 6)):
        np.testing.assert_array_equal(got, want)
    del flat["output_embeddings/embedding"], nested["output_embeddings"]
    got_in, got_out = tb.passthrough_transfer(flat, 7)
    assert got_out is None and jb.passthrough_transfer(nested, 7)[1] is None
    np.testing.assert_array_equal(got_in, nested["input_embeddings"]["embedding"][:7])


def _flax_gpt2(seed, vocab):
    import jax
    import jax.numpy as jnp

    from zett_tpu.models.backbones.gpt2 import GPT2Config, GPT2LMHeadModel

    cfg = GPT2Config(vocab_size=vocab, n_positions=16, n_embd=16, n_layer=1, n_head=2)
    params = GPT2LMHeadModel(cfg).init(jax.random.PRNGKey(seed), jnp.ones((1, 4), jnp.int32))
    return cfg, jax.tree_util.tree_map(np.asarray, params["params"])


def _flax_llama(seed, vocab):
    import jax
    import jax.numpy as jnp

    from zett_tpu.models.backbones.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=vocab, hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2, tie_word_embeddings=False)
    params = LlamaForCausalLM(cfg).init(jax.random.PRNGKey(seed), jnp.ones((1, 4), jnp.int32))
    return cfg, jax.tree_util.tree_map(np.asarray, params["params"])


@pytest.mark.parametrize("model_type", ["gpt2", "llama"])
def test_apply_to_ft_matches_jax(model_type):
    """ft + 0.5 (swapped - base) off the tables, the swapped tables on them:
    the port over HF state dicts equals JAX over Flax trees (inverted to HF
    keys) within 1 f32 ulp of each weight's scale."""
    from zett_tpu.models.backbones import loader

    make, invert = ((_flax_gpt2, loader.invert_gpt2) if model_type == "gpt2"
                    else (_flax_llama, loader.invert_llama))
    (cfg, base), (_, ft) = make(0, 24), make(1, 24)
    swapped_cfg, swapped = make(2, 30)
    want = invert(jb.apply_to_ft(base, ft, swapped, model_type, lam=0.5), swapped_cfg)

    def hf(tree, c):
        return {k: torch.from_numpy(np.array(v)) for k, v in invert(tree, c).items()}

    got = tb.apply_to_ft(hf(base, cfg), hf(ft, cfg), hf(swapped, swapped_cfg), model_type, 0.5)
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert np.abs(got[k].numpy() - v).max() <= 1.2e-7 * max(np.abs(v).max(), 1.0), k


# ------------------------------------------------------------------------ CLI
@pytest.fixture(scope="module")
def gpt2_dir(tmp_path_factory, gpt2_like_json):
    """A tiny HF GPT-2 directory written by the JAX package's tools."""
    from safetensors.numpy import save_file

    from zett_tpu.models.backbones.loader import invert_gpt2

    path = tmp_path_factory.mktemp("gpt2_baselines")
    tok = JaxTokenizer.from_json(gpt2_like_json)
    cfg, params = _flax_gpt2(0, len(tok))
    sd = invert_gpt2(params, cfg)
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              str(path / "model.safetensors"))
    with open(path / "config.json", "w") as f:
        json.dump({"model_type": "gpt2", "vocab_size": len(tok), "n_positions": 16,
                   "n_embd": 16, "n_layer": 1, "n_head": 2, "layer_norm_epsilon": 1e-5,
                   "tie_word_embeddings": True}, f)
    tok.save(str(path / "tokenizer.json"))
    return str(path)


@pytest.mark.parametrize("method", ["lexical", "bfvt", "focus", "ofa"])
def test_cli_matches_jax_cli(gpt2_dir, xlmr_like_json, tmp_path, method):
    """Both CLIs on one tiny GPT-2 and the xlmr-like target: the same
    safetensors keys, dtypes and shapes; every tensor equal (the OFA table
    within 1e-6 of its largest |value|: numpy's einsum on row blocks), the
    same config.json and tokenizer vocabulary."""
    from safetensors.numpy import load_file

    from zett_tpu.transfer.baselines_cli import main as jax_main
    from zett_tpu_torch.transfer.baselines_cli import main as port_main

    target = tmp_path / "target.json"
    JaxTokenizer.from_json(xlmr_like_json).save(str(target))
    common = ["--method", method, "--model", gpt2_dir, "--target-tokenizer", str(target),
              "--top-k", "4"]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_main(common + ["--output", jax_out])
    port_main(common + ["--output", port_out, "--device", "cpu"])
    want = load_file(os.path.join(jax_out, "model.safetensors"))
    got = load_file(os.path.join(port_out, "model.safetensors"))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if method == "ofa" and k == "transformer.wte.weight":
            assert np.abs(got[k] - v).max() <= 1e-6 * np.abs(v).max(), k
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    with open(os.path.join(jax_out, "config.json")) as a, \
            open(os.path.join(port_out, "config.json")) as b:
        assert json.load(a) == json.load(b)
    jtok = JaxTokenizer.from_file(os.path.join(jax_out, "tokenizer.json"))
    ttok = Tokenizer.from_file(os.path.join(port_out, "tokenizer.json"))
    assert jtok.get_vocab() == ttok.get_vocab()
    assert want["transformer.wte.weight"].shape[0] == len(ttok)



@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory, gpt2_like_json):
    """A tiny HF Llama directory (untied head) written by the JAX package's
    tools, over the gpt2-like tokenizer."""
    from safetensors.numpy import save_file

    from zett_tpu.models.backbones.loader import invert_llama

    path = tmp_path_factory.mktemp("llama_baselines")
    tok = JaxTokenizer.from_json(gpt2_like_json)
    cfg, params = _flax_llama(0, len(tok))
    save_file({k: np.ascontiguousarray(v) for k, v in invert_llama(params, cfg).items()},
              str(path / "model.safetensors"))
    with open(path / "config.json", "w") as f:
        json.dump({"model_type": "llama", "vocab_size": len(tok), "hidden_size": 16,
                   "intermediate_size": 32, "num_hidden_layers": 1, "num_attention_heads": 2,
                   "tie_word_embeddings": False}, f)
    tok.save(str(path / "tokenizer.json"))
    return str(path)


@pytest.mark.parametrize("method", ["focus", "ofa"])
def test_cli_untied_head_matches_jax_cli(llama_dir, xlmr_like_json, tmp_path, method):
    """Both CLIs on a tiny Llama, whose input and output tables are
    transferred over the same anchors (the port builds them once): both
    tables equal JAX's (OFA's within 1e-6 of the largest |value|), every
    other tensor bit for bit."""
    from safetensors.numpy import load_file

    from zett_tpu.transfer.baselines_cli import main as jax_main
    from zett_tpu_torch.transfer.baselines_cli import main as port_main

    target = tmp_path / "target.json"
    JaxTokenizer.from_json(xlmr_like_json).save(str(target))
    common = ["--method", method, "--model", llama_dir, "--target-tokenizer", str(target),
              "--top-k", "4"]
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_main(common + ["--output", jax_out])
    summary = port_main(common + ["--output", port_out, "--device", "cpu"])
    assert summary["routes"]["in"] == summary["routes"]["out"]
    want = load_file(os.path.join(jax_out, "model.safetensors"))
    got = load_file(os.path.join(port_out, "model.safetensors"))
    assert set(got) == set(want)
    tables = ("model.embed_tokens.weight", "lm_head.weight")
    assert not np.array_equal(want[tables[0]], want[tables[1]])
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if method == "ofa" and k in tables:
            assert np.abs(got[k] - v).max() <= 1e-6 * np.abs(v).max(), k
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
