"""The port's transfer path (zett_tpu_torch/transfer) held against the JAX
package's on the CPU: get_sample_indices, transfer() on de_raw from a
gpt2_raw source, and the two transfer CLIs on the same checkpoint and HF
model directory. Also the hand-written safetensors reader and writer
against the safetensors library."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from zett_tpu.models import Hypernet as JaxHypernet
from zett_tpu.models import HypernetConfig as JaxConfig
from zett_tpu.tokenization import Tokenizer as JaxTokenizer
from zett_tpu.transfer import get_sample_indices as jax_sample_indices
from zett_tpu.transfer import transfer as jax_transfer
from zett_tpu_torch.models import Hypernet, HypernetConfig
from zett_tpu_torch.models.backbones.hf_io import load_safetensors, save_safetensors
from zett_tpu_torch.models.convert import flax_to_torch
from zett_tpu_torch.tokenization import Tokenizer
from zett_tpu_torch.transfer import get_sample_indices, transfer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK = os.path.join(REPO, "artifacts", "tokenizers", "{}", "tokenizer.json")
N_EMBD = 32


def _config(vocab):
    return dict(
        hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
        max_position_embeddings=8, n_embd=N_EMBD, hn_surface_maxlen=7,
        embed_using_source_embeddings=True, original_vocab_size=vocab, n_extra_tokens=16,
        rescale_embeddings=True, predict_bias=True,
        hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
    )


def _flax_params(cfg, src, seed=1):
    """Flax-initialized tree, every leaf refilled from a numpy seed."""
    model = JaxHypernet(JaxConfig(**cfg))
    sf = jnp.ones((4, 7), jnp.int32)
    p = model.init(jax.random.PRNGKey(0), sf, jnp.zeros(4), jnp.asarray(src), 0)
    flat = traverse_util.flatten_dict(p["params"], sep="/")
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith("kernel"):
            x = rng.normal(size=v.shape) / np.sqrt(v.shape[0])
        elif k.endswith("scale") or k.endswith("/w"):
            x = 1.0 + 0.1 * rng.normal(size=v.shape)
        else:
            x = 0.05 * rng.normal(size=v.shape)
        flat[k] = np.asarray(x, np.float32)
    return model, flat


@pytest.fixture(scope="module")
def source():
    vocab = len(Tokenizer.from_file(TOK.format("gpt2_raw")))
    src = (np.random.default_rng(0).normal(size=(vocab, N_EMBD)) * 0.05).astype(np.float32)
    return vocab, src


def test_sample_indices_match_jax():
    p = np.random.default_rng(0).normal(size=100)
    p[90:] = -100_000
    a = get_sample_indices(100, p, 40, 2, 6, rng=np.random.default_rng(7))
    b = jax_sample_indices(100, p, 40, 2, 6, rng=np.random.default_rng(7))
    np.testing.assert_array_equal(a, b)


def test_transfer_matches_jax(source):
    """transfer() on de_raw: emb_in and bias within 1e-5 absolute (f32
    hypernet, outputs of magnitude ~4; sums in another order), special-token
    rows and the converted tokenizer identical."""
    vocab, src = source
    cfg = _config(vocab)
    jax_model, flat = _flax_params(cfg, src)
    model = Hypernet(HypernetConfig(**cfg))
    model.load_state_dict(flax_to_torch(flat))
    common = dict(source_embeddings_in=src, lang_index=0, batch_size=2048, seed=3)
    ref_in, ref_out, ref_bias, ref_tok = jax_transfer(
        hypernet=jax_model,
        hn_params=traverse_util.unflatten_dict(flat, sep="/"),
        hn_tokenizer=JaxTokenizer.from_file(TOK.format("gpt2_raw")),
        source_tokenizer=JaxTokenizer.from_file(TOK.format("gpt2_raw")),
        target_tokenizer=JaxTokenizer.from_file(TOK.format("de_raw")),
        **common,
    )
    got_in, got_out, got_bias, got_tok = transfer(
        hypernet=model,
        hn_tokenizer=Tokenizer.from_file(TOK.format("gpt2_raw")),
        source_tokenizer=Tokenizer.from_file(TOK.format("gpt2_raw")),
        target_tokenizer=Tokenizer.from_file(TOK.format("de_raw")),
        **common,
    )
    assert ref_out is None and got_out is None
    assert got_tok.to_str() == ref_tok.to_str()
    assert got_in.shape == ref_in.shape == (len(got_tok), N_EMBD)
    assert np.abs(got_in - ref_in).max() <= 1e-5
    assert np.abs(got_bias - ref_bias).max() <= 1e-5
    special = [got_tok.token_to_id(t) for t in got_tok.all_special_tokens]
    np.testing.assert_array_equal(got_in[special], ref_in[special])


def _write_gpt2_dir(path, vocab, seed=0):
    """A tiny HF-format GPT-2 directory with every key HF writes, including
    the attention-mask buffers the transfer drops."""
    rng = np.random.default_rng(seed)
    E, n_pos = N_EMBD, 16
    sd = {
        "transformer.wte.weight": rng.normal(size=(vocab, E)) * 0.05,
        "transformer.wpe.weight": rng.normal(size=(n_pos, E)) * 0.02,
        "transformer.ln_f.weight": 1 + 0.1 * rng.normal(size=E),
        "transformer.ln_f.bias": 0.1 * rng.normal(size=E),
        "transformer.h.0.attn.bias": np.tril(np.ones((n_pos, n_pos)))[None, None],
    }
    for name, shape in [("ln_1.weight", (E,)), ("ln_1.bias", (E,)), ("ln_2.weight", (E,)),
                        ("ln_2.bias", (E,)), ("attn.c_attn.weight", (E, 3 * E)),
                        ("attn.c_attn.bias", (3 * E,)), ("attn.c_proj.weight", (E, E)),
                        ("attn.c_proj.bias", (E,)), ("mlp.c_fc.weight", (E, 4 * E)),
                        ("mlp.c_fc.bias", (4 * E,)), ("mlp.c_proj.weight", (4 * E, E)),
                        ("mlp.c_proj.bias", (E,))]:
        sd[f"transformer.h.0.{name}"] = rng.normal(size=shape) * 0.02
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    sd = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}
    os.makedirs(path, exist_ok=True)
    save_safetensors(sd, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "gpt2", "vocab_size": vocab, "n_positions": n_pos,
                   "n_embd": E, "n_layer": 1, "n_head": 2, "layer_norm_epsilon": 1e-5,
                   "tie_word_embeddings": True}, f)
    Tokenizer.from_file(TOK.format("gpt2_raw")).save(os.path.join(path, "tokenizer.json"))
    return sd


def test_transfer_cli_matches_jax(source, tmp_path):
    """Both CLIs on one HF model dir and one hypernet checkpoint (orbax for
    the JAX package, params.npz for the port): the same safetensors keys,
    the spliced table and bias.npy within 1e-5, the other weights and the
    config and tokenizer files identical."""
    import orbax.checkpoint as ocp
    from safetensors.numpy import load_file

    from zett_tpu.transfer.__main__ import main as jax_main
    from zett_tpu_torch.transfer.__main__ import main as port_main

    vocab, src = source
    model_dir = str(tmp_path / "gpt2")
    sd = _write_gpt2_dir(model_dir, vocab)
    cfg = _config(vocab)
    _, flat = _flax_params(cfg, sd["transformer.wte.weight"].numpy())
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    with open(ckpt / "hn_config.json", "w") as f:
        json.dump(JaxConfig(**cfg).to_dict(), f)
    np.savez(ckpt / "params.npz", **flat)
    Tokenizer.from_file(TOK.format("gpt2_raw")).save(str(ckpt / "tokenizer.json"))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(ckpt / "state"), traverse_util.unflatten_dict(flat, sep="/"))
    ckptr.wait_until_finished()

    common = ["--checkpoint", str(ckpt), "--model", model_dir,
              "--target-tokenizer", TOK.format("de_raw"), "--batch-size", "1024"]
    jax_out, port_out = str(tmp_path / "jax_out"), str(tmp_path / "port_out")
    jax_main(common + ["--output", jax_out])
    port_main(common + ["--output", port_out, "--device", "cpu"])

    ref = load_file(os.path.join(jax_out, "model.safetensors"))
    got = load_file(os.path.join(port_out, "model.safetensors"))
    assert set(got) == set(ref)
    assert "transformer.h.0.attn.bias" not in got
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        if k in ("transformer.wte.weight", "lm_head.weight"):
            assert np.abs(got[k] - ref[k]).max() <= 1e-5, k
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(got["lm_head.weight"], got["transformer.wte.weight"])
    bias_ref = np.load(os.path.join(jax_out, "bias.npy"))
    bias_got = np.load(os.path.join(port_out, "bias.npy"))
    assert bias_got.dtype == bias_ref.dtype and np.abs(bias_got - bias_ref).max() <= 1e-5
    for name in ("tokenizer.json", "config.json"):
        with open(os.path.join(jax_out, name)) as a, open(os.path.join(port_out, name)) as b:
            assert a.read() == b.read(), name


def test_safetensors_round_trip_with_library(tmp_path):
    """The hand-written writer is read by the safetensors library and the
    reader reads what the library writes, for every supported dtype."""
    from safetensors.torch import load_file, save_file

    rng = np.random.default_rng(0)
    tensors = {
        "a.f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
        "b.bf16": torch.from_numpy(rng.normal(size=(4,)).astype(np.float32)).to(torch.bfloat16),
        "c.f16": torch.from_numpy(rng.normal(size=(2, 2, 2)).astype(np.float16)),
        "d.i64": torch.arange(7, dtype=torch.int64),
        "e.empty": torch.zeros(0, 3),
    }
    ours = str(tmp_path / "ours.safetensors")
    save_safetensors(tensors, ours)
    theirs = str(tmp_path / "theirs.safetensors")
    save_file(tensors, theirs)
    for loaded in (load_file(ours), load_safetensors(theirs), load_safetensors(ours)):
        assert set(loaded) == set(tensors)
        for k, v in tensors.items():
            assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k
