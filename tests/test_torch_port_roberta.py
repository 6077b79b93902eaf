"""The port's (XLM-)RoBERTa backbone (zett_tpu_torch/models/backbones/roberta.py)
and what carries it, held against the JAX package on the CPU: the MLM
logits and the headless hidden states against JAX's RobertaForMaskedLM and
RobertaModel from one numpy-seeded HF-layout state dict (JAX reads it
through loader.convert_roberta, the port directly) on a padded batch, with
remat; the registry's Flax paths against convert_roberta's; the splice's
keys and zeroed bias against JAX's splice_embeddings + invert_roberta; the
HF directory round trip; and the corpus-size language sampling on
artifacts/26l.txt and the MADLAD metadata. (A JAX hypernet at xlmr_26l's
settings carried into the port: tests/test_torch_port_mlm.py's train
steps.)"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from zett_tpu.models.backbones.loader import convert_roberta, invert_roberta
from zett_tpu.models.backbones.roberta import RobertaConfig as JaxRobertaConfig
from zett_tpu.models.backbones.roberta import RobertaForMaskedLM as JaxRobertaForMaskedLM
from zett_tpu.models.backbones.roberta import RobertaModel as JaxRobertaModel
from zett_tpu.models.splice import splice_embeddings as jax_splice
from zett_tpu_torch.models.backbones.registry import (build_model, config_from_hf,
                                                      headless_model, is_output_tied, mlm_head)
from zett_tpu_torch.models.backbones.roberta import RobertaForMaskedLM, weight_keys
from zett_tpu_torch.models.convert import backbone_flax_path, backbone_transposed
from zett_tpu_torch.models.splice import extract_embeddings, splice_embeddings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# XLM-R base's config.json layout at a test's widths
HF_CONFIG = dict(model_type="xlm-roberta", vocab_size=300, hidden_size=48,
                 num_hidden_layers=2, num_attention_heads=3, intermediate_size=96,
                 max_position_embeddings=40, type_vocab_size=1, layer_norm_eps=1e-5,
                 pad_token_id=1, bos_token_id=0, eos_token_id=2, hidden_act="gelu")
_LAYER_SHAPES = {
    "attention.self.query": "HH", "attention.self.key": "HH", "attention.self.value": "HH",
    "attention.output.dense": "HH", "intermediate.dense": "IH", "output.dense": "HI",
}


def roberta_state_dict(hf_config, seed=0):
    """A seeded HF-layout RoBERTa MLM state dict as numpy f32 arrays, with
    every key HF writes: the tied decoder's weight and bias and the
    position_ids buffer included."""
    rng = np.random.default_rng(seed)
    H, I, V = hf_config["hidden_size"], hf_config["intermediate_size"], hf_config["vocab_size"]
    dims = {"H": H, "I": I}

    def normal(*shape, scale=0.05):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    def ln(prefix):
        return {f"{prefix}.weight": (1 + 0.1 * rng.normal(size=H)).astype(np.float32),
                f"{prefix}.bias": normal(H)}

    sd = {"roberta.embeddings.word_embeddings.weight": normal(V, H, scale=0.5),
          "roberta.embeddings.position_embeddings.weight": normal(
              hf_config["max_position_embeddings"], H, scale=0.5),
          "roberta.embeddings.token_type_embeddings.weight": normal(
              hf_config["type_vocab_size"], H, scale=0.5),
          "roberta.embeddings.position_ids": np.arange(
              hf_config["max_position_embeddings"], dtype=np.int64)[None],
          **ln("roberta.embeddings.LayerNorm")}
    for i in range(hf_config["num_hidden_layers"]):
        p = f"roberta.encoder.layer.{i}."
        for name, (o, n) in _LAYER_SHAPES.items():
            sd[p + name + ".weight"] = normal(dims[o], dims[n], scale=1 / np.sqrt(dims[n]))
            sd[p + name + ".bias"] = normal(dims[o])
        sd.update(ln(p + "attention.output.LayerNorm"))
        sd.update(ln(p + "output.LayerNorm"))
    sd.update({"lm_head.dense.weight": normal(H, H, scale=1 / np.sqrt(H)),
               "lm_head.dense.bias": normal(H), **ln("lm_head.layer_norm"),
               "lm_head.bias": normal(V)})
    sd["lm_head.decoder.weight"] = sd["roberta.embeddings.word_embeddings.weight"]
    sd["lm_head.decoder.bias"] = sd["lm_head.bias"]
    return sd


def jax_roberta(hf_config, sd, dtype=jnp.float32, remat=False):
    """(JAX RobertaForMaskedLM, its config, its params from convert_roberta)."""
    cfg = JaxRobertaConfig(**{k: hf_config[k] for k in (
        "vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
        "intermediate_size", "max_position_embeddings", "type_vocab_size", "layer_norm_eps",
        "pad_token_id")}, remat_blocks=remat)
    return JaxRobertaForMaskedLM(cfg, dtype=dtype), cfg, convert_roberta(sd, cfg)


def padded_batch(vocab, seed=1, B=3, L=12):
    """Ids in [3, vocab) with <s> (0) first, </s> (2) last and pad (1) past
    each row's length; row 1 is ragged, row 2 has a pad id inside its
    attended span (position ids come from the ids, not the mask)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(B, L))
    ids[:, 0] = 0
    ids[:, -1] = 2
    mask = np.ones((B, L), np.int64)
    ids[1, 8:] = 1
    ids[1, 7] = 2
    mask[1, 8:] = 0
    ids[2, 4] = 1
    return ids, mask


def _port(sd, hf_config=HF_CONFIG, dtype=torch.float32, remat=False):
    import dataclasses

    cfg = dataclasses.replace(config_from_hf(hf_config["model_type"], hf_config),
                              remat_blocks=remat)
    state = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    return build_model(hf_config["model_type"], cfg, state, dtype), state


def test_logits_and_hidden_states_match_jax():
    """MLM logits (own table and bias) and RobertaModel's hidden states on a
    padded batch, f32: max abs difference <= 1e-4, on the attended
    positions and the padded ones."""
    sd = roberta_state_dict(HF_CONFIG)
    jmodel, jcfg, params = jax_roberta(HF_CONFIG, sd)
    ids, mask = padded_batch(HF_CONFIG["vocab_size"])
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids),
                                            jnp.asarray(mask)))
    want_h = np.asarray(jax.jit(JaxRobertaModel(jcfg).apply)(
        {"params": params["roberta"]}, jnp.asarray(ids), jnp.asarray(mask)))
    model, state = _port(sd)
    assert isinstance(model, RobertaForMaskedLM)
    with torch.no_grad():
        got = model.mlm_logits(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        got_h = headless_model("xlm-roberta", model)(
            torch.from_numpy(ids), torch.from_numpy(mask),
            state["roberta.embeddings.word_embeddings.weight"]).numpy()
    assert got.shape == want.shape == (3, 12, HF_CONFIG["vocab_size"])
    assert np.abs(got - want).max() <= 1e-4
    assert got_h.shape == want_h.shape and np.abs(got_h - want_h).max() <= 1e-4
    # the head: the transform then the tied decoder plus the bias
    with torch.no_grad():
        t = mlm_head("xlm-roberta", model)(torch.from_numpy(got_h))
        table = state["roberta.embeddings.word_embeddings.weight"]
        again = (t @ table.t() + state["lm_head.bias"]).numpy()
    assert np.abs(again - want).max() <= 1e-4


def test_remat_matches_the_plain_run():
    """remat_blocks under gradients: the same logits and the same gradient
    of the input table and of every layer weight as without it."""
    sd = roberta_state_dict(HF_CONFIG)
    ids, mask = (torch.from_numpy(a) for a in padded_batch(HF_CONFIG["vocab_size"]))
    out = []
    for remat in (False, True):
        model, state = _port(sd, remat=remat)
        table = state["roberta.embeddings.word_embeddings.weight"].clone().requires_grad_(True)
        logits = model(ids, mask, table)
        (logits.square().mean()).backward()
        grads = {k: p.grad.clone() for k, p in model.named_hf_parameters() if p.grad is not None}
        out.append((logits.detach(), table.grad.clone(), grads))
    (l0, g0, p0), (l1, g1, p1) = out
    assert torch.equal(l0, l1)
    assert torch.allclose(g0, g1, rtol=0, atol=1e-7)
    assert set(p0) == set(p1) and "roberta.encoder.layer.1.output.dense.weight" in p0
    for k in p0:
        assert torch.allclose(p0[k], p1[k], rtol=0, atol=1e-6), k


def test_bf16_logits_match_jax():
    """bf16 compute with the frozen backbone held in bf16 (as the trainer
    holds it): logits within 3% of their scale (XLA rounds every bf16 op,
    the port rounds fused gelu/LayerNorm once)."""
    sd = roberta_state_dict(HF_CONFIG)
    sd16 = {k: (v.astype(jnp.bfloat16) if v.dtype == np.float32 else v) for k, v in sd.items()}
    jmodel, _, params = jax_roberta(HF_CONFIG, sd16, dtype=jnp.bfloat16)
    ids, mask = padded_batch(HF_CONFIG["vocab_size"])
    want = np.asarray(jnp.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids),
                                                        jnp.asarray(mask)), jnp.float32))
    state = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    state = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32 else v)
             for k, v in state.items()}
    model = build_model("xlm-roberta", config_from_hf("xlm-roberta", HF_CONFIG), state,
                        torch.bfloat16)
    with torch.no_grad():
        got = model.mlm_logits(torch.from_numpy(ids), torch.from_numpy(mask)).float().numpy()
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_registry_and_flax_paths():
    """Tied, no out table; every held key maps to the Flax path
    convert_roberta gives it, kernels transposed; the HF keys JAX keeps are
    the model's plus the tied decoder's."""
    sd = roberta_state_dict(HF_CONFIG)
    _, _, params = jax_roberta(HF_CONFIG, sd)
    flat = traverse_util.flatten_dict(params)
    model, _ = _port(sd)
    assert is_output_tied("xlm-roberta") and is_output_tied("roberta")
    seen = set()
    for key, p in model.named_hf_parameters():
        path = backbone_flax_path("xlm-roberta", key)
        want = flat[path]
        got = p.detach().numpy()
        got = got.T if backbone_transposed("xlm-roberta", key) else got
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=key)
        seen.add(path)
    assert seen == set(flat)
    assert set(weight_keys(model.config)) | {"lm_head.decoder.weight", "lm_head.decoder.bias"} \
        == set(invert_roberta(params, None))
    source, n = extract_embeddings({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                                   "xlm-roberta")
    assert n == HF_CONFIG["vocab_size"] and source.shape == (384, HF_CONFIG["hidden_size"])


@pytest.mark.parametrize("bias", [False, True])
def test_splice_matches_jax_and_round_trips(bias, tmp_path):
    """The splice of a new (V', E) table: the keys invert_roberta writes
    after JAX's splice (no position_ids), the decoder tied to the table,
    both bias keys zero (or the given bias), every other weight unchanged;
    then save_hf_model / load_hf_state_dict round trip bit for bit with
    config.json's vocab_size."""
    from zett_tpu_torch.models.backbones.hf_io import load_hf_state_dict, save_hf_model

    sd = roberta_state_dict(HF_CONFIG)
    _, _, params = jax_roberta(HF_CONFIG, sd)
    new = np.random.default_rng(3).normal(size=(257, HF_CONFIG["hidden_size"])).astype(np.float32)
    b = np.random.default_rng(4).normal(size=257).astype(np.float32) if bias else None
    ref = invert_roberta(jax_splice(params, "xlm-roberta", jnp.asarray(new), None,
                                    None if b is None else jnp.asarray(b)), None)
    state = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    got = splice_embeddings(state, "xlm-roberta", torch.from_numpy(new),
                            bias=None if b is None else torch.from_numpy(b))
    assert set(got) == set(ref)
    assert "roberta.embeddings.position_ids" not in got
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    for k in ("lm_head.bias", "lm_head.decoder.bias"):
        assert got[k].dtype == torch.float32 and got[k].shape == (257,)
        assert bool((got[k] == 0).all()) != bias
    assert torch.equal(got["lm_head.decoder.weight"], torch.from_numpy(new))

    out = str(tmp_path / "spliced")
    save_hf_model(out, got, dict(HF_CONFIG, vocab_size=257))
    back = load_hf_state_dict(out)
    assert set(back) == set(got)
    for k in got:
        assert torch.equal(back[k], got[k]), k
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["vocab_size"] == 257


def test_language_sampling_matches_jax():
    """26l.txt with the MADLAD metadata at alpha 0.1 (xlmr_26l.json): sizes
    equal, probabilities within 1e-12; a language missing from the CSV
    raises KeyError on both sides."""
    from zett_tpu.data.datasets import language_probs_from_sizes as jax_probs
    from zett_tpu.data.datasets import language_sizes_from_metadata as jax_sizes
    from zett_tpu.data.datasets import load_language_list as jax_list
    from zett_tpu_torch.data.datasets import (language_probs_from_sizes,
                                              language_sizes_from_metadata,
                                              load_language_list)

    csv = os.path.join(REPO, "artifacts", "madlad400_metadata.csv")
    path = os.path.join(REPO, "artifacts", "26l.txt")
    langs, probs = load_language_list(path)
    assert (langs, probs) == jax_list(path) and len(langs) == 26 and probs is None
    sizes = language_sizes_from_metadata(langs, csv)
    np.testing.assert_array_equal(sizes, jax_sizes(langs, csv))
    got, want = language_probs_from_sizes(sizes, 0.1), jax_probs(jax_sizes(langs, csv), 0.1)
    assert np.abs(got - want).max() <= 1e-12 and abs(got.sum() - 1) <= 1e-12
    assert got.argmax() == langs.index("en")
    for fn in (language_sizes_from_metadata, jax_sizes):
        with pytest.raises(KeyError, match="xx"):
            fn(["en", "xx"], csv)


def test_native_surface_forms_match_jax(xlmr_like_json):
    """Surface forms through a canonical byte-level Unigram hn tokenizer run
    its Viterbi natively: equal to JAX's get_surface_form_matrix (the
    model's Python tokenize) for de_raw's first 3000 tokens under the
    converted xlmr_like and under roberta0001, with a cache, and when the
    native side is off."""
    import zett_tpu_torch.tokenization.surface_forms as sfm
    from zett_tpu.tokenization import Tokenizer as JaxTokenizer
    from zett_tpu.tokenization.convert import convert_to_byte_level as jax_convert
    from zett_tpu.tokenization.surface_forms import get_surface_form_matrix as jax_sf
    from zett_tpu_torch.tokenization.convert import convert_to_byte_level
    from zett_tpu_torch.tokenization.core import Tokenizer

    tok = os.path.join(REPO, "artifacts", "tokenizers", "{}", "tokenizer.json")
    jhn, _ = jax_convert(JaxTokenizer.from_json(xlmr_like_json))
    thn, _ = convert_to_byte_level(Tokenizer.from_json(xlmr_like_json))
    cases = [(thn, jhn, "de_raw"),
             (Tokenizer.from_file(tok.format("roberta0001")),
              JaxTokenizer.from_file(tok.format("roberta0001")), "de_raw")]
    for thn, jhn, name in cases:
        assert sfm._native_segmenter(thn) is not None
        t = Tokenizer.from_file(tok.format(name))
        tokens = [t.id_to_token(i) for i in range(3000)]
        want, n_want = jax_sf(tokens, 7, jhn)
        got, n_got = sfm.get_surface_form_matrix(tokens, 7, thn)
        np.testing.assert_array_equal(got, want)
        assert n_got == n_want
        cache = {}
        again, _ = sfm.get_surface_form_matrix(tokens, 7, thn, cache=cache)
        np.testing.assert_array_equal(again, want)
        assert len(cache) > 2900
        saved = sfm._native_segmenter
        sfm._native_segmenter = lambda hn: None
        try:
            np.testing.assert_array_equal(sfm.get_surface_form_matrix(tokens, 7, thn)[0], want)
        finally:
            sfm._native_segmenter = saved
