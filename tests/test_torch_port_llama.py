"""The port's Llama family (zett_tpu_torch/models/backbones/llama.py) and
what carries it through transfer and training, held against the JAX package
on the CPU: the backbone against JAX LlamaForCausalLM (f32 and bf16) and
against HF torch built from a config in code (llama tied and untied with
GQA, mistral, gemma, qwen2; 2 layers, hidden 64), the HF key <-> Flax path
tables against loader.convert_llama / invert_llama, the metaspace and
WordPiece conversions against convert_to_byte_level (equal as JSON), the
transfer CLI on a tiny untied llama directory (both tables), and an
identity step and two train steps of a tiny untied-llama config against the
JAX trainer (losses and every hypernet gradient). Inputs come from numpy
seeds; each tolerance is stated where it is checked."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from zett_tpu.models import HypernetConfig as JaxHnConfig
from zett_tpu.models.backbones.llama import LlamaConfig as JaxLlamaConfig
from zett_tpu.models.backbones.llama import LlamaForCausalLM as JaxLlama
from zett_tpu.models.backbones.loader import convert_llama
from zett_tpu.models.backbones.loader import invert_llama as jax_invert_llama
from zett_tpu.models.backbones.registry import build_model as jax_build_model
from zett_tpu.tokenization import Tokenizer as JaxTokenizer
from zett_tpu.tokenization.convert import convert_to_byte_level as jax_convert
from zett_tpu.training import Trainer as JaxTrainer
from zett_tpu.training import TrainingConfig as JaxTrainingConfig
from zett_tpu.training.state import TrainState as JaxTrainState
from zett_tpu_torch.models import HypernetConfig
from zett_tpu_torch.models.backbones.hf_io import save_safetensors
from zett_tpu_torch.models.backbones.llama import LlamaConfig, LlamaForCausalLM
from zett_tpu_torch.models.backbones.registry import (is_output_tied, resolve_out_path)
from zett_tpu_torch.models.convert import flax_paths, invert_llama, llama_flax_path
from zett_tpu_torch.models.splice import extract_embeddings
from zett_tpu_torch.tokenization import Tokenizer
from zett_tpu_torch.tokenization.convert import convert_to_byte_level
from zett_tpu_torch.training import Trainer, TrainingConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK = os.path.join(REPO, "artifacts", "tokenizers", "{}", "tokenizer.json")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------- the backbone
def _hf_model(variant):
    """A tiny HF torch model of the family, weights from torch's seed 0."""
    import transformers as tf

    common = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4)
    if variant == "llama_tied":
        cfg, cls = tf.LlamaConfig(**common, num_key_value_heads=4, tie_word_embeddings=True), \
            tf.LlamaForCausalLM
    elif variant == "llama_untied_gqa":
        cfg, cls = tf.LlamaConfig(**common, num_key_value_heads=2, tie_word_embeddings=False), \
            tf.LlamaForCausalLM
    elif variant == "mistral":
        cfg, cls = tf.MistralConfig(**common, num_key_value_heads=2, tie_word_embeddings=False,
                                    sliding_window=None), tf.MistralForCausalLM
    elif variant == "gemma":
        # head_dim 32 is not hidden / heads (16): gemma's own head width
        cfg, cls = tf.GemmaConfig(**common, num_key_value_heads=4, head_dim=32,
                                  tie_word_embeddings=True, hidden_act="gelu_pytorch_tanh"), \
            tf.GemmaForCausalLM
    else:
        from transformers.models.qwen2.modeling_qwen2 import Qwen2ForCausalLM

        cfg, cls = tf.Qwen2Config(**common, num_key_value_heads=2, tie_word_embeddings=False,
                                  use_sliding_window=False, attention_dropout=0.0), \
            Qwen2ForCausalLM
    torch.manual_seed(0)
    model = cls(cfg).eval()
    # non-trivial RMSNorm weights (HF initialises them to ones, gemma's to 0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                p.add_(0.1 * torch.randn(p.shape))
    return model, cfg


def _ids(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, size=(2, 12)).astype(np.int64)
    mask = np.ones((2, 12), np.int64)
    mask[1, 8:] = 0
    return ids, mask


VARIANTS = ["llama_tied", "llama_untied_gqa", "mistral", "gemma", "qwen2"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_llama_family_matches_jax_and_hf(variant, dtype_name):
    """Logits on the unpadded positions. f32: within 1e-5 of the JAX module
    (the same arithmetic, sums in another order) and, as
    tests/test_backbones.py holds the JAX module, within 2e-4 absolute
    (gemma 5e-4) plus 1e-3 relative of HF torch. bf16 (the JAX module at
    dtype bf16, the port at compute dtype bf16, both from the f32
    weights): within 2 bf16 ulps of the largest logit of JAX's, since XLA
    rounds every intermediate bf16 op and torch rounds fused ones once."""
    hf, hf_cfg = _hf_model(variant)
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    ids, mask = _ids()
    valid = mask.astype(bool)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype_name]
    cfg = LlamaConfig.from_hf(hf_cfg.to_dict())
    assert cfg.tie_word_embeddings == hf_cfg.tie_word_embeddings
    port = LlamaForCausalLM(cfg, sd, tdt)
    out_key = resolve_out_path(variant.split("_")[0], sd, hf_cfg.to_dict())
    head = () if out_key is None else (sd[out_key],)
    with torch.no_grad():
        got = _f32(port(torch.from_numpy(ids), torch.from_numpy(mask),
                        sd["model.embed_tokens.weight"], *head))
    module, jcfg = jax_build_model(cfg.model_type, hf_config=hf_cfg, dtype=jdt)
    params = convert_llama({k: v.numpy() for k, v in sd.items()}, jcfg)
    ref = _f32(module.apply({"params": params}, jnp.asarray(ids),
                            attention_mask=jnp.asarray(mask)))
    assert got.shape == ref.shape == (2, 12, 128)
    err = np.abs(got - ref)[valid].max()
    if dtype_name == "float32":
        assert err <= 1e-5, err
        with torch.no_grad():
            theirs = hf(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).logits
        atol = 5e-4 if variant == "gemma" else 2e-4
        np.testing.assert_allclose(got[valid], theirs.numpy()[valid], atol=atol, rtol=1e-3)
    else:
        top = float(np.abs(ref).max())
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        assert err <= 2 * ulp, (err, ulp)


def test_llama_headless_remat_and_tied_head():
    """hidden_states is the logits' input (an untied head's logits are
    hidden @ lm_head.T); remat_blocks recomputes each layer in the backward
    and gives the same gradients of the input table; an untied model needs
    its head table."""
    hf, hf_cfg = _hf_model("llama_untied_gqa")
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    ids, mask = (torch.from_numpy(a) for a in _ids(1))
    grads = []
    for remat in (False, True):
        cfg = LlamaConfig.from_hf(hf_cfg.to_dict())
        cfg.remat_blocks = remat
        port = LlamaForCausalLM(cfg, sd, torch.float32)
        emb = sd["model.embed_tokens.weight"].clone().requires_grad_()
        logits = port(ids, mask, emb, sd["lm_head.weight"])
        hidden = port.hidden_states(ids, mask, emb)
        torch.testing.assert_close(logits, hidden @ sd["lm_head.weight"].t(), rtol=0, atol=0)
        (logits.square().mean()).backward()
        grads.append(emb.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="lm_head"):
        port(ids, mask, sd["model.embed_tokens.weight"])


# ------------------------------------------------------------- weights across
@pytest.mark.parametrize("variant", ["llama_tied", "qwen2"])
def test_weight_tables_match_jax_loader(variant):
    """llama_flax_path names, for every HF key that convert_llama keeps, the
    Flax leaf convert_llama writes it to (kernels transposed); the port's
    invert_llama gives exactly the JAX invert_llama's state dict. qwen2
    covers the q/k/v biases and an untied head; tied llama the head that
    convert_llama drops and invert_llama writes back."""
    hf, hf_cfg = _hf_model(variant)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    _, jcfg = jax_build_model(hf_cfg.model_type, hf_config=hf_cfg)
    tree = convert_llama(sd, jcfg)
    flat = traverse_util.flatten_dict(tree)
    seen = set()
    for key, value in sd.items():
        if key == "lm_head.weight" and jcfg.tie_word_embeddings:
            continue
        path = llama_flax_path(key)
        assert path in flat, key
        want = flat[path].T if path[-1] == "kernel" else flat[path]
        np.testing.assert_array_equal(value, want, err_msg=key)
        seen.add(path)
    assert seen == set(flat)
    want = jax_invert_llama(tree, jcfg)
    got = invert_llama(traverse_util.flatten_dict(tree, sep="/"), jcfg.tie_word_embeddings)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_registry_tied_and_untied():
    """is_output_tied reads tie_word_embeddings; resolve_out_path the
    presence of lm_head.weight unless the config ties it (a torch state dict
    of a tied model lists the head too); extract_embeddings returns
    [in | out] for an untied head, padded to 128 rows."""
    hf, hf_cfg = _hf_model("llama_untied_gqa")
    sd = dict(hf.state_dict())
    assert not is_output_tied("llama", hf_cfg.to_dict())
    assert is_output_tied("llama", {"tie_word_embeddings": True})
    assert is_output_tied("gpt2") and is_output_tied("gemma")
    assert resolve_out_path("llama", sd) == "lm_head.weight"
    assert resolve_out_path("llama", sd, {"tie_word_embeddings": True}) is None
    assert resolve_out_path("llama", {k: v for k, v in sd.items() if k != "lm_head.weight"}) \
        is None
    source, n = extract_embeddings(sd, "llama", config=hf_cfg.to_dict())
    assert n == 128 and source.shape == (128, 128)
    torch.testing.assert_close(source[:, 64:], sd["lm_head.weight"], rtol=0, atol=0)
    source, _ = extract_embeddings(sd, "llama", config={"tie_word_embeddings": True})
    assert source.shape == (128, 64)


# ---------------------------------------------------------- the conversions
def _conversion_pair(data, **kw):
    raw = json.dumps(data)
    return (jax_convert(JaxTokenizer.from_str(raw), **kw),
            convert_to_byte_level(Tokenizer.from_str(raw), **kw))


@pytest.mark.parametrize("name", ["llama_like_json", "bpe_metaspace_50k_json", "bert_like_json"])
@pytest.mark.parametrize("whitespace", [False, True])
def test_metaspace_conversion_matches_jax(name, whitespace, request):
    """The metaspace (sentencepiece-style BPE with byte fallback) and
    WordPiece (continuing-subword prefix) conversions are identical to the
    JAX package's as JSON: vocab order, merges, surface forms, added
    tokens, post-processor ids and n_added_tokens."""
    data = request.getfixturevalue(name)
    (jtok, jn), (ptok, pn) = _conversion_pair(data, make_whitespace_consistent=whitespace)
    assert pn == jn
    assert ptok.to_json() == jtok.to_json()
    assert len(ptok) == len(jtok) > 0


def test_matched_conversion_matches_jax(llama_like_json, bert_like_json):
    """The transfer's conversion of a target tokenizer: specials matched to
    a converted metaspace source (post-processor ids remapped, indices not
    preserved) and whitespace made consistent, identical to JAX's."""
    (jsrc, _), (psrc, _) = _conversion_pair(llama_like_json)
    raw = json.dumps(bert_like_json)
    jtok, jn = jax_convert(JaxTokenizer.from_str(raw), match_special_tokens_to=jsrc,
                           make_whitespace_consistent=True)
    ptok, pn = convert_to_byte_level(Tokenizer.from_str(raw), match_special_tokens_to=psrc,
                                     make_whitespace_consistent=True)
    assert jn is None and pn is None
    assert ptok.to_json() == jtok.to_json()


# ----------------------------------------------------- transfer and training
N_EMBD = 32  # the tiny backbone's hidden size
HN = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
          max_position_embeddings=8, n_embd=N_EMBD, hn_surface_maxlen=7,
          embed_using_source_embeddings=True, n_extra_tokens=16, rescale_embeddings=True,
          predict_bias=True, separate_out_embeddings=True,
          hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
BB = dict(hidden_size=N_EMBD, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, max_position_embeddings=64, rms_norm_eps=1e-5,
          tie_word_embeddings=False)


def _bb_params(vocab, seed=0):
    """An untied JAX Llama's parameters, every leaf refilled from a numpy
    seed (the RMSNorm weights around 1)."""
    cfg = JaxLlamaConfig(vocab_size=vocab, **BB)
    params = JaxLlama(cfg).init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    flat = traverse_util.flatten_dict(params, sep="/")
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        x = 1.0 + 0.1 * rng.normal(size=v.shape) if k.endswith("norm/weight") \
            else rng.normal(size=v.shape) * (0.05 if "embed" in k or "lm_head" in k else 0.1)
        flat[k] = np.asarray(x, np.float32)
    return cfg, flat


def _hn_params(cfg, src, seed=1):
    from zett_tpu.models import Hypernet as JaxHypernet

    model = JaxHypernet(JaxHnConfig(**cfg))
    p = model.init(jax.random.PRNGKey(0), jnp.ones((4, 7), jnp.int32), jnp.zeros(4),
                   jnp.asarray(src), 0)
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
    return flat


def test_transfer_cli_untied_llama_matches_jax(llama_like_json, tmp_path):
    """Both CLIs on one tiny untied llama directory (a metaspace BPE source
    tokenizer with byte fallback, converted by each CLI) and one hypernet
    checkpoint with dual heads: the same safetensors keys; embed_tokens
    and lm_head (the predicted in and out tables, which differ) and
    bias.npy within 1e-5 (f32 hypernet, sums in another order); the other
    weights, config.json (vocab_size updated) and tokenizer.json
    identical."""
    import orbax.checkpoint as ocp
    from safetensors.numpy import load_file

    from zett_tpu.transfer.__main__ import main as jax_main
    from zett_tpu_torch.transfer.__main__ import main as port_main

    source = Tokenizer.from_str(json.dumps(llama_like_json))
    vocab = len(source)
    cfg, flat_bb = _bb_params(vocab)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in jax_invert_llama(traverse_util.unflatten_dict(flat_bb, sep="/"),
                                       cfg).items()}
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(4)  # dropped on the way
    model_dir = tmp_path / "llama"
    model_dir.mkdir()
    save_safetensors(sd, str(model_dir / "model.safetensors"))
    with open(model_dir / "config.json", "w") as f:
        json.dump({"model_type": "llama", "vocab_size": vocab, **BB}, f)
    source.save(str(model_dir / "tokenizer.json"))

    hn = dict(HN, original_vocab_size=vocab)
    src = np.concatenate([sd["model.embed_tokens.weight"].numpy(),
                          sd["lm_head.weight"].numpy()], axis=1)
    flat = _hn_params(hn, src)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    with open(ckpt / "hn_config.json", "w") as f:
        json.dump(JaxHnConfig(**hn).to_dict(), f)
    np.savez(ckpt / "params.npz", **flat)
    convert_to_byte_level(source)[0].save(str(ckpt / "tokenizer.json"))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(ckpt / "state"), traverse_util.unflatten_dict(flat, sep="/"))
    ckptr.wait_until_finished()

    common = ["--checkpoint", str(ckpt), "--model", str(model_dir),
              "--target-tokenizer", TOK.format("de_raw"), "--batch-size", "1024"]
    jax_out, port_out = str(tmp_path / "jax_out"), str(tmp_path / "port_out")
    jax_main(common + ["--output", jax_out])
    port_main(common + ["--output", port_out, "--device", "cpu"])

    ref = load_file(os.path.join(jax_out, "model.safetensors"))
    got = load_file(os.path.join(port_out, "model.safetensors"))
    assert set(got) == set(ref)
    assert not any("inv_freq" in k for k in got)
    n_target = got["model.embed_tokens.weight"].shape[0]
    assert got["lm_head.weight"].shape == (n_target, N_EMBD)
    assert np.abs(got["lm_head.weight"] - got["model.embed_tokens.weight"]).max() > 0.01
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        if k in ("model.embed_tokens.weight", "lm_head.weight"):
            assert np.abs(got[k] - ref[k]).max() <= 1e-5, k
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    bias_ref = np.load(os.path.join(jax_out, "bias.npy"))
    bias_got = np.load(os.path.join(port_out, "bias.npy"))
    assert np.abs(bias_got - bias_ref).max() <= 1e-5
    for name in ("tokenizer.json", "config.json"):
        with open(os.path.join(jax_out, name)) as a, open(os.path.join(port_out, name)) as b:
            assert a.read() == b.read(), name
    with open(os.path.join(port_out, "config.json")) as f:
        assert json.load(f)["vocab_size"] == n_target


V_BATCH, VOCAB = 64, 300


def _batch(seed):
    rng = np.random.default_rng(seed)
    B, L, M = 3, 12, HN["hn_surface_maxlen"]
    sf = rng.integers(1, VOCAB + 16, size=(V_BATCH, M)).astype(np.int32)
    lens = rng.integers(1, M + 1, size=V_BATCH)
    sf[np.arange(M)[None] >= lens[:, None]] = 0
    sf[7] = 0  # an all-padding surface form
    attention_mask = np.ones((B, L), np.int32)
    attention_mask[1, 9:] = 0
    mask = np.ones(V_BATCH, bool)
    mask[-5:] = False
    return {
        "input_ids": rng.integers(0, V_BATCH, size=(B, L)).astype(np.int32),
        "attention_mask": attention_mask,
        "labels": rng.integers(0, V_BATCH, size=(B, L)).astype(np.int32),
        "target_surface_forms": sf,
        "target_priors": np.zeros(V_BATCH, np.float32),
        "mask": mask,
        "ids_to_embed": rng.permutation(VOCAB)[:V_BATCH].astype(np.int32),
        "special_indices": np.array([0, 5]),
        "special_indices_in_reference": np.array([0, 3]),
        "lang_index": np.array(0),
    }


def _llama_trainers():
    """A JAX Trainer and a port Trainer of a tiny untied llama from the same
    parameters (the backbone moved by the port's invert_llama), f32."""
    cfg, flat_bb = _bb_params(VOCAB, seed=3)
    bb_params = traverse_util.unflatten_dict(flat_bb, sep="/")
    kw = dict(steps=6, learning_rate=1e-3, warmup_steps=1, lexical_loss_weight=0.5,
              lexical_loss_kind="huber", max_grad_norm=0.05, weight_decay=0.01,
              adam_beta2=0.95, identity_steps=1, logging_steps=10, save_steps=0,
              eval_steps=0, dtype="float32")
    jtr = JaxTrainer(hn_config=JaxHnConfig(**HN), backbone_config=cfg, backbone_params=bb_params,
                     model_type="llama", train_config=JaxTrainingConfig(**kw),
                     vocab_batch_size=V_BATCH)
    hn_params = {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in
                 traverse_util.flatten_dict(jtr.state.params["hypernet"], sep="/").items()}
    sd = invert_llama(flat_bb, tie_word_embeddings=False)
    ttr = Trainer(hn_config=HypernetConfig(**HN),
                  backbone_config=LlamaConfig.from_hf({"model_type": "llama",
                                                       "vocab_size": VOCAB, **BB}),
                  backbone_state=sd, model_type="llama", train_config=TrainingConfig(**kw),
                  device="cpu", hn_params=hn_params)
    return jtr, ttr


def test_untied_llama_train_and_identity_steps_match_jax(monkeypatch):
    """An identity step (in and out tables regressed onto the source's)
    then two train steps (the predicted out table as the head, the
    special-token splice of both tables, the lexical loss on both) from the
    same parameters and batches, f32. Losses within 1e-5 relative; every
    hypernet gradient of the last step within 1e-4 of its leaf's largest
    (or of 1% of the model's largest gradient: sums in another order); the
    backbone's gradients, which the clip norm includes (ROADMAP C.3), within
    2 bf16 ulps (the frozen backbone is held in bf16); the frozen backbone
    and rescalers bitwise unchanged."""
    captured = []
    orig = JaxTrainState.apply_gradients

    def capture(self, *, grads, **kw):
        jax.debug.callback(captured.append, grads)
        return orig(self, grads=grads, **kw)

    monkeypatch.setattr(JaxTrainState, "apply_gradients", capture)
    jtr, ttr = _llama_trainers()
    assert not ttr.out_tied and ttr.source_embeddings.shape == (384, 2 * N_EMBD)
    start = {k: _f32(p).copy() for k, p in ttr.params.items()}
    for kind, batch in [("identity", _batch(10)), ("train", _batch(11)), ("train", _batch(12))]:
        if kind == "identity":
            jtr.state, jm = jtr.identity_train_step(jtr.state, jtr._device_batch(batch))
            tm = ttr.identity_train_step(batch)
            keys = ("identity_loss",)
        else:
            jtr.state, jm = jtr.train_step(jtr.state, jtr._device_batch(batch))
            tm = ttr.train_step(batch)
            keys = ("loss", "lexical_loss", "mean_lexical_overlap")
        for key in keys:
            want = float(jm[key])
            assert abs(tm[key] - want) <= 1e-5 * max(abs(want), 1e-12), (kind, key, tm[key], want)
    jgrads = traverse_util.flatten_dict(captured[-1])
    # Flax kernels are (in, out): the hypernet's nn.Linear weights and the
    # backbone's HF projections are (out, in)
    transposed = {("hypernet",) + p for p, t in flax_paths(ttr.hypernet).values() if t}
    transposed |= {p for p in ttr.params if p[0] == "inner" and p[-1] == "kernel"}
    tgrads = {}
    for path, g in ttr.last_grads.items():
        g = torch.zeros_like(ttr.params[path]) if g is None else g
        tgrads[path] = g.t() if path in transposed else g
    assert set(jgrads) == set(tgrads)
    assert any(path[:2] == ("inner", "lm_head") for path in jgrads)
    floor = 1e-2 * max(float(np.abs(_f32(g)).max()) for g in jgrads.values())
    for path, g in jgrads.items():
        want, got = _f32(g), _f32(tgrads[path])
        rel = 1e-4 if path[0] == "hypernet" else 2 ** -7
        scale = max(float(np.abs(want).max()), floor)
        assert np.abs(got - want).max() <= rel * scale, (path, np.abs(got - want).max(), scale)
    for path, p in ttr.params.items():
        if path[0] == "inner" or path[1] in ("scaler", "in_scaler", "out_scaler"):
            assert np.array_equal(_f32(p), start[path]), path


def test_identity_rows_past_the_source_table_are_clamped():
    """ROADMAP C.7: a converted source tokenizer can hold more tokens than
    the source model has rows (TinyLlama's 32000-row table has no padding
    rows), and the identity step draws its ids from that tokenizer. The
    JAX identity step takes the target rows with jnp.take, which fills ids
    past the table with NaN, so its loss is NaN; its lexical loss's gather
    clamps them to the last row. The port clamps both: its identity loss
    is finite and equals JAX's on the same ids clamped (within 1e-5
    relative, f32)."""
    jtr, ttr = _llama_trainers()
    rows = ttr.source_embeddings.shape[0]
    batch = _batch(20)
    batch["ids_to_embed"][:5] = rows + np.arange(5) * 7  # past the table
    clamped = dict(batch, ids_to_embed=np.minimum(batch["ids_to_embed"], rows - 1))
    # the step donates its state: each call gets a copy
    _, jm = jtr.identity_train_step(jax.tree_util.tree_map(jnp.copy, jtr.state),
                                    jtr._device_batch(batch))
    assert np.isnan(float(jm["identity_loss"]))
    _, jm_clamped = jtr.identity_train_step(jtr.state, jtr._device_batch(clamped))
    tm = ttr.identity_train_step(batch)
    want = float(jm_clamped["identity_loss"])
    assert np.isfinite(tm["identity_loss"])
    assert abs(tm["identity_loss"] - want) <= 1e-5 * abs(want), (tm["identity_loss"], want)
