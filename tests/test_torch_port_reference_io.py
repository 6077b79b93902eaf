"""Reference-format hypernet checkpoints in the port (the reference's HF
save layout: config.json with the hn_* arguments, flax_model.msgpack),
held against the JAX package on the CPU: the port's standard-library
msgpack reader against flax.serialization.msgpack_restore, bit for bit;
convert_reference_hypernet, reference_config_to_ours and
sync_config_to_params against JAX's for nine checkpoint kinds, key for key,
bit for bit and field for field; and load_reference_hypernet on a
directory that flax itself wrote, through the port's Hypernet, against the
JAX Hypernet on what JAX's loader reads.

The reference trees are built here: a JAX Hypernet's parameter shapes
(eval_shape of its init), values from a numpy seed, renamed by inverting
JAX's rename tables, with the tables the reference always allocates (the
token-type table, the one-row word table in source-embedding mode, the
prior projection, the language table, the inter-token blocks). Small
widths: hidden 128, 2 layers, 2 heads."""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization, traverse_util

import zett_tpu.models.reference_io as jref
from zett_tpu.models import Hypernet as JaxHypernet
from zett_tpu.models import HypernetConfig as JaxConfig
from zett_tpu_torch.models import Hypernet, load_reference_hypernet
from zett_tpu_torch.models import reference_io as ref_io
from zett_tpu_torch.models.convert import flax_to_torch
from zett_tpu_torch.models.msgpack_io import msgpack_restore, read_msgpack

H, I, N_EMBD = 128, 256, 64
BASE = {
    "hn_hidden_size": H, "hn_intermediate_size": I, "hn_n_layers": 2,
    "hn_num_attention_heads": 2, "n_embd": N_EMBD, "hn_surface_maxlen": 7,
    "hn_rescale_embeddings": True, "hn_predict_bias": True,
    # the backbone's table sizes, which sync_config_to_params replaces
    "vocab_size": 50257, "max_position_embeddings": 514, "pad_token_id": 0,
    "layer_norm_eps": 1e-5, "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
    "initializer_range": 0.02,
}
SOURCE = {"hn_embed_using_source_embeddings": True, "original_vocab_size": 300,
          "hn_n_extra_tokens": 16}
T5 = {"hn_model_type": "t5", "d_model": H, "d_ff": I, "num_layers": 2, "num_heads": 2,
      "d_kv": H // 2, "layer_norm_epsilon": 1e-6, "dropout_rate": 0.0, **SOURCE}
CASES = {  # name: (reference config.json, leaf dtype)
    "roberta_plain": (dict(BASE, hidden_act="gelu_new"), np.float32),
    "erf_gelu": (dict(BASE, **SOURCE), np.float32),
    "priors": (dict(BASE, **SOURCE, hn_embed_target_priors=True), jnp.bfloat16),
    "inter_token_compat": (dict(BASE, **SOURCE, embed_target_priors=True,
                                add_inter_token_attention=True,
                                inter_token_attention_bias_by_priors=True,
                                inter_token_attention_bias_scaler=0.5, n_inter_token_blocks=4),
                           np.float32),
    "lang_ids": (dict(BASE, **SOURCE, hn_embed_lang_id=True, n_langs=4), np.float32),
    "lang_adapters": (dict(BASE, **SOURCE, hn_language_adapter_bottleneck_dim=8, n_langs=3),
                      np.float32),
    "source_placeholder": (dict(BASE, **SOURCE, hn_embed_lang_id=False,
                                separate_out_embeddings=True), np.float32),
    "t5_relu": (dict(BASE, **T5, feed_forward_proj="relu"), np.float32),
    "t5_gated_gelu": (dict(BASE, **T5, feed_forward_proj="gated-gelu",
                           hn_embed_target_priors=True, hn_add_inter_token_attention=True,
                           hn_n_inter_token_blocks=4), jnp.bfloat16),
}


def _our_tree(ref_config, dtype, seed=0):
    """A JAX Hypernet's parameters ("/"-joined paths) at the config JAX
    reads from ``ref_config``, with the hn encoder's own table sizes."""
    cfg = dataclasses.replace(jref.reference_config_to_ours(ref_config), vocab_size=256,
                              max_position_embeddings=9)
    model = JaxHypernet(cfg)
    n_in = cfg.n_in_embd
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.ones((4, 7), jnp.int32),
                            jnp.zeros(4), jnp.zeros((384, n_in)), jnp.asarray(0))
    flat = traverse_util.flatten_dict(shapes["params"], sep="/")
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        if k.endswith("kernel") or k.endswith("_weights"):
            x = rng.normal(size=v.shape) / np.sqrt(v.shape[-2])
        elif k.endswith("scale") or k.endswith("/w") or k.endswith("/weight"):
            x = 1.0 + 0.1 * rng.normal(size=v.shape)
        else:
            x = 0.05 * rng.normal(size=v.shape)
        out[k] = np.asarray(x.astype(np.float32), dtype)
    return cfg, out


def _reference_tree(cfg, ours, dtype, seed=1):
    """Our flat tree under the reference's names (JAX's rename tables
    inverted), with the placeholder tables the reference always allocates."""
    rng = np.random.default_rng(seed)

    def table(*shape):
        return np.asarray((0.05 * rng.normal(size=shape)).astype(np.float32), dtype)

    t5 = cfg.encoder_type == "t5"
    embed = {v: k for k, v in jref._EMBED_RENAMES.items()}
    layer = {v: k for k, v in (jref._T5_LAYER_RENAMES if t5 else jref._LAYER_RENAMES).items()}
    ref = {}
    for key, value in ours.items():
        path = tuple(key.split("/"))
        if path[0] != "encoder":
            ref[path] = value
        elif t5 and path[1] == "word_embeddings":
            ref[("model", "shared", "embedding")] = value
        elif t5 and path[1] == "prior_projection":
            ref[("model", "encoder", "target_priors_projection") + path[2:]] = value
        elif t5 and path[1] == "final_ln":
            ref[("model", "encoder", "final_layer_norm") + path[2:]] = value
        elif path[1] == "inter_token_blocks":
            ref[("model", "encoder", "block" if t5 else "layer", "inter_token_blocks")] = value
        elif path[1] == "position_embeddings":
            token_type = table(1, H)
            ref[("model", "embeddings", "token_type_embeddings", "embedding")] = token_type
            ref[("model", "embeddings", "position_embeddings", "embedding")] = \
                np.asarray(value.astype(np.float32) - token_type[0].astype(np.float32), dtype)
        elif path in embed:
            ref[("model",) + embed[path]] = value
        elif path[1].startswith("layer_"):
            i = path[1][len("layer_"):]
            if path[2] == "adapter_ln":
                continue  # the reference reuses the output LayerNorm
            for n in range(len(path) - 2, 0, -1):
                if path[2:2 + n] in layer:
                    ref[("model", "encoder", "block" if t5 else "layer", i)
                        + layer[path[2:2 + n]] + path[2 + n:]] = value
                    break
            else:
                raise KeyError(key)
        else:
            raise KeyError(key)
    # the tables the reference allocates whatever the config says
    if t5:
        ref.setdefault(("model", "shared", "embedding"), table(1, H))
        ref.setdefault(("model", "encoder", "target_priors_projection", "kernel"), table(1, H))
        ref.setdefault(("model", "encoder", "target_priors_projection", "bias"), table(H))
        ref.setdefault(("model", "encoder", "block", "inter_token_blocks"), table(4, H))
    else:
        ref.setdefault(("model", "embeddings", "word_embeddings", "embedding"), table(1, H))
        ref.setdefault(("model", "embeddings", "target_priors_projection", "kernel"), table(1, H))
        ref.setdefault(("model", "embeddings", "target_priors_projection", "bias"), table(H))
        ref.setdefault(("model", "embeddings", "lang_embedding", "embedding"), table(1, H))
        ref.setdefault(("model", "encoder", "layer", "inter_token_blocks"), table(4, H))
    return traverse_util.unflatten_dict(ref)


def _bits(v):
    """A leaf's dtype name, shape and bytes (a torch bf16 tensor as numpy
    bf16 would hold it)."""
    if isinstance(v, torch.Tensor):
        assert v.dtype == torch.bfloat16
        return "bfloat16", tuple(v.shape), v.contiguous().view(torch.int16).numpy().tobytes()
    v = np.asarray(v)
    return v.dtype.name, v.shape, v.tobytes()


def _case(name):
    ref_config, dtype = CASES[name]
    cfg, ours = _our_tree(ref_config, dtype)
    return ref_config, dtype, cfg, ours, _reference_tree(cfg, ours, dtype)


def test_msgpack_reader_matches_flax():
    """f32, bf16, int32, int64, f16 and bool leaves, numpy scalars, nested
    maps, lists, strings, ints of every width, floats, None and complex
    numbers: the same tree as flax's msgpack_restore, leaf bytes equal."""
    rng = np.random.default_rng(0)
    tree = {
        "params": {"dense": {"kernel": rng.normal(size=(5, 3)).astype(np.float32),
                             "bias": np.asarray(rng.normal(size=3), jnp.bfloat16)},
                   "ids": np.arange(-3, 300, dtype=np.int32), "mask": rng.random(9) > 0.5,
                   "big": np.arange(5, dtype=np.int64) << 40,
                   "half": rng.normal(size=(2, 2)).astype(np.float16),
                   "empty": np.zeros((0, 4), np.float32),
                   "scalar": np.float32(2.5), "bf16_scalar": np.asarray(1.5, jnp.bfloat16)},
        "step": 7, "neg": -1, "i8": -100, "i16": 40000, "u32": 1 << 31, "i64": -(1 << 40),
        "lr": 1e-3, "name": "z" * 40, "none": None, "flag": True, "list": [1, [2.5, "x"]],
        "complex": 1.5 - 2j, "key" * 20: {},
    }
    data = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(data)
    got = msgpack_restore(data)

    def same(a, b, path):
        if isinstance(a, dict):
            assert isinstance(b, dict) and list(a) == list(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            assert isinstance(b, list) and len(a) == len(b), path
            for x, y in zip(a, b):
                same(x, y, path)
        elif isinstance(a, (np.ndarray, np.generic)):
            assert _bits(a) == _bits(b if isinstance(b, torch.Tensor) else np.asarray(b)), path
            if a.dtype.name != "bfloat16":
                assert type(a) is type(b), path
        else:
            assert type(a) is type(b) and a == b, path

    same(want, got, "")


def test_msgpack_reader_chunked_arrays(monkeypatch, tmp_path):
    """Leaves over flax's MAX_CHUNK_SIZE (lowered to 64 bytes here) are
    written as chunk maps with {"0": ..} shapes; the reader joins them back
    to the arrays flax restores, f32 and bf16, from a file."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"a": {"w": rng.normal(size=(10, 7)).astype(np.float32)},
            "b": np.asarray(rng.normal(size=(3, 33)), jnp.bfloat16),
            "small": np.ones(4, np.float32)}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    path = tmp_path / "flax_model.msgpack"
    path.write_bytes(data)
    want = serialization.msgpack_restore(data)
    got = read_msgpack(str(path))
    assert set(got) == {"a", "b", "small"} and set(got["a"]) == {"w"}
    assert _bits(got["a"]["w"]) == _bits(want["a"]["w"])
    assert _bits(got["b"]) == _bits(want["b"])
    assert _bits(got["small"]) == _bits(want["small"])


@pytest.mark.parametrize("name", list(CASES))
def test_conversion_matches_jax(name):
    """reference_config_to_ours field for field, convert_reference_hypernet
    key for key and bit for bit (bf16 leaves too, the folded position table
    included), sync_config_to_params field for field."""
    ref_config, _, _, _, ref_tree = _case(name)
    want_cfg = jref.reference_config_to_ours(ref_config)
    got_cfg = ref_io.reference_config_to_ours(ref_config)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    tree = ref_tree if name != "lang_ids" else {"params": ref_tree}  # the wrapper is stripped
    want = traverse_util.flatten_dict(jref.convert_reference_hypernet(tree, want_cfg), sep="/")
    got = traverse_util.flatten_dict(ref_io.convert_reference_hypernet(tree, got_cfg), sep="/")
    assert sorted(got) == sorted(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k
    want_synced = jref.sync_config_to_params(want_cfg, jref._unflatten(
        {tuple(k.split("/")): v for k, v in want.items()}))
    got_synced = ref_io.sync_config_to_params(got_cfg, ref_io._unflatten(
        {tuple(k.split("/")): v for k, v in got.items()}))
    assert dataclasses.asdict(got_synced) == dataclasses.asdict(want_synced)


def _sf(n=40, seed=2):
    rng = np.random.default_rng(seed)
    sf = rng.integers(1, 316, size=(n, 7)).astype(np.int32)
    lens = rng.integers(1, 8, size=n)
    sf[np.arange(7)[None] >= lens[:, None]] = 0
    sf[3] = 0
    priors = (rng.normal(size=n) * 2.0 - 9.0).astype(np.float32)
    return sf, priors


@pytest.mark.parametrize("name", ["erf_gelu", "inter_token_compat", "lang_adapters",
                                  "t5_gated_gelu"])
def test_load_reference_hypernet_matches_jax(name, tmp_path):
    """A directory written as the reference writes it (config.json and
    flax_model.msgpack by flax.serialization.to_bytes) through the port's
    load_reference_hypernet, flax_to_torch and Hypernet against JAX's
    loader and Hypernet.apply: (emb_in, emb_out, bias) within 1e-5 of the
    output scale in f32; in bf16 C.6's bound (2% of the scale, mean 0.3%,
    the bias within 0.03), or for the T5 stack (which spreads further in
    bf16, tests/test_torch_port_hypernet_variants.py) 3% and 0.6%."""
    ref_config, _, _, _, ref_tree = _case(name)
    (tmp_path / "config.json").write_text(json.dumps(ref_config))
    (tmp_path / "flax_model.msgpack").write_bytes(serialization.to_bytes(ref_tree))
    want_cfg, want_params = jref.load_reference_hypernet(str(tmp_path))
    cfg, params = load_reference_hypernet(str(tmp_path))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    sf, priors = _sf()
    src = (np.random.default_rng(4).normal(size=(384, cfg.n_in_embd)) * 0.05).astype(np.float32)
    lang = 1 if cfg.language_adapter_bottleneck_dim else 0
    sd = flax_to_torch(params)
    t5 = cfg.encoder_type == "t5"
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jmodel = JaxHypernet(want_cfg, dtype=jdt)
        # each leaf in the dtype the module declares it in
        shapes = traverse_util.flatten_dict(jax.eval_shape(
            jmodel.init, jax.random.PRNGKey(0), jnp.asarray(sf[:4]), jnp.zeros(4),
            jnp.asarray(src), jnp.asarray(0))["params"])
        jparams = traverse_util.unflatten_dict(
            {k: jnp.asarray(v, shapes[k].dtype)
             for k, v in traverse_util.flatten_dict(want_params).items()})
        refs = jax.jit(jmodel.apply)({"params": jparams}, jnp.asarray(sf), jnp.asarray(priors),
                                     jnp.asarray(src), jnp.asarray(lang))
        model = Hypernet(cfg, dtype=tdt)
        own = model.state_dict()
        model.load_state_dict({k: v.to(own[k].dtype) for k, v in sd.items()})
        with torch.inference_mode():
            gots = model(torch.from_numpy(sf).long(), torch.from_numpy(priors),
                         torch.from_numpy(src), lang)
        for what, got, ref in zip(("in", "out", "bias"), gots, refs):
            if ref is None:
                assert got is None, what
                continue
            got = got.float().numpy()
            ref = np.asarray(jnp.asarray(ref, jnp.float32))
            assert got.shape == ref.shape and np.isfinite(got).all(), what
            err = np.abs(got - ref)
            scale = max(float(np.abs(ref).max()), 1.0)
            if jdt == jnp.float32:
                assert err.max() <= 1e-5 * scale, (what, err.max(), scale)
            elif t5:
                assert err.max() <= 0.03 * scale and err.mean() <= 0.006 * scale, (what, err.max())
            elif what == "bias":
                assert err.max() <= 0.03, err.max()
            else:
                assert err.max() <= 0.02 * scale and err.mean() <= 0.003 * scale, \
                    (what, err.max(), err.mean(), scale)
