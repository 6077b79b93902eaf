"""The port's Hypernet (zett_tpu_torch/models/hypernet.py) held against the
JAX package's Hypernet.apply on the CPU, with the same params moved by
flax_to_torch and the same numpy-seeded surface forms and source embeddings.

The shape is a shrunken configs/zeroshot/gpt2_en.json: hidden 128, 2 heads
of width 64, 2 layers (so both routes run: layer 0 through kernel 1's plain
version, the CLS-only last layer through kernel 2's), source-embedding input
with the fallback table, rescalers and the bias head."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from zett_tpu.models import Hypernet as JaxHypernet
from zett_tpu.models import HypernetConfig as JaxConfig
from zett_tpu_torch.models import Hypernet, HypernetConfig
from zett_tpu_torch.models.convert import flax_to_torch

CONFIG = dict(
    hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
    max_position_embeddings=8, n_embd=64, hn_surface_maxlen=7,
    embed_using_source_embeddings=True, original_vocab_size=300, n_extra_tokens=16,
    rescale_embeddings=True, predict_bias=True,
    hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B=48, L=7, seed=0):
    rng = np.random.default_rng(seed)
    sf = rng.integers(1, 316, size=(B, L)).astype(np.int32)  # ids >= 300 use the fallback
    lens = rng.integers(1, L + 1, size=B)
    sf[np.arange(L)[None] >= lens[:, None]] = 0
    sf[3] = 0  # all-padding rows
    sf[10] = 0
    src = (rng.normal(size=(384, 64)) * 0.05).astype(np.float32)
    return sf, src


def _params(model, sf, src, seed=1):
    """Init the Flax tree, then refill every leaf from a numpy seed so that
    rescalers, LayerNorms and biases are all non-trivial."""
    p = model.init(jax.random.PRNGKey(0), jnp.asarray(sf[:4]), jnp.zeros(4), jnp.asarray(src), 0)
    flat = traverse_util.flatten_dict(p["params"], sep="/")
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith("kernel"):
            x = rng.normal(size=v.shape) / np.sqrt(v.shape[0])
        elif k.endswith("scale") or k.endswith("/w"):
            x = 1.0 + 0.1 * rng.normal(size=v.shape)
        else:
            x = 0.05 * rng.normal(size=v.shape)
        flat[k] = jnp.asarray(x.astype(np.float32), v.dtype)
    return flat


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_hypernet_matches_jax(dtype_name):
    """f32: max abs 1e-5 (outputs of magnitude ~4; sums in another order).
    bf16: XLA rounds every intermediate bf16 op while the port rounds gelu
    and the kernels' fused steps once, so outputs differ by a few bf16 ulps:
    max abs <= 2% of the output scale (5 ulps), mean abs <= 0.3%; the bias
    (|b| < 1) within 0.03 absolute."""
    jdt, tdt = DTYPES[dtype_name]
    sf, src = _inputs()
    jax_model = JaxHypernet(JaxConfig(**CONFIG), dtype=jdt)
    flat = _params(jax_model, sf, src)
    ref_in, ref_out, ref_bias = jax_model.apply(
        {"params": traverse_util.unflatten_dict(flat, sep="/")},
        jnp.asarray(sf), None, jnp.asarray(src), 0,
    )
    model = Hypernet(HypernetConfig(**CONFIG), dtype=tdt)
    model.load_state_dict(flax_to_torch({k: np.asarray(v) for k, v in flat.items()}))
    with torch.inference_mode():
        got_in, got_out, got_bias = model(torch.from_numpy(sf).long(), None,
                                          torch.from_numpy(src))
    assert ref_out is None and got_out is None
    assert got_in.dtype == tdt and got_in.shape == (len(sf), 64)
    ref_in = np.asarray(jnp.asarray(ref_in, jnp.float32))
    ref_bias = np.asarray(jnp.asarray(ref_bias, jnp.float32))
    err_in = np.abs(got_in.float().numpy() - ref_in)
    err_bias = np.abs(got_bias.float().numpy() - ref_bias)
    if dtype_name == "float32":
        assert err_in.max() <= 1e-5 and err_bias.max() <= 1e-5, (err_in.max(), err_bias.max())
    else:
        scale = np.abs(ref_in).max()
        assert err_in.max() <= 0.02 * scale, (err_in.max(), scale)
        assert err_in.mean() <= 0.003 * scale, (err_in.mean(), scale)
        # the bias is one 128-term dot product of bf16-rounded pooled values
        assert err_bias.max() <= 0.03, err_bias.max()


def test_flax_to_torch_covers_every_parameter():
    """Every Flax leaf lands on a port parameter of the same shape and
    dtype, and every port parameter is filled."""
    sf, src = _inputs()
    jax_model = JaxHypernet(JaxConfig(**CONFIG), dtype=jnp.bfloat16)
    flat = _params(jax_model, sf, src)
    sd = flax_to_torch({k: np.asarray(v) for k, v in flat.items()})
    model = Hypernet(HypernetConfig(**CONFIG), dtype=torch.bfloat16)
    own = model.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert v.shape == own[k].shape, k
        assert v.dtype == own[k].dtype, k
    assert sd["scaler.w"].dtype == torch.bfloat16
    assert sd["encoder.position_embeddings"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        sd["encoder.layers.0.attention.query.weight"].numpy(),
        np.asarray(flat["encoder/layer_0/attention/query/kernel"]).T,
    )


@pytest.mark.parametrize("override", [
    {"hidden_size": 384, "num_attention_heads": 2},
    {"hidden_size": 512, "num_attention_heads": 2},
    {"hidden_size": 768, "num_attention_heads": 4, "hidden_act": "gelu"},
    {"hidden_size": 1024, "num_attention_heads": 4, "add_inter_token_attention": True},
    {"hidden_size": 512, "num_attention_heads": 2, "language_adapter_bottleneck_dim": 8},
])
def test_off_route_configs_raise(override):
    """Head widths 192 and 256: the JAX module fuses these layers (any
    multiple of 64), the port's kernels 1 and 4 run 64 and 128 only. The
    configs that raised here before (concat pooling, language adapters, the
    T5 encoder, relative positions, head width 32) run now and are held
    against JAX in tests/test_torch_port_hypernet_variants.py."""
    with pytest.raises(NotImplementedError, match="A.10"):
        Hypernet(HypernetConfig(**{**CONFIG, **override}))
