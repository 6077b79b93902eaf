"""The port's Hypernet at the features of the prior + inter-token-attention
configuration (configs/zeroshot/gpt2_en_priors_inter_token_attn.json: the
prior token, inter-token attention with the prior bias, the residual
LayerNorms either way) and at hidden_act="gelu", held against the JAX
package's Hypernet.apply on the CPU: inference outputs, and the training
route's loss and every parameter gradient at dropout rate 0, from the same
params moved by flax_to_torch and the same numpy-seeded inputs.

Shrunken widths: hidden 128, 2 heads of width 64, 2 layers, 4 inter-token
blocks. At 48 rows the blocks' cross-attention over the rows takes the
merged-head form (8 x 96 merged widths), at 160 rows the per-head form; the
rows' attention over the blocks is per-head at both."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from test_torch_port_hypernet import CONFIG, DTYPES, _inputs, _params
from zett_tpu.models import Hypernet as JaxHypernet
from zett_tpu.models import HypernetConfig as JaxConfig
from zett_tpu_torch.constants import NEGATIVE_INF_FILL_VALUE
from zett_tpu_torch.models import Hypernet, HypernetConfig
from zett_tpu_torch.models.convert import flax_paths, flax_to_torch

PITA = dict(CONFIG, embed_target_priors=True, add_inter_token_attention=True,
            inter_token_attention_bias_by_priors=True, n_inter_token_blocks=4)
VARIANTS = {
    "pita": (PITA, 48),
    "pita_residual_ln": (dict(PITA, inter_token_residual_ln=True,
                              inter_token_attention_bias_scaler=0.5), 160),
    "gelu": (dict(CONFIG, hidden_act="gelu"), 48),
}


def _variant(name, seed=0):
    """Config, surface forms, priors (Unigram log-probs, the padding fill on
    a few rows) and source embeddings."""
    cfg, B = VARIANTS[name]
    sf, src = _inputs(B=B, seed=seed)
    rng = np.random.default_rng(seed + 7)
    priors = (rng.normal(size=B) * 2.0 - 9.0).astype(np.float32)
    priors[-3:] = NEGATIVE_INF_FILL_VALUE  # vocab padding rows
    return cfg, sf, priors, src


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _models(cfg, sf, src, jdt, tdt):
    jmodel = JaxHypernet(JaxConfig(**cfg), dtype=jdt)
    flat = _params(jmodel, sf, src)
    model = Hypernet(HypernetConfig(**cfg), dtype=tdt)
    model.load_state_dict(flax_to_torch({k: np.asarray(v) for k, v in flat.items()}))
    return jmodel, flat, model


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_inference_matches_jax(name, dtype_name):
    """f32: max abs 2e-5 (outputs of magnitude ~4 through the inter-token
    exchange's softmax over every row; sums in another order). bf16: as
    tests/test_torch_port_hypernet.py (XLA rounds every bf16 op, the port
    rounds gelu, LayerNorm and the kernels' fused steps once): max abs
    within 2.5% of the output scale, mean within 0.4%, the bias within
    0.04."""
    jdt, tdt = DTYPES[dtype_name]
    cfg, sf, priors, src = _variant(name)
    jmodel, flat, model = _models(cfg, sf, src, jdt, tdt)
    ref_in, _, ref_bias = jmodel.apply({"params": traverse_util.unflatten_dict(flat, sep="/")},
                                       jnp.asarray(sf), jnp.asarray(priors), jnp.asarray(src), 0)
    with torch.inference_mode():
        got_in, got_out, got_bias = model(torch.from_numpy(sf).long(), torch.from_numpy(priors),
                                          torch.from_numpy(src))
    assert got_out is None and got_in.dtype == tdt and got_in.shape == (len(sf), 64)
    ref_in, ref_bias = _f32(ref_in), _f32(ref_bias)
    err_in = np.abs(_f32(got_in) - ref_in)
    err_bias = np.abs(_f32(got_bias) - ref_bias)
    assert np.isfinite(_f32(got_in)).all()
    if dtype_name == "float32":
        assert err_in.max() <= 2e-5 and err_bias.max() <= 2e-5, (err_in.max(), err_bias.max())
    else:
        scale = np.abs(ref_in).max()
        assert err_in.max() <= 0.025 * scale, (err_in.max(), scale)
        assert err_in.mean() <= 0.004 * scale, (err_in.mean(), scale)
        assert err_bias.max() <= 0.04, err_bias.max()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_training_route_gradients_match_jax(name):
    """The training route (inference=False) at rate 0 gives JAX's loss and
    every parameter gradient, f32, within 2e-5 of each leaf's largest
    gradient (or of 1% of the model's largest, for leaves whose exact
    gradient is 0, such as the key biases)."""
    cfg, sf, priors, src = _variant(name, seed=1)
    jmodel, flat, model = _models(cfg, sf, src, jnp.float32, torch.float32)
    rng = np.random.default_rng(3)
    w_in = rng.normal(size=(len(sf), 64)).astype(np.float32)
    w_b = rng.normal(size=len(sf)).astype(np.float32)

    def jloss(params):
        e, _, b = jmodel.apply({"params": params}, jnp.asarray(sf), jnp.asarray(priors),
                               jnp.asarray(src), 0, deterministic=True, inference=False)
        return (e * w_in).sum() + (b * w_b).sum()

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(traverse_util.unflatten_dict(flat, sep="/"))
    jgrads = traverse_util.flatten_dict(jgrads, sep="/")
    e, _, b = model(torch.from_numpy(sf).long(), torch.from_numpy(priors), torch.from_numpy(src),
                    0, deterministic=True, inference=False)
    got = (e * torch.from_numpy(w_in)).sum() + (b * torch.from_numpy(w_b)).sum()
    got.backward()
    got = float(got.detach())
    assert abs(got - float(want)) <= 1e-5 * abs(float(want)), (got, float(want))
    floor = 1e-2 * max(float(np.abs(_f32(g)).max()) for g in jgrads.values())
    paths = flax_paths(model)
    assert {"/".join(p) for p, _ in paths.values()} == set(jgrads)
    for pname, (path, transpose) in paths.items():
        g = dict(model.named_parameters())[pname].grad
        g = _f32(g.t() if transpose else g)
        want_g = _f32(jgrads["/".join(path)])
        scale = max(float(np.abs(want_g).max()), floor)
        assert np.abs(g - want_g).max() <= 2e-5 * scale, (pname, np.abs(g - want_g).max(), scale)


def test_variant_routes_on_the_inference_path(monkeypatch):
    """Which kernel wrapper each layer calls on the inference route: the
    pita features send every layer to the tier-2 block (never the tier-3
    layer, no CLS-only layer); erf-gelu sends the non-CLS layers to the
    block and the CLS layer to the tier-4 core; the default config keeps
    the tier-3 layer."""
    from zett_tpu_torch.models import hypernet as hn

    calls = []
    for fn in ("attention_block_fused", "attention_core", "encoder_layer"):
        orig = getattr(hn, fn)
        monkeypatch.setattr(hn, fn, lambda *a, _f=orig, _n=fn, **k: (calls.append(_n), _f(*a, **k))[1])
    expected = {
        "pita": ["attention_block_fused"] * 2,
        "gelu": ["attention_block_fused", "attention_core"],
        "default": ["encoder_layer", "attention_core"],
    }
    for name, want in expected.items():
        cfg, sf, priors, src = _variant("gelu" if name == "default" else name)
        if name == "default":
            cfg = CONFIG
        model = Hypernet(HypernetConfig(**cfg))
        model.init_weights(torch.Generator().manual_seed(0))
        calls.clear()
        with torch.inference_mode():
            model(torch.from_numpy(sf).long(), torch.from_numpy(priors), torch.from_numpy(src))
        assert calls == want, (name, calls)


def test_priors_are_required_where_the_config_reads_them():
    cfg, sf, priors, src = _variant("pita")
    model = Hypernet(HypernetConfig(**cfg))
    with pytest.raises(ValueError, match="target_priors"):
        model(torch.from_numpy(sf).long(), None, torch.from_numpy(src))
