"""The hypernet variants that reference-format checkpoints and the JAX
configs express, held against the JAX package's Hypernet.apply on the CPU
with the same params moved by flax_to_torch and the same numpy-seeded
inputs: per-language bottleneck adapters (after kernel 1's layer under
gelu_new, after the unfused layer under erf-gelu, at language 0 and past
it), relative positions (the merged-head and the per-head form), concat
pooling, the T5-compat encoder (relu, and gated-gelu with the prior token
and the inter-token exchange), and a head width of 32 (the plain route).
Inference outputs, and the training route's loss and every parameter
gradient at dropout rate 0; which kernel wrappers each layer calls; the
relative-position buckets; concat pooling through transfer(), and where
the JAX module's concat pooling fails (ROADMAP C.21).

Shrunken widths: hidden 128 (256 for the per-head form), 2 layers, 2-4
heads, surface forms of 7 (65 for the per-head form, 1 for concat)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from test_torch_port_hypernet import CONFIG, DTYPES, _inputs
from test_torch_port_transfer import N_EMBD, TOK, _config
from zett_tpu.models import Hypernet as JaxHypernet
from zett_tpu.models import HypernetConfig as JaxConfig
from zett_tpu.models.hypernet import _relative_position_bucket
from zett_tpu.models.hypernet_t5 import _t5_relative_position_bucket
from zett_tpu.tokenization import Tokenizer as JaxTokenizer
from zett_tpu.transfer import transfer as jax_transfer
from zett_tpu_torch.constants import NEGATIVE_INF_FILL_VALUE
from zett_tpu_torch.models import Hypernet, HypernetConfig
from zett_tpu_torch.models.convert import flax_paths, flax_to_torch
from zett_tpu_torch.models.hypernet import relative_position_bucket
from zett_tpu_torch.tokenization import Tokenizer
from zett_tpu_torch.transfer import transfer

ADAPTERS = dict(CONFIG, language_adapter_bottleneck_dim=16, n_langs=3)
T5 = dict(CONFIG, encoder_type="t5", layer_norm_eps=1e-6)
VARIANTS = {  # name: (config, rows, surface-form length)
    "adapters": (ADAPTERS, 48, 7),
    "adapters_gelu_lang_id": (dict(ADAPTERS, hidden_act="gelu", embed_lang_id=True), 48, 7),
    "relative": (dict(CONFIG, position_embedding_type="relative", embed_target_priors=True),
                 48, 7),
    "relative_per_head": (dict(CONFIG, hidden_size=256, num_attention_heads=4,
                               position_embedding_type="relative"), 16, 65),
    "concat": (dict(CONFIG, concat_last_hidden_state=True, hn_surface_maxlen=1), 48, 1),
    "t5_relu": (dict(T5, hidden_act="relu"), 48, 7),
    "t5_gated_gelu": (dict(T5, hidden_act="gated-gelu", embed_target_priors=True,
                           add_inter_token_attention=True, n_inter_token_blocks=4,
                           inter_token_attention_bias_by_priors=True), 48, 7),
    "head_width_32": (dict(CONFIG, num_attention_heads=4), 48, 7),
}
CASES = [(name, 0) for name in VARIANTS] + [("adapters", 2), ("adapters_gelu_lang_id", 1)]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _variant(name, seed=0):
    """Config, surface forms, priors (a few at the padding fill) and source
    embeddings."""
    cfg, B, L = VARIANTS[name]
    sf, src = _inputs(B=B, L=L, seed=seed)
    rng = np.random.default_rng(seed + 7)
    priors = (rng.normal(size=B) * 2.0 - 9.0).astype(np.float32)
    priors[-3:] = NEGATIVE_INF_FILL_VALUE
    return cfg, sf, priors, src


def _params(model, sf, src, seed=1):
    """The Flax tree's shapes and dtypes (``eval_shape`` of the init, which
    compiles nothing), every leaf drawn from a numpy seed: kernels at
    1/sqrt(fan_in), LayerNorm and RMS-norm scales and rescaler weights near
    1, the relative-position tables at 0.5, the rest at 0.05."""
    p = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(sf[:4]), jnp.zeros(4),
                       jnp.asarray(src), jnp.asarray(0))
    flat = traverse_util.flatten_dict(p["params"], sep="/")
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith("kernel") or k.endswith("_weights"):
            x = rng.normal(size=v.shape) / np.sqrt(v.shape[-2])
        elif k.endswith("scale") or k.endswith("/w") or k.endswith("_ln/weight") \
                or k.endswith("ln1/weight") or k.endswith("ln2/weight"):
            x = 1.0 + 0.1 * rng.normal(size=v.shape)
        elif "relative_attention_bias" in k:
            x = 0.5 * rng.normal(size=v.shape)
        else:
            x = 0.05 * rng.normal(size=v.shape)
        flat[k] = jnp.asarray(x.astype(np.float32), v.dtype)
    return flat


@functools.lru_cache(maxsize=None)
def _tree(name, dtype_name):
    """The JAX module of a variant and its seeded parameters (one trace of
    its init a variant and dtype)."""
    cfg, sf, _, src = _variant(name)
    jmodel = JaxHypernet(JaxConfig(**cfg), dtype=DTYPES[dtype_name][0])
    return jmodel, _params(jmodel, sf, src)


def _models(name, dtype_name):
    """(JAX module, its parameters, the port's Hypernet holding them)."""
    cfg = VARIANTS[name][0]
    jmodel, flat = _tree(name, dtype_name)
    model = Hypernet(HypernetConfig(**cfg), dtype=DTYPES[dtype_name][1])
    model.load_state_dict(flax_to_torch({k: np.asarray(v) for k, v in flat.items()}))
    return jmodel, flat, model


_JITTED = {}  # (variant, dtype) -> the JAX module's params and jitted function


def _weights(B):
    rng = np.random.default_rng(3)
    return rng.normal(size=(B, 64)).astype(np.float32), rng.normal(size=B).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_run(name, dtype_name, lang):
    """JAX's emb_in and bias (f32 numpy) and, in f32, the training loss
    (sum(emb_in * w_in) + sum(bias * w_b)) with every parameter gradient:
    one jitted function a variant and dtype, the language id an argument
    of it. In f32 the outputs come from the training-route forward
    (``inference=False``, deterministic): on the CPU the JAX module's two
    routes run the same XLA ops (its Pallas kernels are the TPU's)."""
    cfg, sf, priors, src = _variant(name)
    args = (jnp.asarray(sf), jnp.asarray(priors), jnp.asarray(src))
    if (name, dtype_name) not in _JITTED:
        jmodel, flat = _tree(name, dtype_name)
        params = traverse_util.unflatten_dict(flat, sep="/")
        if dtype_name == "bfloat16":
            fn = jax.jit(lambda p, li: jmodel.apply({"params": p}, *args, li))
        else:
            w_in, w_b = _weights(len(sf))

            def loss(p, li):
                e, _, b = jmodel.apply({"params": p}, *args, li, deterministic=True,
                                       inference=False)
                return (e * w_in).sum() + (b * w_b).sum(), (e, b)

            fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
        _JITTED[name, dtype_name] = (params, fn)
    params, fn = _JITTED[name, dtype_name]
    out = fn(params, jnp.asarray(lang))
    if dtype_name == "bfloat16":
        return _f32(out[0]), _f32(out[2])
    (value, (e, b)), grads = out
    return _f32(e), _f32(b), float(value), traverse_util.flatten_dict(grads, sep="/")


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,lang", CASES)
def test_variant_inference_matches_jax(name, lang, dtype_name):
    """f32: max abs within 1e-5 of the output scale (sums in another
    order). bf16: C.6's bound, max abs within 2% of the output scale and
    mean within 0.3%, the bias within 0.03 (XLA rounds every bf16 op, the
    port rounds gelu, LayerNorm and the kernels' fused steps once). The T5
    stack (pre-LN, unscaled scores, the prior token's 3.6e3-wide input on
    padding rows) spreads further in bf16: JAX's own bf16 run is 2.4-2.9%
    of the scale off its f32 run, so there both outputs are held within 3%
    of the scale (mean 0.6%) of JAX's bf16 run, and the port's mean
    distance to the f32 run within 1.5x JAX's own."""
    tdt = DTYPES[dtype_name][1]
    cfg, sf, priors, src = _variant(name)
    _, _, model = _models(name, dtype_name)
    refs = _jax_run(name, dtype_name, lang)[:2]
    with torch.inference_mode():
        gots = model(torch.from_numpy(sf).long(), torch.from_numpy(priors),
                     torch.from_numpy(src), lang)
    assert gots[1] is None
    assert gots[0].dtype == tdt and gots[0].shape == (len(sf), 64)
    t5 = cfg.get("encoder_type") == "t5"
    for what, got, ref, truth in zip(("in", "bias"), (gots[0], gots[2]), refs,
                                     _jax_run(name, "float32", lang)):
        got = _f32(got)
        assert np.isfinite(got).all(), what
        err = np.abs(got - ref)
        scale = max(float(np.abs(ref).max()), 1.0)
        if dtype_name == "float32":
            assert err.max() <= 1e-5 * scale, (what, err.max(), scale)
        elif t5:
            own = np.abs(ref - truth).mean()
            assert np.abs(got - truth).mean() <= 1.5 * own, (what, np.abs(got - truth).mean(), own)
            assert err.max() <= 0.03 * scale and err.mean() <= 0.006 * scale, (what, err.max())
        elif what == "bias":
            assert err.max() <= 0.03, err.max()
        else:
            assert err.max() <= 0.02 * scale, (err.max(), scale)
            assert err.mean() <= 0.003 * scale, (err.mean(), scale)


@pytest.mark.parametrize("name,lang", CASES)
def test_variant_training_route_gradients_match_jax(name, lang):
    """The training route (inference=False) at rate 0 gives JAX's loss and
    every parameter gradient, f32, within 1e-5 of the loss and of each
    leaf's largest gradient (or of 1% of the model's largest, for leaves
    whose exact gradient is 0, such as the key biases). The T5 stack's
    gradients within 2e-5: its unscaled scores put JAX's own f32 gradient
    of layer 0's q kernel 8.3e-6 of its scale off an f64 run of the same
    module, so two f32 runs agree to about twice that."""
    cfg, sf, priors, src = _variant(name)
    _, _, model = _models(name, "float32")
    w_in, w_b = _weights(len(sf))
    _, _, want, jgrads = _jax_run(name, "float32", lang)
    e, _, b = model(torch.from_numpy(sf).long(), torch.from_numpy(priors), torch.from_numpy(src),
                    lang, deterministic=True, inference=False)
    got = (e * torch.from_numpy(w_in)).sum() + (b * torch.from_numpy(w_b)).sum()
    got.backward()
    got = float(got.detach())
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    floor = 1e-2 * max(float(np.abs(_f32(g)).max()) for g in jgrads.values())
    tol = 2e-5 if cfg.get("encoder_type") == "t5" else 1e-5
    paths = flax_paths(model)
    assert {"/".join(p) for p, _ in paths.values()} == set(jgrads)
    params = dict(model.named_parameters())
    for pname, (path, transpose) in paths.items():
        g = params[pname].grad
        g = _f32(g.t() if transpose else g)
        want_g = _f32(jgrads["/".join(path)])
        scale = max(float(np.abs(want_g).max()), floor)
        assert np.abs(g - want_g).max() <= tol * scale, (pname, np.abs(g - want_g).max(), scale)


def test_variant_routes_on_the_inference_path(monkeypatch):
    """Which kernel wrapper each layer calls on the inference route, as the
    JAX module routes its Pallas kernels: the adapters follow kernel 1's
    layer under gelu_new and kernel 4's block under erf-gelu (the CLS layer
    through kernel 2); relative positions, the T5 encoder and head width 32
    take no kernel; concat pooling runs kernel 1 on every layer (no CLS-only
    layer)."""
    from zett_tpu_torch.models import hypernet as hn

    calls = []
    for fn in ("attention_block_fused", "attention_core", "encoder_layer"):
        orig = getattr(hn, fn)
        monkeypatch.setattr(hn, fn,
                            lambda *a, _f=orig, _n=fn, **k: (calls.append(_n), _f(*a, **k))[1])
    expected = {
        "adapters": ["encoder_layer", "attention_core"],
        "adapters_gelu_lang_id": ["attention_block_fused", "attention_core"],
        "relative": [], "relative_per_head": [], "t5_relu": [], "t5_gated_gelu": [],
        "head_width_32": [],
        "concat": ["encoder_layer", "encoder_layer"],
    }
    assert set(expected) == set(VARIANTS)
    for name, want in expected.items():
        cfg, sf, priors, src = _variant(name)
        model = Hypernet(HypernetConfig(**cfg))
        model.init_weights(torch.Generator().manual_seed(0))
        calls.clear()
        with torch.inference_mode():
            out = model(torch.from_numpy(sf).long(), torch.from_numpy(priors),
                        torch.from_numpy(src), 1)
        assert calls == want, (name, calls)
        assert all(o is None or bool(torch.isfinite(o).all()) for o in out), name


def test_relative_position_buckets_match_jax():
    """Both bucketings (the roberta encoder's with its epsilon, HF T5's
    without) equal JAX's at every offset of rows up to 160 positions, at
    the default buckets and a smaller table."""
    offsets = np.arange(-160, 161)
    for nb, md in ((32, 128), (16, 32)):
        want = np.asarray(_relative_position_bucket(jnp.asarray(offsets), nb, md))
        got = relative_position_bucket(torch.from_numpy(offsets), nb, md).numpy()
        np.testing.assert_array_equal(got, want)
        want = np.asarray(_t5_relative_position_bucket(jnp.asarray(offsets), nb, md))
        got = relative_position_bucket(torch.from_numpy(offsets), nb, md, eps=0.0).numpy()
        np.testing.assert_array_equal(got, want)


def test_concat_pooling_past_one_position_fails_as_in_jax():
    """ROADMAP C.21: the JAX module's output heads add a (rows, H) residual
    to the pooled (rows, L * H) row and fail at any L > 1; the port raises
    a ValueError naming C.21 where JAX raises."""
    cfg = dict(CONFIG, concat_last_hidden_state=True)
    sf, src = _inputs(B=16, L=7)
    with pytest.raises(TypeError, match="broadcast"):
        jax.eval_shape(JaxHypernet(JaxConfig(**cfg)).init, jax.random.PRNGKey(0),
                       jnp.asarray(sf), None, jnp.asarray(src), 0)
    model = Hypernet(HypernetConfig(**cfg))
    model.init_weights(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="C.21"):
        model(torch.from_numpy(sf).long(), None, torch.from_numpy(src))


def test_transfer_with_concat_pooling_matches_jax():
    """transfer() with concat pooling (surface forms of one position; no
    length buckets) over de_raw's 7580 pieces from a gpt2_raw source: emb_in
    and bias within 1e-5 of JAX's, the converted tokenizer identical."""
    vocab = len(Tokenizer.from_file(TOK.format("gpt2_raw")))
    src = (np.random.default_rng(0).normal(size=(vocab, N_EMBD)) * 0.05).astype(np.float32)
    cfg = dict(_config(vocab), concat_last_hidden_state=True, hn_surface_maxlen=1)
    jmodel = JaxHypernet(JaxConfig(**cfg))
    flat = _params(jmodel, np.ones((4, 1), np.int32), src)
    flat = {k: np.asarray(v) for k, v in flat.items()}
    model = Hypernet(HypernetConfig(**cfg))
    model.load_state_dict(flax_to_torch(flat))
    common = dict(source_embeddings_in=src, lang_index=0, batch_size=4096, seed=3)
    ref_in, _, ref_bias, ref_tok = jax_transfer(
        hypernet=jmodel, hn_params=traverse_util.unflatten_dict(flat, sep="/"),
        hn_tokenizer=JaxTokenizer.from_file(TOK.format("gpt2_raw")),
        source_tokenizer=JaxTokenizer.from_file(TOK.format("gpt2_raw")),
        target_tokenizer=JaxTokenizer.from_file(TOK.format("de_raw")), **common)
    got_in, _, got_bias, got_tok = transfer(
        hypernet=model, hn_tokenizer=Tokenizer.from_file(TOK.format("gpt2_raw")),
        source_tokenizer=Tokenizer.from_file(TOK.format("gpt2_raw")),
        target_tokenizer=Tokenizer.from_file(TOK.format("de_raw")), **common)
    assert got_tok.to_str() == ref_tok.to_str()
    assert got_in.shape == ref_in.shape == (len(got_tok), N_EMBD)
    scale = max(float(np.abs(ref_in).max()), 1.0)
    assert np.abs(got_in - ref_in).max() <= 1e-5 * scale
    assert np.abs(got_bias - ref_bias).max() <= 1e-5 * scale


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_init_weights_writes_every_parameter(name):
    """The trainer builds its hypernet on the meta device and lets
    init_weights write every value: that hypernet equals one built with
    torch's default init and then drawn by init_weights, bit for bit."""
    cfg = HypernetConfig(**VARIANTS[name][0])
    drawn = Hypernet(cfg)
    drawn.init_weights(torch.Generator().manual_seed(3))
    with torch.device("meta"):
        empty = Hypernet(cfg)
    empty.to_empty(device="cpu")
    with torch.no_grad():
        for p in empty.parameters():
            p.fill_(float("nan"))
    empty.init_weights(torch.Generator().manual_seed(3))
    want, got = drawn.state_dict(), empty.state_dict()
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(got[key], value), key
