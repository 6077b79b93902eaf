"""32 heads in the port (Mistral-7B's hypernets: 32 heads of 128): the plain
versions of kernels 1, 2 and 3 held against the JAX package's Pallas
kernels in interpret mode and its differentiable reference at 32 heads of
64 and of 128, the plans and limits of the bf16 wrappers at Mistral's
hypernet widths, and the Hypernet at 32 heads on both sides of the
merged/per-head boundary (L*h = 256 and 288) against the JAX Hypernet. The
same numpy-seeded inputs go through both sides; the CUDA kernels at 32
heads run only on the card (chip_smoke.py phase 15).

At dropout rate 0.1 the Pallas kernel draws the TPU's own random bits,
which interpret mode on the CPU cannot run; there the reference is the
JAX package's differentiable fallback (``_core_train_fallback``), and its
``jax.random.bernoulli`` keep mask is handed to the plain versions in
place of their Philox mask, so both sides drop the same weights."""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from zett_tpu.models import Hypernet as JaxHypernet
from zett_tpu.models import HypernetConfig as JaxConfig
from zett_tpu.ops.pallas_attention import (
    _core_train_bwd_pallas,
    _core_train_fallback,
    _core_train_fwd_pallas,
    encoder_layer_pallas,
    encoder_layer_reference,
)
from zett_tpu_torch.models import Hypernet, HypernetConfig
from zett_tpu_torch.models.convert import flax_to_torch
from zett_tpu_torch.models.hypernet import MERGED_ATTENTION_MAX
from zett_tpu_torch.ops.attention_core import (
    MAX_HEADS_BF16,
    attention_core_bwd_reference,
    attention_core_reference,
    check_heads,
    check_row_fits,
)
from zett_tpu_torch.ops.encoder_layer import FUSED_MAX_HEADS, encoder_layer, layer_plan

# the module (the package's ``attention_core`` is the wrapper function)
core = importlib.import_module("zett_tpu_torch.ops.attention_core")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, h = 4, 32
BF, F32 = torch.bfloat16, torch.float32


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(dtype_name, ref):
    """f32: 1e-5 of the output scale (sums in another order). bf16: 2 ulps
    of the largest magnitude (an f32 sum in another order can round an
    intermediate the other way)."""
    scale = max(float(np.abs(ref).max()), 1.0)
    return 1e-5 * scale if dtype_name == "float32" else 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)


def _key_mask(rng, L):
    mask = rng.random((B, L)) > 0.3
    mask[:, 0] = True
    mask[1] = False  # an all-padding surface form
    return mask


def _core_inputs(dtype_name, L, d, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, L * h, d)).astype(np.float32) for _ in range(4)]
    mask = _key_mask(rng, L)
    kmaskf = np.repeat(mask, h, axis=-1).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    jx = [jnp.asarray(a, jdt) for a in arrs] + [jnp.asarray(kmaskf)]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs] + [torch.from_numpy(kmaskf)]
    return jx, tx, mask


def _fallback_keep(jx, seed, rate):
    """The fallback's keep mask (pallas_attention.py _core_train_fallback):
    bernoulli(fold_in(PRNGKey(0), seed), 1 - rate) over (B, Lq*h, Lk*h)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), seed.astype(jnp.uint32))
    shape = (jx[0].shape[0], jx[0].shape[1], jx[1].shape[1])
    return torch.from_numpy(np.array(jax.random.bernoulli(key, 1.0 - rate, shape)))


@pytest.fixture
def shared_mask(monkeypatch):
    """Hands a given keep mask to the plain versions in place of Philox."""
    def use(keep):
        monkeypatch.setattr(core, "keep_mask", lambda *a, **k: keep)
    return use


CORE_CASES = [(d, L, rate) for d in (64, 128) for L in (7, 8) for rate in (0.0, 0.1)]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,L,rate", CORE_CASES)
def test_attention_core_plain_at_32_heads_matches_jax(dtype_name, d, L, rate, shared_mask):
    """Kernel 2's plain version at 32 heads (merged widths 224 and 256) vs
    _core_train_fwd_pallas(interpret=True) at rate 0 and the fallback
    reference at both rates, an all-padding row included (its weights are
    uniform over every head's keys); tolerance as ``_tol``."""
    jx, tx, _ = _core_inputs(dtype_name, L, d, seed=d + L)
    seed = jnp.asarray(5, jnp.int32)
    if rate:
        shared_mask(_fallback_keep(jx, seed, rate))
    got = _f32(attention_core_reference(*tx[:3], tx[4], h, rate, 5))
    ref = _f32(_core_train_fallback(*jx[:3], jx[4], seed, h, rate))
    assert got.shape == (B, L * h, d) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= _tol(dtype_name, ref), np.abs(got - ref).max()
    if not rate:
        pal = _f32(_core_train_fwd_pallas(*jx[:3], jx[4], seed, h, 0.0, interpret=True))
        assert np.abs(got - pal).max() <= _tol(dtype_name, pal), np.abs(got - pal).max()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,L,rate", CORE_CASES)
def test_attention_core_bwd_plain_at_32_heads_matches_jax(dtype_name, d, L, rate,
                                                          shared_mask):
    """Kernel 3's plain version at 32 heads vs jax.vjp of the differentiable
    fallback on every row (all-padding rows: dq = dk = 0, dv sums every
    query head's dout) and, at rate 0, vs the Pallas backward kernel in
    interpret mode on the rows with a valid key (the TPU kernel omits the
    select's gradient on all-padding rows, ROADMAP C.4)."""
    jx, tx, mask = _core_inputs(dtype_name, L, d, seed=100 + d + L)
    jq, jk, jv, jg, jm = jx
    tq, tk, tv, tg, tm = tx
    seed = jnp.asarray(9, jnp.int32)
    if rate:
        shared_mask(_fallback_keep(jx, seed, rate))
    got = attention_core_bwd_reference(tq, tk, tv, tm, tg, h, rate, 9)
    _, vjp = jax.vjp(lambda q, k, v: _core_train_fallback(q, k, v, jm, seed, h, rate),
                     jq, jk, jv)
    fallback = vjp(jg)
    pallas = (_core_train_bwd_pallas(jq, jk, jv, jm, seed, jg, h, 0.0, interpret=True)
              if not rate else fallback)
    rows = mask.any(1)
    for name, g, p, f in zip(("dq", "dk", "dv"), got, pallas, fallback):
        g, p, f = _f32(g), _f32(p), _f32(f)
        tol = _tol(dtype_name, f)
        assert np.abs(g - f).max() <= tol, (name, np.abs(g - f).max(), tol)
        assert np.abs(g[rows] - p[rows]).max() <= tol, (name, np.abs(g[rows] - p[rows]).max())
    assert not rows.all()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_encoder_layer_plain_at_32_heads_of_64_matches_jax(dtype_name):
    """Kernel 1's plain version at 32 heads of 64 (H 2048, a small I 256, L
    7) vs encoder_layer_reference (all rows) and encoder_layer_pallas
    (interpret mode, rows with a valid key: the Pallas kernel pads L to 8
    with masked positions, so its all-padding rows average the padding too,
    ROADMAP C.5). Tolerances: f32 1e-5 absolute (LayerNormed outputs, sums
    in another order); bf16 one ulp at the output scale (2^-8 x 8), since
    XLA rounds every intermediate bf16 op where the port rounds once."""
    L, d, I = 7, 64, 256
    H = h * d
    rng = np.random.default_rng(32)
    jdt, tdt = DTYPES[dtype_name]

    def pair(a):
        a = np.asarray(a, np.float32)
        return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)

    x = pair(rng.normal(size=(B, L, H)))
    mask = _key_mask(rng, L)
    mats = [pair(rng.normal(size=s) * 0.02) for s in [(H, H)] * 4 + [(H, I), (I, H)]]
    vecs = [pair(rng.normal(size=s) * 0.02) for s in [(H,)] * 4 + [(I,), (H,)]]
    lns = [np.asarray(1.0 + 0.1 * rng.normal(size=H), np.float32),
           np.asarray(0.1 * rng.normal(size=H), np.float32)]

    def args(side, to_mask, to_ln):
        w = [m[side] for m in mats]
        b = [v[side] for v in vecs]
        ln = [to_ln(v) for v in lns]
        return (x[side], to_mask(mask), w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3],
                ln[0], ln[1], w[4], b[4], w[5], b[5], ln[0], ln[1])

    jargs = args(0, jnp.asarray, jnp.asarray)
    targs = args(1, torch.from_numpy, torch.from_numpy)
    got = _f32(encoder_layer(*targs, num_heads=h, eps=1e-5))
    ref = _f32(encoder_layer_reference(*jargs, h, 1e-5, True))
    pal = _f32(encoder_layer_pallas(*jargs, num_heads=h, eps=1e-5, approximate_gelu=True,
                                    tile_b=2, interpret=True))
    tol = 1e-5 if dtype_name == "float32" else 0.03125
    live = mask.any(axis=1)
    assert np.isfinite(got).all() and not live.all()
    assert np.abs(got - ref).max() <= tol, np.abs(got - ref).max()
    assert np.abs(got[live] - pal[live]).max() <= tol, np.abs(got[live] - pal[live]).max()


# ---------------------------------------------------------------- the plans
@pytest.mark.parametrize("L", [7, 8])
def test_layer_plan_at_mistral_widths(L):
    """Mistral-7B's hypernet (H 4096, 32 heads of 128, I 8192) at L 7 (a
    surface form) and 8 (with the language-id token): kernel 1's
    seven-launch route, in bf16 and in f32."""
    for dtype in (BF, F32):
        plan = layer_plan(dtype, L, 4096, 32, 8192)
        assert (plan.route, plan.launches, plan.cluster) == ("unfused", 7, 0)


@pytest.mark.parametrize("heads", [17, 24, 32])
def test_layer_plan_routes_past_16_heads_of_64_by_name(heads):
    """The fused four-launch route takes at most 16 heads of 64 (its
    LayerNorm cluster would be over the portable 8 CTAs past that): wider
    layers get the route named "unfused", never the fused one; 16 heads
    keep it."""
    assert FUSED_MAX_HEADS == 16
    plan = layer_plan(BF, 8, 64 * heads, heads, 1024)
    assert (plan.route, plan.launches, plan.cluster, plan.tile_rows) == ("unfused", 7, 0, 0)
    assert layer_plan(BF, 8, 64 * 16, 16, 1024).route == "fused"


def test_head_limit_is_32_and_33_is_refused_by_name():
    """check_heads (kernels 1 to 5) takes 32 bf16 heads and refuses 33 with
    the limit in its message; f32 (the scalar path) has no head limit."""
    assert MAX_HEADS_BF16 == 32
    for what in ("attention_core", "attention_block", "merged_attention", "encoder_layer"):
        check_heads(what, BF, 32)
        with pytest.raises(ValueError, match=f"{what}: 33 heads; the bf16 kernel takes at most 32"):
            check_heads(what, BF, 33)
    check_heads("attention_core", F32, 64)
    with pytest.raises(ValueError, match="at most 32"):
        layer_plan(BF, 7, 128 * 33, 33, 8192)


def test_past_16_heads_rows_take_at_most_16_queries():
    """Past 16 heads the bf16 core runs one m16 query tile: 16 query
    positions pass, 17 are refused by name (a merged width over 256, which
    the hypernet runs per head); 16 heads keep 32 positions."""
    check_heads("attention_core", BF, 17, 16)
    with pytest.raises(ValueError, match="past 16 heads the bf16 kernel takes at most 16 query"):
        check_heads("attention_core", BF, 17, 17)
    with pytest.raises(ValueError, match="17 query positions"):
        layer_plan(BF, 17, 64 * 20, 20, 1024)
    check_heads("attention_core", BF, 16, 32)
    check_heads("attention_core", F32, 32, 32)


def test_row_fits_at_32_heads():
    """A row of 32 heads of 128 fits the core's shared memory at L 8
    (213,632 of 232,448 bytes, one buffer) and not at L 9; 32 heads of 64
    fit up to L 18."""
    check_row_fits("attention_core", BF, 8, 8, 32, 128)
    check_row_fits("attention_core", BF, 1, 8, 32, 128)
    with pytest.raises(ValueError, match="shared memory"):
        check_row_fits("attention_core", BF, 9, 9, 32, 128)
    check_row_fits("attention_block", BF, 18, 18, 32, 64)
    with pytest.raises(ValueError, match="shared memory"):
        check_row_fits("attention_block", BF, 19, 19, 32, 64)
    check_row_fits("attention_core", F32, 32, 32, 32, 128)  # f32 stages per warp


# ------------------------------------------------------------ the hypernet
def _hn_config(maxlen):
    return dict(
        hidden_size=h * 64, intermediate_size=256, num_hidden_layers=2, num_attention_heads=h,
        max_position_embeddings=10, n_embd=32, hn_surface_maxlen=maxlen,
        embed_using_source_embeddings=True, original_vocab_size=300, n_extra_tokens=16,
        rescale_embeddings=True, predict_bias=True, separate_out_embeddings=True,
        hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
    )


def _hn_params(cfg, sf, src, seed=1):
    model = JaxHypernet(JaxConfig(**cfg))
    p = model.init(jax.random.PRNGKey(0), jnp.asarray(sf[:2]), jnp.zeros(2), jnp.asarray(src), 0)
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


def _hn_inputs(maxlen, n=12, seed=0):
    rng = np.random.default_rng(seed)
    sf = rng.integers(1, 316, size=(n, maxlen)).astype(np.int32)  # >= 300: the fallback
    lens = rng.integers(1, maxlen + 1, size=n)
    lens[0] = maxlen
    sf[np.arange(maxlen)[None] >= lens[:, None]] = 0
    sf[3] = 0  # an all-padding row
    src = (rng.normal(size=(384, 64)) * 0.05).astype(np.float32)  # [in | out]
    return sf, src


@pytest.mark.parametrize("route", ["inference", "training"])
@pytest.mark.parametrize("maxlen", [8, 9])
def test_hypernet_at_32_heads_matches_jax_across_the_merged_boundary(maxlen, route):
    """The Hypernet with 32 heads of 64 (H 2048), f32, on 12 rows with an
    all-padding one: at maxlen 8 (L*h = 256) its layers take the merged
    routes (kernel 1 and kernel 2's plain versions for inference, the
    tier-4 core for training); at 9 (288) every layer takes the per-head
    plain route, as the JAX module's ``_attention`` does, where an
    all-padding row averages its own head's values. Max abs 1e-5 of the
    outputs' scale (sums in another order)."""
    cfg = _hn_config(maxlen)
    sf, src = _hn_inputs(maxlen)
    assert (maxlen * h > MERGED_ATTENTION_MAX) == (maxlen == 9)
    flat = _hn_params(cfg, sf, src)
    inference = route == "inference"
    refs = JaxHypernet(JaxConfig(**cfg)).apply(
        {"params": traverse_util.unflatten_dict(flat, sep="/")}, jnp.asarray(sf), None,
        jnp.asarray(src), 0, inference=inference)
    model = Hypernet(HypernetConfig(**cfg))
    model.load_state_dict(flax_to_torch(flat))
    with torch.no_grad():
        gots = model(torch.from_numpy(sf).long(), None, torch.from_numpy(src), 0,
                     inference=inference)
    for name, got, ref in zip(("in", "out", "bias"), gots, refs):
        got, ref = _f32(got), _f32(ref)
        assert got.shape == ref.shape, name
        scale = max(float(np.abs(ref).max()), 1.0)
        assert np.abs(got - ref).max() <= 1e-5 * scale, (name, np.abs(got - ref).max())
