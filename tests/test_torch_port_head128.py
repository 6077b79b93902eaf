"""Head width 128 in the port (the Llama family's hypernets: TinyLlama's 16
heads of 128): the plain versions of kernels 1, 2 and 3 held against the
JAX package's Pallas kernels in interpret mode and their pure-JAX
references at d = 128 (B 6, L 7, 2 heads, H 256, I 512), kernel 1's plan at
TinyLlama's hypernet widths, and the Hypernet at head width 128 against the
JAX Hypernet. The same numpy-seeded inputs go through both sides; the CUDA
instantiations at d = 128 run only on the card (chip_smoke.py phase 14)."""

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
from zett_tpu_torch.ops.attention_core import (
    attention_core_bwd_reference,
    attention_core_reference,
    keep_mask,
)
from zett_tpu_torch.ops.encoder_layer import encoder_layer, layer_plan

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, L, h, d = 6, 7, 2, 128
H, I = h * d, 512


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def _tol(dtype_name, ref):
    """f32: 1e-5 of the output scale (sums in another order). bf16: 2 ulps
    of the largest magnitude (an f32 sum in another order can round an
    intermediate the other way)."""
    scale = max(float(np.abs(ref).max()), 1.0)
    return 1e-5 * scale if dtype_name == "float32" else 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)


def _key_mask(rng, Lk):
    mask = rng.random((B, Lk)) > 0.3
    mask[:, 0] = True
    mask[1] = False  # all-padding surface forms
    mask[4] = False
    return mask


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_encoder_layer_plain_at_head128_matches_jax(dtype_name):
    """Kernel 1's plain version at d = 128 vs encoder_layer_reference (all
    rows) and encoder_layer_pallas(interpret=True) on the rows with a valid
    key (the Pallas kernel pads L to 8 with masked positions, so its
    all-padding rows average the padding too; ROADMAP C.5). Tolerances: f32
    1e-5 absolute (LayerNormed outputs, |y| < 6, sums in another order);
    bf16 one ulp at the output scale (2^-8 * 8), since XLA rounds every
    intermediate bf16 op where the port rounds once."""
    rng = np.random.default_rng(128)
    x = rng.normal(size=(B, L, H)).astype(np.float32)
    mask = _key_mask(rng, L)
    mats = [rng.normal(size=s).astype(np.float32) * 0.05 for s in [(H, H)] * 4 + [(H, I), (I, H)]]
    vecs = [rng.normal(size=s).astype(np.float32) * 0.02 for s in [(H,)] * 4 + [(I,), (H,)]]
    lns = [1.0 + 0.1 * rng.normal(size=H).astype(np.float32),
           0.1 * rng.normal(size=H).astype(np.float32)]
    jx, tx = _pair(x, dtype_name)
    jw, tw = zip(*(_pair(m, dtype_name) for m in mats))
    jb, tb = zip(*(_pair(v, dtype_name) for v in vecs))

    def order(w, b, ln):
        return (w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3], ln[0], ln[1],
                w[4], b[4], w[5], b[5], ln[0], ln[1])

    jargs = (jx, jnp.asarray(mask), *order(jw, jb, [jnp.asarray(v) for v in lns]))
    targs = (tx, torch.from_numpy(mask), *order(tw, tb, [torch.from_numpy(v) for v in lns]))
    got = _f32(encoder_layer(*targs, num_heads=h, eps=1e-5))
    ref = _f32(encoder_layer_reference(*jargs, h, 1e-5, True))
    pal = _f32(encoder_layer_pallas(*jargs, num_heads=h, eps=1e-5, approximate_gelu=True,
                                    tile_b=2, interpret=True))
    tol = 1e-5 if dtype_name == "float32" else 0.03125
    live = mask.any(axis=1)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= tol, np.abs(got - ref).max()
    assert np.abs(got[live] - pal[live]).max() <= tol, np.abs(got[live] - pal[live]).max()


def _core_inputs(dtype_name, Lq, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, n * h, d)).astype(np.float32) for n in (Lq, L, L, Lq)]
    mask = _key_mask(rng, L)
    kmaskf = np.repeat(mask, h, axis=-1).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    jx = [jnp.asarray(a, jdt) for a in arrs] + [jnp.asarray(kmaskf)]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs] + [torch.from_numpy(kmaskf)]
    return jx, tx, mask


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq", [7, 1])
def test_attention_core_plain_at_head128_matches_jax(dtype_name, Lq):
    """Kernel 2's plain version at d = 128 (full-query and CLS-only rows,
    rate 0) vs _core_train_fwd_pallas(interpret=True) and the fallback
    reference, all-padding rows included; tolerance as ``_tol``."""
    jx, tx, _ = _core_inputs(dtype_name, Lq, seed=20 + Lq)
    seed = jnp.zeros((), jnp.int32)
    got = _f32(attention_core_reference(*tx[:3], tx[4], h))
    pal = _f32(_core_train_fwd_pallas(*jx[:3], jx[4], seed, h, 0.0, interpret=True))
    ref = _f32(_core_train_fallback(*jx[:3], jx[4], seed, h, 0.0))
    assert got.shape == (B, Lq * h, d)
    assert np.abs(got - pal).max() <= _tol(dtype_name, pal), np.abs(got - pal).max()
    assert np.abs(got - ref).max() <= _tol(dtype_name, ref), np.abs(got - ref).max()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq", [7, 1])
def test_attention_core_bwd_plain_at_head128_matches_jax(dtype_name, Lq):
    """Kernel 3's plain version at d = 128 vs the Pallas backward kernel
    (interpret mode) on rows with a valid key, and vs jax.vjp of the
    differentiable fallback on every row: all-padding rows take dq = dk = 0
    there (ROADMAP C.4), and their dv sums every query head's dout."""
    jx, tx, mask = _core_inputs(dtype_name, Lq, seed=40 + Lq)
    jq, jk, jv, jg, jm = jx
    tq, tk, tv, tg, tm = tx
    got = attention_core_bwd_reference(tq, tk, tv, tm, tg, h)
    seed = jnp.zeros((), jnp.int32)
    pallas = _core_train_bwd_pallas(jq, jk, jv, jm, seed, jg, h, 0.0, interpret=True)
    _, vjp = jax.vjp(lambda q, k, v: _core_train_fallback(q, k, v, jm, seed, h, 0.0), jq, jk, jv)
    fallback = vjp(jg)
    rows = mask.any(1)
    for name, g, p, f in zip(("dq", "dk", "dv"), got, pallas, fallback):
        g, p, f = _f32(g), _f32(p), _f32(f)
        tol = _tol(dtype_name, f)
        assert np.abs(g - f).max() <= tol, (name, np.abs(g - f).max(), tol)
        assert np.abs(g[rows] - p[rows]).max() <= tol, (name, np.abs(g[rows] - p[rows]).max())
    assert not rows.all()
    assert np.abs(_f32(got[0])[~rows]).max() == 0.0


H4 = 4  # heads of 128 in the per-head mask cases


def _head_masks(kind, seed):
    """(B, L, 4) key masks, ragged. "mixed": row 0 heads 0 and 2 without a
    valid key, row 3 head 3, row 5 heads 1 to 3, row 1 no head with one;
    "all_padding": every head masked alike, rows 1 and 4 without any."""
    rng = np.random.default_rng(seed)
    m = rng.random((B, L, H4)) > 0.3
    m[:, 0, :] = True
    if kind == "all_padding":
        m = np.repeat(m[:, :, :1], H4, axis=2)
        m[[1, 4]] = False
        return m
    m[0, :, [0, 2]] = False
    m[1] = False
    m[3, :, 3] = False
    m[5, :, 1:] = False
    return m


def _head_mask_inputs(dtype_name, masks, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, L * H4, d)).astype(np.float32) for _ in range(4)]
    kmaskf = masks.reshape(B, L * H4).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    jx = [jnp.asarray(a, jdt) for a in arrs] + [jnp.asarray(kmaskf)]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs] + [torch.from_numpy(kmaskf)]
    return jx, tx


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["all_padding", "mixed"])
def test_attention_core_bwd_plain_head_masks_at_head128_match_jax(kind, dtype_name):
    """Kernel 3's plain version at 4 heads of 128, rate 0, against jax.vjp
    of the differentiable fallback on rows whose heads all lack a valid key
    (there every dv row is w times the row's dout summed over its queries,
    w = round(1/(L*h)), and dq = dk = 0) and on rows whose heads differ (a
    head without a valid key has dq = dk = 0, and its queries add to the dv
    of every merged key, the other heads' included)."""
    masks = _head_masks(kind, 60)
    jx, tx = _head_mask_inputs(dtype_name, masks, 61)
    jq, jk, jv, jg, jm = jx
    tq, tk, tv, tg, tm = tx
    got = [_f32(g) for g in attention_core_bwd_reference(tq, tk, tv, tm, tg, H4)]
    seed = jnp.zeros((), jnp.int32)
    _, vjp = jax.vjp(lambda q, k, v: _core_train_fallback(q, k, v, jm, seed, H4, 0.0),
                     jq, jk, jv)
    for name, g, f in zip(("dq", "dk", "dv"), got, vjp(jg)):
        f = _f32(f)
        assert np.abs(g - f).max() <= _tol(dtype_name, f), (name, np.abs(g - f).max())
    pad = ~masks.any(axis=1)  # (B, h)
    merged_pad = np.tile(pad, L)  # (B, L*h), index position*h + head
    assert not got[0][merged_pad].any() and not got[1][merged_pad].any()
    rows = pad.all(1)
    w = float(torch.tensor(1.0 / (L * H4), dtype=tq.dtype))
    expect = w * _f32(tg).sum(axis=1, keepdims=True)[rows]
    assert np.abs(got[2][rows] - expect).max() <= _tol(dtype_name, expect)
    assert (rows.sum(), (pad.any(1) & ~rows).sum()) == ((2, 0) if kind == "all_padding" else (1, 3))


@pytest.mark.parametrize("kind", ["all_padding", "mixed"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_core_bwd_plain_head_masks_at_head128_match_autograd(kind, rate):
    """At 4 heads of 128 in f64, rates 0 and 0.1: the hand-written backward
    against autograd of the plain forward on the same masks, and the
    padding heads' share of dv (dv less dv with their queries' dout zeroed)
    against sum keep * wd * dout over those queries."""
    masks = _head_masks(kind, 62)
    _, tx = _head_mask_inputs("float32", masks, 63)
    q, k, v = (t.double().requires_grad_() for t in tx[:3])
    g, kmaskf = tx[3].double(), tx[4].double()
    seed = 21
    attention_core_reference(q, k, v, kmaskf, H4, rate, seed).backward(g)
    got = [t.detach() for t in attention_core_bwd_reference(q, k, v, kmaskf, g, H4, rate, seed)]
    for name, a, b in zip(("dq", "dk", "dv"), got, (q.grad, k.grad, v.grad)):
        assert float((a - b).abs().max()) <= 1e-6 * max(1.0, float(b.abs().max())), name
    merged_pad = torch.from_numpy(np.tile(~masks.any(axis=1), L))
    g0 = torch.where(merged_pad[..., None], torch.zeros((), dtype=g.dtype), g)
    dv0 = attention_core_bwd_reference(q, k, v, kmaskf, g0, H4, rate, seed)[2].detach()
    keep = keep_mask(seed, B, L * H4, L * H4, rate, "cpu") & merged_pad[:, :, None]
    share = torch.einsum("bqk,bqd->bkd", keep.double(), g) / (L * H4) / (1.0 - rate)
    assert float((got[2] - dv0 - share).abs().max()) <= 1e-12


def test_layer_plan_at_tinyllama_widths():
    """TinyLlama's hypernet (H 2048, 16 heads of 128, I 4096) runs kernel 1
    as the seven-launch sequence in bf16 and in f32 (encoder_layer.cu's
    header note says why head width 128 does not take the four fused
    launches); head width 64 keeps the fused route, 32 heads are the bf16
    limit at 128 as at 64, and a bf16 row must fit the core's shared
    memory."""
    bf, f32 = torch.bfloat16, torch.float32
    for dtype in (bf, f32):
        assert layer_plan(dtype, 7, 2048, 16, 4096) == type(layer_plan(bf, 7, 768, 12, 1536))(
            "unfused", 7, 0, 0, 0)
    assert layer_plan(bf, 7, 1024, 16, 4096).route == "fused"
    with pytest.raises(ValueError, match="at most 32"):
        layer_plan(bf, 7, 128 * 33, 33, 4096)
    with pytest.raises(ValueError, match="head width 96/1 heads"):
        layer_plan(bf, 7, 96, 1, 256)
    # a row of 16 heads of 128 fits shared memory up to 18 positions
    assert layer_plan(bf, 18, 2048, 16, 4096).launches == 7
    with pytest.raises(ValueError, match="shared memory"):
        layer_plan(bf, 19, 2048, 16, 4096)


HN = dict(
    hidden_size=H, intermediate_size=I, num_hidden_layers=2, num_attention_heads=h,
    max_position_embeddings=8, n_embd=64, hn_surface_maxlen=L,
    embed_using_source_embeddings=True, original_vocab_size=300, n_extra_tokens=16,
    rescale_embeddings=True, predict_bias=True, separate_out_embeddings=True,
    hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
)


def _hn_inputs(n=40, seed=0):
    rng = np.random.default_rng(seed)
    sf = rng.integers(1, 316, size=(n, L)).astype(np.int32)  # ids >= 300: the fallback
    lens = rng.integers(1, L + 1, size=n)
    sf[np.arange(L)[None] >= lens[:, None]] = 0
    sf[3] = 0  # all-padding rows
    src = (rng.normal(size=(384, 128)) * 0.05).astype(np.float32)  # [in | out]
    return sf, src


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_hypernet_at_head128_matches_jax(dtype_name):
    """The Hypernet with 2 heads of 128 and dual heads (an untied
    backbone's [in | out] source table): layer 0 through kernel 1's plain
    version at d = 128, the CLS-only last layer through kernel 2's. f32: max
    abs 1e-5 (outputs of magnitude ~4); bf16: max abs <= 2% of the output
    scale and mean <= 0.3% (XLA rounds every bf16 op, the port's fused
    steps round once), the bias within 0.03."""
    jdt, tdt = DTYPES[dtype_name]
    sf, src = _hn_inputs()
    jax_model = JaxHypernet(JaxConfig(**HN), dtype=jdt)
    p = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(sf[:4]), jnp.zeros(4),
                       jnp.asarray(src), 0)
    flat = traverse_util.flatten_dict(p["params"], sep="/")
    rng = np.random.default_rng(1)
    for k, v in flat.items():
        if k.endswith("kernel"):
            x = rng.normal(size=v.shape) / np.sqrt(v.shape[0])
        elif k.endswith("scale") or k.endswith("/w"):
            x = 1.0 + 0.1 * rng.normal(size=v.shape)
        else:
            x = 0.05 * rng.normal(size=v.shape)
        flat[k] = jnp.asarray(x.astype(np.float32), v.dtype)
    refs = jax_model.apply({"params": traverse_util.unflatten_dict(flat, sep="/")},
                           jnp.asarray(sf), None, jnp.asarray(src), 0)
    model = Hypernet(HypernetConfig(**HN), dtype=tdt)
    model.load_state_dict(flax_to_torch({k: np.asarray(v) for k, v in flat.items()}))
    with torch.inference_mode():
        gots = model(torch.from_numpy(sf).long(), None, torch.from_numpy(src))
    for name, got, ref in zip(("in", "out", "bias"), gots, refs):
        got, ref = _f32(got), _f32(ref)
        assert got.shape == ref.shape, name
        err = np.abs(got - ref)
        if dtype_name == "float32":
            assert err.max() <= 1e-5, (name, err.max())
        elif name == "bias":
            assert err.max() <= 0.03, err.max()
        else:
            scale = np.abs(ref).max()
            assert err.max() <= 0.02 * scale, (name, err.max(), scale)
            assert err.mean() <= 0.003 * scale, (name, err.mean(), scale)


@pytest.mark.parametrize("override", [{"add_inter_token_attention": True, "n_inter_token_blocks": 4,
                                       "embed_target_priors": True,
                                       "inter_token_attention_bias_by_priors": True},
                                      {"hidden_act": "gelu"}])
def test_head128_layers_that_take_kernel4_raise(override):
    """At head width 128 the layers that take kernel 4 (inter-token
    attention, erf-gelu) run now: the inference route (kernel 4's plain
    version at d = 128 on every layer with inter-token attention, on the
    non-CLS layers with erf-gelu) against the JAX Hypernet. f32: max abs
    within 1e-5 of the output scale; bf16: C.6's bound, max abs within 2%
    of the output scale, mean within 0.3%, the bias within 0.03."""
    from zett_tpu_torch.models import hypernet as hn

    cfg = {**HN, **override}
    sf, src = _hn_inputs()
    priors = np.random.default_rng(5).normal(size=len(sf)).astype(np.float32) * 2.0 - 9.0
    calls = []
    orig = hn.attention_block_fused
    for dtype_name, (jdt, tdt) in DTYPES.items():
        jax_model = JaxHypernet(JaxConfig(**cfg), dtype=jdt)
        p = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.asarray(sf[:4]),
                           jnp.zeros(4), jnp.asarray(src), 0)
        flat = traverse_util.flatten_dict(p["params"], sep="/")
        rng = np.random.default_rng(1)
        for k, v in flat.items():
            if k.endswith("kernel"):
                x = rng.normal(size=v.shape) / np.sqrt(v.shape[0])
            elif k.endswith("scale") or k.endswith("/w"):
                x = 1.0 + 0.1 * rng.normal(size=v.shape)
            else:
                x = 0.05 * rng.normal(size=v.shape)
            flat[k] = jnp.asarray(x.astype(np.float32), v.dtype)
        refs = jax.jit(jax_model.apply)({"params": traverse_util.unflatten_dict(flat, sep="/")},
                                        jnp.asarray(sf), jnp.asarray(priors), jnp.asarray(src), 0)
        model = Hypernet(HypernetConfig(**cfg), dtype=tdt)
        model.load_state_dict(flax_to_torch({k: np.asarray(v) for k, v in flat.items()}))
        calls.clear()
        hn.attention_block_fused = lambda *a, **k: (calls.append(a[0].shape), orig(*a, **k))[1]
        try:
            with torch.inference_mode():
                gots = model(torch.from_numpy(sf).long(), torch.from_numpy(priors),
                             torch.from_numpy(src))
        finally:
            hn.attention_block_fused = orig
        n_block = HN["num_hidden_layers"] - (0 if "add_inter_token_attention" in override else 1)
        assert len(calls) == n_block, calls
        for name, got, ref in zip(("in", "out", "bias"), gots, refs):
            got, ref = _f32(got), _f32(ref)
            assert got.shape == ref.shape and np.isfinite(got).all(), name
            err = np.abs(got - ref)
            scale = max(float(np.abs(ref).max()), 1.0)
            if dtype_name == "float32":
                assert err.max() <= 1e-5 * scale, (name, err.max(), scale)
            elif name == "bias":
                assert err.max() <= 0.03, err.max()
            else:
                assert err.max() <= 0.02 * scale, (name, err.max(), scale)
                assert err.mean() <= 0.003 * scale, (name, err.mean(), scale)


@pytest.mark.parametrize("override", [{"add_inter_token_attention": True, "n_inter_token_blocks": 4,
                                       "embed_target_priors": True,
                                       "inter_token_attention_bias_by_priors": True},
                                      {"hidden_act": "gelu"}])
def test_head128_kernel4_layers_training_route_matches_jax(override):
    """The same configurations on the training route (inference=False, rate
    0, f32): JAX's loss and every parameter gradient, within 1e-5 of the
    loss and of each leaf's largest gradient (or of 1% of the model's
    largest, for leaves whose exact gradient is 0)."""
    from zett_tpu_torch.models.convert import flax_paths

    cfg = {**HN, **override}
    sf, src = _hn_inputs()
    priors = np.random.default_rng(5).normal(size=len(sf)).astype(np.float32) * 2.0 - 9.0
    jax_model = JaxHypernet(JaxConfig(**cfg))
    p = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.asarray(sf[:4]),
                       jnp.zeros(4), jnp.asarray(src), 0)
    flat = traverse_util.flatten_dict(p["params"], sep="/")
    rng = np.random.default_rng(1)
    for k, v in flat.items():
        scale = 1.0 / np.sqrt(v.shape[0]) if k.endswith("kernel") else 0.05
        x = scale * rng.normal(size=v.shape)
        flat[k] = (1.0 + x if k.endswith("scale") or k.endswith("/w") else x).astype(np.float32)
    w = np.random.default_rng(3).normal(size=(len(sf), 64)).astype(np.float32)

    def jloss(params):
        e, o, b = jax_model.apply({"params": params}, jnp.asarray(sf), jnp.asarray(priors),
                                  jnp.asarray(src), 0, deterministic=True, inference=False)
        return (e * w).sum() + (o * w).sum() + b.sum()

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(traverse_util.unflatten_dict(flat, sep="/"))
    jgrads = traverse_util.flatten_dict(jgrads, sep="/")
    model = Hypernet(HypernetConfig(**cfg))
    model.load_state_dict(flax_to_torch(flat))
    e, o, b = model(torch.from_numpy(sf).long(), torch.from_numpy(priors), torch.from_numpy(src),
                    0, deterministic=True, inference=False)
    wt = torch.from_numpy(w)
    got = (e * wt).sum() + (o * wt).sum() + b.sum()
    got.backward()
    got = float(got.detach())
    assert abs(got - float(want)) <= 1e-5 * abs(float(want)), (got, float(want))
    floor = 1e-2 * max(float(np.abs(np.asarray(g)).max()) for g in jgrads.values())
    params = dict(model.named_parameters())
    for pname, (path, transpose) in flax_paths(model).items():
        g = params[pname].grad
        g = (g.t() if transpose else g).numpy()
        want_g = np.asarray(jgrads["/".join(path)])
        tol = 1e-5 * max(float(np.abs(want_g).max()), floor)
        assert np.abs(g - want_g).max() <= tol, (pname, np.abs(g - want_g).max(), tol)


def test_remat_glue_same_gradients_fewer_saved_bytes():
    """The training route at head width 128 inside ``remat_glue`` (what the
    trainer's ``remat_hypernet`` runs), bf16: the LayerNorms and gelus keep
    only their bf16 inputs for the backward instead of their f32
    intermediates, so the graph saves under a tenth of the f32 bytes and
    under 60% of all bytes (the plain graph's are mostly those f32
    intermediates), and the outputs and every parameter gradient are
    bitwise those of the plain graph (the same ops recomputed in the same
    order)."""
    from zett_tpu_torch.models.hypernet import remat_glue

    sf, src = _hn_inputs(n=64, seed=3)
    model = Hypernet(HypernetConfig(**HN), dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(0))
    sf_t, src_t = torch.from_numpy(sf).long(), torch.from_numpy(src)

    def run(glue):
        saved = {torch.float32: 0, torch.bfloat16: 0}

        def pack(t):
            saved[t.dtype] = saved.get(t.dtype, 0) + t.numel() * t.element_size()
            return t

        model.zero_grad()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            with remat_glue() if glue else torch.enable_grad():
                outs = model(sf_t, None, src_t, inference=False)
        loss = sum((o.float() ** 2).sum() for o in outs)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        return outs, grads, saved

    outs, grads, plain = run(False)
    outs_g, grads_g, glue = run(True)
    for a, b in zip(outs, outs_g):
        assert torch.equal(a, b)
    assert grads.keys() == grads_g.keys() and len(grads) > 20
    for name, g in grads.items():
        assert torch.equal(g, grads_g[name]), name
    assert glue[torch.float32] < 0.1 * plain[torch.float32], (glue, plain)
    assert sum(glue.values()) < 0.6 * sum(plain.values()), (glue, plain)
