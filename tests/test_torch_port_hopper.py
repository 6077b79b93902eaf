"""The Hopper redesigns of kernels 1, 3 and 4, on the CPU: the GEMM's
transposed weight packing, what the new kernels refuse (raised before any
launch) and the widths they take, the plain versions at the ragged widths
against the JAX references, and the property that lets kernel 3's bf16 path
run its products on the tensor cores: every plane the plain version
multiplies is a bf16 value. The kernels themselves run only on the card
(``chip_smoke.py`` phases 1, 2, 5 and 8)."""

import contextlib
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zett_tpu.ops.pallas_attention import attention_block_reference as jax_block_reference
from zett_tpu.ops.pallas_attention import encoder_layer_reference as jax_layer_reference

from zett_tpu_torch.ops import _build, attention_block, attention_core_bwd, encoder_layer
from zett_tpu_torch.ops.attention_core import attention_core_bwd_reference, core_bwd_weights
from zett_tpu_torch.ops.encoder_layer import check_gemm_widths, dense_exact, pack_weights

# the module (the package's ``attention_core`` is its forward function)
core_ops = importlib.import_module("zett_tpu_torch.ops.attention_core")
DTYPES = [torch.float32, torch.bfloat16]


def _weights(rng, shapes, dtype):
    return [torch.from_numpy(0.1 * rng.standard_normal(s, dtype=np.float32)).to(dtype)
            for s in shapes]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n_parts", [1, 3])
def test_pack_weights_is_a_pure_permutation(dtype, n_parts):
    """The packed (sum N, K) operand holds exactly the weights' values, each
    at its transposed index, K contiguous."""
    rng = np.random.default_rng(n_parts)
    ws = _weights(rng, [(64, 128)] * n_parts, dtype)
    packed = pack_weights(*ws)
    cat = torch.cat(ws, dim=1)
    assert packed.shape == (128 * n_parts, 64) and packed.stride() == (64, 1)
    assert packed.dtype == dtype
    assert torch.equal(packed, cat.t())
    assert torch.equal(packed.flatten().sort().values, cat.flatten().sort().values)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_dense_exact_through_packed_weights_equals_original(dtype):
    """dense_exact on the packed operand (read back as (K, N)) gives the
    original weights' outputs bit for bit, per projection and fused."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((5, 7, 64), dtype=np.float32)).to(dtype)
    wq, wk, wv = _weights(rng, [(64, 64)] * 3, dtype)
    bq, bk, bv = _weights(rng, [(64,)] * 3, dtype)
    packed = pack_weights(wq, wk, wv)
    fused = dense_exact(x, packed.t(), torch.cat([bq, bk, bv]))
    parts = [dense_exact(x, w, b) for w, b in ((wq, bq), (wk, bk), (wv, bv))]
    assert torch.equal(fused, torch.cat(parts, dim=-1))
    assert torch.equal(dense_exact(x, pack_weights(wq).t(), bq), parts[0])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("widths,depths,match", [
    ((2304, 768, 1536), (768, 1536), None),
    ((768,), (96,), None),  # K off the 64 tile: the last k tile is partial
    ((640,), (768,), None),  # N off the 256 tile: the last N tile is partial
    ((1004,), (768,), "16 bytes"),
])
def test_check_gemm_widths(dtype, widths, depths, match):
    """The GEMM takes the hypernet's widths (H 768, 3H, I 1536), an N off
    the 256 tile and a K off the 64 tile, and refuses only rows that are not
    whole 16-byte units."""
    if match == "16 bytes" and dtype == torch.float32:
        match = None  # 1004 f32 values are 4016 bytes: whole units
    if match is None:
        check_gemm_widths("gemm", dtype, widths, depths)
        return
    with pytest.raises(ValueError, match=match):
        check_gemm_widths("gemm", dtype, widths, depths)


@pytest.fixture
def no_built_kernels(monkeypatch, tmp_path):
    """No built library and no compiler to build one."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))


def test_core_backward_raises_off_the_cpu(no_built_kernels):
    """Kernel 3: a tensor that is not on the CPU goes for the kernel and,
    with none built, raises without counting a launch."""
    q = torch.empty(2, 14, 64, device="meta", dtype=torch.bfloat16)
    before = dict(_build.launch_counts)
    with pytest.raises(RuntimeError, match="nvcc"):
        attention_core_bwd(q, q, q, torch.empty(2, 14, device="meta"), q, 2, 0.1, 5)
    assert _build.launch_counts == before


@pytest.fixture
def built_kernels(monkeypatch):
    """A stand-in for a built library: the wrappers get past the build and
    reach their checks (no launch can happen on the CPU)."""
    monkeypatch.setattr(_build, "load", lambda name: object())


def _misaligned(shape, dtype):
    """A contiguous tensor that starts 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8, dtype=dtype)
    off = next(i for i in range(1, 8) if (buf.data_ptr() + 2 * i) % 16)
    return buf[off:off + n].view(shape)


@pytest.mark.parametrize("case", ["block_n_tile", "layer_row_bytes", "layer_n_tile",
                                  "core_bwd_alignment"])
def test_new_kernels_refuse_before_launching(built_kernels, case):
    """What the Hopper GEMM (kernels 1 and 4) and kernel 3's cp.async
    staging cannot take raises ValueError before any launch is counted;
    widths off the GEMM's tiles get past the width check to the device
    check (a meta tensor has no kernel)."""
    bf = torch.bfloat16
    before = dict(_build.launch_counts)

    def meta(*shape):
        return torch.empty(*shape, device="meta", dtype=bf)

    if case == "block_n_tile":  # H = 128: 3H = 384 is off the 256 tile, and taken
        x, w, b = meta(2, 4, 128), meta(128, 128), meta(128)
        with pytest.raises(ValueError, match="no kernel for device meta"):
            attention_block(x, None, None, w, b, w, b, w, b, w, b, num_heads=2)
    elif case in ("layer_row_bytes", "layer_n_tile"):
        H, I = 256, 1004 if case == "layer_row_bytes" else 1088
        x, w, b = meta(2, 4, H), meta(H, H), meta(H)
        ln = torch.empty(H, device="meta")
        with pytest.raises(ValueError,
                           match="16 bytes" if I == 1004 else "no kernel for device meta"):
            encoder_layer(x, None, w, b, w, b, w, b, w, b, ln, ln, meta(H, I), meta(I),
                          meta(I, H), b, ln, ln, num_heads=4, eps=1e-5)
    else:
        B, Lh = 3, 14
        q = _misaligned((B, Lh, 64), bf)
        assert q.is_contiguous() and q.data_ptr() % 16
        k = torch.zeros(B, Lh, 64, dtype=bf)
        with pytest.raises(ValueError, match="16-byte aligned"):
            core_ops._launch_bwd(q, k, k, torch.ones(B, Lh), k, 2, 0.0, 0)
    assert _build.launch_counts == before


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("Lq,Lk", [(7, 7), (1, 7), (3, 17)])
def test_plain_backward_planes_are_bf16_values(rate, Lq, Lk):
    """In bf16, w, wd and ds, the planes kernel 3's plain version feeds its
    output products, round-trip through bf16 unchanged (with all-padding
    rows, masked keys and dropout): a bf16 mma on them multiplies the same
    values. The plain outputs are those products of the planes."""
    rng = np.random.default_rng(Lq * 100 + Lk)
    B, h = 24, 2
    bf = torch.bfloat16

    def operand(L):
        return torch.from_numpy(rng.standard_normal((B, L * h, 64), dtype=np.float32)).to(bf)

    qm, km, vm, dout = operand(Lq), operand(Lk), operand(Lk), operand(Lq)
    mask = rng.random((B, Lk)) > 0.3
    mask[:, 0] = True
    mask[1::5] = False  # all-padding rows
    kmaskf = torch.from_numpy(np.repeat(mask, h, axis=1).astype(np.float32))
    planes = core_bwd_weights(qm, km, vm, kmaskf, dout, h, rate, seed=11)
    for name, plane in zip(("w", "wd", "ds"), planes):
        assert plane.dtype == torch.float32
        assert torch.equal(plane.to(bf).float(), plane), name
    assert bool((planes[2] != 0).any()) and bool((planes[1] != 0).any())
    _, wd, ds = planes
    dqm, dkm, dvm = attention_core_bwd_reference(qm, km, vm, kmaskf, dout, h, rate, seed=11)
    assert torch.equal(dvm, torch.einsum("bqk,bqd->bkd", wd, dout.float()).to(bf))
    assert torch.equal(dqm, torch.einsum("bqk,bkd->bqd", ds, km.float()).to(bf))
    assert torch.equal(dkm, torch.einsum("bqk,bqd->bkd", ds, qm.float()).to(bf))


def _ragged_inputs(B, L, H, I, dtype, seed):
    """numpy-seeded layer operands at a ragged width: x, a mask with an
    all-padding row, four (H, H) and the FFN's weights, LayerNorm params."""
    rng = np.random.default_rng(seed)

    def arr(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)

    x = arr((B, L, H), 1.0)
    mask = rng.random((B, L)) > 0.3
    mask[:, 0] = True
    mask[1] = False
    ws = [arr((H, H), 0.04) for _ in range(4)]
    bs = [arr((H,), 0.02) for _ in range(4)]
    ffn = [arr((H, I), 0.04), arr((I,), 0.02), arr((I, H), 0.04), arr((H,), 0.02)]
    ln = [1.0 + 0.1 * arr((H,), 1.0), 0.1 * arr((H,), 1.0)]
    return x, mask, ws, bs, ffn, ln


@contextlib.contextmanager
def _one_thread():
    """torch's intra-op threads pinned to one inside the block."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("H,nh,I", [(640, 10, 1600), (896, 14, 1600)])
def test_plain_versions_at_ragged_widths_match_jax(dtype, H, nh, I):
    """Kernels 1 and 4's plain versions at widths off the GEMM's 256 tile
    (H 640 with 10 heads, H 896 with 14 heads, qwen2-0.5B's width; I 1600)
    against the JAX package's encoder_layer_reference and
    attention_block_reference on the same numpy inputs, all rows. The widths
    pass check_gemm_widths. Tolerances: f32 1e-5 of the output scale (sums in
    another order); bf16 one ulp at the output scale (XLA rounds
    intermediate bf16 ops where the port rounds once). The plain versions run
    on one CPU thread, so that torch's f32 sums keep one order whatever the
    machine's load (ROADMAP C.22)."""
    B, L, eps = 3, 5, 1e-5
    x, mask, ws, bs, ffn, ln = _ragged_inputs(B, L, H, I, dtype, seed=H)
    check_gemm_widths("encoder_layer", dtype, (3 * H, H, I), (H, I))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def t(a):
        return torch.from_numpy(a).to(dtype)

    def j(a):
        return jnp.asarray(a, jdt)

    wb_t = [v for w, b in zip(ws, bs) for v in (t(w), t(b))]
    wb_j = [v for w, b in zip(ws, bs) for v in (j(w), j(b))]
    tmask, jmask = torch.from_numpy(mask), jnp.asarray(mask)
    scale = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5

    with _one_thread():
        got = attention_block(t(x), tmask, None, *wb_t, num_heads=nh).float().numpy()
    want = np.asarray(jax_block_reference(j(x), jmask, None, *wb_j, nh).astype(jnp.float32))
    top = max(float(np.abs(want).max()), 1.0)
    assert np.isfinite(got).all() and np.abs(got - want).max() <= scale * top

    lns_t = [torch.from_numpy(v) for v in ln]
    lns_j = [jnp.asarray(v) for v in ln]
    with _one_thread():
        got = encoder_layer(t(x), tmask, *wb_t, *lns_t, t(ffn[0]), t(ffn[1]), t(ffn[2]),
                            t(ffn[3]), *lns_t, num_heads=nh, eps=eps).float().numpy()
    want = np.asarray(jax_layer_reference(
        j(x), jmask, *wb_j, *lns_j, j(ffn[0]), j(ffn[1]), j(ffn[2]), j(ffn[3]), *lns_j,
        nh, eps, True).astype(jnp.float32))
    top = max(float(np.abs(want).max()), 1.0)
    assert np.isfinite(got).all() and np.abs(got - want).max() <= scale * top
