"""The kernel 1 and 4 side-by-side tool (zett_tpu_torch.tools.kernel1_versions)
on the CPU: its rows are the rows of PERF.md's table of TPU kernels, its
bounds count what they state, its operands are the stated ones, and without
a card it stops before building anything."""

import pytest
import torch

from zett_tpu_torch.tools import kernel1_versions as kv


def test_kernel1_rows_are_the_tables():
    rows = {row[1:] for row in kv.K1_ROWS}
    assert {(16384, 7, 768, 12, 1536), (16384, 4, 768, 12, 1536),
            (16384, 7, 640, 10, 1600), (16384, 7, 896, 14, 1600),
            (4096, 7, 1024, 16, 4096),             # the widest fused width
            (16384, 7, 2048, 16, 4096),            # TinyLlama, d 128
            (4096, 8, 2048, 32, 4096),             # 32 heads of 64
            (16384, 7, 4096, 32, 8192), (16384, 8, 4096, 32, 8192)} == rows


def test_kernel4_rows_are_the_tables():
    rows = {row[1:] for row in kv.K4_ROWS}
    assert (16384, 8, 768, 12, False) in rows and (16384, 8, 768, 12, True) in rows
    assert {(16384, 5, 768, 12, False), (32896, 8, 768, 12, False),
            (16384, 8, 640, 10, False), (16384, 8, 896, 14, False),
            (16384, 8, 2048, 32, False), (16384, 8, 2048, 16, False),
            (16384, 8, 4096, 32, False)} <= rows


@pytest.mark.parametrize("row,ms", [((16384, 7, 4096, 32, 8192), 31.142),
                                    ((16384, 8, 4096, 32, 8192), 35.593),
                                    ((16384, 7, 2048, 16, 4096), 7.789),
                                    ((16384, 7, 768, 12, 1536), 1.097),
                                    ((4096, 8, 2048, 32, 4096), 2.226)])
def test_kernel1_bounds(row, ms):
    # PERF.md's bounds (operations): the projections, the FFN and the core
    assert kv.kernel1_bound_ms(*row) == pytest.approx(ms, abs=1e-3)
    B, L, H, h, I = row
    flops = 2 * B * L * (4 * H * H + 2 * H * I) + 4 * B * h * L * L * (H // h)
    assert kv.kernel1_bound_ms(*row) == pytest.approx(flops / 989e12 * 1e3)


@pytest.mark.parametrize("row,ms", [((16384, 8, 4096, 32, False), 17.805),
                                    ((16384, 8, 2048, 16, False), 4.456),
                                    ((16384, 8, 768, 12, False), 0.629)])
def test_kernel4_bounds(row, ms):
    assert kv.kernel4_bound_ms(*row) == pytest.approx(ms, abs=1e-3)


def test_a_bytes_bound_row():
    # one row of 8 positions at H 64: the bytes, not the operations, bound it
    nbytes = (2 * 8 * 64 + 4 * 64 * 64 + 2 * 64 * 64 + 6 * 64 + 64) * 2 + 8 * 4 + 4 * 64 * 4
    assert kv.kernel1_bound_ms(1, 8, 64, 1, 64) == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_operands_at_the_inits_scale():
    gen = torch.Generator().manual_seed(0)
    args = kv.layer_operands(200, 7, 64, 96, gen)
    x, mask, wq, w1, w2 = args[0], args[1], args[2], args[12], args[14]
    assert x.shape == (200, 7, 64) and x.dtype == torch.bfloat16
    assert not mask[1::97].any() and mask[::97, 0].all()
    assert float(wq.float().std()) == pytest.approx(64 ** -0.5, rel=0.15)
    assert w1.shape == (64, 96) and float(w2.float().std()) == pytest.approx(96 ** -0.5, rel=0.15)
    block = kv.block_operands(50, 8, 64, True, gen)
    assert len(block) == 11 and block[2].shape == (50, 8)
    assert kv.block_operands(50, 8, 64, False, gen)[2] is None


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no card"):
        kv.main([])
