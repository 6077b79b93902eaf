"""The kernel 2 side-by-side tool (zett_tpu_torch.tools.kernel2_versions)
on the CPU: its rows are the ones it claims, its bounds count what they
state, its SASS count reads cuobjdump's format, and without a card it stops
before building anything."""

import pytest
import torch

from zett_tpu_torch.tools import kernel2_versions as kv


def test_timed_rows_are_the_redesigned_rows():
    rows = {(what, h, d, B, Lq, Lk, rate) for what, h, d, B, Lq, Lk, _, rate in kv.TIMED}
    assert ("CLS", 32, 128, 16384, 1, 7, 0.0) in rows
    assert ("CLS", 32, 128, 16384, 1, 8, 0.0) in rows
    for h in (32, 16):
        assert ("padding share", h, 128, 32896, 7, 7, 0.1) in rows
        assert ("padding share", h, 128, 32896, 7, 7, 0.0) in rows
    assert all(pad == 18991 for what, *_, pad, _ in kv.TIMED if what == "padding share")


def test_edges_cover_the_cluster_cases():
    shapes = {(B, Lq, Lk) for B, Lq, Lk, _, _ in kv.EDGES}
    assert {(1, 1, 7), (133, 1, 7), (777, 16, 5)} <= shapes
    assert any(rate > 0 and offset > 0 for *_, rate, offset in kv.EDGES)
    assert {rate for *_, rate, _ in kv.EDGES} == {0.0, 0.1}


def test_philox_words_and_bounds():
    # an all-padding row at 32 heads, L 7: every query of every head over
    # every merged key; a row with valid keys: each head its own 7 x 7
    assert kv.philox_words(1, 7, 7, 32, 1) == 224 * 224 == 50176
    assert kv.philox_words(2, 7, 7, 32, 1) == 50176 + 32 * 49
    assert kv.issue_rate(132, 1980) == 132 * 128 * 1.98e9
    # a row of 16 heads of 128 without padding: q, k, v in and out at L 7
    assert kv.bytes_bound_ms(1, 7, 7, 16, 128, 0) == pytest.approx(
        (16 * 28 * 128 * 2 + 7 * 16 * 4) / 3.35e12 * 1e3)
    # an all-padding row needs no q or k
    assert kv.bytes_bound_ms(1, 7, 7, 16, 128, 1) == pytest.approx(
        (16 * 14 * 128 * 2 + 7 * 16 * 4) / 3.35e12 * 1e3)


SASS = """
\tcode for sm_90a
\t\tFunction : philox_base
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;                      /* 0x0000000000007919 */
        /*0020*/              @!PT LDS RZ, [RZ] ;                          /* 0x00000000fffff984 */
        /*0030*/                   EXIT ;                                  /* 0x000000000000794d */
        /*0040*/                   BRA 0x40;                               /* 0xfffffffc00fc7947 */
        /*0050*/                   NOP;                                    /* 0x0000000000007918 */
\t\t..........
\t\tFunction : philox_probe
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
        /*0010*/                   IMAD.WIDE.U32 R2, R0, -0x2daee0ad, RZ ; /* 0x0000000000007919 */
        /*0020*/               @P0 LOP3.LUT R4, R2, R3, R5, 0x96, !PT ;    /* 0x0000000000007919 */
        /*10000*/                  EXIT ;                                  /* 0x000000000000794d */
"""


def test_sass_instructions_counts_by_function():
    assert kv.sass_instructions(SASS) == {"philox_base": 4, "philox_probe": 4}


def test_held_by_rule_is_chip_smokes_tolerance():
    ok = {"max_abs": 0.01, "max_ref": 4.0, "within_2_ulps": 0.9995}
    assert kv.held_by_rule(ok, torch.bfloat16)
    assert not kv.held_by_rule(dict(ok, within_2_ulps=0.99), torch.bfloat16)
    assert not kv.held_by_rule(dict(ok, max_abs=0.3), torch.bfloat16)  # 8 ulps at 4: 0.25
    assert kv.held_by_rule({"max_abs": 1e-5, "max_ref": 4.0}, torch.float32)
    assert not kv.held_by_rule({"max_abs": 3e-5, "max_ref": 4.0}, torch.float32)
    # a plain bool: each held row is printed and written as JSON
    assert type(kv.held_by_rule(ok, torch.bfloat16)) is bool
    assert type(kv.held_by_rule({"max_abs": 1e-5, "max_ref": 4.0}, torch.float32)) is bool


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no card"):
        kv.main([])
