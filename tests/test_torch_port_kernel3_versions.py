"""The kernel 3 side-by-side tool (zett_tpu_torch.tools.kernel3_versions)
on the CPU: its masks are the cases it claims, its error measure is the
stated one, and without a card it stops before building anything."""

import pytest
import torch

from zett_tpu_torch.tools import kernel3_versions as kv


def test_mixed_head_masks_differ_within_rows():
    B, Lk, h = 400, 7, 4
    heads = kv.mixed_head_masks(B, Lk, h, torch.Generator().manual_seed(0)).view(B, Lk, h)
    padding = (heads <= 0).all(1)  # (B, h): heads without a valid key
    assert padding[1::97].all()
    assert padding[::5, 0].all()
    mixed = padding.any(1) & ~padding.all(1)
    assert int(mixed.sum()) > B // 2


def test_train_masks_repeat_one_mask_over_heads():
    B, Lk, h = 1000, 7, 3
    mask = kv.train_masks(B, Lk, h, torch.Generator().manual_seed(0), padding_rows=400)
    per_head = mask.view(B, Lk, h)
    assert torch.equal(per_head, per_head[..., :1].expand(B, Lk, h))
    all_padding = int((per_head <= 0).all(1).all(1).sum())
    assert 400 <= all_padding <= 400 + len(range(1, B, 97))


def test_errors_counts_bf16_ulps_at_unit_scale():
    ref = torch.tensor([0.5, 3.0, -10.0, 100.0])
    # ulps of max(|ref|, 1): 2^-7, 2^-6, 2^-4, 2^-1
    got = (ref + torch.tensor([2 * 2.0 ** -7, 3 * 2.0 ** -6, 2 * 2.0 ** -4, 0.0])).bfloat16()
    out = kv.errors(got, ref)
    assert out["max_ref"] == 100.0
    assert out["max_abs"] == pytest.approx(float((got.float() - ref).abs().max()))
    assert out["within_2_ulps"] == pytest.approx(0.75)
    assert "within_2_ulps" not in kv.errors(ref, ref)


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no card"):
        kv.main([])
