"""Guards of the PyTorch port: it imports nothing of JAX, the JAX package
or the third-party libraries the card's machine lacks; its entry point runs
on the card unless asked for the CPU; and a kernel wrapper handed a tensor
that is not on the CPU launches its kernel or raises."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from zett_tpu_torch.ops import (
    _build,
    attention_block,
    attention_block_fused,
    attention_core,
    encoder_layer,
    merged_attention,
    viterbi_dp,
    viterbi_dp_plain,
)
from zett_tpu_torch.ops.device_viterbi import viterbi_spans_dp, viterbi_spans_dp_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "regex", "safetensors",
             "tokenizers", "transformers", "datasets", "zett_tpu", "msgpack", "ml_dtypes")


def _port_files():
    root = os.path.join(REPO, "zett_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_files()), ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_nothing_forbidden(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("module", ["zett_tpu_torch.transfer.__main__",
                                    "zett_tpu_torch.training.__main__",
                                    "zett_tpu_torch.tokenization.compute_prior",
                                    "zett_tpu_torch.evaluation.__main__",
                                    "zett_tpu_torch.evaluation.choice",
                                    "zett_tpu_torch.transfer.baselines_cli"])
def test_cli_import_leaves_jax_out(module):
    code = (f"import sys, {module}, zett_tpu_torch.data, zett_tpu_torch.training.engine, "
            "zett_tpu_torch.evaluation.loop, zett_tpu_torch.transfer.baselines, "
            "zett_tpu_torch.models.reference_io, zett_tpu_torch.models.hypernet_t5; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'zett_tpu', 'regex', 'safetensors', 'datasets', 'msgpack', "
            "'tokenizers', 'transformers')]; "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def test_cli_without_device_flag_needs_the_card(tmp_path):
    """Without --device cpu the CLI runs on the card; with none it raises
    before doing any work."""
    from zett_tpu_torch.transfer.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--checkpoint", str(tmp_path), "--model", str(tmp_path),
              "--target-tokenizer", str(tmp_path), "--output", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")


def test_baselines_cli_without_device_flag_needs_the_card(tmp_path):
    """The baselines CLI searches FOCUS's and OFA's similarities on the card
    unless --device cpu is given; with none it raises before reading or
    writing anything."""
    from zett_tpu_torch.transfer.baselines_cli import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for method in ("focus", "passthrough"):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--method", method, "--model", str(tmp_path / "missing"),
                  "--target-tokenizer", str(tmp_path / "missing"),
                  "--checkpoint", str(tmp_path / "missing"), "--output", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")


def test_prior_cli_bare_device_flag_needs_the_card(tmp_path):
    """compute_prior's bare --device means the card; with none it raises
    before reading or writing anything."""
    from zett_tpu_torch.tokenization.compute_prior import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    out = tmp_path / "priors.npy"
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--tokenizer", str(tmp_path / "missing"), "--data", str(tmp_path / "missing.txt"),
              "--output", str(out), "--device"])
    assert not os.path.exists(out)


@pytest.fixture
def no_built_kernels(monkeypatch, tmp_path):
    """No built library and no compiler to build one."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))


def test_kernel_wrappers_raise_off_the_cpu(no_built_kernels):
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper goes for its kernel and, with none built, raises."""
    H, L, B = 128, 4, 2
    x = torch.empty(B, L, H, device="meta")
    w, b = torch.empty(H, H, device="meta"), torch.empty(H, device="meta")
    before = dict(_build.launch_counts)
    with pytest.raises(RuntimeError, match="nvcc"):
        encoder_layer(x, None, w, b, w, b, w, b, w, b, b, b, w, b, w, b, b, b,
                      num_heads=2, eps=1e-5)
    q = torch.empty(B, 2, 64, device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        attention_core(q, q, q, torch.empty(B, 2, device="meta"), 2)
    assert _build.launch_counts == before


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = dict(_build.launch_counts)
    q = torch.randn(3, 2, 64)
    out = attention_core(q, q, q, torch.ones(3, 2), 2)
    assert out.shape == q.shape
    assert _build.launch_counts == before


@pytest.mark.parametrize("wrapper", ["attention_block", "attention_block_fused",
                                     "merged_attention"])
def test_block_and_core_wrappers_raise_off_the_cpu(no_built_kernels, wrapper):
    """Kernels 4 and 5: a tensor that is not on the CPU goes for the kernel
    and, with none built, raises without counting a launch."""
    H, L, B = 128, 4, 2
    x = torch.empty(B, L, H, device="meta")
    w, b = torch.empty(H, H, device="meta"), torch.empty(H, device="meta")
    mask = torch.empty(B, L, device="meta")
    before = dict(_build.launch_counts)
    with pytest.raises(RuntimeError, match="nvcc"):
        if wrapper == "attention_block":
            attention_block(x, mask > 0, mask, w, b, w, b, w, b, w, b, num_heads=2)
        elif wrapper == "attention_block_fused":
            attention_block_fused(x, mask, None, w, b, w, b, w, b, w, b, 2, True, False)
        else:
            q = torch.empty(B, L * 2, 64, device="meta")
            merged_attention(q, q, q, None, torch.empty(B, L * 2, device="meta"), num_heads=2)
    assert _build.launch_counts == before


def test_block_and_core_take_the_plain_version_on_cpu():
    """Kernels 4 and 5 on CPU tensors: the plain versions' values, no launch
    counted."""
    from zett_tpu_torch.ops import attention_block_reference, merged_attention_reference

    before = dict(_build.launch_counts)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, 128, generator=g)
    mask = torch.rand(3, 4, generator=g) > 0.3
    kb = torch.randn(3, 4, generator=g)
    wb = [torch.randn(128, 128, generator=g) * 0.05 if i % 2 == 0 else torch.zeros(128)
          for i in range(8)]
    assert torch.equal(attention_block(x, mask, kb, *wb, num_heads=2),
                       attention_block_reference(x, mask, kb, *wb, 2))
    q = torch.randn(3, 8, 64, generator=g)
    km = mask.repeat_interleave(2, -1)
    assert torch.equal(merged_attention(q, q, q, km, None, num_heads=2),
                       merged_attention_reference(q, q, q, km, None, num_heads=2))
    assert _build.launch_counts == before


def test_viterbi_dp_raises_off_the_cpu(no_built_kernels):
    """Kernel 6: a tensor that is not on the CPU goes for the kernel and,
    with none built, raises without counting a launch."""
    S = torch.empty(4, 8, 16, device="meta")
    I = torch.empty(4, 8, 16, dtype=torch.int32, device="meta")
    before = dict(_build.launch_counts)
    with pytest.raises(RuntimeError, match="nvcc"):
        viterbi_dp(S, I)
    assert _build.launch_counts == before


def test_viterbi_dp_takes_the_plain_version_on_cpu():
    g = torch.Generator().manual_seed(0)
    S = torch.randn(6, 9, 4, generator=g)
    I = torch.randint(0, 50, (6, 9, 4), generator=g, dtype=torch.int32)
    before = dict(_build.launch_counts)
    got, want = viterbi_dp(S, I), viterbi_dp_plain(S, I)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _build.launch_counts == before


def test_fused_viterbi_raises_off_the_cpu(no_built_kernels):
    """The span scores fused into kernel 6: a tensor that is not on the CPU
    goes for the kernel and, with none built, raises without counting a
    launch."""
    rows = torch.empty(4, 8, dtype=torch.int32, device="meta")
    lens = torch.empty(4, dtype=torch.int32, device="meta")
    table = torch.empty(64, 16, dtype=torch.int32, device="meta")
    before = dict(_build.launch_counts)
    with pytest.raises(RuntimeError, match="nvcc"):
        viterbi_spans_dp(rows, lens, table, 0, -20.0, 8)
    assert _build.launch_counts == before


def test_fused_viterbi_takes_the_plain_version_on_cpu():
    g = torch.Generator().manual_seed(0)
    rows = torch.randint(0, 256, (6, 12), generator=g, dtype=torch.int32)
    lens = torch.tensor([0, 3, 12, 7, 1, 12], dtype=torch.int32)
    table = torch.randint(-2**31, 2**31 - 1, (64, 16), generator=g, dtype=torch.int32)
    before = dict(_build.launch_counts)
    got = viterbi_spans_dp(rows, lens, table, 3, -20.0, 5)
    want = viterbi_spans_dp_plain(rows, lens, table, 3, -20.0, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _build.launch_counts == before
