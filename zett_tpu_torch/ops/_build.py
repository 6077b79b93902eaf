"""Build and bind the port's CUDA kernels, and count their launches.

Each ``zett_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface under
``build/zett_tpu_torch/`` at the root of the checkout, at first use, and
loaded with ctypes. Nothing is built or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "zett_tpu_torch")
SOURCES = ("encoder_layer", "attention_core", "attention_core_bwd", "attention_block",
           "merged_attention", "viterbi_dp")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}

# nvcc's output (ptxas's registers, shared memory and spills) of each
# library built with ``verbose``
reports: Dict[str, str] = {}

# Launches per kernel wrapper. A wrapper adds one where it launches its
# kernel on the card, and nowhere else. Each library's kernel counts under
# the library's name; the span scores fused into kernel 6's DP (a second
# entry point of viterbi_dp.cu) count under their own.
COUNTERS = SOURCES + ("viterbi_spans_dp",)
launch_counts: Dict[str, int] = {name: 0 for name in COUNTERS}


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _tool(name: str) -> Optional[str]:
    """A CUDA toolkit program: under CUDA_HOME (or /usr/local/cuda), else
    on the PATH; None where there is neither."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", name)
    return path if os.path.exists(path) else shutil.which(name)


def _nvcc() -> str:
    found = _tool("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    newest = max(
        os.path.getmtime(os.path.join(CSRC, f))
        for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )
    return os.path.getmtime(lib) < newest


def build(names: Optional[Iterable[str]] = None, verbose: bool = False) -> float:
    """Compile the named kernels (default: all) that are missing or older
    than their sources, one nvcc process per source, all started together.
    With ``verbose``, ptxas reports each kernel's resources into
    ``reports``. Returns the wall time in seconds. Raises if any compile
    fails."""
    names = [n for n in (names or SOURCES) if _stale(n)]
    t0 = time.perf_counter()
    if not names:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in names:
        tmp = _lib_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}:\n{out}")
            continue
        if verbose:
            reports[name] = out
        os.replace(tmp, _lib_path(name))
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return time.perf_counter() - t0


def sass_counts(name: str, opcodes: Iterable[str],
                function: Optional[str] = None) -> Optional[Dict[str, int]]:
    """How often each SASS opcode occurs in a built kernel library
    (``cuobjdump -sass``), or only in its kernels whose mangled name holds
    ``function``; None where the toolkit has no cuobjdump."""
    tool = _tool("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", _lib_path(name)], capture_output=True, text=True,
                          check=True).stdout
    if function is not None:
        # one section per kernel, each opened by a "Function : <mangled name>" line
        sections = re.split(r"^\s*Function : ", sass, flags=re.M)[1:]
        sass = "".join(s for s in sections if function in s.split("\n", 1)[0])
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of a kernel library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_lib_path(name))
        _LIBS[name] = lib
    return lib


def aligned16(t):
    """``t`` contiguous and 16-byte aligned, as the kernels' 16-byte loads
    (TMA, cp.async, int4) need: a copy where the storage starts off a
    16-byte boundary."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
