"""serde_json float parsing, so tokenizer.json Unigram scores round-trip
byte-identically with the JAX package and with HF ``tokenizers``.

HF loads tokenizer.json through Rust's serde_json, whose default f64 parsing
computes fl(fl(significand) * 10^k) instead of the correctly rounded
conversion Python's json performs; ~25% of real Unigram scores differ by one
ulp between the two. Scores are canonicalized through this emulation when a
model is built (counterpart of ``zett_tpu/tokenization/jsonfloat.py``, without
its optional C++ fast path).
"""

from __future__ import annotations

import re
from typing import List, Sequence

# serde_json's POW10 table entries are the f64 literals 1e0..1e308 (nearest
# doubles). Python float("1eK") is correctly rounded -> identical values.
_POW10 = [float(f"1e{k}") for k in range(309)]

_NUM = re.compile(r"^(\d+)(?:\.(\d+))?(?:[eE]([+-]?\d+))?$")


class SerdeFloat(float):
    """A float already parsed from its raw JSON decimal bytes through
    `serde_f64`; `serde_canon` passes such values through unchanged."""

    __slots__ = ()


def serde_parse_float(s: str) -> float:
    """json.loads `parse_float` hook: parse the raw decimal string the way
    serde_json does and mark the result as already canonical."""
    return SerdeFloat(serde_f64(s))


def serde_f64(s) -> float:
    """Parse a JSON number the way serde_json's default f64 path does.
    Accepts a decimal string or a number (uses its shortest float repr)."""
    if isinstance(s, (int, float)):
        s = repr(float(s))
    s = s.strip()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    m = _NUM.match(s)
    if m is None:  # Infinity/NaN etc. — not produced by either serializer
        return -float(s) if neg else float(s)
    digits = m.group(1) + (m.group(2) or "")
    exponent = (int(m.group(3)) if m.group(3) else 0) - len(m.group(2) or "")
    sig = int(digits)
    if sig >= 1 << 64:  # serde takes a slower (correct) path
        return -float(s) if neg else float(s)
    f = float(sig)  # rounds when sig > 2^53, exactly like `significand as f64`
    if exponent >= 0:
        f *= _POW10[min(exponent, 308)]
    else:
        f /= _POW10[min(-exponent, 308)]
    return -f if neg else f


def serde_canon(scores: Sequence[float]) -> List[float]:
    """Canonicalize a score list to the values HF would hold after reading
    our serialization."""
    if scores and all(isinstance(s, SerdeFloat) for s in scores):
        return [float(s) for s in scores]
    return [serde_f64(s) for s in scores]
