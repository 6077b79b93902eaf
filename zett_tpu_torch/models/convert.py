"""Flax parameter tree -> the port's ``Hypernet`` state dict.

Keys are the "/"-joined Flax paths, as ``flax.traverse_util.flatten_dict(
params, sep="/")`` gives them (the layout of a checkpoint's ``params.npz``).
Dense kernels (in, out) become ``nn.Linear`` weights (out, in); embedding
tables and LayerNorm scales become ``weight``; ``layers_N`` of an
``nn.Sequential`` becomes ``N`` and the encoder's ``layer_N`` becomes
``layers.N``. Values keep their dtype; bfloat16 leaves (numpy arrays of the
``bfloat16`` extension dtype) become torch bfloat16.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def _to_tensor(v: np.ndarray) -> torch.Tensor:
    if v.dtype.name == "bfloat16":
        return torch.from_numpy(np.asarray(v, dtype=np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(v, copy=True, order="C"))


def flax_to_torch(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        parts = path.split("/")
        mods = []
        for p in parts[:-1]:
            m = re.fullmatch(r"(layers?)_(\d+)", p)
            if m is None:
                mods.append(p)
            elif m.group(1) == "layer":
                mods += ["layers", m.group(2)]
            else:
                mods.append(m.group(2))
        leaf = parts[-1]
        value = np.asarray(value)
        if leaf == "kernel":
            leaf, value = "weight", value.T
        elif leaf in ("embedding", "scale"):
            leaf = "weight"
        sd[".".join(mods + [leaf])] = _to_tensor(value)
    return sd
