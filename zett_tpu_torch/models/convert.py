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


def flax_paths(model: torch.nn.Module) -> Dict[str, tuple]:
    """torch parameter name -> (Flax path tuple, transpose): the inverse of
    ``flax_to_torch`` for a port ``Hypernet`` (``nn.Linear`` weights are
    Dense kernels, transposed; embedding tables and LayerNorm scales are
    ``embedding``/``scale``)."""
    from .hypernet import Dense, LayerNorm

    kinds = {}
    for name, mod in model.named_modules():
        if isinstance(mod, Dense):
            kinds[name] = "kernel"
        elif isinstance(mod, LayerNorm):
            kinds[name] = "scale"
        elif isinstance(mod, torch.nn.Embedding):
            kinds[name] = "embedding"
    out = {}
    for name, _ in model.named_parameters():
        mod, _, leaf = name.rpartition(".")
        transpose = False
        if leaf == "weight" and mod in kinds:
            leaf = kinds[mod]
            transpose = leaf == "kernel"
        parts = mod.split(".") if mod else []
        path, i = [], 0
        while i < len(parts):
            if parts[i] == "layers" and path == ["encoder"]:
                path.append(f"layer_{parts[i + 1]}")
                i += 2
                continue
            path.append(f"layers_{parts[i]}" if parts[i].isdigit() else parts[i])
            i += 1
        out[name] = (tuple(path + [leaf]), transpose)
    return out


def torch_to_flax(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """A port ``Hypernet``'s parameters keyed by "/"-joined Flax path, as
    float32 numpy arrays (the layout of a checkpoint's ``params.npz``)."""
    paths = flax_paths(model)
    flat = {}
    for name, p in model.named_parameters():
        path, transpose = paths[name]
        value = p.detach().float().cpu()
        flat["/".join(path)] = (value.t() if transpose else value).contiguous().numpy()
    return flat
