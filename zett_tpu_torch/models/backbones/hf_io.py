"""HF checkpoint directories: a hand-written safetensors reader and writer,
``pytorch_model.bin``, and ``config.json``.

Counterpart of ``load_hf_state_dict`` / ``save_hf_model`` in
``zett_tpu/models/backbones/loader.py``. The safetensors format: an unsigned
64-bit little-endian header length, a JSON header mapping each tensor name
to its dtype, shape and [begin, end) byte offsets into the data that
follows, then the raw little-endian data. Supported dtypes: F32, BF16, F16,
I64.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import torch

_DTYPES = {
    "F32": torch.float32,
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "I64": torch.int64,
}
_CODES = {v: k for k, v in _DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The file's tensors. They are views of one buffer that holds the data
    as read (a tensor whose start is not a multiple of its element size is
    copied out)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    raw = torch.frombuffer(data, dtype=torch.uint8) if data else None
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        shape = info["shape"]
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = raw[begin:end]
        if begin % dtype.itemsize:
            flat = flat.clone()
        out[name] = flat.view(dtype).reshape(shape)
    return out


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    header = {}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype not in _CODES:
            raise ValueError(f"tensor {name} has unsupported dtype {t.dtype}")
        blob = t.reshape(-1).view(torch.uint8).numpy()  # written from its memory
        header[name] = {
            "dtype": _CODES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + len(blob)],
        }
        blobs.append(blob)
        offset += len(blob)
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * ((-len(raw)) % 8)  # data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for blob in blobs:
            f.write(blob)


def load_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A HF checkpoint directory as a flat name -> CPU tensor dict."""
    index_st = os.path.join(path, "model.safetensors.index.json")
    single_st = os.path.join(path, "model.safetensors")
    torch_bin = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(index_st):
        with open(index_st) as f:
            index = json.load(f)
        out: Dict[str, torch.Tensor] = {}
        for shard in sorted(set(index["weight_map"].values())):
            out.update(load_safetensors(os.path.join(path, shard)))
        return out
    if os.path.exists(single_st):
        return load_safetensors(single_st)
    if os.path.exists(torch_bin):
        return torch.load(torch_bin, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"No checkpoint found in {path}")


def save_hf_model(path: str, state_dict: Dict[str, torch.Tensor],
                  config_json: Optional[dict] = None) -> None:
    """Write model.safetensors (+ config.json) into a HF-format directory."""
    os.makedirs(path, exist_ok=True)
    save_safetensors(state_dict, os.path.join(path, "model.safetensors"))
    if config_json is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config_json, f, indent=2)
