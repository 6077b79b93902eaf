"""Flax parameter tree -> the port's ``Hypernet`` state dict, and the
backbones' HF key <-> Flax path tables.

Keys are the "/"-joined Flax paths, as ``flax.traverse_util.flatten_dict(
params, sep="/")`` gives them (the layout of a checkpoint's ``params.npz``).
Dense kernels (in, out) become ``nn.Linear`` weights (out, in); embedding
tables and LayerNorm scales become ``weight``; ``layers_N`` of an
``nn.Sequential`` becomes ``N`` and the encoder's ``layer_N`` becomes
``layers.N``. Values keep their dtype; bfloat16 leaves (numpy arrays of the
``bfloat16`` extension dtype, or ``torch.bfloat16`` tensors as
``msgpack_io`` reads them) become torch bfloat16. ``flax_to_torch`` also
takes a nested tree (``reference_io.load_reference_hypernet``'s), and a
``device`` to build the tensors on (the copy to it first, the kernels'
transposes there). ``read_npz`` maps an uncompressed ``params.npz`` (what
``np.savez`` writes) without copying it.
"""

from __future__ import annotations

import io
import mmap
import re
import struct
import warnings
import zipfile
from typing import Dict

import numpy as np
import torch


def _to_tensor(v, device=None) -> torch.Tensor:
    """A contiguous tensor of its own with ``v``'s values, on ``device``
    (default the CPU). A transposed kernel is laid out by torch's blocked
    copy, many times faster than numpy's at a (4096, 8192) kernel; with a
    device, by the device after the copy to it."""
    if isinstance(v, torch.Tensor):
        t = v
    elif v.dtype.name == "bfloat16":
        t = torch.from_numpy(np.asarray(v, dtype=np.float32)).to(torch.bfloat16)
    elif device is not None:
        with warnings.catch_warnings():  # read-only memory (a map): only read here
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(v)
    else:
        if not v.flags.writeable:
            v = np.array(v)  # torch holds no read-only memory; the layout is kept
        t = torch.from_numpy(v)
    if device is not None and t.device != torch.device(device):
        t = t.to(device)
        return t if t.is_contiguous() else t.contiguous()
    return t.contiguous() if not t.is_contiguous() else t.clone()


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """The arrays of an uncompressed ``.npz`` file (``np.savez``), each a
    read-only view of one memory map of the file: no copy, where
    ``np.load`` reads every member through ``zipfile`` (about 0.6 GB/s).
    A compressed member raises."""
    out = {}
    with open(path, "rb") as f:
        whole = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        with zipfile.ZipFile(f) as zf:
            infos = zf.infolist()
    view = memoryview(whole)
    for info in infos:
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"{path}: {info.filename} is compressed; read it with np.load")
        h = info.header_offset
        name_len, extra_len = struct.unpack("<HH", view[h + 26:h + 30])
        start = h + 30 + name_len + extra_len
        member = view[start:start + info.file_size]
        header = io.BytesIO(member[:4096])
        version = np.lib.format.read_magic(header)
        read = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}[version]
        shape, fortran, dtype = read(header)
        count = int(np.prod(shape))
        a = np.frombuffer(member, dtype=dtype, count=count, offset=header.tell())
        name = info.filename[:-4] if info.filename.endswith(".npy") else info.filename
        out[name] = a.reshape(shape, order="F" if fortran else "C")
    return out


def flatten(tree, prefix=()) -> dict:
    """A nested dict's leaves by their paths, tuples of str keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def unflatten(flat: dict) -> dict:
    """``flatten``'s inverse."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = v
    return tree


def flax_to_torch(flat: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """"/"-joined Flax paths (or a nested tree) -> the port's state dict,
    its tensors on ``device`` (default the CPU)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in flatten(flat).items():
        parts = "/".join(path).split("/")
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
        if not isinstance(value, torch.Tensor):
            value = np.asarray(value)
        if leaf == "kernel":
            leaf, value = "weight", value.T
        elif leaf in ("embedding", "scale"):
            leaf = "weight"
        sd[".".join(mods + [leaf])] = _to_tensor(value, device)
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


# ------------------------------------------------------------- the backbones
def gpt2_flax_path(key: str) -> tuple:
    """HF GPT-2 key -> the JAX package's Flax path (``loader.convert_gpt2``)."""
    parts = key.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}
    if parts[1] in ("wte", "wpe"):
        return ("transformer", parts[1], "embedding")
    if parts[1] == "ln_f":
        return ("transformer", "ln_f", "scale" if parts[2] == "weight" else "bias")
    base = ("transformer", f"h_{parts[2]}")
    rest = parts[3:]
    if rest[0] in ("ln_1", "ln_2"):
        return base + (rest[0], "scale" if rest[1] == "weight" else "bias")
    if rest[0] == "attn":
        return base + ("attn", rest[1], leaf[rest[2]])
    return base + (rest[1], leaf[rest[2]])  # mlp.c_fc / mlp.c_proj


def llama_flax_path(key: str) -> tuple:
    """HF Llama-family key -> the JAX package's Flax path
    (``loader.convert_llama``, loader.py:125-153)."""
    if key == "model.embed_tokens.weight":
        return ("model", "embed_tokens", "embedding")
    if key == "model.norm.weight":
        return ("model", "norm", "weight")
    if key == "lm_head.weight":
        return ("lm_head", "kernel")
    parts = key.split(".")
    base = ("model", f"layers_{parts[2]}")
    rest = parts[3:]
    if rest[0].endswith("layernorm"):
        return base + (rest[0], "weight")
    # self_attn / mlp projections
    return base + (rest[0], rest[1], "kernel" if rest[2] == "weight" else "bias")


_ROBERTA_LAYER = {
    "attention.self.query": "query", "attention.self.key": "key",
    "attention.self.value": "value", "attention.output.dense": "attention_output",
    "attention.output.LayerNorm": "attention_ln", "intermediate.dense": "intermediate",
    "output.dense": "output", "output.LayerNorm": "output_ln",
}


def roberta_flax_path(key: str) -> tuple:
    """HF RoBERTa key -> the JAX package's Flax path
    (``loader.convert_roberta``, loader.py:154-208)."""
    parts = key.split(".")
    if key == "lm_head.bias":
        return ("lm_head_bias",)
    if parts[0] == "lm_head":  # dense, layer_norm
        scope = {"dense": "lm_head_dense", "layer_norm": "lm_head_ln"}[parts[1]]
        leaf = {"dense": "kernel", "layer_norm": "scale"}[parts[1]]
        return (scope, leaf if parts[2] == "weight" else "bias")
    if parts[1] == "embeddings":
        if parts[2] == "LayerNorm":
            return ("roberta", "embeddings_ln", "scale" if parts[3] == "weight" else "bias")
        return ("roberta", parts[2], "embedding")
    module = _ROBERTA_LAYER[".".join(parts[4:-1])]
    leaf = parts[-1]
    if leaf == "weight":
        leaf = "scale" if module.endswith("_ln") else "kernel"
    return ("roberta", f"layer_{parts[3]}", module, leaf)


def backbone_flax_path(model_type: str, key: str) -> tuple:
    """HF key of a backbone -> its Flax path in the JAX package: the
    optimizer's labels, decay mask and leaf order read these."""
    if model_type == "gpt2":
        return gpt2_flax_path(key)
    if model_type in ("roberta", "xlm-roberta"):
        return roberta_flax_path(key)
    return llama_flax_path(key)


def backbone_transposed(model_type: str, key: str) -> bool:
    """Whether the HF weight ``key`` is held transposed against its Flax
    kernel: the Llama family's and RoBERTa's ``nn.Linear`` weights are (out,
    in), Flax kernels (in, out); GPT-2's ``Conv1D`` weights are (in, out)
    already."""
    return model_type != "gpt2" and backbone_flax_path(model_type, key)[-1] == "kernel"


def invert_llama(flat: Dict[str, np.ndarray], tie_word_embeddings: bool) -> Dict[str, torch.Tensor]:
    """Flax Llama-family parameters ("/"-joined paths) -> the HF state dict
    (``loader.invert_llama``, loader.py:291-315): kernels (in, out) become
    (out, in) weights; a tied model's head is the embedding table."""
    sd: Dict[str, torch.Tensor] = {}
    for k, v in flat.items():
        parts = k.split("/")
        v = np.asarray(v)
        if k == "model/embed_tokens/embedding":
            sd["model.embed_tokens.weight"] = _to_tensor(v)
            if tie_word_embeddings:
                sd["lm_head.weight"] = _to_tensor(v)
        elif k == "model/norm/weight":
            sd["model.norm.weight"] = _to_tensor(v)
        elif k == "lm_head/kernel":
            sd["lm_head.weight"] = _to_tensor(v.T)
        elif parts[1].startswith("layers_"):
            i = parts[1][len("layers_"):]
            rest = parts[2:]
            if rest[0].endswith("layernorm"):
                sd[f"model.layers.{i}.{rest[0]}.weight"] = _to_tensor(v)
            else:
                name = "weight" if rest[2] == "kernel" else "bias"
                sd[f"model.layers.{i}.{rest[0]}.{rest[1]}.{name}"] = _to_tensor(
                    v.T if rest[2] == "kernel" else v)
    return sd
