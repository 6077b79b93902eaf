"""A reader of flax's msgpack files, standard library, numpy and torch only.

Counterpart of ``flax.serialization.msgpack_restore``, which the JAX
package calls to read a reference-format hypernet's ``flax_model.msgpack``
(``zett_tpu/models/reference_io.py:369-372``). The card's machine has
neither ``flax`` nor ``msgpack``.

The msgpack types a flax file uses are read in every width of the
specification: nil, bool, positive and negative fixint, (u)int 8/16/32/64,
float 32/64, str, bin and ext 8/16/32, fixstr/fixarray/fixmap, array and
map 16/32, fixext 1-16. Maps become dicts, arrays lists, str a Python str
(keys included), bin bytes. Flax's ext types (``_MsgpackExtType``):

- 1, ndarray: a msgpack array (shape, dtype name, raw C-order bytes);
- 2, native_complex: a msgpack array (real, imag), a Python complex;
- 3, npscalar: an ndarray payload of shape (), a numpy scalar.

Arrays over flax's ``MAX_CHUNK_SIZE`` are written as
``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks": {"0":
.., ..}}`` maps of flat chunks; they are joined back to one array.

Supported dtypes: float32, float16, bfloat16, int32, int64, bool (and the
other numpy dtypes numpy names). numpy has no bfloat16 and the card's
machine has no ``ml_dtypes``, so a bfloat16 leaf comes back as a
``torch.bfloat16`` tensor holding the same bits; every other leaf is a numpy
array. The file is read once into a writable buffer and every leaf is a
view of it (``memoryview`` slices, no copy per leaf); a chunked array is
the one copy of its chunks.
"""

from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

_FIXED = {  # first byte -> (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack: data ends inside an object")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def length(self, n: int) -> int:
        return self.unpack(_LENGTH[n], n)

    def value(self, raw: bool = False) -> Any:
        """The next object. ``raw``: as flax reads an ndarray payload, str
        as bytes and bin as a view of the buffer."""
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F, raw)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32: a view inside an ndarray payload
            data = self.take(self.length(1 << (b - 0xC4)))
            return data if raw else bytes(data)
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            n = self.length(1 << (b - 0xC7))
            return self.ext(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return self.string(self.length(1 << (b - 0xD9)), raw)
        if b in (0xDC, 0xDD):
            return self.array(self.length(2 if b == 0xDC else 4), raw)
        if b in (0xDE, 0xDF):
            return self.map(self.length(2 if b == 0xDE else 4), raw)
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at {self.pos - 1}")

    def string(self, n: int, raw: bool):
        data = self.take(n)
        return bytes(data) if raw else str(data, "utf-8")

    def array(self, n: int, raw: bool) -> list:
        return [self.value(raw) for _ in range(n)]

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            key = self.value(raw)
            out[key] = self.value(raw)
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            arr = _ndarray(payload)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_COMPLEX:
            real, imag = _Reader(payload).value()
            return complex(real, imag)
        raise ValueError(f"msgpack: unknown ext type {code}")


def _ndarray(payload: memoryview):
    """flax ``_ndarray_from_bytes``: (shape, dtype name, bytes), the strings
    read raw as flax reads them."""
    shape, name, data = _Reader(payload).value(raw=True)
    name = bytes(name).decode()
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        if not len(data):
            return torch.empty(shape, dtype=torch.bfloat16)
        if data.readonly:  # torch holds no read-only memory
            data = bytearray(data)
        return torch.frombuffer(data, dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(int(d["shape"][str(i)]) for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _restore_chunks(tree):
    """flax ``_unchunk_array_leaves_in_place``: every chunked-array map in
    a tree of maps becomes its array."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                tree[k] = _restore_chunks(v)
    return tree


def msgpack_restore(data) -> Any:
    """The tree of a flax msgpack buffer (bytes, bytearray or memoryview;
    the leaves are views of it)."""
    reader = _Reader(memoryview(data).cast("B"))
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes after the object")
    return _restore_chunks(tree)


def read_msgpack(path: str) -> Any:
    """``msgpack_restore`` of a file, read once into a writable buffer."""
    with open(path, "rb") as f:
        data = bytearray(os.fstat(f.fileno()).st_size)
        n = f.readinto(data)
    if n != len(data):
        raise ValueError(f"{path}: read {n} of {len(data)} bytes")
    return msgpack_restore(data)
