"""A msgpack reader and writer for flax's checkpoint layout, in plain
Python (the GPU machine has no `msgpack` package, and the port imports no
flax).

`serialize(tree)` gives the bytes `flax.serialization.msgpack_serialize`
(and so `to_bytes`) gives for the same tree; `restore(data)` is
`flax.serialization.msgpack_restore`. The layout:

  * maps (str keys, in insertion order), str, bin, int, float (as a
    float64), nil and bool; lists and tuples read and write as arrays;
  * ext type 1, an array: the msgpack array (shape, dtype name, C-order
    bytes). numpy arrays and torch tensors are written; arrays are read
    to numpy, except `bfloat16` ones, which numpy lacks: they read to a
    torch.bfloat16 tensor, and a bfloat16 tensor writes as `bfloat16`;
  * ext type 3, a numpy scalar: the same payload of a 0-d array;
  * an array leaf of a map over MAX_CHUNK_SIZE bytes is written, and read
    back, as flax's chunked form {"__msgpack_chunked_array__": True,
    "shape": {"0": d0, ...}, "chunks": {"0": flat chunk, ...}}.
"""
from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: arrays over this many bytes are chunked
MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ write
def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _raw(x):
    """(shape, dtype name, C-order bytes as a memoryview) of an array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", memoryview(t.view(torch.int16).numpy()).cast("B")
        x = t.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of ndarrays.")
    a = np.ascontiguousarray(x).reshape(-1)
    return tuple(int(s) for s in x.shape), a.dtype.name, memoryview(a).cast("B")


def _chunk(x) -> dict:
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
            "chunks": {str(j): flat[i: i + size] for j, i in enumerate(range(0, n, size))}}


def _chunk_leaves(tree):
    """flax's `_chunk_array_leaves_in_place`, on a copy: oversized array
    leaves of maps (and an oversized top-level array) become chunked maps;
    lists are not entered."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE:
                out[k] = _chunk(v)
            elif isinstance(v, dict):
                out[k] = _chunk_leaves(v)
            else:
                out[k] = v
        return out
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _head(parts: List, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below `fix_max`, else 8-, 16- or
    32-bit lengths (`codes` for the three; None where a width is absent)."""
    if n < fix_max:
        parts.append(bytes([fix | n]))
    elif n < 0x100 and codes[0] is not None:
        parts.append(struct.pack(">BB", codes[0], n))
    elif n < 0x10000:
        parts.append(struct.pack(">BH", codes[1], n))
    else:
        parts.append(struct.pack(">BI", codes[2], n))


def _pack_int(parts: List, n: int) -> None:
    if 0 <= n < 0x80:
        parts.append(bytes([n]))
    elif -32 <= n < 0:
        parts.append(struct.pack(">b", n))
    elif n >= 0:
        for code, fmt, hi in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF), (0xCE, ">BI", 0xFFFFFFFF),
                              (0xCF, ">BQ", 0xFFFFFFFFFFFFFFFF)):
            if n <= hi:
                parts.append(struct.pack(fmt, code, n))
                return
        raise OverflowError("Integer value out of range")
    else:
        for code, fmt, lo in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000), (0xD2, ">Bi", -0x80000000),
                              (0xD3, ">Bq", -0x8000000000000000)):
            if n >= lo:
                parts.append(struct.pack(fmt, code, n))
                return
        raise OverflowError("Integer value out of range")


def _pack_bin(parts: List, data) -> None:
    _head(parts, len(data), 0, 0, (0xC4, 0xC5, 0xC6))
    parts.append(data)


def _array_payload(x) -> List:
    shape, name, data = _raw(x)
    parts: List = [b"\x93"]
    _pack(parts, list(shape))
    _pack(parts, name)
    _pack_bin(parts, data)
    return parts


def _pack_ext(parts: List, code: int, payload: List) -> None:
    n = sum(len(p) for p in payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        parts.append(struct.pack(">Bb", fixed[n], code))
    elif n < 0x100:
        parts.append(struct.pack(">BBb", 0xC7, n, code))
    elif n < 0x10000:
        parts.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        parts.append(struct.pack(">BIb", 0xC9, n, code))
    parts.extend(payload)


def _pack(parts: List, x: Any) -> None:
    if x is None:
        parts.append(b"\xc0")
    elif x is True or x is False:
        parts.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        _pack_int(parts, x)
    elif type(x) is float:
        parts.append(struct.pack(">Bd", 0xCB, x))
    elif type(x) is str:
        data = x.encode("utf-8")
        _head(parts, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        parts.append(data)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        _pack_bin(parts, x)
    elif isinstance(x, dict):
        _head(parts, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(parts, k)
            _pack(parts, v)
    elif isinstance(x, (list, tuple)):
        _head(parts, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(parts, v)
    elif _is_array(x):
        _pack_ext(parts, EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(parts, EXT_NPSCALAR, _array_payload(np.asarray(x)))
    else:
        raise TypeError(f"can not serialize {type(x).__name__!r} object")


def serialize(tree) -> bytes:
    """The msgpack bytes of a tree of maps, Python scalars, numpy arrays
    and scalars and torch tensors, as flax writes them."""
    parts: List = []
    _pack(parts, _chunk_leaves(tree))
    return b"".join(parts)


# ------------------------------------------------------------------- read
class _Reader:
    """`raw_bin`: bin values as memoryviews into the data (an array's
    payload), not copies."""

    def __init__(self, data, raw_bin: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw_bin = raw_bin

    def take(self, n: int):
        out = self.buf[self.pos: self.pos + n]
        if len(out) < n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        out = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return out[0] if len(out) == 1 else out

    def value(self):
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            data = self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]))
            return data if self.raw_bin else bytes(data)
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from(data)
        if code == EXT_NPSCALAR:
            arr = _array_from(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


def _array_from(data):
    r = _Reader(data, raw_bin=True)
    shape, name, raw = r.value()
    if not isinstance(name, str):
        name = bytes(name).decode()
    if name == "bfloat16":
        flat = np.frombuffer(raw, dtype=np.int16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(tuple(shape))
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(tuple(shape), order="C").copy()


def _unchunk(d: dict):
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_leaves(v) if isinstance(v, dict) else v for k, v in tree.items()}
    return tree


def restore(data: bytes):
    """The tree of msgpack bytes that flax (or `serialize`) wrote, with
    chunked arrays joined back."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.buf):
        raise ValueError("extra data after the msgpack object")
    return _unchunk_leaves(tree)
