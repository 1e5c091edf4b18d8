"""Flax checkpoint reader of the benchmark's plain reference.

Frozen copy of the pure-Python msgpack decoder of
``tmat_torch/models/params_io.py`` (``read_msgpack``), taken when the
benchmark was written, so that the reference reads the shipped weights
itself: the chip has no ``msgpack`` package, and the reference takes
nothing that the program has made. A Flax checkpoint is a msgpack map of
the ``{"params", "batch_stats"}`` tree whose array leaves are ext records
of type 1 (ndarray) or 3 (numpy scalar) holding ``(shape, dtype name,
C-order bytes)``; float16 and bfloat16 leaves are cast up to float32.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Sequence

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LEN = {  # type byte -> (kind, length format)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _decode(r: _Reader) -> Any:
    t = r.unpack(">B")
    if t <= 0x7F:
        return t
    if t >= 0xE0:
        return t - 0x100
    if 0x80 <= t <= 0x8F:
        return _container(r, "map", t & 0x0F)
    if 0x90 <= t <= 0x9F:
        return _container(r, "array", t & 0x0F)
    if 0xA0 <= t <= 0xBF:
        return bytes(r.take(t & 0x1F)).decode("utf-8")
    if t == 0xC0:
        return None
    if t in (0xC2, 0xC3):
        return t == 0xC3
    if t in _FIXED:
        return r.unpack(_FIXED[t])
    if t in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(_FIXEXT[t])))
    if t in _LEN:
        kind, fmt = _LEN[t]
        n = r.unpack(fmt)
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return bytes(r.take(n)).decode("utf-8")
        if kind == "ext":
            code = r.unpack(">b")
            return _ext(code, bytes(r.take(n)))
        return _container(r, kind, n)
    raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")


def _container(r: _Reader, kind: str, n: int):
    if kind == "array":
        return [_decode(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    if "__msgpack_chunked_array__" in out:  # flax.serialization._unchunk
        shape = tuple(out["shape"][str(i)] for i in range(len(out["shape"])))
        chunks = [out["chunks"][str(i)] for i in range(len(out["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return out


def _dtype_array(buffer: bytes, name: str, shape: Sequence[int]) -> np.ndarray:
    if name == "bfloat16":
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    arr = np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)
    if arr.dtype == np.float16:
        return arr.astype(np.float32)
    return arr.copy()


def _ext(code: int, payload: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, name, buffer = _decode(_Reader(payload))
    if isinstance(name, bytes):
        name = name.decode("ascii")
    arr = _dtype_array(buffer, name, tuple(shape))
    return arr if code == _EXT_NDARRAY else arr[()]


def read_msgpack(data: bytes) -> Any:
    """Decode Flax msgpack bytes into a tree of dicts and numpy arrays."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def read_flax(path) -> Any:
    """The variable tree of the Flax checkpoint at ``path``."""
    return read_msgpack(Path(path).read_bytes())
