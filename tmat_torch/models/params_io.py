"""Checkpoint reader and weight carry-over from the JAX package's format.

Counterpart of ``tmat_tpu/models/params_io.py::load_params``. A Flax
checkpoint is a msgpack map of the ``{"params", "batch_stats"}`` tree whose
array leaves are msgpack ext records of type 1 (ndarray) or 3 (numpy
scalar); the payload is itself msgpack: ``(shape, dtype name, C-order
bytes)`` (``flax.serialization._ndarray_to_bytes``). ``read_msgpack`` is a
small pure-Python decoder for exactly that subset, so the port needs no
``msgpack`` package. Float16- and bfloat16-stored leaves are cast up to
float32.

``from_flax_variables`` turns such a tree of numpy arrays into the port's
BN-folded UNet weights. It is the one function that carries weights
across packages; the tests use it to give both the same model.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Sequence, Tuple

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
    if "__msgpack_chunked_array__" in out:
        raise ValueError("chunked (>1 GB) array leaves are not supported")
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


def load_variables(path) -> Dict[str, Any]:
    """The ``{"params", "batch_stats"}`` tree of a Flax checkpoint file,
    with float leaves as float32 numpy arrays."""
    with open(path, "rb") as fp:
        return read_msgpack(fp.read())


def _fold_bn(kernel, bias, scale, bn_bias, mean, var, eps) -> Tuple[np.ndarray, np.ndarray]:
    """y = BN(conv(x)) as conv'(x): kernel' = kernel * s, bias' = bias * s +
    (bn_bias - mean * s), s = scale / sqrt(var + eps); in float64."""
    s = scale.astype(np.float64) / np.sqrt(var.astype(np.float64) + eps)
    k = kernel.astype(np.float64) * s
    b0 = 0.0 if bias is None else bias.astype(np.float64)
    b = b0 * s + (bn_bias.astype(np.float64) - mean.astype(np.float64) * s)
    return k.astype(np.float32), b.astype(np.float32)


def from_flax_variables(
    variables: Dict[str, Any], filter_counts: Sequence[int], eps: float = 1e-3
) -> Dict[str, Any]:
    """BN-folded UNet-Xception weights from a Flax variable tree.

    Uses the deterministic ``nn.compact`` naming of
    ``tmat_tpu.models.unet.UNetXception``: entry Conv_0 + BatchNorm_0;
    down block i = SeparableConv_{2i}, BatchNorm_{1+2i},
    SeparableConv_{2i+1}, BatchNorm_{2+2i}, residual Conv_{1+i}; up block
    j = ConvTranspose_{2j}/{2j+1} with BatchNorm_{1+2*n_down+2j}/{+1} and
    residual Conv_{1+n_down+j}; head Conv_{1+n_down+n_up}. Layouts stay
    the JAX package's (HWIO kernels, (9, C) depthwise taps, (Cin, Cout)
    pointwise), as ``tmat_tpu.ops.pallas_unet.extract_fused_params`` gives.
    """
    p = variables["params"]
    bs = variables["batch_stats"]
    f = tuple(sorted(filter_counts))
    n_down, n_up = len(f) - 1, len(f)

    def f32(a):
        return np.asarray(a, np.float32)

    def bn(i):
        return (f32(p[f"BatchNorm_{i}"]["scale"]), f32(p[f"BatchNorm_{i}"]["bias"]),
                f32(bs[f"BatchNorm_{i}"]["mean"]), f32(bs[f"BatchNorm_{i}"]["var"]))

    def conv(name):
        return f32(p[name]["kernel"]), f32(p[name]["bias"])

    out: Dict[str, Any] = {}
    k, b = _fold_bn(*conv("Conv_0"), *bn(0), eps)
    out["entry"] = {"k": k, "b": b}

    down = []
    for i in range(n_down):
        sc1 = p[f"SeparableConv_{2 * i}"]
        sc2 = p[f"SeparableConv_{2 * i + 1}"]
        w1, b1 = _fold_bn(f32(sc1["pointwise"]["kernel"])[0, 0], f32(sc1["pointwise"]["bias"]),
                          *bn(1 + 2 * i), eps)
        w2, b2 = _fold_bn(f32(sc2["pointwise"]["kernel"])[0, 0], f32(sc2["pointwise"]["bias"]),
                          *bn(2 + 2 * i), eps)
        wr, br = conv(f"Conv_{1 + i}")
        down.append({
            # depthwise kernels (3,3,1,C) -> (9,C): row k = tap (k//3, k%3)
            "dw1": np.ascontiguousarray(f32(sc1["depthwise"]["kernel"])[:, :, 0, :].reshape(9, -1)),
            "w1": w1, "b1": b1,
            "dw2": np.ascontiguousarray(f32(sc2["depthwise"]["kernel"])[:, :, 0, :].reshape(9, -1)),
            "w2": w2, "b2": b2,
            "wr": wr[0, 0], "br": br,
        })
    out["down"] = down

    ups = []
    for j in range(n_up):
        k1, bb1 = _fold_bn(*conv(f"ConvTranspose_{2 * j}"), *bn(1 + 2 * n_down + 2 * j), eps)
        k2, bb2 = _fold_bn(*conv(f"ConvTranspose_{2 * j + 1}"), *bn(2 + 2 * n_down + 2 * j), eps)
        wr, br = conv(f"Conv_{1 + n_down + j}")
        ups.append({"k1": k1, "b1": bb1, "k2": k2, "b2": bb2, "wr": wr[0, 0], "br": br})
    out["up"] = ups
    hk, hb = conv(f"Conv_{1 + n_down + n_up}")
    out["head"] = {"k": hk, "b": hb}
    return out
