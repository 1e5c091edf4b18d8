"""Checkpoint reader and writer, and weight carry-over, in the JAX package's format.

Counterpart of ``tmat_tpu/models/params_io.py`` (``load_params`` and
``save_params``; ``load_variables`` reads a file without a template). A Flax
checkpoint is a msgpack map of the ``{"params", "batch_stats"}`` tree whose
array leaves are msgpack ext records of type 1 (ndarray) or 3 (numpy
scalar); the payload is itself msgpack: ``(shape, dtype name, C-order
bytes)`` (``flax.serialization._ndarray_to_bytes``). ``read_msgpack`` is a
small pure-Python decoder for exactly that subset, so the port needs no
``msgpack`` package. Float16- and bfloat16-stored leaves are cast up to
float32. ``to_msgpack`` encodes a tree into the bytes that
``flax.serialization.to_bytes`` gives for it (the same msgpack forms, key
order and ext payloads), and ``save_params`` writes them to a file, with
an optional down-cast of the float leaves. Array leaves over Flax's
``MAX_CHUNK_SIZE`` (1 GiB) are written and read in Flax's chunked form
(``_chunk`` / ``_unchunk``).

``from_flax_variables`` turns such a tree of numpy arrays into the port's
BN-folded UNet weights, ``from_flax_resnet_variables`` into the
invasion classifier's. They are the functions that carry weights across
packages; the tests use them to give both the same model.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE


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


def _uint(out: bytearray, n: int, fix: int, fix_max: int, codes: Sequence[Tuple[int, str]]) -> None:
    """A msgpack length header: the fix form up to ``fix_max``, else the
    first of ``codes`` ((type byte, struct format)) whose width holds ``n``."""
    if n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


_STR = ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))
_BIN = ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I"))
_ARRAY = ((0xDC, ">H"), (0xDD, ">I"))
_MAP = ((0xDE, ">H"), (0xDF, ">I"))
_FIXEXT_CODES = {size: code for code, size in _FIXEXT.items()}


def _pack_int(out: bytearray, n: int) -> None:
    """msgpack's smallest form of an integer, as msgpack-python packs it."""
    if 0 <= n < 128 or -32 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
        return
    forms = (((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if n >= 0 else
             ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")))
    for code, fmt in forms:
        bits = 8 * struct.calcsize(fmt)
        if (n < 1 << bits) if n >= 0 else (n >= -(1 << (bits - 1))):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_str(out: bytearray, s: str) -> None:
    data = s.encode("utf-8")
    _uint(out, len(data), 0xA0, 31, _STR)
    out += data


def _pack_bin(out: bytearray, data: bytes) -> None:
    _uint(out, len(data), 0xC4, -1, _BIN)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """``flax.serialization._ndarray_to_bytes``: msgpack of (shape, dtype
    name, C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    out = bytearray()
    _uint(out, 3, 0x90, 15, _ARRAY)
    _uint(out, arr.ndim, 0x90, 15, _ARRAY)
    for dim in arr.shape:
        _pack_int(out, int(dim))
    _pack_str(out, arr.dtype.name)
    _pack_bin(out, arr.tobytes("C"))
    return bytes(out)


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    if n in _FIXEXT_CODES:
        out.append(_FIXEXT_CODES[n])
    else:
        _uint(out, n, 0xC7, -1, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
    out += struct.pack(">b", code)
    out += payload


def _chunked(arr: np.ndarray) -> Dict[str, Any]:
    """``flax.serialization._chunk``: an array over ``_MAX_CHUNK_SIZE`` bytes
    as a map of its shape and its flat chunks."""
    size = max(1, int(_MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {"__msgpack_chunked_array__": True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j: j + size] for i, j in enumerate(range(0, flat.size, size))}}


def _pack(out: bytearray, obj: Any) -> None:
    # the order of the checks is msgpack's with strict types: a numpy
    # scalar (np.float64 is a float) is an ext record, a bool no integer
    if isinstance(obj, dict):
        _uint(out, len(obj), 0x80, 15, _MAP)
        for key, value in obj.items():
            _pack_str(out, str(key))
            _pack(out, value)
    elif isinstance(obj, (list, tuple)):  # Flax's state dict of a sequence
        _pack(out, {str(i): v for i, v in enumerate(obj)})
    elif isinstance(obj, torch.Tensor):
        _pack(out, obj.detach().cpu().numpy())
    elif isinstance(obj, np.ndarray) and obj.size * obj.dtype.itemsize > _MAX_CHUNK_SIZE:
        _pack(out, _chunked(obj))
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        _pack_str(out, obj)
    elif isinstance(obj, bytes):
        _pack_bin(out, obj)
    else:
        raise TypeError(f"cannot serialize a {type(obj).__name__} leaf")


def to_msgpack(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for ``tree``: a
    nested dict (keys as strings, in their order) of numpy arrays, numpy
    scalars, torch tensors (as numpy arrays) and Python numbers."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def _cast_floats(tree: Any, dtype) -> Any:
    """``jax.tree.map`` of ``tmat_tpu``'s ``save_params`` down-cast: float
    leaves to ``dtype``, other leaves to numpy arrays; dict keys sorted, as
    a JAX tree map rebuilds them."""
    if isinstance(tree, dict):
        return {k: _cast_floats(tree[k], dtype) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    arr = np.asarray(tree)
    return arr.astype(dtype) if np.issubdtype(arr.dtype, np.floating) else arr


def save_params(path, variables: Any, dtype=None) -> None:
    """Write the tree ``variables`` as a Flax checkpoint; ``dtype=np.float16``
    stores the float leaves at half precision (the reader casts them back)."""
    if dtype is not None:
        variables = _cast_floats(variables, np.dtype(dtype))
    data = to_msgpack(variables)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fp:
        fp.write(data)


def load_variables(path) -> Dict[str, Any]:
    """The ``{"params", "batch_stats"}`` tree of a Flax checkpoint file,
    with float leaves as float32 numpy arrays."""
    with open(path, "rb") as fp:
        return read_msgpack(fp.read())


def _restore(template: Any, state: Any, path: str) -> Any:
    if isinstance(template, dict):
        if not isinstance(state, dict):
            raise ValueError(f"{path or 'the root'}: the template has a dict, the checkpoint a leaf")
        missing = sorted(set(map(str, template)) - set(state))
        if missing:
            raise ValueError(f"{path or 'the root'}: the checkpoint lacks the template's keys {missing[:6]}")
        return {k: _restore(v, state[str(k)], f"{path}/{k}") for k, v in template.items()}
    if isinstance(state, dict):
        raise ValueError(f"{path}: the template has a leaf, the checkpoint a dict")
    if not np.issubdtype(np.asarray(state).dtype, np.floating):
        return state
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.asarray(state)).to(template.device, template.dtype)
    return np.asarray(state, np.asarray(template).dtype)


def load_params(path, template: Any) -> Any:
    """A Flax checkpoint in the structure of ``template``, a nested dict such
    as ``load_variables`` or ``layers.flax_variables`` gives. Every key of the
    template must be in the file, each at the same depth; keys that only the
    file has are dropped (``flax.serialization.from_bytes``). Float leaves
    take their template leaf's dtype: a numpy leaf gives a numpy array, a
    tensor leaf (bfloat16 too) a tensor on its device; other leaves are
    returned as read."""
    return _restore(template, load_variables(path), "")


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


RESNET_BN_EPS = 1.001e-5


def from_flax_resnet_variables(variables: Dict[str, Any],
                               eps: float = RESNET_BN_EPS) -> Dict[str, np.ndarray]:
    """The ``state_dict`` of ``tmat_torch.models.resnet.ResNet50TL`` (as
    float32 numpy arrays) from the Flax ``ResNet50TL`` variable tree: each
    ``{name}_conv`` with its ``{name}_bn`` folded in float64 into one
    convolution, HWIO kernels to OIHW; the dense head ``(C, n)`` to a
    Linear ``(n, C)``. The blocks present in the tree are the ones kept."""
    p = variables["params"]["base_model"]
    bs = variables["batch_stats"]["base_model"]

    def f32(a):
        return np.asarray(a, np.float32)

    def folded(tree_p, tree_bs, conv, bn):
        k, b = _fold_bn(f32(tree_p[conv]["kernel"]), f32(tree_p[conv]["bias"]),
                        f32(tree_p[bn]["scale"]), f32(tree_p[bn]["bias"]),
                        f32(tree_bs[bn]["mean"]), f32(tree_bs[bn]["var"]), eps)
        return np.ascontiguousarray(k.transpose(3, 2, 0, 1)), b

    out: Dict[str, np.ndarray] = {}
    out["base.conv1.weight"], out["base.conv1.bias"] = folded(p, bs, "conv1_conv", "conv1_bn")
    for name in sorted(k for k in p if "_block" in k):
        for i in range(4):
            if f"{i}_conv" not in p[name]:
                continue  # an identity shortcut has no 0_conv
            w, b = folded(p[name], bs[name], f"{i}_conv", f"{i}_bn")
            out[f"base.blocks.{name}.conv{i}.weight"] = w
            out[f"base.blocks.{name}.conv{i}.bias"] = b
    head = variables["params"]["head"]
    out["head.weight"] = np.ascontiguousarray(f32(head["kernel"]).T)
    out["head.bias"] = f32(head["bias"])
    return out
