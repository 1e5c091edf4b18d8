"""Minimal pure-Python reader for Nikon ND2 (chunk format v3); the port's
copy of ``tmat_tpu/core/nd2.py`` (numpy and struct only).

The reference loads .nd2 via aicsimageio[nd2] (helper.py:23-95,
setup.py:64); that backend is not bundled in this environment, so this
module implements the subset of the ND2 container needed by the tools:
single-position Z stacks (optionally multi-component), pixel calibration,
and Z spacing.

Format (as implemented by the open-source nd2/nd2reader projects):

- The file is a sequence of chunks. Chunk header (16 bytes, little
  endian): u32 magic 0x0ABECEDA, u32 name_length, u64 data_length;
  followed by `name_length` bytes of ASCII name (ends with '!') and
  `data_length` bytes of payload.
- The last 40 bytes of the file are the 32-byte signature
  b"ND2 FILEMAP SIGNATURE NAME 0001!" followed by a u64 offset to the
  chunk-map chunk. The chunk map's payload is a repetition of
  [name bytes through '!'][u64 offset][u64 length], terminated by an
  entry whose name is the filemap signature itself.
- Image frames live in chunks named "ImageDataSeq|<n>!": a u64 (f8)
  acquisition timestamp followed by interleaved pixel data
  (height x width x components) of the dtype given by the attributes.
- Metadata chunks ("ImageAttributesLV!", "ImageMetadataSeqLV|0!") hold a
  serialized "lite variant" tag tree: each item is u8 type, u8 name char
  count, UTF-16LE name (null-terminated), then a type-dependent value:
    1 -> u8 bool, 2 -> i32, 3 -> u32, 5 -> u64, 6 -> f64,
    8 -> UTF-16LE string (double-null terminated),
    9 -> u64 byte count + raw bytes,
    11 -> u32 child item count + u64 payload byte count + payload.
  Keys used here: uiWidth, uiHeight, uiComp, uiBpcInMemory,
  uiSequenceCount (attributes); dCalibration (µm/px), dZStep (µm)
  (per-sequence metadata).

Validated against synthetic fixtures written by tests (a real Nikon
corpus is unavailable offline); an installed `nd2` package, when present,
is preferred by core.io's loader.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

CHUNK_MAGIC = 0x0ABECEDA
_CHUNK_HEADER = struct.Struct("<IIQ")
FILEMAP_SIGNATURE = b"ND2 FILEMAP SIGNATURE NAME 0001!"
FILE_SIGNATURE_NAME = b"ND2 FILE SIGNATURE CHUNK NAME01!"


class ND2ParseError(ValueError):
    pass


def _read_chunk(buf: bytes, offset: int) -> Tuple[bytes, bytes]:
    """Chunk at `offset` -> (name, payload)."""
    if offset + 16 > len(buf):
        raise ND2ParseError(f"chunk header out of bounds at {offset}")
    magic, name_len, data_len = _CHUNK_HEADER.unpack_from(buf, offset)
    if magic != CHUNK_MAGIC:
        raise ND2ParseError(f"bad chunk magic {magic:#x} at offset {offset}")
    name_start = offset + 16
    data_start = name_start + name_len
    name = buf[name_start:data_start].rstrip(b"\x00")
    return name, buf[data_start : data_start + data_len]


def read_chunkmap(buf: bytes) -> Dict[bytes, Tuple[int, int]]:
    """Parse the trailing filemap into {chunk name: (offset, length)}."""
    if len(buf) < 40 or buf[-40:-8] != FILEMAP_SIGNATURE:
        raise ND2ParseError("missing ND2 filemap signature (not an ND2 v3 file?)")
    (map_offset,) = struct.unpack("<Q", buf[-8:])
    name, payload = _read_chunk(buf, map_offset)
    if not name.startswith(FILEMAP_SIGNATURE[:-1]):
        raise ND2ParseError(f"filemap chunk has unexpected name {name!r}")
    entries: Dict[bytes, Tuple[int, int]] = {}
    pos = 0
    while pos < len(payload):
        bang = payload.find(b"!", pos)
        if bang < 0:
            break
        entry_name = payload[pos : bang + 1]
        pos = bang + 1
        if entry_name == FILEMAP_SIGNATURE:
            break
        if pos + 16 > len(payload):
            raise ND2ParseError(f"truncated filemap entry for {entry_name!r}")
        offset, length = struct.unpack_from("<QQ", payload, pos)
        pos += 16
        entries[entry_name] = (offset, length)
    return entries


# --------------------------------------------------------------------------
# "Lite variant" metadata tag tree
# --------------------------------------------------------------------------


def parse_lv(payload: bytes, count: Optional[int] = None) -> Dict[str, Any]:
    """Parse a serialized lite-variant tag tree into a dict."""
    out: Dict[str, Any] = {}
    pos = 0
    parsed = 0
    while pos < len(payload) and (count is None or parsed < count):
        dtype = payload[pos]
        name_chars = payload[pos + 1]
        pos += 2
        raw_name = payload[pos : pos + 2 * name_chars]
        pos += 2 * name_chars
        name = raw_name.decode("utf-16-le").rstrip("\x00")
        value: Any
        if dtype == 1:
            value = bool(payload[pos])
            pos += 1
        elif dtype == 2:
            (value,) = struct.unpack_from("<i", payload, pos)
            pos += 4
        elif dtype == 3:
            (value,) = struct.unpack_from("<I", payload, pos)
            pos += 4
        elif dtype == 5:
            (value,) = struct.unpack_from("<Q", payload, pos)
            pos += 8
        elif dtype == 6:
            (value,) = struct.unpack_from("<d", payload, pos)
            pos += 8
        elif dtype == 8:
            end = payload.find(b"\x00\x00", pos)
            # align the double-null terminator to a UTF-16 boundary
            while end > pos and (end - pos) % 2:
                end = payload.find(b"\x00\x00", end + 1)
            if end < 0:
                raise ND2ParseError(f"unterminated string value for {name}")
            value = payload[pos:end].decode("utf-16-le")
            pos = end + 2
        elif dtype == 9:
            (blen,) = struct.unpack_from("<Q", payload, pos)
            pos += 8
            value = payload[pos : pos + blen]
            pos += blen
        elif dtype == 11:
            child_count, byte_len = struct.unpack_from("<IQ", payload, pos)
            pos += 12
            value = parse_lv(payload[pos : pos + byte_len], child_count)
            pos += byte_len
        else:
            raise ND2ParseError(f"unsupported LV type {dtype} for {name!r}")
        out[name] = value
        parsed += 1
    return out


def _find_key(tree: Any, key: str) -> Optional[Any]:
    """Depth-first search for `key` anywhere in a nested LV dict."""
    if isinstance(tree, dict):
        if key in tree:
            return tree[key]
        for v in tree.values():
            found = _find_key(v, key)
            if found is not None:
                return found
    return None


# --------------------------------------------------------------------------
# File-level reader
# --------------------------------------------------------------------------


class ND2Reader:
    """Array + calibration access over one .nd2 file (read fully into
    memory; tmat stacks are tens-to-hundreds of MB)."""

    def __init__(self, path):
        self._buf = Path(path).read_bytes()
        name, _ = _read_chunk(self._buf, 0)
        if name != FILE_SIGNATURE_NAME:
            raise ND2ParseError(f"not an ND2 v3 file (leading chunk {name!r})")
        self._chunks = read_chunkmap(self._buf)
        attrs_entry = self._chunks.get(b"ImageAttributesLV!")
        if attrs_entry is None:
            raise ND2ParseError("ImageAttributesLV! chunk missing")
        _, payload = _read_chunk(self._buf, attrs_entry[0])
        self.attributes = parse_lv(payload)

        self.width = int(_find_key(self.attributes, "uiWidth"))
        self.height = int(_find_key(self.attributes, "uiHeight"))
        comp = _find_key(self.attributes, "uiComp")
        self.components = int(comp) if comp is not None else 1
        bpc = _find_key(self.attributes, "uiBpcInMemory")
        self.bits_per_component = int(bpc) if bpc is not None else 16
        n_seq = _find_key(self.attributes, "uiSequenceCount")
        self.n_frames = int(n_seq) if n_seq is not None else self._count_frames()

        self.metadata: Dict[str, Any] = {}
        for meta_name in (b"ImageMetadataSeqLV|0!", b"ImageMetadataLV!"):
            entry = self._chunks.get(meta_name)
            if entry is not None:
                _, payload = _read_chunk(self._buf, entry[0])
                self.metadata.update(parse_lv(payload))

    def _count_frames(self) -> int:
        n = 0
        while b"ImageDataSeq|%d!" % n in self._chunks:
            n += 1
        return n

    @property
    def dtype(self) -> np.dtype:
        if self.bits_per_component <= 8:
            return np.dtype("<u1")
        if self.bits_per_component <= 16:
            return np.dtype("<u2")
        return np.dtype("<f4")

    def pixel_sizes(self) -> Dict[str, Optional[float]]:
        """{'X','Y','Z'} physical pixel sizes in µm (None when absent)."""
        cal = _find_key(self.metadata, "dCalibration")
        zstep = _find_key(self.metadata, "dZStep")
        xy = float(cal) if cal else None
        return {"X": xy, "Y": xy, "Z": float(zstep) if zstep else None}

    def frame(self, index: int) -> np.ndarray:
        """(Y, X, C) pixel array of sequence frame `index`."""
        entry = self._chunks.get(b"ImageDataSeq|%d!" % index)
        if entry is None:
            raise ND2ParseError(f"frame {index} not present")
        _, payload = _read_chunk(self._buf, entry[0])
        pixels = payload[8:]  # skip the f8 acquisition timestamp
        n_expected = self.height * self.width * self.components
        arr = np.frombuffer(pixels, dtype=self.dtype, count=n_expected)
        return arr.reshape(self.height, self.width, self.components)

    def asarray(self) -> np.ndarray:
        """(S, C, Y, X): all sequence frames; S is Z for Z-stack files."""
        frames = [self.frame(i) for i in range(self.n_frames)]
        stack = np.stack(frames)  # (S, Y, X, C)
        return np.moveaxis(stack, -1, 1)


def read_nd2(path) -> Tuple[np.ndarray, Dict[str, Optional[float]]]:
    """Load an .nd2 file -> ((S, C, Y, X) array, pixel sizes in µm)."""
    reader = ND2Reader(path)
    return reader.asarray(), reader.pixel_sizes()
