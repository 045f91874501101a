"""Flax's msgpack weight files, read and written without msgpack or flax.

The JAX package stores model variables with ``flax.serialization.to_bytes``
(its zoo's ``save_variables``, ``cli/import_weights.py``,
``cli/adversarial_train.py``).  The machines the port runs on need not have
the ``msgpack`` package, so this module carries its own codec for the subset
that ``to_bytes`` writes:

- maps, arrays (as lists), str, bin, nil, bool, ints and floats;
- ext type 1, an ndarray: the msgpack array ``(shape, dtype name, raw
  C-order bytes)``; ext type 3, a numpy scalar, packed the same way;
- the ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``
  map that ``to_bytes`` writes for an array above ``MAX_CHUNK_SIZE`` bytes.

Any other ext type raises with its code, as does an unknown dtype name.
Arrays come back as numpy arrays, but ``bfloat16`` (which numpy lacks): its
raw 16-bit words come back as a torch ``bfloat16`` tensor.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
# flax.serialization.MAX_CHUNK_SIZE: arrays above it are written in chunks
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
_NUMPY_DTYPES = frozenset({"bool", "float16", "float32", "float64", "int8", "int16",
                           "int32", "int64", "uint8", "uint16", "uint32", "uint64"})


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack data truncated at byte {self.pos}")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-width codes -> struct format
_INTS = {0xcc: "B", 0xcd: "H", 0xce: "I", 0xcf: "Q", 0xd0: "b", 0xd1: "h", 0xd2: "i", 0xd3: "q"}
_LENGTHS = {"bin": {0xc4: "B", 0xc5: "H", 0xc6: "I"},
            "str": {0xd9: "B", 0xda: "H", 0xdb: "I"},
            "array": {0xdc: "H", 0xdd: "I"},
            "map": {0xde: "H", 0xdf: "I"},
            "ext": {0xc7: "B", 0xc8: "H", 0xc9: "I"}}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _read(r: _Reader) -> Any:
    code = r.unpack("B")
    if code <= 0x7f:
        return code
    if code >= 0xe0:
        return code - 0x100
    if 0x80 <= code <= 0x8f:
        return _read_map(r, code & 0x0f)
    if 0x90 <= code <= 0x9f:
        return [_read(r) for _ in range(code & 0x0f)]
    if 0xa0 <= code <= 0xbf:
        return r.take(code & 0x1f).decode("utf-8")
    if code == 0xc0:
        return None
    if code in (0xc2, 0xc3):
        return code == 0xc3
    if code == 0xca:
        return r.unpack("f")
    if code == 0xcb:
        return r.unpack("d")
    if code in _INTS:
        return r.unpack(_INTS[code])
    if code in _LENGTHS["bin"]:
        return r.take(r.unpack(_LENGTHS["bin"][code]))
    if code in _LENGTHS["str"]:
        return r.take(r.unpack(_LENGTHS["str"][code])).decode("utf-8")
    if code in _LENGTHS["array"]:
        return [_read(r) for _ in range(r.unpack(_LENGTHS["array"][code]))]
    if code in _LENGTHS["map"]:
        return _read_map(r, r.unpack(_LENGTHS["map"][code]))
    if code in _FIXEXT or code in _LENGTHS["ext"]:
        n = _FIXEXT[code] if code in _FIXEXT else r.unpack(_LENGTHS["ext"][code])
        ext_type = r.unpack("b")
        return _ext(ext_type, r.take(n))
    raise ValueError(f"msgpack type byte 0x{code:02x} at byte {r.pos - 1} is not "
                     "one that flax.serialization writes")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    return out


def _array_from_bytes(data: bytes):
    r = _Reader(data)
    shape, name, buf = _read(r)
    if isinstance(name, bytes):
        name = name.decode("utf-8")
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        words = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    if name not in _NUMPY_DTYPES:
        raise ValueError(f"unknown dtype '{name}' in a Flax msgpack array")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(ext_type: int, data: bytes):
    if ext_type == EXT_NDARRAY:
        return _array_from_bytes(data)
    if ext_type == EXT_NPSCALAR:
        return _array_from_bytes(data)[()]
    raise ValueError(f"msgpack ext type {ext_type} is not one this reader knows "
                     f"(ndarray {EXT_NDARRAY}, numpy scalar {EXT_NPSCALAR})")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED) is True:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if any(isinstance(c, torch.Tensor) for c in chunks):
            return torch.cat([torch.as_tensor(c).reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: bytes -> a tree of dicts with
    array leaves (chunked arrays joined again)."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the msgpack object")
    return _unchunk(tree)


# ---------------------------------------------------------------------------
# encoding (msgpack-python's choices: the smallest form of each value)
# ---------------------------------------------------------------------------

def _sized(out: bytearray, n: int, small: tuple[int, int] | None, forms) -> None:
    """A length header: the fixed form ``(base, limit)`` when ``n`` fits,
    else the first of ``forms`` ((code, struct format, limit)) that does."""
    if small is not None and n < small[1]:
        out.append(small[0] | n)
        return
    for code, fmt, limit in forms:
        if n < limit:
            out.append(code)
            out += struct.pack(">" + fmt, n)
            return
    raise ValueError(f"msgpack object of {n} elements or bytes is too large")


_U8, _U16, _U32 = 1 << 8, 1 << 16, 1 << 32


def _write_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xff)
    elif v >= 0:
        for code, fmt, limit in ((0xcc, "B", _U8), (0xcd, "H", _U16), (0xce, "I", _U32),
                                 (0xcf, "Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(">" + fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, limit in ((0xd0, "b", 1 << 7), (0xd1, "h", 1 << 15),
                                 (0xd2, "i", 1 << 31), (0xd3, "q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(">" + fmt, v)
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _write_ext(out: bytearray, ext_type: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _sized(out, n, None, ((0xc7, "B", _U8), (0xc8, "H", _U16), (0xc9, "I", _U32)))
    out += struct.pack(">b", ext_type)
    out += data


def _array_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.name not in _NUMPY_DTYPES:
        raise ValueError(f"cannot write dtype {arr.dtype} to a Flax msgpack file")
    out = bytearray()
    _write(out, [list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes()])
    return bytes(out)


def _write(out: bytearray, v: Any) -> None:
    if isinstance(v, bool):
        out.append(0xc3 if v else 0xc2)
    elif isinstance(v, np.ndarray):
        _write_ext(out, EXT_NDARRAY, _array_bytes(v))
    elif isinstance(v, np.generic):
        _write_ext(out, EXT_NPSCALAR, _array_bytes(np.asarray(v)))
    elif isinstance(v, int):
        _write_int(out, v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _sized(out, len(b), (0xa0, 32), ((0xd9, "B", _U8), (0xda, "H", _U16), (0xdb, "I", _U32)))
        out += b
    elif isinstance(v, (bytes, bytearray)):
        _sized(out, len(v), None, ((0xc4, "B", _U8), (0xc5, "H", _U16), (0xc6, "I", _U32)))
        out += v
    elif isinstance(v, (list, tuple)):
        _sized(out, len(v), (0x90, 16), ((0xdc, "H", _U16), (0xdd, "I", _U32)))
        for item in v:
            _write(out, item)
    elif isinstance(v, dict):
        _sized(out, len(v), (0x80, 16), ((0xde, "H", _U16), (0xdf, "I", _U32)))
        for key, item in v.items():
            _write(out, str(key))
            _write(out, item)
    else:
        raise TypeError(f"cannot write {type(v).__name__} to a Flax msgpack file")


def _chunk(tree):
    """Maps in sorted key order, as the JAX zoo's files have them (its
    ``device_get`` flattens and rebuilds the tree); arrays above
    ``MAX_CHUNK_SIZE`` bytes -> flax's chunked-array map."""
    if isinstance(tree, dict):
        return {k: _chunk(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        per = max(1, int(MAX_CHUNK_SIZE / tree.dtype.itemsize))
        flat = tree.reshape(-1)
        chunks = [flat[i:i + per] for i in range(0, flat.size, per)]
        return {CHUNKED: True, "shape": {str(i): s for i, s in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def to_bytes(tree: dict) -> bytes:
    """``flax.serialization.to_bytes`` of a tree of dicts with numpy leaves."""
    out = bytearray()
    _write(out, _chunk(tree))
    return bytes(out)


def read_variables(path: str | Path) -> dict:
    """A Flax msgpack file -> its variable tree."""
    return msgpack_restore(Path(path).read_bytes())


def save_variables(variables: dict, path: str | Path) -> None:
    """Write a variable tree as the JAX zoo's ``save_variables`` does."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(to_bytes(variables))
