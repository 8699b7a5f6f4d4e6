"""A msgpack decoder for the checkpoints the JAX package writes.

The JAX package saves its checkpoints with ``flax.serialization``: a
msgpack map of maps whose leaves are numpy arrays, each packed as ext
type 1 holding a nested msgpack array (shape, dtype name, raw C-order
bytes).  The card's machine has no ``msgpack`` package, so the port reads
that format itself, in pure Python.

The subset decoded: maps, arrays, str and bin, ints, floats, nil, bool and
ext type 1 (into numpy arrays of numpy's own dtypes).  Any other ext
code, any other dtype (bfloat16) and flax's chunked-array form raise
``ValueError``.
"""
from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
# numpy's own dtypes; bfloat16 is not one (flax names it, numpy knows it
# only where ml_dtypes has registered it, which the card's machine lacks)
DTYPES = frozenset(
    ["bool", "float16", "float32", "float64"]
    + [f"{u}int{n}" for u in ("", "u") for n in (8, 16, 32, 64)])

_FIXED = {   # type byte -> (struct format, size) of a number that follows
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
_STR = {0xd9: 1, 0xda: 2, 0xdb: 4}
_BIN = {0xc4: 1, 0xc5: 2, 0xc6: 4}
_ARRAY = {0xdc: 2, 0xdd: 4}
_MAP = {0xde: 2, 0xdf: 4}
_EXT = {0xc7: 1, 0xc8: 2, 0xc9: 4}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def length(self, nbytes: int) -> int:
        return struct.unpack(_LEN[nbytes], self.take(nbytes))[0]

    def obj(self):
        t = self.take(1)[0]
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return [self.obj() for _ in range(t & 0x0f)]
        if 0xa0 <= t <= 0xbf:
            return str(self.take(t & 0x1f), "utf-8")
        if t == 0xc0:
            return None
        if t in (0xc2, 0xc3):
            return t == 0xc3
        if t in _FIXED:
            fmt, n = _FIXED[t]
            return struct.unpack(fmt, self.take(n))[0]
        if t in _STR:
            return str(self.take(self.length(_STR[t])), "utf-8")
        if t in _BIN:
            return bytes(self.take(self.length(_BIN[t])))
        if t in _ARRAY:
            return [self.obj() for _ in range(self.length(_ARRAY[t]))]
        if t in _MAP:
            return self.map(self.length(_MAP[t]))
        if t in _EXT:
            n = self.length(_EXT[t])
            return self.ext(n)
        if t in _FIXEXT:
            return self.ext(_FIXEXT[t])
        raise ValueError(f"msgpack type byte 0x{t:02x} is not valid")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("flax chunked arrays are not supported")
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = self.take(n)
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not supported "
                             f"(only {EXT_NDARRAY}, a numpy array)")
        return _ndarray(bytes(payload))


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buf = unpackb(payload)
    if name not in DTYPES:
        raise ValueError(f"array dtype {name!r} is not supported")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def unpackb(data: bytes):
    """Decode one msgpack object that spans all of ``data``."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes follow the "
                         "msgpack object")
    return out


def restore(path: str):
    """The tree of a flax msgpack file: dicts, lists, scalars and numpy
    arrays (``flax.serialization.msgpack_restore`` of its bytes)."""
    with open(path, "rb") as f:
        return unpackb(f.read())
