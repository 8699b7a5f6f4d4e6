"""A msgpack decoder and encoder for the checkpoints the JAX package
writes.

The JAX package saves its checkpoints with ``flax.serialization``: a
msgpack map of maps whose leaves are numpy arrays, each packed as ext
type 1 holding a nested msgpack array (shape, dtype name, raw C-order
bytes).  The card's machine has no ``msgpack`` package, so the port reads
and writes that format itself, in pure Python.

The subset decoded: maps, arrays, str and bin, ints, floats, nil, bool and
ext type 1 (into numpy arrays of numpy's own dtypes).  Any other ext
code, any other dtype (bfloat16) and flax's chunked-array form raise
``ValueError``.  ``packb`` writes the subset flax writes (maps keyed by
str, arrays, ints, floats, nil, bool, str, bin and numpy arrays as ext
type 1) in the bytes ``msgpack.packb`` gives: the shortest form of every
int and length, floats as float64, maps in their insertion order.
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


def _head(out: list, n: int, fix: int, fix_max: int, forms) -> None:
    """The header of a str, bin, array or map of length ``n``: the fix
    form below ``fix_max``, else the shortest of ``forms`` ((type byte,
    length bytes), ...)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for t, nbytes in forms:
        if n < 1 << (8 * nbytes):
            out.append(bytes([t]) + n.to_bytes(nbytes, "big"))
            return
    raise ValueError(f"msgpack length {n} is too large")


_INTS = ((0xcc, 0xd0, 1), (0xcd, 0xd1, 2), (0xce, 0xd2, 4), (0xcf, 0xd3, 8))


def _int(out: list, v: int) -> None:
    if -32 <= v < 128:                       # positive / negative fixint
        out.append(v.to_bytes(1, "big", signed=True))
        return
    for ut, st, n in _INTS:
        if 0 <= v < 1 << (8 * n):
            out.append(bytes([ut]) + v.to_bytes(n, "big"))
            return
        if -(1 << (8 * n - 1)) <= v < 0:
            out.append(bytes([st]) + v.to_bytes(n, "big", signed=True))
            return
    raise ValueError(f"int {v} does not fit in msgpack")


def _ext_ndarray(out: list, a: np.ndarray) -> None:
    if a.dtype.name not in DTYPES:
        raise ValueError(f"array dtype {a.dtype.name!r} is not supported")
    data = packb([list(a.shape), a.dtype.name, a.tobytes("C")])
    n = len(data)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        out.append(bytes([fixext[n]]))
    else:
        _head(out, n, None, 0, ((0xc7, 1), (0xc8, 2), (0xc9, 4)))
    out.append(bytes([EXT_NDARRAY]))
    out.append(data)


def _pack(out: list, obj) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        _int(out, obj)
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _head(out, len(data), 0xa0, 32, ((0xd9, 1), (0xda, 2), (0xdb, 4)))
        out.append(data)
    elif type(obj) is bytes:
        _head(out, len(obj), None, 0, ((0xc4, 1), (0xc5, 2), (0xc6, 4)))
        out.append(obj)
    elif type(obj) in (list, tuple):
        _head(out, len(obj), 0x90, 16, ((0xdc, 2), (0xdd, 4)))
        for v in obj:
            _pack(out, v)
    elif type(obj) is dict:
        _head(out, len(obj), 0x80, 16, ((0xde, 2), (0xdf, 4)))
        for k, v in obj.items():
            if type(k) is not str:
                raise ValueError(f"map key {k!r} is not a str")
            _pack(out, k)
            _pack(out, v)
    elif type(obj) is np.ndarray:
        _ext_ndarray(out, obj)
    else:
        raise ValueError(f"cannot pack a {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode ``obj`` (dicts keyed by str, lists, str, bytes, ints,
    floats, None, bools and numpy arrays) as one msgpack object, as
    ``flax.serialization.msgpack_serialize`` does."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)
