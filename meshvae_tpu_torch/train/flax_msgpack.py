"""Reader of the bytes ``flax.serialization.to_bytes`` writes (the JAX
package's ``.msgpack`` checkpoints), with no flax, msgpack or JAX.

``restore(data)`` returns what ``flax.serialization.msgpack_restore``
returns: nested dicts (string keys), lists, Python scalars, and numpy
arrays and scalars. It decodes the msgpack subset that flax emits:

  * maps (fixmap, map16, map32), arrays (fixarray, array16, array32),
    strings (fixstr, str8/16/32, as str), bin8/16/32 (as bytes), nil, bool,
    the positive and negative fixints, uint8-64, int8-64, float32/64;
  * ext types (fixext1-16, ext8/16/32) 1 (an ndarray: a nested msgpack
    triple of shape, dtype name and C-order bytes) and 3 (a numpy scalar,
    the same triple of shape ()).

dtype ``bfloat16`` (which numpy lacks) is read as uint16 and returned as a
``torch.bfloat16`` tensor. Anything else (ext type 2, complex; a reserved
type byte; flax's chunked form of leaves over 1 GiB) raises ValueError
naming it.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SIZED = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xDC: ("array", 2), 0xDD: ("array", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4),
          0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4)}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"truncated msgpack data at byte {self.pos}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unsigned(self, width: int) -> int:
        return int.from_bytes(self.take(width), "big")

    def value(self):
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _NUMBERS:
            fmt = _NUMBERS[b]
            return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
        if b in _FIXEXT:
            code = struct.unpack(">b", self.take(1))[0]
            return _ext(code, bytes(self.take(_FIXEXT[b])), at)
        if b in _SIZED:
            kind, width = _SIZED[b]
            n = self.unsigned(width)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            code = struct.unpack(">b", self.take(1))[0]
            return _ext(code, bytes(self.take(n)), at)
        raise ValueError(f"msgpack type byte 0x{b:02x} at byte {at} is not "
                         "one that flax writes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("flax's chunked array leaves (over 1 GiB) are "
                             "not read")
        return out


def _ndarray(payload: bytes):
    """flax's ndarray payload: msgpack (shape, dtype name, C bytes)."""
    shape, name, buf = _Reader(payload).value()
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(int(d) for d in shape)  # msgpack gives a list
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, payload: bytes, at: int):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"msgpack ext type {code} at byte {at} is not read "
                     "(flax ext types 1 ndarray and 3 numpy scalar are)")


def restore(data: bytes):
    """The tree that flax.serialization.msgpack_restore(data) returns."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         "msgpack value")
    return out


def load(path: str):
    with open(path, "rb") as fp:
        return restore(fp.read())
