"""The bytes ``flax.serialization.to_bytes`` writes and ``from_bytes``
reads, without ``flax`` or ``msgpack`` (the card's machine has neither):
MessagePack maps with string keys, lists, scalars, and numpy arrays as
ExtType 1 holding the packed triple (shape, dtype name, C-order buffer);
numpy scalars as ExtType 3, the same triple of a 0-d array.

``to_bytes`` picks the shortest header for every value, as
``msgpack.packb(..., use_bin_type=True)`` does, so a tree in the same key
order gives the same bytes as Flax. Arrays of 2**30 bytes or more, which
Flax splits into chunks, are refused.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_MAX_ARRAY_BYTES = 2 ** 30


def _sized(out: bytearray, n: int, small: int, small_max: int,
           codes) -> None:
    """A header of ``n`` items: ``small | n`` up to ``small_max``, else the
    first of ``codes`` (8-, 16- or 32-bit lengths) that holds ``n``; a
    ``None`` code is skipped."""
    if small is not None and n <= small_max:
        out.append(small | n)
        return
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: {n} items is too many")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    fmts = ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"), (0xcf, ">Q")) \
        if v > 0 else ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"), (0xd3, ">q"))
    for code, fmt in fmts:
        bits = 8 * struct.calcsize(fmt)
        if (v < 1 << bits) if v > 0 else (v >= -(1 << (bits - 1))):
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"msgpack: integer {v} out of range")


def _array_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not "
                         "serialisable")
    if a.nbytes >= _MAX_ARRAY_BYTES:
        raise ValueError(f"msgpack: an array of {a.nbytes} bytes would be "
                         "chunked by Flax; not supported")
    return to_bytes([list(a.shape), a.dtype.name, a.tobytes("C")])


def _pack(out: bytearray, v: Any) -> None:
    if v is None:
        out.append(0xc0)
    elif v is True or v is False:
        out.append(0xc3 if v else 0xc2)
    elif isinstance(v, np.ndarray) or isinstance(v, np.generic):
        data = _array_bytes(np.asarray(v))
        kind = _EXT_NDARRAY if isinstance(v, np.ndarray) else _EXT_NPSCALAR
        n = len(data)
        fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if n in fixed:
            out.append(fixed[n])
        else:
            _sized(out, n, None, 0, (0xc7, 0xc8, 0xc9))
        out.append(kind)
        out += data
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xcb)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _sized(out, len(raw), 0xa0, 31, (0xd9, 0xda, 0xdb))
        out += raw
    elif isinstance(v, (bytes, bytearray)):
        _sized(out, len(v), None, 0, (0xc4, 0xc5, 0xc6))
        out += v
    elif isinstance(v, (list, tuple)):
        _sized(out, len(v), 0x90, 15, (None, 0xdc, 0xdd))
        for x in v:
            _pack(out, x)
    elif isinstance(v, dict):
        _sized(out, len(v), 0x80, 15, (None, 0xde, 0xdf))
        for k, x in v.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: map keys must be str, not {k!r}")
            _pack(out, k)
            _pack(out, x)
    else:
        raise TypeError(f"msgpack: cannot serialise {type(v).__name__}")


def to_bytes(tree: Any) -> bytes:
    """``tree`` (dicts with str keys, lists, numpy arrays and scalars,
    Python scalars, str, bytes) as MessagePack bytes."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, kind: int, payload: bytes):
        if kind not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ExtType {kind}")
        shape, dtype, buf = from_bytes(payload)
        a = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        return a if kind == _EXT_NDARRAY else a[()]

    def value(self):
        c = self.take(1)[0]
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.value() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return self.take(c & 0x1f).decode("utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        lengths = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B",
                   0xda: ">H", 0xdb: ">I"}
        if c in lengths:
            raw = self.take(self.unpack(lengths[c]))
            return raw.decode("utf-8") if c >= 0xd9 else raw
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if c in numbers:
            return self.unpack(numbers[c])
        if c in (0xdc, 0xdd):
            n = self.unpack(">H" if c == 0xdc else ">I")
            return [self.value() for _ in range(n)]
        if c in (0xde, 0xdf):
            return self.map(self.unpack(">H" if c == 0xde else ">I"))
        fixed = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if c in fixed:
            kind = self.unpack(">b")
            return self.ext(kind, self.take(fixed[c]))
        if c in (0xc7, 0xc8, 0xc9):
            n = self.unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[c])
            kind = self.unpack(">b")
            return self.ext(kind, self.take(n))
        raise ValueError(f"msgpack: unknown type byte 0x{c:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def from_bytes(data: bytes) -> Any:
    """The tree ``to_bytes`` (or ``flax.serialization.to_bytes``) wrote:
    numpy arrays for ExtType 1, numpy scalars for ExtType 3."""
    r = _Reader(bytes(data))
    v = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes")
    return v
