"""The subset of MessagePack (https://msgpack.org) that the checkpoint
format uses: maps, arrays, str, bin, int, bool and None.

``packb`` picks the shortest encoding of each value, as ``msgpack.packb``
does by default (str as str8/16/32, bytes as bin8/16/32), so both write
the same bytes; ``unpackb`` reads maps into dicts, arrays into lists, str
into str and bin into bytes, as ``msgpack.unpackb`` does by default.  The
checkpoint needs no ``msgpack`` package.
"""
from __future__ import annotations

import struct
from typing import Any

__all__ = ["packb", "unpackb"]


def _sized(out: list, n: int, fix: int, fix_max: int, wide: tuple) -> None:
    """A length header: ``fix | n`` below ``fix_max``, else the first of
    the (marker, struct format, limit) triples in ``wide`` that holds n."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
        return
    for marker, fmt, limit in wide:
        if n < limit:
            out.append(bytes((marker,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_UINT = ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
         (0xCF, ">Q", 1 << 64))
_INT = ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15), (0xD2, ">i", 1 << 31),
        (0xD3, ">q", 1 << 63))


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 128 or -32 <= obj < 0:
            out.append(struct.pack(">b" if obj < 0 else ">B", obj))
        elif obj >= 0:
            _sized(out, obj, None, 0, _UINT)
        else:
            marker, fmt, _ = next(w for w in _INT if -obj <= w[2])
            out.append(bytes((marker,)) + struct.pack(fmt, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(out, len(data), 0xA0, 32, _STR)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _sized(out, len(obj), None, 0, _BIN)
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), 0x90, 16, _ARRAY)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _sized(out, len(obj), 0x80, 16, _MAP)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# marker -> (struct format of the length or value, kind)
_WIDE = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
         0xCC: (">B", "value"), 0xCD: (">H", "value"), 0xCE: (">I", "value"),
         0xCF: (">Q", "value"), 0xD0: (">b", "value"), 0xD1: (">h", "value"),
         0xD2: (">i", "value"), 0xD3: (">q", "value"),
         0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
         0xDC: (">H", "array"), 0xDD: (">I", "array"),
         0xDE: (">H", "map"), 0xDF: (">I", "map")}


def _unpack(buf: memoryview, pos: int) -> tuple[Any, int]:
    marker = buf[pos]
    pos += 1
    if marker < 0x80:
        return marker, pos
    if marker >= 0xE0:
        return marker - 0x100, pos
    if marker in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[marker], pos
    if 0xA0 <= marker < 0xC0:
        kind, n = "str", marker & 0x1F
    elif 0x90 <= marker < 0xA0:
        kind, n = "array", marker & 0x0F
    elif 0x80 <= marker < 0x90:
        kind, n = "map", marker & 0x0F
    elif marker in _WIDE:
        fmt, kind = _WIDE[marker]
        (n,) = struct.unpack_from(fmt, buf, pos)
        pos += struct.calcsize(fmt)
        if kind == "value":
            return n, pos
    else:
        raise ValueError(f"msgpack: unsupported marker 0x{marker:02x} at {pos - 1}")
    if kind in ("str", "bin"):
        if pos + n > len(buf):
            raise ValueError("msgpack: truncated input")
        data = bytes(buf[pos:pos + n])
        return (data.decode("utf-8") if kind == "str" else data), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        out[key], pos = _unpack(buf, pos)
    return out, pos


def unpackb(data) -> Any:
    buf = memoryview(data).cast("B")
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - pos} extra bytes after the object")
    return obj
