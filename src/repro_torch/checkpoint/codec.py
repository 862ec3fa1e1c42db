"""The msgpack subset that checkpoints are written in.

The port's own encoder and decoder for what a checkpoint holds: maps with
str keys, lists, tuples, str, bytes (bin), ints from −2^63 to 2^64 − 1,
floats (always float64), bool and None. ``packb(doc)`` gives the bytes of
``msgpack.packb(doc, use_bin_type=True)`` (the smallest int form, keys
in insertion order, a tuple as an array), so each package reads the
other's checkpoints; ``unpackb`` reads what ``packb`` writes (and float32
too), arrays as lists, as ``msgpack.unpackb(data, raw=False)`` does.
"""
from __future__ import annotations

import struct


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for tag, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                return bytes((tag,)) + struct.pack(fmt, n)
    else:
        for tag, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)),
                              (0xD3, ">q", -(1 << 63))):
            if n >= low:
                return bytes((tag,)) + struct.pack(fmt, n)
    raise OverflowError(f"int {n} does not fit in 64 bits")


def _head(n: int, fix: int, fix_max: int, tags) -> bytes:
    """Header of a str / bin / array / map of length ``n``: the fix form
    (``fix | n`` up to ``fix_max``, where the type has one) or the first
    of the 8-, 16- and 32-bit forms that fits."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"),
                             (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < top:
            return bytes((tag,)) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit in 32 bits")


def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(int(obj)))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_head(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(_head(len(raw), None, 0, (0xC4, 0xC5, 0xC6)) + raw)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset above."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LEN = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
        0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
        0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
        0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(buf: bytes, i: int):
    b = buf[i]
    i += 1
    if b < 0x80:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if b in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[b], i
    if b in _FIXED:
        fmt = _FIXED[b]
        n = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + n
    if 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b <= 0x9F:
        kind, n = "array", b & 0x0F
    elif 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif b in _LEN:
        kind, fmt = _LEN[b]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
    if kind in ("str", "bin"):
        raw = bytes(buf[i:i + n])
        if len(raw) != n:
            raise ValueError("truncated msgpack data")
        return (raw.decode("utf-8") if kind == "str" else raw), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            x, i = _unpack(buf, i)
            out.append(x)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"map key of type {type(k).__name__}")
        out[k], i = _unpack(buf, i)
    return out, i


def unpackb(data: bytes):
    """``msgpack.unpackb(data, raw=False)`` for the subset above."""
    try:
        obj, end = _unpack(data, 0)
    except (IndexError, struct.error) as err:
        raise ValueError(f"truncated msgpack data: {err}") from err
    if end != len(data):
        raise ValueError(f"{len(data) - end} extra bytes after the "
                         f"msgpack object")
    return obj
