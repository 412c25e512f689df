"""The msgpack subset of the FL checkpoint files, written and read
without the `msgpack` package.

`packb` emits what ``msgpack.packb(obj, use_bin_type=True)`` emits for
the trees `ckpt._encode` builds, byte for byte: nil, bool, int of every
width and sign in the smallest format that holds it (a non-negative int
never takes a signed format), float64 for every Python float, str
(fixstr, str8/16/32), bin8/16/32 for bytes, and array and map (fix, 16
and 32 bits) in insertion order. `unpackb` reads what
``msgpack.unpackb(raw=True, strict_map_key=False)`` reads for such
files: str comes back as bytes, arrays as lists, and map keys may be of
any hashable type.
"""

from __future__ import annotations

import struct

_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def packb(obj) -> bytes:
    """Encode ``obj`` (None, bool, int, float, str, bytes-like, dict,
    list or tuple, nested) as msgpack."""
    return b"".join(pack_parts(obj))


def pack_parts(obj) -> list:
    """`packb`'s bytes as a list of parts, for a writer that hands them to
    ``file.writelines`` instead of joining a large payload into one more
    copy. A memoryview part is the caller's buffer, not a copy."""
    out: list = []
    _pack(obj, out)
    return out


def _head(out: list, n: int, fix: int | None, fix_max: int,
          codes: tuple[int, int, int]) -> None:
    """A length header: the fix form up to ``fix_max``, then 8-, 16- and
    32-bit lengths (a ``None`` code skips that width)."""
    if fix is not None and n <= fix_max:
        out.append(_U8.pack(fix | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(_U8.pack(codes[0]) + _U8.pack(n))
    elif n <= 0xFFFF:
        out.append(_U8.pack(codes[1]) + _U16.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(_U8.pack(codes[2]) + _U32.pack(n))
    else:
        raise ValueError(f"msgpack: length {n} does not fit 32 bits")


def _pack_int(obj: int, out: list) -> None:
    if 0 <= obj < 0x80 or -0x20 <= obj < 0:
        out.append(_I8.pack(obj) if obj < 0 else _U8.pack(obj))
    elif obj >= 0:
        for code, fmt, top in ((0xCC, _U8, 0xFF), (0xCD, _U16, 0xFFFF),
                               (0xCE, _U32, 0xFFFFFFFF),
                               (0xCF, _U64, 0xFFFFFFFFFFFFFFFF)):
            if obj <= top:
                out.append(_U8.pack(code) + fmt.pack(obj))
                return
        raise OverflowError("Integer value out of range")
    else:
        for code, fmt, low in ((0xD0, _I8, -0x80), (0xD1, _I16, -0x8000),
                               (0xD2, _I32, -0x80000000),
                               (0xD3, _I64, -0x8000000000000000)):
            if obj >= low:
                out.append(_U8.pack(code) + fmt.pack(obj))
                return
        raise OverflowError("Integer value out of range")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 0x0F, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 0x0F, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, memoryview):
        _head(out, obj.nbytes, None, 0, (0xC4, 0xC5, 0xC6))
        out.append(obj)
    else:
        raise TypeError(f"msgpack: can not serialize {type(obj).__name__!r} "
                        "object")


def unpackb(data) -> object:
    """Decode one msgpack object that fills ``data`` exactly."""
    view = memoryview(data)
    obj, pos = _unpack(view, 0)
    if pos != len(view):
        raise ValueError(f"msgpack: {len(view) - pos} bytes of extra data")
    return obj


def _take(view: memoryview, pos: int, n: int) -> tuple[memoryview, int]:
    end = pos + n
    if end > len(view):
        raise ValueError("msgpack: unexpected end of data")
    return view[pos:end], end


def _num(view, pos, fmt: struct.Struct):
    raw, pos = _take(view, pos, fmt.size)
    return fmt.unpack(raw)[0], pos


def _unpack(view: memoryview, pos: int):
    code, pos = _num(view, pos, _U8)
    if code <= 0x7F:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0x80 <= code <= 0x8F:
        return _unpack_map(view, pos, code & 0x0F)
    if 0x90 <= code <= 0x9F:
        return _unpack_array(view, pos, code & 0x0F)
    if 0xA0 <= code <= 0xBF:
        raw, pos = _take(view, pos, code & 0x1F)
        return bytes(raw), pos
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _SIZED:
        fmt, kind = _SIZED[code]
        n, pos = _num(view, pos, fmt)
        if kind == "map":
            return _unpack_map(view, pos, n)
        if kind == "array":
            return _unpack_array(view, pos, n)
        raw, pos = _take(view, pos, n)
        return bytes(raw), pos
    if code in _SCALARS:
        return _num(view, pos, _SCALARS[code])
    raise ValueError(f"msgpack: unsupported type byte 0x{code:02x}")


def _unpack_array(view, pos, n):
    items = []
    for _ in range(n):
        v, pos = _unpack(view, pos)
        items.append(v)
    return items, pos


def _unpack_map(view, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _unpack(view, pos)
        v, pos = _unpack(view, pos)
        out[k] = v
    return out, pos


#: Formats with a length field: type byte -> (length format, kind); bin
#: and str both decode to bytes, as ``unpackb(raw=True)`` returns them.
_SIZED = {0xC4: (_U8, "bytes"), 0xC5: (_U16, "bytes"), 0xC6: (_U32, "bytes"),
          0xD9: (_U8, "bytes"), 0xDA: (_U16, "bytes"), 0xDB: (_U32, "bytes"),
          0xDC: (_U16, "array"), 0xDD: (_U32, "array"),
          0xDE: (_U16, "map"), 0xDF: (_U32, "map")}
#: Fixed-size numbers: type byte -> value format.
_SCALARS = {0xCA: _F32, 0xCB: _F64, 0xCC: _U8, 0xCD: _U16, 0xCE: _U32,
            0xCF: _U64, 0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64}
