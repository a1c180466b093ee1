"""Binary wire codec — Python twin of ``native/wire.h``.

The C++ coordination core and Python speak the same compact TLV encoding
(the protobuf analogue for the reference's ``proto/torchft.proto``). Keep the
two implementations in sync.

Python values map as::

    int        <-> I64          float      <-> F64
    bool       <-> BOOL         str        <-> STR
    bytes      <-> BYTES        list       <-> LIST
    dict       <-> MAP          None       <-> NONE
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

_I64 = 1
_F64 = 2
_BOOL = 3
_STR = 4
_BYTES = 5
_LIST = 6
_MAP = 7
_NONE = 8


def encode(v: Any) -> bytes:
    out = bytearray()
    _encode(v, out)
    return bytes(out)


def _encode(v: Any, out: bytearray) -> None:
    # NOTE: bool before int — bool is an int subclass.
    if v is None:
        out.append(_NONE)
    elif isinstance(v, bool):
        out.append(_BOOL)
        out.append(1 if v else 0)
    elif isinstance(v, int):
        out.append(_I64)
        out += struct.pack("<q", v)
    elif isinstance(v, float):
        out.append(_F64)
        out += struct.pack("<d", v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out.append(_STR)
        out += struct.pack("<I", len(b))
        out += b
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        out.append(_BYTES)
        out += struct.pack("<I", len(b))
        out += b
    elif isinstance(v, (list, tuple)):
        out.append(_LIST)
        out += struct.pack("<I", len(v))
        for e in v:
            _encode(e, out)
    elif isinstance(v, dict):
        out.append(_MAP)
        out += struct.pack("<I", len(v))
        # Sorted keys to match C++ std::map ordering (determinism only;
        # decoding does not depend on order).
        for k in sorted(v.keys()):
            kb = k.encode("utf-8")
            out += struct.pack("<H", len(kb))
            out += kb
            _encode(v[k], out)
    else:
        raise TypeError(f"cannot encode {type(v)}")


def decode(buf: bytes) -> Any:
    v, _ = _decode(memoryview(buf), 0)
    return v


def _decode(buf: memoryview, off: int) -> Tuple[Any, int]:
    tag = buf[off]
    off += 1
    if tag == _NONE:
        return None, off
    if tag == _I64:
        return struct.unpack_from("<q", buf, off)[0], off + 8
    if tag == _F64:
        return struct.unpack_from("<d", buf, off)[0], off + 8
    if tag == _BOOL:
        return buf[off] != 0, off + 1
    if tag == _STR:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        return bytes(buf[off : off + n]).decode("utf-8"), off + n
    if tag == _BYTES:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        return bytes(buf[off : off + n]), off + n
    if tag == _LIST:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        lst = []
        for _ in range(n):
            e, off = _decode(buf, off)
            lst.append(e)
        return lst, off
    if tag == _MAP:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        d = {}
        for _ in range(n):
            (klen,) = struct.unpack_from("<H", buf, off)
            off += 2
            k = bytes(buf[off : off + klen]).decode("utf-8")
            off += klen
            d[k], off = _decode(buf, off)
        return d, off
    raise ValueError(f"bad wire tag {tag} at offset {off - 1}")
