"""Minimal protobuf wire-format codec (dependency-free).

Copy of ``paddle_lite_tpu/formats/protowire.py``, behaviour for behaviour:
the fluid ``__model__`` protobuf (``lite/model_parser/pb/*``, compiled
from ``framework.proto`` in the reference) is parsed directly, so neither
package depends on generated protobuf classes.  Only the encodings fluid
descs use are implemented: varint (incl. bool/enum), fixed32 (float),
fixed64 (double), and length-delimited (strings, sub-messages, packed
repeated scalars).

Wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple, Union

WIRE_VARINT = 0
WIRE_64BIT = 1
WIRE_BYTES = 2
WIRE_32BIT = 5


class WireError(ValueError):
    pass


# ---- decoding ---------------------------------------------------------------

def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Returns (value, new_pos). Values are decoded unsigned (callers apply
    two's-complement reinterpretation for signed int32/int64 fields)."""
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise WireError("varint too long")


def to_signed(v: int, bits: int = 64) -> int:
    """Two's-complement reinterpretation of an unsigned varint."""
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield (field_number, wire_type, raw_value) over a message body.

    raw_value is an unsigned int for varint/fixed types and bytes for
    length-delimited fields.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == WIRE_VARINT:
            val, pos = read_varint(buf, pos)
        elif wire == WIRE_64BIT:
            if pos + 8 > n:
                raise WireError("truncated fixed64")
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wire == WIRE_BYTES:
            size, pos = read_varint(buf, pos)
            if pos + size > n:
                raise WireError("truncated bytes field")
            val = buf[pos:pos + size]
            pos += size
        elif wire == WIRE_32BIT:
            if pos + 4 > n:
                raise WireError("truncated fixed32")
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        else:
            raise WireError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, val


def as_float(raw: int) -> float:
    return struct.unpack("<f", struct.pack("<I", raw & 0xFFFFFFFF))[0]


def as_double(raw: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", raw))[0]


def unpack_varints(buf: bytes, signed: bool = True) -> List[int]:
    """Decode a packed repeated varint payload."""
    out: List[int] = []
    pos = 0
    while pos < len(buf):
        v, pos = read_varint(buf, pos)
        out.append(to_signed(v) if signed else v)
    return out


def unpack_floats(buf: bytes) -> List[float]:
    if len(buf) % 4:
        raise WireError("packed float payload not a multiple of 4")
    return list(struct.unpack(f"<{len(buf) // 4}f", buf))


# ---- encoding ---------------------------------------------------------------

def write_varint(v: int) -> bytes:
    if v < 0:  # signed int32/int64 fields encode as 10-byte two's complement
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return write_varint((field << 3) | wire)


def emit_varint(field: int, v: Union[int, bool]) -> bytes:
    return tag(field, WIRE_VARINT) + write_varint(int(v))


def emit_float(field: int, v: float) -> bytes:
    return tag(field, WIRE_32BIT) + struct.pack("<f", v)


def emit_bytes(field: int, v: Union[bytes, str]) -> bytes:
    if isinstance(v, str):
        v = v.encode("utf-8")
    return tag(field, WIRE_BYTES) + write_varint(len(v)) + v


def emit_message(field: int, body: bytes) -> bytes:
    return emit_bytes(field, body)


def emit_packed_varints(field: int, vs) -> bytes:
    body = b"".join(write_varint(int(v)) for v in vs)
    return emit_bytes(field, body)


def emit_repeated_varints(field: int, vs) -> bytes:
    """Unpacked repeated varints (proto2 default for repeated scalars —
    what fluid's proto2 schema actually emits)."""
    return b"".join(emit_varint(field, v) for v in vs)


def emit_repeated_floats(field: int, vs) -> bytes:
    return b"".join(emit_float(field, v) for v in vs)
