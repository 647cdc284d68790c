"""LEB128 varints + bit mixing + zigzag, as used by the v1 wire format
(reference: src/list/encoding/leb.rs, src/encoding/varint.rs:416-530).

The JAX package's `encoding/varint.py`, copied.
"""

from __future__ import annotations

from typing import Tuple


def decode_leb(buf: bytes, pos: int) -> Tuple[int, int]:
    """Returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def encode_leb(value: int) -> bytes:
    assert value >= 0
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def strip_bit(value: int) -> Tuple[int, bool]:
    return value >> 1, (value & 1) != 0


def mix_bit(value: int, bit: bool) -> int:
    return (value << 1) | (1 if bit else 0)


def decode_zigzag_old(value: int) -> int:
    """The 'old' zigzag used by the v1 list format (reference:
    src/list/encoding/leb.rs:305-323): magnitude * sign; note -0 == 0."""
    return (value >> 1) * (-1 if value & 1 else 1)


def encode_zigzag_old(value: int) -> int:
    return mix_bit(abs(value), value < 0)
