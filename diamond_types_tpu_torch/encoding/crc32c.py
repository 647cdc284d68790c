"""CRC-32C (Castagnoli, reflected poly 0x82F63B78) — the file checksum used
by the wire format (reference: src/encoding/tools.rs:111-115, CRC_32_ISCSI).

The JAX package's `encoding/crc32c.py`, copied. The C++ checksum runs
when the native library builds here, the Python table loop otherwise;
the two agree bit for bit.
"""

from __future__ import annotations

_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    from ..native import core
    out = core.crc32c_native(data, crc)
    if out is not None:
        return out
    return crc32c_py(data, crc)


def crc32c_py(data: bytes, crc: int = 0) -> int:
    """The Python checksum (what `crc32c` runs without the library)."""
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF
