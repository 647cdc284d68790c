"""Position-space conversions: unicode chars <-> UTF-16 code units (wchars).

Capability mirror of the reference's wchar conversion feature (reference:
src/unicount.rs + the wchar_conversion cargo feature; branch.rs
insert_at_wchar/delete_at_wchar): JS and Swift clients address text in UTF-16
code units, while all CRDT math here is in unicode chars. Characters outside
the BMP (>= U+10000) occupy two UTF-16 units.
"""

from __future__ import annotations


def count_utf16(s: str) -> int:
    """Number of UTF-16 code units in s."""
    return len(s) + sum(1 for c in s if ord(c) >= 0x10000)


def chars_to_wchars(s: str, char_pos: int) -> int:
    """Char offset -> UTF-16 offset."""
    assert 0 <= char_pos <= len(s)
    return char_pos + sum(1 for c in s[:char_pos] if ord(c) >= 0x10000)


def wchars_to_chars(s: str, wchar_pos: int) -> int:
    """UTF-16 offset -> char offset. Must not land inside a surrogate pair."""
    w = 0
    for i, c in enumerate(s):
        if w == wchar_pos:
            return i
        w += 2 if ord(c) >= 0x10000 else 1
        if w > wchar_pos:
            raise ValueError("wchar position splits a surrogate pair")
    if w == wchar_pos:
        return len(s)
    raise ValueError("wchar position out of range")


def chars_to_bytes(s: str, char_pos: int) -> int:
    """Char offset -> UTF-8 byte offset (reference: unicount.rs:8-30)."""
    return len(s[:char_pos].encode("utf8"))


def bytes_to_chars(s: str, byte_pos: int) -> int:
    b = s.encode("utf8")
    return len(b[:byte_pos].decode("utf8"))
