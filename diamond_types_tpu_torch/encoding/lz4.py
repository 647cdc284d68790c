"""Raw LZ4 block decompression (no frame header).

The reference compresses content/patch fields with lz4_flex's block format
(reference: src/list/encoding/decode_oplog.rs:621-633). This is a standard
LZ4 block stream: token byte (hi nibble = literal length, lo nibble = match
length - 4), optional 255-extension bytes, literals, little-endian 16-bit
match offset, overlapping match copy.

The JAX package's `encoding/lz4.py`, copied. The compressor runs in C++
when the native library builds here, in Python otherwise; the two write
the same bytes.
"""

from __future__ import annotations


def lz4_compress_block(src: bytes) -> bytes:
    """Greedy LZ4 block compression (hash-table match finder).

    Produces standard LZ4 block streams decodable by lz4_decompress_block and
    by the reference's lz4_flex reader. Spec constraints honored: matches are
    >= 4 bytes, offsets <= 0xFFFF, and the final 5 bytes (plus the 12-byte
    end-of-block window) are emitted as literals.

    Delegates to the byte-identical native mirror when available (the two
    are differential-tested; output must not depend on which one ran).
    """
    from ..native import core
    out = core.lz4_compress_native(src)
    if out is not None:
        return out
    return lz4_compress_block_py(src)


def lz4_compress_block_py(src: bytes) -> bytes:
    """The Python compressor (what `lz4_compress_block` runs without the
    library)."""
    n = len(src)
    out = bytearray()
    table: dict = {}
    anchor = 0
    i = 0
    limit = n - 12  # don't start matches in the end window

    def emit(lit_start: int, lit_end: int, match_off: int, match_len: int) -> None:
        lit_len = lit_end - lit_start
        token_lit = 15 if lit_len >= 15 else lit_len
        if match_len >= 0:
            ml = match_len - 4
            token_match = 15 if ml >= 15 else ml
        else:
            token_match = 0
        out.append((token_lit << 4) | token_match)
        if lit_len >= 15:
            rem = lit_len - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out.extend(src[lit_start:lit_end])
        if match_len >= 0:
            out.append(match_off & 0xFF)
            out.append(match_off >> 8)
            if match_len - 4 >= 15:
                rem = match_len - 4 - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)

    while i < limit:
        key = src[i:i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF and src[cand:cand + 4] == key:
            # extend the match
            m = 4
            max_m = n - 5 - i  # keep last 5 bytes literal
            while m < max_m and src[cand + m] == src[i + m]:
                m += 1
            if m >= 4:
                emit(anchor, i, i - cand, m)
                i += m
                anchor = i
                continue
        i += 1
    emit(anchor, n, 0, -1)  # trailing literals, no match
    return bytes(out)


def lz4_decompress_block(src: bytes, uncompressed_len: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        if lit_len:
            out += src[i:i + lit_len]
            i += lit_len
        if i >= n:
            break  # last sequence has literals only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("invalid LZ4 offset 0")
        match_len = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        start = len(out) - offset
        if start < 0:
            raise ValueError("LZ4 offset out of range")
        for k in range(match_len):  # overlapping copies must go byte-by-byte
            out.append(out[start + k])
    if len(out) != uncompressed_len:
        raise ValueError(f"LZ4 length mismatch: {len(out)} != {uncompressed_len}")
    return bytes(out)
