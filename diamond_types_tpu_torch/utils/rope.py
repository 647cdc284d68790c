"""A chunked rope for branch content.

Fills the role of the reference's external `jumprope` crate (a skip-list rope;
used at reference: src/list/mod.rs:75). This design is a flat list of string
chunks indexed by a Fenwick tree over chunk lengths: O(log n) position lookup,
O(chunk) splice. All positions are in unicode characters (the reference keeps
all CRDT math in char space too — src/unicount.rs).
"""

from __future__ import annotations

from typing import List

_TARGET = 1024  # target chunk size (chars)
_MAX = 2048


class Rope:
    __slots__ = ("_chunks", "_fen", "_len")

    def __init__(self, s: str = "") -> None:
        self._chunks: List[str] = [s[i:i + _TARGET] for i in range(0, len(s), _TARGET)] or [""]
        self._len = len(s)
        self._rebuild()

    # --- Fenwick over chunk lengths --------------------------------------

    def _rebuild(self) -> None:
        n = len(self._chunks)
        fen = [0] * (n + 1)
        for i, c in enumerate(self._chunks, start=1):
            fen[i] += len(c)
            j = i + (i & -i)
            if j <= n:
                fen[j] += fen[i]
        self._fen = fen

    def _fen_add(self, i: int, delta: int) -> None:
        i += 1
        n = len(self._fen) - 1
        while i <= n:
            self._fen[i] += delta
            i += i & -i

    def _find_chunk(self, pos: int):
        """Largest prefix <= pos; returns (chunk_idx, offset_in_chunk)."""
        idx = 0
        rem = pos
        bit = 1 << (len(self._fen).bit_length() - 1)
        n = len(self._fen) - 1
        while bit:
            nxt = idx + bit
            if nxt <= n and self._fen[nxt] <= rem:
                rem -= self._fen[nxt]
                idx = nxt
            bit >>= 1
        # idx = number of whole chunks before pos
        if idx >= len(self._chunks):
            idx = len(self._chunks) - 1
            rem = len(self._chunks[idx])
        return idx, rem

    # --- edits -----------------------------------------------------------

    def __len__(self) -> int:
        return self._len

    def insert(self, pos: int, s: str) -> None:
        if not s:
            return
        assert 0 <= pos <= self._len, (pos, self._len)
        ci, off = self._find_chunk(pos)
        chunk = self._chunks[ci]
        merged = chunk[:off] + s + chunk[off:]
        self._len += len(s)
        if len(merged) <= _MAX:
            self._chunks[ci] = merged
            self._fen_add(ci, len(s))
        else:
            parts = [merged[i:i + _TARGET] for i in range(0, len(merged), _TARGET)]
            self._chunks[ci:ci + 1] = parts
            self._rebuild()

    def delete(self, pos: int, n: int) -> None:
        if n <= 0:
            return
        assert pos + n <= self._len, (pos, n, self._len)
        self._len -= n
        ci, off = self._find_chunk(pos)
        remaining = n
        structural = False
        while remaining > 0:
            chunk = self._chunks[ci]
            take = min(len(chunk) - off, remaining)
            new_chunk = chunk[:off] + chunk[off + take:]
            remaining -= take
            if new_chunk or len(self._chunks) == 1:
                self._chunks[ci] = new_chunk
                if structural:
                    pass  # fenwick rebuilt at the end anyway
                else:
                    self._fen_add(ci, -take)
                ci += 1
            else:
                del self._chunks[ci]
                structural = True
            off = 0
        if structural:
            self._rebuild()

    def char_at(self, pos: int) -> str:
        ci, off = self._find_chunk(pos)
        return self._chunks[ci][off]

    def slice(self, start: int, end: int) -> str:
        return str(self)[start:end] if end - start > self._len // 2 else self._slice_small(start, end)

    def _slice_small(self, start: int, end: int) -> str:
        if end <= start:
            return ""
        ci, off = self._find_chunk(start)
        out: List[str] = []
        need = end - start
        while need > 0 and ci < len(self._chunks):
            chunk = self._chunks[ci]
            take = min(len(chunk) - off, need)
            out.append(chunk[off:off + take])
            need -= take
            ci += 1
            off = 0
        return "".join(out)

    def __str__(self) -> str:
        return "".join(self._chunks)
