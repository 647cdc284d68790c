"""Per-mesh window arenas: device-resident staging and output reuse for
the flush window.

Port of the JAX package's `parallel/arena.py`. `mesh_fused_replay` builds
a window's `[bp, cap]` input rows one of three ways:

  * **Arena fast path**: after a window commits, its K1 outputs are
    parked as the arena of the `(mesh, cap, max_ins)` class and every
    committed session row is tagged `(arena, generation, row)`. When the
    NEXT window presents the same session list at the same padded batch,
    the parked outputs are handed back as that window's K1 inputs: no
    stack, no copy, no allocation.
  * **Device-side gather** (the `DEVICE_STAGE` default): the sessions'
    rows are stacked on their device; only the op plan arrays cross from
    the host.
  * **Host staging** (`DEVICE_STAGE.enabled = False`, the A/B control
    arm): every row round-trips through host numpy and is counted in the
    window's staged bytes.

The JAX arena donates the parked arrays to the next program. K1 never
writes its inputs and returns fresh outputs, so here nothing is donated:
the parked tensors are read as the next inputs, and a committed session
holds the VIEW `out_docs[i]` of the parked buffer instead of a clone.
Nothing writes a session row in place (a commit replaces `sess.docs`, a
rebuild allocates a new row), so a view is as safe as a copy. What keeps
a parked buffer alive is every committed view of it, plus the arena until
the next window of its class: a buffer whose other rows have all moved on
stays allocated while one session still holds its row.

Poison stays local: a row that fails the `adopt_results` length fence is
not committed and not tagged, so the next window's tag check misses and
the gather path rebuilds from the sessions' own rows. A commit through
any other path and a rebuild (`FusedDocSession.commit` / `_materialize`)
clear the session's tag for the same reason.

The table lock is held only around table reads and swaps, never around a
launch, and acquires nothing itself.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

_arena_lock = threading.Lock()


class _StageFlag:
    """Process-global device-staging switch (`--no-device-stage` clears
    it for the A/B control arm: host-numpy staging, every state byte
    counted)."""

    def __init__(self) -> None:
        self.enabled = True


DEVICE_STAGE = _StageFlag()


class WindowArena:
    """Parked K1 outputs of the last committed window of one
    `(mesh, cap, max_ins)` class: one `(docs, lens)` pair per device
    slice. `gen` grows with each adoption so a stale tag never matches;
    `docs`/`lens` are cleared on handoff and stay cleared until the next
    adoption if that window's launch fails."""

    __slots__ = ("bp", "gen", "live", "docs", "lens")

    def __init__(self) -> None:
        self.bp = 0
        self.gen = 0
        self.live = 0
        self.docs: Optional[list] = None
        self.lens: Optional[list] = None


_arenas: Dict[Tuple, WindowArena] = {}
_counts = {"hits": 0, "misses": 0}


def _key(mesh, cap: int, mi: int) -> Tuple:
    return (tuple(str(d) for d in mesh), int(cap), int(mi))


def reset_arenas() -> None:
    with _arena_lock:
        _arenas.clear()
        _counts["hits"] = _counts["misses"] = 0


def arena_stats() -> dict:
    """Arenas, adoptions (generations) and the fast path's hits and
    misses since the last `reset_arenas()`."""
    with _arena_lock:
        return {"arenas": len(_arenas),
                "generations": sum(a.gen for a in _arenas.values()),
                **_counts}


def acquire(mesh, cap: int, mi: int, sessions, bp: int):
    """The fast path: if the previous window of this class committed
    EXACTLY these sessions in this order at this padded batch, hand its
    parked per-device `(docs, lens)` lists back as this window's inputs.
    Returns `(docs, lens)` or None (the caller gathers instead)."""
    with _arena_lock:
        a = _arenas.get(_key(mesh, cap, mi))
        hit = a is not None and a.docs is not None and a.bp == bp \
            and a.live == len(sessions) \
            and all(getattr(s, "_arena_tag", None) == (a, a.gen, i)
                    for i, s in enumerate(sessions))
        _counts["hits" if hit else "misses"] += 1
        if not hit:
            return None
        docs, lens = a.docs, a.lens
        a.docs = a.lens = None       # this window's outputs replace them
        for s in sessions:
            s._arena_tag = None      # re-tagged on adopt, or not at all
        return docs, lens


def adopt(mesh, cap: int, mi: int, out_docs: list, out_lens: list,
          sessions, ok: List[bool], bp: int) -> None:
    """Park a committed window's per-device outputs as the next window's
    arena and tag every COMMITTED session row. Rows that failed the
    length fence stay untagged: their slot is in the parked buffer but
    can never match, so the next window gathers instead of replaying
    stale bytes."""
    with _arena_lock:
        a = _arenas.setdefault(_key(mesh, cap, mi), WindowArena())
        a.gen += 1
        a.bp = bp
        a.live = len(sessions)
        a.docs = out_docs
        a.lens = out_lens
        for i, s in enumerate(sessions):
            if ok[i]:
                s._arena_tag = (a, a.gen, i)
