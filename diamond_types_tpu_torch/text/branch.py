"""A branch: (version frontier, document content) — a live checkpoint.

Capability mirror of the reference ListBranch (reference: src/list/mod.rs:66-76,
src/list/branch.rs, src/list/merge.rs:63-96).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence

from ..utils.rope import Rope
from .op import INS
from .oplog import OpLog


class Branch:
    __slots__ = ("version", "content", "last_merge_collisions",
                 "last_merge_engine")

    def __init__(self) -> None:
        self.version: List[int] = []
        self.content = Rope()
        # collisions reported by the last merge() — genuinely concurrent
        # inserts at the same gap (reference: has_conflicts_when_merging,
        # src/list/merge.rs:51); 0 = merged cleanly, None = no merge yet
        # or an engine that does not report (zone, plan2, device).
        self.last_merge_collisions: Optional[int] = None
        # the engine that ran the last merge(): "tracker", "zone",
        # "python", "plan2" or "device"; None before the first merge.
        self.last_merge_engine: Optional[str] = None

    def __len__(self) -> int:
        return len(self.content)

    def snapshot(self) -> str:
        return str(self.content)

    # --- local edits (append to oplog, then apply here) --------------------

    def insert(self, oplog: OpLog, agent: int, pos: int, content: str) -> int:
        lv = oplog.add_insert_at(agent, self.version, pos, content)
        self.content.insert(pos, content)
        self.version = [lv]
        return lv

    def delete(self, oplog: OpLog, agent: int, start: int, end: int) -> int:
        deleted = self.content.slice(start, end)
        lv = oplog.add_delete_at(agent, self.version, start, end, deleted)
        self.content.delete(start, end - start)
        self.version = [lv]
        return lv

    def delete_without_content(self, oplog: OpLog, agent: int, start: int,
                               end: int) -> int:
        lv = oplog.add_delete_at(agent, self.version, start, end, None)
        self.content.delete(start, end - start)
        self.version = [lv]
        return lv

    # UTF-16 entry points for JS/Swift-style clients (reference:
    # branch.rs insert_at_wchar / delete_at_wchar, wchar_conversion feature).

    def insert_at_wchar(self, oplog: OpLog, agent: int, wchar_pos: int,
                        content: str) -> int:
        from ..core.unicount import wchars_to_chars
        return self.insert(oplog, agent,
                           wchars_to_chars(self.snapshot(), wchar_pos), content)

    def delete_at_wchar(self, oplog: OpLog, agent: int, wchar_start: int,
                        wchar_end: int) -> int:
        from ..core.unicount import wchars_to_chars
        snap = self.snapshot()
        return self.delete(oplog, agent, wchars_to_chars(snap, wchar_start),
                           wchars_to_chars(snap, wchar_end))

    # --- merge -------------------------------------------------------------

    def merge(self, oplog: OpLog, merge_frontier: Sequence[int],
              device=None) -> None:
        """Bring everything in `merge_frontier`'s history into this branch
        (reference: src/list/merge.rs:63-96).

        The engine is chosen behind this one boundary, in the JAX
        package's order:
          * DT_TPU_PLAN2=1: the fork/join plan engine (the conflict zone
            compiled into a Begin/Fork/Max/Apply schedule over numbered
            state indexes, run on the dense state matrix;
            listmerge/plan2.py + dense.py);
          * DT_TPU_DEVICE_MERGE=1: the device merge (`gpu/merge_kernel.py
            merge_device`: the Fugue-tree linearization and K3);
          * DT_TPU_ZONE=1: the zone engine (`gpu/zone_kernel.py
            zone_checkout_device`: the host composes entries, the X8 tape
            resolves every origin on the device);
          * default, with the native library: the measured policy
            (`listmerge/policy.py GLOBAL.choose`) picks the zone engine or
            the C++ tracker merge (`merge_native`), whose rate it records;
          * DT_TPU_NO_NATIVE=1, or no native library: the pure-Python
            engine (the oracle), the transformed-op stream applied to the
            rope.
        The device engines run on `device`: CUDA unless the caller asks
        for "cpu". A policy-selected zone merge that fails propagates; the
        JAX package demotes the zone engine and falls back to the tracker
        instead."""
        self.last_merge_collisions = None
        self.last_merge_engine = None
        if os.environ.get("DT_TPU_PLAN2"):
            from ..listmerge.dense import merge_via_plan2
            rows, final = merge_via_plan2(oplog, self.version,
                                          merge_frontier)
            self._apply_xf(oplog, rows)
            self.version = list(final)
            self.last_merge_engine = "plan2"
            return
        if os.environ.get("DT_TPU_DEVICE_MERGE"):
            from ..gpu.merge_kernel import merge_device
            text, frontier = merge_device(oplog, self.version,
                                          merge_frontier, device=device)
            self.content = Rope(text)
            self.version = frontier
            self.last_merge_engine = "device"
            return

        from ..listmerge import policy

        def top(v) -> int:
            return max((int(x) for x in v), default=-1) + 1

        if os.environ.get("DT_TPU_ZONE"):
            self._zone_merge(oplog, merge_frontier, device)
            return
        from ..native import native_ctx_or_none
        ctx = native_ctx_or_none(oplog)
        if ctx is not None:
            # zone is never chosen before both engines are measured (or a
            # demoted zone engine's cooldown re-probe)
            if policy.GLOBAL.choose(top(merge_frontier) - top(self.version)) \
                    == policy.ZONE:
                self._zone_merge(oplog, merge_frontier, device)
                return
            n_before = top(self.version)
            t0 = time.perf_counter()
            self._merge_tracker(oplog, merge_frontier, ctx)
            policy.GLOBAL.record(policy.TRACKER, top(self.version) - n_before,
                                 time.perf_counter() - t0)
            return
        self._merge_python(oplog, merge_frontier)

    def merge_reference(self, oplog: OpLog,
                        merge_frontier: Sequence[int]) -> None:
        """`merge` on a host engine that nothing but the native library's
        presence picks: the C++ tracker called directly, else the
        pure-Python oracle. No environment switch or engine policy reaches
        it and it records no rate, so a parity check can hold the engines
        that `merge` selects against it."""
        from ..native import native_ctx_or_none
        ctx = native_ctx_or_none(oplog)
        if ctx is not None:
            self._merge_tracker(oplog, merge_frontier, ctx)
        else:
            self._merge_python(oplog, merge_frontier)

    def _merge_tracker(self, oplog: OpLog, merge_frontier: Sequence[int],
                       ctx) -> None:
        from ..native.core import merge_native
        doc, frontier = merge_native(oplog, self.snapshot(), self.version,
                                     merge_frontier)
        self.content = Rope(doc)
        self.version = frontier
        self.last_merge_collisions = ctx.last_collisions()
        self.last_merge_engine = "tracker"

    def _merge_python(self, oplog: OpLog,
                      merge_frontier: Sequence[int]) -> None:
        xf = oplog.get_xf_operations_full(self.version, merge_frontier)
        self._apply_xf(oplog, xf)
        self.version = list(xf.next_frontier)
        self.last_merge_collisions = xf.collisions
        self.last_merge_engine = "python"

    def _zone_merge(self, oplog: OpLog, merge_frontier: Sequence[int],
                    device) -> None:
        """The zone engine; its full runs record their own rate into the
        policy (`zone_checkout_device`)."""
        from ..gpu.zone_kernel import zone_checkout_device
        from ..listmerge.policy import ZONE
        text, frontier = zone_checkout_device(oplog, self.version,
                                              merge_frontier, device=device)
        self.content = Rope(text)
        self.version = list(frontier)
        self.last_merge_engine = ZONE

    def _apply_xf(self, oplog: OpLog, rows) -> None:
        """Apply an (lv, op, xf_pos|None) stream to this branch's content —
        the one shared application loop for every host engine."""
        for _lv, op, pos in rows:
            if pos is None:
                continue  # delete already happened
            if op.kind == INS:
                content = oplog.ops.get_run_content(op)
                assert content is not None
                if not op.fwd:
                    content = content[::-1]
                self.content.insert(pos, content)
            else:
                self.content.delete(pos, len(op))

    def merge_tip(self, oplog: OpLog) -> None:
        self.merge(oplog, oplog.version)
