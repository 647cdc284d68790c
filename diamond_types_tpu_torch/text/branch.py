"""A branch: (version frontier, document content) — a live checkpoint.

Capability mirror of the reference ListBranch (reference: src/list/mod.rs:66-76,
src/list/branch.rs, src/list/merge.rs:63-96).
"""

from __future__ import annotations

import os
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
        # src/list/merge.rs:51); 0 = merged cleanly, None = no merge yet.
        self.last_merge_collisions: Optional[int] = None
        # the engine that ran the last merge(): "python", "plan2" or
        # "device"; None before the first merge. The plan2 and device
        # engines report no collisions (last_merge_collisions = None).
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

    # --- merge -------------------------------------------------------------

    def merge(self, oplog: OpLog, merge_frontier: Sequence[int],
              device=None) -> None:
        """Bring everything in `merge_frontier`'s history into this branch
        (reference: src/list/merge.rs:63-96).

        The engine is chosen behind this one boundary:
          * DT_TPU_PLAN2=1: the fork/join plan engine (the conflict zone
            compiled into a Begin/Fork/Max/Apply schedule over numbered
            state indexes, run on the dense state matrix;
            listmerge/plan2.py + dense.py);
          * DT_TPU_DEVICE_MERGE=1: the device merge (`gpu/merge_kernel.py
            merge_device`: the Fugue-tree linearization and K3) on
            `device`, which is CUDA unless the caller asks for "cpu";
          * default: the pure-Python engine (the oracle), the
            transformed-op stream applied to the rope."""
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
        xf = oplog.get_xf_operations_full(self.version, merge_frontier)
        self._apply_xf(oplog, xf)
        self.version = list(xf.next_frontier)
        self.last_merge_collisions = xf.collisions
        self.last_merge_engine = "python"

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
