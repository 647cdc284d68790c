"""ListCRDT: the convenience (oplog, branch) pair kept in lockstep.

Capability mirror of the reference ListCRDT (reference: src/list/mod.rs:142-145,
src/list/list.rs:144-222).
"""

from __future__ import annotations

from typing import Sequence

from .branch import Branch
from .oplog import OpLog


class ListCRDT:
    __slots__ = ("oplog", "branch")

    def __init__(self) -> None:
        self.oplog = OpLog()
        self.branch = Branch()

    def __len__(self) -> int:
        return len(self.branch)

    def get_or_create_agent_id(self, name: str) -> int:
        return self.oplog.get_or_create_agent_id(name)

    def insert(self, agent: int, pos: int, content: str) -> int:
        return self.branch.insert(self.oplog, agent, pos, content)

    def delete(self, agent: int, start: int, end: int) -> int:
        return self.branch.delete(self.oplog, agent, start, end)

    def snapshot(self) -> str:
        return self.branch.snapshot()

    def merge_data_and_ff(self, other: "ListCRDT") -> None:
        """Pull every op from `other` then fast-forward our branch."""
        merge_oplogs(self.oplog, other.oplog)
        self.branch.merge_tip(self.oplog)


def merge_oplogs(dst: OpLog, src: OpLog) -> None:
    """Merge all ops of `src` into `dst` (cross-oplog version mapping;
    capability mirror of reference src/list/oplog_merge.rs:10-30)."""
    # Map src agents into dst agent ids lazily.
    agent_map = {}

    def map_agent(a: int) -> int:
        if a not in agent_map:
            name = src.cg.agent_assignment.get_agent_name(a)
            agent_map[a] = dst.get_or_create_agent_id(name)
        return agent_map[a]

    for (lv0, lv1, parents, agent, seq) in src.cg.iter_entries():
        # Convert parents to dst LVs via (agent, seq) naming.
        dst_parents = []
        for p in parents:
            pa, pseq = src.cg.agent_assignment.local_to_agent_version(p)
            dlv = dst.cg.agent_assignment.try_agent_version_to_lv(map_agent(pa), pseq)
            assert dlv is not None, "src parents must be merged before children"
            dst_parents.append(dlv)
        dst_parents.sort()

        # Ops covering [lv0, lv1) in src, re-keyed into dst LV space.
        for piece in src.ops.iter_range((lv0, lv1)):
            off = piece.lv - lv0
            content = src.ops.get_run_content(piece)
            dst.add_remote_op(map_agent(agent), seq + off, dst_parents if off == 0
                              else [dst.cg.agent_assignment.agent_version_to_lv(
                                    map_agent(agent), seq + off - 1)],
                              piece.kind, piece.start, piece.end, piece.fwd,
                              content)
