"""The plain reference: a list CRDT merge over the benchmark's own op record.

A straightforward implementation of the YjsMod / FugueMax rule that
diamond-types defines for concurrent inserts (upstream `src/list/merge.rs`,
`integrate`), written here from that description over flat NumPy arrays
with every tombstone kept. It imports nothing of the program under test:
its input is the record that `dtbench.traffic.generate` produced, and its
output is each document's merged text.

A document's history is a list of syncs. A sync is one or more chains of
ops, all forked from the document's merged version before the sync, each op
positioned in its own chain's view, then at most one op on top of every
chain's tip, positioned in the merged view. Ops are processed in the order
they were appended (chain by chain, then the top op), which is also the
order of their local versions in the program's op log.

`control` names a deliberately broken merge that the comparison must
reject (PERF.md, "How correct is decided"):
  * "sibling_order_reversed": concurrent siblings ordered by agent name
    descending, not ascending: a merge that converges, but not on the text
    diamond-types defines;
  * "stale_by_one_sync": the text as of the document's previous sync: a
    committed sync that is not visible.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ROOT = -1
CONTROLS = ("sibling_order_reversed", "stale_by_one_sync")


class RefDoc:
    """One document: parallel arrays in document order, tombstones kept."""

    def __init__(self, reverse_siblings: bool = False) -> None:
        self.lv = np.empty(0, np.int32)       # local version of each char
        self.ch = np.empty(0, np.int32)       # its code point
        self.dead = np.empty(0, bool)         # deleted before this sync
        self.owner = np.empty(0, np.int8)     # -1 settled, else its chain
        self.dmask = np.empty(0, np.int16)    # chains of this sync that
        #                                       deleted it (bit per chain)
        self.ol: List[int] = []               # per LV: origin left
        self.orr: List[int] = []              # per LV: origin right
        self.agent: List[str] = []            # per LV: agent name
        self.seq: List[int] = []              # per LV: agent's sequence
        self.agent_seq: Dict[str, int] = {}
        self.reverse = reverse_siblings

    # ---- helpers -------------------------------------------------------

    def _pos_of(self, lv: int) -> int:
        return int(np.flatnonzero(self.lv == lv)[0])

    def _view(self, chain: Optional[int]) -> np.ndarray:
        """Indexes of the chars visible to `chain` (None: the merged view)."""
        if chain is None:
            vis = ~self.dead & (self.dmask == 0)
        else:
            vis = ~self.dead & ((self.owner == -1) | (self.owner == chain)) \
                & ((self.dmask & (1 << chain)) == 0)
        return np.flatnonzero(vis)

    def _name_before(self, mine: Tuple[str, int],
                     other: Tuple[str, int]) -> bool:
        if self.reverse:
            mine, other = (mine[0], -mine[1]), (other[0], -other[1])
            return mine > other
        return mine < other

    # ---- ops -----------------------------------------------------------

    def insert(self, chain: Optional[int], agent: str, pos: int,
               text: str) -> None:
        n = len(self.lv)
        if pos == 0:
            origin_left, cursor = ROOT, 0
        else:
            i = int(self._view(chain)[pos - 1])
            origin_left, cursor = int(self.lv[i]), i + 1
        # items another chain of this sync inserted: not inserted yet from
        # this chain's point of view
        if chain is None:
            niy = np.zeros(n, bool)
        else:
            niy = (self.owner != -1) & (self.owner != chain)
        rest = np.flatnonzero(~niy[cursor:])
        origin_right = int(self.lv[cursor + rest[0]]) if len(rest) else ROOT

        first = len(self.ol)
        seq0 = self.agent_seq.get(agent, 0)
        at = self._integrate(cursor, origin_left, origin_right, agent, seq0,
                             niy)
        k = len(text)
        for j in range(k):
            self.ol.append(origin_left if j == 0 else first + j - 1)
            self.orr.append(origin_right)
            self.agent.append(agent)
            self.seq.append(seq0 + j)
        self.agent_seq[agent] = seq0 + k
        self.lv = np.insert(self.lv, at, np.arange(first, first + k))
        self.ch = np.insert(self.ch, at, np.frombuffer(
            text.encode("utf-32-le"), np.int32))
        self.dead = np.insert(self.dead, at, np.zeros(k, bool))
        self.owner = np.insert(self.owner, at, np.full(
            k, -1 if chain is None else chain, np.int8))
        self.dmask = np.insert(self.dmask, at, np.zeros(k, np.int16))

    def _integrate(self, cursor: int, origin_left: int, origin_right: int,
                   agent: str, seq: int, niy: np.ndarray) -> int:
        """Where a new run goes among the concurrent (not-yet-inserted)
        runs right of its origin: upstream's scan, char by char (a run's
        later chars have their left neighbour as origin, so they never
        stop the scan or change its state)."""
        n = len(self.lv)
        lvs = self.lv
        left_pos = cursor
        scanning, scan_start = False, cursor
        i = cursor
        while i < n:
            other = int(lvs[i])
            if other == origin_right:
                break
            assert niy[i], "the scan met a settled char"
            o_left = self.ol[other]
            o_left_pos = 0 if o_left == ROOT else self._pos_of(o_left) + 1
            if o_left_pos < left_pos:
                break
            if o_left_pos == left_pos:
                o_right = self.orr[other]
                if o_right == origin_right:
                    if self._name_before((agent, seq),
                                         (self.agent[other],
                                          self.seq[other])):
                        break
                    scanning = False
                else:
                    my_right = n if origin_right == ROOT \
                        else self._pos_of(origin_right)
                    other_right = n if o_right == ROOT \
                        else self._pos_of(o_right)
                    if other_right < my_right:
                        if not scanning:
                            scanning, scan_start = True, i
                    else:
                        scanning = False
            i += 1
        return scan_start if scanning else i

    def delete(self, chain: Optional[int], agent: str, start: int,
               end: int) -> None:
        idx = self._view(chain)[start:end]
        assert len(idx) == end - start, "delete past the end of the view"
        if chain is None:
            self.dead[idx] = True
        else:
            self.dmask[idx] |= 1 << chain
        seq0 = self.agent_seq.get(agent, 0)
        for j in range(end - start):
            # deletes take local versions too; they are never origins
            self.ol.append(ROOT)
            self.orr.append(ROOT)
            self.agent.append(agent)
            self.seq.append(seq0 + j)
        self.agent_seq[agent] = seq0 + end - start

    def settle(self) -> None:
        self.dead |= self.dmask != 0
        self.owner[:] = -1
        self.dmask[:] = 0

    def text(self) -> str:
        return self.ch[~self.dead].astype("<u4").tobytes().decode(
            "utf-32-le")

    # ---- syncs ---------------------------------------------------------

    def apply_op(self, chain: Optional[int], agent: str, op) -> None:
        if op[0] == "i":
            self.insert(chain, agent, op[1], op[2])
        else:
            self.delete(chain, agent, op[1], op[2])

    def apply_sync(self, sync: dict) -> None:
        """`sync` = {"chains": [(agent, [op, ...]), ...], "top": (agent, op)
        or None}; an op is ("i", pos, text) or ("d", start, end)."""
        chains = sync["chains"]
        if len(chains) == 1 and sync.get("top") is None:
            agent, ops = chains[0]
            for op in ops:          # a linear sync: the merged view
                self.apply_op(None, agent, op)
            return
        for j, (agent, ops) in enumerate(chains):
            for op in ops:
                self.apply_op(j, agent, op)
        self.settle()
        if sync.get("top") is not None:
            agent, op = sync["top"]
            self.apply_op(None, agent, op)


def merged_text(syncs: Sequence[dict], control: Optional[str] = None) -> str:
    """The document's text after every sync of its history (the control's
    text when `control` names one)."""
    if control not in (None,) + CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    doc = RefDoc(reverse_siblings=control == "sibling_order_reversed")
    upto = len(syncs) - 1 if control == "stale_by_one_sync" else len(syncs)
    for sync in syncs[:upto]:
        doc.apply_sync(sync)
    return doc.text()
