"""Device-resident incremental merge sessions (X9).

Port of the JAX package's `tpu/zone_session.py`. The realtime pattern — a
live document receiving a stream of small edits from several peers, each
merged immediately (reference hot path: src/list/merge.rs:63-96) — must not
pay a full document re-upload per merge. A `DeviceZoneSession` keeps the
zone engine's ENTIRE carry (state matrix, rank order, origin metadata, key
planes) resident on the device and treats each incremental merge as a few
more tape steps continued from that carry: the host ships only the delta
(the new entries' composed micro-tape), and `kernels.zone_tape_run` updates
the carry IN PLACE (the JAX session donates its buffers to the jitted step
instead).

Row tracking: the session holds one state row per live branch head (each
peer's last version). A new run whose parents match tracked rows applies
directly (fork/max exactly like the plan compiler would); a run anchored at
an untracked version triggers `resync()` — a full rebuild whose plan PINS a
state row at each agent's head (plan2 pin_lvs), so after one rebuild every
active branch is tracked again. Slot capacity is pre-allocated with
headroom; growth also resyncs.

Everything reuses the zone engine verbatim: the same tape schema, the same
kernel (or its plain version for a CPU session), the same YjsMod
semantics — a session is a tape whose steps arrive over time. The session
lives on `device`: CUDA unless the caller asks for "cpu". The JAX session's
sharded row form (`row_sharding`, the state rows spread over a mesh) needs
more than one card and is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..listmerge.compose import compose_entry
from ..listmerge.zone_np import prepare_zone
from . import kernels, resolve_device
from .steer import _pow2
from .zone_kernel import (BIG32, OP_APPLY, OP_FORK, OP_MAX, ZoneTape,
                          _fill_tape, assemble_text, entry_steps,
                          init_zone_carry, pack_zone_tape, tape_xs)


class DeviceZoneSession:
    """A live document resident on the device (see module docstring)."""

    # a zone sync has no length fence; the bank's device-time accounting
    # reads this as it reads a fused session's fence time
    fence_s = 0.0

    def __init__(self, oplog, n_rows: int = 8, headroom: float = 2.0,
                 max_blocks: int = 4, max_chars: int = 256,
                 max_dels: int = 8, device=None):
        self.oplog = oplog
        self.n_rows = n_rows
        self.headroom = headroom
        self.MB, self.MC, self.MD = max_blocks, max_chars, max_dels
        self.device = resolve_device(device)
        self.resyncs = -1          # first build counts up to 0
        self.merges = 0
        self._lru: Dict[Tuple[int, ...], int] = {}
        self._clock = 0
        self.resync()

    # ---- full (re)build --------------------------------------------------

    def resync(self) -> None:
        """Rebuild device state from scratch, pinning one state row per
        agent head so every active branch is immediately tracked."""
        self.resyncs += 1
        ol = self.oplog
        # pin each agent's last version (if it lands in the zone)
        aa = ol.cg.agent_assignment
        heads: List[int] = []
        for agent in range(len(aa.agent_names)):
            last = self._agent_last_lv(agent)
            if last is not None:
                heads.append(last)
        prep = prepare_zone(ol, pin_lvs=tuple(heads))
        self.prep = prep
        W_cap = _pow2(max(int(prep.W * self.headroom), prep.W + 1024))
        n_rows = max(self.n_rows, prep.plan.indexes_used)
        self.W_cap = W_cap
        self.plen = prep.plen

        self._agent_epoch = tuple(ol.cg.agent_assignment.agent_names)
        # growable host-side tables (slot map, pool, key arrays); the
        # searchsorted arrays regenerate lazily once per sync
        self._lv0_list = list(prep.ins_lv0)
        self._cum_list = list(prep.ins_cum)
        self._slot_arrays_dirty = True
        self.W_used = prep.W
        self.pool = np.zeros(W_cap, dtype=np.int32)
        self.pool[:prep.W] = prep.pool
        agent_k = np.zeros(W_cap, dtype=np.int32)
        seq_k = np.zeros(W_cap, dtype=np.int32)
        agent_k[:prep.W] = prep.agent_k
        seq_k[:prep.W] = prep.seq_k

        tape = pack_zone_tape(prep, self.MB, self.MC, self.MD)
        tape.W = W_cap     # slot ids are absolute: only the width differs
        self.carry = init_zone_carry(W_cap, prep.plen, n_rows, agent_k,
                                     seq_k, device=self.device)
        self._run_tape(tape)

        # row registry: pinned agent-head rows + their frontiers
        self.row_of: Dict[Tuple[int, ...], int] = {}
        self.free_rows = set(range(n_rows))
        for lv, row in prep.plan.pinned_rows.items():
            self.row_of[(lv,)] = row
            self.free_rows.discard(row)
        self.n_rows_eff = n_rows
        self.synced_to = len(ol)
        self._lru.clear()          # stale frontiers died with the old rows
        self._keys_cache = None
        # always track the merged TIP as a row (visible = placed and never
        # deleted): linear histories have no zone entries to pin, and most
        # realtime ops parent on the tip
        tipkey = tuple(sorted(int(x) for x in ol.version))
        if tipkey and tipkey not in self.row_of and self.free_rows:
            r = min(self.free_rows)
            self.free_rows.discard(r)
            self._tip_row(r)
            self.row_of[tipkey] = r

    def _tip_row(self, r: int) -> None:
        """state[r] <- the merged tip's visibility (1 = placed and never
        deleted, 2 = placed and deleted, 0 = unplaced), in place."""
        c = self.carry
        row = torch.where(c.rank < int(BIG32),
                          torch.where(c.ever == 0, 1, 2), 0)
        c.state[:, min(max(r, 0), self.n_rows_eff - 1)] = row.to(torch.uint8)

    def _run_tape(self, tape: ZoneTape) -> None:
        """Continue the resident carry with `tape`, in place: one launch
        for the whole tape. (The JAX session can cut it into slices,
        DT_SESSION_SLICE, for its TPU runtime's per-program time limit; the
        card has none.)"""
        kernels.zone_tape_run(self.carry, tape_xs(tape, self.device),
                              tape.plen)

    def _take_row(self, exclude) -> Optional[int]:
        """A free state row, evicting the least-recently-used tracked
        frontier when the pool is dry (an evicted frontier referenced
        later costs one resync)."""
        if self.free_rows:
            r = min(self.free_rows)
            self.free_rows.discard(r)
            return r
        victims = [(self._lru.get(k, 0), k) for k, v in self.row_of.items()
                   if v not in exclude]
        if not victims:
            return None
        _, k = min(victims)
        r = self.row_of.pop(k)
        self._lru.pop(k, None)
        return r

    def _touch_key(self, key) -> None:
        self._clock += 1
        self._lru[key] = self._clock

    def _keys(self, lvs: np.ndarray):
        """(agent name rank, seq) per LV with the run tables cached per
        sync epoch."""
        aa = self.oplog.cg.agent_assignment
        gr = aa.global_runs
        cache = self._keys_cache
        if cache is None or cache[0] != len(gr):
            lv0 = np.asarray([r[0] for r in gr], dtype=np.int64)
            ag = np.asarray([r[2] for r in gr], dtype=np.int64)
            sq0 = np.asarray([r[3] for r in gr], dtype=np.int64)
            o = np.argsort(lv0)
            name_rank = np.asarray(np.argsort(np.argsort(aa.agent_names)))
            cache = (len(gr), lv0[o], ag[o], sq0[o], name_rank)
            self._keys_cache = cache
        _, lv0, ag, sq0, name_rank = cache
        lvs = np.asarray(lvs, dtype=np.int64)
        j = np.clip(np.searchsorted(lv0, lvs, side="right") - 1, 0,
                    len(lv0) - 1)
        return name_rank[ag[j]], sq0[j] + (lvs - lv0[j])

    def _agent_last_lv(self, agent: int) -> Optional[int]:
        aa = self.oplog.cg.agent_assignment
        best = None
        for (_lv0, lv_end, ag, _sq) in aa.global_runs:
            if ag == agent:
                end = lv_end - 1
                best = end if best is None or end > best else best
        return best

    # ---- incremental path ------------------------------------------------

    def _slot_of_lv(self, lvs: np.ndarray) -> np.ndarray:
        if self._slot_arrays_dirty:
            self.ins_lv0 = np.asarray(self._lv0_list, dtype=np.int64)
            self.ins_cum = np.asarray(self._cum_list, dtype=np.int64)
            self._slot_arrays_dirty = False
        j = np.searchsorted(self.ins_lv0, lvs, side="right") - 1
        return self.plen + self.ins_cum[j] + (lvs - self.ins_lv0[j])

    def _alloc_slots(self, entry_span) -> bool:
        """Extend the slot map/pool with the entry's insert runs. Returns
        False when capacity would overflow (caller resyncs)."""
        from ..text.op import INS
        new = []
        for piece in self.oplog.ops.iter_range(entry_span):
            if piece.kind == INS:
                new.append((piece.lv, len(piece),
                            self.oplog.ops.content_slice(piece.lv,
                                                         len(piece))))
        total = sum(n for _, n, _ in new)
        if self.W_used + total > self.W_cap:
            return False
        for (lv, n, content) in new:
            slot0 = self.W_used
            self._lv0_list.append(lv)
            self._cum_list.append(slot0 - self.plen)
            self._slot_arrays_dirty = True
            arr = np.frombuffer(content.encode("utf-32-le"),
                                dtype=np.int32)
            self.pool[slot0:slot0 + n] = arr
            self.W_used += n
        return True

    def sync(self) -> int:
        """Fold every op appended to the oplog since the last sync into
        the device state. Returns the number of micro-steps executed
        (0 = nothing new). Resyncs transparently when needed."""
        ol = self.oplog
        if self.synced_to >= len(ol):
            return 0
        # agent NAME RANKS are relative to the registered-name set; a new
        # agent shifts existing ranks, and the carry's key planes hold the
        # old epoch's ranks — rebuild before they can disagree
        if tuple(ol.cg.agent_assignment.agent_names) != self._agent_epoch:
            self.resync()
            return self.sync()
        g = ol.cg.graph
        # split the new span into entries (same-parents runs)
        steps: List[dict] = []
        end = len(ol)
        spans: List[Tuple[int, int, Tuple[int, ...]]] = []
        v = self.synced_to
        while v < end:
            i = g.find_idx(v)
            take = min(end, g.ends[i])
            parents = tuple(g.parents_at(v)) if v == g.starts[i] \
                else (v - 1,)
            spans.append((v, take, parents))
            v = take

        for (s, e, parents) in spans:
            key = tuple(sorted(parents))
            # source rows: the exact frontier if tracked, else the per-tip
            # rows of a multi-parent frontier
            if key in self.row_of:
                srcs = [self.row_of[key]]
            else:
                srcs = [self.row_of.get((p,)) for p in sorted(parents)]
                if not srcs or any(r is None for r in srcs):
                    # untracked frontier — including parents == [] (a
                    # concurrent root-anchored op): rebuild
                    self.resync()
                    return self.sync()
            # apply on a FRESH row (fork + max joins): source rows stay
            # tracked — two branches forking the same frontier is the
            # normal realtime shape and must not force a rebuild
            row = self._take_row(exclude=set(srcs))
            if row is None or not self._alloc_slots((s, e)):
                self.resync()
                return self.sync()
            pre_ops = [(OP_FORK, srcs[0], row)] + \
                [(OP_MAX, r, row) for r in srcs[1:]]
            ce = compose_entry(ol, (s, e))
            steps.extend(self._pack_entry(ce, row, pre_ops))
            self.row_of[(e - 1,)] = row
            self._touch_key((e - 1,))

        if steps:
            self._run_tape(_fill_tape(steps, self.W_cap, self.plen,
                                      self.n_rows_eff,
                                      self.pool[:self.W_used], self.MB,
                                      self.MC, self.MD))
            self.merges += 1
        self.synced_to = end
        return len(steps)

    def _pack_entry(self, ce, row: int, pre_ops: List[tuple]
                    ) -> List[dict]:
        """Entry -> micro-steps via the SAME packer as whole documents
        (zone_kernel.entry_steps), against the session's growable slot
        map and live agent-key resolution."""
        steps: List[dict] = []
        for (op, a, b) in pre_ops:
            steps.append(dict(op=op, a=a, b=b, snap=0, blocks=[],
                              chars=[], dels=[], n_chars=0))
        cur = dict(op=OP_APPLY, a=row, b=0, snap=1, blocks=[], chars=[],
                   dels=[], n_chars=0)
        steps.append(cur)

        def next_sub():
            s = dict(op=OP_APPLY, a=row, b=0, snap=0, blocks=[],
                     chars=[], dels=[], n_chars=0)
            steps.append(s)
            return s

        entry_steps(ce, self._slot_of_lv, self._keys, None,
                    self.MB, self.MC, self.MD, cur, next_sub)
        return steps

    # ---- reads -----------------------------------------------------------

    def text(self) -> str:
        """Fetch and assemble the merged document."""
        return assemble_text(self.carry.rank[0], self.carry.ever[0],
                             self.pool)

    def touch(self) -> int:
        """Wait for the session's pending device work with a one-value
        read (per-merge latency benches time sync() + touch())."""
        return int(self.carry.m[0])

    def footprint_slots(self) -> int:
        """Device-residency cost of this session in slots, for the serve
        bank's capacity accounting: the state matrix dominates (n_rows x
        W_cap), plus the per-slot planes (rank, order, origin ids x2,
        ever, agent key, seq key — 7 more W_cap vectors), as the JAX
        session counts it. Host pool/key tables are not counted."""
        return int(self.W_cap) * (int(self.n_rows_eff) + 7)
