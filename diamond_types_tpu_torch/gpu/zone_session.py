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
lives on `device`: CUDA unless the caller asks for "cpu".

Divergence from the JAX session (the port's own fix): a continued sync
writes the agent and seq keys of every slot it allocates into the carry's
key planes before its tape runs, as `init_zone_carry` holds every slot's
keys before a whole-document tape. The tape scatters a char's keys only in
the APPLY sub-step that places it, and an entry's block is placed with its
ROOT char's keys, read from the carry; the root is the block's last run
when later runs were typed to its left, so a block longer than one
sub-step's budget is placed before its root's keys exist. It then reads
zero keys, ranks as the first agent, and lands before a concurrent
sibling the YjsMod order puts first. The JAX session reads the same zeros
and serves that wrong text (`tests/test_torch_zone_continued.py`).

Who builds a continued sync's micro-tape: Python walks the new span into
entries, takes their rows and slots and makes every resync decision; the
entries are then composed by the C++ composer (`dt_compose_plan`) and
packed by the C++ zone packer (`dt_zone_pack`) on a scratch native
context the session owns (`native.core.MicroTapeContext`), loaded with
the sync's own op runs alone. The Python composer (`listmerge/compose.py`),
`entry_steps` and `_fill_tape` build the same tape, array for array, when
the native engine is off (DT_TPU_NO_NATIVE, or the library cannot be
built) or refuses the entries. The C++ refuses only what the Python
composer refuses too (a reverse insert run, a delete past the end), so
such a sync then raises from the Python path, as it did before the C++
path. ctypes leaves the GIL while the C++ runs.

Counters (`take_counts`, `ZONE_COUNTS`): syncs, continued and resynced;
resyncs by cause (`RESYNC_CAUSES`); the continued syncs whose micro-tape
each path built (`prep_native`, `prep_python`); X8 launches and the
launched tapes' shapes: steps of each kind, snapshotting APPLY steps,
chars placed, the ranks placed before each APPLY step, the slots swept by
row steps and snapshots, the tapes' widths and bytes. The serve bank takes
them after every sync (`ServeMetrics.record_zone`). With a `FlushClock`,
`sync` times its phases: `zone_compose` (the entries' rows and slots
taken, the entries composed and packed into a tape), `zone_tape` (the key
planes' and the tape's upload, the X8 launch) and `zone_resync` (a
rebuild: `prepare_zone`, its tape and launch).

`devices` (the JAX session's `row_sharding`) spreads the version rows over
several devices. The row count is rounded up to a multiple of
len(devices), as JAX rounds it to the mesh, so rows, evictions and resyncs
match. Between syncs the state rows rest in equal contiguous blocks, one a
device in device order (`state_blocks`; `carry.state` is then None), and
the rest of the carry stays on the first device, `self.device`. X8's steps
read and write any rows (FORK copies row a into row b, MAX merges them,
APPLY snapshots its row), so a block cannot step on its own device: a
tape run gathers the blocks onto the first device, launches X8 there once,
in place, and copies each block back to its device (`_on_lead`). JAX's
GSPMD moves rows between chips for the same reason.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..listmerge import plan2
from ..listmerge.compose import compose_entry
from ..listmerge.zone_np import prepare_zone
from ..obs.devprof import note_transfer
from ..text.op import INS, OpRun
from . import kernels, resolve_device
from .steer import _pow2
from .zone_kernel import (BIG32, OP_APPLY, OP_BEGIN, OP_FORK, OP_MAX,
                          ZoneTape, _fill_tape, assemble_text, entry_steps,
                          init_zone_carry, pack_zone_tape, tape_xs)


# why a sync rebuilt the carry: a run anchored at a frontier with no
# tracked row, an entry whose inserts overflow the slot capacity, an agent
# registered since the last build, or no state row left to take
RESYNC_CAUSES = ("untracked_frontier", "slot_capacity", "new_agent",
                 "rows_dry")

# the counters a session keeps until `take_counts` (module docstring):
#   syncs, continued, resynced   sync() calls that had new ops, and of
#                                them those that ran no rebuild / one or
#                                more
#   resync_<cause>               rebuilds by cause (RESYNC_CAUSES)
#   prep_native, prep_python     continued syncs whose micro-tape the C++
#                                composer and packer built / the Python
#                                ones (`_micro_tape`)
#   launches                     X8 launches (builds and rebuilds too)
#   steps_<kind>                 tape steps of each kind launched
#   apply_snap                   APPLY steps that snapshot their row
#   chars                        chars placed (n summed over APPLY steps)
#   ranks_before                 ranks placed before each APPLY step (m),
#                                summed over APPLY steps
#   <kind>_slots, snap_slots     slots swept by BEGIN / FORK / MAX steps
#                                and by snapshots: the tape's width W
#                                summed over those steps
#   width                        W summed over launches
#   tape_bytes                   the launched tapes' columns, in bytes
ZONE_COUNTS = (("syncs", "continued", "resynced")
               + tuple(f"resync_{c}" for c in RESYNC_CAUSES)
               + ("prep_native", "prep_python")
               + ("launches", "steps_begin", "steps_fork", "steps_max",
                  "steps_apply", "apply_snap", "chars", "ranks_before",
                  "begin_slots", "fork_slots", "max_slots", "snap_slots",
                  "width", "tape_bytes"))


class _NoClock:
    """A `FlushClock` stand-in for a sync outside a bank flush."""

    @staticmethod
    def enter_phase(phase) -> None:
        pass


_NO_CLOCK = _NoClock()


def _tape_shape(tape: ZoneTape, m: int) -> tuple:
    """`DeviceZoneSession._tally`'s shape of a tape from its columns, on a
    carry with `m` ranks placed. Every row is launched, the one row of a
    tape with no step too; only APPLY rows place chars or snapshot."""
    n = np.count_nonzero(tape.ch_slot >= 0, axis=1)
    kinds = np.bincount(tape.op, minlength=OP_APPLY + 1)
    apply = tape.op == OP_APPLY
    before = int(kinds[OP_APPLY]) * m + int((np.cumsum(n) - n)[apply].sum())
    return (int(kinds[OP_BEGIN]), int(kinds[OP_FORK]), int(kinds[OP_MAX]),
            int(kinds[OP_APPLY]), int(np.count_nonzero(tape.snap_flag)),
            int(n.sum()), before)


class DeviceZoneSession:
    """A live document resident on the device (see module docstring)."""

    # a zone sync has no length fence; the bank's device-time accounting
    # reads this as it reads a fused session's fence time
    fence_s = 0.0

    def __init__(self, oplog, n_rows: int = 8, headroom: float = 2.0,
                 max_blocks: int = 4, max_chars: int = 256,
                 max_dels: int = 8, device=None,
                 devices: Optional[Sequence] = None):
        self.oplog = oplog
        self.n_rows = n_rows
        self.headroom = headroom
        self.MB, self.MC, self.MD = max_blocks, max_chars, max_dels
        if devices is None:
            self.devices = None
            self.device = resolve_device(device)
        else:
            if device is not None:
                raise ValueError("device= and devices= are mutually "
                                 "exclusive")
            self.devices = [resolve_device(d) for d in devices]
            if not self.devices:
                raise ValueError("devices names no device")
            self.device = self.devices[0]
        self.state_blocks: Optional[List[torch.Tensor]] = None
        self.resyncs = -1          # first build counts up to 0
        self.merges = 0
        self._lru: Dict[Tuple[int, ...], int] = {}
        self._clock = 0
        self.counts = dict.fromkeys(ZONE_COUNTS, 0)
        self._micro = None         # the native MicroTapeContext, at first use
        self.resync()

    # ---- full (re)build --------------------------------------------------

    def resync(self, cause: Optional[str] = None,
                clock=_NO_CLOCK) -> None:
        """Rebuild device state from scratch, pinning one state row per
        agent head so every active branch is immediately tracked. `cause`
        (one of RESYNC_CAUSES; None for a build or a caller's own) is
        counted; the rebuild runs in `clock`'s "zone_resync" phase."""
        clock.enter_phase("zone_resync")
        if cause is not None:
            self.counts[f"resync_{cause}"] += 1
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
        if self.devices is not None:
            # equal row blocks: round up to the devices, as JAX rounds the
            # sharded row axis up to the mesh
            k = len(self.devices)
            n_rows = -(-n_rows // k) * k
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
        # every slot's (agent name rank, seq), as the native packer reads
        # them; `_alloc_slots` fills each new run's
        self.agent_k = np.zeros(W_cap, dtype=np.int64)
        self.seq_k = np.zeros(W_cap, dtype=np.int64)
        self.agent_k[:prep.W] = prep.agent_k
        self.seq_k[:prep.W] = prep.seq_k

        tape = pack_zone_tape(prep, self.MB, self.MC, self.MD)
        tape.W = W_cap     # slot ids are absolute: only the width differs
        self.carry = init_zone_carry(W_cap, prep.plen, n_rows, self.agent_k,
                                     self.seq_k, device=self.device)
        self.state_blocks = None
        self._m = prep.plen        # ranks placed: the carry's m, on the host
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

    def _on_lead(self, fn) -> None:
        """Call `fn()` on the whole carry on `self.device`. With `devices`,
        the state rows are first gathered from their blocks (unless a
        fresh carry already holds them) and afterwards copied back, one
        block a device; `carry.state` is None again after."""
        if self.devices is None:
            fn()
            return
        if self.carry.state is None:
            self.carry = self.carry._replace(state=torch.cat(
                [b.to(self.device) for b in self.state_blocks], dim=1))
        fn()
        state = self.carry.state
        per = state.shape[1] // len(self.devices)
        self.state_blocks = [state[:, k * per:(k + 1) * per].to(d, copy=True)
                             for k, d in enumerate(self.devices)]
        self.carry = self.carry._replace(state=None)

    def _tip_row(self, r: int) -> None:
        """state[r] <- the merged tip's visibility (1 = placed and never
        deleted, 2 = placed and deleted, 0 = unplaced), in place."""
        def build():
            c = self.carry
            row = torch.where(c.rank < int(BIG32),
                              torch.where(c.ever == 0, 1, 2), 0)
            c.state[:, min(max(r, 0), self.n_rows_eff - 1)] = \
                row.to(torch.uint8)
        self._on_lead(build)

    def _run_tape(self, tape: ZoneTape) -> None:
        """Continue the resident carry with `tape`, in place: one launch
        for the whole tape, on `self.device`. (The JAX session can cut it
        into slices, DT_SESSION_SLICE, for its TPU runtime's per-program
        time limit; the card has none.) The tape's upload is counted by
        `note_transfer`, untagged as in the JAX package; the port's tape
        is unpadded, so it moves fewer bytes than JAX's pow2-padded one.
        The launch and its tape's shape (`_tape_shape`) are counted
        (`ZONE_COUNTS`)."""
        xs = tape_xs(tape, self.device)
        nbytes = sum(v.nbytes for v in xs.values())
        note_transfer(nbytes)
        self._tally(_tape_shape(tape, self._m), int(tape.W), nbytes)
        self._on_lead(lambda: kernels.zone_tape_run(self.carry, xs,
                                                    tape.plen))

    def _tally(self, shape: tuple, W: int, nbytes: int) -> None:
        """Add one launch to the counters, and advance the host's copy of
        the carry's placed-rank count by its chars. `shape` is (BEGIN,
        FORK, MAX, APPLY steps, snapshotting APPLY steps, chars, ranks
        placed before each APPLY step summed)."""
        begin, fork, mx, apply, snaps, chars, before = shape
        c = self.counts
        c["launches"] += 1
        c["steps_begin"] += begin
        c["steps_fork"] += fork
        c["steps_max"] += mx
        c["steps_apply"] += apply
        c["apply_snap"] += snaps
        c["chars"] += chars
        c["ranks_before"] += before
        c["begin_slots"] += W * begin
        c["fork_slots"] += W * fork
        c["max_slots"] += W * mx
        c["snap_slots"] += W * snaps
        c["width"] += W
        c["tape_bytes"] += nbytes
        self._m += chars

    def take_counts(self) -> Dict[str, int]:
        """The counters since the last take (`ZONE_COUNTS`), zeroed."""
        out, self.counts = self.counts, dict.fromkeys(ZONE_COUNTS, 0)
        return out

    def _write_keys(self, w0: int) -> None:
        """The agent and seq keys of the slots [w0, W_used), which this
        sync allocated and its tape places, into the carry's key planes:
        every slot's keys are in place before the tape's first step reads
        any (module docstring, the divergence)."""
        w1 = self.W_used
        if w1 <= w0:
            return
        keys = torch.from_numpy(np.stack(
            [self.agent_k[w0:w1], self.seq_k[w0:w1]]).astype(np.int32))
        self.carry.agent_k[:, w0:w1] = keys[0]
        self.carry.seq_k[:, w0:w1] = keys[1]

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

    def _alloc_slots(self, pieces) -> bool:
        """Extend the slot map, the pool and the key arrays with the insert
        runs among an entry's op `pieces` (`OpStore.iter_range`). Returns
        False when capacity would overflow (caller resyncs)."""
        ins = [p for p in pieces if p.kind == INS]
        lens = np.fromiter((len(p) for p in ins), np.int64, len(ins))
        total = int(lens.sum())
        if self.W_used + total > self.W_cap:
            return False
        if not ins:
            return True
        w = self.W_used
        get = self.oplog.ops.get_run_content
        self.pool[w:w + total] = np.frombuffer(
            "".join(get(p) for p in ins).encode("utf-32-le"), dtype=np.int32)
        lv0 = np.fromiter((p.lv for p in ins), np.int64, len(ins))
        self.agent_k[w:w + total], self.seq_k[w:w + total] = self._keys(
            np.repeat(lv0 - (np.cumsum(lens) - lens), lens)
            + np.arange(total))
        self._lv0_list.extend(lv0.tolist())
        self._cum_list.extend((w - self.plen + np.cumsum(lens) - lens)
                              .tolist())
        self._slot_arrays_dirty = True
        self.W_used = w + total
        return True

    def sync(self, clock=_NO_CLOCK) -> int:
        """Fold every op appended to the oplog since the last sync into
        the device state. Returns the number of micro-steps executed
        (0 = nothing new). Resyncs transparently when needed. Its phases
        run on `clock` (a bank flush's `FlushClock`), which is left in
        the last one."""
        if self.synced_to >= len(self.oplog):
            return 0
        resyncs = self.resyncs
        steps = self._sync(clock)
        c = self.counts
        c["syncs"] += 1
        c["resynced" if self.resyncs != resyncs else "continued"] += 1
        return steps

    def _sync(self, clock) -> int:
        clock.enter_phase("zone_compose")
        ol = self.oplog
        # agent NAME RANKS are relative to the registered-name set; a new
        # agent shifts existing ranks, and the carry's key planes hold the
        # old epoch's ranks — rebuild before they can disagree
        if tuple(ol.cg.agent_assignment.agent_names) != self._agent_epoch:
            self.resync("new_agent", clock)
            return self._sync(clock)
        g = ol.cg.graph
        # split the new span into entries (same-parents runs)
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

        w0 = self.W_used
        runs0 = len(self._lv0_list)
        # (start, end, source rows, row) an entry, and the entries' op
        # pieces: the rows and slots are decided here, the entries
        # composed after the loop (`_micro_tape`)
        entries: List[Tuple[int, int, List[int], int]] = []
        pieces: List[OpRun] = []
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
                    self.resync("untracked_frontier", clock)
                    return self._sync(clock)
            # apply on a FRESH row (fork + max joins): source rows stay
            # tracked — two branches forking the same frontier is the
            # normal realtime shape and must not force a rebuild
            row = self._take_row(exclude=set(srcs))
            if row is None:
                self.resync("rows_dry", clock)
                return self._sync(clock)
            entry_pieces = list(ol.ops.iter_range((s, e)))
            if not self._alloc_slots(entry_pieces):
                self.resync("slot_capacity", clock)
                return self._sync(clock)
            pieces.extend(entry_pieces)
            entries.append((s, e, srcs, row))
            self.row_of[(e - 1,)] = row
            self._touch_key((e - 1,))

        n_steps = 0
        if entries:
            tape = self._micro_tape(entries, pieces, runs0)
            n_steps = tape.total_steps
            clock.enter_phase("zone_tape")
            self._write_keys(w0)
            self._run_tape(tape)
            self.merges += 1
        self.synced_to = end
        return n_steps

    def _micro_tape(self, entries, pieces, runs0: int) -> ZoneTape:
        """The sync's micro-tape, each entry a FORK of its first source
        row into its row, a MAX of each other source into it, then its
        APPLY sub-steps. Composed and packed in C++ (`_native_tape`) when
        the native engine is enabled and takes the entries, else by the
        Python composer and packer (`_python_tape`): array-identical
        tapes. Counted as `prep_native` / `prep_python`."""
        from ..native import native_enabled
        if native_enabled():
            tape = self._native_tape(entries, pieces, runs0)
            if tape is not None:
                self.counts["prep_native"] += 1
                return tape
        self.counts["prep_python"] += 1
        return self._python_tape(entries)

    def _native_tape(self, entries, pieces, runs0: int
                     ) -> Optional[ZoneTape]:
        """`dt_compose_plan` + `dt_zone_pack` on the session's scratch
        context, loaded with this sync's op `pieces` alone. Every LV is
        rebased to the sync's first, and so is the slot map passed: its
        runs from `runs0` on, this sync's, since the packer maps only the
        entries' own inserts to slots. None when the C++ refuses."""
        from ..native.core import MicroTapeContext
        base = entries[0][0]
        acts = []
        for k, (_s, _e, srcs, row) in enumerate(entries):
            acts.append((plan2.FORK, srcs[0], row))
            acts.extend((plan2.MAX, row, r) for r in srcs[1:])  # dst, src
            acts.append((plan2.APPLY, k, row))
        if self._micro is None:
            self._micro = MicroTapeContext()
        cols = self._micro.pack(
            [(r.lv - base, r.kind, r.fwd, r.start, r.end) for r in pieces],
            [(s - base, e - base) for s, e, _, _ in entries], acts,
            [lv - base for lv in self._lv0_list[runs0:]],
            self._cum_list[runs0:], self.plen, self.agent_k, self.seq_k,
            self.MB, self.MC, self.MD)
        if cols is None:
            return None
        return ZoneTape(**cols, W=self.W_cap, plen=self.plen,
                        n_idx=self.n_rows_eff, pool=self.pool[:self.W_used])

    def _python_tape(self, entries) -> ZoneTape:
        """The same tape from `compose_entry`, `_pack_entry` and
        `_fill_tape`."""
        steps: List[dict] = []
        for (s, e, srcs, row) in entries:
            pre_ops = [(OP_FORK, srcs[0], row)] + \
                [(OP_MAX, r, row) for r in srcs[1:]]
            ce = compose_entry(self.oplog, (s, e))
            steps.extend(self._pack_entry(ce, row, pre_ops))
        return _fill_tape(steps, self.W_cap, self.plen, self.n_rows_eff,
                          self.pool[:self.W_used], self.MB, self.MC, self.MD)

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
