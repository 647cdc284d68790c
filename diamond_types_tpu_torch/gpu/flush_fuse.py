"""Fused bucket flush: many documents, ONE device call per window.

Port of the JAX package's `tpu/flush_fuse.py`:

  * `FusedDocSession` — a document resident on the device as an int32
    `[cap]` char-code buffer + length. The pending op tail since the last
    sync is extracted HOST-side through the oplog's transformed-op stream
    (`get_xf_operations_full`), so concurrent/merged histories arrive as
    plain positional ops.
  * `plan_tail()` packs that tail into dense `(pos, dlen, ilen, chars)`
    rows, splitting long ops to `max_ins` exactly like `encode_trace_ops`.
  * `kernel_fused_replay(sessions, plans)` — the kernel rung, the
    counterpart of `pallas_fused_replay` and the per-shard path's rung —
    stacks the bucket into `[b, n, max_ins]` arrays (`n` and `b` padded to
    powers of two, padding rows replicating row 0's state with all-zero
    ops) and replays the whole window in one launch of the hand-written K1
    kernel (`kernels.apply_ops_window`) on CUDA sessions, or of its plain
    version on CPU sessions. `FusedDocSession.sync` replays one document
    the same way.

The flush window (`parallel/mesh.py::mesh_fused_replay`) replays a whole
window's rows across shards through the same K1 name and the same fence,
committing views of its output instead of clones (`adopt_results(...,
clone=False)`) and tagging them for its arena (`_arena_tag`).

Every launch runs at the pow2 floor of its batch and op counts: K1 is one
kernel for every shape, so padding further would only cost copies and
kernel work.

Contract violations (an op longer than `max_ins` reaching the device)
poison that DOCUMENT's length to -1. `adopt_results` commits only rows whose
returned length matches the host-side projection; the caller serves any
other document from `oplog.checkout_tip()`, and `FusedDocSession.sync`
raises `FenceMismatch` for one. That fence is the system's correctness
semantics, not a kernel fallback: the rung catches no exception.

Every host-to-device copy is counted by `obs.devprof.note_transfer` under
the JAX package's (rung, purpose) tags: a session's upload as
`session.stage` (its buffer and its length), each replay's op arrays as
`pallas.plan` for the kernel rung (the JAX name of the rung K1 ports) and
`fused.plan` for the per-doc sync.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..obs.devprof import note_transfer
from ..text.op import INS
from . import resolve_device
from .kernels import apply_ops_window
from .steer import _pow2, cap_class

DEFAULT_CAP = 1 << 10
DEFAULT_MAX_INS = 16


class FenceMismatch(RuntimeError):
    """A replayed row came back poisoned (-1) or at another length than
    the host projection: its session must not be trusted, and the caller
    serves the document from the host."""


@dataclass
class TailPlan:
    """Host-side packing of one doc's pending op tail (see
    FusedDocSession.plan_tail). `max_len` past the session cap means
    the plan does not fit — the caller resyncs at a larger capacity."""
    pos: np.ndarray
    dlen: np.ndarray
    ilen: np.ndarray
    chars: np.ndarray          # [n_ops, max_ins] int32
    n_ops: int
    new_len: int               # projected doc length after the tail
    max_len: int               # peak length the tail passes through
    frontier: Tuple[int, ...]  # oplog frontier after the tail
    synced_to: int             # oplog length the plan covers

    def fits(self, cap: int) -> bool:
        return self.max_len <= cap


def _empty_plan(frontier, synced_to, doc_len, mi) -> TailPlan:
    z = np.zeros(0, np.int32)
    return TailPlan(z, z, z, np.zeros((0, mi), np.int32), 0, doc_len,
                    doc_len, frontier, synced_to)


class FusedDocSession:
    """A live document resident on the device as the replay-kernel state:
    `[cap]` char codes + length. `device=None` means CUDA and raises when
    there is none; pass `device="cpu"` to keep the state on the CPU."""

    def __init__(self, oplog, cap: int = DEFAULT_CAP,
                 max_ins: int = DEFAULT_MAX_INS,
                 headroom: float = 2.0,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.device = resolve_device(device)
        self.oplog = oplog
        self.max_ins = int(max_ins)
        self.headroom = float(headroom)
        self.resyncs = -1          # the first build counts up to 0
        self.merges = 0
        self.fence_s = 0.0         # blocked on the last sync's fence
        self._materialize(min_cap=cap)

    # ---- full (re)build --------------------------------------------------

    def _materialize(self, min_cap: int = 0) -> None:
        """Host checkout -> device buffer. Always correct (the host
        tracker is the oracle); costs one full upload, so it only runs
        at build time and on capacity growth."""
        text = self.oplog.checkout_tip().snapshot()
        cap = cap_class(max(int(len(text) * self.headroom), min_cap))
        buf = np.zeros(cap, np.int32)
        if text:
            buf[:len(text)] = np.frombuffer(
                text.encode("utf-32-le"), dtype=np.int32)
        self.cap = cap
        self.docs = torch.from_numpy(buf).to(self.device)
        self.lens = torch.tensor(len(text), dtype=torch.int32,
                                 device=self.device)
        note_transfer(self.docs.nbytes + self.lens.nbytes,
                      rung="session", purpose="stage")
        self.doc_len = len(text)
        self.frontier = tuple(int(x) for x in self.oplog.version)
        self.synced_to = len(self.oplog)
        self.resyncs += 1
        # a rebuilt row is no window arena's row (parallel/arena.py)
        self._arena_tag = None

    # ---- host-side planning ----------------------------------------------

    def plan_tail(self) -> TailPlan:
        """Pack every op appended since the last sync into dense
        positional rows. Pure read — commit() applies the bookkeeping,
        so a plan can be dropped (fallback, eviction) at zero cost.
        Concurrent/merged histories come back pre-transformed by the
        host oracle; `pos is None` rows (deletes that already
        happened) are no-ops and are skipped."""
        ol = self.oplog
        if self.synced_to >= len(ol):
            return _empty_plan(self.frontier, self.synced_to,
                               self.doc_len, self.max_ins)
        mi = self.max_ins
        xf = ol.get_xf_operations_full(list(self.frontier), ol.version)
        rows: List[Tuple[int, int, int, str]] = []
        cur = self.doc_len
        peak = cur
        for _lv, op, pos in xf:
            if pos is None:
                continue
            if op.kind == INS:
                content = ol.ops.get_run_content(op)
                if not op.fwd:
                    content = content[::-1]
                off = 0
                while off < len(content):
                    chunk = content[off:off + mi]
                    rows.append((pos + off, 0, len(chunk), chunk))
                    off += len(chunk)
                cur += len(content)
                peak = max(peak, cur)
            else:
                d = len(op)
                while d:
                    k = min(d, mi)
                    rows.append((pos, k, 0, ""))
                    d -= k
                cur -= len(op)
        k = len(rows)
        frontier = tuple(int(x) for x in xf.next_frontier)
        if k == 0:
            plan = _empty_plan(frontier, len(ol), self.doc_len, mi)
            plan.max_len = peak
            return plan
        pos_a = np.zeros(k, np.int32)
        dl_a = np.zeros(k, np.int32)
        il_a = np.zeros(k, np.int32)
        ch_a = np.zeros((k, mi), np.int32)
        for i, (p, d, il, s) in enumerate(rows):
            pos_a[i] = p
            dl_a[i] = d
            il_a[i] = il
            if s:
                ch_a[i, :il] = np.frombuffer(
                    s.encode("utf-32-le"), dtype=np.int32)
        return TailPlan(pos_a, dl_a, il_a, ch_a, k, cur, peak, frontier,
                        len(ol))

    def commit(self, docs: torch.Tensor, lens: torch.Tensor,
               plan: TailPlan) -> None:
        """Adopt one replay result row + the plan's bookkeeping. The row
        is the session's own clone on the per-shard rungs, and a view of
        the window's output on the flush window's (which then tags it,
        `parallel/arena.py`); nothing writes it in place either way. Any
        commit clears the arena tag: the window re-tags its own rows
        after this."""
        self.docs = docs
        self.lens = lens
        self._arena_tag = None
        self.doc_len = plan.new_len
        self.frontier = plan.frontier
        self.synced_to = plan.synced_to
        if plan.n_ops:
            self.merges += 1

    def commit_host(self, plan: TailPlan) -> None:
        """Adopt an EMPTY plan (frontier advanced, no visible ops —
        e.g. deletes of already-deleted spans): no device work."""
        assert plan.n_ops == 0
        self.frontier = plan.frontier
        self.synced_to = plan.synced_to

    def resync_for(self, plan: TailPlan) -> None:
        """Rebuild at a capacity that holds `plan`'s peak length (the
        plan did not fit). The rebuild reads the whole oplog, so the
        plan is consumed."""
        self._materialize(min_cap=_pow2(int(plan.max_len * self.headroom)))

    # ---- merge path ------------------------------------------------------

    def sync(self) -> int:
        """Per-doc path: plan, then replay this doc alone through K1 (its
        plain version on a CPU session). Resyncs on capacity overflow. Raises
        `FenceMismatch` on a poisoned or mismatched result (the caller
        evicts the session and serves the doc from the host); any other
        exception is a fault and propagates."""
        self.fence_s = 0.0
        plan = self.plan_tail()
        if not plan.fits(self.cap):
            self.resync_for(plan)
            return 0
        if plan.n_ops == 0:
            self.commit_host(plan)
            return 0
        ok, self.fence_s = _replay([self], [plan], "fused")
        if not ok[0]:
            raise FenceMismatch(
                "replay poisoned/mismatched length "
                f"(doc_len {self.doc_len}, plan {plan.new_len})")
        return plan.n_ops

    # ---- reads -----------------------------------------------------------

    def text(self) -> str:
        """Fetch and decode the merged document (device parity surface:
        the answer comes from the replay state, not the host tracker)."""
        n = self.doc_len
        return self.docs[:n].cpu().numpy().astype(np.int32).tobytes() \
            .decode("utf-32-le")

    def footprint_slots(self) -> int:
        """Device residency in int32 slots: the doc buffer dominates."""
        return int(self.cap)


def pack_plans(plans: Sequence[TailPlan], n: int, mi: int,
               bp: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """Stack `plans` into dense host-side op arrays
    (pos/dlen/ilen [bp, n], chars [bp, n, mi]). Rows past len(plans)
    are all-zero no-ops — the inert padding the pow2 batch rounding
    relies on."""
    pos = np.zeros((bp, n), np.int32)
    dlen = np.zeros((bp, n), np.int32)
    ilen = np.zeros((bp, n), np.int32)
    chars = np.zeros((bp, n, mi), np.int32)
    for i, p in enumerate(plans):
        k = p.n_ops
        pos[i, :k] = p.pos
        dlen[i, :k] = p.dlen
        ilen[i, :k] = p.ilen
        chars[i, :k] = p.chars
    return pos, dlen, ilen, chars


def pack_bucket(sessions: Sequence[FusedDocSession],
                plans: Sequence[TailPlan]) -> List[torch.Tensor]:
    """A bucket's window inputs on its device: (docs [bp, cap], lens [bp],
    pos/dlen/ilen [bp, n], chars [bp, n, max_ins]). `n` pads to a power of
    two and `b` to `bp`, a power of two; padding rows replicate row 0's
    docs and lens and carry all-zero ops."""
    b = len(sessions)
    s0 = sessions[0]
    n = _pow2(max(max(p.n_ops for p in plans), 1))
    bp = _pow2(b) if b > 1 else 1
    ops = [torch.from_numpy(a).to(s0.device)
           for a in pack_plans(plans, n, s0.max_ins, bp)]
    docs = torch.stack([s.docs for s in sessions] + [s0.docs] * (bp - b))
    lens = torch.stack([s.lens for s in sessions] + [s0.lens] * (bp - b))
    return [docs, lens] + ops


def adopt_results(sessions: Sequence[FusedDocSession],
                  plans: Sequence[TailPlan],
                  out_docs: torch.Tensor, out_lens: torch.Tensor,
                  got: np.ndarray, clone: bool = True) -> List[bool]:
    """The returned-length fence: commit each session whose device length
    matches the host-side projection; a poisoned (-1) or drifting row is
    NOT committed (the caller evicts it and serves the doc from the host
    engine). With `clone` (the per-shard rungs) a committed row is cloned
    out of the batch, so the session owns its buffer and the batch is
    freed with the window; the flush window passes False and commits the
    view `out_docs[i]`, since it parks the batch as its arena anyway."""
    ok: List[bool] = []
    for i, (sess, plan) in enumerate(zip(sessions, plans)):
        good = int(got[i]) == plan.new_len and int(got[i]) >= 0
        if good:
            row, ln = out_docs[i], out_lens[i]
            if clone:
                row, ln = row.clone(), ln.clone()
            sess.commit(row, ln, plan)
        ok.append(good)
    return ok


def fetch_lengths(out_lens: torch.Tensor) -> np.ndarray:
    """The completion fence: the replayed lengths fetched to the host,
    which waits for the replay to finish."""
    return out_lens.cpu().numpy()


# the JAX package's transfer tag for each replay rung (its cache names):
# the port's kernel rung is the counterpart of `pallas_fused_replay`
_TRANSFER_RUNG = {"kernel": "pallas"}


def _replay(sessions: List[FusedDocSession], plans: List[TailPlan],
            cache: str, clock=None) -> Tuple[List[bool], float]:
    """Pack a bucket at its pow2 floor, launch K1 once over it, and fence
    the results. All sessions share (cap, max_ins, device). `cache` names
    the rung ("kernel" or "fused") only for the transfer tag of its plan
    arrays. Returns (ok-per-session, seconds blocked on the length fetch,
    which is the completion fence).

    `clock` (a `serve.metrics.FlushClock`, its "pack" phase running) is
    switched to "fence" at the length fetch and to "adopt" for the
    commits. The per-doc sync passes none: the serial rung that runs it
    counts its pack and fence as its own."""
    b = len(sessions)
    if b < 1 or b != len(plans):
        raise ValueError(f"{b} sessions for {len(plans)} plans")
    s0 = sessions[0]
    for s in sessions:
        if (s.cap, s.max_ins, s.device) != (s0.cap, s0.max_ins, s0.device):
            raise ValueError("a bucket must share cap, max_ins and device")
    args = pack_bucket(sessions, plans)
    note_transfer(sum(a.nbytes for a in args[2:]),
                  rung=_TRANSFER_RUNG.get(cache, cache), purpose="plan")
    out_docs, out_lens = apply_ops_window(*args, s0.max_ins)
    if clock is not None:
        clock.enter_phase("fence")
    t_fence = time.perf_counter()
    got = fetch_lengths(out_lens)
    device_s = time.perf_counter() - t_fence
    if clock is not None:
        clock.enter_phase("adopt")
    return adopt_results(sessions, plans, out_docs, out_lens, got), device_s


def kernel_fused_replay(sessions: List[FusedDocSession],
                        plans: List[TailPlan],
                        clock=None) -> Tuple[List[bool], float]:
    """The kernel rung, the counterpart of `pallas_fused_replay`: the
    bucket's window in ONE launch of K1 on CUDA sessions (K1's plain
    version on CPU sessions). `clock`: the flush's phase timer, as
    `_replay` takes it."""
    return _replay(sessions, plans, "kernel", clock)
