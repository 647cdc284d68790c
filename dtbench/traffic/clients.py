"""The clients: when each sync is sent, and when it counts as visible.

A mix's "arrivals" block names its shape, `arrivals/<kind>.py`, whose
`Arrivals` class decides when syncs are sent; this module holds what every
shape shares. Every shape keeps at most one sync in flight per document (a
client folds what it edits meanwhile into its next sync, as diamond-types'
sync clients do), so every commit belongs to exactly one sync.

A sync's latency runs from its due time (the moment its client became
ready, or for a folded sync the due time of its oldest batch) to the
commit of its document, read on the clock the commit hook stamps. Every
sync sent before the window closes, and every batch due before then, is
timed to its commit, even when that falls in the drain.

The clients run on the caller's thread, in the program's process, as a
server's ingest does. What they cost that thread is recorded beside the
result (`stalls`): the longest wait to append a sync's ops under the oplog
lock, to submit it, and to wake for a due batch or a commit.
"""

from __future__ import annotations

import queue
import time
from typing import Dict, List, Optional

from dtbench import plugins

from .generate import DocGen, n_ops


class Sync:
    __slots__ = ("doc", "due", "n_ops", "committed")

    def __init__(self, doc: str, due: float, n: int) -> None:
        self.doc, self.due, self.n_ops = doc, due, n
        self.committed: Optional[float] = None


class Clients:
    """Drives one tier with one mix's arrivals from one thread: the caller's.

    `tier` has `append(doc_id, sync)` and `submit(doc_id, n_ops) -> dict`;
    `on_commit` is the tier's commit hook."""

    def __init__(self, gens: List[DocGen], tier, arrivals: dict, seed: int,
                 clock=time.perf_counter) -> None:
        self.gens = {g.doc_id: g for g in gens}
        self.order = [g.doc_id for g in gens]
        self.tier = tier
        self.clock = clock
        self.seed = seed
        # a queue.Queue, not a SimpleQueue: its get waits in Python
        # (threading), so the traced run's host sampler sees it as waiting
        self.commits: "queue.Queue" = queue.Queue()
        self.inflight: Dict[str, Sync] = {}
        self.folded: Dict[str, List[tuple]] = {}    # doc -> [(due, sync)]
        self.t_end: Optional[float] = None
        self.t0 = 0.0
        self.reset()
        self.shape = plugins.load("traffic/arrivals",
                                  arrivals["kind"]).Arrivals(self, arrivals)

    def prepare(self, seconds: float) -> None:
        """Generate, in set-up, every sync a window of `seconds` should
        send (and the warm-up's)."""
        k = self.shape.ahead(seconds)
        for g in self.gens.values():
            g.prepare(k)

    def on_commit(self, doc_id: str) -> None:
        """The scheduler's commit hook (called on its flush threads)."""
        self.commits.put((doc_id, self.clock()))

    # ---- sending -----------------------------------------------------------

    def send(self, doc: str, sync: dict, due: float) -> None:
        gen = self.gens[doc]
        gen.syncs.append(sync)
        n = n_ops(sync)
        t = self.clock()
        self.tier.append(doc, sync)
        t_append = self.clock()
        self.inflight[doc] = Sync(doc, due, n)
        res = self.tier.submit(doc, n)
        while not res.get("accepted"):
            # refused (backpressure): counted, and sent again once the
            # scheduler's retry_after has passed; its ops are in the log
            self.refused += 1
            time.sleep(float(res.get("retry_after") or 0.01))
            res = self.tier.submit(doc, n)
        self._stall("append_s", t_append - t, t)
        self._stall("submit_s", self.clock() - t_append, t)

    def _stall(self, key: str, s: float, at: float) -> None:
        if s > self.stalls[key]:
            self.stalls[key] = s
            self.stalls[key.replace("_s", "_at_s")] = at - self.t0

    def _commit(self, doc: str, t: float) -> Optional[Sync]:
        s = self.inflight.pop(doc, None)
        if s is None:
            return None        # a flush of a document with nothing in flight
        s.committed = t
        self.done.append(s)
        return s

    # ---- the loop ----------------------------------------------------------

    def start(self, t0: float, t_end: float) -> None:
        """Open the window at `t0`, closing at `t_end`."""
        self.t0, self.t_end = t0, t_end
        self.shape.start(t0, t_end)

    def step_until(self, stop_at: float) -> bool:
        """Offer the load until `stop_at` (past the window's close only
        the syncs sent or due before it are served). True once nothing is
        in flight, folded or due."""
        shape = self.shape
        while True:
            now = self.clock()
            shape.fire(now)
            nxt = shape.next_due()
            if nxt is None and not self.inflight and not self.folded:
                return True
            if now >= stop_at:
                return False
            wait = stop_at - now
            if nxt is not None:
                wait = min(wait, max(nxt - now, 0.0))
            wait = max(wait, 1e-4)
            try:
                doc, t = self.commits.get(timeout=wait)
            except queue.Empty:
                # woken late: this thread waited for the interpreter
                self._stall("wake_s", self.clock() - now - wait, now)
                continue
            s = self._commit(doc, t)
            if s is not None:
                shape.committed(s, t)

    def warm(self, timeout_s: float) -> None:
        """One sync of the mix per client, sent at once, all committed
        before it returns."""
        self.shape.warm(self.clock())
        self.wait_all(timeout_s)

    def wait_all(self, timeout_s: float) -> None:
        deadline = self.clock() + timeout_s
        while self.inflight:
            left = deadline - self.clock()
            if left <= 0:
                raise TimeoutError(f"{len(self.inflight)} syncs not "
                                   f"committed after {timeout_s} s")
            try:
                doc, t = self.commits.get(timeout=left)
            except queue.Empty:
                continue
            self._commit(doc, t)

    def send_bases(self, t: float) -> None:
        """Every document's base sync (its history so far), for the warm-up
        that builds the sessions."""
        for doc in self.order:
            sync = self.gens[doc].syncs.pop(0)
            self.send(doc, sync, t)

    def reset(self) -> None:
        """Forget the warm-up's syncs (their ops stay in the record)."""
        self.done: List[Sync] = []
        self.refused = 0
        self.late_s = 0.0                # how late due batches were typed
        self.late_at_s = 0.0
        self.batches = 0                 # batches typed (interval arrivals)
        self.stalls = {"append_s": 0.0, "append_at_s": 0.0,
                       "submit_s": 0.0, "submit_at_s": 0.0,
                       "wake_s": 0.0, "wake_at_s": 0.0}
