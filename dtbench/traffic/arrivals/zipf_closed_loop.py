"""A fixed number of closed-loop clients with no think time over a corpus
far larger than they: each of a client's syncs goes to a document drawn by
Zipf(s) over the document's rank (rank order is document order, `doc0` the
head, as the port's `workload/popularity.py` `Zipf` has it), and is sent as
soon as the client's last sync commits, until the window closes. A draw
that lands on a document with a sync in flight is drawn again, since a
document has one sync in flight at most.

The draws come from one generator seeded by the run's seed, so the
sequence of draws is fixed; which of them are drawn again depends on the
timing.

The warm-up runs the same loop, on a generator of its own, until it has
sent `warm_syncs` syncs, then waits for them: the window opens on the
steady state, with the card's sessions and the warm tier full and evicting,
and not on the fill that follows a restart.

Numbers (the mix's "arrivals" block): clients, zipf_s, warm_syncs, and for
set-up ahead_syncs_per_s (the syncs the tier is expected to commit a
second) and ahead_margin. Set-up plays the warm-up's and the window's
syncs through the same loop once, on a generator of its own, with the
syncs in flight committing in the order they were sent: each document gets
the syncs it took there, times the margin, plus two (one for a tail
document the rehearsal missed), generated in set-up (a faster program that
outruns them generates the rest in the window, and the result's notes
count them). The head's documents are busy most of the time, so the tail
takes more than its Zipf share."""

import collections
import math
import queue

import numpy as np

DRAWS = 64          # draws taken from the generator at once


class Arrivals:
    def __init__(self, clients, p: dict) -> None:
        self.c = clients
        self.n_clients = int(p["clients"])
        if 2 * self.n_clients > len(clients.order):
            raise ValueError(f"{self.n_clients} clients over "
                             f"{len(clients.order)} documents: a client "
                             "would wait on the tail's draws")
        self.per_s = float(p["ahead_syncs_per_s"])
        self.margin = float(p["ahead_margin"])
        self.warm_syncs = int(p.get("warm_syncs", 0))
        w = 1.0 / np.arange(1, len(clients.order) + 1) ** float(p["zipf_s"])
        self.share = w / w.sum()
        self.cdf = np.cumsum(self.share)
        self.cdf[-1] = 1.0
        self.rng = np.random.default_rng([clients.seed, 3 << 20])
        self.warm_rng = np.random.default_rng([clients.seed, 5 << 20])
        self.drawn: list = []
        self.redrawn = 0            # draws that landed on a busy document
        self.t_end = None

    def ahead(self, seconds: float) -> int:
        """Each document's syncs in a rehearsal of the window (module
        docstring), generated here; the count every document gets besides
        (0)."""
        n = len(self.c.order)
        rng = np.random.default_rng([self.c.seed, 4 << 20])
        busy, inflight = set(), collections.deque()
        taken = np.zeros(n, dtype=np.int64)
        plays = 2 * self.n_clients + self.warm_syncs \
            + math.ceil(self.per_s * seconds)
        for _ in range(plays):
            if len(inflight) == self.n_clients:
                busy.discard(inflight.popleft())
            while True:
                i = int(np.searchsorted(self.cdf, rng.random(),
                                        side="right"))
                if i not in busy:
                    break
            busy.add(i)
            inflight.append(i)
            taken[i] += 1
        for d, k in zip(self.c.order, taken):
            self.c.gens[d].prepare(2 + math.ceil(self.margin * k))
        return 0

    def draw(self, rng=None) -> str:
        """The next document by Zipf rank with no sync in flight, from the
        window's generator (or `rng`'s, the warm-up's)."""
        busy = self.c.inflight
        if rng is not None:
            while True:
                doc = self.c.order[int(np.searchsorted(
                    self.cdf, rng.random(), side="right"))]
                if doc not in busy:
                    return doc
        while True:
            if not self.drawn:
                idx = np.searchsorted(self.cdf, self.rng.random(DRAWS),
                                      side="right")
                self.drawn = [self.c.order[i] for i in idx[::-1]]
            doc = self.drawn.pop()
            if doc not in busy:
                return doc
            self.redrawn += 1

    def _send(self, t: float, rng=None) -> None:
        doc = self.draw(rng)
        self.c.send(doc, self.c.gens[doc].next_sync(), t)

    def warm(self, t: float, timeout_s: float = 600.0) -> None:
        """One sync a client, then the loop until `warm_syncs` more are
        sent (module docstring); the caller waits for the last ones."""
        c = self.c
        for _ in range(self.n_clients):
            self._send(t, self.warm_rng)
        deadline = c.clock() + timeout_s
        for _ in range(self.warm_syncs):
            while True:
                left = deadline - c.clock()
                if left <= 0:
                    raise TimeoutError(f"warm-up: {len(c.inflight)} syncs "
                                       f"not committed after {timeout_s} s")
                try:
                    doc, at = c.commits.get(timeout=left)
                except queue.Empty:
                    continue
                if c._commit(doc, at) is not None:
                    break
            self._send(at, self.warm_rng)

    def start(self, t0: float, t_end: float) -> None:
        self.t_end = t_end
        for _ in range(self.n_clients):
            self._send(t0)

    def next_due(self):
        return None

    def fire(self, now: float) -> None:
        pass

    def committed(self, s, t: float) -> None:
        if t < self.t_end:
            self._send(t)
