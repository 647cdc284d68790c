"""One typist per document whose keystroke batches fall due every
`interval_s` seconds, each document at its own phase drawn from the seed.
A batch due while its document's sync is in flight is folded into the
next sync, sent when that one commits (its due time the oldest batch's).

Numbers (the mix's "arrivals" block): interval_s."""

import heapq
import math

import numpy as np

from dtbench.traffic.generate import fold


class Arrivals:
    def __init__(self, clients, p: dict) -> None:
        self.c = clients
        self.period = p["interval_s"]
        self.due = []                  # (time, doc) of batches
        self.t_end = None

    def ahead(self, seconds: float) -> int:
        return 2 + math.ceil(seconds / self.period)     # warm one included

    def warm(self, t: float) -> None:
        for doc in self.c.order:
            self.c.send(doc, self.c.gens[doc].next_sync(), t)

    def start(self, t0: float, t_end: float) -> None:
        self.t_end = t_end
        rng = np.random.default_rng([self.c.seed, 1 << 20])
        phases = rng.random(len(self.c.order)) * self.period
        self.due = [(t0 + ph, doc) for ph, doc in zip(phases, self.c.order)]
        heapq.heapify(self.due)

    def next_due(self):
        return self.due[0][0] if self.due else None

    def fire(self, now: float) -> None:
        """Batches that fell due: typed now, sent or folded."""
        c, due = self.c, self.due
        while due and due[0][0] <= now:
            t_due, doc = heapq.heappop(due)
            if t_due >= self.t_end:
                due.clear()
                return
            if now - t_due > c.late_s:
                c.late_s, c.late_at_s = now - t_due, t_due - c.t0
            c.batches += 1
            batch = c.gens[doc].next_sync()
            if doc in c.inflight:
                c.folded.setdefault(doc, []).append((t_due, batch))
            else:
                c.send(doc, batch, t_due)
            heapq.heappush(due, (t_due + self.period, doc))

    def committed(self, s, t: float) -> None:
        batches = self.c.folded.pop(s.doc, None)
        if batches:
            self.c.send(s.doc, fold([b for _t, b in batches]), batches[0][0])
