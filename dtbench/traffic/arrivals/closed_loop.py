"""One client per document with no think time: a document's next sync is
sent as soon as its last one commits, until the window closes.

Numbers (the mix's "arrivals" block): ahead_syncs_per_doc_s, the syncs a
document is expected to send per second of window, for set-up to generate
(a faster program that outruns them generates the rest in the window, and
the result's notes count them)."""

import math


class Arrivals:
    def __init__(self, clients, p: dict) -> None:
        self.c = clients
        self.per_s = p["ahead_syncs_per_doc_s"]
        self.t_end = None

    def ahead(self, seconds: float) -> int:
        return 2 + math.ceil(seconds * self.per_s)      # warm one included

    def _all(self, t: float) -> None:
        for doc in self.c.order:
            self.c.send(doc, self.c.gens[doc].next_sync(), t)

    def warm(self, t: float) -> None:
        self._all(t)

    def start(self, t0: float, t_end: float) -> None:
        self.t_end = t_end
        self._all(t0)

    def next_due(self):
        return None

    def fire(self, now: float) -> None:
        pass

    def committed(self, s, t: float) -> None:
        if t < self.t_end:
            self.c.send(s.doc, self.c.gens[s.doc].next_sync(), t)
