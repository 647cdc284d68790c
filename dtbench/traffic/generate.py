"""The one traffic generator: documents and the syncs clients send.

A traffic mix is a JSON file beside this one (`dtbench/traffic/<mix>.json`).
Its "docs" block sizes the documents, read here; its "edits" block names
the shape of a sync (`edits/<kind>.py`) with that shape's numbers; its
"arrivals" block names when syncs are sent (`arrivals/<kind>.py`), read by
`dtbench.traffic.clients`. Nothing here merges: each document's merged
length is tracked from the ops themselves, so a generated op is always in
range in its own view.

Every document draws from its own generator, seeded by (seed, document,
stream), so its k-th sync is the same in every run of a seed whatever the
timing; only how syncs fold together (open arrivals) depends on it. The
syncs a run will send are generated in set-up (`DocGen.prepare`), so the
window spends no time generating.
"""

from __future__ import annotations

import collections
from typing import List

import numpy as np

from dtbench import plugins

# seeded random characters, multi-byte ones included (copied from the
# port's chip_smoke.py ALPHABET)
ALPHABET = "abcdefghijklmnopqrstuvwxyz      ,.\nAEIOUé中文😀"
_ALPHA = np.array(list(ALPHABET))
BASE_AGENT = "typist"
POOL = 1 << 12          # chars of a document's pool of random text


def rand_text(rng: np.random.Generator, k: int) -> str:
    return "".join(_ALPHA[rng.integers(0, len(_ALPHA), k)])


class TextPool:
    """Seeded random characters, drawn in bulk once: a k-char insert is a
    slice at a random offset."""

    def __init__(self, rng: np.random.Generator) -> None:
        self.text = rand_text(rng, POOL) * 2
        self.rng = rng

    def take(self, k: int) -> str:
        off = int(self.rng.integers(0, POOL))
        return self.text[off:off + k]


class DocGen:
    """One document's client side: its merged length, the typist's cursor,
    its generator and its edit shape. `syncs` is the benchmark's own record
    of every sync the document was sent, base included, which the
    reference replays."""

    def __init__(self, seed: int, index: int, docs: dict, edits: dict):
        self.doc_id = f"doc{index}"
        self.edits = edits
        self.shape = plugins.load("traffic/edits", edits["kind"])
        self.rng = np.random.default_rng([seed, index, 1])
        base_rng = np.random.default_rng([seed, index, 0])
        self.pool = TextPool(self.rng)
        base_pool = TextPool(base_rng)
        n = int(base_rng.integers(docs["base_min"], docs["base_max"] + 1))
        ops, done = [], 0
        while done < n:             # typed in runs of run_min..run_max
            k = min(n - done, int(base_rng.integers(docs["run_min"],
                                                    docs["run_max"] + 1)))
            ops.append(("i", done, base_pool.take(k)))
            done += k
        self.length = n
        self.cursor = n
        self.syncs: List[dict] = [{"chains": [(BASE_AGENT, ops)],
                                   "top": None}]
        self.ahead: "collections.deque" = collections.deque()
        self.made_late = 0          # syncs generated after set-up

    def agents(self) -> List[str]:
        """Every agent name this document's traffic uses, base first."""
        return [BASE_AGENT, *self.shape.agents(self.edits)]

    def prepare(self, k: int) -> None:
        """Generate the next `k` syncs now (set-up), in order."""
        for _ in range(k):
            self.ahead.append(self.shape.next_sync(self, self.edits))

    def next_sync(self) -> dict:
        """The next sync's ops (the sender records what it sends in
        `syncs`: a folded sync is recorded once)."""
        if self.ahead:
            return self.ahead.popleft()
        self.made_late += 1
        return self.shape.next_sync(self, self.edits)


def n_ops(sync: dict) -> int:
    """Ops a sync carries (the count the scheduler is told)."""
    return sum(len(ops) for _a, ops in sync["chains"]) \
        + (1 if sync.get("top") is not None else 0)


def fold(syncs: List[dict]) -> dict:
    """Several linear syncs of one agent as one (a client that folds the
    edits it made while its last sync was in flight)."""
    agent = syncs[0]["chains"][0][0]
    if any(s.get("top") is not None or len(s["chains"]) != 1
           or s["chains"][0][0] != agent for s in syncs):
        raise ValueError("only linear syncs of one agent fold")
    ops = [op for s in syncs for op in s["chains"][0][1]]
    return {"chains": [(agent, ops)], "top": None}


def make_docs(seed: int, n_docs: int, docs: dict,
              edits: dict) -> List[DocGen]:
    return [DocGen(seed, i, docs, edits) for i in range(n_docs)]
