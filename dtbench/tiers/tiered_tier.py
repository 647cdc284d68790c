"""The port's merge tier over its residency tier, in-process: a corpus of
documents far larger than the card's resident set, most of them cold in
their durable homes.

Wired as the port's `serve/README.md` "Tiered residency" section and its
`storage/soak.py` wire it: a `TieredStore` (one `PagedDocFile` home a
document, its default compaction) over a temporary directory of its own,
a `Hydrator` over it with the oplog lock, a `MergeScheduler` on the device
engine (`fused`, `device_plan`, the configuration's shards and bounds) with
`resolve=hydrator.resolve`, then `attach_hydrator`, and the server's
`Observability` bundle attached at its sampling. The ladder then runs as
on a server: a sync to a cold document resolves it (a cold open), a flush
gates on warmth, a miss on the card builds a session, and every eviction,
from the card or from the warm tier, persists the document first.

Each sync appends its ops through `Hydrator.edit`, under the oplog lock,
on the document's warm op log (looking its agents up by name there), then
calls `submit(doc_id, n_ops)`. Set-up ends with a restart over the
corpus it wrote: once every document's base has committed, the next sync
first stops the tier (the scheduler drained, the hydrator stopped with its
checkpoint, so every base is in its home) and starts it anew over the same
homes, with an empty warm tier and no session on the card; the mix's
warm-up then fills both (`traffic/arrivals/zipf_closed_loop.py`).

`residency(doc)` is "resident" for a session on the card caught up with
the document's ops, "lagging" for one behind them, and for a document with
no session on the card "resident" when its warm op log or its home holds
every op appended to it ("lagging" when either lacks one: an op lost on
the way down the ladder). `text(doc)` reads through `MergeScheduler.text`,
which loads a cold document from its home. The documents the check reads
are counted as on the card, warm or cold at the read; `close` prints the
counts, and the tier's counters, on standard error.

Configuration keys: merge_tier's, and corpus_docs, warm_max,
hydrator (the Hydrator's options) and compact_patch_records.
"""

from __future__ import annotations

import sys
import tempfile
import threading
from typing import Callable, Dict, List

from dtbench.tiers import append_sync


class Homes:
    """The documents' op logs for the check's diagnosis, readable after
    the tier has stopped: a warm one while the hydrator holds it, else a
    fresh load of the home. Holds the homes' directory until it is
    dropped."""

    def __init__(self, tier: "Tier") -> None:
        self.tier = tier
        self.dir = tier.dir

    def __getitem__(self, doc_id: str):
        from diamond_types_tpu_torch.storage.tier import TieredStore
        ol = self.tier.hyd.warm_oplog(doc_id)
        if ol is None:
            ol = TieredStore(self.dir.name).load(doc_id)
        return ol


class Tier:
    def __init__(self, config: dict, device, on_commit: Callable[[str], None]):
        from diamond_types_tpu_torch.serve import metrics as sm
        from diamond_types_tpu_torch.serve.hydrate import Hydrator
        if not {"build", "gate"} <= set(sm.FLUSH_PHASES) \
                or not hasattr(sm, "RESIDENCY_TIMERS") \
                or not hasattr(Hydrator, "edit"):
            raise RuntimeError(
                "this program has no residency timers (the flush phases "
                "build and gate, metrics_json()['residency']) and no "
                "Hydrator.edit: the tiered cell cannot run on it")

        self.config, self.device = config, device
        self.lock = threading.Lock()            # the DocStore's oplog lock
        self.dir = tempfile.TemporaryDirectory(prefix="dtbench-homes-")
        self.agents: Dict[str, List[str]] = {}
        self.lengths: Dict[str, int] = {}       # ops appended, by doc
        self.home_lengths: Dict[str, int] = {}  # ops in its home, by doc
        self.on_commit = on_commit
        self.bases = set()          # documents whose base has not committed
        self.restarted = False
        self.read_states = {"card": 0, "warm": 0, "cold": 0}
        self.oplogs = Homes(self)
        self._start()

    def _start(self) -> None:
        """The store, the hydrator and the scheduler over the homes'
        directory, wired as the module docstring says."""
        from diamond_types_tpu_torch.obs import Observability
        from diamond_types_tpu_torch.serve.hydrate import Hydrator
        from diamond_types_tpu_torch.serve.scheduler import MergeScheduler
        from diamond_types_tpu_torch.storage.tier import TieredStore
        config = self.config
        self.store = TieredStore(
            self.dir.name,
            compact_patch_records=config["compact_patch_records"],
            on_persist=self._persisted)
        self.hyd = Hydrator(self.store, warm_max=config["warm_max"],
                            oplog_lock=self.lock, **config["hydrator"])
        self.sched = MergeScheduler(
            config["serve_shards"], resolve=self.hyd.resolve,
            engine="device", fused=config["fused"],
            device_plan=config["device_plan"],
            fused_opts={"device": self.device},
            max_sessions_per_shard=config["max_sessions_per_shard"],
            max_slots_per_shard=config["max_slots_per_shard"],
            flush_docs=config["flush_docs"],
            flush_deadline_s=config["flush_deadline_s"],
            max_pending=config["max_pending"],
            mesh_window=config["mesh_window"], sync_lock=self.lock)
        self.sched.attach_hydrator(self.hyd)
        self.obs = Observability(sample_rate=config["obs_sample_rate"])
        self.sched.attach_obs(self.obs)
        self.sched.read_invalidate = self._committed

    def _stop(self) -> None:
        try:
            self.sched.stop_pump(drain=True)
        finally:
            self.hyd.stop(checkpoint=True)

    def _persisted(self, doc_id: str, home) -> None:
        """`TieredStore.on_persist`: the ops the home holds now (called
        once the save's write has landed, under the doc's io lock)."""
        self.home_lengths[doc_id] = len(home)

    def _committed(self, doc_id: str) -> None:
        self.bases.discard(doc_id)
        self.on_commit(doc_id)

    def add_doc(self, doc_id: str, agents: List[str]) -> None:
        """A document of the corpus, with the agents its traffic uses
        (registered on its op log by its first sync)."""
        self.agents[doc_id] = agents
        self.lengths[doc_id] = 0
        self.bases.add(doc_id)

    def append(self, doc_id: str, sync: dict) -> None:
        """The sync's ops into the document's warm op log, under the oplog
        lock, forked from its version; a cold document is loaded first."""
        if not self.restarted and not self.bases:
            # every base committed: the restart that ends set-up
            self.restarted = True
            self._stop()
            self._start()
            self.sched.start_pump()
        agents = self.agents[doc_id]

        def add(ol) -> None:
            ids = {a: ol.get_or_create_agent_id(a) for a in agents}
            n = len(ol)
            append_sync(ol, ids, ol.version, sync)
            # counted here, not read off the op log: one that came back
            # from its home short of ops then reads as lagging
            self.lengths[doc_id] += len(ol) - n
        self.hyd.edit(doc_id, add)

    def submit(self, doc_id: str, n_ops: int) -> dict:
        res = self.sched.submit(doc_id, n_ops)
        if res.get("reason") == "quarantined":
            # never accepted again: fail the run rather than retry forever
            raise RuntimeError(f"{doc_id} quarantined: "
                               f"{self.store.is_quarantined(doc_id)}")
        return res

    def _session(self, doc_id: str):
        bank = self.sched.banks[self.sched.router.shard_of(doc_id)]
        return bank.sessions.get(doc_id)

    def residency(self, doc_id: str) -> str:
        """Module docstring: "resident" or "lagging" on the card, and for
        a document off the card by what its warm op log or its home
        holds."""
        with self.lock:
            want = self.lengths[doc_id]
            sess = self._session(doc_id)
            if sess is not None:
                have = sess.synced_to
            else:
                ol = self.hyd.warm_oplog(doc_id)
                have = len(ol) if ol is not None \
                    else self.home_lengths.get(doc_id, 0)
            return "resident" if have >= want else "lagging"

    def text(self, doc_id: str) -> str:
        """The document's merged text through `MergeScheduler.text`: from
        its session on the card when it is resident and caught up, else a
        checkout of its op log, loaded from its home when it is cold."""
        with self.lock:
            where = "card" if self._session(doc_id) is not None else \
                "warm" if self.hyd.warm_oplog(doc_id) is not None else "cold"
        self.read_states[where] += 1
        return self.sched.text(doc_id)

    def close(self) -> None:
        self._stop()
        snap = self.sched.metrics_json()
        print(f"tiered_tier: check read {self.read_states}; hydration "
              f"{snap['hydration']}; residency {snap['residency']}; "
              f"store {self.store.counters()}; edit_retries "
              f"{self.hyd.edit_retries}; stale_loads "
              f"{self.hyd.stale_loads}", file=sys.stderr)
