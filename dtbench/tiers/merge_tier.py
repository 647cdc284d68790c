"""The port's sync-server merge tier, in-process.

Wired as the port's `tools/server.serve(serve_shards=N)` wires it, without
HTTP: a `MergeScheduler` on the device engine with the device plan, the
background pump and its per-shard flush workers, the server's
`Observability` bundle attached at its sampling, `obs.devprof.PROFILER`
left off. Each sync appends its ops to the document's `OpLog` under the
scheduler's `sync_lock`, as the server's `DocStore` does, then calls
`submit(doc_id, n_ops)`. A sync is committed when the scheduler calls
`read_invalidate` for its document, which it does for every document a
flush commits, on both flush paths.

Configuration keys: serve_shards, fused, device_plan, mesh_window,
flush_docs, flush_deadline_s, max_pending, max_sessions_per_shard,
max_slots_per_shard, obs_sample_rate.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

from dtbench.tiers import append_sync


class Tier:
    """The scheduler, the documents' op logs, and the commit hook."""

    def __init__(self, config: dict, device, on_commit: Callable[[str], None]):
        from diamond_types_tpu_torch.obs import Observability
        from diamond_types_tpu_torch.serve.scheduler import MergeScheduler

        self.lock = threading.Lock()            # the DocStore's oplog lock
        self.oplogs: Dict[str, object] = {}
        self.agent_ids: Dict[str, Dict[str, int]] = {}
        self.tips: Dict[str, List[int]] = {}
        self.sched = MergeScheduler(
            config["serve_shards"], resolve=self.oplogs.__getitem__,
            engine="device", fused=config["fused"],
            device_plan=config["device_plan"],
            fused_opts={"device": device},
            max_sessions_per_shard=config["max_sessions_per_shard"],
            max_slots_per_shard=config["max_slots_per_shard"],
            flush_docs=config["flush_docs"],
            flush_deadline_s=config["flush_deadline_s"],
            max_pending=config["max_pending"],
            mesh_window=config["mesh_window"], sync_lock=self.lock)
        self.obs = Observability(sample_rate=config["obs_sample_rate"])
        self.sched.attach_obs(self.obs)
        self.sched.read_invalidate = on_commit

    def add_doc(self, doc_id: str, agents: List[str]) -> None:
        """A new document with every agent its traffic uses registered up
        front."""
        from diamond_types_tpu_torch import OpLog
        ol = OpLog()
        ol.doc_id = doc_id
        self.agent_ids[doc_id] = {a: ol.get_or_create_agent_id(a)
                                  for a in agents}
        self.oplogs[doc_id] = ol
        self.tips[doc_id] = []

    def append(self, doc_id: str, sync: dict) -> None:
        """The sync's ops into the document's op log, under the oplog
        lock."""
        with self.lock:
            self.tips[doc_id] = append_sync(
                self.oplogs[doc_id], self.agent_ids[doc_id],
                self.tips[doc_id], sync)

    def submit(self, doc_id: str, n_ops: int) -> dict:
        return self.sched.submit(doc_id, n_ops)

    def residency(self, doc_id: str) -> str:
        """"resident" when the document's session is caught up with its op
        log, "lagging" when it is behind, "absent" when it has none (the
        scheduler would then answer from the host)."""
        bank = self.sched.banks[self.sched.router.shard_of(doc_id)]
        with self.lock:
            sess = bank.sessions.get(doc_id)
            if sess is None:
                return "absent"
            if sess.synced_to < len(self.oplogs[doc_id]):
                return "lagging"
            return "resident"

    def text(self, doc_id: str) -> str:
        """The document's merged text through `MergeScheduler.text`: from
        its session on the device when it is resident and caught up."""
        return self.sched.text(doc_id)

    def close(self) -> None:
        self.sched.stop_pump(drain=True)
