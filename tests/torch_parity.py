"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

One seeded edit history is driven into several OpLogs at once: one from
the JAX package and one from the PyTorch port. Every decision comes from a
numpy generator and the FIRST oplog's state, and the same calls go to
every oplog, so any divergence between the packages shows up as unequal
versions, transformed ops or text.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

ASCII = "abcdefghij"
# astral-plane emoji and math letters, CJK, combining marks, RTL text
UNICODE = "aé中文😀🎉ßΏñ𝔘ש‍क़"


def rand_text(rng: np.random.Generator, n: int, alphabet: str) -> str:
    return "".join(alphabet[i] for i in rng.integers(0, len(alphabet), n))


class TwinDocs:
    """The same document history in each of `oplogs` (same agents, same
    calls). Each agent edits on its own Branch, forked from the oplog's
    tip when the agent first appears, and merges the tip back in now and
    then, so the histories are concurrent."""

    def __init__(self, oplogs: Sequence, seed: int,
                 alphabet: str = ASCII) -> None:
        self.oplogs = list(oplogs)
        self.rng = np.random.default_rng(seed)
        self.alphabet = alphabet
        self.branches: List[Dict[str, object]] = [{} for _ in self.oplogs]

    def _branches(self, name: str) -> list:
        out = []
        for ol, br in zip(self.oplogs, self.branches):
            if name not in br:
                ol.get_or_create_agent_id(name)
                br[name] = ol.checkout_tip()
            out.append(br[name])
        return out

    def insert(self, name: str, pos: int, text: str) -> None:
        for ol, b in zip(self.oplogs, self._branches(name)):
            b.insert(ol, ol.get_or_create_agent_id(name), pos, text)

    def delete(self, name: str, start: int, end: int) -> None:
        for ol, b in zip(self.oplogs, self._branches(name)):
            b.delete(ol, ol.get_or_create_agent_id(name), start, end)

    def merge_tip(self, name: str) -> None:
        for ol, b in zip(self.oplogs, self._branches(name)):
            b.merge(ol, ol.version)

    def fork(self, names: Sequence[str]) -> None:
        """Give each of `names` its own branch at the current tip now, so
        their next edits are concurrent with each other."""
        for name in names:
            self._branches(name)

    def doc_len(self, name: str) -> int:
        return len(self._branches(name)[0])

    def type_base(self, name: str, n: int) -> None:
        """One agent types `n` chars at the tip, in runs of up to 64."""
        done = 0
        while done < n:
            k = min(64, n - done)
            self.insert(name, done, rand_text(self.rng, k, self.alphabet))
            done += k

    def edits(self, name: str, n: int, max_ins: int = 12,
              max_del: int = 9) -> None:
        """`n` random edits by `name`: inserts of 1..max_ins chars,
        deletes of 1..max_del chars, delete-key and backspace runs."""
        rng = self.rng
        for _ in range(n):
            cur = self.doc_len(name)
            r = rng.random()
            if cur and r < 0.2:
                # backspace run: consecutive single deletes moving left,
                # which the op store merges into one reversed delete run
                p = int(rng.integers(1, cur + 1))
                for _ in range(int(rng.integers(2, 5))):
                    if p == 0:
                        break
                    self.delete(name, p - 1, p)
                    p -= 1
            elif cur and r < 0.3:
                # delete-key run: repeated deletes at one position
                p = int(rng.integers(0, cur))
                for _ in range(int(rng.integers(2, 5))):
                    if p >= self.doc_len(name):
                        break
                    self.delete(name, p, p + 1)
            elif cur and r < 0.5:
                p = int(rng.integers(0, cur))
                end = min(p + int(rng.integers(1, max_del + 1)), cur)
                self.delete(name, p, end)
            else:
                p = int(rng.integers(0, cur + 1))
                k = int(rng.integers(1, max_ins + 1))
                self.insert(name, p, rand_text(rng, k, self.alphabet))

    def concurrent_round(self, names: Sequence[str], n_each: int,
                         max_ins: int = 12, max_del: int = 9) -> None:
        """Each agent makes `n_each` edits on its own branch (concurrently
        with the others), then the first one merges the tip and edits once
        more on top of the merge."""
        for name in names:
            self.edits(name, n_each, max_ins, max_del)
        self.merge_tip(names[0])
        self.edits(names[0], 1, max_ins, max_del)


def export_columns(ol) -> dict:
    """An OpLog's history as the plain columns `oplog_from_columns` takes:
    one row per op run, split at graph-entry and agent-run boundaries (the
    walk `__graft_entry__._prefix_oplog` does)."""
    aa = ol.cg.agent_assignment
    cols = {"agents": list(aa.agent_names), "lv_start": [], "lv_end": [],
            "agent": [], "seq": [], "parents": [], "parents_indptr": [0],
            "kind": [], "start": [], "end": [], "fwd": [], "content": []}
    for lo, hi, parents, agent, seq in ol.cg.iter_entries():
        for piece in ol.ops.iter_range((lo, hi)):
            cols["lv_start"].append(piece.lv)
            cols["lv_end"].append(piece.lv + len(piece))
            cols["agent"].append(agent)
            cols["seq"].append(seq + piece.lv - lo)
            ps = list(parents) if piece.lv == lo else [piece.lv - 1]
            cols["parents"].extend(ps)
            cols["parents_indptr"].append(len(cols["parents"]))
            cols["kind"].append(piece.kind)
            cols["start"].append(piece.start)
            cols["end"].append(piece.end)
            cols["fwd"].append(piece.fwd)
            cols["content"].append(ol.ops.get_run_content(piece))
    for k in ("lv_start", "lv_end", "seq", "parents", "parents_indptr",
              "start", "end"):
        cols[k] = np.asarray(cols[k], np.int64)
    cols["agent"] = np.asarray(cols["agent"], np.int32)
    cols["kind"] = np.asarray(cols["kind"], np.int8)
    cols["fwd"] = np.asarray(cols["fwd"], bool)
    return cols


def xf_rows(ol, frm, to) -> list:
    """The transformed-op stream as comparable tuples."""
    return [(lv, op.kind, len(op), op.fwd, pos, ol.ops.get_run_content(op))
            for lv, op, pos in ol.get_xf_operations_full(frm, to)]


# ---- shape steering ---------------------------------------------------------

def steer_tape(seed: int, n: int, note_share: float = 0.4) -> list:
    """A random sequence of `ShapeSteer` calls over small shape domains, so
    exact hits, padding, forced pads and new classes all occur: ("note",
    cache, mi, cap, b, n) and ("snap", cache, bp0, n0, mi, cap).
    Cache names are the JAX package's ("fused", "pallas"); a test maps
    "pallas" to the port's "kernel". After a snap, ("launch",) asks the
    caller to note the returned class warm, as the replay rungs do."""
    rng = np.random.default_rng(seed)
    caches, mis, caps = ("fused", "pallas"), (4, 16), (256, 1024)
    bs, ns = (1, 2, 4, 8), (2, 4, 8, 16, 32)
    tape = []
    for _ in range(n):
        cache = caches[int(rng.integers(2))]
        mi, cap = mis[int(rng.integers(2))], caps[int(rng.integers(2))]
        b, k = bs[int(rng.integers(4))], ns[int(rng.integers(5))]
        if rng.random() < note_share:
            tape.append(("note", cache, mi, cap, b, k))
        else:
            tape.append(("snap", cache, b, k, mi, cap))
            if rng.random() < 0.5:
                tape.append(("launch",))
    return tape


# ---- the serve layer --------------------------------------------------------

def serve_docs(oplog_types: Sequence, n_docs: int, seed: int,
               base_min: int = 10, base_max: int = 300,
               agents: Sequence[str] = ("alice", "bob", "carol")
               ) -> Dict[str, TwinDocs]:
    """`n_docs` documents, each a TwinDocs over one fresh oplog of every
    type in `oplog_types`, typed to a random base length by the first of
    `agents`, then forked for all of them (so the first round's edits
    are concurrent). Bases up to 300 chars give sessions of mixed cap."""
    rng = np.random.default_rng(seed)
    docs = {}
    for i in range(n_docs):
        tw = TwinDocs([t() for t in oplog_types], seed * 1000 + i)
        tw.type_base(agents[0], int(rng.integers(base_min, base_max + 1)))
        tw.fork(agents)
        docs[f"d{i:02d}"] = tw
    return docs


def serve_round(docs: Dict[str, TwinDocs], seed: int, rnd: int,
                agents: Sequence[str] = ("alice", "bob", "carol"),
                share: float = 0.7) -> list:
    """One round of the shared concurrent tape: about `share` of the
    documents take a concurrent round of 1-4 edits per agent (inserts up
    to 11 chars, past a max_ins of 4). Returns the (doc_id, n_ops) submits
    to make, in document order."""
    rng = np.random.default_rng([seed, rnd])
    out = []
    for d, tw in docs.items():
        if rng.random() >= share:
            continue
        k = int(rng.integers(1, 5))
        tw.concurrent_round(agents, k, max_ins=11, max_del=9)
        out.append((d, k * len(agents) + 1))
    return out


# ---- the zone engine --------------------------------------------------------

def zone_history(oplog_types: Sequence, seed: int, n_edits: int = 40,
                 agents: Sequence[str] = ("alice", "bob", "git"),
                 max_branches: int = 5, p_branch: float = 0.3) -> list:
    """One random concurrent-branch history (`test_zone.random_edit`, as
    the JAX package's zone tests drive it) into a fresh oplog of each of
    `oplog_types`, from one `random.Random(seed)` stream per oplog, so the
    histories are identical. Any agent edits any branch, so one agent
    also edits on parallel branches."""
    import random

    from test_zone import random_edit
    out = []
    for make in oplog_types:
        rng = random.Random(seed)
        ol = make()
        ids = [ol.get_or_create_agent_id(n) for n in agents]
        branches = [([], "")]
        for _ in range(n_edits):
            bi = rng.randrange(len(branches))
            version, content = branches[bi]
            agent = ids[rng.randrange(len(ids))]
            version, content = random_edit(rng, ol, agent, version, content)
            if rng.random() < p_branch and len(branches) < max_branches:
                branches.append((version, content))
            else:
                branches[bi] = (version, content)
        out.append(ol)
    return out


# ---- observability ----------------------------------------------------------

class FakeClock:
    """A settable monotonic clock."""

    def __init__(self, t: float = 100.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


class FakeTime:
    """Stands in for the `time` module inside a module under test: its
    monotonic, perf_counter and wall-clock reads are all `clock`'s, so
    two packages on clocks advanced alike stamp alike. Span ids still
    draw from the real nanosecond clock (they only need to be unique)."""

    def __init__(self, clock: FakeClock) -> None:
        self._clock = clock

    def monotonic(self) -> float:
        return self._clock()

    perf_counter = monotonic
    time = monotonic

    @staticmethod
    def monotonic_ns() -> int:
        import time
        return time.monotonic_ns()


# the obs modules that read the clock (each as `time.<fn>`)
OBS_CLOCKED = ("obs.trace", "obs.recorder", "obs.timeseries",
               "obs.journey", "obs.exemplars", "obs.incident")


def clock_modules(monkeypatch, root: str, clock: FakeClock,
                  names: Sequence[str] = OBS_CLOCKED) -> None:
    """Point `root.<name>.time` at a FakeTime over `clock` for each of
    `names` (before the objects that cache a clock are built)."""
    import importlib
    for name in names:
        mod = importlib.import_module(f"{root}.{name}")
        monkeypatch.setattr(mod, "time", FakeTime(clock))


def span_forest(spans: List[dict], drop: Sequence[str] = ()) -> list:
    """Finished spans as comparable rows with their random ids replaced by
    order of appearance: (trace #, name, parent's name or None, parent in
    the ring, attrs without `drop`, t0, dur_s)."""
    traces: Dict[str, int] = {}
    by_id = {s["span"]: s for s in spans}
    rows = []
    for s in spans:
        t = traces.setdefault(s["trace"], len(traces))
        p = by_id.get(s["parent"])
        rows.append((t, s["name"], p["name"] if p else None,
                     s["parent"] is not None,
                     {k: v for k, v in s["attrs"].items() if k not in drop},
                     s["t0"], s["dur_s"]))
    return rows


# ---- served kernels on the card ------------------------------------------------

class ServedLaunches:
    """Counts what the port's servers launch while an entry point runs:
    keeps every server it boots through `tools.server.serve` (patched on
    `monkeypatch`), counts per-doc replays on `FusedDocSession.sync`, and
    sets K1's and K2's launch counts to 0. `check()` then requires K1
    launches == fused calls + per-doc replays (> 0), K2 launches ==
    resolves, 0 host and plan fallbacks and no scheduler fault, over every
    scheduler booted. An entry point that builds its scheduler inside
    itself (the CLI's serve bench) passes its reports' `metrics` blocks
    to `check` instead."""

    def __init__(self, monkeypatch) -> None:
        from diamond_types_tpu_torch.gpu import flush_fuse as ff
        from diamond_types_tpu_torch.gpu import kernels
        from diamond_types_tpu_torch.tools import server
        self.kernels = kernels
        self.httpds: list = []
        self.syncs: List[int] = []
        real_serve, real_sync = server.serve, ff.FusedDocSession.sync

        def serve(*args, **kw):
            httpd = real_serve(*args, **kw)
            self.httpds.append(httpd)
            return httpd

        def counted_sync(sess):
            n = real_sync(sess)
            self.syncs.append(n)
            return n

        monkeypatch.setattr(server, "serve", serve)
        monkeypatch.setattr(ff.FusedDocSession, "sync", counted_sync)
        kernels.apply_ops_window.launches = 0
        kernels.xform_positions.launches = 0

    def check(self, metrics: Optional[List[dict]] = None) -> dict:
        ms = metrics if metrics is not None else [
            h.store.scheduler.metrics_json() for h in self.httpds
            if h.store.scheduler is not None]
        assert ms and all(h.store.scheduler.fault is None
                          for h in self.httpds)
        fused = sum(m["fused"]["device_calls"] for m in ms)
        replays = sum(1 for n in self.syncs if n)
        resolves = sum(m["transform"]["batches"] for m in ms)
        k1 = self.kernels.apply_ops_window.launches
        k2 = self.kernels.xform_positions.launches
        assert k1 == fused + replays and k1 > 0, (k1, fused, replays)
        assert k2 == resolves, (k2, resolves)
        assert sum(m["totals"]["host_fallbacks"] for m in ms) == 0
        assert sum(m["transform"]["fallbacks"] for m in ms) == 0
        return {"k1": k1, "k2": k2, "fused": fused, "replays": replays}
