"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

One seeded edit history is driven into several OpLogs at once: one from
the JAX package and one from the PyTorch port. Every decision comes from a
numpy generator and the FIRST oplog's state, and the same calls go to
every oplog, so any divergence between the packages shows up as unequal
versions, transformed ops or text.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

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
