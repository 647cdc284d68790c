"""Experimental multi-CRDT documents: JSON-ish trees of Map / Register / Text.

Capability mirror of the reference's experimental OpLog/Branch layer
(reference: src/lib.rs:279-284 CRDTKind {Map, Register, Collection, Text},
src/oplog.rs — map_keys MV-registers, texts, tie_break_mv at oplog.rs:361-385;
src/branch.rs — checkout to a value tree with `conflicts_with` surfaced).

Model:
  * One causal graph orders every op in the document.
  * CRDTs are identified by the LV that created them; the root map is
    ROOT_CRDT (-1).
  * Map ops: set (map_id, key) to a CreateValue — a primitive or a fresh
    child CRDT. Each (map, key) is a multi-value register: the heads
    (dominator set) are all visible; the *active* value is chosen by the
    deterministic agent tie-break (max by (agent name, seq)), identical on
    every peer.
  * Text CRDTs reuse the full list merge engine.

Delta sync: `ops_since(version)` / `merge_ops(delta)` exchange JSON-safe op
payloads keyed by remote versions (capability of the reference's
SerializedOps, src/oplog.rs:489-611).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..causalgraph.causal_graph import CausalGraph
from ..listmerge.transform import TransformedOps
from ..text.op import DEL, INS, OpStore
from ..utils.rope import Rope

ROOT_CRDT = -1

KIND_MAP = "map"
KIND_REGISTER = "register"
KIND_TEXT = "text"
KIND_COLLECTION = "collection"

# CreateValue encodings (JSON-safe):
#   ("prim", value)        — None / bool / int / float / str
#   ("crdt", kind)         — create a new child CRDT of `kind`


class Doc:
    """The multi-CRDT oplog + checkout functions."""

    def __init__(self) -> None:
        self.cg = CausalGraph()
        # (crdt_id, key) -> list of (lv, CreateValue); heads tracked lazily
        self.map_keys: Dict[Tuple[int, str], List[Tuple[int, Any]]] = {}
        # text crdt id -> (OpStore, version list of that text's ops)
        self.texts: Dict[int, OpStore] = {}
        # LV -> ("map", crdt, key) | ("text", crdt) for remote re-export
        self.op_index: Dict[int, Tuple] = {}

    def get_or_create_agent_id(self, name: str) -> int:
        return self.cg.get_or_create_agent(name)

    @property
    def version(self) -> List[int]:
        return list(self.cg.version)

    # --- local edits -------------------------------------------------------

    def _map_set_internal(self, lv: int, crdt: int, key: str, value) -> None:
        self.map_keys.setdefault((crdt, key), []).append((lv, value))
        self.op_index[lv] = ("map", crdt, key)

    def map_set(self, agent: int, map_id: int, key: str, value) -> int:
        """Set a primitive value. Returns the op LV."""
        lv = self.cg.assign_local_op(agent, 1)[0]
        self._map_set_internal(lv, map_id, key, ("prim", value))
        return lv

    def map_create_crdt(self, agent: int, map_id: int, key: str, kind: str) -> int:
        """Create a child CRDT under a map key; returns its CRDT id (the LV)."""
        lv = self.cg.assign_local_op(agent, 1)[0]
        self._map_set_internal(lv, map_id, key, ("crdt", kind))
        if kind == KIND_TEXT:
            self.texts[lv] = OpStore()
        return lv

    def text_insert(self, agent: int, text_id: int, pos: int, content: str) -> int:
        store = self.texts[text_id]
        span = self.cg.assign_local_op(agent, len(content))
        store.push_op(span[0], INS, pos, pos + len(content), True, content)
        for v in range(span[0], span[1]):
            self.op_index[v] = ("text", text_id)
        return span[1] - 1

    def text_delete(self, agent: int, text_id: int, start: int, end: int) -> int:
        store = self.texts[text_id]
        span = self.cg.assign_local_op(agent, end - start)
        store.push_op(span[0], DEL, start, end, True, None)
        for v in range(span[0], span[1]):
            self.op_index[v] = ("text", text_id)
        return span[1] - 1

    # --- checkout ----------------------------------------------------------

    def _register_heads(self, entries: List[Tuple[int, Any]]) -> List[Tuple[int, Any]]:
        lvs = [lv for (lv, _) in entries]
        doms = set(self.cg.graph.find_dominators(sorted(lvs)))
        return [(lv, v) for (lv, v) in entries if lv in doms]

    def _register_resolve(self, heads: List[Tuple[int, Any]]) -> Tuple[int, Any]:
        """Deterministic winner (reference: oplog.rs:361-385 tie_break_mv)."""
        aa = self.cg.agent_assignment

        def sort_key(item):
            agent, seq = aa.local_to_agent_version(item[0])
            return (aa.get_agent_name(agent), seq)

        return max(heads, key=sort_key)

    def checkout_text(self, text_id: int) -> str:
        """Project the causal graph onto this text's op spans, then transform
        within the mini-DAG (reference: TextInfo::with_xf_iter,
        src/listmerge/merge.rs:954-987)."""
        from ..causalgraph.subgraph import subgraph
        from ..core.span import merge_spans
        store = self.texts[text_id]
        if not store.runs:
            return ""
        spans = merge_spans((r.lv, r.lv + len(r)) for r in store.runs)
        sub, proj = subgraph(self.cg.graph, spans, self.version)
        rope = Rope()
        xf = TransformedOps(sub, self.cg.agent_assignment, store, [], proj)
        for _lv, op, pos in xf:
            if pos is None:
                continue
            if op.kind == INS:
                content = store.get_run_content(op)
                rope.insert(pos, content if op.fwd else content[::-1])
            else:
                rope.delete(pos, len(op))
        return str(rope)

    def checkout_map(self, map_id: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for (crdt, key), entries in self.map_keys.items():
            if crdt != map_id:
                continue
            heads = self._register_heads(entries)
            lv, val = self._register_resolve(heads)
            out[key] = self._materialize(lv, val)
            if len(heads) > 1:
                out.setdefault("_conflicts", {})[key] = [
                    self._materialize(l, v) for (l, v) in heads
                    if l != lv]
        return out

    def _materialize(self, lv: int, val) -> Any:
        tag, payload = val
        if tag == "prim":
            return payload
        kind = payload
        if kind == KIND_TEXT:
            return self.checkout_text(lv)
        if kind in (KIND_MAP, KIND_COLLECTION):
            return self.checkout_map(lv)
        if kind == KIND_REGISTER:
            return None  # bare registers hold their value via map semantics
        raise ValueError(kind)

    def checkout(self) -> Dict[str, Any]:
        return self.checkout_map(ROOT_CRDT)

    # --- delta sync (SerializedOps equivalent) ------------------------------

    def ops_since(self, version: Sequence[int]) -> str:
        """JSON delta of everything not in `version`'s history
        (reference: src/oplog.rs:489 ops_since -> SerializedOps)."""
        _only_old, only_new = self.cg.graph.diff(version, self.cg.version)
        aa = self.cg.agent_assignment
        rows = []
        for (lo, hi) in only_new:
            pos = lo
            while pos < hi:
                agent, seq, n = aa.local_span_to_agent_span(pos, hi - pos)
                # split on graph runs so parents stay simple
                gi = self.cg.graph.find_idx(pos)
                n = min(n, self.cg.graph.ends[gi] - pos)
                parents = self.cg.graph.parents_at(pos)
                rparents = self.cg.local_to_remote_frontier(list(parents))
                # op payloads for [pos, pos+n)
                payloads = []
                v = pos
                while v < pos + n:
                    kind_entry = self.op_index[v]
                    if kind_entry[0] == "map":
                        _, crdt, key = kind_entry
                        val = next(val for (lv, val)
                                   in self.map_keys[(crdt, key)] if lv == v)
                        payloads.append(["map", self._crdt_ref(crdt), key, val])
                        v += 1
                    else:
                        _, crdt = kind_entry
                        store = self.texts[crdt]
                        run = store.runs[store.find_idx(v)]
                        take = min(run.lv + len(run), pos + n) - v
                        piece = store._slice_run(run, v - run.lv,
                                                 v - run.lv + take)
                        payloads.append([
                            "text", self._crdt_ref(crdt),
                            "ins" if piece.kind == INS else "del",
                            piece.start, piece.end, piece.fwd,
                            store.get_run_content(piece)])
                        v += take
                rows.append({
                    "agent": aa.get_agent_name(agent), "seq": seq,
                    "parents": rparents, "len": n, "ops": payloads,
                })
                pos += n
        return json.dumps(rows)

    def _crdt_ref(self, crdt: int):
        if crdt == ROOT_CRDT:
            return None
        agent, seq = self.cg.agent_assignment.local_to_agent_version(crdt)
        return [self.cg.agent_assignment.get_agent_name(agent), seq]

    def _crdt_deref(self, ref) -> int:
        if ref is None:
            return ROOT_CRDT
        agent = self.cg.agent_assignment.try_get_agent(ref[0])
        assert agent is not None
        return self.cg.agent_assignment.agent_version_to_lv(agent, ref[1])

    def merge_ops(self, delta: str) -> None:
        """Ingest a delta; already-known ops dedup via the causal graph
        (reference: src/oplog.rs:568 merge_ops)."""
        for row in json.loads(delta):
            agent = self.get_or_create_agent_id(row["agent"])
            parents = self.cg.remote_to_local_frontier(row["parents"])
            span = self.cg.merge_and_assign(parents, agent, row["seq"],
                                            row["len"])
            if span[1] == span[0]:
                continue  # fully known
            skip = row["len"] - (span[1] - span[0])
            lv = span[0]
            consumed = 0
            for payload in row["ops"]:
                if payload[0] == "map":
                    _, ref, key, val = payload
                    if consumed >= skip:
                        self._map_set_internal(lv, self._crdt_deref(ref), key,
                                               tuple(val))
                        if val[0] == "crdt" and val[1] == KIND_TEXT:
                            self.texts.setdefault(lv, OpStore())
                        lv += 1
                    consumed += 1
                else:
                    _, ref, kind_s, start, end, fwd, content = payload
                    n = end - start
                    crdt = self._crdt_deref(ref)
                    use = max(0, (consumed + n) - max(consumed, skip))
                    drop = n - use
                    if use > 0:
                        kind = INS if kind_s == "ins" else DEL
                        if drop:
                            from ..text.op import sub_op_loc
                            start, end = sub_op_loc(kind, start, end, fwd,
                                                    drop, n)
                            if content is not None:
                                content = content[drop:]
                        store = self.texts.setdefault(crdt, OpStore())
                        store.push_op(lv, kind, start, end, fwd, content)
                        for v in range(lv, lv + use):
                            self.op_index[v] = ("text", crdt)
                        lv += use
                    consumed += n
