"""Editing-trace loader + replay.

Loads the concurrent-editing-trace JSON format used by the reference's bench
corpus (reference: crates/crdt-testdata/src/lib.rs:14-54): gzipped JSON with
`startContent`, `endContent` and `txns: [{patches: [[pos, del, ins], ...]}]`.
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass
from typing import List, Tuple

from .oplog import OpLog


@dataclass
class TestData:
    start_content: str
    end_content: str
    txns: List[List[Tuple[int, int, str]]]  # per txn: [(pos, num_deleted, ins)]

    def num_ops(self) -> int:
        return sum(len(t) for t in self.txns)

    def patch_columns(self):
        """Columnar view of the flattened patches: (pos, num_del, ins_len)
        int64 arrays + concatenated insert text — the zero-Python-loop
        input shape of OpLog.apply_local_patch_columns. Cached."""
        cols = getattr(self, "_cols", None)
        if cols is None:
            import numpy as np
            flat = [p for t in self.txns for p in t]
            pos_l, nd_l, txt_l = zip(*flat) if flat else ((), (), ())
            cols = (np.array(pos_l, dtype=np.int64),
                    np.array(nd_l, dtype=np.int64),
                    np.array(list(map(len, txt_l)), dtype=np.int64),
                    "".join(txt_l))
            self._cols = cols
        return cols


def load_trace(path: str) -> TestData:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf8") as f:
        d = json.load(f)
    return TestData(
        start_content=d["startContent"],
        end_content=d["endContent"],
        txns=[[(p[0], p[1], p[2]) for p in t["patches"]] for t in d["txns"]],
    )


def replay_into_oplog(data: TestData, agent_name: str = "trace") -> OpLog:
    """Linear replay of a trace into an oplog (reference:
    crates/bench/src/main.rs local/apply_* benches)."""
    ol = OpLog()
    agent = ol.get_or_create_agent_id(agent_name)
    assert not data.start_content, "traces in the corpus start empty"
    for txn in data.txns:
        for (pos, num_del, ins) in txn:
            if num_del:
                ol.add_delete_without_content(agent, pos, pos + num_del)
            if ins:
                ol.add_insert(agent, pos, ins)
    return ol


def replay_into_oplog_native(data: TestData,
                             agent_name: str = "trace") -> OpLog:
    """Per-op replay through the native local-ingest session (reference:
    local/apply_direct over the native push path, src/list/oplog.rs:
    203-296 + crates/bench/src/main.rs:17-40). Same per-op call shape as
    replay_into_oplog; the RLE/graph/arena state lands bit-identical
    (tests/test_native_ingest.py proves encode parity)."""
    ol = OpLog()
    agent = ol.get_or_create_agent_id(agent_name)
    assert not data.start_content, "traces in the corpus start empty"
    session = ol.local_session(agent)
    sess, ins, dele = session.hot()
    for txn in data.txns:
        for (pos, num_del, ins_text) in txn:
            if num_del:
                dele(sess, pos, pos + num_del)
            if ins_text:
                ins(sess, pos, ins_text)
    session.flush()
    return ol


def replay_into_oplog_grouped(data: TestData,
                              agent_name: str = "trace") -> OpLog:
    """Bulk-ingest replay via OpLog.apply_local_patches (reference:
    crates/bench/src/main.rs local/apply_grouped_rle)."""
    ol = OpLog()
    agent = ol.get_or_create_agent_id(agent_name)
    assert not data.start_content, "traces in the corpus start empty"
    ol.apply_local_patch_columns(agent, *data.patch_columns())
    return ol


def replay_direct(data: TestData) -> str:
    """Oracle replay straight into a rope (no CRDT)."""
    from ..utils.rope import Rope
    r = Rope(data.start_content)
    for txn in data.txns:
        for (pos, num_del, ins) in txn:
            if num_del:
                r.delete(pos, num_del)
            if ins:
                r.insert(pos, ins)
    return str(r)
