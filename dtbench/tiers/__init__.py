"""Tiers: the system under test, one file each (`dtbench/tiers/<tier>.py`),
named by a configuration's "tier" key.

A tier module defines `Tier(config, device, on_commit)` with
`add_doc(doc_id, agents)`, `append(doc_id, sync)`, `submit(doc_id, n_ops)
-> {"accepted": bool, ...}`, `residency(doc_id) -> "resident" | "lagging"
| "absent"`, `text(doc_id)`, `oplogs` (doc -> the program's op log),
`sched.metrics_json()`, `sched.start_pump()`, `sched.drain()` and
`close()`. It calls `on_commit(doc_id)` for every document a flush
commits.

Only tier modules and `dtbench.run` import the program, and only inside
functions, so the reference and the generator never load it. The helpers
below are shared by the tiers and the tests.
"""

from __future__ import annotations

from typing import Dict, List


def add_op(ol, agent: int, parents: List[int], op) -> int:
    """One generated op ("i", pos, text) or ("d", start, end) into an op
    log, parented on `parents`; returns its local version."""
    if op[0] == "i":
        return ol.add_insert_at(agent, parents, op[1], op[2])
    return ol.add_delete_at(agent, parents, op[1], op[2])


def append_sync(ol, ids: Dict[str, int], tip: List[int], sync: dict) -> list:
    """A sync's ops into an op log whose document is at `tip`: each chain
    forks from the tip, each of its ops parented on the chain's previous
    op, and the top op on every chain's tip. Returns the new tip."""
    tips: List[int] = []
    for agent, ops in sync["chains"]:
        parents = tip
        for op in ops:
            parents = [add_op(ol, ids[agent], parents, op)]
        tips.extend(parents)
    if sync.get("top") is not None:
        agent, op = sync["top"]
        tips = [add_op(ol, ids[agent], sorted(tips), op)]
    return sorted(tips)
