"""A sync of concurrent agents: each forks from the document's merged
version and edits inside its own region, then one op goes on both tips.

Shape copied from the port's `chip_smoke.py` (`round_edits`,
`random_edits`) and rewritten to need no merge: agent j of m owns the j-th
m-th of the forked text; the first agent's region grows at its end, the
last one's at its start, so their inserts may meet at the boundary
(`edge_share` of inserts land exactly there). Region-local deletes keep
the merged length exact: the fork's length plus every chain's inserts
minus every chain's deletes.

Numbers (the mix's "edits" block): agents, top_agent, ops_min, ops_max
(ops per agent a sync), del_share, del_max, ins_max, edge_share, top_ops.
"""


def agents(e: dict) -> list:
    return [*e["agents"], e["top_agent"]]


def next_sync(doc, e: dict) -> dict:
    rng = doc.rng
    names = e["agents"]
    m, fork_len = len(names), doc.length
    chains, net = [], 0
    text, pool = doc.pool.text, len(doc.pool.text) // 2
    for j, agent in enumerate(names):
        start = fork_len * j // m            # in this chain's view
        end = fork_len * (j + 1) // m
        n = int(rng.integers(e["ops_min"], e["ops_max"] + 1))
        # each op's draws, in bulk: kind, place, edge, size, text offset
        u = rng.random((3, n))
        dsz = rng.integers(1, e["del_max"] + 1, n)
        isz = rng.integers(1, e["ins_max"] + 1, n)
        off = rng.integers(0, pool, n)
        ops = []
        for i in range(n):
            if end > start and u[0, i] < e["del_share"]:
                p = start + int(u[1, i] * (end - start))
                q = min(end, p + int(dsz[i]))
                ops.append(("d", p, q))
                end -= q - p
            else:
                if u[2, i] < e["edge_share"]:
                    # at the region's edge that meets the next region
                    # (the last agent: the previous one)
                    p = end if j < m - 1 else start
                else:
                    p = start + int(u[1, i] * (end - start + 1))
                k = int(isz[i])
                ops.append(("i", p, text[off[i]:off[i] + k]))
                end += k
        net += end - fork_len * (j + 1) // m
        chains.append((agent, ops))
    doc.length = fork_len + net
    top = None
    if e.get("top_ops", 0):
        top = (e["top_agent"], _one_op(doc, e))
    return {"chains": chains, "top": top}


def _one_op(doc, e: dict):
    rng = doc.rng
    if doc.length and rng.random() < e["del_share"]:
        p = int(rng.integers(0, doc.length))
        q = min(doc.length, p + int(rng.integers(1, e["del_max"] + 1)))
        doc.length -= q - p
        return ("d", p, q)
    p = int(rng.integers(0, doc.length + 1))
    k = int(rng.integers(1, e["ins_max"] + 1))
    doc.length += k
    return ("i", p, doc.pool.take(k))
