"""A sync of one typist's keystrokes at a moving cursor: inserts of
1..ins_max chars, backspaces of 1..del_max (del_share of the ops), and now
and then (jump_share of the syncs) a jump of the cursor to anywhere in the
text. One agent, so consecutive syncs fold into one.

Numbers (the mix's "edits" block): agent, ops_min, ops_max, del_share,
del_max, ins_max, jump_share.
"""


def agents(e: dict) -> list:
    return [e["agent"]]


def next_sync(doc, e: dict) -> dict:
    rng = doc.rng
    if rng.random() < e["jump_share"]:
        doc.cursor = int(rng.integers(0, doc.length + 1))
    ops = []
    for _ in range(int(rng.integers(e["ops_min"], e["ops_max"] + 1))):
        c = doc.cursor
        if c and rng.random() < e["del_share"]:
            k = min(c, int(rng.integers(1, e["del_max"] + 1)))
            ops.append(("d", c - k, c))
            doc.cursor -= k
            doc.length -= k
        else:
            k = int(rng.integers(1, e["ins_max"] + 1))
            ops.append(("i", c, doc.pool.take(k)))
            doc.cursor += k
            doc.length += k
    return {"chains": [(e["agent"], ops)], "top": None}
