"""THE single source of the in-browser CRDT engine's replay algorithm.

This module is written in a restricted, JS-expressible Python subset and
is BOTH artifacts at once (VERDICT r4 #5):

  * executed directly by the Python test/fuzz/golden-vector suite
    (tests/test_crdt_client_logic.py) — the oracle-blessed conformance
    vectors run against THIS code;
  * transpiled to the JavaScript shipped inside the editor page
    (tools/py2js.py, embedded by tools/web_assets.py at import time) —
    the emitted JS is generated, never stored, so it cannot be
    hand-edited out of sync; the transpiler rejects any construct
    outside the subset at generation time.

Algorithm: unit-op text CRDT replay — topological order with
(agent, seq) ties, ancestor sets, origin resolution against the visible
item list, and the YjsMod integrate state machine with the scanning
rollback (reference: src/listmerge/merge.rs:154-278 integrate,
merge.rs:407-424 origin-right resolution). Convergence therefore matches
every other engine in this repo; replay is a full O(n^2) recompute —
fine for interactive docs, and it keeps the client auditable.

Subset rules (enforced by py2js): no tuples, comprehensions, slices,
generators, f-strings, kwargs or classes; dict records with string-
literal keys only (they become JS object properties); lists via
append/insert/pop/len; loops via range()/direct iteration; bitwise ops
only on sub-30-bit non-negative words (JS bitwise is signed 32-bit);
agent ordering uses plain `<` on strings (JS compares UTF-16 units,
Python code points — identical for BMP agent names, which the server
edge ENFORCES: astral-named agents are rejected at input validation).

Ancestor sets are 30-bit word arrays (anc_add/anc_has below), the same
word-wise representation the pre-single-source JS used — per-keystroke
replay cost stays O(n^2/30), not O(n^2) Set traffic.

Ops: {"agent": str, "seq": int, "parents": [[agent, seq]...],
      "kind": "ins"|"del", "pos": int, "ch": str|None}
"""


def dict_has(d, k):
    return k in d


def op_key(agent, seq):
    return agent + ":" + str(seq)


def replay(ops):
    """Replay every op in causal order; returns the document text, or
    None when a dependency is missing (caller waits for more ops)."""
    n = len(ops)
    by_key = {}
    for i in range(n):
        by_key[op_key(ops[i]["agent"], ops[i]["seq"])] = i

    # topological order, ready set ordered by (agent, seq)
    indeg = []
    for i in range(n):
        indeg.append(0)
    kids = {}
    for i in range(n):
        parents = ops[i]["parents"]
        for p in parents:
            pk = op_key(p[0], p[1])
            if not dict_has(by_key, pk):
                return None           # missing dependency: wait
            j = by_key[pk]
            indeg[i] = indeg[i] + 1
            if not dict_has(kids, j):
                kids[j] = []
            kids[j].append(i)
    ready = []
    for i in range(n):
        if indeg[i] == 0:
            ready.append(i)
    order = []
    while len(ready) > 0:
        # take the (agent, seq)-smallest ready op (explicit scan: the
        # tie-break IS convergence-relevant and must live here, not in
        # a per-language sort shim)
        best = 0
        for r in range(1, len(ready)):
            ra = ops[ready[r]]["agent"]
            ba = ops[ready[best]]["agent"]
            if ra < ba:
                best = r
            elif ra == ba and ops[ready[r]]["seq"] < ops[ready[best]]["seq"]:
                best = r
        i = ready.pop(best)
        order.append(i)
        if dict_has(kids, i):
            for k in kids[i]:
                indeg[k] = indeg[k] - 1
                if indeg[k] == 0:
                    ready.append(k)
    if len(order) != n:
        return None                   # cycle = corrupt input

    # ancestor bitsets (30-bit words): anc[i] = parents union their
    # ancestors
    nw = n // 30 + 1
    anc = []
    for i in range(n):
        row = []
        for w in range(nw):
            row.append(0)
        anc.append(row)
    for idx in range(len(order)):
        i = order[idx]
        for p in ops[i]["parents"]:
            j = by_key[op_key(p[0], p[1])]
            for w in range(nw):
                anc[i][w] = anc[i][w] | anc[j][w]
            anc_add(anc[i], j)

    # items: one per insert op, in document order as built
    items = []

    for idx in range(len(order)):
        i = order[idx]
        op = ops[i]
        if op["kind"] == "del":
            seen = 0
            for x in range(len(items)):
                it = items[x]
                if _visible_at(anc, i, it):
                    if seen == op["pos"]:
                        it["dels"].append(i)
                        break
                    seen = seen + 1
            continue
        # insert: origin-left = visible item at pos-1; cursor after it
        ol_idx = -1
        seen = 0
        if op["pos"] > 0:
            for x in range(len(items)):
                if _visible_at(anc, i, items[x]):
                    seen = seen + 1
                    if seen == op["pos"]:
                        ol_idx = x
                        break
        # origin-right: first non-NotInsertedYet item after the cursor
        # (merge.rs:407-424 — deleted items count, concurrent ones don't)
        orr_idx = len(items)
        for x in range(ol_idx + 1, len(items)):
            if anc_has(anc[i], items[x]["ins"]):
                orr_idx = x
                break
        if orr_idx < len(items):
            my_orr_key = op_key(items[orr_idx]["a"], items[orr_idx]["s"])
        else:
            my_orr_key = "END"
        # integrate (YjsMod, merge.rs:154-278) — the scanning state
        # machine; rollback lands BEFORE the compared item (merge.rs:233
        # clones the cursor before advancing past it)
        dst = ol_idx + 1
        scanning = False
        scan_start = ol_idx + 1
        for x in range(ol_idx + 1, orr_idx):
            o = items[x]
            if o["ol"] < ol_idx:
                break
            if o["ol"] == ol_idx:
                if o["orrKey"] == my_orr_key:
                    ins_here = op["agent"] < o["a"] or \
                        (op["agent"] == o["a"] and op["seq"] < o["s"])
                    if ins_here:
                        break
                    scanning = False
                else:
                    # right-origin document position comparison (END is
                    # farthest; -1 encodes END in orrItem)
                    o_r = o["orrItem"]
                    if o_r == -1:
                        o_r = n + len(items) + 1
                    my_r = orr_idx
                    if orr_idx >= len(items):
                        my_r = n + len(items) + 1
                    if o_r < my_r:
                        if not scanning:
                            scanning = True
                            scan_start = x
                    else:
                        scanning = False
            dst = x + 1
        if scanning:
            dst = scan_start
        if orr_idx >= len(items):
            orr_item = -1
        else:
            orr_item = orr_idx
        item = {"ins": i, "dels": [], "ol": ol_idx, "a": op["agent"],
                "s": op["seq"], "ch": op["ch"], "orrItem": orr_item,
                "orrKey": my_orr_key}
        # inserting shifts stored item indexes at/after dst
        for x in range(len(items)):
            it = items[x]
            if it["ol"] >= dst:
                it["ol"] = it["ol"] + 1
            if it["orrItem"] != -1 and it["orrItem"] >= dst:
                it["orrItem"] = it["orrItem"] + 1
        if item["ol"] >= dst:
            item["ol"] = item["ol"] + 1
        if item["orrItem"] != -1 and item["orrItem"] >= dst:
            item["orrItem"] = item["orrItem"] + 1
        items.insert(dst, item)

    text = ""
    for x in range(len(items)):
        if len(items[x]["dels"]) == 0:
            text = text + items[x]["ch"]
    return text


def anc_add(row, j):
    row[j // 30] = row[j // 30] | (1 << (j % 30))


def anc_has(row, j):
    return ((row[j // 30] >> (j % 30)) & 1) == 1


def _visible_at(anc, i, it):
    if not anc_has(anc[i], it["ins"]):
        return False
    for d in it["dels"]:
        if anc_has(anc[i], d):
            return False
    return True
