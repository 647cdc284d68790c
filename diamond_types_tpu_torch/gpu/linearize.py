"""Fugue-tree linearization: the parallel formulation of YjsMod integrate.

Port of the JAX package's `tpu/linearize.py`. The reference resolves
concurrent-insert order with a sequential scan per insert (YjsMod /
FugueMax `integrate`). This module re-expresses the SAME total order as a
static tree computation: every item run becomes a left child of its right
origin or a right child of its left origin, and the document is the DFS of
that tree. Sibling ordering, the tour and its ranking are sorts, gathers
and scans, batched over documents.

Inputs are RLE runs (id-consecutive items sharing origins/state, the
tracker's granularity):

    ids[i]   first LV of run i  (underwater ids >= 1<<62 are pre-zone text)
    length[i] run length (items)
    ol[i]    origin-left:  LV of the item immediately left at insert time,
             or -1 (document start)
    orr[i]   origin-right: LV of the next item at-or-right at insert time,
             or -1 (document end)
    agent[i] tie-break rank of the inserting agent (rank of its NAME)
    seq[i]   agent-local sequence number of the run's first item

Host half (numpy, copied as is): `split_runs_at_anchors`, `build_tree_np`,
`resolve_pos_keys`, `_doc_order_np`, `fugue_order_np`. Device half (plain
PyTorch, batched over `[b, n]` rows): `fugue_linearize` (the JAX package's
`fugue_linearize_jax`) and `materialize` (`materialize_jax`, also the
plain version of the checkout kernel K3, `gpu/kernels.py::
materialize_runs`). Every index op is int64 and every value int32, with
the JAX package's implicit clamps written out: torch raises on an
out-of-range gather or scatter where JAX clamps or drops.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.span import UNDERWATER_START as UNDERWATER

ROOT = -1

# ---------------------------------------------------------------------------
# host-side preparation: split runs so every anchor is a run endpoint
# ---------------------------------------------------------------------------


def split_runs_at_anchors(ids: np.ndarray, length: np.ndarray,
                          ol: np.ndarray, orr: np.ndarray,
                          extra: Tuple[np.ndarray, ...] = (),
                          extra_cuts: np.ndarray | None = None
                          ) -> Tuple[np.ndarray, ...]:
    """Split RLE runs so that every origin-left lands on a run's LAST item
    and every origin-right on a run's FIRST item. After this pass the tree
    is a pure run-level structure (no intra-run anchors).

    `extra` arrays (e.g. state) are split alongside; items inside a run are
    id-consecutive so a split at offset k gives (ids, k) + (ids+k, len-k)
    with the right half chained: ol = ids+k-1, orr = original orr... the
    right half keeps the SAME orr only if it was the run's trailing part;
    mid-run items' effective right origin within a run is the next item of
    the run itself, which stays adjacent — the chain ol encodes that.

    `extra_cuts` adds caller-chosen item-id cut points (the device
    transform cuts at the old/new LV threshold and at delete-target
    boundaries so per-run visibility is all-or-nothing). Extra cuts
    produce chained pieces exactly like anchor cuts, so they refine the
    run granularity without changing the linearization.
    """
    ends = ids + length
    # cut points: after every referenced ol (ol+1), and at every orr
    cuts = np.concatenate(
        [ol[ol != ROOT] + 1, orr[orr != ROOT]]
        + ([np.asarray(extra_cuts, dtype=ids.dtype)]
           if extra_cuts is not None and len(extra_cuts) else []))
    cuts = np.unique(cuts)
    # map each cut to the run containing it strictly inside (start < cut < end)
    order = np.argsort(ids, kind="stable")
    sids = ids[order]
    run_of = np.searchsorted(sids, cuts, side="right") - 1
    valid = (run_of >= 0)
    run_of = np.clip(run_of, 0, len(sids) - 1)
    inside = valid & (cuts > sids[run_of]) & (cuts < (sids + length[order])[run_of])
    cuts = cuts[inside]
    run_idx = order[run_of[inside]]  # original index of run to split

    # vectorized piece emission, grouped by run (ascending), cuts
    # ascending within each run
    n = len(ids)
    counts = np.bincount(run_idx, minlength=n) + 1
    out_n = int(counts.sum())
    offs = np.cumsum(counts) - counts          # first piece of each run
    last = offs + counts - 1                   # last piece of each run
    run_of_piece = np.repeat(np.arange(n), counts)

    cut_order = np.lexsort((cuts, run_idx))
    cuts_sorted = cuts[cut_order]

    is_first = np.zeros(out_n, dtype=bool)
    is_first[offs] = True
    new_ids = np.empty(out_n, dtype=np.int64)
    new_ids[offs] = ids
    new_ids[~is_first] = cuts_sorted           # (run, cut) order matches
    new_end = np.empty(out_n, dtype=np.int64)
    if out_n > 1:
        new_end[:-1] = new_ids[1:]             # next piece's start...
    new_end[last] = ends                       # ...except at run ends
    new_len = new_end - new_ids
    new_ol = np.where(is_first, ol[run_of_piece], new_ids - 1)
    new_orr = orr[run_of_piece]
    new_extra = tuple(e[run_of_piece] for e in extra)
    return (new_ids, new_len, new_ol, new_orr) + new_extra


# ---------------------------------------------------------------------------
# numpy reference linearizer
# ---------------------------------------------------------------------------


def _doc_order_np(parent: np.ndarray, side: np.ndarray, key_pos: np.ndarray,
                  key_agent: np.ndarray, key_seq: np.ndarray) -> np.ndarray:
    """DFS of the Fugue tree (parent == n is the virtual root) under the
    sibling sort (key_pos, key_agent, key_seq). Host-side mirror of
    fugue_linearize."""
    n = len(parent)
    order = np.lexsort((key_seq, key_agent, key_pos, side, parent))

    from collections import defaultdict
    kids_left = defaultdict(list)
    kids_right = defaultdict(list)
    for i in order:
        (kids_left if side[i] == 0 else kids_right)[int(parent[i])].append(i)

    out = np.empty(n, dtype=np.int64)
    w = 0
    # iterative DFS: (node, phase) — phase 0 = emit left kids, 1 = self+right
    stack = [(n, 0)]
    while stack:
        node, phase = stack.pop()
        if phase == 0:
            stack.append((node, 1))
            for c in reversed(kids_left.get(node, ())):
                stack.append((c, 0))
        else:
            if node < n:
                out[w] = node
                w += 1
            for c in reversed(kids_right.get(node, ())):
                stack.append((c, 0))
    assert w == n
    return out


def resolve_pos_keys(parent: np.ndarray, side: np.ndarray,
                     key_agent: np.ndarray, key_seq: np.ndarray,
                     orr_run: np.ndarray, max_rounds: int = 64) -> np.ndarray:
    """Right-origin position sort key per run (the YjsMod `scanning` rule,
    reference merge.rs:230-242: same-left-origin concurrent siblings order
    by right-origin DOCUMENT POSITION, descending, before the agent
    tie-break).

    Returned key is ascending-sorts-first: `n - rank(orr)` so a farther
    right origin gives a smaller key; ROOT (document end — the farthest
    possible right origin) and underwater runs get 0.

    The key depends on the document order, which depends on the key — but
    the recursion is well-founded: the order of a sibling pair (u, v)
    depends only on the order of their right-origin targets, both of which
    have strictly smaller LVs (origins causally precede their items), so
    iterating order → keys → order converges stratum by stratum. Almost
    every document converges in 0 rounds (no same-(parent, side) sibling
    group has heterogeneous right origins) or 2 (compute + verify)."""
    n = len(parent)
    key_pos = np.zeros(n, dtype=np.int64)
    if n == 0:
        return key_pos
    # fast path: if every (parent, side) sibling group shares one orr_run,
    # the key ties inside every group and cannot affect the order
    grp = parent.astype(np.int64) * 2 + side
    o = np.lexsort((orr_run, grp))
    gs, rs = grp[o], orr_run[o]
    if not ((gs[1:] == gs[:-1]) & (rs[1:] != rs[:-1])).any():
        return key_pos
    for _ in range(max_rounds):
        out = _doc_order_np(parent, side, key_pos, key_agent, key_seq)
        rank = np.empty(n, dtype=np.int64)
        rank[out] = np.arange(n)
        new = np.where(orr_run >= 0, n - rank[np.clip(orr_run, 0, n - 1)], 0)
        if (new == key_pos).all():
            return key_pos
        key_pos = new
    raise AssertionError("right-origin position keys did not converge")


def fugue_order_np(ids: np.ndarray, length: np.ndarray, ol: np.ndarray,
                   orr: np.ndarray, agent: np.ndarray, seq: np.ndarray
                   ) -> np.ndarray:
    """Return the permutation of run indices giving document order.

    Precondition: runs are anchor-split (split_runs_at_anchors) — every ol
    is some run's last item, every orr some run's first item.

    Tree rules (== YjsMod; validated vs the native tracker on corpora +
    cross-sync fuzz):
      * parent/side: run x is a LEFT child of the run starting at orr(x)
        when that run shares x's left origin (same insertion gap — the
        "b.leftOrigin == a" Fugue condition); otherwise x is a RIGHT child
        of the run whose last item is ol(x) (ol == ROOT → right child of
        the virtual root).
      * Same-(parent, side) siblings sort by the YjsMod order: right-origin
        document position DESCENDING (reference merge.rs:230-242, the
        `scanning` branch), then (agent rank, seq) ascending. The position
        rank is well-defined before the full order is known because the
        relative order of two existing items never changes as later items
        are inserted between them; `resolve_pos_keys` computes it by a
        (rarely needed) fixed point.
    Soundness of the flat sibling ordering: a sibling's right origin can
    never point strictly inside another sibling's subtree. origin_right is
    the immediate tracker successor skipping only NOT_INSERTED_YET items
    (reference merge.rs:407-424) — any item between the insertion gap and
    a deeper target would have to be NIY (concurrent), yet it causally
    precedes the target (origins precede items), which causally precedes
    the new item: contradiction. The only reachable interior targets are
    the left spine of the next subtree, whose members share the new item's
    origin-left, so the LEFT-child rule routes those exactly.
    """
    parent, side, key_agent, key_seq, orr_run = build_tree_np(
        ids, length, ol, orr, agent, seq)
    key_pos = resolve_pos_keys(parent, side, key_agent, key_seq, orr_run)
    return _doc_order_np(parent, side, key_pos, key_agent, key_seq)


# ---------------------------------------------------------------------------
# host-side tree construction (vectorized; feeds the device kernel)
# ---------------------------------------------------------------------------


def build_tree_np(ids: np.ndarray, length: np.ndarray, ol: np.ndarray,
                  orr: np.ndarray, agent: np.ndarray, seq: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray]:
    """Vectorized parent/side/key computation for anchor-split runs.

    Returns (parent, side, key_agent, key_seq, orr_run); parent == n means
    the virtual root (index n). orr_run maps each run's origin-right LV to
    the index of the run starting at that LV, or -1 for ROOT (document
    end) and for underwater runs (the fixed pre-zone spine takes no part
    in right-origin ordering) — the input resolve_pos_keys needs."""
    n = len(ids)
    ends = ids + length
    order_s = np.argsort(ids, kind="stable")
    sorted_starts = ids[order_s]
    order_e = np.argsort(ends, kind="stable")
    sorted_ends = ends[order_e]

    def run_starting(lv):
        j = np.searchsorted(sorted_starts, lv)
        jj = np.clip(j, 0, n - 1)
        hit = (j < n) & (sorted_starts[jj] == lv)
        return np.where(hit, order_s[jj], -2)

    def run_ending(lv):
        j = np.searchsorted(sorted_ends, lv + 1)
        jj = np.clip(j, 0, n - 1)
        hit = (j < n) & (sorted_ends[jj] == lv + 1)
        return np.where(hit, order_e[jj], -2)

    uw = ids >= UNDERWATER
    r = np.where(orr != ROOT, run_starting(orr), -2)
    assert ((r >= 0) | (orr == ROOT)).all(), "unsplit orr anchor"
    orr_run = np.where(uw | (r < 0), -1, r).astype(np.int64)
    r_ok = (r >= 0) & (ol[np.clip(r, 0, n - 1)] == ol) & ~uw
    p_right = np.where(ol == ROOT, n, run_ending(ol))
    parent = np.where(uw, n, np.where(r_ok, r, p_right)).astype(np.int64)
    side = np.where(uw, 1, np.where(r_ok, 0, 1)).astype(np.int8)
    key_agent = np.where(uw, -1, agent).astype(np.int64)
    # underwater sort key: RANK among underwater ids (their absolute ids
    # exceed int32; only the relative order matters — ids ascend with
    # document position)
    uw_sorted = np.sort(ids[uw])
    uw_rank = np.searchsorted(uw_sorted, ids)
    key_seq = np.where(uw, uw_rank, seq).astype(np.int64)
    # the device kernel runs in int32 and pad_docs marks padding rows with
    # INT32_MAX: real keys must stay strictly below it (fail loudly rather
    # than silently mis-sorting)
    assert (key_seq.max(initial=0) < 2**31 - 1
            and key_agent.max(initial=0) < 2**31 - 1)
    assert (parent >= 0).all(), "unsplit anchor"
    return parent, side, key_agent, key_seq, orr_run


# ---------------------------------------------------------------------------
# device linearizer: sibling sort + threaded tour + list ranking
# ---------------------------------------------------------------------------


def _lexsort_rows(keys) -> torch.Tensor:
    """Per-row `np.lexsort(keys)` of [b, n] tensors: the LAST key is the
    primary one. Stable sorts applied from the least to the most
    significant key."""
    b, n = keys[0].shape
    idx = torch.arange(n, device=keys[0].device).expand(b, n)
    for k in keys:
        order = torch.sort(k.gather(1, idx), dim=1, stable=True).indices
        idx = idx.gather(1, order)
    return idx


def fugue_linearize(parent: torch.Tensor, side: torch.Tensor,
                    key_pos: torch.Tensor, key_agent: torch.Tensor,
                    key_seq: torch.Tensor) -> torch.Tensor:
    """Document-order permutation of each row's n tree nodes.

    All inputs are [b, n] integer tensors on one device (parent == n is
    the virtual root). key_pos is the right-origin position key from
    resolve_pos_keys. Returns perm [b, n] int32: node indices in document
    order. Padding nodes carry parent == n, side == 1 and INT32_MAX keys,
    so they sort to the end of the document.

    The DFS is a threaded Euler tour (3 cells per node: pre, visit, post)
    ranked by pointer jumping in ceil(log2(3n+3)) + 1 rounds."""
    b, n = parent.shape
    dev = parent.device
    parent = parent.long()
    side = side.long()
    root = n
    N = n + 1

    # sibling order: (parent, side, key_pos, key_agent, key_seq)
    sort_idx = _lexsort_rows((key_seq.long(), key_agent.long(),
                              key_pos.long(), side, parent))
    grp = parent.gather(1, sort_idx) * 2 + side.gather(1, sort_idx)
    # next sibling within the group; -1 at group end
    same_next = torch.zeros_like(grp, dtype=torch.bool)
    same_next[:, :-1] = grp[:, :-1] == grp[:, 1:]
    nxt = torch.where(same_next, sort_idx.roll(-1, dims=1),
                      torch.full_like(sort_idx, -1))
    next_sib = torch.zeros_like(sort_idx).scatter(1, sort_idx, nxt)
    # first child per (node, side) via group-head scatter; non-heads go to
    # an overflow slot (n+1)*2 so no real slot gets clobbered
    is_head = torch.ones_like(grp, dtype=torch.bool)
    is_head[:, 1:] = grp[:, 1:] != grp[:, :-1]
    overflow = (n + 1) * 2
    first = torch.full((b, overflow + 1), -1, dtype=torch.long, device=dev)
    first.scatter_(1, torch.where(is_head, grp, overflow),
                   torch.where(is_head, sort_idx, -1))
    first_left = first[:, 0:overflow:2]
    first_right = first[:, 1:overflow:2]

    # cells: pre(x)=x, visit(x)=N+x, post(x)=2N+x for x in 0..n (root incl.)
    idx = torch.arange(N, device=dev).expand(b, N)
    succ_pre = torch.where(first_left >= 0, first_left, N + idx)
    succ_visit = torch.where(first_right >= 0, first_right, 2 * N + idx)
    # post(c): next sibling's pre, else visit(parent) [left] / post(parent)
    col = torch.full((b, 1), root, dtype=torch.long, device=dev)
    parent_full = torch.cat([parent, col], dim=1)
    side_full = torch.cat([side, torch.ones_like(col)], dim=1)
    next_sib_full = torch.cat([next_sib, torch.full_like(col, -1)], dim=1)
    up = torch.where(side_full == 0, N + parent_full, 2 * N + parent_full)
    succ_post = torch.where(next_sib_full >= 0, next_sib_full, up)
    succ_post[:, root] = -1                    # end of tour
    succ = torch.cat([succ_pre, succ_visit, succ_post], dim=1)

    # list ranking by pointer jumping: dist = #cells strictly after me
    live = succ >= 0
    dist = live.long()
    n_rounds = max(1, int(np.ceil(np.log2(3 * N))) + 1)
    for _ in range(n_rounds):
        sc = succ.clamp(0, 3 * N - 1)
        dist = dist + torch.where(live, dist.gather(1, sc), 0)
        succ = torch.where(live, succ.gather(1, sc), -1)
        live = succ >= 0
    # visit-cell position from head = total - 1 - dist (root excluded)
    visit_rank = (3 * N - 1) - dist[:, N:N + n]
    return torch.sort(visit_rank, dim=1, stable=True).indices.to(torch.int32)


BIAS = 1 << 30                                 # keeps parked bases >= 0


def materialize(perm: torch.Tensor, vis_len: torch.Tensor,
                arena_off: torch.Tensor, arena: torch.Tensor, cap: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assemble each row's visible text (the JAX package's
    `materialize_jax`, batched).

    perm [b, n]: document-order permutation; vis_len [b, n]: visible char
    count of each run (0 for deleted/NIY/padding); arena_off [b, n]: first
    char of the run's content in `arena`; arena [b, pool] int32 char codes;
    cap: output width. perm, arena_off and arena may instead be one row
    ([1, n], [1, pool]) that all b rows of vis_len share. Returns (text
    [b, cap] int32, total [b] int32): the runs laid out in perm order,
    clipped at cap, zero past total; total is not clipped.

    Each live run parks its start and its affine source base (`arena start
    - doc start`) AT its start slot; a cummax fills the starts forward,
    then one gather fetches the base and one the text."""
    b, n = vis_len.shape
    dev = vis_len.device
    p = perm.long().expand(b, n)
    arena_off = arena_off.expand(b, n)
    arena = arena.expand(b, arena.shape[1])
    vl = vis_len.gather(1, p).to(torch.int32)
    cum = torch.cumsum(vl, dim=1, dtype=torch.int32)
    total = cum[:, -1] if n else torch.zeros(b, dtype=torch.int32, device=dev)
    starts = cum - vl
    base = arena_off.gather(1, p).to(torch.int32) - starts
    cs = starts.clamp(0, cap - 1).long()
    # runs starting at/after cap never contribute an output char; keep them
    # out of the scatter or they would collide into slot cap-1
    live = (vl > 0) & (starts < cap)
    zero = torch.zeros((b, cap), dtype=torch.int32, device=dev)
    S = zero.scatter_reduce(1, cs, torch.where(live, starts, 0), "amax")
    S = torch.cummax(S, dim=1).values
    parked = zero.scatter_reduce(1, cs, torch.where(live, base + BIAS, 0),
                                 "amax")
    j = torch.arange(cap, dtype=torch.int32, device=dev).expand(b, cap)
    src = parked.gather(1, S.long()) - BIAS + j
    text = arena.gather(1, src.clamp(0, arena.shape[1] - 1).long())
    return torch.where(j < total[:, None], text, 0), total
