"""Dense causal-graph kernels: DAG queries as a scatter-max fixed point.

Port of the JAX package's `tpu/graph_kernels.py` (X6), as plain PyTorch on
an explicit device. The host causal graph (`causalgraph/graph.py`) exports
its RLE time-DAG as columnar arrays; these kernels re-express the
reference's heap-walk DAG queries (reference: src/causalgraph/graph/
tools.rs, frontier_contains_version and diff) as a relaxation over the
dense run table.

Within an RLE run ancestry is linear: if LV x of a run is an ancestor of a
frontier, so is every earlier LV of the run. So per-run reachability is one
integer `reach[e]`, the highest LV of run `e` known to be an ancestor (-1
none). One round relaxes every run at once:

    active runs (reach >= start) push their first-LV parents p as
    reach[run(p)] = max(reach[run(p)], p)

and rounds repeat until nothing changes (rounds = the DAG's depth in run
hops). Where the JAX package iterates with `lax.while_loop` and reads its
flag on the device, here the loop is on the host and reads the "changed"
flag once every `CHECK_EVERY` rounds, one sync per read. The relaxation is
monotone and idempotent at the fixed point, so the rounds run past it
change nothing and the result does not depend on `CHECK_EVERY`.

Queries batch as rows: a `[q, n]` reach matrix relaxes with one scatter per
round over `[q, m]` edges, flattened into one index. JAX's dropped writes
(`mode="drop"` to index `n`) land in an overflow column `n` that is sliced
off. Device math is int32, as in the JAX package: `reach`, `starts` and the
edge arrays are int32 and every search pins `out_int32`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import resolve_device

CHECK_EVERY = 16      # rounds between two reads of the "changed" flag


def pack_graph(graph, device: Optional[Union[str, torch.device]] = None
               ) -> dict:
    """Export a host Graph into CSR edge arrays on `device` (None: CUDA).

    Edge-parallel layout: one row per (run, parent) edge, so a 10k-way
    fan-in merge is 10k edge rows, not a [n, 10k] padded parent matrix.
    Device math is int32; LV bounds are checked here."""
    dev = resolve_device(device)
    starts, ends, _shadows, indptr, flat = graph.as_arrays()
    n = len(starts)
    if ends.max(initial=0) >= 2**31 - 1:
        raise ValueError("graph LVs exceed int32 device math")
    counts = np.diff(indptr)
    m = int(flat.shape[0])
    src = np.repeat(np.arange(n, dtype=np.int32), counts)
    plv = flat.astype(np.int32)
    prun = (np.searchsorted(starts, flat, side="right") - 1).astype(np.int32)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    return {"starts": put(starts), "ends": put(ends),
            "edge_src": put(src),     # [m] run owning the edge
            "edge_plv": put(plv),     # [m] parent LV
            "edge_prun": put(prun),   # [m] run containing the parent
            "n": n, "m": m, "device": dev}


def _entry_of(starts: torch.Tensor, lv: torch.Tensor) -> torch.Tensor:
    """The run holding each LV (int32; -1 before the first run)."""
    return torch.searchsorted(starts, lv.contiguous(), right=True,
                              out_int32=True) - 1


def relax(starts: torch.Tensor, src: torch.Tensor, plv: torch.Tensor,
          prun: torch.Tensor, reach: torch.Tensor) -> torch.Tensor:
    """One round's contributions over the edges (src, plv, prun) for each
    row of `reach` [q, n]: `upd[r, run(p)] = max p` over active edges, -1
    elsewhere (not yet maxed with `reach`). Inactive edges go to the
    overflow column n, which is cut off."""
    q, n = reach.shape
    active = (reach >= starts)[:, src.long()]                   # [q, m]
    contrib = torch.where(active, plv, -1)
    tgt = torch.where(active, prun, n).long()
    tgt = tgt + torch.arange(q, device=reach.device)[:, None] * (n + 1)
    upd = torch.full((q * (n + 1),), -1, dtype=torch.int32,
                     device=reach.device)
    upd.scatter_reduce_(0, tgt.reshape(-1), contrib.reshape(-1), "amax")
    return upd.view(q, n + 1)[:, :n]


def fixed_point(round_fn, reach: torch.Tensor,
                stats: Optional[dict] = None) -> torch.Tensor:
    """Apply `round_fn` (reach -> new reach, monotone) until a round
    changes nothing, reading the "changed" flag on the host once every
    `CHECK_EVERY` rounds (read at call time). `stats`, when given, gets
    `rounds` (rounds run, those past the fixed point included) and `syncs`
    (flag reads) added."""
    check_every = CHECK_EVERY
    if check_every < 1:
        raise ValueError(f"CHECK_EVERY must be >= 1, got {check_every}")
    rounds = syncs = 0
    while True:
        for _ in range(check_every):
            last = reach
            reach = round_fn(reach)
            rounds += 1
        syncs += 1
        if not bool((reach != last).any()):
            break
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + rounds
        stats["syncs"] = stats.get("syncs", 0) + syncs
    return reach


def reach_fixed_point(packed: dict, reach0: torch.Tensor,
                      stats: Optional[dict] = None) -> torch.Tensor:
    """Propagate per-run coverage to a fixed point.

    reach0: int32 [n] (or [q, n], one query per row), the highest
    directly named LV per run (-1 none). Returns reach, same shape: the
    highest LV of each run that is an ancestor of the seed set."""
    starts, src = packed["starts"], packed["edge_src"]
    plv, prun = packed["edge_plv"], packed["edge_prun"]
    batched = reach0.dim() == 2
    reach = (reach0 if batched else reach0[None]).to(torch.int32)

    def one_round(r: torch.Tensor) -> torch.Tensor:
        return torch.maximum(r, relax(starts, src, plv, prun, r))

    reach = fixed_point(one_round, reach, stats)
    return reach if batched else reach[0]


def seed_from_frontier(packed: dict, frontier_lvs: torch.Tensor
                       ) -> torch.Tensor:
    """reach0 from a padded (-1) frontier LV vector [k], or one frontier
    per row [q, k] (then [q, n])."""
    n = packed["n"]
    fr = frontier_lvs.to(device=packed["device"], dtype=torch.int32)
    batched = fr.dim() == 2
    fr = fr if batched else fr[None]
    valid = fr >= 0
    ent = torch.where(valid, _entry_of(packed["starts"], fr.clamp(min=0)),
                      n).long()
    reach0 = torch.full((fr.shape[0], n + 1), -1, dtype=torch.int32,
                        device=fr.device)
    reach0.scatter_reduce_(1, ent, torch.where(valid, fr, -1), "amax")
    reach0 = reach0[:, :n]
    return reach0 if batched else reach0[0]


def _contains(packed: dict, reach: torch.Tensor,
              target_lv: torch.Tensor) -> torch.Tensor:
    """reach [q, n], targets [q, t] -> [q, t] bool. An empty graph holds
    no LV (the JAX kernel's gather fails there; the host says False)."""
    t = target_lv.to(device=reach.device, dtype=torch.int32)
    if packed["n"] == 0:
        return t < 0
    te = _entry_of(packed["starts"], t.clamp(min=0)).clamp(min=0).long()
    return (t < 0) | (reach.gather(1, te) >= t)


def frontier_contains_lv(packed: dict, frontier_lvs: torch.Tensor,
                         target_lv: torch.Tensor,
                         stats: Optional[dict] = None) -> torch.Tensor:
    """Device analogue of frontier_contains_version (graph/tools.rs:88-146):
    one frontier [k] (padded with -1) against a target LV or a vector of
    them (-1 is ROOT: always contained)."""
    reach = reach_fixed_point(packed, seed_from_frontier(packed,
                                                         frontier_lvs),
                              stats)
    t = torch.as_tensor(target_lv)
    return _contains(packed, reach[None], t.reshape(1, -1)).reshape(t.shape)


def diff_masks(packed: dict, a_lvs: torch.Tensor, b_lvs: torch.Tensor,
               stats: Optional[dict] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-run coverage of a's and b's histories (both relaxed together,
    as two rows). `diff_to_spans` turns them into the (only_a, only_b)
    span lists of graph/tools.rs diff."""
    k = max(a_lvs.shape[0], b_lvs.shape[0], 1)

    def pad(x: torch.Tensor) -> torch.Tensor:
        x = x.to(device=packed["device"], dtype=torch.int32)
        return torch.cat([x, torch.full((k - x.shape[0],), -1,
                                        dtype=torch.int32, device=x.device)])

    reach = reach_fixed_point(
        packed, seed_from_frontier(packed, torch.stack([pad(a_lvs),
                                                        pad(b_lvs)])),
        stats)
    return reach[0], reach[1]


def frontier_matrix(frontiers: Sequence[Sequence[int]]) -> np.ndarray:
    """Frontiers as one [q, k] int32 array, padded with -1 (k >= 1)."""
    k = max((len(f) for f in frontiers), default=0) or 1
    out = np.full((len(frontiers), k), -1, dtype=np.int32)
    for i, f in enumerate(frontiers):
        out[i, :len(f)] = list(f)
    return out


def make_contains_fn(graph, device: Optional[Union[str, torch.device]] = None):
    """Pack once; return a batched containment query
    `contains(frontiers [q, k], targets [q]) -> bool [q]` (numpy arrays or
    tensors; -1 pads a frontier, and a -1 target is ROOT). All q queries
    relax together as the rows of one `[q, n]` reach matrix. The function
    keeps the rounds and syncs of its last call in `contains.stats`."""
    packed = pack_graph(graph, device)

    def contains(frontiers, targets) -> torch.Tensor:
        contains.stats = {}
        reach = reach_fixed_point(
            packed, seed_from_frontier(packed, _int32(frontiers)),
            contains.stats)
        return _contains(packed, reach,
                         _int32(targets).reshape(-1, 1)).reshape(-1)

    contains.packed = packed
    contains.stats = {}
    return contains


def make_diff_fn(graph, device: Optional[Union[str, torch.device]] = None):
    """Pack once; return `diff(a [k], b [k]) -> (reach_a, reach_b)`. The
    function keeps the rounds and syncs of its last call in `diff.stats`."""
    packed = pack_graph(graph, device)

    def diff(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
        diff.stats = {}
        return diff_masks(packed, _int32(a), _int32(b), diff.stats)

    diff.packed = packed
    diff.stats = {}
    return diff


def reach_to_spans(graph, reach) -> List[Tuple[int, int]]:
    """Host side: a reach vector as ascending covered spans."""
    reach = _host(reach)
    out: List[Tuple[int, int]] = []
    for i in range(len(graph.starts)):
        r = int(reach[i])
        if r >= graph.starts[i]:
            s = (graph.starts[i], r + 1)
            if out and out[-1][1] == s[0]:
                out[-1] = (out[-1][0], s[1])
            else:
                out.append(s)
    return out


def diff_to_spans(graph, ra, rb) -> Tuple[List[Tuple[int, int]],
                                          List[Tuple[int, int]]]:
    """Host side: two reach vectors as (only_a, only_b) ascending spans,
    the result of the host `Graph.diff(a, b)`."""
    ra, rb = _host(ra), _host(rb)
    out: Dict[bool, List[Tuple[int, int]]] = {True: [], False: []}
    for i in range(len(graph.starts)):
        s = graph.starts[i]
        a_hi, b_hi = int(ra[i]), int(rb[i])
        if a_hi == b_hi:
            continue
        side = out[a_hi > b_hi]
        lo = max(s, min(a_hi, b_hi) + 1)
        hi = max(a_hi, b_hi) + 1
        if side and side[-1][1] == lo:
            side[-1] = (side[-1][0], hi)
        else:
            side.append((lo, hi))
    return out[True], out[False]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _int32(x) -> torch.Tensor:
    """A tensor, numpy array or list of LVs as an int32 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.from_numpy(np.asarray(x, np.int32))
