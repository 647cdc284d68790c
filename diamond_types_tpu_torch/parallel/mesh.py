"""Device lists for the flush window and the sharded merge step.

Port of the JAX package's `parallel/mesh.py`. There a mesh is a
`jax.sharding.Mesh` and each program runs as ONE `shard_map` across it.
Here the mesh is an ordered list of distinct `torch.device`s: the ones the
scheduler's shards use (`serve_mesh`), or the first cards (`make_mesh`);
one H100 gives `[cuda:0]`.

Serve half. A window's super-batch is split by device (each session's rows
stay on its own card) and `mesh_fused_replay` launches K1 once per device
slice at its pow2 floor, as the port's other replay rungs do, so a window
over one card is one K1 launch per `(cap, max_ins)` class. It counts its
host-to-device copies with `obs.devprof.note_transfer` under the JAX
package's tag `mesh.plan`: the window's op arrays, once a call.

Graph half. `sharded_replay` replays `[b, n]` op tapes from empty documents
with one K1 launch per device slice of the padded rows;
`sharded_reach_fixed_point` splits the causal graph's padded edge list
(`pad_edges`) over the devices, relaxes each slice locally every round and
takes the maximum on the first device (the JAX package's `pmax`);
`multichip_merge_step` runs both. On one card the reach is X6
(`gpu/graph_kernels.py`) itself.

The forms over several cards (`place_on_devices=True` for the window, a
mesh of more than one card for the graph half) have run on no machine with
more than one card: they are untested.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..gpu import flush_fuse as _ff
from ..gpu import graph_kernels as _gk
from ..gpu import resolve_device
from ..gpu.steer import _pow2
from ..obs.devprof import note_transfer
from . import arena as _arena


def serve_mesh(devices: Sequence[torch.device]) -> List[torch.device]:
    """The window's mesh: the distinct devices among the shards'
    `devices`, in order of first appearance. The JAX package takes a
    shard count and slices `jax.devices()`; the port's shards already
    know their devices (`serve_shard_devices`, or one device for all)."""
    out: List[torch.device] = []
    seen = set()
    for d in devices:
        if str(d) not in seen:
            seen.add(str(d))
            out.append(torch.device(d))
    return out


def make_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The first `n_devices` cards (default: all), `[cuda:0, ...]`. Raises
    without CUDA; a CPU "mesh" is `[torch.device("cpu")]`, given
    explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh needs CUDA: no card is available; "
                           "pass [torch.device('cpu')] as the mesh instead")
    k = torch.cuda.device_count()
    n = k if n_devices is None else n_devices
    if not 1 <= n <= k:
        raise ValueError(f"need 1..{k} devices, asked for {n}")
    return [torch.device("cuda", i) for i in range(n)]


def serve_shard_devices(n_shards: int) -> List[torch.device]:
    """Shard i on `cuda:(i % device_count)`: every card gets shards, and
    shards beyond the card count share cards round-robin."""
    if not torch.cuda.is_available():
        raise RuntimeError("place_on_devices needs CUDA: no card is "
                           "available")
    k = torch.cuda.device_count()
    return [torch.device("cuda", i % k) for i in range(n_shards)]


def pad_batch_count(b: int, n_devices: int) -> int:
    """Smallest super-batch size >= b that divides the mesh and is
    n_devices times a power of two (one row per device is a class of its
    own). On one device this is the pow2 batch class, with 1 for 1."""
    per_dev = max(-(-max(int(b), 1) // n_devices), 1)
    return n_devices * (1 if per_dev == 1 else _pow2(per_dev))


def pad_batch_to_mesh(pos, dlen, ilen, chars, n_devices: int):
    """Pad a packed super-batch's row axis to `pad_batch_count` rows:
    padding rows carry all-zero ops, and the caller pairs them with
    `lens = -1` sentinel rows, so they stay identifiably inert through
    K1. Numpy arrays or tensors (padded on their own device). Returns
    (pos, dlen, ilen, chars, bp)."""
    b = pos.shape[0]
    bp = pad_batch_count(b, n_devices)
    if bp == b:
        return pos, dlen, ilen, chars, bp

    def _pad(a):
        out = a.new_zeros((bp,) + a.shape[1:]) \
            if isinstance(a, torch.Tensor) else \
            np.zeros((bp,) + a.shape[1:], dtype=a.dtype)
        out[:b] = a
        return out

    return _pad(pos), _pad(dlen), _pad(ilen), _pad(chars), bp


def _device_slices(mesh: Sequence[torch.device], sessions
                   ) -> List[Tuple[torch.device, List[int]]]:
    """The window's rows grouped by their session's device, in mesh
    order; rows keep the window's order inside a slice."""
    keys = [str(d) for d in mesh]
    rows: List[List[int]] = [[] for _ in mesh]
    for i, s in enumerate(sessions):
        if str(s.device) not in keys:
            raise ValueError(f"a session on {s.device} is outside the "
                             f"mesh {keys}")
        rows[keys.index(str(s.device))].append(i)
    return [(mesh[k], idx) for k, idx in enumerate(rows) if idx]


def _stage_rows(sessions, idx: List[int], bp: int, cap: int,
                dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slice's `[bp, cap]` input rows and `[bp]` lengths, gathered on
    the device, padding rows zero with length -1."""
    pad = bp - len(idx)
    docs = torch.stack([sessions[i].docs for i in idx])
    lens = torch.stack([sessions[i].lens for i in idx])
    if pad:
        docs = torch.cat([docs, torch.zeros((pad, cap), dtype=torch.int32,
                                            device=dev)])
        lens = torch.cat([lens, torch.full((pad,), -1, dtype=torch.int32,
                                           device=dev)])
    return docs, lens


def mesh_fused_replay(mesh: Sequence[torch.device], sessions, plans,
                      clock=None) -> Tuple[List[bool], float, int, int]:
    """Replay the fusable rows of a whole flush window, every shard's
    bucket concatenated, all sharing (cap, max_ins): one K1 launch per
    device slice of the super-batch.

    Each slice pads to its pow2 batch class with inert rows (zero ops,
    length -1) and every slice's op tape to the window's pow2 op class.
    K1 is launched through `flush_fuse.apply_ops_window`, the name every
    replay rung launches through. Input rows come from the class's arena
    when the same sessions recur, else from a device-side gather
    (`parallel/arena.py`). The length fence is
    `flush_fuse.adopt_results`, committing each good row as a view of the
    output with no clone; the outputs are then parked as the class's
    arena.

    `clock` (the window's `serve.metrics.FlushClock`, its "pack" phase
    running) is switched to "fence" at the length fetch and to "adopt"
    for the commits and the arena.

    Returns (ok per session, seconds blocked on the length fetch, padded
    rows launched, host-to-device bytes staged: the plan arrays). A kernel
    fault propagates."""
    b = len(sessions)
    if b < 1 or b != len(plans):
        raise ValueError(f"{b} sessions for {len(plans)} plans")
    cap, mi = sessions[0].cap, sessions[0].max_ins
    for s in sessions:
        if (s.cap, s.max_ins) != (cap, mi):
            raise ValueError("a window class must share cap and max_ins")
    slices = _device_slices(mesh, sessions)
    n = _pow2(max(max(p.n_ops for p in plans), 1))
    sizes = [pad_batch_count(len(idx), 1) for _, idx in slices]
    bp = sum(sizes)
    staged = 0
    ops = []
    for (dev, idx), bpd in zip(slices, sizes):
        arrs = _ff.pack_plans([plans[i] for i in idx], n, mi, bpd)
        staged += sum(a.nbytes for a in arrs)
        ops.append([torch.from_numpy(a).to(dev) for a in arrs])
    note_transfer(staged, rung="mesh", purpose="plan")
    reuse = _arena.acquire(mesh, cap, mi, sessions, bp)
    if reuse is not None:
        docs_l, lens_l = reuse
    else:
        rows = [_stage_rows(sessions, idx, bpd, cap, dev)
                for (dev, idx), bpd in zip(slices, sizes)]
        docs_l = [d for d, _ in rows]
        lens_l = [ln for _, ln in rows]
    outs = [_ff.apply_ops_window(d, ln, *o, mi)
            for d, ln, o in zip(docs_l, lens_l, ops)]
    # the length fetch is the completion fence
    if clock is not None:
        clock.enter_phase("fence")
    t_fence = time.perf_counter()
    got = [_ff.fetch_lengths(out_lens) for _, out_lens in outs]
    device_s = time.perf_counter() - t_fence
    if clock is not None:
        clock.enter_phase("adopt")
    ok = [False] * b
    for (_dev, idx), (out_docs, out_lens), g in zip(slices, outs, got):
        oks = _ff.adopt_results([sessions[i] for i in idx],
                                [plans[i] for i in idx], out_docs,
                                out_lens, g, clone=False)
        for i, good in zip(idx, oks):
            ok[i] = good
    _arena.adopt(mesh, cap, mi, [o[0] for o in outs], [o[1] for o in outs],
                 sessions, ok, bp)
    return ok, device_s, bp, staged


# ---------------------------------------------------------------------------
# the graph half: sharded replay and reachability
# ---------------------------------------------------------------------------

def _mesh_devices(mesh: Sequence) -> List[torch.device]:
    if not len(mesh):
        raise ValueError("the mesh holds no device")
    return [resolve_device(d) for d in mesh]


def sharded_replay(mesh: Sequence[torch.device], pos, dlen, ilen, chars,
                   cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replay `[b, n]` op tapes (pos/dlen/ilen int32 [b, n], chars int32
    [b, n, max_ins], numpy or tensors) into `[b, cap]` documents from empty
    ones: the rows padded to `pad_batch_count(b, len(mesh))` with inert
    rows (`pad_batch_to_mesh`), split evenly over the mesh, and K1
    (`flush_fuse.apply_ops_window`) launched once per device slice.

    The function of the JAX package's `replay_batch` sharded over the
    `docs` axis: ops with dlen or ilen > max_ins are no-ops and poison
    EVERY length in the batch to -1. Returns (docs [b, cap], lens [b]) on
    the mesh's first device. Tensors stay on their device until their
    slice moves to its own; numpy input is staged from the host."""
    devs = _mesh_devices(mesh)
    arrs = [x.to(torch.int32) if isinstance(x, torch.Tensor) else
            torch.from_numpy(np.ascontiguousarray(x, np.int32))
            for x in (pos, dlen, ilen, chars)]
    b = arrs[0].shape[0]
    mi = arrs[3].shape[-1]
    any_bad = ((arrs[1] > mi) | (arrs[2] > mi)).any()
    *padded, bp = pad_batch_to_mesh(*arrs, len(devs))
    per = bp // len(devs)
    docs_l, lens_l = [], []
    for k, dev in enumerate(devs):
        rows = slice(k * per, (k + 1) * per)
        p, d, i, c = (a[rows].contiguous().to(dev) for a in padded)
        docs, lens = _ff.apply_ops_window(
            torch.zeros((per, cap), dtype=torch.int32, device=dev),
            torch.zeros(per, dtype=torch.int32, device=dev), p, d, i, c, mi)
        docs_l.append(docs.to(devs[0]))
        lens_l.append(lens.to(devs[0]))
    docs = torch.cat(docs_l)[:b]
    lens = torch.cat(lens_l)[:b]
    return docs, torch.where(any_bad.to(devs[0]), -1, lens)


def pad_edges(packed: dict, n_devices: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a `pack_graph` CSR edge list to a multiple of n_devices (at
    least n_devices). Padding edges scatter to the overflow slot (prun ==
    n) with a -1 LV, so they are inert whatever their activity. Returns
    (src, plv, prun) int32 numpy arrays ready to split."""
    n, m = packed["n"], packed["m"]
    pad_to = max(n_devices, ((m + n_devices - 1) // n_devices) * n_devices)
    src = np.zeros(pad_to, dtype=np.int32)
    plv = np.full(pad_to, -1, dtype=np.int32)
    prun = np.full(pad_to, n, dtype=np.int32)
    for out, key in ((src, "edge_src"), (plv, "edge_plv"),
                     (prun, "edge_prun")):
        v = packed[key]
        out[:m] = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
    return src, plv, prun


def sharded_reach_fixed_point(mesh: Sequence[torch.device], starts,
                              edge_src, edge_plv, edge_prun, reach0,
                              stats: Optional[dict] = None) -> torch.Tensor:
    """Causal-graph reachability with the EDGE list split across the mesh.

    Each device owns a contiguous slice of the (run, parent) edges (their
    count divisible by the mesh size: `pad_edges`); `starts` and the reach
    vector are copied to every device. One round: each device relaxes its
    slice, and the first device takes the maximum of the contributions and
    of reach (the JAX package's `pmax`). Rounds repeat to the fixed point,
    the "changed" flag read once every `graph_kernels.CHECK_EVERY` rounds
    (`graph_kernels.fixed_point`). Edge sharding, not run sharding, keeps
    a 10k-way fan-in balanced: its edges spread evenly over the mesh.

    starts int32 [n]; edge_* int32 [m]; reach0 int32 [n]; numpy or
    tensors. Returns reach int32 [n] on the mesh's first device."""
    devs = _mesh_devices(mesh)

    def put(x, dev: torch.device) -> torch.Tensor:
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x, np.int32))
        return x.to(device=dev, dtype=torch.int32)

    m = int(np.shape(edge_src)[0])
    if m % len(devs):
        raise ValueError(f"{m} edges do not split over {len(devs)} "
                         "devices: pad them with pad_edges")
    per = m // len(devs)
    sl = [tuple(put(e, dev)[k * per:(k + 1) * per]
                for e in (edge_src, edge_plv, edge_prun))
          for k, dev in enumerate(devs)]
    st = [put(starts, dev) for dev in devs]
    home = devs[0]

    def one_round(reach: torch.Tensor) -> torch.Tensor:
        out = reach
        for dev, s, (src, plv, prun) in zip(devs, st, sl):
            upd = _gk.relax(s, src, plv, prun, reach.to(dev))
            out = torch.maximum(out, upd.to(home))
        return out

    reach = _gk.fixed_point(one_round, put(reach0, home)[None], stats)
    return reach[0]


def multichip_merge_step(mesh: Sequence[torch.device], pos, dlen, ilen,
                         chars, cap: int, starts, edge_src, edge_plv,
                         edge_prun, reach0,
                         stats: Optional[dict] = None):
    """One sharded merge step: the documents' replay split over the mesh
    (`sharded_replay`, K1 once per device slice) and the causal graph's
    reachability with its edges split over the mesh
    (`sharded_reach_fixed_point`). Returns (docs, lens, reach)."""
    docs, lens = sharded_replay(mesh, pos, dlen, ilen, chars, cap)
    reach = sharded_reach_fixed_point(mesh, starts, edge_src, edge_plv,
                                      edge_prun, reach0, stats)
    return docs, lens, reach
