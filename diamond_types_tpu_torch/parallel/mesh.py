"""The flush window's device list and its one-launch-per-device replay.

Port of the serve half of the JAX package's `parallel/mesh.py`. There a
mesh is a `jax.sharding.Mesh` over a `docs` axis and a window runs as ONE
`shard_map` program across it. Here the mesh is the ordered list of the
distinct `torch.device`s the scheduler's shards use (`serve_mesh`); one
H100 gives `[cuda:0]`. A window's super-batch is split by device (each
session's rows stay on its own card) and K1 is launched once per device
slice (`mesh_flush_fn`), so a window over one card is one K1 launch per
`(cap, max_ins)` class.

With no jit there is no program cache: `mesh_flush_fn` only notes the
steered class warm for steering's bookkeeping (cache `"mesh"`), and each
slice launches at its pow2 floor, as the port's other replay rungs do.

The graph half of the JAX module (`sharded_replay`, `pad_edges`,
`sharded_reach_fixed_point`, `multichip_merge_step`) is not ported yet.
The form over several cards (`place_on_devices=True`) splits and launches
per device but has run on no machine with more than one card.
"""

from __future__ import annotations

import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..gpu import flush_fuse as _ff
from ..gpu.steer import STEER, _pow2
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
    K1. Returns (pos, dlen, ilen, chars, bp)."""
    b = pos.shape[0]
    bp = pad_batch_count(b, n_devices)
    if bp == b:
        return pos, dlen, ilen, chars, bp

    def _pad(a):
        out = np.zeros((bp,) + a.shape[1:], dtype=a.dtype)
        out[:b] = a
        return out

    return _pad(pos), _pad(dlen), _pad(ilen), _pad(chars), bp


def mesh_flush_fn(mesh: Sequence[torch.device], b: int, n: int, mi: int,
                  cap: int) -> Callable[[list], list]:
    """The window's replay over `mesh`: notes the class `(b, n)` warm
    under steering's `"mesh"` cache and returns a function that takes one
    `(docs, lens, pos, dlen, ilen, chars)` tuple per device slice and
    launches K1 once per slice, returning one `(out_docs, out_lens)` per
    slice. K1 is reached through `flush_fuse.apply_ops_window`, the name
    every replay rung launches through."""
    STEER.note_warm("mesh", mi, cap, b, n)

    def run(slices: list) -> list:
        return [_ff.apply_ops_window(*args, mi) for args in slices]
    return run


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
                dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One slice's `[bp, cap]` input rows and `[bp]` lengths, padding rows
    zero with length -1: gathered on the device (`DEVICE_STAGE`), or
    round-tripped through host numpy. Returns (docs, lens, host bytes)."""
    pad = bp - len(idx)
    if _arena.DEVICE_STAGE.enabled:
        docs = torch.stack([sessions[i].docs for i in idx])
        lens = torch.stack([sessions[i].lens for i in idx])
        if pad:
            docs = torch.cat([docs, torch.zeros((pad, cap),
                                                dtype=torch.int32,
                                                device=dev)])
            lens = torch.cat([lens, torch.full((pad,), -1,
                                               dtype=torch.int32,
                                               device=dev)])
        return docs, lens, 0
    docs_h = np.zeros((bp, cap), np.int32)
    lens_h = np.full(bp, -1, np.int32)
    for r, i in enumerate(idx):
        docs_h[r] = sessions[i].docs.cpu().numpy()
        lens_h[r] = int(sessions[i].lens)
    return (torch.from_numpy(docs_h).to(dev),
            torch.from_numpy(lens_h).to(dev),
            docs_h.nbytes + lens_h.nbytes)


def mesh_fused_replay(mesh: Sequence[torch.device], sessions, plans
                      ) -> Tuple[List[bool], float, int, int]:
    """Replay the fusable rows of a whole flush window, every shard's
    bucket concatenated, all sharing (cap, max_ins): one K1 launch per
    device slice of the super-batch.

    Each slice pads to its pow2 batch class with inert rows (zero ops,
    length -1) and every slice's op tape to the window's pow2 op class.
    Steering records the class the JAX mesh would dispatch
    (`STEER.snap("mesh", ..., multiple=len(mesh))`); the launch stays at
    the floor. Input rows come from the class's arena when the same
    sessions recur, else from a device-side gather, or from host staging
    with `DEVICE_STAGE` off (`parallel/arena.py`). The length fence is
    `flush_fuse.adopt_results`, committing each good row as a view of the
    output with no clone; the outputs are then parked as the class's
    arena.

    Returns (ok per session, seconds blocked on the length fetch, padded
    rows launched, host-to-device bytes staged: the plan arrays, plus
    the rows with host staging). A kernel fault propagates."""
    b = len(sessions)
    if b < 1 or b != len(plans):
        raise ValueError(f"{b} sessions for {len(plans)} plans")
    cap, mi = sessions[0].cap, sessions[0].max_ins
    for s in sessions:
        if (s.cap, s.max_ins) != (cap, mi):
            raise ValueError("a window class must share cap and max_ins")
    slices = _device_slices(mesh, sessions)
    n = _pow2(max(max(p.n_ops for p in plans), 1))
    bp_steer, n_steer = STEER.snap("mesh", pad_batch_count(b, len(mesh)),
                                   n, mi, cap, multiple=len(mesh))
    run = mesh_flush_fn(mesh, bp_steer, n_steer, mi, cap)
    sizes = [pad_batch_count(len(idx), 1) for _, idx in slices]
    bp = sum(sizes)
    staged = 0
    ops = []
    for (dev, idx), bpd in zip(slices, sizes):
        arrs = _ff.pack_plans([plans[i] for i in idx], n, mi, bpd)
        staged += sum(a.nbytes for a in arrs)
        ops.append([torch.from_numpy(a).to(dev) for a in arrs])
    reuse = _arena.acquire(mesh, cap, mi, sessions, bp) \
        if _arena.DEVICE_STAGE.enabled else None
    if reuse is not None:
        docs_l, lens_l = reuse
    else:
        docs_l, lens_l = [], []
        for (dev, idx), bpd in zip(slices, sizes):
            docs, lens, nbytes = _stage_rows(sessions, idx, bpd, cap, dev)
            docs_l.append(docs)
            lens_l.append(lens)
            staged += nbytes
    outs = run([(d, ln, *o) for d, ln, o in zip(docs_l, lens_l, ops)])
    # the length fetch is the completion fence
    t_fence = time.perf_counter()
    got = [out_lens.cpu().numpy() for _, out_lens in outs]
    device_s = time.perf_counter() - t_fence
    ok = [False] * b
    for (_dev, idx), (out_docs, out_lens), g in zip(slices, outs, got):
        oks = _ff.adopt_results([sessions[i] for i in idx],
                                [plans[i] for i in idx], out_docs,
                                out_lens, g, clone=False)
        for i, good in zip(idx, oks):
            ok[i] = good
    if _arena.DEVICE_STAGE.enabled:
        _arena.adopt(mesh, cap, mi, [o[0] for o in outs],
                     [o[1] for o in outs], sessions, ok, bp)
    return ok, device_s, bp, staged
