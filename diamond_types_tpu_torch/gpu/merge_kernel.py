"""Device checkout: whole documents, and incremental merges, with the
concurrent-order resolution and the text assembly on the device.

Port of the JAX package's `tpu/merge_kernel.py`. The host extracts each
item run's origins (the native tracker is the right tool for positional
lookups); the device computes the document order (the Fugue-tree
linearization that replaces YjsMod `integrate`, `gpu/linearize.py`) and
lays out the visible text, batched over documents:

  host   prepare_doc(oplog):
           native transform (origin extraction) -> tracker item table
           -> anchor-split runs -> tree arrays (parent/side/keys)
           -> char pool (fast-forward prefix text + insert arena)
  device checkout_batch_device(docs):
           `fugue_linearize` over the batch's [b, n] rows, then ONE call
           of kernel K3 (`kernels.materialize_runs`) for the whole batch:
           two kernels on one stream (a row scan of the run starts, then
           a gather over rows x tiles of cap), counted as one launch

Documents are padded to a common run count and char pool (powers of two);
padding runs carry parent = root, INT32_MAX keys and zero visible length,
so they sort to the end and contribute no text.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..listmerge.columnar import agent_key_columns, arena_offset_columns
from ..native.core import get_native_ctx
from ..text.op import INS
from . import kernels, resolve_device
from .flush_fuse import _pow2
from .linearize import (UNDERWATER, build_tree_np, fugue_linearize,
                        resolve_pos_keys, split_runs_at_anchors)

INT32_MAX = np.iinfo(np.int32).max


@dataclass
class DeviceDoc:
    """Host-prepared dense tables for one document's device checkout."""
    parent: np.ndarray      # [n] int32, parent == n -> virtual root
    side: np.ndarray        # [n] int8, 0 left / 1 right child
    key_pos: np.ndarray     # [n] int32 sibling sort key (orr position desc)
    key_agent: np.ndarray   # [n] int32 sibling sort key (agent name rank)
    key_seq: np.ndarray     # [n] int32 sibling sort key (seq)
    vis_len: np.ndarray     # [n] int32 visible chars contributed by run
    char_off: np.ndarray    # [n] int32 first char of run in `chars`
    chars: np.ndarray       # [pool] int32 char codes (prefix + ins arena)
    total_len: int          # expected document length
    frontier: Optional[List[int]] = None  # version the checkout lands on


def prepare_doc(oplog, from_frontier: Sequence[int] = (),
                merge_frontier: Optional[Sequence[int]] = None) -> DeviceDoc:
    """Host pass: origins + char pool for a device checkout.

    Serves incremental merge too: the tracker covers the conflict zone of
    (from, merge), the underwater spine tiles the document at the zone's
    common ancestor, and the checkout is the document at
    version_union(from, merge), which is exactly what a branch at `from`
    merging `merge` must converge to."""
    ctx = get_native_ctx(oplog)
    frm = [int(x) for x in from_frontier]
    merge = ([int(x) for x in oplog.version] if merge_frontier is None
             else [int(x) for x in merge_frontier])
    *_rest, union = ctx.transform(frm, merge)
    ids, ln, ol, orr, st, ev = ctx.dump_tracker(keep_underwater=True)
    common = ctx.zone_common()

    # The underwater id space tiles the document at the conflict zone's
    # COMMON ANCESTOR (the version the tracker's walk starts from): zone
    # ops that are pure deletes toggle underwater text without creating
    # tracker items.
    if len(ids) == 0:
        # no conflict zone at all (purely linear history): the document is
        # the fast-forward result; model it as one visible pseudo-run
        prefix, _ = ctx.merge_to_string("", [], union)
        ctx.release_tracker()
        arr = np.frombuffer(prefix.encode("utf-32-le"), dtype=np.int32)
        n = 1
        return DeviceDoc(
            parent=np.array([n], dtype=np.int32),
            side=np.ones(n, dtype=np.int8),
            key_pos=np.zeros(n, dtype=np.int32),
            key_agent=np.zeros(n, dtype=np.int32),
            key_seq=np.zeros(n, dtype=np.int32),
            vis_len=np.array([len(arr)], dtype=np.int32),
            char_off=np.zeros(n, dtype=np.int32),
            chars=arr if len(arr) else np.zeros(1, np.int32),
            total_len=len(arr), frontier=union)
    if common:
        prefix, _ = ctx.merge_to_string("", [], common)
    else:
        prefix = ""
    ctx.release_tracker()  # the dump above is all we needed
    prefix_arr = np.frombuffer(prefix.encode("utf-32-le"), dtype=np.int32)
    plen = len(prefix_arr)

    s_ids, s_len, s_ol, s_orr, s_ev = split_runs_at_anchors(
        ids, ln, ol, orr, (ev,))
    agent, seq = agent_key_columns(oplog, s_ids)
    parent, side, ka, ks, orr_run = build_tree_np(s_ids, s_len, s_ol, s_orr,
                                                  agent, seq)
    kp = resolve_pos_keys(parent, side, ka, ks, orr_run)

    uw = s_ids >= UNDERWATER
    # Final visibility: a full checkout merges EVERY op, so an item is
    # visible iff no delete op ever targeted it (the tracker's monotone
    # `ever` flag). Underwater runs are structural anchors; only their
    # overlap with the real prefix text [UNDERWATER, UNDERWATER+plen) is
    # document text.
    uw_text = np.maximum(
        0, np.minimum(s_ids + s_len, UNDERWATER + plen) - s_ids)
    vis = np.where(s_ev != 0, 0, np.where(uw, uw_text, s_len))

    arena_str = oplog.ops._arenas[INS].get((0, oplog.ops.arena_len(INS)))
    arena = np.frombuffer(arena_str.encode("utf-32-le"), dtype=np.int32)
    chars = np.concatenate([prefix_arr, arena]) if plen else arena
    off = np.where(uw, s_ids - UNDERWATER,
                   plen + arena_offset_columns(oplog, np.where(uw, 0, s_ids)))

    return DeviceDoc(
        parent=parent.astype(np.int32), side=side.astype(np.int8),
        key_pos=kp.astype(np.int32),
        key_agent=ka.astype(np.int32), key_seq=ks.astype(np.int32),
        vis_len=vis.astype(np.int32), char_off=off.astype(np.int32),
        chars=chars.astype(np.int32), total_len=int(vis.sum()),
        frontier=union)


def pad_docs(docs: List[DeviceDoc]):
    """Stack documents into [b, n] / [b, pool] int32 arrays, n and pool
    padded to powers of two."""
    n = _pow2(max(d.parent.shape[0] for d in docs))
    pool = _pow2(max(d.chars.shape[0] for d in docs))
    b = len(docs)
    parent = np.full((b, n), 0, dtype=np.int32)
    side = np.ones((b, n), dtype=np.int32)
    kp = np.full((b, n), INT32_MAX, dtype=np.int32)
    ka = np.full((b, n), INT32_MAX, dtype=np.int32)
    ks = np.full((b, n), INT32_MAX, dtype=np.int32)
    vis = np.zeros((b, n), dtype=np.int32)
    off = np.zeros((b, n), dtype=np.int32)
    chars = np.zeros((b, pool), dtype=np.int32)
    for i, d in enumerate(docs):
        k = d.parent.shape[0]
        # the virtual root is index n (padded size); remap each doc's own
        # root (k) and hang padding rows off the root with huge keys so
        # they linearize to the very end (zero visible text)
        parent[i, :] = n
        parent[i, :k] = np.where(d.parent == k, n, d.parent)
        side[i, :k] = d.side
        kp[i, :k] = d.key_pos
        ka[i, :k] = d.key_agent
        ks[i, :k] = d.key_seq
        vis[i, :k] = d.vis_len
        off[i, :k] = d.char_off
        chars[i, :d.chars.shape[0]] = d.chars
    return parent, side, kp, ka, ks, vis, off, chars


def checkout_batch_device(docs: List[DeviceDoc], cap: Optional[int] = None,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> List[str]:
    """Batched device checkout: `fugue_linearize` over the padded batch,
    then one K3 call (K3's plain version on the CPU). `cap` defaults to
    the pow2 of the longest document. `device=None` means CUDA and raises
    without it."""
    device = resolve_device(device)
    parent, side, kp, ka, ks, vis, off, chars = (
        torch.from_numpy(a).to(device) for a in pad_docs(docs))
    if cap is None:
        cap = _pow2(max(max(d.total_len for d in docs), 1))
    perm = fugue_linearize(parent, side, kp, ka, ks)
    texts, totals = kernels.materialize_runs(perm, vis, off, chars, cap)
    texts = texts.cpu().numpy()
    totals = totals.cpu().numpy()
    return [texts[i, :totals[i]].tobytes().decode("utf-32-le")
            for i in range(len(docs))]


def checkout_device(oplog, doc: Optional[DeviceDoc] = None,
                    device: Optional[Union[str, torch.device]] = None) -> str:
    """Full checkout with device-side order resolution. Returns the text."""
    device = resolve_device(device)
    if doc is None:
        doc = prepare_doc(oplog)
    return checkout_batch_device([doc], device=device)[0]


def merge_device(oplog, from_frontier: Sequence[int],
                 merge_frontier: Optional[Sequence[int]] = None,
                 device: Optional[Union[str, torch.device]] = None):
    """Incremental device merge: the document and frontier a branch at
    `from_frontier` reaches after merging `merge_frontier` (default: the
    oplog tip). Returns (text, frontier) at version_union(from, merge)."""
    device = resolve_device(device)
    doc = prepare_doc(oplog, from_frontier, merge_frontier)
    return checkout_batch_device([doc], device=device)[0], doc.frontier
