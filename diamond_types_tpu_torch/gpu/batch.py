"""Batched multi-document op application (PyTorch).

Port of the JAX package's batched replay (`tpu/batch.py`): N replicas apply
their op streams together, a loop over op index with the document batch
written out as the leading axis.

Document state is a fixed-capacity int32 char-code buffer + length. One op
step (pos, del_len, ins_len, ins_chars) rebuilds the buffer:

    out(i) = doc(i)                for i <  pos
           = ins_chars(i - pos)    for pos <= i < pos + ins
           = doc(i - ins + del)    for i >= pos + ins     (tail shift, a roll)

The JAX version selects among the 2*max_ins+1 static rolls of the buffer
because per-lane gathers are slow on a TPU; on a GPU a direct gather of the
rolled index is the same function and one pass. The bounded-shift contract
is kept exactly: a shift outside [-max_ins, max_ins] leaves the buffer
unshifted (no static roll matches it), and only the first max_ins insert
lanes are written.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from . import resolve_device


def encode_trace_ops(txns, max_ins: int):
    """Flatten a TestData-style patch list into dense op arrays, splitting
    long inserts into <= max_ins chunks. Returns (pos, dlen, ilen, chars)."""
    pos, dl, il, chars = [], [], [], []
    for txn in txns:
        for (p, d, ins) in txn:
            while d:  # split deletes to <= max_ins (bounded-shift contract)
                k = min(d, max_ins)
                pos.append(p)
                dl.append(k)
                il.append(0)
                chars.append([0] * max_ins)
                d -= k
            off = 0
            while off < len(ins):
                chunk = ins[off:off + max_ins]
                pos.append(p + off)
                dl.append(0)
                il.append(len(chunk))
                chars.append([ord(c) for c in chunk]
                             + [0] * (max_ins - len(chunk)))
                off += len(chunk)
    return (np.asarray(pos, np.int32), np.asarray(dl, np.int32),
            np.asarray(il, np.int32),
            np.asarray(chars, np.int32).reshape(-1, max_ins))


def _apply_ops_batched(docs: torch.Tensor, lens: torch.Tensor,
                       pos: torch.Tensor, dlen: torch.Tensor,
                       ilen: torch.Tensor, ins_chars: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One op per document, whole batch at once: docs [b, cap], pos/dlen/
    ilen [b], ins_chars [b, max_ins], all int32. Requires dlen <= max_ins
    and ilen <= max_ins (see module docstring)."""
    cap = docs.shape[1]
    mi = ins_chars.shape[1]
    idx = torch.arange(cap, dtype=torch.int32, device=docs.device)
    shift = ilen - dlen
    in_range = (shift >= -mi) & (shift <= mi)
    roll = torch.where(in_range, shift, 0)
    src = torch.remainder(idx[None, :] - roll[:, None], cap)
    out = torch.gather(docs, 1, src.long())
    rel = idx[None, :] - pos[:, None]
    lane = (rel >= 0) & (rel < ilen[:, None]) & (rel < mi)
    ins = torch.gather(ins_chars, 1, rel.clamp(0, mi - 1).long())
    out = torch.where(lane, ins, out)
    out = torch.where(idx[None, :] < pos[:, None], docs, out)
    return out, lens + shift


def apply_op_step(doc: torch.Tensor, doc_len: torch.Tensor,
                  pos: torch.Tensor, dlen: torch.Tensor,
                  ilen: torch.Tensor, ins_chars: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-document variant of _apply_ops_batched (same contract)."""
    docs, lens = _apply_ops_batched(
        doc[None], doc_len[None], pos[None], dlen[None], ilen[None],
        ins_chars[None])
    return docs[0], lens[0]


def replay_batch(pos, dlen, ilen, chars, cap: int,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replay [b, n] op streams into [b, cap] documents on `device`.

    pos/dlen/ilen: int32 [b, n]; chars: int32 [b, n, max_ins] (numpy
    arrays or tensors). CONTRACT: dlen and ilen must be <= max_ins; split
    longer ops the way encode_trace_ops does. Out-of-range ops are zeroed
    to no-ops and, as in the JAX version, poison EVERY length in the batch
    to -1. Returns (docs [b, cap], lens [b])."""
    dev = resolve_device(device)
    pos, dlen, ilen, chars = (torch.as_tensor(x, dtype=torch.int32,
                                              device=dev)
                              for x in (pos, dlen, ilen, chars))
    b, n = pos.shape
    mi = chars.shape[-1]
    bad = (dlen > mi) | (ilen > mi)
    dlen = torch.where(bad, 0, dlen)
    ilen = torch.where(bad, 0, ilen)
    docs = torch.zeros((b, cap), dtype=torch.int32, device=dev)
    lens = torch.zeros((b,), dtype=torch.int32, device=dev)
    for k in range(n):
        docs, lens = _apply_ops_batched(docs, lens, pos[:, k], dlen[:, k],
                                        ilen[:, k], chars[:, k])
    return docs, torch.where(bad.any(), -1, lens)


def docs_to_strings(docs, lens) -> List[str]:
    docs = docs.cpu().numpy() if isinstance(docs, torch.Tensor) else docs
    lens = lens.cpu().numpy() if isinstance(lens, torch.Tensor) else lens
    return ["".join(chr(c) for c in row[:n]) for row, n in
            zip(np.asarray(docs), np.asarray(lens))]
