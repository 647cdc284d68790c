"""diamond_types_tpu_torch — the PyTorch/CUDA port of diamond_types_tpu.

The same text CRDT (an append-only operation log over a causal DAG, branches
as (version, content) checkpoints, a merge engine that transforms concurrent
positional edits into a linear, replayable stream) with its device tier on
an NVIDIA Hopper GPU instead of a TPU.

Layout mirrors the JAX package module for module: `core/`, `causalgraph/`,
`text/`, `listmerge/` and `utils/` are the host layer (pure Python, the
merge oracle), `gpu/` is the counterpart of `tpu/`, and `csrc/` holds the
hand-written CUDA kernels that `gpu/kernels.py` builds and binds.

Device entry points default to CUDA and raise when no card is present;
pass `device="cpu"` to run their plain PyTorch versions on the CPU.

Public API, as the JAX package's root: `OpLog`, `Branch`, `ListCRDT`,
`merge_oplogs`, and `load` / `save` of the v1 (.dt) format, whose bytes
are the same in both packages.
"""

from .causalgraph.agent import AgentAssignment
from .causalgraph.causal_graph import CausalGraph
from .causalgraph.graph import ROOT, DiffFlag, Graph
from .core.frontier import frontier_eq, frontier_from
from .text.branch import Branch
from .text.crdt import ListCRDT, merge_oplogs
from .text.oplog import OpLog, oplog_from_columns

__version__ = "0.1.0"


def load(data: bytes) -> OpLog:
    """Load a v1-format (.dt) oplog."""
    from .encoding.decode import load_oplog
    return load_oplog(data)


def save(oplog: OpLog, patch_since=None) -> bytes:
    """Encode an oplog (full snapshot, or a patch since a version)."""
    from .encoding.encode import ENCODE_FULL, ENCODE_PATCH, encode_oplog
    if patch_since is None:
        return encode_oplog(oplog, ENCODE_FULL)
    return encode_oplog(oplog, ENCODE_PATCH, from_version=patch_since)


__all__ = [
    "Graph", "ROOT", "DiffFlag", "AgentAssignment", "CausalGraph",
    "OpLog", "Branch", "ListCRDT", "merge_oplogs", "load", "save",
]
