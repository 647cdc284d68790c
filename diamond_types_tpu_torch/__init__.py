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
"""

from .causalgraph.agent import AgentAssignment
from .causalgraph.causal_graph import CausalGraph
from .causalgraph.graph import ROOT, DiffFlag, Graph
from .core.frontier import frontier_eq, frontier_from
from .text.branch import Branch
from .text.oplog import OpLog, oplog_from_columns

__version__ = "0.1.0"
