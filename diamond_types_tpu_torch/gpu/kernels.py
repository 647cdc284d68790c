"""Hand-written Hopper kernels: build, load, wrappers and plain versions.

Each is the port of one Pallas kernel of the JAX package's
`tpu/pallas_kernels.py`; each source's header says how it is laid out and
what bounds it.

  K1 `apply_ops_window` (`csrc/apply_ops.cu`, from `apply_op_block`):
     replays a whole flush window (`[b, n]` op tape over `[b, cap]` document
     rows) in one launch, as a gather: each output element's source is
     found by walking the tape backwards, over a grid of rows times tiles
     of the cap axis; the TPU kernel applies one op per row and is
     launched n times per window inside a scan. `replay_batch_kernel` (from
     `replay_batch_pallas`, that scan from empty rows) is one K1 launch
     from zero rows.
  K2 `xform_positions` (`csrc/xform_positions.cu`, from
     `xform_positions_pallas`): the device transform's position scans over
     a bucket's doc-order columns `[b, n]`, one launch per bucket, one warp
     per row.
  K3 `materialize_runs` (`csrc/materialize.cu`, from `materialize_pallas`):
     the text assembly of the device checkout (a batch of documents) and
     of the history path (a batch of versions sharing one order and
     arena), any run count. One call is two kernels on one stream: a row
     scan (one CTA per row) into a scratch table of run starts, then a
     gather over rows times tiles of the cap axis.
  X8 `zone_tape_run` (`csrc/zone_tape.cu`, from the XLA scan of
     `tpu/zone_kernel.py::make_zone_step`, which has no `pallas_call`): the
     zone engine's whole step tape for B replicas in one launch, a
     thread-block cluster per replica stepping the tape, the carry held in
     the cluster's shared memory where it fits (`cluster_size` picks the
     cluster and the form) and updated in place.

Build: each `csrc/*.cu` compiles with `nvcc` for `sm_90a` into a shared
library with a plain C interface, at first use, into `_build/` beside this
package's sources, named by a hash of the source and flags so an edited
source never loads a stale library. Libraries load with ctypes and launch
on PyTorch's current stream. Nothing is built or loaded at import.

Every wrapper launches its kernel for CUDA tensors and runs the kernel's
plain PyTorch version only for CPU tensors. It never falls back: a failed
build or launch raises. `<wrapper>.launches` counts the wrapper's calls
that launched on the card: one per call, however many kernels the call
launches (K3's two). It is counted under a lock, so it stays exact when
several threads launch (the serve layer's flush workers).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import torch

from .batch import _apply_ops_batched
from .linearize import materialize

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# kernel name -> its source in csrc/
SOURCES = {"apply_ops": "apply_ops.cu",
           "xform_positions": "xform_positions.cu",
           "materialize": "materialize.cu",
           "zone_tape": "zone_tape.cu"}
_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()
_launches_lock = threading.Lock()


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        exe = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return exe


def library_path(name: str) -> Path:
    """Where kernel `name`'s library lives once built: keyed by a hash of
    its source and the compiler flags."""
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet,
    one `nvcc` per source, all started together. Returns, per kernel, its
    library path, build seconds (0.0 when it was already built) and the
    compiler's output (ptxas register and shared-memory report)."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = {"path": str(lib), "seconds": 0.0, "log": ""}
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                               f"(rc {proc.returncode}):\n{log}")
        os.replace(tmp, lib)
        out[name] = {"path": str(lib),
                     "seconds": time.perf_counter() - t0, "log": log}
    return out


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _libs_lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _bind(name, lib)
            _libs[name] = lib
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dt_cuda_error_string.argtypes = [i]
    lib.dt_cuda_error_string.restype = ctypes.c_char_p
    if name == "apply_ops":
        lib.dt_apply_ops_window.argtypes = [p, p, p, p, p, p, p, p,
                                            i, i, i, i, p]
        lib.dt_apply_ops_window.restype = i
        lib.dt_apply_ops_window_ctas.argtypes = [i, i]
        lib.dt_apply_ops_window_ctas.restype = ctypes.c_longlong
    elif name == "xform_positions":
        lib.dt_xform_positions.argtypes = [p, p, p, p, p, i, i, p]
        lib.dt_xform_positions.restype = i
    elif name == "materialize":
        ll = ctypes.c_longlong
        lib.dt_materialize_runs.argtypes = [p, p, p, p, p, p, p,
                                            i, i, i, i, ll, ll, ll, p]
        lib.dt_materialize_runs.restype = i
        for fn in (lib.dt_materialize_runs_ctas,
                   lib.dt_materialize_runs_scratch_row):
            fn.argtypes = [i, i]
            fn.restype = ctypes.c_longlong
    elif name == "zone_tape":
        lib.dt_zone_tape_run.argtypes = [p] * 33 + [i] * 10 + [p]
        lib.dt_zone_tape_run.restype = i
        lib.dt_zone_tape_smem_bytes.argtypes = [i, i, i]
        lib.dt_zone_tape_smem_bytes.restype = ctypes.c_longlong
        lib.dt_zone_tape_smem_budget.argtypes = []
        lib.dt_zone_tape_smem_budget.restype = ctypes.c_longlong


# The current CUDA device and a device's current raw stream, through the
# bindings PyTorch's own generated code uses where this build has them
# (one C call each), else through the public API.
_current_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _launch_on(device: torch.device, fn, *args) -> int:
    """Call the C launcher `fn(*args, stream)` on `device`'s current
    stream, switching the current device only when it is another one."""
    cur = (_current_device or torch.cuda.current_device)()
    idx = cur if device.index is None else device.index
    get_stream = _raw_stream or (
        lambda d: torch.cuda.current_stream(d).cuda_stream)
    if idx == cur:
        return fn(*args, get_stream(idx))
    with torch.cuda.device(idx):
        return fn(*args, get_stream(idx))


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.dt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def count_launch(name: str) -> None:
    """Add one to the launch count of this module's wrapper `name`. It is
    looked up by name, so a stand-in that replaces the wrapper (and
    forwards `launches`) keeps the count on the real one."""
    with _launches_lock:
        globals()[name].launches += 1


def _check_int32(device: torch.device, **ts: torch.Tensor) -> None:
    for name, t in ts.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def _launch_device(device: torch.device, **ts: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel; they must be contiguous),
    False for CPU tensors (run the plain version); raises otherwise."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for name, t in ts.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return True


# ---------------------------------------------------------------------------
# K1: one flush window's op tape over a batch of document rows
# ---------------------------------------------------------------------------

def apply_ops_window_plain(docs: torch.Tensor, lens: torch.Tensor,
                           pos: torch.Tensor, dlen: torch.Tensor,
                           ilen: torch.Tensor, chars: torch.Tensor,
                           max_ins: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's plain version: the window as a Python loop of per-op steps
    (`batch._apply_ops_batched`), int32 throughout. It is the function of
    the JAX package's `make_pallas_replay_body` and `make_replay_body`,
    which agree once every op is within contract.

    Ops out of contract (dlen or ilen > max_ins; or a negative field,
    which the planner never emits) are zeroed to no-ops and their row's
    length comes back -1; a row that comes in at -1 with all-zero ops
    stays at -1."""
    bad = (dlen > max_ins) | (ilen > max_ins) | (dlen < 0) | (ilen < 0) \
        | (pos < 0)
    dlen = torch.where(bad, 0, dlen)
    ilen = torch.where(bad, 0, ilen)
    bad_doc = bad.any(dim=1)
    for k in range(pos.shape[1]):
        docs, lens = _apply_ops_batched(docs, lens, pos[:, k], dlen[:, k],
                                        ilen[:, k], chars[:, k])
    return docs, torch.where(bad_doc, -1, lens)


def _check_window(docs, lens, pos, dlen, ilen, chars, max_ins) -> None:
    if docs.dim() != 2:
        raise ValueError(f"docs must be [b, cap], got {tuple(docs.shape)}")
    b, cap = docs.shape
    if pos.dim() != 2 or pos.shape[0] != b:
        raise ValueError(f"pos must be [b={b}, n], got {tuple(pos.shape)}")
    n = pos.shape[1]
    want = {"lens": (b,), "pos": (b, n), "dlen": (b, n), "ilen": (b, n),
            "chars": (b, n, max_ins)}
    ts = {"docs": docs, "lens": lens, "pos": pos, "dlen": dlen,
          "ilen": ilen, "chars": chars}
    for name, shape in want.items():
        if tuple(ts[name].shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(ts[name].shape)}")
    for name, t in ts.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != docs.device:
            raise ValueError(f"{name} is on {t.device}, docs on "
                             f"{docs.device}")
    if not 1 <= max_ins <= cap:
        raise ValueError(f"max_ins must lie in [1, cap={cap}], "
                         f"got {max_ins}")


def apply_ops_window(docs: torch.Tensor, lens: torch.Tensor,
                     pos: torch.Tensor, dlen: torch.Tensor,
                     ilen: torch.Tensor, chars: torch.Tensor,
                     max_ins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replay one window: docs [b, cap], lens [b], pos/dlen/ilen [b, n],
    chars [b, n, max_ins], all int32 on one device. Returns fresh
    (out_docs, out_lens); the inputs are never written, so a row that
    fails the caller's length fence keeps its pre-window state.

    CUDA tensors launch K1 once; CPU tensors run `apply_ops_window_plain`."""
    _check_window(docs, lens, pos, dlen, ilen, chars, max_ins)
    if not _launch_device(docs.device, docs=docs, lens=lens, pos=pos,
                          dlen=dlen, ilen=ilen, chars=chars):
        return apply_ops_window_plain(docs, lens, pos, dlen, ilen, chars,
                                      max_ins)
    b, cap = docs.shape
    n = pos.shape[1]
    out_docs = torch.empty_like(docs)
    out_lens = torch.empty_like(lens)
    if b == 0:
        return out_docs, out_lens
    lib = _lib("apply_ops")
    # the kernel indexes a row's chars tape, and its grid, in int32
    if n * max_ins >= 1 << 31 or \
            lib.dt_apply_ops_window_ctas(b, cap) >= 1 << 31:
        raise ValueError(f"window too large for one launch: b={b}, "
                         f"n={n}, cap={cap}, max_ins={max_ins}")
    rc = _launch_on(docs.device, lib.dt_apply_ops_window,
                    docs.data_ptr(), lens.data_ptr(), pos.data_ptr(),
                    dlen.data_ptr(), ilen.data_ptr(), chars.data_ptr(),
                    out_docs.data_ptr(), out_lens.data_ptr(), b, n, cap,
                    max_ins)
    _raise_on(lib, rc, "apply_ops_window launch")
    count_launch("apply_ops_window")
    return out_docs, out_lens


apply_ops_window.launches = 0


def _empty_rows(pos: torch.Tensor, chars: torch.Tensor,
                cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero [b, cap] rows and zero lengths on pos's device, for a replay
    from empty documents."""
    if chars.dim() != 3:
        raise ValueError(f"chars must be [b, n, max_ins], got "
                         f"{tuple(chars.shape)}")
    b = pos.shape[0]
    return (torch.zeros((b, cap), dtype=torch.int32, device=pos.device),
            torch.zeros(b, dtype=torch.int32, device=pos.device))


def replay_batch_plain(pos: torch.Tensor, dlen: torch.Tensor,
                       ilen: torch.Tensor, chars: torch.Tensor,
                       cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`replay_batch_kernel`'s plain version: K1's plain version over the
    whole op sequence from zero rows and zero lengths."""
    docs, lens = _empty_rows(pos, chars, cap)
    return apply_ops_window_plain(docs, lens, pos, dlen, ilen, chars,
                                  chars.shape[2])


def replay_batch_kernel(pos: torch.Tensor, dlen: torch.Tensor,
                        ilen: torch.Tensor, chars: torch.Tensor,
                        cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replay [b, n] op sequences (pos/dlen/ilen [b, n], chars [b, n,
    max_ins], int32 on one device) into empty [b, cap] rows: (docs [b,
    cap], lens [b]), int32. The counterpart of the JAX package's
    `replay_batch_pallas` (a scan of one Pallas step per op): ONE K1 launch
    over the whole sequence with max_ins = chars.shape[2]. K1's contract
    holds: a row with an op out of contract (dlen or ilen > max_ins, a
    negative field) comes back with length -1.

    CUDA tensors launch K1 once, counted by `apply_ops_window.launches`;
    CPU tensors run the plain version."""
    docs, lens = _empty_rows(pos, chars, cap)
    return apply_ops_window(docs, lens, pos, dlen, ilen, chars,
                            chars.shape[2])


# ---------------------------------------------------------------------------
# K2: the device transform's position scans over a bucket
# ---------------------------------------------------------------------------

def xform_positions_plain(nv: torch.Tensor, ov: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """K2's plain version over doc-order columns nv, ov [b, n] int32:
    (pos [b, n] = exclusive prefix sum of nv, new_len [b] = sum of nv,
    peak [b] = max(0, max prefix sum of nv - ov)), int32 throughout."""
    b, n = nv.shape
    if n == 0:
        z = torch.zeros(b, dtype=torch.int32, device=nv.device)
        return torch.zeros_like(nv), z, z.clone()
    cum = torch.cumsum(nv, dim=1, dtype=torch.int32)
    delta = torch.cumsum(nv - ov, dim=1, dtype=torch.int32)
    return cum - nv, cum[:, -1], delta.max(dim=1).values.clamp(min=0)


def xform_positions(nv: torch.Tensor, ov: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pos [b, n], new_len [b], peak [b]) for doc-order columns nv, ov
    [b, n] int32 on one device. CUDA tensors launch K2 once; CPU tensors
    run `xform_positions_plain`."""
    if nv.dim() != 2 or nv.shape != ov.shape:
        raise ValueError(f"nv and ov must be one [b, n] shape, got "
                         f"{tuple(nv.shape)} and {tuple(ov.shape)}")
    _check_int32(nv.device, nv=nv, ov=ov)
    if not _launch_device(nv.device, nv=nv, ov=ov):
        return xform_positions_plain(nv, ov)
    b, n = nv.shape
    pos = torch.empty_like(nv)
    new_len = torch.empty(b, dtype=torch.int32, device=nv.device)
    peak = torch.empty_like(new_len)
    if b == 0:
        return pos, new_len, peak
    lib = _lib("xform_positions")
    rc = _launch_on(nv.device, lib.dt_xform_positions, nv.data_ptr(),
                    ov.data_ptr(), pos.data_ptr(), new_len.data_ptr(),
                    peak.data_ptr(), b, n)
    _raise_on(lib, rc, "xform_positions launch")
    count_launch("xform_positions")
    return pos, new_len, peak


xform_positions.launches = 0


# ---------------------------------------------------------------------------
# K3: the device checkout's text assembly over a batch of documents
# ---------------------------------------------------------------------------

def materialize_runs(perm: torch.Tensor, vis_len: torch.Tensor,
                     arena_off: torch.Tensor, arena: torch.Tensor,
                     cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lay each row's runs out in perm order: vis_len [b, n] int32; perm
    and arena_off [b, n] or [1, n] int32, arena [b, pool] or [1, pool]
    int32 (pool >= 1), where one row is shared by all b documents (the
    history path's versions share all three); cap >= 1. Returns (text
    [b, cap] int32, total [b] int32, not clipped at cap).

    CUDA tensors launch K3: two kernels on the current stream, a row scan
    into a scratch table of run starts and bases (allocated here), then a
    gather over rows times tiles of cap, with no host sync between them; a
    shared row is passed with row stride 0, never copied. `launches`
    counts the call once. The kernels equal the plain version wherever
    arena_off[perm[i]] - start[i] < 2**30, which every in-contract input
    meets. CPU tensors run its plain version, `linearize.materialize`. In
    contract vis_len >= 0 and each perm row is a permutation of
    range(n)."""
    if vis_len.dim() != 2 or any(
            t.dim() != 2 or t.shape[1] != vis_len.shape[1]
            or t.shape[0] not in (1, vis_len.shape[0])
            for t in (perm, arena_off)):
        raise ValueError("perm, vis_len and arena_off must be one [b, n] "
                         "shape (perm and arena_off may be one shared "
                         f"[1, n] row), got {tuple(perm.shape)}, "
                         f"{tuple(vis_len.shape)}, {tuple(arena_off.shape)}")
    b, n = vis_len.shape
    if arena.dim() != 2 or arena.shape[0] not in (1, b) or \
            arena.shape[1] < 1:
        raise ValueError(f"arena must be [b={b}, pool>=1] or [1, pool], got "
                         f"{tuple(arena.shape)}")
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    ts = {"perm": perm, "vis_len": vis_len, "arena_off": arena_off,
          "arena": arena}
    _check_int32(perm.device, **ts)
    if not _launch_device(perm.device, **ts):
        return materialize(perm, vis_len, arena_off, arena, cap)
    out = torch.empty((b, cap), dtype=torch.int32, device=perm.device)
    total = torch.empty(b, dtype=torch.int32, device=perm.device)
    if b == 0:
        return out, total
    lib = _lib("materialize")
    # the gather's grid is int32
    if lib.dt_materialize_runs_ctas(b, cap) >= 1 << 31:
        raise ValueError(f"checkout too large for one launch: b={b}, "
                         f"cap={cap}")
    # per row: (start, base) of every run, the run of every 128-output
    # segment's first char
    table = torch.empty((b, lib.dt_materialize_runs_scratch_row(n, cap)),
                        dtype=torch.int32, device=perm.device)
    # a row stride per input: its row length, or 0 for one shared row
    strides = [t.shape[1] if t.shape[0] > 1 else 0
               for t in (perm, arena_off, arena)]
    rc = _launch_on(perm.device, lib.dt_materialize_runs,
                    perm.data_ptr(), vis_len.data_ptr(),
                    arena_off.data_ptr(), arena.data_ptr(), out.data_ptr(),
                    total.data_ptr(), table.data_ptr(), b, n,
                    arena.shape[1], cap, *strides)
    _raise_on(lib, rc, "materialize_runs launch")
    count_launch("materialize_runs")
    return out, total


materialize_runs.launches = 0


# ---------------------------------------------------------------------------
# X8: the zone engine's step tape over a batch of replicas
# ---------------------------------------------------------------------------

ZONE_CARRY_DTYPES = {"state": torch.uint8, "snap": torch.uint8,
                     "rank": torch.int32, "ord": torch.int32,
                     "ol_id": torch.int32, "orr_id": torch.int32,
                     "ever": torch.uint8, "m": torch.int32,
                     "agent_k": torch.int32, "seq_k": torch.int32}


def _check_zone(carry, xs: dict) -> tuple:
    """Shapes, dtypes and devices of a zone carry and tape; returns
    (B, n_idx, W, T, MB, MC, MD)."""
    from .zone_kernel import XS_KEYS
    state = carry.state
    if state.dim() != 3:
        raise ValueError(f"state must be [B, n_idx, W], got "
                         f"{tuple(state.shape)}")
    B, n_idx, W = state.shape
    dev = state.device
    for name, dt in ZONE_CARRY_DTYPES.items():
        t = getattr(carry, name)
        want = (B,) if name == "m" else (B, n_idx, W) if name == "state" \
            else (B, W)
        if tuple(t.shape) != want:
            raise ValueError(f"carry.{name} must be {list(want)}, got "
                             f"{list(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"carry.{name} must be {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"carry.{name} is on {t.device}, state on "
                             f"{dev}")
    missing = [k for k in XS_KEYS if k not in xs]
    if missing:
        raise ValueError(f"xs lacks {missing}")
    T = xs["op"].shape[0]
    MB, MC, MD = (xs["blk_cursor"].shape[1], xs["ch_slot"].shape[1],
                  xs["del_kind"].shape[1])
    for k in XS_KEYS:
        t = xs[k]
        want = (T,) if k in ("op", "a", "b", "snap") else \
            (T, MB) if k.startswith("blk_") else \
            (T, MC) if k.startswith("ch_") else (T, MD)
        if tuple(t.shape) != want:
            raise ValueError(f"xs[{k!r}] must be {list(want)}, got "
                             f"{list(t.shape)}")
    _check_int32(dev, **{f"xs[{k!r}]": xs[k] for k in XS_KEYS})
    if W < 1 or n_idx < 1:
        raise ValueError(f"W and n_idx must be >= 1, got {W}, {n_idx}")
    return B, n_idx, W, T, MB, MC, MD


CLUSTER_SIZES = (1, 2, 4, 8, 16)
SM_COUNT = 132                       # an H100 SXM's streaming multiprocessors
# the dynamic shared memory one block may take (232,448 bytes less 3,072
# for the kernel's static arrays); `csrc/zone_tape.cu` holds the same
ZONE_SMEM_BUDGET = 232448 - 3072
MIN_SLICE = 1024                     # slots a block keeps when c is raised


class ClusterPick(NamedTuple):
    """X8's launch shape: `c` blocks in a cluster per replica, the carry in
    shared memory (`smem`) or in global memory."""
    c: int
    smem: bool


def zone_smem_bytes(W: int, n_idx: int, c: int) -> int:
    """Shared memory a block of X8's shared-memory form takes for a
    cluster of c: (n_idx + 36) bytes a slot of its slice, S = ceil(W / c)
    padded to 16."""
    S = -(-W // c)
    return (36 + n_idx) * (-(-S // 16) * 16)


def cluster_size(B: int, W: int, n_idx: int) -> ClusterPick:
    """X8's cluster and form for B replicas of W slots and n_idx rows.

    The shared-memory form at the smallest c whose slice fits, unless the
    card would run its clusters in more than three times the waves that
    the global-memory form at c 1 (a replica per SM) takes: on one H100,
    at the history zone of `chip_smoke.py` (W 38,029, n_idx 6), a replica
    took 8-10 ms at c 8-16 in shared memory and 31 ms at c 1 in global
    memory, and at B 132 and 1,024 c 1 global beat c 8 shared 2x (42.6
    against 87.8 ms, 332 against 671 ms). Where no c fits, the global
    form. Then c is doubled while the card holds every block at once
    (B * c <= 132) and each block keeps >= 1,024 slots."""
    fits = [c for c in CLUSTER_SIZES
            if zone_smem_bytes(W, n_idx, c) <= ZONE_SMEM_BUDGET]
    smem = bool(fits)
    c = fits[0] if fits else 1
    if smem and c > 1 and -(-B * c // SM_COUNT) > 3 * -(-B // SM_COUNT):
        c, smem = 1, False
    while c < CLUSTER_SIZES[-1] and B * 2 * c <= SM_COUNT and \
            -(-W // (2 * c)) >= MIN_SLICE:
        c *= 2
    return ClusterPick(c, smem)


def _zone_pick(B: int, W: int, n_idx: int, cluster) -> ClusterPick:
    if cluster is None:
        return cluster_size(B, W, n_idx)
    c, smem = cluster
    pick = ClusterPick(int(c), bool(smem))
    if pick.c not in CLUSTER_SIZES:
        raise ValueError(f"cluster size must be one of {CLUSTER_SIZES}, "
                         f"got {pick.c}")
    if pick.smem and zone_smem_bytes(W, n_idx, pick.c) > ZONE_SMEM_BUDGET:
        raise ValueError(
            f"a slice of W={W}, n_idx={n_idx} at cluster {pick.c} does not "
            f"fit shared memory: {zone_smem_bytes(W, n_idx, pick.c)} > "
            f"{ZONE_SMEM_BUDGET} bytes a block")
    return pick


def zone_tape_run(carry, xs: dict, plen: int, cluster=None):
    """Run every step of the tape `xs` (the zone tape's columns, `[T]`,
    `[T, MB]`, `[T, MC]`, `[T, MD]` int32; `gpu/zone_kernel.tape_xs`) on
    the batched zone carry (`gpu/zone_kernel.ZoneCarry`), updating the
    carry IN PLACE; returns it. `plen` is the prefix length (what OP_BEGIN
    sets). `cluster`, a (c, smem) pair, forces the launch shape; by default
    `cluster_size(B, W, n_idx)` picks it. A forced shared-memory form whose
    slice does not fit raises.

    CUDA tensors launch the kernel once: a cluster of c blocks per replica,
    stepping the whole tape (MB <= 32: the launcher refuses more). A launch
    the card refuses (an attribute, or a cluster it cannot hold) raises;
    nothing retries at another shape. CPU tensors run the plain version
    `zone_kernel.run_zone_plain` and copy its result into the carry."""
    B, n_idx, W, T, MB, MC, MD = _check_zone(carry, xs)
    pick = _zone_pick(B, W, n_idx, cluster)
    ts = dict(carry._asdict(), **{f"xs_{k}": v for k, v in xs.items()})
    if not _launch_device(carry.state.device, **ts):
        from .zone_kernel import run_zone_plain
        out = run_zone_plain(carry, xs, plen)
        for dst, src in zip(carry, out):
            dst.copy_(src)
        return carry
    if B == 0 or T == 0:
        return carry
    if n_idx * W >= 1 << 31 or B * pick.c >= 1 << 31:
        raise ValueError(f"zone carry too large for one launch: B={B}, "
                         f"n_idx={n_idx}, W={W}, cluster {pick.c}")
    lib = _lib("zone_tape")
    dev = carry.state.device
    # the global form's scratch per replica: the visibility prefix sum, the
    # snapshot states in rank order, and the second buffers of the order and
    # of those states (the shared-memory form keeps them in shared memory)
    scratch = [0, 0, 0, 0]
    if not pick.smem:
        bufs = (torch.empty((B, W), dtype=torch.int32, device=dev),
                torch.empty((B, W), dtype=torch.uint8, device=dev),
                torch.empty((B, W), dtype=torch.int32, device=dev),
                torch.empty((B, W), dtype=torch.uint8, device=dev))
        scratch = [t.data_ptr() for t in bufs]
    from .zone_kernel import XS_KEYS
    ptrs = [xs[k].data_ptr() for k in XS_KEYS] + \
        [t.data_ptr() for t in carry] + scratch
    rc = _launch_on(dev, lib.dt_zone_tape_run, *ptrs, B, T, W, int(plen),
                    n_idx, MB, MC, MD, pick.c, int(pick.smem))
    _raise_on(lib, rc, f"zone_tape_run launch (cluster {pick.c}, "
              f"{'shared' if pick.smem else 'global'} memory)")
    count_launch("zone_tape_run")
    return carry


zone_tape_run.launches = 0
