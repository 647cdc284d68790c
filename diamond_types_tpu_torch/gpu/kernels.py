"""Hand-written Hopper kernels: build, load, wrappers and plain versions.

Each is the port of one Pallas kernel of the JAX package's
`tpu/pallas_kernels.py`; each source's header says how it is laid out and
what bounds it.

  K1 `apply_ops_window` (`csrc/apply_ops.cu`, from `apply_op_block`):
     replays a whole flush window (`[b, n]` op tape over `[b, cap]` document
     rows) in one launch, as a gather: each output element's source is
     found by walking the tape backwards, over a grid of rows times tiles
     of the cap axis; the TPU kernel applies one op per row and is
     launched n times per window inside a scan.
  K2 `xform_positions` (`csrc/xform_positions.cu`, from
     `xform_positions_pallas`): the device transform's position scans over
     a bucket's doc-order columns `[b, n]`, one launch per bucket, one warp
     per row.
  K3 `materialize_runs` (`csrc/materialize.cu`, from `materialize_pallas`):
     the device checkout's text assembly for a batch of documents, one
     launch per batch, any run count.

Build: each `csrc/*.cu` compiles with `nvcc` for `sm_90a` into a shared
library with a plain C interface, at first use, into `_build/` beside this
package's sources, named by a hash of the source and flags so an edited
source never loads a stale library. Libraries load with ctypes and launch
on PyTorch's current stream. Nothing is built or loaded at import.

Every wrapper launches its kernel for CUDA tensors and runs the kernel's
plain PyTorch version only for CPU tensors. It never falls back: a failed
build or launch raises. `<wrapper>.launches` counts the kernel's launches.
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
from typing import Dict, Iterable, Optional, Tuple

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
           "materialize": "materialize.cu"}
# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448

_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()


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
        lib.dt_materialize_runs.argtypes = [p, p, p, p, p, p, p,
                                            i, i, i, i, i, p]
        lib.dt_materialize_runs.restype = i
        lib.dt_materialize_runs_smem_bytes.argtypes = [i]
        lib.dt_materialize_runs_smem_bytes.restype = i


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
    apply_ops_window.launches += 1
    return out_docs, out_lens


apply_ops_window.launches = 0


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
    xform_positions.launches += 1
    return pos, new_len, peak


xform_positions.launches = 0


# ---------------------------------------------------------------------------
# K3: the device checkout's text assembly over a batch of documents
# ---------------------------------------------------------------------------

def materialize_runs(perm: torch.Tensor, vis_len: torch.Tensor,
                     arena_off: torch.Tensor, arena: torch.Tensor,
                     cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lay each row's runs out in perm order: perm, vis_len, arena_off
    [b, n] int32, arena [b, pool] int32 (pool >= 1), cap >= 1. Returns
    (text [b, cap] int32, total [b] int32, not clipped at cap).

    CUDA tensors launch K3 once; CPU tensors run its plain version,
    `linearize.materialize`. In contract vis_len >= 0 and each perm row
    is a permutation of range(n)."""
    if perm.dim() != 2 or not perm.shape == vis_len.shape == arena_off.shape:
        raise ValueError("perm, vis_len and arena_off must be one [b, n] "
                         f"shape, got {tuple(perm.shape)}, "
                         f"{tuple(vis_len.shape)}, {tuple(arena_off.shape)}")
    b, n = perm.shape
    if arena.dim() != 2 or arena.shape[0] != b or arena.shape[1] < 1:
        raise ValueError(f"arena must be [b={b}, pool>=1], got "
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
    # the static warp-total buffer shares the block's shared memory
    in_smem = lib.dt_materialize_runs_smem_bytes(n) <= MAX_SMEM_BYTES - 1024
    scratch = (None if in_smem else
               torch.empty((b, n + 1), dtype=torch.int32, device=perm.device))
    rc = _launch_on(perm.device, lib.dt_materialize_runs,
                    perm.data_ptr(), vis_len.data_ptr(),
                    arena_off.data_ptr(), arena.data_ptr(), out.data_ptr(),
                    total.data_ptr(),
                    0 if scratch is None else scratch.data_ptr(), b, n,
                    arena.shape[1], cap, int(in_smem))
    _raise_on(lib, rc, "materialize_runs launch")
    materialize_runs.launches += 1
    return out, total


materialize_runs.launches = 0
