"""Hand-written Hopper kernels: build, load, wrappers and plain versions.

K1, `apply_ops_window`, replays a whole flush window (`[b, n]` op tape over
`[b, cap]` document rows) in one launch of `csrc/apply_ops.cu`. It is the
port of the JAX package's Pallas kernel `tpu/pallas_kernels.py::
apply_op_block`, which applies one op per row and is launched n times per
window inside a scan (`tpu/flush_fuse.py::make_pallas_replay_body`); the
source's header says how it is laid out and what bounds it.

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

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# kernel name -> its source in csrc/
SOURCES = {"apply_ops": "apply_ops.cu"}
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
                                            i, i, i, i, i, p]
        lib.dt_apply_ops_window.restype = i
        lib.dt_apply_ops_window_smem_bytes.argtypes = [i, i, i]
        lib.dt_apply_ops_window_smem_bytes.restype = i


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.dt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


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
    if docs.device.type == "cpu":
        return apply_ops_window_plain(docs, lens, pos, dlen, ilen, chars,
                                      max_ins)
    if docs.device.type != "cuda":
        raise ValueError(f"unsupported device {docs.device}")
    for name, t in (("docs", docs), ("lens", lens), ("pos", pos),
                    ("dlen", dlen), ("ilen", ilen), ("chars", chars)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, cap = docs.shape
    n = pos.shape[1]
    out_docs = torch.empty_like(docs)
    out_lens = torch.empty_like(lens)
    if b == 0:
        return out_docs, out_lens
    lib = _lib("apply_ops")
    in_smem = int(lib.dt_apply_ops_window_smem_bytes(cap, max_ins, 1)
                  <= MAX_SMEM_BYTES)
    with torch.cuda.device(docs.device):
        stream = torch.cuda.current_stream(docs.device).cuda_stream
        rc = lib.dt_apply_ops_window(
            docs.data_ptr(), lens.data_ptr(), pos.data_ptr(),
            dlen.data_ptr(), ilen.data_ptr(), chars.data_ptr(),
            out_docs.data_ptr(), out_lens.data_ptr(), b, n, cap, max_ins,
            in_smem, stream)
    _raise_on(lib, rc, "apply_ops_window launch")
    apply_ops_window.launches += 1
    return out_docs, out_lens


apply_ops_window.launches = 0
