"""Build the C++ merge core for the port: g++ over native/dt_core.cpp and
native/dt_decode.cpp (dt_core.cpp calls dt_lz4_compress and dt_crc32c,
which dt_decode.cpp defines) into `diamond_types_tpu_torch/_build/`.

The library is named by a hash of both sources, the flags and this CPU's
instruction-set flags (`-march=native` ties the binary to them), so an
edited source or another machine never loads a stale build. Several
processes may build at once (test workers): one builds under a file lock,
into a temp file finished with `os.replace`, and the rest wait and load
it. A failed build raises.

    python -m diamond_types_tpu_torch.native.build
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import subprocess
import time
from pathlib import Path
from typing import Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
REPO = PKG_DIR.parent
SOURCES = (REPO / "native" / "dt_core.cpp", REPO / "native" / "dt_decode.cpp")
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-fno-semantic-interposition",
             "-std=c++17", "-shared", "-fPIC", "-DNDEBUG")


def _cpu_tag() -> bytes:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.encode()
    except OSError:
        pass
    return platform.machine().encode()


def library_path() -> Path:
    """Where the native library lives once built."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_tag())
    return BUILD_DIR / f"libdt_core-{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, float]:
    """Build the library unless it exists. Returns (path, build seconds,
    0.0 when it was already built)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(BUILD_DIR / "libdt_core.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():               # another process built it meanwhile
            return lib, 0.0
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"native build needs g++: {e}") from e
        if r.returncode != 0:
            raise RuntimeError(f"native build failed (rc {r.returncode}):\n"
                               f"{r.stderr[-4000:]}")
        os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


if __name__ == "__main__":
    path, secs = build()
    print(f"{path} ({secs:.1f} s)")
