"""Build the C++ merge core for the port: g++ over native/dt_core.cpp and
native/dt_decode.cpp (dt_core.cpp calls dt_lz4_compress and dt_crc32c,
which dt_decode.cpp defines) into `diamond_types_tpu_torch/_build/`.

The library is named by a hash of both sources, the flags and this CPU's
instruction-set flags (`-march=native` ties the binary to them), so an
edited source or another machine never loads a stale build. Several
processes may build at once (test workers): one builds under a file lock,
into a temp file finished with `os.replace`, and the rest wait and load
it. A failed build raises.

`build_ingest` builds the local-ingest CPython extension
(`native/dt_ingest.cpp`, against this interpreter's headers) the same way,
named by a hash that also covers the interpreter's extension suffix. A
failed ingest build returns None ("no library"): `native/ingest.py` then
keeps the per-op Python path.

    python -m diamond_types_tpu_torch.native.build
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import subprocess
import sys
import sysconfig
import time
from pathlib import Path
from typing import Optional, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
REPO = PKG_DIR.parent
SOURCES = (REPO / "native" / "dt_core.cpp", REPO / "native" / "dt_decode.cpp")
SOURCE_INGEST = REPO / "native" / "dt_ingest.cpp"
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


def _gxx_build(sources, out: Path, lock_name: str,
               extra_flags=()) -> float:
    """Compile `sources` with g++ into `out` unless it exists, under the
    file lock `lock_name` in BUILD_DIR, through a temp file finished with
    `os.replace`. Returns the build seconds (0.0 when it was already
    built); a missing g++ or a compile error raises RuntimeError."""
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(BUILD_DIR / lock_name, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():               # another process built it meanwhile
            return 0.0
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, *extra_flags, *map(str, sources), "-o",
               str(tmp)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"native build needs g++: {e}") from e
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build of {out.name} failed (rc "
                               f"{r.returncode}):\n{r.stderr[-4000:]}")
        os.replace(tmp, out)
    return time.perf_counter() - t0


def build() -> Tuple[Path, float]:
    """Build the library unless it exists. Returns (path, build seconds,
    0.0 when it was already built)."""
    lib = library_path()
    return lib, _gxx_build(SOURCES, lib, "libdt_core.lock")


def ingest_path() -> Path:
    """Where the ingest extension lives once built. A CPython extension
    built for another interpreter must never load, so the interpreter's
    extension suffix is both hashed and kept as the file's suffix."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    h = hashlib.sha256(SOURCE_INGEST.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(suffix.encode())
    h.update(_cpu_tag())
    return BUILD_DIR / f"_dtingest-{h.hexdigest()[:16]}{suffix}"


def build_ingest() -> Optional[str]:
    """Build the local-ingest extension unless it exists: its path, or
    None when it cannot be built here (no source, no g++, a compile
    error; the reason goes to stderr)."""
    if not SOURCE_INGEST.exists():
        return None
    out = ingest_path()
    try:
        _gxx_build((SOURCE_INGEST,), out, "dtingest.lock",
                   (f"-I{sysconfig.get_paths()['include']}",))
    except RuntimeError as e:
        sys.stderr.write(f"ingest ext build failed: {e}\n")
        return None
    return str(out)


if __name__ == "__main__":
    path, secs = build()
    print(f"{path} ({secs:.1f} s)")
    ingest = build_ingest()
    print(ingest or "INGEST BUILD FAILED")
    sys.exit(0 if ingest else 1)
