"""Dump an oplog's columnar merge state to the binary format consumed by
native/bench_main.cpp (standalone gprof/perf harness for the C++ engine).

Usage: python -m diamond_types_tpu_torch.tools.dump_columns IN.dt OUT.bin
"""

from __future__ import annotations

import struct
import sys

import numpy as np

# 'DTCOL' + format version; bump when columns change (bench_main.cpp
# checks the same constant)
DUMP_MAGIC = 0x4454434F4C_02


def dump(oplog, path: str) -> None:
    g = oplog.cg.graph
    starts, ends, shadows, indptr, flat = g.as_arrays()
    if flat.size == 0:
        flat = np.zeros(1, dtype=np.int64)
    gr = oplog.cg.agent_assignment.global_runs
    runs = oplog.ops.runs
    with open(path, "wb") as f:
        # magic+version header (checked by bench_main.cpp): a stale dump
        # fed to a newer harness must fail with an actionable message,
        # not a mid-file EOF
        f.write(struct.pack("<q", DUMP_MAGIC))
        names = oplog.cg.agent_assignment.agent_names
        f.write(struct.pack("<q", len(names)))
        for name in names:
            b = name.encode("utf8")
            f.write(struct.pack("<q", len(b)))
            f.write(b)

        def vec(a, dtype):
            a = np.ascontiguousarray(np.asarray(a, dtype=dtype))
            f.write(struct.pack("<q", a.size))
            f.write(a.tobytes())

        vec(starts, np.int64)
        vec(ends, np.int64)
        vec(shadows, np.int64)
        vec(indptr, np.int64)
        vec(flat, np.int64)
        vec([r[0] for r in gr], np.int64)
        vec([r[1] for r in gr], np.int64)
        vec([r[2] for r in gr], np.int64)
        vec([r[3] for r in gr], np.int64)
        vec([r.lv for r in runs], np.int64)
        vec([r.kind for r in runs], np.uint8)
        vec([1 if r.fwd else 0 for r in runs], np.uint8)
        vec([r.start for r in runs], np.int64)
        vec([r.end for r in runs], np.int64)
        # content columns (same layout NativeContext.sync feeds
        # dt_load_ops/dt_load_ins_arena — one shared builder) so the
        # harness can also drive dt_merge_into_doc's assembly path
        from ..native.core import content_columns
        cp, arena, _ = content_columns(oplog)
        vec(cp, np.int64)
        vec(arena, np.int32)
        vec(sorted(oplog.cg.version), np.int64)


def main() -> None:
    from ..encoding.decode import load_oplog
    with open(sys.argv[1], "rb") as f:
        ol = load_oplog(f.read())
    dump(ol, sys.argv[2])
    print(f"dumped {len(ol)} ops -> {sys.argv[2]}")


if __name__ == "__main__":
    main()
