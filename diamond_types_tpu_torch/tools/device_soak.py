"""Device-session endurance soak — hours of realtime merge-per-edit
traffic against the REAL card, parity-checked against the host engine
on every sync.

The device benches measure per-call latency over seconds; this harness
measures something they cannot: sustained runtime stability. It drives
a `DeviceZoneSession` (gpu/zone_session.py, X8 per sync) with the same
2-agent continuation shape as the session bench — each agent keeps
typing from its own head — and asserts that `sess.text()` equals the
C++ tracker's merge of the oplog's tip (`Branch.merge_reference`) after
EVERY sync, so the device state, the resync path (capacity growth
naturally forces full rebuilds as the document grows), and the
micro-tape continuation are all parity-gated for the whole run. The
reference never goes through `OpLog.checkout`, which may itself pick the
zone engine once the engine policy has measured it.

A parity MISMATCH is logged and stops the run (exit 1). A fault of the
device session is fail-stop too: the `device_crash` event is logged and
the run exits 2. The JAX package's soak rebuilds the session and carries
on; on the port's device paths only the fence is caught.

The session runs on `--device` (default CUDA, which must exist; `cpu`
runs X8's plain version). `--corpus` is a file name under the reference
corpora directory (`~/reference/benchmark_data`), or an absolute path to
any `.dt` file.

Coexistence: pauses while a bench run is in flight (the repo root's
`.bench_active`, the same check as tools/soak.py).

Usage:
  python -m diamond_types_tpu_torch.tools.device_soak \\
      --corpus friendsforever.dt --hours 3 --log DEVICE_SOAK.jsonl
Stop early: touch .stop_device_soak in the repo root.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
import traceback

from .soak import bench_is_active, checkout

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
_STOP = os.path.join(_REPO_ROOT, ".stop_device_soak")
# the reference corpora's directory in a checkout of the reference beside
# the home directory (an absolute --corpus path is used as it is)
_BENCH_DATA = os.path.join(os.path.expanduser("~"), "reference",
                           "benchmark_data")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--corpus", default="friendsforever.dt")
    p.add_argument("--hours", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--batch-max", type=int, default=8,
                   help="max edits folded per sync")
    p.add_argument("--device", default=None,
                   help="the session's torch device (default: CUDA, "
                   "which must exist; 'cpu' runs X8's plain version)")
    p.add_argument("--log", default=None)
    args = p.parse_args(argv)

    from ..gpu import resolve_device
    device = resolve_device(args.device)

    out = open(args.log, "a") if args.log else sys.stdout

    def emit(obj):
        obj["ts"] = round(time.time(), 1)
        out.write(json.dumps(obj, ensure_ascii=False) + "\n")
        out.flush()

    from ..encoding.decode import load_oplog
    from ..gpu.zone_session import DeviceZoneSession

    with open(os.path.join(_BENCH_DATA, args.corpus), "rb") as f:
        ol = load_oplog(f.read())
    emit({"event": "soak_start", "corpus": args.corpus,
          "backend": str(device), "hours": args.hours,
          "n_ops_start": len(ol)})

    rng = random.Random(args.seed)
    t_build0 = time.time()
    sess = DeviceZoneSession(ol, device=device)
    sess.touch()
    emit({"event": "session_built",
          "build_s": round(time.time() - t_build0, 1)})

    # The 2-agent continuation shape needs two agents that each OWN at
    # least one op: heads come from _agent_last_lv, and a None head
    # (agent registered but opless, or a single-agent linear corpus)
    # would crash the first one_edit with a useless traceback hours
    # into an unattended run. Validate up front; a missing SECOND
    # agent is repairable by seeding one op at the tip.
    agents = [a for a in range(len(ol.cg.agent_assignment.agent_names))
              if sess._agent_last_lv(a) is not None][:2]
    if not agents:
        emit({"event": "soak_abort", "fatal": True,
              "why": f"corpus {args.corpus} has no agent with any ops; "
              "cannot derive an editing head (pick a non-empty corpus)"})
        return 1
    heads = {}
    if len(agents) == 1:
        a2 = ol.get_or_create_agent_id("device-soak-2")
        heads[a2] = [ol.add_insert_at(a2, list(ol.version), 0, "q")]
        agents.append(a2)
        emit({"event": "seeded_second_agent", "agent": "device-soak-2",
              "why": "corpus has a single editing agent; the soak's "
              "continuation shape needs two concurrent heads"})
    for a in agents:
        heads.setdefault(a, [sess._agent_last_lv(a)])
    lens = {a: len(checkout(ol, heads[a]).snapshot()) for a in agents}

    def one_edit(a):
        # inserts only: deletes at random positions are covered by the
        # CI fuzz; growth is the POINT here (it forces capacity resyncs)
        pos = rng.randrange(max(lens[a], 1))
        n = rng.randint(1, 4)
        heads[a] = [ol.add_insert_at(a, heads[a], pos, "q" * n)]
        lens[a] += n

    deadline = time.time() + args.hours * 3600
    syncs = edits = crashes = 0
    resyncs0 = sess.resyncs
    t_report = time.time()
    while time.time() < deadline and not os.path.exists(_STOP):
        if bench_is_active():
            emit({"event": "paused", "why": "bench.py run in flight"})
            time.sleep(30)
            continue
        k = rng.randint(1, args.batch_max)
        for i in range(k):
            one_edit(agents[(edits + i) % 2])
        edits += k
        try:
            sess.sync()
            got = sess.text()
        except Exception:
            # fail-stop: a fault of the device session ends the run
            crashes += 1
            emit({"event": "device_crash", "crashes": crashes,
                  "fatal": True, "syncs": syncs, "edits": edits,
                  "error": traceback.format_exc(limit=1)
                  .strip().splitlines()[-1][:200]})
            traceback.print_exc()
            return 2
        expected = checkout(ol, ol.version).snapshot()
        if got != expected:
            emit({"event": "PARITY_MISMATCH", "syncs": syncs,
                  "edits": edits, "fatal": True})
            return 1
        syncs += 1
        if time.time() - t_report > 120:
            emit({"event": "progress", "syncs": syncs, "edits": edits,
                  "resyncs": sess.resyncs - resyncs0, "crashes": crashes,
                  "doc_chars": len(expected), "n_ops": len(ol),
                  "elapsed_s": round(time.time() - (deadline -
                                                    args.hours * 3600))})
            t_report = time.time()
    emit({"event": "soak_end", "syncs": syncs, "edits": edits,
          "resyncs": sess.resyncs - resyncs0, "crashes": crashes,
          "parity": "all syncs byte-identical", "n_ops_end": len(ol)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
