"""A zone session against the reference, sync by sync, with no scheduler.

    python3 -m dtbench.zone_repro --seed 77 --docs 24 --syncs 16 \\
        --base-min 200 --base-max 400 [--device cpu]

Each document gets the concurrent mix's syncs (two agents forked from the
merged version, then one op on both tips). After each sync the document's
`DeviceZoneSession` syncs, and its text is compared with the reference's.
For the first sync that differs, one line is printed with the document,
the sync, whether the session resynced, and whether the program's host merge
(`OpLog.checkout_tip`) sides with the reference. This is the witness for the
zone-session fault that keeps `zone-concurrent` out of the manifest
(PERF.md, Open questions)."""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> int:
    from diamond_types_tpu_torch import OpLog
    from diamond_types_tpu_torch.gpu.zone_session import DeviceZoneSession

    from dtbench.reference.listcrdt import RefDoc
    from dtbench.tiers import append_sync
    from dtbench.traffic.generate import DocGen

    ap = argparse.ArgumentParser(prog="python3 -m dtbench.zone_repro")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--docs", type=int, default=24)
    ap.add_argument("--syncs", type=int, default=16)
    ap.add_argument("--base-min", type=int, default=200)
    ap.add_argument("--base-max", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mix = json.loads((Path(__file__).parent / "traffic" / "concurrent.json")
                     .read_text())
    mix["docs"].update(base_min=args.base_min, base_max=args.base_max)
    bad = 0
    for d in range(args.docs):
        gen = DocGen(args.seed, d, mix["docs"], mix["edits"])
        ol = OpLog()
        ids = {a: ol.get_or_create_agent_id(a) for a in gen.agents()}
        ref, tip = RefDoc(), []
        sess = None
        for k in range(args.syncs + 1):
            sync = gen.syncs[0] if k == 0 else gen.next_sync()
            if k:
                gen.syncs.append(sync)
            tip = append_sync(ol, ids, tip, sync)
            ref.apply_sync(sync)
            if sess is None:
                sess = DeviceZoneSession(ol, device=args.device)
                continue
            resyncs = sess.resyncs
            sess.sync()
            if sess.text() != ref.text():
                bad += 1
                print(json.dumps({
                    "doc": d, "sync": k, "ops": len(ol),
                    "resynced": sess.resyncs != resyncs,
                    "host_equals_reference":
                        ol.checkout_tip().snapshot() == ref.text()}),
                      flush=True)
                break
    print(json.dumps({"docs": args.docs, "diverged": bad}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
