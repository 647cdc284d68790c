"""Run a cell once and hold each control merge against the reference on the
same sample of documents: the run is the benchmark's own (set-up, window,
drain, check), and beside the program's texts each sampled document is
merged again by every control (`reference/listcrdt.CONTROLS`). A control
put in the program's place must make `correct` false.

    python3 -m dtbench.control --workload fused-concurrent --seed <n> \\
        --seconds 20

It prints the program's own result line, with `notes.controls` holding each
control's mismatched documents, and one line a control on standard error.
The benchmark's own runs never run the controls (PERF.md: how correct is
decided)."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from dtbench.reference.listcrdt import CONTROLS
    from dtbench.run import cell_metrics, load_cell, print_result, run_cell
    ap = argparse.ArgumentParser(prog="python3 -m dtbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    manifest, cell, config, mix = load_cell(args.workload)
    result = run_cell(cell, config, mix,
                      cell_metrics(manifest, cell["name"], False),
                      args.seed, args.seconds, False, "cuda",
                      controls=CONTROLS)
    checked = result["checks"]["checked_docs"]["value"]
    for name, bad in result["notes"]["controls"].items():
        print(f"control {name} mismatched_docs {bad} of {checked} "
              f"(limit 0: {'fails' if bad > 0 else 'PASSES'})",
              file=sys.stderr)
    print_result(result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
