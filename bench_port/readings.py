"""The readings a cell's limits are set from, on many seeds in one process.

    python3 -m bench_port.readings --workload <name> --seeds 11,12,13 [--seconds 51] [--device cuda]

For each seed, one whole run of the cell (``run.run_cell``: set-up, the
window, the reference over every step), and over the same steps two more
sides judged against the reference, as ``correct`` judges the program:

- ``control``: the reference at the precision below the configuration's,
  put in the program's place;
- ``half_batch``: the reference with half of each batch left out and the
  mean taken over the rest.

A step that returns the weights unchanged reads 1 on ``grad_gap`` and
``change_gap`` by their definition, and one prediction altered in the eval
reads 1 / test rows on ``eval_acc_gap``: neither needs a run.  One JSON
line a seed (the run's metrics, the program's numbers, the sides'), then
the largest program reading and the smallest of each side.
"""

from __future__ import annotations

import argparse
import json
import os

from bench_port import run, spec

SIDES = ("control", "half_batch")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=None,
                   help="window length (default: BENCHMARK.json's run_seconds)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load_cell(os.getcwd(), args.workload)
    seconds = args.seconds or spec.run_seconds(os.getcwd())
    rows = []
    for seed in (int(x) for x in args.seeds.split(",")):
        r = run.run_cell(cell, seed, seconds, traced=False, device=args.device, sides=SIDES)
        rows.append({"seed": seed, "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                     "correct": r["correct"], "diagnostics": r["diagnostics"],
                     **r["sides"]})
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": cell.name, "seeds": len(rows),
               "program_max": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}}
    for side in SIDES:
        summary[f"{side}_min"] = {k: min(r[side][k] for r in rows) for k in rows[0][side]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
