"""CLI for the port's schedcheck:
``python -m distlr_tpu_torch.analysis.schedcheck``.

    python -m distlr_tpu_torch.analysis.schedcheck              # fast tier
    python -m distlr_tpu_torch.analysis.schedcheck --full       # deep DFS
    python -m distlr_tpu_torch.analysis.schedcheck --scenario joiner_label_race
    python -m distlr_tpu_torch.analysis.schedcheck --fuzz 200   # wider fuzz
    python -m distlr_tpu_torch.analysis.schedcheck --list
    python -m distlr_tpu_torch.analysis.schedcheck \
        --replay 'mutant:joiner_check_then_insert:1.1.0.0.0.0'

``--replay`` re-executes one pinned schedule id (as printed by a
failure report) and prints the byte-stable report; a ``mutant:``-
prefixed id replays with the historical bug re-applied.  Exit codes:
0 clean, 1 findings/failure.
"""

from __future__ import annotations

import argparse
import sys
import time

from distlr_tpu_torch.analysis.schedcheck import explore, lint, mutants, scenarios
from distlr_tpu_torch.analysis.schedcheck.runtime import parse_schedule_id


def _replay(sid: str) -> int:
    name, choices = parse_schedule_id(sid)
    if name.startswith("mutant:"):
        mname = name.split(":", 1)[1]
        if mname not in mutants.MUTANTS:
            print(f"unknown mutant {mname!r}", file=sys.stderr)
            return 1
        res = mutants.MUTANTS[mname].replay(choices)
    else:
        if name not in scenarios.SCENARIOS:
            print(f"unknown scenario {name!r} "
                  f"(have: {', '.join(scenarios.names())})",
                  file=sys.stderr)
            return 1
        s = scenarios.SCENARIOS[name]
        res = explore.replay(name, s.fn, choices, max_steps=s.max_steps)
    if res.failure is None:
        print(f"schedule {sid} replays CLEAN "
              f"({len(res.decisions)} decisions, {len(res.steps)} steps)")
        return 0
    print(res.render_failure())
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distlr_tpu_torch.analysis.schedcheck",
        description="deterministic-interleaving execution of the real "
                    "Python fleet: scenario DFS + fuzz + mutant "
                    "rediscovery")
    ap.add_argument("--full", action="store_true",
                    help="deep tier: higher preemption bound and run "
                    "budgets")
    ap.add_argument("--scenario", action="append", metavar="NAME",
                    help="run only this scenario (repeatable)")
    ap.add_argument("--fuzz", type=int, default=0, metavar="N",
                    help="additionally run N random schedules per "
                    "scenario")
    ap.add_argument("--replay", metavar="SCHEDULE_ID",
                    help="re-run one pinned schedule id and print its "
                    "byte-stable report")
    ap.add_argument("--list", action="store_true",
                    help="list scenarios and mutants, then exit")
    args = ap.parse_args(argv)

    if args.list:
        for s in scenarios.SCENARIOS.values():
            print(f"{s.name}: {', '.join(s.classes)}")
        for m in mutants.MUTANTS.values():
            print(f"mutant:{m.name}: reverts {m.target} "
                  f"({m.historical})")
        return 0
    if args.replay:
        return _replay(args.replay)

    picked = scenarios.SCENARIOS
    if args.scenario:
        unknown = sorted(set(args.scenario) - set(picked))
        if unknown:
            print(f"unknown scenario(s) {unknown} "
                  f"(have: {', '.join(scenarios.names())})",
                  file=sys.stderr)
            return 1
        picked = {n: picked[n] for n in args.scenario}

    rc = 0
    for s in picked.values():
        t0 = time.monotonic()
        findings = lint.check_scenario(s, deep=args.full)
        dt = time.monotonic() - t0
        if findings:
            rc = 1
            for f in findings:
                print(f.render(), file=sys.stderr)
        else:
            print(f"{s.name}: clean ({dt:.1f}s)")
        if args.fuzz:
            fz = explore.fuzz(s.name, s.fn, seeds=args.fuzz,
                              max_steps=s.max_steps)
            if fz.failure is not None:
                rc = 1
                print(fz.failure.render_failure(), file=sys.stderr)
            else:
                print(f"{s.name}: fuzz clean ({fz.runs} schedules)")
    if not args.scenario:
        for name in mutants.MUTANTS:
            with lint.quiet_logs():
                problems = mutants.verify_mutant(name)
            if problems:
                rc = 1
                for p in problems:
                    print(f"[sched] {p}", file=sys.stderr)
            else:
                print(f"mutant:{name}: rediscovered, bounded, replayable")
    return rc


if __name__ == "__main__":
    sys.exit(main())
