"""CLI for fleetsim: ``python -m distlr_tpu_torch.analysis.fleetsim``
(also reachable as ``launch fleetsim``).

    python -m distlr_tpu_torch.analysis.fleetsim              # fast tier
    python -m distlr_tpu_torch.analysis.fleetsim --full       # + fuzz seeds
    python -m distlr_tpu_torch.analysis.fleetsim --scenario slow_burn_slo
    python -m distlr_tpu_torch.analysis.fleetsim --seed 7
    python -m distlr_tpu_torch.analysis.fleetsim --fuzz 25    # wider sweep
    python -m distlr_tpu_torch.analysis.fleetsim --list
    python -m distlr_tpu_torch.analysis.fleetsim \
        --replay 'fleetsim:cascade_eject_canary:0'
    python -m distlr_tpu_torch.analysis.fleetsim --scenario slow_burn_slo \
        --history /tmp/burn.jsonl   # then: launch top --replay ...

``--replay`` re-executes one pinned replay id (as printed in a
violation) and prints the byte-stable verdict.  ``--history`` banks
the run's simulated ``fleet.json`` frames as a ``history.jsonl`` that
``launch top --replay`` scrubs on the virtual clock.  Exit codes: 0
clean, 1 violations/problems, 2 bad usage.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from distlr_tpu_torch.analysis.fleetsim import lint, mutants, scenarios


def _emit(res: scenarios.Result, *, as_json: bool) -> None:
    if as_json:
        print(json.dumps(res.to_doc(), sort_keys=True))
        return
    verdict = "CLEAN" if not res.violations else "VIOLATED"
    print(f"{res.replay_id}: {verdict} ({res.events} events, "
          f"digest {res.digest})")
    for v in res.violations:
        print(f"  {v}")


def _write_history(res: scenarios.Result, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for doc in res.history:
            f.write(json.dumps(doc, sort_keys=True) + "\n")
    print(f"banked {len(res.history)} frames to {path} "
          f"(scrub with `python -m distlr_tpu_torch.launch top --replay {path}`)")


def _replay(replay_id: str, *, as_json: bool) -> int:
    try:
        name, seed = scenarios.parse_replay_id(replay_id)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    with lint.quiet_logs():
        res = scenarios.run_scenario(name, seed)
    _emit(res, as_json=as_json)
    return 1 if res.violations else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distlr_tpu_torch.analysis.fleetsim",
        description="deterministic discrete-event fleet scenarios "
                    "property-testing the real autopilot / router / "
                    "reshard / SLO policies at thousand-rank scale")
    ap.add_argument("--full", action="store_true",
                    help="deep tier: add the multi-seed fuzz sweep")
    ap.add_argument("--scenario", action="append", metavar="NAME",
                    help="run only this scenario (repeatable)")
    ap.add_argument("--seed", type=int, default=0,
                    help="RNG seed for the runs (default 0, the pinned "
                    "digest seed)")
    ap.add_argument("--fuzz", type=int, default=0, metavar="N",
                    help="additionally run seeds 1..N per scenario")
    ap.add_argument("--replay", metavar="REPLAY_ID",
                    help="re-run one pinned fleetsim:<scenario>:<seed> "
                    "id and print its byte-stable verdict")
    ap.add_argument("--history", metavar="PATH",
                    help="bank the run's simulated fleet.json frames "
                    "as a history.jsonl for `launch top --replay` "
                    "(single scenario only)")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON result doc per run instead of "
                    "prose")
    ap.add_argument("--list", action="store_true",
                    help="list scenarios and mutants, then exit")
    args = ap.parse_args(argv)

    if args.list:
        for s in scenarios.SCENARIOS.values():
            print(f"{s.name}: {s.describe}")
        for m in mutants.MUTANTS.values():
            print(f"mutant:{m.name}: reverts the {m.historical} "
                  f"(pinned at {m.replay_id})")
        return 0
    if args.replay:
        if args.history:
            print("error: --history needs a scenario run, not --replay "
                  "(use --scenario NAME --history PATH)", file=sys.stderr)
            return 2
        return _replay(args.replay, as_json=args.json)

    picked = list(scenarios.SCENARIOS)
    if args.scenario:
        unknown = sorted(set(args.scenario) - set(picked))
        if unknown:
            print(f"unknown scenario(s) {unknown} "
                  f"(have: {', '.join(picked)})", file=sys.stderr)
            return 2
        picked = list(args.scenario)
    if args.history and len(picked) != 1:
        print("error: --history banks ONE scenario's frames — pick it "
              "with --scenario NAME", file=sys.stderr)
        return 2

    rc = 0
    for name in picked:
        t0 = time.monotonic()
        with lint.quiet_logs():
            res = scenarios.run_scenario(name, args.seed)
        dt = time.monotonic() - t0
        _emit(res, as_json=args.json)
        if not args.json:
            print(f"  {res.events / max(dt, 1e-9):,.0f} events/s "
                  f"({dt:.2f}s wall)")
        if res.violations:
            rc = 1
        if args.history:
            _write_history(res, args.history)
        seeds = list(range(1, args.fuzz + 1))
        if args.full and not seeds:
            seeds = list(range(1, lint.DEEP_FUZZ_SEEDS + 1))
        for seed in seeds:
            with lint.quiet_logs():
                r = scenarios.run_scenario(name, seed)
            if r.violations:
                rc = 1
                _emit(r, as_json=args.json)
            elif args.json:
                _emit(r, as_json=True)
        if seeds and not args.json:
            print(f"  fuzz: {len(seeds)} extra seed(s)")

    if not args.scenario and args.seed == 0:
        for name in mutants.MUTANTS:
            with lint.quiet_logs():
                problems = mutants.verify_mutant(name)
            if problems:
                rc = 1
                for p in problems:
                    print(f"[fleetsim] {p}", file=sys.stderr)
            else:
                print(f"mutant:{name}: rediscovered and replayable at "
                      f"{mutants.MUTANTS[name].replay_id}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
