"""The full protocol verification runner.

    python -m distlr_tpu_torch.analysis.protocol            # standard suite
    python -m distlr_tpu_torch.analysis.protocol --full     # + the combined
                                                      #   resize+fault
                                                      #   space (~400k
                                                      #   states)
    python -m distlr_tpu_torch.analysis.protocol --mutants  # schedules only
    python -m distlr_tpu_torch.analysis.protocol --run-dir DIR \\
        [--chaos-events LOG]                          # conformance
                                                      #   replay of a
                                                      #   real run

Exit codes: 0 all clean / mutants rediscovered; 1 an invariant
violation, a missed mutant, or a conformance violation.
"""

from __future__ import annotations

import argparse
import sys
import time

from distlr_tpu_torch.analysis.protocol import (
    checker,
    conformance,
    mutants,
    spec as S,
)


def scenario_full() -> S.Scenario:
    """The combined space: one live resize AND one chaos fault over the
    2x2 configuration — the largest closure the suite proves (~400k
    states; this is what the ``slow`` marker buys)."""
    return S.Scenario(
        name="full-resize-plus-fault",
        dim=4, num_servers=2,
        programs=(
            (("push", (1, 3)), ("barrier", 0)),
            (("push", (0, 2)),),
        ),
        resize=1,
        faults=("reset", "delay"),
        fault_budget=1,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distlr_tpu_torch.analysis.protocol",
        description="KV-protocol model checking: exhaustive "
                    "interleaving search + mutant rediscovery + trace "
                    "conformance")
    ap.add_argument("--full", action="store_true",
                    help="also close the combined resize+fault space")
    ap.add_argument("--mutants", action="store_true",
                    help="only print the mutant counterexample schedules")
    ap.add_argument("--max-states", type=int, default=2_000_000)
    ap.add_argument("--run-dir", default=None,
                    help="conformance-replay a real run's --obs-run-dir")
    ap.add_argument("--chaos-events", default=None,
                    help="canonical chaos event log to replay with it")
    ap.add_argument("--require-parents", action="store_true",
                    help="run was captured at --trace-sample 1.0: every "
                         "handler span must resolve its client op span")
    ap.add_argument("--regen-fixtures", action="store_true",
                    help="re-run the chaos witness against the live "
                         "native stack and bank its artifacts under "
                         "fixtures/ (see fixtures/README.md)")
    args = ap.parse_args(argv)
    rc = 0

    if args.regen_fixtures:
        from distlr_tpu_torch.analysis.protocol import witness  # noqa: PLC0415
        for path in witness.regen_fixtures(conformance.fixtures_dir()):
            print(f"banked {path}")
        vs = conformance.check_fixtures()
        for v in vs:
            print(v.render(), file=sys.stderr)
        print("fixture conformance after regen: "
              + (f"{len(vs)} violation(s)" if vs else "clean"))
        return 1 if vs else 0

    if args.run_dir or args.chaos_events:
        vs = conformance.check_run(
            conformance.run_dir_journals(args.run_dir)
            if args.run_dir else (),
            args.chaos_events, require_parents=args.require_parents)
        for v in vs:
            print(v.render(), file=sys.stderr)
        print(f"conformance: {len(vs)} violation(s)"
              if vs else "conformance: clean")
        return 1 if vs else 0

    if not args.mutants:
        scenarios = [fn() for fn in checker.STANDARD_SCENARIOS]
        if args.full:
            scenarios.append(scenario_full())
        for sc in scenarios:
            t0 = time.time()
            res = checker.explore(sc, max_states=args.max_states,
                                  max_depth=80)
            print(f"{res.render()}  [{time.time() - t0:.1f}s]")
            if res.violation is not None:
                rc = 1

    print()
    for m in mutants.MUTANTS:
        res = mutants.rediscover(m, max_states=args.max_states)
        if res.violation is None:
            print(f"mutant {m.name}: NOT REDISCOVERED — the spec "
                  f"stopped encoding [{m.reverts}]", file=sys.stderr)
            rc = 1
            continue
        print(f"mutant {m.name} (reverts {m.reverts}):")
        print(res.render())
        print()
    # the fixture witness rides every invocation, like the lint pass
    vs = conformance.check_fixtures()
    for v in vs:
        print(v.render(), file=sys.stderr)
        rc = 1
    print("fixture conformance: "
          + (f"{len(vs)} violation(s)" if vs else "clean"))
    return rc


if __name__ == "__main__":
    sys.exit(main())
