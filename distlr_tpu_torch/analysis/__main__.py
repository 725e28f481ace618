"""distlr-lint runner: ``python -m distlr_tpu_torch.analysis``.

Runs every pass (wire parity, concurrency, config/CLI/docs parity, the
folded-in metrics-doc lint, the print ban, the protocol model-checking
pass, the schedcheck interleaving pass and the fleetsim scenario pass),
prints findings as ``[pass] key: message (file:line ...)``, and exits
non-zero when any survive the audited baselines — the single
static-analysis entry point of the port, held by
``tests/test_torch_analysis.py``.

    python -m distlr_tpu_torch.analysis                # all passes
    python -m distlr_tpu_torch.analysis --only wire    # one pass in isolation
    python -m distlr_tpu_torch.analysis --list-passes  # what exists
    python -m distlr_tpu_torch.analysis --write-docs   # regenerate
                                                       # distlr_tpu_torch/CONFIG.md +
                                                       # distlr_tpu_torch/obs/METRICS.md
"""

from __future__ import annotations

import argparse
import sys

from distlr_tpu_torch.analysis.report import Finding

PASSES = ("wire", "concurrency", "config", "metrics", "printban",
          "protocol", "sched", "fleetsim")

#: one-line summaries for --list-passes (kept here, not in the pass
#: modules, so listing passes never imports them)
PASS_SUMMARIES = {
    "wire": "kv_protocol.h <-> ps/wire.py mirror parity "
            "(analysis/wire_parity.py)",
    "concurrency": "shared-state registry + lock-order cycles + "
                   "audited baseline (analysis/concurrency.py)",
    "config": "Config <-> launch CLI <-> distlr_tpu_torch/CONFIG.md parity "
              "(analysis/config_doc.py)",
    "metrics": "metric-series <-> distlr_tpu_torch/obs/METRICS.md drift "
               "(obs/metrics_doc.py)",
    "printban": "bare print()/sys.stderr.write outside the audited "
                "CLI-output allowlist (analysis/printban.py)",
    "protocol": "KV state-machine model checking + mutants + trace "
                "conformance (analysis/protocol/)",
    "sched": "deterministic-interleaving execution of the real fleet "
             "classes + mutants (analysis/schedcheck/)",
    "fleetsim": "discrete-event fleet scenarios property-testing the "
                "control plane + policy mutants (analysis/fleetsim/)",
}


def run_pass(name: str) -> list[Finding]:
    if name == "wire":
        from distlr_tpu_torch.analysis import wire_parity
        return wire_parity.check()
    if name == "concurrency":
        from distlr_tpu_torch.analysis import concurrency
        return concurrency.check()
    if name == "config":
        from distlr_tpu_torch.analysis import config_doc
        return config_doc.check()
    if name == "printban":
        # structured-log coverage can't silently regress — daemon
        # narrative must flow through get_logger (where the journal tee
        # sees it), not bare prints
        from distlr_tpu_torch.analysis import printban
        return printban.check()
    if name == "protocol":
        # bounded exhaustive search of the KV state machine, mutant
        # rediscovery, and fixture trace conformance (full depth:
        # `python -m distlr_tpu_torch.analysis.protocol --full`)
        from distlr_tpu_torch.analysis.protocol import lint
        return lint.check()
    if name == "sched":
        # the real Python classes under controlled interleavings —
        # scenario DFS/fuzz + the two historical-race mutants
        # (full depth: `python -m distlr_tpu_torch.analysis.schedcheck --full`)
        from distlr_tpu_torch.analysis.schedcheck import lint
        return lint.check()
    if name == "fleetsim":
        # thousand-rank fleet scenarios driving the real autopilot /
        # balance / reshard / SLO policies on a seeded event loop —
        # pinned digests + the three policy-bug mutants (full depth:
        # `python -m distlr_tpu_torch.analysis.fleetsim --full`)
        from distlr_tpu_torch.analysis.fleetsim import lint
        return lint.check()
    if name == "metrics":
        # the metrics-doc lint, folded under this runner (its module
        # keeps its own __main__ for the doc generator)
        from distlr_tpu_torch.obs import metrics_doc
        return [Finding("metrics", f"metrics-drift:{i}", p)
                for i, p in enumerate(metrics_doc.check())]
    raise ValueError(f"unknown pass {name!r} (choose from {PASSES})")


def run(passes=PASSES) -> list[Finding]:
    findings: list[Finding] = []
    for name in passes:
        findings.extend(run_pass(name))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distlr_tpu_torch.analysis",
        description="distlr-lint: wire parity, concurrency, "
                    "config/docs parity, metrics doc, print ban, "
                    "protocol model checking, schedcheck interleavings, "
                    "fleetsim scenarios")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=PASSES,
                    help="run only this pass (repeatable; default all)")
    ap.add_argument("--only", dest="passes", action="append",
                    choices=PASSES, metavar="PASS",
                    help="alias of --pass: run one pass in isolation "
                    "(see --list-passes)")
    ap.add_argument("--list-passes", action="store_true",
                    help="list the passes with one-line summaries, "
                    "then exit")
    ap.add_argument("--write-docs", action="store_true",
                    help="regenerate distlr_tpu_torch/CONFIG.md and "
                    "distlr_tpu_torch/obs/METRICS.md from the sources, "
                    "then exit")
    args = ap.parse_args(argv)
    if args.list_passes:
        for name in PASSES:
            print(f"{name}: {PASS_SUMMARIES[name]}")
        return 0
    if args.write_docs:
        from distlr_tpu_torch.analysis import config_doc
        from distlr_tpu_torch.obs import metrics_doc
        print(f"wrote {config_doc.write_doc()}")
        metrics_doc.main([])
        return 0
    passes = tuple(args.passes) if args.passes else PASSES
    findings = run(passes)
    for f in findings:
        print(f.render(), file=sys.stderr)
    if findings:
        print(f"distlr-lint: {len(findings)} finding(s) across "
              f"{len(passes)} pass(es)", file=sys.stderr)
        return 1
    print(f"distlr-lint: clean ({', '.join(passes)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
