"""The ``protocol`` pass of ``python -m distlr_tpu_torch.analysis``.

Three sub-checks, all fast enough for the CPU tests:

* bounded exploration of the standard scenarios — any invariant
  violation is a finding carrying the counterexample schedule;
* mutant rediscovery — each reverted historical fix MUST produce a
  counterexample (a spec that cannot find known bugs is a finding);
* conformance replay of the checked-in fixture artifacts (a real
  2-server chaos run at full trace sampling) — every violation cites
  the journal ``file:line``.

``python -m distlr_tpu_torch.analysis.protocol``
(:mod:`distlr_tpu_torch.analysis.protocol.__main__`)
runs the same checks to closure with schedules printed.
"""

from __future__ import annotations

from distlr_tpu_torch.analysis.protocol import checker, conformance, mutants
from distlr_tpu_torch.analysis.report import Finding, rel

#: bounded-mode budget: every standard scenario CLOSES well under this
#: (the largest needs ~24k states), so the lint pass still gets full proofs;
#: the cap only guards against a spec edit exploding the space
LINT_MAX_STATES = 80_000


def check(max_states: int = LINT_MAX_STATES) -> list[Finding]:
    findings: list[Finding] = []
    for fn in checker.STANDARD_SCENARIOS:
        sc = fn()
        res = checker.explore(sc, max_states=max_states)
        if res.violation is not None:
            msg, sched = res.violation
            findings.append(Finding(
                "protocol", f"invariant:{sc.name}",
                f"{msg} — schedule: " + " | ".join(sched)))
        elif not res.complete:
            findings.append(Finding(
                "protocol", f"state-space:{sc.name}",
                f"exploration no longer closes under {max_states} "
                f"states ({res.states} visited, depth {res.depth}) — "
                "the spec grew; re-tune LINT_MAX_STATES deliberately "
                "or shrink the scenario"))
    for problem in mutants.check_all(max_states=max_states):
        findings.append(Finding("protocol", "mutant", problem))
    for v in conformance.check_fixtures():
        findings.append(Finding(
            "protocol", "conformance-fixture",
            v.message, ((rel(v.file), v.line),)))
    return findings
