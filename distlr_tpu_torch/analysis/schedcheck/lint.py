"""The ``sched`` pass of distlr-lint: the schedcheck sweep.

Runs every registered scenario's fast-tier exploration (bounded
exhaustive DFS + a small seeded fuzz layer) and the two mutant
rediscoveries, converting anything unexpected into
:class:`~distlr_tpu_torch.analysis.report.Finding`s:

* a scenario failure — a REAL interleaving bug with its replayable
  schedule id in the message (fix the bug, or pin the schedule and
  fix in the same change; there is deliberately no suppression mechanism
  for schedule failures);
* a fast-tier DFS that no longer closes within its budget — the
  scenario grew past its exploration budget and the bound must be
  re-sized consciously;
* a mutant problem — a reverted historical fix that is no longer
  rediscovered, rediscovered as the wrong bug, needs more than the
  pinned 20 steps, or fails byte-identical replay.

The deep tier (bigger preemption bound / run budgets) lives behind
``python -m distlr_tpu_torch.analysis.schedcheck --full`` and the
``slow`` pytest marker.
"""

from __future__ import annotations

import contextlib
import logging

from distlr_tpu_torch.analysis.report import Finding
from distlr_tpu_torch.analysis.schedcheck import explore, mutants, scenarios


@contextlib.contextmanager
def quiet_logs():
    """The scenarios run REAL production classes, whose health logging
    (ejections, degraded polls, resizes) is meaningless noise across
    thousands of exploration runs — silence it for the sweep."""
    logging.disable(logging.WARNING)
    try:
        yield
    finally:
        logging.disable(logging.NOTSET)

#: fuzz seeds per scenario inside the lint pass (the CLI and tests run
#: wider sweeps; this keeps the runner interactive)
LINT_FUZZ_SEEDS = 5


def _first_line(text: str) -> str:
    return text.splitlines()[0] if text else text


def check_scenario(s: scenarios.Scenario, *, deep: bool = False
                   ) -> list[Finding]:
    with quiet_logs():
        return _check_scenario(s, deep=deep)


def _check_scenario(s: scenarios.Scenario, *, deep: bool
                    ) -> list[Finding]:
    out: list[Finding] = []
    bound = s.deep_bound if deep else s.dfs_bound
    runs = s.deep_runs if deep else s.dfs_runs
    res = explore.dfs(s.name, s.fn, preemption_bound=bound,
                      max_runs=runs, max_steps=s.max_steps)
    if res.failure is not None:
        out.append(Finding(
            "sched", f"scenario-failure:{s.name}",
            f"{_first_line(res.failure.failure.message)} — replay with "
            f"`python -m distlr_tpu_torch.analysis.schedcheck --replay "
            f"'{res.failure.schedule_id}'`"))
        return out
    if not res.closed and not deep:
        # the FAST tier is the closure proof (< 60 s each);
        # the deep tier is budgeted extra depth — bound-2 exhaustion of
        # the largest scenarios (the router's ~10^5+ schedules) is
        # best-effort coverage, not a contract, so only a failure
        # found there is a finding
        out.append(Finding(
            "sched", f"scenario-unclosed:{s.name}",
            f"fast-tier DFS (preemption bound {bound}) no longer "
            f"closes within {runs} runs — the scenario outgrew its "
            "exploration budget; re-size it consciously"))
    fz = explore.fuzz(s.name, s.fn,
                      seeds=s.fuzz_seeds if deep else LINT_FUZZ_SEEDS,
                      max_steps=s.max_steps)
    if fz.failure is not None:
        out.append(Finding(
            "sched", f"scenario-fuzz-failure:{s.name}",
            f"{_first_line(fz.failure.failure.message)} — replay with "
            f"`python -m distlr_tpu_torch.analysis.schedcheck --replay "
            f"'{fz.failure.schedule_id}'`"))
    return out


def check(*, deep: bool = False) -> list[Finding]:
    findings: list[Finding] = []
    with quiet_logs():
        for s in scenarios.SCENARIOS.values():
            findings.extend(_check_scenario(s, deep=deep))
        for name in mutants.MUTANTS:
            for problem in mutants.verify_mutant(name):
                findings.append(
                    Finding("sched", f"mutant:{name}", problem))
    return findings
