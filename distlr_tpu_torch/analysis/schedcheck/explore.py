"""Schedule exploration: bounded-exhaustive DFS, seeded fuzzing,
and pinned replay.

Three explorers over :func:`~distlr_tpu_torch.analysis.schedcheck.runtime.
run_controlled`, all stateless (every schedule re-runs the scenario
from scratch, so exploration needs no snapshot/restore of arbitrary
Python state):

* :func:`dfs` — CHESS-style iterative exploration with **preemption
  bounding**: the baseline schedule runs each task until it blocks
  (zero preemptions); alternatives preempt a runnable task at some
  decision, and only schedules with at most ``preemption_bound``
  preemptions are explored.  Empirically almost every concurrency bug
  needs very few preemptions (the CHESS result), which turns an
  exponential space into a small polynomial one — the SOUNDNESS
  CAVEAT being that a bug requiring more preemptions than the bound
  (or an interleaving inside uninstrumented code) is out of scope;
  ``closed=True`` means "no bug within the bound", not "no bug".
* :func:`fuzz` — seeded random schedules.  Cheap diversity beyond the
  bound; every failing run is reported by its explicit choice list,
  so a fuzz finding replays exactly like a DFS finding.
* :func:`replay` — re-run one pinned schedule id (regression tests,
  counterexample reproduction).  Reports are byte-stable: same
  schedule id, same failure text, every time.
"""

from __future__ import annotations

import dataclasses

from distlr_tpu_torch.analysis.schedcheck.runtime import (
    Decision,
    Failure,
    RandomStrategy,
    ReplayStrategy,
    RunResult,
    run_controlled,
)


@dataclasses.dataclass
class ExploreResult:
    scenario: str
    runs: int
    #: every distinct failing run (first failure per distinct schedule)
    failures: list[RunResult]
    #: True when every schedule within the preemption bound was run
    #: (DFS only; fuzz always reports False — sampling never closes)
    closed: bool

    @property
    def failure(self) -> RunResult | None:
        return self.failures[0] if self.failures else None


def replay(scenario: str, fn, choices: list[int], *,
           max_steps: int = 4000) -> RunResult:
    res = run_controlled(scenario, fn, ReplayStrategy(choices),
                         max_steps=max_steps)
    if res.failure is None and len(res.decisions) < len(choices):
        # a pin longer than the run's branching means the code under
        # it changed shape — surface a stale pin, never a silent pass
        res = dataclasses.replace(res, failure=Failure(
            "divergence",
            f"schedule pins {len(choices)} choices but the run "
            f"branched only {len(res.decisions)} times — the pinned "
            "schedule no longer matches the code"))
    return res


def _alt_cost(decisions: list[Decision], upto: int, alt: int) -> int:
    """Preemptions in ``decisions[:upto]`` plus the preemption the
    alternative ``alt`` at decision ``upto`` would add."""
    cost = sum(1 for d in decisions[:upto] if d.preemptive)
    d = decisions[upto]
    cur_enabled = d.current is not None and d.current in d.enabled
    if cur_enabled and alt != d.current:
        cost += 1
    return cost


def dfs(scenario: str, fn, *, preemption_bound: int = 2,
        max_runs: int = 4000, max_steps: int = 4000,
        stop_at_first_failure: bool = True) -> ExploreResult:
    """Bounded-exhaustive exploration.  Every run follows a forced
    choice prefix and then the default policy (run the current task
    until it blocks); new prefixes branch off each run's decisions
    wherever an untried alternative stays within the preemption
    bound."""
    stack: list[list[int]] = [[]]
    failures: list[RunResult] = []
    runs = 0
    while stack:
        if runs >= max_runs:
            return ExploreResult(scenario, runs, failures, closed=False)
        prefix = stack.pop()
        res = run_controlled(scenario, fn, ReplayStrategy(prefix),
                             max_steps=max_steps)
        runs += 1
        if res.failure is not None:
            failures.append(res)
            if stop_at_first_failure:
                return ExploreResult(scenario, runs, failures,
                                     closed=False)
            if res.failure.kind == "divergence":
                # the prefix no longer matches the code — harness-level
                # problem, no point branching below it
                continue
        chosen = [d.chosen for d in res.decisions]
        # branch points strictly below this run's forced prefix are
        # already covered by the runs that produced the prefix
        for i in range(len(res.decisions) - 1, len(prefix) - 1, -1):
            d = res.decisions[i]
            for alt in d.enabled:
                if alt == d.chosen:
                    continue
                if _alt_cost(res.decisions, i, alt) > preemption_bound:
                    continue
                stack.append(chosen[:i] + [alt])
    return ExploreResult(scenario, runs, failures, closed=True)


def fuzz(scenario: str, fn, *, seeds: int = 50, seed_base: int = 0,
         max_steps: int = 4000,
         stop_at_first_failure: bool = True) -> ExploreResult:
    failures: list[RunResult] = []
    runs = 0
    for s in range(seed_base, seed_base + seeds):
        res = run_controlled(scenario, fn, RandomStrategy(s),
                             max_steps=max_steps)
        runs += 1
        if res.failure is not None:
            failures.append(res)
            if stop_at_first_failure:
                break
    return ExploreResult(scenario, runs, failures, closed=False)
