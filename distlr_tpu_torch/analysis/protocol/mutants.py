"""Mutant mode: revert a named historical fix, rediscover the bug.

A spec that never finds anything might be modeling the wrong protocol.
The calibration is the repo's own bug history: each mutant here turns
OFF exactly one :class:`~distlr_tpu_torch.analysis.protocol.spec.Spec` fix
flag, and the checker must rediscover the production bug that fix
closed — as a counterexample schedule, within a budget of 12 steps.  If a refactor of the spec ever makes a mutant
pass clean, the spec stopped encoding the fix and the protocol pass
fails loudly ("mutant not rediscovered").
"""

from __future__ import annotations

import dataclasses

from distlr_tpu_torch.analysis.protocol import checker, spec as S

#: the schedule-length budget for rediscovered bugs
MAX_SCHEDULE_STEPS = 12


@dataclasses.dataclass(frozen=True)
class Mutant:
    name: str
    #: which fix is reverted, and where it landed
    reverts: str
    protocol: S.Spec
    scenario: S.Scenario
    #: substring the violation message must carry (the right bug, not
    #: just any bug)
    expect: str


def _barrier_scenario() -> S.Scenario:
    return S.Scenario(
        name="mutant-barrier-double-vote",
        dim=4, num_servers=2,
        programs=(
            (("barrier", 0),),
            (("barrier", 0),),
        ),
        faults=("reset",),
        fault_budget=1,
    )


def _straddle_scenario() -> S.Scenario:
    return S.Scenario(
        name="mutant-reissue-straddling-push",
        dim=4, num_servers=2,
        programs=(
            (("push", (1, 3)),),
        ),
        resize=1,
        faults=(),
        fault_budget=0,
    )


MUTANTS = (
    Mutant(
        name="barrier-double-vote",
        reverts="HandleBarrier dedups votes by client_id "
                "(kv_server.cc replaces the stale entry's fd)",
        protocol=S.Spec(barrier_dedup_by_client=False),
        scenario=_barrier_scenario(),
        expect="I2: barrier gen 0 released",
    ),
    Mutant(
        name="reissue-straddling-push",
        reverts="a push straddling a membership flip is absorbed "
                "as push_outcome_unknown, never re-issued "
                "(ps/client.py membership layer)",
        protocol=S.Spec(absorb_fenced_push=False),
        scenario=_straddle_scenario(),
        expect="I1: push",
    ),
)


def rediscover(mutant: Mutant, *, max_states: int = 200_000
               ) -> checker.CheckResult:
    """Run the checker against one reverted fix; the result must carry
    the expected violation (callers assert)."""
    return checker.explore(mutant.scenario, mutant.protocol,
                           max_states=max_states,
                           max_depth=MAX_SCHEDULE_STEPS + 4)


def check_all(max_states: int = 200_000) -> list:
    """Every mutant must be rediscovered: returns a list of problem
    strings (empty = all bugs found, spec still encodes every fix)."""
    problems = []
    for m in MUTANTS:
        res = rediscover(m, max_states=max_states)
        if res.violation is None:
            if not res.complete:
                # the search was CUT, not exhausted: the bug may still
                # be reachable past the bound — name the real cause
                problems.append(
                    f"mutant {m.name!r} not rediscovered within the "
                    f"search bounds ({res.states} states, depth "
                    f"{res.depth}, max_states={max_states}) — the "
                    "minimal schedule grew past the budget; shrink the "
                    "scenario or raise the bounds deliberately")
            else:
                problems.append(
                    f"mutant {m.name!r} NOT rediscovered: reverting "
                    f"[{m.reverts}] violates no invariant anywhere in "
                    "the CLOSED state space — the spec stopped "
                    "encoding the fix")
            continue
        msg, sched = res.violation
        if m.expect not in msg:
            problems.append(
                f"mutant {m.name!r} found the WRONG bug: expected "
                f"{m.expect!r} in {msg!r}")
        if len(sched) > MAX_SCHEDULE_STEPS:
            problems.append(
                f"mutant {m.name!r} counterexample takes {len(sched)} "
                f"steps (> {MAX_SCHEDULE_STEPS}) — the minimal schedule "
                "regressed; the spec grew accidental steps")
    return problems
