"""Explicit-state model checker over the executable KV-protocol spec.

Breadth-first search over every interleaving of a
:class:`~distlr_tpu_torch.analysis.protocol.spec.Scenario`'s enabled steps,
with state hashing (two interleavings that converge on the same world
are explored once) and invariant checks at every node.  BFS means the
first violation found has a SHORTEST schedule — the counterexamples
this prints are minimal, which is what makes them readable bug
reports rather than thousand-step soup.

The search is bounded two ways (``max_states``, ``max_depth``) and the
result says whether the exploration CLOSED (every reachable state
visited) or was cut — a bounded-clean result is evidence, a closed
clean result is proof (for the configuration searched).  The lint pass
runs the bounded check; ``python -m distlr_tpu_torch.analysis.protocol``
runs to closure.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from distlr_tpu_torch.analysis.protocol import spec as S


@dataclasses.dataclass
class CheckResult:
    """Outcome of one exploration."""

    scenario: str
    states: int                  # distinct states visited
    transitions: int             # edges traversed
    depth: int                   # deepest level reached
    complete: bool               # True: state space closed under bounds
    #: None, or (message, schedule) — schedule is the step-label list
    violation: tuple | None = None

    @property
    def ok(self) -> bool:
        return self.violation is None

    def schedule(self) -> list:
        return list(self.violation[1]) if self.violation else []

    def render(self) -> str:
        head = (f"[{self.scenario}] {self.states} states, "
                f"{self.transitions} transitions, depth {self.depth}, "
                f"{'closed' if self.complete else 'BOUNDED'}")
        if self.violation is None:
            return head + " — no invariant violations"
        msg, sched = self.violation
        lines = [head + " — VIOLATION", "",
                 f"counterexample ({len(sched)} steps):"]
        lines += [f"  {i + 1:2d}. {step}" for i, step in enumerate(sched)]
        lines += ["", f"  invariant violated: {msg}"]
        return "\n".join(lines)


def explore(scenario: S.Scenario, protocol: S.Spec | None = None, *,
            max_states: int = 200_000, max_depth: int = 64) -> CheckResult:
    """Exhaustive BFS of ``scenario`` under ``protocol`` (the fixed
    spec by default).  Stops at the FIRST invariant violation and
    rebuilds its schedule from the predecessor chain."""
    protocol = protocol or S.Spec()
    w0 = S.initial_world(scenario)
    root = w0.freeze()
    # frozen state -> (parent frozen state, step label); roots map to None
    parent: dict = {root: None}
    live: dict = {root: w0}
    queue = deque([(root, 0)])
    states, transitions, depth_seen = 1, 0, 0

    def schedule_of(key) -> list:
        steps = []
        while parent[key] is not None:
            key, label = parent[key][0], parent[key][1]
            steps.append(label)
        return list(reversed(steps))

    while queue:
        key, depth = queue.popleft()
        w = live.pop(key)
        depth_seen = max(depth_seen, depth)
        if depth >= max_depth:
            continue
        for label, nw in S.successors(w, scenario, protocol):
            transitions += 1
            nkey = nw.freeze()
            if nkey in parent:
                continue
            parent[nkey] = (key, label)
            msg = S.world_invariant(nw, scenario)
            if msg is not None:
                return CheckResult(
                    scenario=scenario.name, states=states + 1,
                    transitions=transitions, depth=depth + 1,
                    complete=False,
                    violation=(msg, schedule_of(nkey) + []))
            states += 1
            if states >= max_states:
                return CheckResult(
                    scenario=scenario.name, states=states,
                    transitions=transitions, depth=depth_seen,
                    complete=False, violation=None)
            live[nkey] = nw
            queue.append((nkey, depth + 1))
    # queue drained: complete iff no state was cut at max_depth
    complete = depth_seen < max_depth
    return CheckResult(scenario=scenario.name, states=states,
                       transitions=transitions, depth=depth_seen,
                       complete=complete, violation=None)


# -- the standard configurations the lint pass explores ------------------


def scenario_base() -> S.Scenario:
    """The base configuration: 2 clients x 2 servers, each
    client pushing a range-straddling gradient then voting the exit
    barrier, with ONE injected fault from the full chaos alphabet."""
    return S.Scenario(
        name="base-2c2s-fault",
        dim=4, num_servers=2,
        programs=(
            (("push", (1, 3)), ("barrier", 0)),
            (("push", (0, 2)), ("barrier", 0)),
        ),
        faults=("reset", "reset_mid", "delay", "partition"),
        fault_budget=1,
    )


def scenario_resize() -> S.Scenario:
    """One live resize (2 -> 1, the drain direction that moves a
    resident slice) under a concurrent straddling push + barrier, no
    extra fault — the interleavings AROUND the epoch flip are the
    search target."""
    return S.Scenario(
        name="resize-2c2s",
        dim=4, num_servers=2,
        programs=(
            (("push", (1, 3)), ("barrier", 0)),
            (("push", (0, 2)),),
        ),
        resize=1,
        faults=(),
        fault_budget=0,
    )


def scenario_mixed_vintage() -> S.Scenario:
    """A mixed-vintage group: rank 1 predates codecs AND membership
    epochs (kHello answers empty).  Clients WANT int8 — negotiation
    must degrade the whole group to dense f32 and skip the epoch
    announce, never desynchronize (invariant I4)."""
    from distlr_tpu_torch.ps import wire
    return S.Scenario(
        name="mixed-vintage-2c2s",
        dim=4, num_servers=2,
        programs=(
            (("push", (1, 3)), ("barrier", 0)),
            (("push", (0, 2)), ("barrier", 0)),
        ),
        codec=wire.CODEC_INT8,
        server_caps=((1, S.LEGACY_CAPS),),
        faults=("reset",),
        fault_budget=1,
    )


def scenario_ftrl_resize() -> S.Scenario:
    """FTRL group under a live shrink: the drain must carry the z/n
    accumulator multiset exactly (invariant I5) while a concurrent
    push straddles the flip."""
    return S.Scenario(
        name="ftrl-resize-2c2s",
        dim=4, num_servers=2,
        programs=(
            (("push", (1, 3)),),
            (("push", (0, 2)),),
        ),
        optimizer="ftrl",
        resize=1,
        faults=(),
        fault_budget=0,
    )


STANDARD_SCENARIOS = (scenario_base, scenario_resize,
                      scenario_mixed_vintage, scenario_ftrl_resize)
