"""Mutant-verified policy-bug rediscovery (the schedcheck tradition,
pointed at the CONTROL PLANE).

Fleetsim found three real policy bugs in this repo's shipping code;
each got a fix, a unit-test row, and an entry here.  A mutant swaps
ONE fixed policy seam back to its verbatim pre-fix body (kept below as
the historical record), re-runs the scenario that found the bug, and
the property that motivated the fix must fail again — with the exact
violation class, at the pinned replay id, byte-identically on every
run.  With the fix in place the same scenario must stay clean AND
reproduce its pinned digest.  Failing either direction means
"fleetsim stopped encoding the fix" and fails the analysis pass.

The three pinned counterexamples:

* ``router_eject_unbounded`` — ``fleetsim:cascade_eject_canary:0``.
  Pre-fix the router had NO ejection floor: a fleet-wide brownout
  failed every replica's health streak, the eject path removed all of
  them, and after the fault cleared the empty rotation kept erroring
  until probe backoff (doubling toward 30s) let somebody back in —
  the outage outlived the fault.  Fix: :func:`distlr_tpu_torch.serve.
  balance.may_eject` refuses to eject the last healthy member of any
  multi-replica pool (singleton pools stay ejectable — fast
  "no healthy replica" admission errors beat dial timeouts), counted
  by ``distlr_route_eject_suppressed_total``.
* ``autopilot_alert_freeze`` — ``fleetsim:slow_burn_slo:0``.
  Pre-fix rule 2 froze EVERY actuator whenever any bound alert fired,
  blamable or not.  A slow capacity loss fires the SLO burn alert
  forever, the frozen controller can never add the engine that would
  clear it, and the error budget drains to zero.  Fix:
  :meth:`~distlr_tpu_torch.autopilot.policy.PolicyEngine._on_alert` only
  freezes when the youngest action is young enough to blame;
  otherwise the tick runs capacity-only (adds allowed, removals
  suppressed).
* ``autopilot_no_flap_damping`` — ``fleetsim:autopilot_resonance:0``.
  Pre-fix ``_act`` charged a constant cooldown, so an offered load
  sitting between the scale-down and scale-up thresholds of adjacent
  engine counts drove up/down/up/down at exactly the cooldown cadence
  — each cycle a replica churn.  Fix: direction reversals inside
  ``FLAP_WINDOW_COOLDOWNS`` escalate the cooldown ``2**streak`` up to
  ``2**FLAP_STREAK_MAX``, stretching the oscillation period until the
  diurnal curve moves off the resonant point.
"""

from __future__ import annotations

import contextlib
import dataclasses

from distlr_tpu_torch.autopilot.policy import ACTUATORS, Action, PolicyEngine
from distlr_tpu_torch.serve import balance
from distlr_tpu_torch.analysis.fleetsim.scenarios import Result, run_scenario

#: scenario -> seed-0 clean-run digest; byte-identity is asserted by
#: the lint pass and the tests, so a change
#: to any modeled or real policy path shows up as a reviewable diff
#: of this table, never as silent drift
EXPECTED_DIGESTS: dict[str, str] = {
    "partition_heal_1000": "92c4ae086027f82b",
    "reshard_64_to_96_zipf": "1d3a5ab457abe029",
    "cascade_eject_canary": "3d3b548dfe07ddaf",
    "autopilot_resonance": "8a27b240d189726b",
    "slow_burn_slo": "f433f00e7d368a8b",
    "standby_exhaustion": "27fa5c1582a81512",
    "power_loss_durable": "69dcd9fcc6a72fc1",
}


# ---------------------------------------------------------------------------
# the verbatim pre-fix bodies
# ---------------------------------------------------------------------------


def _prefix_may_eject(rep, pools) -> bool:
    """``balance.may_eject`` BEFORE the floor: the eject path asked no
    questions — any replica whose failure streak crossed the threshold
    left the rotation, including the last healthy member of a pool."""
    return True


def _prefix_on_alert(self, current, now):
    """Rule 2 BEFORE the capacity-only fix (verbatim from the first
    ``PolicyEngine.tick`` body, reshaped to the ``_on_alert`` seam):
    every firing alert froze every actuator for a cooldown, whether or
    not any action could be blamed — the slow-burn deadlock."""
    c = self.cfg
    for a in ACTUATORS:
        self._cooldown_until[a] = now + c.cooldown_s
    self._breach.clear()
    last = self._last_action
    if (last is not None and not self._rolled_back
            and now - self._last_action_t <= c.rollback_window_s
            and current.get(last.actuator) is not None):
        lo, hi = c.bounds(last.actuator)
        target = max(lo, min(hi, last.from_count))
        cur = int(current[last.actuator])
        self._rolled_back = True
        if target != cur:
            return ("rollback_on_alert",
                    Action(last.actuator, "down" if target < cur else "up",
                           cur, target))
    return ("hold_on_alert", None)


def _prefix_act(self, actuator, direction, current, now):
    """``PolicyEngine._act`` BEFORE flap damping: constant cooldown,
    no reversal streak — the resonance oscillator."""
    lo, hi = self.cfg.bounds(actuator)
    target = max(lo, min(hi, current + (1 if direction == "up" else -1)))
    act = Action(actuator, direction, current, target)
    self._cooldown_until[actuator] = now + self.cfg.cooldown_s
    # the action changes the very state both counters measured
    self._breach[(actuator, "up")] = 0
    self._breach[(actuator, "down")] = 0
    self._last_action, self._last_action_t = act, now
    self._rolled_back = False
    return act


# ---------------------------------------------------------------------------
# registry + verification
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mutant:
    name: str
    historical: str                 # which shipped fix this reverts
    #: (module-or-class object, attribute) the buggy body replaces
    target: tuple[object, str]
    buggy_fn: object
    scenario: str
    seed: int
    #: substring every-run violations must carry under the mutation —
    #: rediscovering a DIFFERENT bug is a failure too ("wrong bug")
    expect_in_violation: str

    @property
    def replay_id(self) -> str:
        return f"fleetsim:{self.scenario}:{self.seed}"

    @contextlib.contextmanager
    def applied(self):
        """Swap the fixed seam for the historical pre-fix body."""
        obj, attr = self.target
        orig = getattr(obj, attr)
        setattr(obj, attr, self.buggy_fn)
        try:
            yield
        finally:
            setattr(obj, attr, orig)

    def clean_run(self) -> Result:
        return run_scenario(self.scenario, self.seed)

    def rediscover(self) -> Result:
        """Re-run the pinned scenario with the fix REVERTED."""
        with self.applied():
            return run_scenario(self.scenario, self.seed)


MUTANTS: dict[str, Mutant] = {
    m.name: m for m in (
        Mutant(
            name="router_eject_unbounded",
            historical="serve.balance ejection floor",
            target=(balance, "may_eject"),
            buggy_fn=_prefix_may_eject,
            scenario="cascade_eject_canary",
            seed=0,
            expect_in_violation="zero_failed_accepted",
        ),
        Mutant(
            name="autopilot_alert_freeze",
            historical="autopilot capacity-only alert mode",
            target=(PolicyEngine, "_on_alert"),
            buggy_fn=_prefix_on_alert,
            scenario="slow_burn_slo",
            seed=0,
            expect_in_violation="slo_budget_held",
        ),
        Mutant(
            name="autopilot_no_flap_damping",
            historical="autopilot flap-reversal cooldown escalation",
            target=(PolicyEngine, "_act"),
            buggy_fn=_prefix_act,
            scenario="autopilot_resonance",
            seed=0,
            expect_in_violation="no_flapping",
        ),
    )
}


def verify_mutant(name: str) -> list[str]:
    """Full acceptance for one mutant; returns problem strings (empty
    = fixed code clean at the pinned digest, reverted code violates
    the expected property, and the counterexample replays
    byte-identically)."""
    m = MUTANTS[name]
    problems: list[str] = []
    clean = m.clean_run()
    if clean.violations:
        problems.append(
            f"{name}: {m.replay_id} violates WITH the fix in place: "
            f"{clean.violations[0]}")
        return problems
    want = EXPECTED_DIGESTS.get(m.scenario)
    if want is not None and clean.digest != want:
        problems.append(
            f"{name}: clean digest {clean.digest} != pinned {want} "
            f"({m.replay_id}) — the simulated fleet drifted; re-pin "
            "EXPECTED_DIGESTS deliberately if the change is intended")
    cex = m.rediscover()
    if not cex.violations:
        problems.append(
            f"{name}: reverting the {m.historical} was NOT rediscovered "
            f"at {m.replay_id} — fleetsim stopped encoding the fix")
        return problems
    if not any(m.expect_in_violation in v for v in cex.violations):
        problems.append(
            f"{name}: rediscovered a DIFFERENT failure "
            f"({cex.violations[0]!r}) — wrong bug")
    again = m.rediscover()
    if again.digest != cex.digest or again.violations != cex.violations:
        problems.append(
            f"{name}: counterexample at {m.replay_id} did not replay "
            "byte-identically")
    if cex.digest == clean.digest:
        problems.append(
            f"{name}: mutant digest equals clean digest — the mutation "
            "never executed")
    return problems
