"""The autopilot's decision core: pure, deterministic, clock-injected
(the port's copy of ``distlr_tpu/autopilot/policy.py``).

This module is the half of the control loop that is allowed to be
clever, because it is the half that can be TESTED exhaustively: no
sockets, no processes, no wall clock — :class:`PolicyEngine` consumes
a :class:`FleetSignals` snapshot plus the current actuator counts and
an injected ``now``, and returns a :class:`Decision`.  Same input
sequence, same decisions, byte-identical journal lines (the
determinism contract ``tests/test_torch_autopilot.py`` holds against the
JAX package's engine).  Everything
effectful — the ps-ctl wire, router admin lines, worker subprocesses
— lives in :mod:`distlr_tpu_torch.autopilot.actuators`, behind the daemon.

Control shape (one action per tick, fixed priority):

1. **Unreachable aggregator** -> hold.  Acting blind is how an
   autoscaler turns an observability outage into a fleet outage; the
   same fail-safe stance as the rollout gater's synthetic
   ``rollout_fleet_unreachable`` alert.
2. **Any bound alert firing** -> if the most recent action is young
   enough to blame (:attr:`PolicyConfig.rollback_window_s`), roll it
   back and freeze every actuator for a cooldown.  When NO action can
   be blamed the alert is evidence of under-provisioning, not
   mis-actuation: capacity ADDS stay allowed (and are never rollback
   candidates — they were taken under an already-firing alert),
   removals are suppressed, and an idle tick holds.  The pre-fix
   freeze-everything stance deadlocked on slow burns: a gradual
   degradation fires the SLO alert forever, the frozen controller can
   never add the engine that would clear it, and the error budget
   drains to zero (fleetsim ``slow_burn_slo``).
3. **Bands, in priority order** ``ps`` -> ``engine`` -> ``worker``:
   the PS group is the quality knob (Hogwild convergence degrades with
   staleness τ — PAPERS.md), so it outranks serving capacity, which
   outranks feedback drain.  A signal must breach its band for
   :attr:`PolicyConfig.hysteresis_ticks` CONSECUTIVE ticks before an
   action fires (flapping costs a reshard / a replica churn), each
   actuator then holds for :attr:`PolicyConfig.cooldown_s`, and targets
   clamp to the per-actuator [min, max] bounds.

Scale-up triggers may ride cumulative percentiles (a latched-high
staleness p99 erring toward capacity is safe); scale-DOWN triggers use
only windowed rates and live gauges, because a cumulative histogram
never forgets the peak.
"""

from __future__ import annotations

import dataclasses
import json

#: actuators in arbitration priority order (first breach wins the tick)
ACTUATORS = ("ps", "engine", "worker")

#: the synthetic alert name an unreachable aggregator reports
#: (:func:`distlr_tpu_torch.serve.rollout.fleet_alert_poller`); it HOLDS the
#: autopilot rather than triggering a rollback — no evidence, no action
UNREACHABLE_ALERT = "rollout_fleet_unreachable"

#: flap damping (fleetsim ``autopilot_resonance``): a direction
#: REVERSAL within this many cooldowns of the previous action on the
#: same actuator doubles that actuator's next cooldown, compounding up
#: to ``2**FLAP_STREAK_MAX``.  An offered load sitting between the
#: scale-down and scale-up thresholds of adjacent counts otherwise
#: drives up/down/up/down at exactly the cooldown cadence — each cycle
#: a replica churn — while the escalating hold stretches the
#: oscillation period until the diurnal curve moves off the resonant
#: point.  Same-direction repeats (a genuine ramp) never pay it.
FLAP_WINDOW_COOLDOWNS = 10
FLAP_STREAK_MAX = 3


@dataclasses.dataclass(frozen=True)
class FleetSignals:
    """One tick's sensor snapshot, already reduced to scalars by the
    daemon (fleet.json rows + windowed rates from successive polls /
    ``history.jsonl``).  ``None`` means "no data" — a band with no data
    never fires in either direction."""

    #: the aggregator answered this tick's poll
    reachable: bool = True
    #: firing bound-alert names (``name{labels}`` strings)
    alerts: tuple[str, ...] = ()
    #: max over trainer rows of the cumulative staleness-pushes p99
    staleness_pushes_p99: float | None = None
    #: windowed ok-push rate over the whole fleet, pushes/s
    push_rate: float | None = None
    #: windowed admission-shed rate at the routing tier, sheds/s
    shed_rate: float | None = None
    #: cumulative route p99 latency (safety up-trigger only)
    route_p99_ms: float | None = None
    #: windowed accepted-request rate at the routing tier, req/s
    req_rate: float | None = None
    #: current unclaimed feedback shards (distlr_feedback_shard_lag)
    shard_lag: float | None = None


@dataclasses.dataclass(frozen=True)
class Action:
    actuator: str          # "ps" | "engine" | "worker"
    direction: str         # "up" | "down"
    from_count: int
    to_count: int

    def to_doc(self) -> dict:
        return {"actuator": self.actuator, "direction": self.direction,
                "from": self.from_count, "to": self.to_count}


@dataclasses.dataclass
class Decision:
    """One tick's full audit record — what the journal line carries.
    ``outcome`` is filled by the daemon after the actuator ran (it
    stays None in pure-policy runs, keeping the determinism contract
    independent of execution)."""

    t: float
    tick: int
    rule: str
    action: Action | None
    inputs: dict
    holding: dict
    outcome: str | None = None

    def to_doc(self) -> dict:
        return {
            "t": round(self.t, 3),
            "tick": self.tick,
            "rule": self.rule,
            "action": self.action.to_doc() if self.action else None,
            "inputs": self.inputs,
            "holding": self.holding,
            "outcome": self.outcome,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_doc(), sort_keys=True)


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Bands, bounds, and damping — the knobs ``launch autopilot``
    exposes (Config ``autopilot_*`` fields)."""

    hysteresis_ticks: int = 2
    cooldown_s: float = 10.0
    rollback_window_s: float = 60.0
    ps_min: int = 1
    ps_max: int = 8
    engine_min: int = 1
    engine_max: int = 8
    worker_min: int = 1
    worker_max: int = 8
    staleness_high: float = 64.0
    push_rate_high: float = 200.0
    push_rate_low: float = 20.0
    shed_rate_high: float = 0.5
    route_p99_high_ms: float = 250.0
    req_rate_low: float = 5.0
    lag_high: float = 4.0
    lag_low: float = 1.0

    @classmethod
    def from_config(cls, cfg) -> "PolicyConfig":
        """Lift the flat ``autopilot_*`` Config fields."""
        return cls(**{f.name: getattr(cfg, f"autopilot_{f.name}")
                      for f in dataclasses.fields(cls)})

    def bounds(self, actuator: str) -> tuple[int, int]:
        return (getattr(self, f"{actuator}_min"),
                getattr(self, f"{actuator}_max"))


def _round(v: float | None) -> float | None:
    return None if v is None else round(float(v), 3)


class PolicyEngine:
    """Deterministic band controller; see the module docstring for the
    rule order.  All state is tick-local bookkeeping (consecutive
    breach counters, per-actuator cooldown stamps, the last action for
    rollback attribution) — nothing reads a real clock or randomness."""

    def __init__(self, cfg: PolicyConfig | None = None):
        self.cfg = cfg or PolicyConfig()
        self.tick_count = 0
        #: actuator -> injected-clock time of its last action
        self._cooldown_until: dict[str, float] = {}
        #: (actuator, direction) -> consecutive ticks in breach
        self._breach: dict[tuple[str, str], int] = {}
        #: the youngest action (for rollback-on-alert attribution)
        self._last_action: Action | None = None
        self._last_action_t: float = float("-inf")
        self._rolled_back = True  # nothing to roll back yet
        #: actuator -> (direction, time) of its last action, and the
        #: running reversal streak that escalates its cooldown
        self._last_dir: dict[str, tuple[str, float]] = {}
        self._flap_streak: dict[str, int] = {}

    # -- helpers -----------------------------------------------------------
    def _holding(self, now: float) -> dict:
        return {a: bool(now < self._cooldown_until.get(a, float("-inf")))
                for a in ACTUATORS}

    def _arm(self, key: tuple[str, str], breaching: bool) -> bool:
        """Advance the consecutive-breach counter for ``key``; True when
        hysteresis is satisfied.  Counters keep accumulating through
        cooldowns, so a persistent breach fires the moment the hold
        clears instead of re-waiting the full hysteresis."""
        if breaching:
            self._breach[key] = self._breach.get(key, 0) + 1
        else:
            self._breach[key] = 0
        return self._breach[key] >= self.cfg.hysteresis_ticks

    def _act(self, actuator: str, direction: str, current: int,
             now: float) -> Action:
        lo, hi = self.cfg.bounds(actuator)
        target = max(lo, min(hi, current + (1 if direction == "up" else -1)))
        act = Action(actuator, direction, current, target)
        prev = self._last_dir.get(actuator)
        if (prev is not None and prev[0] != direction
                and now - prev[1]
                <= FLAP_WINDOW_COOLDOWNS * self.cfg.cooldown_s):
            self._flap_streak[actuator] = min(
                self._flap_streak.get(actuator, 0) + 1, FLAP_STREAK_MAX)
        else:
            self._flap_streak[actuator] = 0
        self._last_dir[actuator] = (direction, now)
        self._cooldown_until[actuator] = now + self.cfg.cooldown_s * (
            2 ** self._flap_streak[actuator])
        # the action changes the very state both counters measured
        self._breach[(actuator, "up")] = 0
        self._breach[(actuator, "down")] = 0
        self._last_action, self._last_action_t = act, now
        self._rolled_back = False
        return act

    def _on_alert(self, current: dict,
                  now: float) -> tuple[str, Action | None] | None:
        """Arbitrate a firing bound alert.  Returns the decided
        ``(rule, action)`` when the youngest action is young enough to
        blame (freeze everything, undo it), or ``None`` when nobody is
        blamable — the tick then runs in capacity-only mode instead of
        freezing a fleet whose alert no rollback can clear."""
        c = self.cfg
        last = self._last_action
        if (last is None or self._rolled_back
                or now - self._last_action_t > c.rollback_window_s):
            return None
        # the youngest action plausibly caused this: undo it while the
        # fleet heals behind a full freeze
        for a in ACTUATORS:
            self._cooldown_until[a] = now + c.cooldown_s
        self._breach.clear()
        if current.get(last.actuator) is None:
            # count unknown: hold, but keep the blame armed so the
            # rollback fires as soon as the actuator is readable again
            return ("hold_on_alert", None)
        lo, hi = c.bounds(last.actuator)
        target = max(lo, min(hi, last.from_count))
        cur = int(current[last.actuator])
        self._rolled_back = True
        if target != cur:
            return ("rollback_on_alert",
                    Action(last.actuator, "down" if target < cur else "up",
                           cur, target))
        return ("hold_on_alert", None)

    # -- the tick ----------------------------------------------------------
    def tick(self, signals: FleetSignals, current: dict,
             now: float) -> Decision:
        """``current`` maps actuator -> live count (None = unknown,
        that actuator holds) plus an optional ``ps_busy`` bool (a
        resize still migrating; never stack a second one)."""
        self.tick_count += 1
        c = self.cfg
        inputs = {
            "reachable": signals.reachable,
            "alerts": list(signals.alerts),
            "staleness_pushes_p99": _round(signals.staleness_pushes_p99),
            "push_rate": _round(signals.push_rate),
            "shed_rate": _round(signals.shed_rate),
            "route_p99_ms": _round(signals.route_p99_ms),
            "req_rate": _round(signals.req_rate),
            "shard_lag": _round(signals.shard_lag),
            "current": {a: current.get(a) for a in ACTUATORS},
            "ps_busy": bool(current.get("ps_busy")),
        }

        def decide(rule: str, action: Action | None = None) -> Decision:
            return Decision(t=now, tick=self.tick_count, rule=rule,
                            action=action, inputs=inputs,
                            holding=self._holding(now))

        # 1. no evidence, no action — an unreachable observability
        # plane must never be answered with blind scaling
        if not signals.reachable or UNREACHABLE_ALERT in signals.alerts:
            self._breach.clear()
            return decide("hold_unreachable")

        # 2. a firing bound alert: undo the youngest action while it is
        # still plausibly the cause, then freeze everything for a
        # cooldown — the fleet heals before the controller moves again.
        # With nobody to blame, the alert is the symptom of missing
        # capacity: fall through in capacity-only mode (adds allowed,
        # removals suppressed) instead of freezing into the deadlock
        # fleetsim's slow_burn_slo scenario pins.
        alert_capacity_only = False
        if signals.alerts:
            decided = self._on_alert(current, now)
            if decided is not None:
                return decide(decided[0], decided[1])
            alert_capacity_only = True

        # 3. bands, fixed priority; every counter advances every tick
        # (an early actuator's action must not stall a later actuator's
        # hysteresis), then the first actionable breach wins
        bands = (
            ("ps",
             (signals.staleness_pushes_p99 is not None
              and signals.staleness_pushes_p99 > c.staleness_high)
             or (signals.push_rate is not None
                 and current.get("ps")
                 and signals.push_rate / current["ps"] > c.push_rate_high),
             (signals.push_rate is not None
              and current.get("ps")
              and signals.push_rate / current["ps"] < c.push_rate_low)),
            ("engine",
             (signals.shed_rate is not None
              and signals.shed_rate > c.shed_rate_high)
             or (signals.route_p99_ms is not None
                 and signals.route_p99_ms > c.route_p99_high_ms),
             (signals.req_rate is not None
              and (signals.shed_rate or 0.0) == 0.0
              and current.get("engine")
              and signals.req_rate / current["engine"] < c.req_rate_low)),
            ("worker",
             (signals.shard_lag is not None
              and signals.shard_lag > c.lag_high),
             (signals.shard_lag is not None
              and signals.shard_lag < c.lag_low)),
        )
        armed = {(a, d): self._arm((a, d), bool(b))
                 for a, up, down in bands
                 for d, b in (("up", up), ("down", down))}
        for actuator, _up, _down in bands:
            cur = current.get(actuator)
            if cur is None:
                continue
            if actuator == "ps" and current.get("ps_busy"):
                continue  # a resize is still migrating
            if now < self._cooldown_until.get(actuator, float("-inf")):
                continue
            lo, hi = c.bounds(actuator)
            if armed[(actuator, "up")] and cur < hi:
                act = self._act(actuator, "up", int(cur), now)
                if alert_capacity_only:
                    # an add taken under an already-firing alert cannot
                    # have caused it — never a rollback candidate
                    self._rolled_back = True
                return decide(f"{actuator}_up", act)
            if (not alert_capacity_only
                    and armed[(actuator, "down")] and cur > lo):
                return decide(f"{actuator}_down",
                              self._act(actuator, "down", int(cur), now))
        return decide("hold_on_alert" if alert_capacity_only else "steady")
