"""Modeled fleet components + the real-policy composition seams.

Everything a process or socket owns in production is a fluid model
here — engines serve ``capacity_qps``, workers push gradients at a
rate, PS migrations take ``moved_keys / migrate_rate`` seconds — but
every DECISION is made by the real policy code:

* :class:`SimReplica` carries exactly the health fields of
  ``serve.router._Replica`` and is driven through
  :mod:`distlr_tpu_torch.serve.balance` (selection order, ejection verdicts,
  probe backoff) — the router's policy, not a lookalike;
* :class:`SimActuators` duck-types
  :class:`~distlr_tpu_torch.autopilot.actuators.Actuators` for a REAL
  :class:`~distlr_tpu_torch.autopilot.daemon.AutopilotDaemon` (which brings
  its own sensor reduction and rate windows), raising the same
  ``ActuatorError`` when the standby pool runs dry;
* PS resizes go through the real
  :func:`~distlr_tpu_torch.ps.server.plan_reshard`;
* the per-tick ``fleet.json`` document uses the same field names
  obs-agg federates (``route_requests``, ``route_shed``,
  ``staleness_pushes_p99``, ``shard_lag``, ...), so the daemon — and
  ``launch top --replay`` — cannot tell it is simulated.  Frames carry
  ``"virtual": true``; the dashboard renders the simulated clock
  instead of wall-clock age.

Request accounting per tick: offered load (the shared
:mod:`distlr_tpu_torch.traffic` curve) spreads over in-rotation replicas;
requests landing on a replica inside a scripted fault window FAIL and
retry onto serving replicas (a retry, not an error) — with nowhere to
retry they are ERRORS (failed ACCEPTED requests, the thing the
``zero_failed_accepted`` property forbids outside fault windows).
Demand beyond serving capacity is SHED — explicit admission control,
never an error.  Overload alone never hard-fails an engine; only
scripted fault windows do.
"""

from __future__ import annotations

import dataclasses
import json

from distlr_tpu_torch.analysis.fleetsim.events import EventLoop
from distlr_tpu_torch.autopilot.actuators import ActuatorError
from distlr_tpu_torch.autopilot.daemon import AutopilotDaemon
from distlr_tpu_torch.autopilot.policy import PolicyConfig, PolicyEngine
from distlr_tpu_torch.obs.registry import MetricsRegistry
from distlr_tpu_torch.obs.slo import SLOEngine, load_slo_spec
from distlr_tpu_torch.obs.tsdb import FleetTSDB
from distlr_tpu_torch.ps.server import plan_reshard
from distlr_tpu_torch.serve import balance
from distlr_tpu_torch.traffic import qps_at

__all__ = ["FleetParams", "SimFleet", "SimPS", "SimReplica", "SimRouter",
           "SimActuators", "SimWorkers"]


def _r(v: float) -> float:
    """Canonical float for logs and fleet docs (6 decimals — formatting
    drift would break the byte-identity pin)."""
    return round(float(v), 6)


class SimReplica:
    """One modeled engine, shaped as the router's ``_Replica`` duck so
    :mod:`distlr_tpu_torch.serve.balance` drives it unmodified."""

    def __init__(self, name: str, capacity_qps: float, now: float):
        self.name = name
        self.capacity_qps = float(capacity_qps)
        # -- the balance.* health-field contract --
        self.healthy = True
        self.consecutive_errors = 0
        self.inflight = 0
        self.requests = 0
        self.errors = 0
        self.ejections = 0
        self.reinstates = 0
        self.backoff_s = 0.0
        self.next_probe_at = 0.0
        self.last_ok = now
        self.last_probe = now
        self.models = {"m"}
        # -- model state --
        self.fail_until = 0.0       # scripted fault window end
        self.capacity_factor = 1.0  # slow-burn degradation knob
        self.in_service = True      # spun up (standby pool adds delay)
        self.retired = False
        self.floor_warned = False

    def failing(self, now: float) -> bool:
        return now < self.fail_until

    def capacity(self) -> float:
        return self.capacity_qps * self.capacity_factor


class SimRouter:
    """The routing tier: real balance policy over modeled replicas."""

    def __init__(self, loop: EventLoop, replicas: list[SimReplica], *,
                 eject_after: int = 3, probe_backoff_s: float = 2.0,
                 probe_backoff_max_s: float = 30.0,
                 health_interval_s: float = 2.0, base_ms: float = 5.0):
        self.loop = loop
        self.replicas = replicas
        self.eject_after = int(eject_after)
        self.probe_backoff_s = float(probe_backoff_s)
        self.probe_backoff_max_s = float(probe_backoff_max_s)
        self.health_interval_s = float(health_interval_s)
        self.base_ms = float(base_ms)
        self._rr = -1
        self.requests_total = 0.0   # accepted (cumulative)
        self.shed_total = 0.0
        self.errors_total = 0.0     # failed ACCEPTED requests
        self.retries_total = 0.0
        self.suppressed_total = 0   # floor-suppressed ejections
        self.p99_ms = self.base_ms
        #: (t, errors) deltas, for the zero_failed_accepted property
        self.error_ticks: list[tuple[float, float]] = []

    # -- membership --------------------------------------------------------
    def pool(self) -> list[SimReplica]:
        return [r for r in self.replicas if not r.retired and r.in_service]

    def in_rotation(self) -> list[SimReplica]:
        return [r for r in self.pool() if r.healthy]

    def _pools_for(self, rep: SimReplica) -> list[list[SimReplica]]:
        return [self.pool() for _m in sorted(rep.models)]

    # -- one traffic tick --------------------------------------------------
    def tick(self, dt: float, offered_qps: float) -> None:
        now = self.loop.now
        demand = offered_qps * dt
        rot = self.in_rotation()
        if not rot:
            # nothing in rotation: accepted-at-admission requests have
            # nowhere to go — hard errors, the outage fleetsim's
            # cascade scenario pins
            self.requests_total += demand
            self.errors_total += demand
            if demand > 0:
                self.error_ticks.append((now, _r(demand)))
                self.loop.log("route_errors", n=_r(demand), reason="no_replica")
            return
        ordered, self._rr = balance.order_candidates(rot, self._rr)
        share = demand / len(ordered)
        serving: list[SimReplica] = []
        failed_demand = 0.0
        for rep in ordered:
            if rep.failing(now):
                failed_demand += share
                # each failed exchange counts toward ejection; one
                # tick's worth is capped at the threshold (the streak
                # is what matters, not the raw request count)
                for _ in range(min(max(int(share), 1), self.eject_after)):
                    balance.note_failure(rep)
                verdict = balance.eject_verdict(
                    rep, self._pools_for(rep), self.eject_after)
                if verdict == "eject":
                    balance.eject(rep, now, self.probe_backoff_s)
                    self.loop.log("eject", replica=rep.name,
                                  errors=rep.consecutive_errors)
                elif verdict == "floor" and not rep.floor_warned:
                    rep.floor_warned = True
                    self.suppressed_total += 1
                    self.loop.log("eject_suppressed", replica=rep.name)
            else:
                serving.append(rep)
        cap = sum(r.capacity() for r in serving) * dt
        if serving:
            self.retries_total += failed_demand
            demand_on_serving = demand
            errors = 0.0
        else:
            demand_on_serving = demand - failed_demand
            errors = failed_demand
        served = min(demand_on_serving, cap)
        shed = max(0.0, demand_on_serving - served)
        self.requests_total += demand
        self.shed_total += shed
        self.errors_total += errors
        if errors > 0:
            self.error_ticks.append((now, _r(errors)))
            self.loop.log("route_errors", n=_r(errors), reason="all_failing")
        util = served / cap if cap > 0 else 1.0
        self.p99_ms = self.base_ms * (1.0 + 4.0 * util ** 3)
        for rep in serving:
            balance.note_success(rep, now)
            rep.floor_warned = False
            rep.inflight = int(util * 4)
            rep.requests += 1

    # -- health probes -----------------------------------------------------
    def probe_tick(self) -> None:
        now = self.loop.now
        for rep in self.pool():
            if not balance.probe_due(rep, now, self.health_interval_s,
                                     self.probe_backoff_s):
                continue
            outcome = balance.probe_result(
                rep, not rep.failing(now), now,
                probe_backoff_s=self.probe_backoff_s,
                probe_backoff_max_s=self.probe_backoff_max_s,
                eject_after=self.eject_after,
                pools=self._pools_for(rep))
            if outcome in ("reinstated", "ejected"):
                self.loop.log(f"probe_{outcome}", replica=rep.name)


class SimPS:
    """The KV server group: real :func:`plan_reshard` arithmetic, a
    fluid migration clock."""

    def __init__(self, dim: int, num: int, *,
                 migrate_keys_per_s: float = 200_000.0):
        self.dim = int(dim)
        self.num = int(num)
        self.ranges = [(self.dim * r // self.num,
                        self.dim * (r + 1) // self.num)
                       for r in range(self.num)]
        self.migrate_keys_per_s = float(migrate_keys_per_s)
        self.busy_until = 0.0
        self.resizes = 0
        self.moved_keys_total = 0

    def busy(self, now: float) -> bool:
        return now < self.busy_until

    def start_resize(self, to: int, loop: EventLoop):
        """Plan with the REAL planner, hold ``ps_busy`` for the modeled
        migration, commit at its end.  Returns the plan."""
        plan = plan_reshard(self.dim, self.ranges, to,
                            alive=[True] * self.num)
        dur = max(0.5, plan.moved_keys / self.migrate_keys_per_s)
        self.busy_until = loop.now + dur
        self.resizes += 1
        self.moved_keys_total += plan.moved_keys
        loop.log("ps_resize", frm=self.num, to=plan.new_num_servers,
                 moved_keys=plan.moved_keys, reuse=len(plan.reuse),
                 spawn=len(plan.spawn), retire=len(plan.retire),
                 dur=_r(dur))

        def commit(p=plan):
            self.num = p.new_num_servers
            self.ranges = list(p.new_ranges)
            loop.log("ps_resize_done", num=self.num)

        loop.at(self.busy_until, commit)
        return plan


class SimWorkers:
    """The training-worker population (pushes) + the feedback drain."""

    def __init__(self, total: int, *, push_rate_per_worker: float = 2.0,
                 staleness_k: float = 0.5):
        self.total = int(total)
        self.joined = int(total)
        self.push_rate_per_worker = float(push_rate_per_worker)
        self.staleness_k = float(staleness_k)
        self.pushes_total = 0.0
        self.rejoin_events = 0

    def push_rate(self) -> float:
        return self.joined * self.push_rate_per_worker

    def staleness(self, ps_num: int) -> float:
        # async staleness grows with the worker:server ratio
        # (FASGD, arXiv:1508.05711)
        return self.staleness_k * self.joined / max(1, ps_num)


class SimActuators:
    """The Actuators duck the real daemon applies decisions through."""

    def __init__(self, fleet: "SimFleet", *, standby_engines: int = 4,
                 spinup_s: float = 2.0):
        self.fleet = fleet
        self.standby_engines = int(standby_engines)
        self.spinup_s = float(spinup_s)
        self._engine_seq = 0

    def current(self) -> dict:
        f = self.fleet
        return {"ps": f.ps.num,
                "engine": len(f.router.pool()),
                "worker": f.drain_workers,
                "ps_busy": f.ps.busy(f.loop.now)}

    def apply(self, actuator: str, to_count: int) -> str:
        f = self.fleet
        if actuator == "engine":
            cur = len(f.router.pool())
            if to_count > cur:
                if self.standby_engines <= 0:
                    raise ActuatorError(
                        "standby pool exhausted: no engine to add")
                self.standby_engines -= 1
                f.add_engine(spinup_s=self.spinup_s)
            elif to_count < cur:
                f.retire_engine()
                self.standby_engines += 1
            return f"set engine={to_count}"
        if actuator == "ps":
            f.ps.start_resize(to_count, f.loop)
            return f"set ps={to_count}"
        if actuator == "worker":
            f.drain_workers = int(to_count)
            return f"set worker={to_count}"
        raise ActuatorError(f"unknown actuator {actuator!r}")

    def close(self) -> None:
        pass


#: the default SLO spec fleetsim evaluates (the SLO engine, windows
#: shrunk onto the simulated clock): route availability as a
#: shed/requests ratio
def default_slo_spec(*, objective: float = 0.95,
                     window_s: float = 3600.0) -> dict:
    return {
        "slos": [{
            "name": "route-availability",
            "objective": objective,
            "window_s": window_s,
            "sli": {"kind": "ratio",
                    "bad": "increase(route_shed)",
                    "total": "increase(route_requests)"},
        }],
        "burn_windows": [
            {"name": "fast", "short_s": 10.0, "long_s": 20.0, "factor": 2.0},
        ],
    }


@dataclasses.dataclass
class FleetParams:
    """One scenario's fleet shape + traffic (see scenarios.py)."""

    engines: int = 4
    engine_capacity_qps: float = 25.0
    workers: int = 4
    ps: int = 2
    ps_dim: int = 1 << 14
    drain_workers: int = 2
    standby_engines: int = 4
    tick_s: float = 0.5
    control_interval_s: float = 2.0
    base_qps: float = 40.0
    peak_qps: float = 80.0
    period_s: float = 120.0
    duration_s: float = 240.0
    shard_inflow_rate: float = 4.0
    claim_rate_per_worker: float = 2.0
    eject_after: int = 3
    autopilot: bool = True
    slo: bool = True
    slo_objective: float = 0.95
    policy: PolicyConfig | None = None


class SimFleet:
    """The composition root: modeled components + real control plane,
    stepped by the event loop."""

    def __init__(self, loop: EventLoop, params: FleetParams,
                 scenario: str = "fleet"):
        self.loop = loop
        self.p = params
        self.scenario = scenario
        now = loop.now
        self._engine_seq = params.engines
        self.router = SimRouter(
            loop,
            [SimReplica(f"e{i}", params.engine_capacity_qps, now)
             for i in range(params.engines)],
            eject_after=params.eject_after)
        self.ps = SimPS(params.ps_dim, params.ps)
        self.workers = SimWorkers(params.workers)
        self.drain_workers = int(params.drain_workers)
        self.shard_lag = 2.0
        self.offered_scale = 1.0
        #: scenario hooks (t -> rate); None = the built-in defaults
        self.shard_inflow = None
        self.claim_capacity = None
        # rank-second accounting (the rank_seconds property)
        self.rank_seconds = 0.0
        self.peak_ranks = 0
        # real observability plane on the virtual clock
        self.tsdb = FleetTSDB()
        self.registry = MetricsRegistry()
        self.slo_engine = SLOEngine(load_slo_spec(default_slo_spec(
            objective=params.slo_objective))) if params.slo else None
        self.slo_alerts: list[dict] = []
        self.slo_summaries: list[dict] = []
        self.latest_doc: dict = {"updated": 0.0, "ranks": []}
        self.history: list[dict] = []
        self.daemon: AutopilotDaemon | None = None
        self.decisions: list = []
        #: zero-arg callables run_scenario invokes after the run
        #: (tempdir removal for the real spool/joiner composition)
        self.cleanups: list = []
        if params.autopilot:
            self.daemon = AutopilotDaemon(
                PolicyEngine(params.policy or PolicyConfig()),
                SimActuators(self, standby_engines=params.standby_engines),
                fetch=lambda: self.latest_doc,
                alert_poll=self._firing_alert_names,
                clock=lambda: loop.now)

    # -- engine membership (actuator seam) ---------------------------------
    def add_engine(self, *, spinup_s: float = 2.0) -> SimReplica:
        rep = SimReplica(f"e{self._engine_seq}",
                         self.p.engine_capacity_qps, self.loop.now)
        self._engine_seq += 1
        rep.in_service = False
        self.router.replicas.append(rep)

        def up(r=rep):
            r.in_service = True
            self.loop.log("engine_up", replica=r.name)

        self.loop.after(spinup_s, up)
        return rep

    def retire_engine(self) -> None:
        pool = self.router.pool()
        if len(pool) <= 1:
            return
        rep = pool[-1]
        rep.retired = True
        self.loop.log("engine_retired", replica=rep.name)

    # -- faults (the chaos alphabet's delay/reset analogues) ---------------
    def degrade_all(self, until: float) -> None:
        for rep in self.router.pool():
            rep.fail_until = max(rep.fail_until, until)
        self.loop.log("fault", fault="brownout", until=_r(until))

    # -- observability -----------------------------------------------------
    def _firing_alert_names(self) -> list[str]:
        return [f"{a['name']}{{slo={a['labels'].get('slo', '?')}}}"
                for a in self.slo_alerts if a.get("firing")]

    def fleet_doc(self) -> dict:
        now = self.loop.now
        pool = self.router.pool()
        up = self.router.in_rotation()
        ranks = [{
            "role": "router", "rank": 0, "state": "up",
            "route_requests": _r(self.router.requests_total),
            "route_shed": _r(self.router.shed_total),
            "route_errors": _r(self.router.errors_total),
            "route_p99_ms": _r(self.router.p99_ms),
            "replicas_up": len(up),
        }, {
            "role": "trainer", "rank": 0, "state": "up",
            "pushes": _r(self.workers.pushes_total),
            "staleness_pushes_p99": _r(self.workers.staleness(self.ps.num)),
            "workers_joined": self.workers.joined,
        }, {
            "role": "joiner", "rank": 0, "state": "up",
            "shard_lag": _r(self.shard_lag),
        }]
        ranks += [{"role": "engine", "rank": i,
                   "state": "up" if (r.healthy and r.in_service) else "down",
                   "requests": r.requests, "errors": r.errors}
                  for i, r in enumerate(self.router.replicas)
                  if not r.retired]
        return {
            "updated": _r(now),
            "virtual": True,
            "run_dir": f"fleetsim:{self.scenario}",
            "totals": {"ranks": len(ranks),
                       "up": 3 + sum(1 for r in pool if r.healthy),
                       "samples_per_s": _r(self.offered(now))},
            "alerts": [a for a in self.slo_alerts if a.get("firing")],
            "slo": self.slo_summaries,
            "ranks": ranks,
        }

    def offered(self, t: float) -> float:
        return self.offered_scale * qps_at(
            t, self.p.base_qps, self.p.peak_qps, self.p.period_s)

    # -- the two periodic loops --------------------------------------------
    def traffic_tick(self) -> None:
        now, dt = self.loop.now, self.p.tick_s
        self.router.tick(dt, self.offered(now))
        self.router.probe_tick()
        self.workers.pushes_total += self.workers.push_rate() * dt
        inflow = (self.shard_inflow(now) if self.shard_inflow
                  else self.p.shard_inflow_rate)
        claim = (self.claim_capacity(now) if self.claim_capacity
                 else self.drain_workers * self.p.claim_rate_per_worker)
        self.shard_lag = max(0.0, self.shard_lag + (inflow - claim) * dt)
        ranks = len(self.router.pool()) + self.ps.num + self.drain_workers
        self.rank_seconds += ranks * dt
        self.peak_ranks = max(self.peak_ranks, ranks)

    def control_tick(self) -> None:
        now = self.loop.now
        doc = self.fleet_doc()
        self.latest_doc = doc
        self.history.append(doc)
        self.tsdb.ingest(doc)
        if self.slo_engine is not None:
            alerts: list[dict] = []
            self.slo_summaries = self.slo_engine.evaluate(
                self.tsdb, self.registry, now, alerts)
            fired_before = {a["labels"].get("window")
                            for a in self.slo_alerts if a.get("firing")}
            self.slo_alerts = alerts
            for a in alerts:
                w = a["labels"].get("window")
                if a.get("firing") and w not in fired_before:
                    self.loop.log("slo_burn_firing", window=str(w))
        if self.daemon is not None:
            d = self.daemon.tick_once()
            self.decisions.append(d)
            if d.rule not in ("steady",):
                self.loop.log("autopilot", rule=d.rule,
                              action=d.action.to_doc() if d.action else None,
                              outcome=d.outcome)

    def schedule(self) -> None:
        """Install the periodic loops through ``duration_s``."""
        self.loop.every(self.p.tick_s, self.traffic_tick,
                        until=self.p.duration_s)
        self.loop.every(self.p.control_interval_s, self.control_tick,
                        until=self.p.duration_s)

    # -- summary -----------------------------------------------------------
    def actions(self) -> list[dict]:
        return [json.loads(d.to_json())
                for d in self.decisions if d.action is not None]

    def summary(self) -> dict:
        return {
            "requests": _r(self.router.requests_total),
            "shed": _r(self.router.shed_total),
            "errors": _r(self.router.errors_total),
            "retries": _r(self.router.retries_total),
            "eject_suppressed": self.router.suppressed_total,
            "engines": len(self.router.pool()),
            "ps": self.ps.num,
            "ps_resizes": self.ps.resizes,
            "workers_joined": self.workers.joined,
            "rejoin_events": self.workers.rejoin_events,
            "shard_lag": _r(self.shard_lag),
            "rank_seconds": _r(self.rank_seconds),
            "peak_ranks": self.peak_ranks,
            "actions": len(self.actions()),
            "budget_remaining": (self.slo_summaries[0]["budget_remaining"]
                                 if self.slo_summaries else None),
        }
