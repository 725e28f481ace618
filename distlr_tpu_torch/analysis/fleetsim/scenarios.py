"""The scripted fleet-scale scenarios and the replay entry point.

Each scenario wires a :class:`~distlr_tpu_torch.analysis.fleetsim.models.
SimFleet` (modeled processes, REAL policies), schedules its fault /
traffic script on the event loop, and names the properties that must
hold.  ``run_scenario(name, seed)`` executes one and returns a
:class:`Result` whose ``digest`` is byte-stable for a given
``(scenario, seed)`` — the replay id ``fleetsim:<scenario>:<seed>``
reproduces it exactly (``--replay``), which is how counterexamples
stay pinned after their policy fix lands (see ``mutants.py``).
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile

from distlr_tpu_torch.analysis.fleetsim.events import EventLoop
from distlr_tpu_torch.analysis.fleetsim.models import (
    FleetParams,
    SimFleet,
    _r,
)
from distlr_tpu_torch.analysis.fleetsim import props
from distlr_tpu_torch.autopilot.policy import PolicyConfig
from distlr_tpu_torch.feedback.join import LabelJoiner
from distlr_tpu_torch.feedback.spool import FeedbackSpool, SpoolRecord
from distlr_tpu_torch.ps.server import plan_reshard
from distlr_tpu_torch.traffic import LabelDelay, ZipfSampler

__all__ = ["SCENARIOS", "Result", "Scenario", "parse_replay_id",
           "run_scenario"]


# ---------------------------------------------------------------------------
# scenario constructors — each returns (fleet, [prop thunks])
# ---------------------------------------------------------------------------

def _partition_heal_1000(loop: EventLoop):
    """1000 workers drop on a partition and rejoin with jittered
    backoff when it heals; the REAL spool/joiner machinery runs the
    label window underneath, and the autopilot rides the push-rate and
    shard-lag bands down and back up (rank-seconds must beat static
    peak provisioning)."""
    p = FleetParams(
        engines=4, workers=1000, ps=16, ps_dim=1 << 14,
        duration_s=240.0, base_qps=40.0, peak_qps=60.0,
        shard_inflow_rate=5.0,
        policy=PolicyConfig(ps_max=32, worker_max=8),
    )
    fleet = SimFleet(loop, p, "partition_heal_1000")
    fleet.workers.push_rate_per_worker = 2.5
    fleet.workers.staleness_k = 0.25
    # feedback drain capacity follows the joined training workers
    # (online trainers claim shards) plus the autopilot's drain pool
    fleet.claim_capacity = lambda t: (
        fleet.workers.joined * 0.05
        + fleet.drain_workers * p.claim_rate_per_worker)

    def partition():
        fleet.workers.joined = 0
        loop.log("partition", workers=fleet.workers.total)

    def heal():
        loop.log("heal", rejoining=fleet.workers.total)
        for _ in range(fleet.workers.total):
            loop.after(loop.rng.uniform(0.0, 20.0), rejoin)

    def rejoin():
        fleet.workers.joined += 1
        fleet.workers.rejoin_events += 1
        if fleet.workers.joined % 100 == 0:
            loop.log("rejoined", joined=fleet.workers.joined)

    loop.at(30.0, partition)
    loop.at(90.0, heal)

    # -- the REAL label window machinery, on virtual timestamps --
    spool_dir = tempfile.mkdtemp(prefix="fleetsim-spool-")
    out_dir = tempfile.mkdtemp(prefix="fleetsim-shards-")
    spool = FeedbackSpool(spool_dir, capacity=4096)
    joiner = LabelJoiner(spool, out_dir, window_s=60.0,
                         negative_rate=0.25, shard_records=64, seed=7)
    fleet.cleanups += [lambda: shutil.rmtree(spool_dir, ignore_errors=True),
                       lambda: shutil.rmtree(out_dir, ignore_errors=True)]
    delay = LabelDelay(2.0, 30.0)
    outcomes = {"joined": 0, "pending": 0, "duplicate": 0}

    def label(i: int):
        outcomes[joiner.label(f"r{i}", 1, ts=loop.now)] += 1

    def score(i: int):
        joiner.scored(SpoolRecord(rid=f"r{i}", ts=loop.now, line="1:1",
                                  score=0.5, version=1))
        loop.after(delay.sample(loop.rng), label, i)

    for i in range(480):
        loop.at(i * 0.5, score, i)
    loop.every(5.0, lambda: joiner.tick(now=loop.now), until=p.duration_s)
    loop.every(30.0, lambda: loop.log(
        "joiner", joined=joiner.joined, negatives=joiner.negatives,
        shards=joiner.shards_written, spooled=len(spool)),
        until=p.duration_s)
    fleet.cleanups.append(lambda: loop.log(
        "joiner_final", joined=joiner.joined, negatives=joiner.negatives,
        shards=joiner.shards_written, outcomes=outcomes))

    return fleet, [
        lambda f: props.all_rejoined(f, deadline_s=p.duration_s),
        lambda f: props.no_flapping(f, actuator="worker", max_reversals=4),
        lambda f: props.no_flapping(f, actuator="ps", max_reversals=4),
        lambda f: props.zero_failed_accepted(f, allowed_until=0.0),
        lambda f: props.rank_seconds_bounded(f, slack=0.9),
    ]


def _reshard_64_to_96_zipf(loop: EventLoop):
    """A 64 -> 96 membership resize planned by the REAL planner under
    Zipf-hot traffic: the plan must exactly tile the new layout and the
    hottest new rank must carry no more load than the hottest old one
    (the head of the Zipf curve splits, never concentrates)."""
    p = FleetParams(engines=4, workers=128, ps=64, ps_dim=1 << 16,
                    duration_s=60.0, autopilot=False, slo=False)
    fleet = SimFleet(loop, p, "reshard_64_to_96_zipf")
    fleet.ps.migrate_keys_per_s = 20_000.0
    sampler = ZipfSampler(p.ps_dim, alpha=1.05)
    old_ranges = list(fleet.ps.ranges)
    hot_before = max(sampler.mass(lo, hi) for lo, hi in old_ranges)
    state: dict = {}

    def resize():
        loop.log("zipf_hot", hottest_old=_r(hot_before))
        state["plan"] = fleet.ps.start_resize(96, loop)

    loop.at(20.0, resize)

    def check(_f):
        if "plan" not in state:
            return ["reshard: the resize never ran"]
        return props.reshard_converged(
            state["plan"], p.ps_dim, old_ranges,
            sampler=sampler, max_hot_share=hot_before)

    def committed(f):
        if f.ps.num != 96:
            return [f"reshard: expected 96 ranks at end, got {f.ps.num}"]
        return []

    return fleet, [check, committed]


def _cascade_eject_canary(loop: EventLoop):
    """A transient brownout degrades every engine mid-canary-ramp with
    the standby pool empty.  The pre-fix router ejected ALL of them and
    kept serving nothing for a full probe backoff after the fault
    cleared; the ejection floor (serve.balance.may_eject) must keep the
    last replica in rotation so recovery is immediate."""
    p = FleetParams(engines=4, workers=8, ps=2, duration_s=90.0,
                    base_qps=60.0, peak_qps=60.0, standby_engines=0,
                    slo=False)
    fleet = SimFleet(loop, p, "cascade_eject_canary")
    loop.at(20.0, lambda: fleet.add_engine())        # the canary ramp
    loop.at(25.0, lambda: fleet.add_engine())
    fault_end = 52.0
    loop.at(40.0, lambda: fleet.degrade_all(fault_end))
    return fleet, [
        # one tick of grace past the fault for in-flight accounting
        lambda f: props.zero_failed_accepted(
            f, allowed_until=fault_end + 2 * p.tick_s),
    ]


def _autopilot_resonance(loop: EventLoop):
    """Offered load parked between the scale-down and scale-up
    thresholds of adjacent engine counts, at a diurnal period resonant
    with the cooldown: the pre-fix controller flips up/down/up at the
    cooldown cadence forever; flap damping must stretch the oscillation
    instead."""
    p = FleetParams(
        engines=2, workers=8, ps=2, duration_s=200.0,
        base_qps=26.0, peak_qps=30.0, period_s=80.0, slo=False,
        policy=PolicyConfig(hysteresis_ticks=2, cooldown_s=6.0,
                            req_rate_low=15.0, engine_max=4),
    )
    fleet = SimFleet(loop, p, "autopilot_resonance")
    return fleet, [
        lambda f: props.no_flapping(f, actuator="engine", max_reversals=10),
        lambda f: props.zero_failed_accepted(f, allowed_until=0.0),
    ]


def _slow_burn_slo(loop: EventLoop):
    """A sudden deep capacity loss (factor 0.1) starts an SLO burn.
    The controller's adds land, then the long-window burn alert fires
    mid-recovery and blames the youngest one — the rollback makes
    things WORSE, and the pre-fix policy then froze every actuator
    while the alert kept firing, burning the error budget to
    exhaustion.  The capacity-only alert mode must re-add engines
    until the burn clears."""
    p = FleetParams(
        engines=3, workers=8, ps=2, duration_s=200.0,
        base_qps=55.0, peak_qps=55.0, standby_engines=5,
        slo_objective=0.9,
        policy=PolicyConfig(hysteresis_ticks=2, cooldown_s=6.0),
    )
    fleet = SimFleet(loop, p, "slow_burn_slo")

    def degrade():
        for rep in fleet.router.pool():
            rep.capacity_factor = 0.1
        loop.log("fault", fault="capacity_loss", factor=0.1)

    loop.at(40.0, degrade)

    def capacity_added(f):
        if len(f.router.pool()) < 4:
            return ["slow_burn: the controller never added capacity "
                    "while the burn alert fired"]
        return []

    return fleet, [
        lambda f: props.slo_budget_held(f),
        capacity_added,
        lambda f: props.zero_failed_accepted(f, allowed_until=0.0),
    ]


def _standby_exhaustion(loop: EventLoop):
    """The diurnal peak demands more engines than the standby pool
    holds: the actuator raises, the daemon journals ``error:``
    outcomes and HOLDS — no crash, no failed accepted requests, and
    the controller still breathes back down after the peak."""
    p = FleetParams(
        engines=2, workers=8, ps=2, duration_s=180.0,
        base_qps=40.0, peak_qps=120.0, period_s=120.0,
        standby_engines=1, slo=False,
        policy=PolicyConfig(hysteresis_ticks=2, cooldown_s=6.0,
                            req_rate_low=8.0),
    )
    fleet = SimFleet(loop, p, "standby_exhaustion")

    def exhausted_surfaced(f):
        errs = [d for d in f.decisions
                if d.outcome and d.outcome.startswith("error:")]
        if not errs:
            return ["standby: the pool never exhausted — the scenario "
                    "lost its point"]
        return []

    return fleet, [
        exhausted_surfaced,
        lambda f: props.zero_failed_accepted(f, allowed_until=0.0),
        lambda f: props.no_flapping(f, actuator="engine", max_reversals=6),
    ]


def _power_loss_durable(loop: EventLoop):
    """The whole PS group loses power mid-push (the DR drill at
    fleet scale): every rank dies at the same instant, cold-restarts
    from its durable store, and resumes at its persisted push clock.
    Odd ranks run the push WAL (durable clock tracks the applied clock
    — RPO 0); even ranks are snapshot-only (loss bounded by one
    snapshot interval); and rank 0's NEWEST snapshot generation is torn
    by the cut mid-write, so its recovery must fall back one generation
    (the 2-generation design: loss bounded by TWO intervals, never a
    refusal to start, never a silent restore of the corrupt file).
    RTO is the span from the cut to the LAST rank back."""
    p = FleetParams(engines=2, workers=256, ps=8, ps_dim=1 << 14,
                    duration_s=120.0, base_qps=20.0, peak_qps=30.0,
                    autopilot=False, slo=False)
    fleet = SimFleet(loop, p, "power_loss_durable")
    interval_s = 5.0
    # mid-interval on purpose: a cut ON a snapshot boundary loses
    # nothing and proves nothing (the losses_realistic prop pins this)
    t_kill = 62.7
    ranks = [{
        "mode": "wal" if r % 2 else "snap",
        "applied": 0.0,            # the rank's push clock
        "snapshots": [0.0, 0.0],   # the 2 on-disk generations (clocks)
        "durable": 0.0,            # what a cold restart recovers to
        "up": True,
        "recovered_at": None,
        "lost": None,
        "rpo_bound": None,
    } for r in range(p.ps)]
    dr = {"t_kill": t_kill, "interval_s": interval_s, "ranks": ranks,
          "rto_s": None, "rate_per_rank": 0.0}
    fleet.dr = dr

    def push_tick():
        rate = fleet.workers.push_rate() / p.ps
        dr["rate_per_rank"] = rate
        for r in ranks:
            if r["up"]:
                r["applied"] += rate * p.tick_s
                if r["mode"] == "wal":
                    # group-commit fsync (default 0.1s) << tick: the
                    # WAL's durable clock tracks the applied clock
                    r["durable"] = r["applied"]

    def snapshot_tick():
        for r in ranks:
            if r["up"]:
                r["snapshots"] = [r["snapshots"][1], r["applied"]]
                if r["mode"] == "snap":
                    r["durable"] = r["applied"]
        loop.log("store_snapshot", clock=_r(ranks[0]["applied"]))

    loop.every(p.tick_s, push_tick, until=p.duration_s)
    loop.every(interval_s, snapshot_tick, until=p.duration_s)

    def recover(i: int):
        r = ranks[i]
        r["up"] = True
        r["applied"] = r["durable"]
        r["recovered_at"] = loop.now
        loop.log("rank_recovered", rank=i, mode=r["mode"],
                 clock=_r(r["applied"]), lost=_r(r["lost"]))
        if all(x["up"] for x in ranks):
            dr["rto_s"] = loop.now - t_kill
            fleet.workers.joined = fleet.workers.total  # clients resume
            loop.log("fleet_recovered", rto_s=_r(dr["rto_s"]))

    def power_loss():
        rate = dr["rate_per_rank"]
        loop.log("power_loss", ranks=p.ps, rate_per_rank=_r(rate))
        for i, r in enumerate(ranks):
            r["up"] = False
            generations = 1
            if i == 0:
                # the snapshot write in flight at the cut is torn: CRC
                # rejects the newest generation, recovery restores the
                # previous one
                r["snapshots"][1] = r["snapshots"][0]
                if r["mode"] == "snap":
                    r["durable"] = r["snapshots"][0]
                generations = 2
            r["lost"] = r["applied"] - r["durable"]
            r["rpo_bound"] = (0.0 if r["mode"] == "wal"
                              else rate * (interval_s * generations
                                           + p.tick_s))
            # staggered cold restart: respawn + snapshot load, plus WAL
            # replay time for the WAL ranks
            delay = 1.0 + loop.rng.uniform(0.0, 2.0) + (
                0.5 if r["mode"] == "wal" else 0.0)
            loop.after(delay, recover, i)
        fleet.workers.joined = 0  # every push stream broke at once

    loop.at(t_kill, power_loss)

    def losses_realistic(_f):
        # the scenario must actually exercise its point: snapshot ranks
        # lose real pushes, the torn rank loses MORE than an untorn one
        if not any(r["mode"] == "snap" and r["lost"] and i > 0
                   for i, r in enumerate(ranks)):
            return ["power_loss: no snapshot-only rank lost anything — "
                    "the cut landed on a snapshot boundary and proved "
                    "nothing"]
        untorn = max(r["lost"] for i, r in enumerate(ranks)
                     if r["mode"] == "snap" and i > 0)
        if ranks[0]["lost"] <= untorn:
            return ["power_loss: the torn-generation rank lost no more "
                    "than an untorn one — the fallback never engaged"]
        return []

    return fleet, [
        lambda f: props.rto_bounded(f, max_rto_s=5.0),
        props.rpo_bounded,
        losses_realistic,
        lambda f: props.all_rejoined(f, deadline_s=p.duration_s),
    ]


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    describe: str
    build: object  # (EventLoop) -> (SimFleet, [prop thunks])


SCENARIOS: dict[str, Scenario] = {
    s.name: s for s in (
        Scenario("partition_heal_1000",
                 "1000 workers rejoin after a partition heals "
                 "(joiner/spool + ps/worker bands + rank-seconds)",
                 _partition_heal_1000),
        Scenario("reshard_64_to_96_zipf",
                 "64 -> 96 membership resize under Zipf-hot traffic "
                 "(real planner, closed-form hot-share check)",
                 _reshard_64_to_96_zipf),
        Scenario("cascade_eject_canary",
                 "brownout mid-canary with no standby: the ejection "
                 "floor must keep the last replica in rotation",
                 _cascade_eject_canary),
        Scenario("autopilot_resonance",
                 "load parked between adjacent thresholds at a "
                 "resonant diurnal period: flap damping bounds "
                 "reversals",
                 _autopilot_resonance),
        Scenario("slow_burn_slo",
                 "deep capacity loss + burn alert: capacity-only "
                 "alert mode must keep adding engines",
                 _slow_burn_slo),
        Scenario("standby_exhaustion",
                 "diurnal peak outgrows the standby pool: loud error "
                 "outcomes, no crash, no failed requests",
                 _standby_exhaustion),
        Scenario("power_loss_durable",
                 "whole-fleet power loss mid-push: cold restart from "
                 "the durable store with RTO/RPO bounds (WAL ranks "
                 "lose 0, snapshot ranks <= 1 interval, torn "
                 "generation falls back to <= 2)",
                 _power_loss_durable),
    )
}


# ---------------------------------------------------------------------------
# execution + replay
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Result:
    scenario: str
    seed: int
    digest: str
    events: int
    violations: list[str]
    summary: dict
    lines: list[str]
    history: list[dict]

    @property
    def replay_id(self) -> str:
        return f"fleetsim:{self.scenario}:{self.seed}"

    def to_doc(self) -> dict:
        return {"scenario": self.scenario, "seed": self.seed,
                "replay_id": self.replay_id, "digest": self.digest,
                "events": self.events, "violations": self.violations,
                "summary": self.summary}


def parse_replay_id(replay_id: str) -> tuple[str, int]:
    parts = replay_id.split(":")
    if len(parts) != 3 or parts[0] != "fleetsim" \
            or parts[1] not in SCENARIOS:
        raise ValueError(
            f"bad replay id {replay_id!r}: want fleetsim:<scenario>:<seed> "
            f"with scenario one of {sorted(SCENARIOS)}")
    try:
        seed = int(parts[2])
    except ValueError:
        raise ValueError(
            f"bad replay id {replay_id!r}: seed {parts[2]!r} is not an "
            "int") from None
    return parts[1], seed


def run_scenario(name: str, seed: int = 0) -> Result:
    """Execute one scenario to completion; deterministic per
    ``(name, seed)`` — the digest is the byte-identity pin."""
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    loop = EventLoop(seed)
    loop.log("scenario", name=name, seed=seed)
    fleet, prop_thunks = SCENARIOS[name].build(loop)
    fleet.schedule()
    try:
        loop.run(fleet.p.duration_s)
        violations = [v for thunk in prop_thunks for v in thunk(fleet)]
        loop.log("summary", **fleet.summary())
        loop.log("verdict", violations=violations)
    finally:
        for fn in fleet.cleanups:
            try:
                fn()
            except Exception:  # noqa: BLE001 — cleanup is best-effort
                pass
    return Result(scenario=name, seed=seed, digest=loop.digest(),
                  events=loop.events, violations=violations,
                  summary=fleet.summary(), lines=loop.lines,
                  history=fleet.history)
