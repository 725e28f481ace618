"""Fleet-scale property checks — what a scenario must not violate.

Each check takes the finished :class:`~distlr_tpu_torch.analysis.fleetsim.
models.SimFleet` (plus per-check bounds baked in by the scenario) and
returns a list of violation strings — empty means the property held.
Violations are counterexamples: the CLI prints the replay id, the
mutant suite pins the pre-fix behavior, and the tests assert the fixed
policies keep every scenario clean.
"""

from __future__ import annotations

__all__ = [
    "all_rejoined",
    "no_flapping",
    "rank_seconds_bounded",
    "reshard_converged",
    "rpo_bounded",
    "rto_bounded",
    "slo_budget_held",
    "zero_failed_accepted",
]


def no_flapping(fleet, *, actuator: str, max_reversals: int) -> list[str]:
    """Bounded direction reversals per run: each reversal is a replica
    churn / a reshard, so a controller that oscillates at the cooldown
    cadence is broken even when every individual action is 'correct'
    (the autopilot_resonance counterexample)."""
    dirs = [a["action"]["direction"] for a in fleet.actions()
            if a["action"]["actuator"] == actuator]
    reversals = sum(1 for prev, cur in zip(dirs, dirs[1:]) if prev != cur)
    if reversals > max_reversals:
        return [f"no_flapping: {actuator} reversed direction {reversals}x "
                f"(bound {max_reversals}) — controller resonance"]
    return []


def zero_failed_accepted(fleet, *, allowed_until: float) -> list[str]:
    """No ACCEPTED request may fail outside a scripted fault window
    (+grace).  Sheds are explicit admission control and never count;
    errors after the fault cleared mean the routing tier turned a
    transient into an outage (the cascade_eject counterexample)."""
    late = [(t, n) for t, n in fleet.router.error_ticks
            if t > allowed_until]
    if late:
        total = sum(n for _t, n in late)
        return [f"zero_failed_accepted: {total:.1f} requests failed "
                f"after t={allowed_until:.1f}s (first at "
                f"t={late[0][0]:.1f}s) — outage outlived the fault"]
    return []


def slo_budget_held(fleet, *, min_budget: float = 0.0) -> list[str]:
    """The error budget survives the run (the slow_burn_slo
    counterexample: a frozen controller burns it to exhaustion)."""
    if not fleet.slo_summaries:
        return ["slo_budget_held: no SLO summaries were evaluated"]
    out = []
    for s in fleet.slo_summaries:
        budget = s.get("budget_remaining")
        if budget is None:
            out.append(f"slo_budget_held: {s['name']}: no budget computed")
        elif budget <= min_budget:
            out.append(f"slo_budget_held: {s['name']}: budget "
                       f"{budget:.3f} <= {min_budget} — exhausted")
    return out


def rank_seconds_bounded(fleet, *, slack: float = 1.0) -> list[str]:
    """Autopilot-scaled rank-seconds must not exceed static peak
    provisioning (times ``slack``) — an autoscaler that costs more
    than not having one is a bug, not a tuning problem."""
    static = fleet.peak_ranks * fleet.p.duration_s
    if fleet.rank_seconds > static * slack:
        return [f"rank_seconds: {fleet.rank_seconds:.0f} > "
                f"{slack:.2f} * static-peak {static:.0f}"]
    return []


def all_rejoined(fleet, *, deadline_s: float) -> list[str]:
    """Every partitioned worker is back and the feedback backlog has
    drained by the deadline (the 1000-worker heal scenario)."""
    out = []
    if fleet.workers.joined < fleet.workers.total:
        out.append(f"all_rejoined: {fleet.workers.joined}/"
                   f"{fleet.workers.total} workers joined by "
                   f"t={deadline_s:.0f}s")
    if fleet.shard_lag > fleet.p.shard_inflow_rate:
        out.append(f"all_rejoined: shard backlog {fleet.shard_lag:.1f} "
                   f"not drained by t={deadline_s:.0f}s")
    return out


def rto_bounded(fleet, *, max_rto_s: float) -> list[str]:
    """Recovery-Time Objective: the span from a whole-fleet power loss
    to the LAST rank back in service stays under the bound (the
    power_loss_durable scenario writes ``fleet.dr``).  A fleet that
    never fully recovers is the worst violation, not a vacuous pass."""
    dr = getattr(fleet, "dr", None)
    if not dr:
        return ["rto_bounded: the fleet has no DR record — the power "
                "loss never ran"]
    if dr["rto_s"] is None:
        down = [i for i, r in enumerate(dr["ranks"]) if not r["up"]]
        return [f"rto_bounded: the fleet never fully recovered "
                f"(ranks still down: {down})"]
    if dr["rto_s"] > max_rto_s:
        return [f"rto_bounded: RTO {dr['rto_s']:.1f}s > bound "
                f"{max_rto_s:.1f}s"]
    return []


def rpo_bounded(fleet) -> list[str]:
    """Recovery-Point Objective, per rank against its durability mode
    (the durable store's contract): a WAL rank loses ZERO applied pushes; a
    snapshot-only rank loses at most one snapshot interval's worth; a
    rank whose newest generation was torn by the cut falls back ONE
    generation — at most two intervals lost, never a refusal to start
    and never a silent restore of the corrupt file.  The scenario bakes
    each rank's bound (``rpo_bound``) from its mode and the live push
    rate at the moment of the cut."""
    dr = getattr(fleet, "dr", None)
    if not dr:
        return ["rpo_bounded: the fleet has no DR record — the power "
                "loss never ran"]
    out = []
    for i, r in enumerate(dr["ranks"]):
        if r["lost"] is None:
            out.append(f"rpo_bounded: rank {i} has no loss record — it "
                       "never lost power")
            continue
        if r["lost"] > r["rpo_bound"] + 1e-9:
            out.append(
                f"rpo_bounded: rank {i} ({r['mode']}) lost "
                f"{r['lost']:.1f} pushes > bound {r['rpo_bound']:.1f}")
    return out


def reshard_converged(plan, dim: int, old_ranges, *, sampler=None,
                      max_hot_share: float | None = None) -> list[str]:
    """The resize plan exactly tiles the new layout: every key of every
    new range is either resident (the reused prefix) or covered by
    exactly one move; nothing moves into a reused resident prefix; and
    under a Zipf-hot key distribution the hottest new rank's load share
    (closed-form, :meth:`~distlr_tpu_torch.traffic.ZipfSampler.mass`) stays
    under ``max_hot_share``."""
    out = []
    by_target: dict[int, list[tuple[int, int]]] = {}
    for _o, lo, hi, nr in plan.moves:
        by_target.setdefault(nr, []).append((lo, hi))
    for nr, (lo, hi) in enumerate(plan.new_ranges):
        res_hi = lo
        if nr in plan.reuse:
            res_hi = min(old_ranges[plan.reuse[nr]][1], hi)
        spans = sorted(by_target.get(nr, []))
        cursor = res_hi
        for mlo, mhi in spans:
            if mlo < res_hi:
                out.append(f"reshard_converged: move [{mlo},{mhi}) into "
                           f"rank {nr} overlaps resident prefix "
                           f"[{lo},{res_hi})")
            if mlo != cursor:
                out.append(f"reshard_converged: rank {nr} gap/overlap at "
                           f"{cursor} (next move starts {mlo})")
            cursor = max(cursor, mhi)
        if cursor != hi:
            out.append(f"reshard_converged: rank {nr} covered to {cursor}, "
                       f"range ends {hi}")
    covered = sum(hi - lo for lo, hi in plan.new_ranges)
    if covered != dim:
        out.append(f"reshard_converged: new ranges cover {covered} keys "
                   f"of dim {dim}")
    if sampler is not None and max_hot_share is not None:
        hottest = max(sampler.mass(lo, hi) for lo, hi in plan.new_ranges)
        if hottest > max_hot_share:
            out.append(f"reshard_converged: hottest new rank carries "
                       f"{hottest:.3f} of the load "
                       f"(bound {max_hot_share})")
    return out
