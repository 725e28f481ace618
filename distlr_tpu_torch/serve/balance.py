"""The router's balancing and health policy, as pure functions.

Counterpart of ``distlr_tpu/serve/balance.py``, function for function:
least-in-flight ordering with a rotated tie-break, success and failure
notes, the last-healthy ejection floor, ejection, and the active probe's
backoff and reinstatement.

Every function takes duck-typed replica objects carrying the health
fields of ``serve.router._Replica`` (``healthy``, ``consecutive_errors``,
``inflight``, ``errors``, ``requests``, ``ejections``, ``reinstates``,
``backoff_s``, ``next_probe_at``, ``last_ok``, ``last_probe``).  Nothing
here touches sockets, locks or clocks: the router calls these under its
health lock with ``time.monotonic()``.  Side effects are confined to the
replica fields each docstring names.

The **ejection floor** (:func:`may_eject`): the last healthy replica of a
pool stays in rotation however it misbehaves, because a bad answer beats
no answer; its ``consecutive_errors`` keep counting, and it is ejected
the moment a sibling is reinstated.
"""

from __future__ import annotations

__all__ = [
    "eject",
    "eject_verdict",
    "may_eject",
    "note_failure",
    "note_success",
    "order_candidates",
    "probe_due",
    "probe_result",
]


def order_candidates(cands: list, rr: int) -> tuple[list, int]:
    """Least in-flight first with a rotating tie-break: advance the
    rotation counter, rotate, then stable-sort by in-flight (so rotation
    order breaks ties and serial traffic still spreads).  Returns
    ``(ordered, new_rr)``; an empty candidate list leaves the counter be."""
    if not cands:
        return [], rr
    rr = (rr + 1) % len(cands)
    rotated = cands[rr:] + cands[:rr]
    rotated.sort(key=lambda r: r.inflight)
    return rotated, rr


def note_success(rep, now: float) -> None:
    """A successful exchange: the consecutive-error streak resets."""
    rep.requests += 1
    rep.consecutive_errors = 0
    rep.last_ok = now


def note_failure(rep) -> None:
    """A transport failure: count it (the caller then consults
    :func:`eject_verdict`)."""
    rep.errors += 1
    rep.consecutive_errors += 1


def may_eject(rep, pools: list) -> bool:
    """True only if every multi-replica pool in ``pools`` (the replica
    lists of each model ``rep`` serves) keeps at least one other healthy
    replica after ``rep`` leaves rotation.  Singleton pools are exempt:
    a pool of one has no fail-over destination to preserve, and ejecting
    its only member turns slow per-request dial timeouts into fast
    ``no healthy replica`` errors while backoff probes watch it."""
    for pool in pools:
        if len(pool) > 1 and not any(r.healthy for r in pool if r is not rep):
            return False
    return True


def eject_verdict(rep, pools: list, eject_after: int) -> str:
    """Arbitrate one failure streak: ``"keep"`` below the threshold,
    ``"eject"`` at or over it, ``"floor"`` when only the last-healthy
    floor blocks the ejection."""
    if not rep.healthy or rep.consecutive_errors < eject_after:
        return "keep"
    return "eject" if may_eject(rep, pools) else "floor"


def eject(rep, now: float, probe_backoff_s: float) -> None:
    """Take ``rep`` out of rotation and arm the first backoff probe."""
    rep.healthy = False
    rep.ejections += 1
    rep.backoff_s = probe_backoff_s
    rep.next_probe_at = now + rep.backoff_s


def probe_result(rep, ok: bool, now: float, *, probe_backoff_s: float,
                 probe_backoff_max_s: float, eject_after: int, pools: list) -> str:
    """Fold one active health probe's outcome into the replica's state.

    Returns ``"reinstated"`` (an ejected replica back in rotation),
    ``"ok"`` (healthy confirmed), ``"counted"`` (a failure toward
    ejection), ``"ejected"``, ``"floor"`` (threshold crossed, the floor
    held it) or ``"backoff"`` (an ejected replica still down: backoff
    doubled, capped)."""
    rep.last_probe = now
    if ok:
        rep.consecutive_errors = 0
        rep.last_ok = now
        rep.backoff_s = 0.0
        if not rep.healthy:
            rep.healthy = True
            rep.reinstates += 1
            return "reinstated"
        return "ok"
    if rep.healthy:
        note_failure(rep)
        verdict = eject_verdict(rep, pools, eject_after)
        if verdict == "eject":
            eject(rep, now, probe_backoff_s)
            return "ejected"
        return "floor" if verdict == "floor" else "counted"
    rep.backoff_s = min(max(rep.backoff_s * 2, probe_backoff_s), probe_backoff_max_s)
    rep.next_probe_at = now + rep.backoff_s
    return "backoff"


def probe_due(rep, now: float, health_interval_s: float, probe_backoff_s: float) -> bool:
    """Healthy replicas probe when neither traffic nor a probe confirmed
    them for an interval; ejected ones on their backoff schedule.  When an
    ejected replica's probe comes due the next slot is pushed at once, so
    a fast-failing probe cannot loop inside one backoff window."""
    if rep.healthy:
        return now - max(rep.last_ok, rep.last_probe) >= health_interval_s
    due = now >= rep.next_probe_at
    if due:
        rep.next_probe_at = now + max(rep.backoff_s, probe_backoff_s)
    return due
