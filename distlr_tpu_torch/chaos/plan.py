"""Fault plans: the declarative half of the chaos layer (the port's copy of
``distlr_tpu/chaos/plan.py``: the same schema, validations and messages).

A plan is a JSON document describing WHICH network faults to inject on
WHICH links (a link = one client-side path to one server rank) and WHEN
— either at deterministic traffic offsets (the Nth KV frame, the Nth
byte) or inside timed windows relative to fabric start:

.. code-block:: json

    {
      "faults": [
        {"kind": "delay",     "links": "*", "delay_ms": 30, "jitter_ms": 10},
        {"kind": "throttle",  "links": [0], "bytes_per_sec": 65536,
         "window": [2.0, 5.0]},
        {"kind": "reset",     "links": [0], "after_ops": 25},
        {"kind": "reset",     "links": [1], "after_bytes": 4096},
        {"kind": "partition", "links": [1], "window": [6.0, 7.5]},
        {"kind": "kill",      "links": [0], "target": "rank:0",
         "after_ops": 40},
        {"kind": "kill",      "target": "group", "at_s": 3.0}
      ]
    }

``kill`` is the process-fault kind (the durable store's power-loss
primitive): SIGKILL one server rank (``target: "rank:N"``)
or the whole group (``target: "group"``) either when the Nth KV frame
has been forwarded on an observing link (``after_ops``; ``links`` must
pin exactly ONE observing link) or at a fabric-clock offset (``at_s``).
Unlike the network kinds it needs an executor — the fabric's ``killer``
callback (wired by :class:`~distlr_tpu_torch.ps.server.ServerGroup` for
``via_chaos`` groups, or ``launch chaos --pids`` standalone); a plan
with kill faults but no killer registered records the events and warns
rather than silently dropping the fault.

Validation is LOUD and happens entirely at parse time: unknown fault
kinds, unknown keys, negative delays, malformed or overlapping windows
each raise :class:`FaultPlanError` naming the offending fault index and
key — a typo'd plan must never silently inject nothing.

Determinism contract (shared with :mod:`distlr_tpu_torch.chaos.proxy`): the
plan plus one seed fully determine the fault timeline.  Offset-triggered
faults (``after_ops``/``after_bytes``) and always-on faults are
bit-deterministic against the same client op sequence; windowed faults
are deterministic in WHICH window fired (the event log records the
plan's window, never wall time).  Per-op jitter draws are a pure hash of
``(seed, link, fault, op)``, not a shared RNG stream, so thread
interleaving cannot perturb them.
"""

from __future__ import annotations

import dataclasses
import json

FAULT_KINDS = ("delay", "throttle", "reset", "partition", "kill")

#: keys every fault object may carry
_COMMON_KEYS = {"kind", "links", "window"}
#: kind-specific allowed keys
_KIND_KEYS = {
    "delay": {"delay_ms", "jitter_ms"},
    "throttle": {"bytes_per_sec"},
    "reset": {"after_ops", "after_bytes"},
    "partition": set(),
    "kill": {"target", "after_ops", "at_s"},
}


class FaultPlanError(ValueError):
    """A malformed fault plan — message names the offending fault index
    and key (the parse-time rejection contract)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One validated fault.  ``links is None`` means every link; a
    ``window`` is ``(start_s, end_s)`` relative to fabric start, ``None``
    means always active (reset and kill faults are point events — offset
    or clock triggered — and never windowed)."""

    index: int
    kind: str
    links: tuple[int, ...] | None = None
    window: tuple[float, float] | None = None
    delay_ms: float = 0.0
    jitter_ms: float = 0.0
    bytes_per_sec: float = 0.0
    after_ops: int | None = None
    after_bytes: int | None = None
    #: kill faults only: "rank:N" (one server rank) or "group" (all)
    target: str | None = None
    #: kill faults only: fire at this fabric-clock offset (seconds)
    at_s: float | None = None

    def applies_to(self, link: int) -> bool:
        return self.links is None or link in self.links

    def active_at(self, t: float) -> bool:
        return self.window is None or self.window[0] <= t < self.window[1]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A validated, immutable fault plan."""

    faults: tuple[FaultSpec, ...] = ()
    #: plan-suggested seed; an explicit fabric/CLI seed overrides it
    seed: int = 0

    def for_link(self, link: int, kind: str | None = None) -> tuple[FaultSpec, ...]:
        return tuple(f for f in self.faults if f.applies_to(link)
                     and (kind is None or f.kind == kind))


def _err(i: int, key: str, why: str) -> FaultPlanError:
    return FaultPlanError(f"fault[{i}].{key}: {why}")


def _parse_links(i: int, raw) -> tuple[int, ...] | None:
    if raw is None or raw == "*":
        return None
    if not isinstance(raw, list) or not raw:
        raise _err(i, "links", f'must be "*" or a non-empty list of link '
                               f"indices, got {raw!r}")
    links = []
    for v in raw:
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            raise _err(i, "links", f"link indices must be ints >= 0, got {v!r}")
        links.append(v)
    if len(set(links)) != len(links):
        raise _err(i, "links", f"duplicate link index in {raw!r}")
    return tuple(sorted(links))


def _parse_window(i: int, raw) -> tuple[float, float] | None:
    if raw is None:
        return None
    if (not isinstance(raw, (list, tuple)) or len(raw) != 2
            or any(isinstance(v, bool) or not isinstance(v, (int, float))
                   for v in raw)):
        raise _err(i, "window", f"must be [start_s, end_s], got {raw!r}")
    start, end = float(raw[0]), float(raw[1])
    if start < 0 or end <= start:
        raise _err(i, "window",
                   f"need 0 <= start < end, got [{start}, {end}]")
    return start, end


def _number(i: int, fault: dict, key: str, *, required: bool,
            minimum: float, default: float = 0.0) -> float:
    raw = fault.get(key)
    if raw is None:
        if required:
            raise _err(i, key, f"required for kind={fault['kind']!r}")
        return default
    if isinstance(raw, bool) or not isinstance(raw, (int, float)):
        raise _err(i, key, f"must be a number, got {raw!r}")
    v = float(raw)
    if v < minimum:
        raise _err(i, key, f"must be >= {minimum:g}, got {v:g}")
    return v


def _parse_fault(i: int, fault) -> FaultSpec:
    if not isinstance(fault, dict):
        raise FaultPlanError(f"fault[{i}]: must be an object, got {fault!r}")
    kind = fault.get("kind")
    if kind not in FAULT_KINDS:
        raise _err(i, "kind",
                   f"unknown fault kind {kind!r}; known: {list(FAULT_KINDS)}")
    allowed = _COMMON_KEYS | _KIND_KEYS[kind]
    unknown = sorted(set(fault) - allowed)
    if unknown:
        raise _err(i, unknown[0],
                   f"unknown key for kind={kind!r}; allowed: {sorted(allowed)}")
    links = _parse_links(i, fault.get("links"))
    window = _parse_window(i, fault.get("window"))
    spec = dict(index=i, kind=kind, links=links, window=window)

    if kind == "delay":
        spec["delay_ms"] = _number(i, fault, "delay_ms", required=True,
                                   minimum=0.0)
        spec["jitter_ms"] = _number(i, fault, "jitter_ms", required=False,
                                    minimum=0.0)
        if spec["jitter_ms"] > spec["delay_ms"]:
            raise _err(i, "jitter_ms",
                       f"must be <= delay_ms ({spec['delay_ms']:g}) or a "
                       "draw could go negative")
    elif kind == "throttle":
        v = _number(i, fault, "bytes_per_sec", required=True, minimum=1.0)
        spec["bytes_per_sec"] = v
    elif kind == "reset":
        if window is not None:
            raise _err(i, "window", "reset faults trigger at traffic "
                       "offsets (after_ops/after_bytes), not windows")
        ops = fault.get("after_ops")
        nbytes = fault.get("after_bytes")
        if (ops is None) == (nbytes is None):
            raise _err(i, "after_ops",
                       "reset needs exactly one of after_ops / after_bytes")
        key = "after_ops" if ops is not None else "after_bytes"
        raw = ops if ops is not None else nbytes
        if isinstance(raw, bool) or not isinstance(raw, int) or raw < 1:
            raise _err(i, key, f"must be an int >= 1, got {raw!r}")
        spec[key] = raw
    elif kind == "partition":
        if window is None:
            raise _err(i, "window", "partition faults must be timed "
                       "(a window is what bounds the outage)")
    elif kind == "kill":
        if window is not None:
            raise _err(i, "window", "kill faults are one-shot point "
                       "events (after_ops or at_s), not windows")
        target = fault.get("target")
        if not isinstance(target, str) or not (
                target == "group"
                or (target.startswith("rank:")
                    and target[5:].isdigit())):
            raise _err(i, "target",
                       f'must be "rank:N" (N >= 0) or "group", '
                       f"got {target!r}")
        spec["target"] = target
        ops = fault.get("after_ops")
        ats = fault.get("at_s")
        if (ops is None) == (ats is None):
            raise _err(i, "after_ops",
                       "kill needs exactly one of after_ops / at_s")
        if ops is not None:
            if isinstance(ops, bool) or not isinstance(ops, int) or ops < 1:
                raise _err(i, "after_ops",
                           f"must be an int >= 1, got {ops!r}")
            spec["after_ops"] = ops
            if links is None or len(links) != 1:
                raise _err(i, "links",
                           "an after_ops kill needs exactly ONE observing "
                           'link (e.g. "links": [0]) — "the Nth op on any '
                           'link" is a thread race and the canonical '
                           "event log must stay deterministic")
        else:
            if fault.get("links") is not None:
                raise _err(i, "links",
                           "a time-triggered kill (at_s) fires on the "
                           "fabric clock; links only select the "
                           "OBSERVING link of an after_ops kill")
            spec["at_s"] = _number(i, fault, "at_s", required=True,
                                   minimum=0.0)
    return FaultSpec(**spec)


def _links_overlap(a: FaultSpec, b: FaultSpec) -> bool:
    if a.links is None or b.links is None:
        return True
    return bool(set(a.links) & set(b.links))


def _windows_overlap(a: FaultSpec, b: FaultSpec) -> bool:
    wa = a.window or (0.0, float("inf"))
    wb = b.window or (0.0, float("inf"))
    return wa[0] < wb[1] and wb[0] < wa[1]


def parse_plan(doc: dict, *, seed: int | None = None) -> FaultPlan:
    """Validate a plan document into a :class:`FaultPlan`; every
    malformation raises :class:`FaultPlanError` naming the fault index
    and key."""
    if not isinstance(doc, dict):
        raise FaultPlanError(f"plan must be a JSON object, got {type(doc).__name__}")
    unknown = sorted(set(doc) - {"faults", "seed", "comment"})
    if unknown:
        raise FaultPlanError(
            f"unknown top-level key {unknown[0]!r}; allowed: "
            "['faults', 'seed', 'comment']")
    raw_faults = doc.get("faults")
    if not isinstance(raw_faults, list):
        raise FaultPlanError('plan needs a "faults" list')
    faults = tuple(_parse_fault(i, f) for i, f in enumerate(raw_faults))

    # Overlap rejection: two WINDOWED kinds of the same kind on a shared
    # link with intersecting windows would double-inject ambiguously —
    # the plan must say which fault owns the interval.  Resets and kills
    # are one-shot point events (never windowed) and exempt.
    windowed = [f for f in faults if f.kind in ("delay", "throttle",
                                                "partition")]
    for ai, a in enumerate(windowed):
        for b in windowed[ai + 1:]:
            if (a.kind == b.kind and _links_overlap(a, b)
                    and _windows_overlap(a, b)):
                raise FaultPlanError(
                    f"fault[{a.index}].window overlaps fault[{b.index}]"
                    f".window (both {a.kind!r} on a shared link); split "
                    "the windows or the links")

    plan_seed = doc.get("seed", 0)
    if isinstance(plan_seed, bool) or not isinstance(plan_seed, int):
        raise FaultPlanError(f"seed: must be an int, got {plan_seed!r}")
    return FaultPlan(faults=faults,
                     seed=plan_seed if seed is None else int(seed))


def load_plan(path: str, *, seed: int | None = None) -> FaultPlan:
    """Parse + validate a fault-plan JSON file."""
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise FaultPlanError(f"{path} is not valid JSON: {e}") from e
    return parse_plan(doc, seed=seed)
