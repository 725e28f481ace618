"""Embedded fleet time-series store: ring buffers, rollups, queries
(the port's copy of ``distlr_tpu/obs/tsdb.py``, stdlib only).

Every :class:`~distlr_tpu_torch.obs.federate.FleetScraper` poll feeds one
frame into a :class:`FleetTSDB`: the ``/fleet.json`` per-rank rows
become scalar series (``route_requests{role=route,rank=0}``), the
merged registry's counter/gauge families become labeled scalar series,
and its histogram families become bucket-vector series — so windowed
questions ("requests/s over the last 30s", "p99 over the last 5m",
"how fast is the error budget burning") answer from ONE store instead
of the three hand-rolled rate windows that grew around the fleet
(``launch top``'s frame tracker, the autopilot's ``_RateWindow``, and
ad-hoc deltas in benches).

Storage is bounded by construction:

* a **raw tier** — one fixed-size ring per series (``raw_points``
  frames; at obs-agg's default 2s interval the default 512 points is
  ~17 minutes);
* staged **rollups** — 10s and 60s buckets carrying sum/count/min/max
  + last (and, for histograms, the bucket-count deltas within the
  bucket), each tier bounded by ``rollup_retention_s``.

Every eviction is counted (:meth:`FleetTSDB.stats` ->
``distlr_tsdb_points_dropped_total``), never silent.  The on-disk raw
tier stays ``history.jsonl`` (one fleet doc per line, written by the
scraper) so ``launch top --replay`` and rate seeding keep working on
the same file they always read.

The query layer is a deliberately small Prometheus-shaped expression
language (:func:`FleetTSDB.query`)::

    rate(route_requests{role=route})
    increase(distlr_route_shed_total)
    histogram_quantile(0.99, distlr_route_request_seconds)
    avg_over_time(samples_per_s) / 2 + 1

exposed as helpers, as obs-agg's ``/query?expr=...&window=...`` JSON
endpoint, and as the ``launch fleet-query`` CLI.  Recording rules
(:class:`RecordingRule`) evaluate expressions every scrape tick and
write the result back as a derived series (``fleet:req_rate``) that
later queries — and the SLO engine (:mod:`distlr_tpu_torch.obs.slo`) — can
reference like any other name.

Concurrency: the scrape-tick writer, ``/query`` HTTP readers, and the
rule/SLO evaluator cross threads, so all mutation and point reads go
through ``_lock`` (from the :mod:`distlr_tpu_torch.sync` facade);
:meth:`stats` is a deliberately lock-free monitoring snapshot.
"""

from __future__ import annotations

import collections
import json
import math
import re

from distlr_tpu_torch import sync
from distlr_tpu_torch.obs.registry import percentile_from_counts

#: rollup tiers, seconds per bucket, coarsest last
ROLLUP_STEPS = (10.0, 60.0)


# ---------------------------------------------------------------------------
# the one shared rate arithmetic (satellite: dedupe the three windows)
# ---------------------------------------------------------------------------

def delta_rate(t0: float, v0, t1: float, v1) -> float | None:
    """Counter rate between two observations: ``max(0, dv/dt)``.

    ``None`` when either endpoint is missing or time did not advance;
    negative deltas clamp to 0 (a restarted process reset the counter).
    This is THE rate arithmetic — ``launch top``'s per-rank columns,
    the autopilot's windowed signals, and :meth:`FleetTSDB.query`'s
    ``rate()`` all call it, so they can never disagree about what a
    rate means.
    """
    if v0 is None or v1 is None:
        return None
    dt = t1 - t0
    if dt <= 0:
        return None
    return max(0.0, (v1 - v0) / dt)


class RateWindow:
    """Windowed rates from successive cumulative-counter observations:
    append ``(t, totals-dict)``, read back delta/dt over the horizon.
    Keeps one observation at/past the horizon so the window always
    spans at least ``window_s`` once enough history exists (the
    autopilot daemon's contract, moved here from
    ``autopilot/daemon.py``)."""

    def __init__(self, window_s: float):
        self.window_s = float(window_s)
        self._obs: collections.deque = collections.deque()

    def push(self, t: float, totals: dict) -> None:
        self._obs.append((t, totals))
        while len(self._obs) > 2 and t - self._obs[1][0] >= self.window_s:
            self._obs.popleft()

    def rate(self, key: str) -> float | None:
        if len(self._obs) < 2:
            return None
        (t0, a), (t1, b) = self._obs[0], self._obs[-1]
        if key not in a or key not in b:
            return None
        return delta_rate(t0, a[key], t1, b[key])


def load_history(path: str, *, limit: int = 64) -> list[tuple[float, dict]]:
    """Parse the tail of a scraper ``history.jsonl`` into
    ``[(t, fleet_doc), ...]`` (oldest first).  Rows written by the live
    aggregator stamp ``updated``; test fixtures (and the pre-tsdb
    seeding contract) stamp ``t`` — both are accepted, because seeding
    from a REAL history file silently primed nothing when only ``t``
    was recognized.  Unparseable lines are skipped (a torn tail line
    is normal)."""
    try:
        with open(path) as f:
            lines = f.readlines()[-limit:]
    except OSError:
        return []
    rows: list[tuple[float, dict]] = []
    for line in lines:
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if not isinstance(doc, dict):
            continue
        t = doc.get("t")
        if not isinstance(t, (int, float)):
            t = doc.get("updated")
        if isinstance(t, (int, float)) and math.isfinite(t):
            rows.append((float(t), doc))
    return rows


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _label_key(labels: dict | None) -> tuple:
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


class _Rollup:
    """One rollup tier of one series: fixed-width buckets carrying
    sum/count/min/max/last (+ histogram bucket deltas)."""

    __slots__ = ("step", "buckets")

    def __init__(self, step: float):
        self.step = float(step)
        self.buckets: collections.deque = collections.deque()

    def add_scalar(self, t: float, v: float) -> None:
        b = math.floor(t / self.step) * self.step
        if self.buckets and self.buckets[-1][0] == b:
            agg = self.buckets[-1]
            agg[1] += v
            agg[2] += 1
            agg[3] = min(agg[3], v)
            agg[4] = max(agg[4], v)
            agg[5] = v
            agg[6] = t
        else:
            # [bucket_t, sum, count, min, max, last, last_t]
            self.buckets.append([b, v, 1, v, v, v, t])

    def add_hist(self, t: float, counts: list[float]) -> None:
        b = math.floor(t / self.step) * self.step
        if self.buckets and self.buckets[-1][0] == b:
            agg = self.buckets[-1]
            agg[2] = counts          # last cumulative vector
            agg[3] = t
        else:
            # [bucket_t, first_counts, last_counts, last_t]
            self.buckets.append([b, counts, counts, t])

    def evict(self, now: float, retention_s: float) -> int:
        dropped = 0
        while self.buckets and self.buckets[0][0] < now - retention_s:
            self.buckets.popleft()
            dropped += 1
        return dropped


class _Series:
    __slots__ = ("name", "labels", "kind", "bounds", "raw", "rollups")

    def __init__(self, name: str, labels: tuple, kind: str,
                 raw_points: int, bounds: tuple = ()):
        self.name = name
        self.labels = labels
        self.kind = kind            # "scalar" | "histogram"
        self.bounds = bounds        # histogram bucket boundaries
        self.raw: collections.deque = collections.deque(maxlen=raw_points)
        self.rollups = [_Rollup(s) for s in ROLLUP_STEPS]


class FleetTSDB:
    """The embedded store.  All timestamps are caller-provided (the
    scraper passes each frame's ``updated`` stamp), so the store is
    fully deterministic under a virtual clock — tests and schedcheck
    drive it without wall time."""

    def __init__(self, *, raw_points: int = 512,
                 rollup_retention_s: float = 3600.0):
        if raw_points < 2:
            raise ValueError(
                f"raw_points must be >= 2 (a rate needs two), got "
                f"{raw_points}")
        if rollup_retention_s <= 0:
            raise ValueError("rollup_retention_s must be positive, got "
                             f"{rollup_retention_s}")
        self.raw_points = int(raw_points)
        self.rollup_retention_s = float(rollup_retention_s)
        self._lock = sync.Lock()
        self._series: dict[tuple[str, tuple], _Series] = {}
        self._last_t: float | None = None
        # monitoring counters: written under _lock, read lock-free by
        # stats() (monotonic ints; audited in the concurrency baseline,
        # raced by the tsdb_write_query_rollup schedcheck scenario)
        self.points_total = 0
        self.frames_total = 0
        self.dropped = {"raw": 0, "rollup": 0, "history": 0}

    # -- ingest ------------------------------------------------------------
    def _append(self, name: str, labels: tuple, t: float, value,
                *, kind: str = "scalar", bounds: tuple = ()) -> None:
        key = (name, labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _Series(name, labels, kind,
                                            self.raw_points, bounds)
        if len(s.raw) == s.raw.maxlen:
            self.dropped["raw"] += 1
        s.raw.append((t, value))
        for r in s.rollups:
            if kind == "histogram":
                r.add_hist(t, value)
            else:
                r.add_scalar(t, float(value))
            self.dropped["rollup"] += r.evict(t, self.rollup_retention_s)
        self.points_total += 1

    def ingest(self, fleet: dict, snapshot: dict | None = None) -> int:
        """Feed one scrape frame: the ``/fleet.json`` doc's per-rank
        numeric fields (+ totals) and, optionally, the merged registry
        snapshot's families.  Returns points ingested (0 for a
        duplicate frame — same ``updated`` stamp as the last one, the
        aggregator has not rescraped)."""
        t = fleet.get("updated")
        if not isinstance(t, (int, float)) or not math.isfinite(t):
            return 0
        t = float(t)
        with self._lock:
            if self._last_t is not None and t <= self._last_t:
                return 0
            before = self.points_total
            self._last_t = t
            for row in fleet.get("ranks", []):
                labels = _label_key({"role": row.get("role", "?"),
                                     "rank": row.get("rank", "?")})
                for field, v in row.items():
                    if field == "rank" or isinstance(v, bool) \
                            or not isinstance(v, (int, float)):
                        continue  # rank is identity (a label), not data
                    self._append(field, labels, t, v)
            for field, v in (fleet.get("totals") or {}).items():
                if not isinstance(v, bool) and isinstance(v, (int, float)):
                    self._append(f"fleet:{field}", (), t, v)
            if snapshot:
                self._ingest_snapshot_locked(snapshot, t)
            self.frames_total += 1
            return self.points_total - before

    def _ingest_snapshot_locked(self, snap: dict, t: float) -> None:
        for name, fam in snap.items():
            kind = fam.get("type")
            for series in fam.get("series", []):
                labels = _label_key(series.get("labels"))
                if kind == "histogram":
                    buckets = series.get("buckets") or {}
                    try:
                        bounds = tuple(sorted(float(b) for b in buckets))
                    except (TypeError, ValueError):
                        continue
                    # cumulative per-bound counts + the +Inf slot, in
                    # boundary order — one vector per frame
                    counts = [float(buckets[b]) for b in
                              sorted(buckets, key=float)]
                    counts.append(float(series.get("inf", 0)))
                    self._append(name, labels, t, counts,
                                 kind="histogram", bounds=bounds)
                else:
                    v = series.get("value")
                    if isinstance(v, bool) or not isinstance(
                            v, (int, float)) or not math.isfinite(v):
                        continue
                    self._append(name, labels, t, v)

    def record(self, name: str, labels: dict | None, t: float,
               value: float | None) -> None:
        """Write one derived point (recording rules, SLO bad-tick
        series).  ``None`` values record nothing — absence of data must
        stay distinguishable from 0."""
        if value is None:
            return
        with self._lock:
            self._append(name, _label_key(labels), t, float(value))

    def count_dropped(self, tier: str, n: int) -> None:
        """Attribute ``n`` externally-evicted points (the on-disk
        history tier's rotation) to the drop counter."""
        if n > 0:
            with self._lock:
                self.dropped[tier] = self.dropped.get(tier, 0) + int(n)

    # -- reads -------------------------------------------------------------
    def _match_locked(self, name: str, labels: dict | None) -> list[_Series]:
        want = dict(_label_key(labels))
        out = []
        for (n, _k), s in self._series.items():
            if n != name:
                continue
            have = dict(s.labels)
            if all(have.get(k) == v for k, v in want.items()):
                out.append(s)
        return out

    @staticmethod
    def _scalar_points(s: _Series, start: float, end: float) -> list:
        """Merged (t, value) points inside [start, end]: rollup tiers
        (coarsest first) cover history the raw ring has already
        evicted; raw covers the recent end.  Rollup buckets contribute
        their last sample at its true timestamp."""
        raw = [(t, v) for t, v in s.raw if start <= t <= end]
        oldest_raw = raw[0][0] if raw else end + 1.0
        pts: list = []
        for r in reversed(s.rollups):          # coarsest tier first
            for b in r.buckets:
                t = b[6]
                if start <= t <= end and t < oldest_raw and (
                        not pts or t > pts[-1][0]):
                    pts.append((t, b[5]))
        pts = [p for p in pts if p[0] < oldest_raw]
        pts.extend(raw)
        return pts

    @staticmethod
    def _hist_endpoints(s: _Series, start: float, end: float):
        """(first, last) cumulative bucket vectors inside the window:
        raw points, with rollup buckets (coarsest first) covering
        history the raw ring evicted.  A rollup bucket contributes its
        last vector at its true timestamp; the earliest contributing
        bucket may also lend its FIRST vector, but only when the whole
        bucket lies inside the window — a bucket straddling the window
        edge would smuggle pre-window counts into the delta."""
        raw = [(t, v) for t, v in s.raw if start <= t <= end]
        oldest_raw = raw[0][0] if raw else end + 1.0
        pts: list = []
        for r in reversed(s.rollups):          # coarsest tier first
            for b in r.buckets:
                t = b[3]
                if start <= t <= end and t < oldest_raw and (
                        not pts or t > pts[-1][0]):
                    if not pts and b[0] >= start:
                        pts.append((b[0], b[1]))
                    pts.append((t, b[2]))
        pts = [p for p in pts if p[0] < oldest_raw]
        pts.extend(raw)
        if len(pts) < 2:
            return None
        return pts[0][1], pts[-1][1]

    def series_names(self) -> list[dict]:
        with self._lock:
            return [{"name": s.name, "labels": dict(s.labels),
                     "kind": s.kind, "points": len(s.raw)}
                    for s in self._series.values()]

    def window_snapshot(self, start: float, end: float, *,
                        prefix: str = "fleet:") -> dict:
        """Export every ``prefix``-named scalar series' (t, value)
        points inside ``[start, end]`` — the incident bundle's
        ``tsdb.json`` payload: the headline recorded series around the
        alert edge, frozen into the bundle so the postmortem does not
        depend on the live store's retention."""
        out: dict = {}
        with self._lock:
            for s in self._series.values():
                if not s.name.startswith(prefix) or s.kind == "hist":
                    continue
                pts = self._scalar_points(s, start, end)
                if not pts:
                    continue
                key = s.name
                if s.labels:
                    key += "{" + ",".join(
                        f"{k}={v}" for k, v in s.labels) + "}"
                out[key] = [[round(t, 3), v] for t, v in pts]
        return out

    def latest_time(self) -> float | None:
        with self._lock:
            return self._last_t

    def stats(self) -> dict:
        """Lock-free monitoring snapshot: the counters are monotonic
        ints and a racing reader sees the previous frame's values —
        what a monitor means (same stance as ``AutopilotDaemon.
        status()``; audited in the concurrency baseline)."""
        return {
            "series": len(self._series),
            "frames": self.frames_total,
            "points": self.points_total,
            "dropped": dict(self.dropped),
        }

    # -- query functions ---------------------------------------------------
    def _eval_fn(self, fn: str, name: str, labels: dict | None,
                 window_s: float, now: float, q: float | None):
        start, end = now - window_s, now
        with self._lock:
            series = self._match_locked(name, labels)
            if fn == "histogram_quantile":
                deltas: list[float] | None = None
                bounds: tuple | None = None
                for s in series:
                    if s.kind != "histogram":
                        continue
                    ep = self._hist_endpoints(s, start, end)
                    if ep is None:
                        continue
                    first, last = ep
                    if bounds is None:
                        bounds = s.bounds
                        deltas = [0.0] * len(last)
                    elif s.bounds != bounds or len(last) != len(deltas):
                        continue   # mismatched ladders never merge
                    for i in range(len(last)):
                        deltas[i] += max(0.0, last[i] - first[i])
                if deltas is None or bounds is None:
                    return None
                # cumulative -> per-bucket decomposition (+Inf last)
                per = [deltas[0]]
                per.extend(deltas[i] - deltas[i - 1]
                           for i in range(1, len(deltas)))
                per = [max(0.0, c) for c in per]
                if sum(per) == 0:
                    return None
                return percentile_from_counts(bounds, per, q)
            total = None
            agg: list[float] = []
            for s in series:
                if s.kind != "scalar":
                    continue
                pts = self._scalar_points(s, start, end)
                if fn in ("rate", "increase"):
                    if len(pts) < 2:
                        continue
                    (t0, v0), (t1, v1) = pts[0], pts[-1]
                    r = delta_rate(t0, v0, t1, v1)
                    if r is None:
                        continue
                    total = (total or 0.0) + (
                        r if fn == "rate" else r * (t1 - t0))
                elif fn == "last":
                    if pts:
                        total = (total or 0.0) + pts[-1][1]
                else:
                    agg.extend(v for _t, v in pts)
            if fn in ("rate", "increase", "last"):
                return total
            if not agg:
                return None
            if fn == "avg_over_time":
                return sum(agg) / len(agg)
            if fn == "min_over_time":
                return min(agg)
            if fn == "max_over_time":
                return max(agg)
            if fn == "sum_over_time":
                return sum(agg)
            if fn == "count_over_time":
                return float(len(agg))
            raise ValueError(f"unknown query function {fn!r}")

    def query(self, expr: str, *, window_s: float = 60.0,
              now: float | None = None):
        """Evaluate one expression over the trailing window.  Returns a
        float, or ``None`` when the window holds no data (callers must
        distinguish "no traffic yet" from 0)."""
        if now is None:
            now = self.latest_time()
            if now is None:
                return None
        return _eval_expr(self, expr, float(window_s), float(now))


# ---------------------------------------------------------------------------
# the expression mini-language
# ---------------------------------------------------------------------------

_FUNCS = ("rate", "increase", "avg_over_time", "min_over_time",
          "max_over_time", "sum_over_time", "count_over_time", "last",
          "histogram_quantile")

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<num>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
    | (?P<name>[A-Za-z_][A-Za-z0-9_:.]*)
    | (?P<sel>\{[^}]*\})
    | (?P<op>[()+\-*/,])
    )""", re.VERBOSE)


def _tokenize(expr: str) -> list[tuple[str, str]]:
    out, i = [], 0
    while i < len(expr):
        m = _TOKEN.match(expr, i)
        if m is None or m.end() == i:
            raise ValueError(f"bad query syntax at {expr[i:]!r}")
        i = m.end()
        for kind in ("num", "name", "sel", "op"):
            v = m.group(kind)
            if v is not None:
                out.append((kind, v))
                break
    return out


def _parse_labels(sel: str) -> dict:
    body = sel.strip()[1:-1].strip()
    labels: dict = {}
    if not body:
        return labels
    for part in body.split(","):
        k, eq, v = part.partition("=")
        if not eq:
            raise ValueError(f"bad label matcher {part!r} (need k=v)")
        labels[k.strip()] = v.strip().strip('"').strip("'")
    return labels


class _Parser:
    """Recursive descent over +- / */ with function calls and parens.
    Arithmetic over ``None`` (a term with no data) propagates ``None``
    — a budget must read "unknown", never "fine", when its inputs are
    missing; division by zero reads ``None`` too."""

    def __init__(self, db: FleetTSDB, tokens: list, window_s: float,
                 now: float):
        self.db = db
        self.toks = tokens
        self.i = 0
        self.window_s = window_s
        self.now = now

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def take(self, kind=None, value=None):
        k, v = self.peek()
        if k is None or (kind and k != kind) or (value and v != value):
            raise ValueError(
                f"bad query syntax near token {self.i} "
                f"(expected {value or kind}, got {v!r})")
        self.i += 1
        return v

    def expr(self):
        left = self.term()
        while self.peek() == ("op", "+") or self.peek() == ("op", "-"):
            op = self.take("op")
            right = self.term()
            if left is None or right is None:
                left = None
            else:
                left = left + right if op == "+" else left - right
        return left

    def term(self):
        left = self.factor()
        while self.peek() == ("op", "*") or self.peek() == ("op", "/"):
            op = self.take("op")
            right = self.factor()
            if left is None or right is None:
                left = None
            elif op == "*":
                left = left * right
            else:
                left = left / right if right != 0 else None
        return left

    def factor(self):
        k, v = self.peek()
        if k == "op" and v == "(":
            self.take("op", "(")
            inner = self.expr()
            self.take("op", ")")
            return inner
        if k == "op" and v == "-":
            self.take("op", "-")
            inner = self.factor()
            return None if inner is None else -inner
        if k == "num":
            self.take("num")
            return float(v)
        if k == "name" and v in _FUNCS:
            return self.call(self.take("name"))
        if k == "name":
            name = self.take("name")
            labels = self.selector()
            return self.db._eval_fn("last", name, labels,
                                    self.window_s, self.now, None)
        raise ValueError(f"bad query syntax near {v!r}")

    def selector(self) -> dict:
        if self.peek()[0] == "sel":
            return _parse_labels(self.take("sel"))
        return {}

    def call(self, fn: str):
        self.take("op", "(")
        q = None
        if fn == "histogram_quantile":
            q = float(self.take("num"))
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"quantile must be in [0, 1], got {q}")
            self.take("op", ",")
        name = self.take("name")
        labels = self.selector()
        self.take("op", ")")
        return self.db._eval_fn(fn, name, labels, self.window_s,
                                self.now, q)


def _eval_expr(db: FleetTSDB, expr: str, window_s: float, now: float):
    p = _Parser(db, _tokenize(expr), window_s, now)
    out = p.expr()
    if p.i != len(p.toks):
        raise ValueError(f"trailing junk in query: {expr!r}")
    return out


def check_expr(expr: str) -> None:
    """Full grammar check without data: parse-and-evaluate against an
    empty store (every selector reads None), so malformed expressions
    fail at LOAD time with a ValueError instead of mid-scrape."""
    _eval_expr(FleetTSDB(), str(expr), 60.0, 0.0)


# ---------------------------------------------------------------------------
# recording rules
# ---------------------------------------------------------------------------

class RecordingRule:
    """One derived series: ``expr`` evaluated over ``window_s`` every
    scrape tick, recorded back under ``name`` — the engine behind the
    fleet's windowed rates (one implementation, queried everywhere)."""

    def __init__(self, name: str, expr: str, window_s: float = 30.0):
        if not name or not str(name).strip():
            raise ValueError("recording rule needs a series name")
        self.name = str(name)
        self.expr = str(expr)
        self.window_s = float(window_s)
        if self.window_s <= 0:
            raise ValueError(
                f"rule {name!r}: window_s must be positive, got {window_s}")
        check_expr(self.expr)  # syntax-check eagerly, not mid-scrape

    def evaluate(self, db: FleetTSDB, now: float) -> float | None:
        value = db.query(self.expr, window_s=self.window_s, now=now)
        db.record(self.name, None, now, value)
        return value


#: the recording rules every aggregator evaluates (the unified windowed
#: fleet rates the bespoke trackers used to duplicate); an SLO file's
#: "rules" list appends to these
DEFAULT_RULES = (
    ("fleet:push_rate", "rate(pushes)", 30.0),
    ("fleet:shed_rate", "rate(route_shed)", 30.0),
    ("fleet:req_rate", "rate(route_requests)", 30.0),
    # windowed fleet ERROR-record rate (the structured-log signal the
    # `launch top` log_errors column and incident bundles read)
    ("fleet:log_error_rate", "rate(log_errors_total)", 30.0),
)


def default_rules() -> list[RecordingRule]:
    return [RecordingRule(n, e, w) for n, e, w in DEFAULT_RULES]
