"""SLO engine: error budgets and multi-window multi-burn-rate alerts
over the embedded fleet tsdb (:mod:`distlr_tpu_torch.obs.tsdb`); the
port's copy of ``distlr_tpu/obs/slo.py``, stdlib only.

An SLO file (``launch obs-agg --slo-file slo.json``) declares
objectives over SLI expressions::

    {
      "clock_scale": 1.0,
      "slos": [
        {"name": "route_availability",
         "objective": 0.99,
         "window_s": 3600,
         "sli": {"kind": "ratio",
                 "bad": "increase(route_shed)",
                 "total": "increase(route_requests)"}},
        {"name": "route_p99",
         "objective": 0.95,
         "window_s": 3600,
         "sli": {"kind": "threshold",
                 "expr": "histogram_quantile(0.99, distlr_route_request_seconds)",
                 "op": "<=", "bound": 0.25}}
      ]
    }

Two SLI kinds:

* **ratio** — ``bad``/``total`` tsdb expressions evaluated per burn
  window; the bad fraction is their quotient (``None`` -> unknown when
  total is 0: no traffic is not compliance).
* **threshold** — ``expr`` compared against ``bound`` each scrape tick;
  the engine records a 0/1 ``slo:<name>:bad`` series into the tsdb and
  the bad fraction over any window is its ``avg_over_time``.

From the bad fraction the engine derives, each scrape tick:

* ``budget_remaining = 1 - bad_fraction(window_s) / (1 - objective)``
  — the fraction of the error budget left over the SLO window
  (negative = overspent), exported as
  ``distlr_slo_budget_remaining{slo}``;
* ``burn_rate(w) = bad_fraction(w) / (1 - objective)`` per burn
  window, exported as ``distlr_slo_burn_rate{slo,window}`` — 1.0 means
  burning exactly the budget over the SLO window, 14.4 means the whole
  budget gone in ~2% of it;
* **multi-window multi-burn-rate alerts** (Google SRE workbook ch. 5):
  a pair fires only when BOTH its short and long windows exceed the
  pair's factor — the long window guards against noise, the short one
  makes the alert reset quickly once the burn stops.  Defaults: fast =
  (5m, 1h) at 14.4x, slow = (30m, 6h) at 6x; ``clock_scale`` shrinks
  every window uniformly so compressed bench/e2e clocks keep the same
  math.

Alerts are emitted as ``distlr_alert_slo_burn{slo,window}`` through the
same alert list ``evaluate_alerts`` produces — the flight recorder,
profiler bursts, rollout gater, and autopilot rollback inherit
burn-rate triggering with zero changes to their plumbing.
"""

from __future__ import annotations

import json
import math

from distlr_tpu_torch.obs import tsdb as tsdb_mod

#: default burn-rate window pairs: (label, short_s, long_s, factor) —
#: the SRE-workbook 5m/1h @ 14.4x and 30m/6h @ 6x pairs
DEFAULT_BURN_WINDOWS = (
    ("fast", 300.0, 3600.0, 14.4),
    ("slow", 1800.0, 21600.0, 6.0),
)

_OPS = {
    "<=": lambda v, b: v <= b,
    "<": lambda v, b: v < b,
    ">=": lambda v, b: v >= b,
    ">": lambda v, b: v > b,
}


class SLOSpecError(ValueError):
    """A malformed SLO file — raised loudly at load, never mid-scrape."""


def _req(obj: dict, key: str, where: str):
    if key not in obj:
        raise SLOSpecError(f"{where}: missing required key {key!r}")
    return obj[key]


class SLO:
    """One objective: name, target, SLO window, and an SLI."""

    def __init__(self, spec: dict, *, clock_scale: float = 1.0,
                 burn_windows=DEFAULT_BURN_WINDOWS):
        where = f"slo {spec.get('name', '?')!r}"
        self.name = str(_req(spec, "name", "slo"))
        if not self.name:
            raise SLOSpecError("slo: empty name")
        self.objective = float(_req(spec, "objective", where))
        if not 0.0 < self.objective < 1.0:
            raise SLOSpecError(
                f"{where}: objective must be in (0, 1), got "
                f"{self.objective}")
        self.window_s = float(_req(spec, "window_s", where)) * clock_scale
        if self.window_s <= 0:
            raise SLOSpecError(f"{where}: window_s must be positive")
        sli = _req(spec, "sli", where)
        if not isinstance(sli, dict):
            raise SLOSpecError(f"{where}: sli must be an object")
        self.kind = str(_req(sli, "kind", where))
        if self.kind == "ratio":
            self.bad_expr = str(_req(sli, "bad", where))
            self.total_expr = str(_req(sli, "total", where))
            self._check_expr(self.bad_expr, where)
            self._check_expr(self.total_expr, where)
        elif self.kind == "threshold":
            self.expr = str(_req(sli, "expr", where))
            self._check_expr(self.expr, where)
            self.bound = float(_req(sli, "bound", where))
            op = str(sli.get("op", "<="))
            if op not in _OPS:
                raise SLOSpecError(
                    f"{where}: op must be one of {sorted(_OPS)}, got "
                    f"{op!r}")
            self.op = op
        else:
            raise SLOSpecError(
                f"{where}: sli.kind must be 'ratio' or 'threshold', got "
                f"{self.kind!r}")
        labels = spec.get("labels") or {}
        if not isinstance(labels, dict):
            raise SLOSpecError(f"{where}: labels must be an object")
        # attribution labels (model/tenant/candidate/...) ride only on
        # the alert dicts in fleet.json — the gauge families keep fixed
        # labelnames
        self.labels = {str(k): str(v) for k, v in labels.items()}
        self.burn_windows = tuple(
            (str(lbl), float(short) * clock_scale,
             float(long) * clock_scale, float(factor))
            for lbl, short, long, factor in burn_windows)
        for lbl, short, long, factor in self.burn_windows:
            if not (0 < short < long):
                raise SLOSpecError(
                    f"{where}: burn window {lbl!r} needs "
                    f"0 < short < long, got ({short}, {long})")
            if factor <= 0:
                raise SLOSpecError(
                    f"{where}: burn window {lbl!r} factor must be "
                    f"positive, got {factor}")

    @staticmethod
    def _check_expr(expr: str, where: str) -> None:
        try:
            tsdb_mod.check_expr(expr)
        except ValueError as e:
            raise SLOSpecError(
                f"{where}: bad sli expression {expr!r}: {e}") from e

    # -- SLI ---------------------------------------------------------------
    def bad_series(self) -> str:
        return f"slo:{self.name}:bad"

    def observe(self, db: tsdb_mod.FleetTSDB, now: float) -> None:
        """Per-tick bookkeeping: threshold SLIs record their 0/1 bad
        sample so windowed bad fractions are just ``avg_over_time``."""
        if self.kind != "threshold":
            return
        v = db.query(self.expr, window_s=min(self.window_s, 60.0), now=now)
        if v is None:
            return          # no data is unknown, not good and not bad
        good = _OPS[self.op](v, self.bound)
        db.record(self.bad_series(), None, now, 0.0 if good else 1.0)

    def bad_fraction(self, db: tsdb_mod.FleetTSDB, window_s: float,
                     now: float) -> float | None:
        if self.kind == "threshold":
            frac = db.query(f"avg_over_time({self.bad_series()})",
                            window_s=window_s, now=now)
        else:
            bad = db.query(self.bad_expr, window_s=window_s, now=now)
            total = db.query(self.total_expr, window_s=window_s, now=now)
            if bad is None or total is None or total <= 0:
                return None
            frac = bad / total
        if frac is None:
            return None
        return min(1.0, max(0.0, frac))

    # -- budget math -------------------------------------------------------
    def burn_rate(self, db: tsdb_mod.FleetTSDB, window_s: float,
                  now: float) -> float | None:
        frac = self.bad_fraction(db, window_s, now)
        if frac is None:
            return None
        return frac / (1.0 - self.objective)

    def budget_remaining(self, db: tsdb_mod.FleetTSDB,
                         now: float) -> float | None:
        burn = self.burn_rate(db, self.window_s, now)
        if burn is None:
            return None
        return 1.0 - burn


def load_slo_spec(doc: dict) -> list[SLO]:
    """Compile a parsed SLO file into objectives (raises
    :class:`SLOSpecError` on any malformed entry)."""
    if not isinstance(doc, dict):
        raise SLOSpecError("slo file: top level must be an object")
    clock_scale = float(doc.get("clock_scale", 1.0))
    if clock_scale <= 0:
        raise SLOSpecError(
            f"slo file: clock_scale must be positive, got {clock_scale}")
    raw_windows = doc.get("burn_windows")
    if raw_windows is not None:
        if not isinstance(raw_windows, list) or not raw_windows:
            raise SLOSpecError("slo file: burn_windows must be a "
                               "non-empty list")
        windows = tuple(
            (str(_req(w, "name", "burn_window")),
             float(_req(w, "short_s", "burn_window")),
             float(_req(w, "long_s", "burn_window")),
             float(_req(w, "factor", "burn_window")))
            for w in raw_windows)
    else:
        windows = DEFAULT_BURN_WINDOWS
    slos_doc = doc.get("slos")
    if not isinstance(slos_doc, list) or not slos_doc:
        raise SLOSpecError("slo file: 'slos' must be a non-empty list")
    slos = [SLO(s, clock_scale=clock_scale, burn_windows=windows)
            for s in slos_doc]
    names = [s.name for s in slos]
    if len(set(names)) != len(names):
        raise SLOSpecError(f"slo file: duplicate slo names in {names}")
    return slos


def load_slo_file(path: str) -> tuple[list[SLO], list[tsdb_mod.RecordingRule]]:
    """Parse + compile an SLO file; also returns any extra recording
    rules it declares (``"rules": [{"name", "expr", "window_s"}]``)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise SLOSpecError(f"cannot read slo file {path}: {e}") from e
    except ValueError as e:
        raise SLOSpecError(f"slo file {path} is not valid JSON: {e}") from e
    slos = load_slo_spec(doc)
    rules = []
    for r in doc.get("rules") or []:
        try:
            rules.append(tsdb_mod.RecordingRule(
                _req(r, "name", "rule"), _req(r, "expr", "rule"),
                float(r.get("window_s", 30.0))))
        except ValueError as e:
            raise SLOSpecError(f"slo file {path}: bad rule: {e}") from e
    return slos, rules


class SLOEngine:
    """Evaluates every objective each scrape tick: writes the budget /
    burn gauges into the merged registry, appends burn alerts onto the
    scrape's alert list (same dict shape ``evaluate_alerts`` emits, so
    every downstream consumer — flight recorder, rollout gate,
    autopilot — inherits them), and returns fleet.json summaries."""

    def __init__(self, slos: list[SLO]):
        self.slos = list(slos)
        # last firing state per (slo, window): a window with NO data
        # holds its previous state — a missed scrape neither pages nor
        # resolves (resolving on absence would flap the pager and
        # re-edge the flight recorder every stall)
        self._firing: dict[tuple[str, str], bool] = {}

    def evaluate(self, db: tsdb_mod.FleetTSDB, reg, now: float,
                 alerts: list) -> list[dict]:
        budget_g = reg.gauge(
            "distlr_slo_budget_remaining",
            "Fraction of the SLO window's error budget remaining "
            "(1 = untouched, 0 = exhausted, negative = overspent; "
            "NaN = no data yet)", ("slo",))
        burn_g = reg.gauge(
            "distlr_slo_burn_rate",
            "Error-budget burn rate over each alerting window "
            "(1 = burning exactly the budget; NaN = no data yet)",
            ("slo", "window"))
        alert_g = reg.gauge(
            "distlr_alert_slo_burn",
            "1 while an SLO burn-rate window pair (short AND long over "
            "its factor) is firing", ("slo", "window", "threshold"))
        summaries = []
        for slo in self.slos:
            slo.observe(db, now)
            budget = slo.budget_remaining(db, now)
            budget_g.labels(slo=slo.name).set(
                budget if budget is not None else math.nan)
            summary = {
                "name": slo.name,
                "objective": slo.objective,
                "window_s": slo.window_s,
                "budget_remaining": budget,
                "burn": {},
            }
            for lbl, short_s, long_s, factor in slo.burn_windows:
                short = slo.burn_rate(db, short_s, now)
                long = slo.burn_rate(db, long_s, now)
                burn_g.labels(slo=slo.name, window=lbl).set(
                    long if long is not None else math.nan)
                if short is None or long is None:
                    # no data: hold the previous state (see __init__)
                    firing = self._firing.get((slo.name, lbl), False)
                else:
                    firing = short >= factor and long >= factor
                self._firing[(slo.name, lbl)] = firing
                alert_g.labels(slo=slo.name, window=lbl,
                               threshold=f"{factor:g}").set(
                    1.0 if firing else 0.0)
                labels = {"slo": slo.name, "window": lbl, **slo.labels}
                alerts.append({
                    "name": "distlr_alert_slo_burn",
                    "labels": labels,
                    "firing": firing,
                    "value": (round(long, 6)
                              if long is not None and math.isfinite(long)
                              else None),
                    "threshold": factor,
                })
                summary["burn"][lbl] = {
                    "short": short, "long": long, "factor": factor,
                    "firing": firing,
                }
            summaries.append(summary)
        return summaries
