"""The autopilot daemon: sensors -> policy -> actuators, on a tick.

``launch autopilot`` wraps this in a process (the port's copy of
``distlr_tpu/autopilot/daemon.py``); everything here is stdlib-light,
because the controller must keep working
while the data plane it is scaling is on fire (the same stance as the
router, obs-agg, the chaos proxy, and the membership coordinator).

Per tick (``autopilot.tick`` span):

1. poll obs-agg's ``/fleet.json`` and reduce it to
   :class:`~distlr_tpu_torch.autopilot.policy.FleetSignals` — cumulative
   percentiles straight off the rows, windowed rates (push/s, shed/s,
   req/s) from successive polls (seeded from the run dir's
   ``history.jsonl`` at startup, so a freshly restarted daemon is not
   blind for a full window);
2. poll the bound alerts through the same
   :func:`~distlr_tpu_torch.serve.rollout.fleet_alert_poller` fail-safe the
   rollout gater uses (unreachable => synthetic alert => hold);
3. ask the deterministic :class:`PolicyEngine` for at most one action;
4. execute it via :class:`~distlr_tpu_torch.autopilot.actuators.Actuators`
   (``autopilot.action`` span), absorbing failures into the decision's
   ``outcome`` and ``distlr_autopilot_errors_total``;
5. append the full decision to ``<run_dir>/autopilot/decisions.jsonl``
   and refresh the ``distlr_autopilot_*`` gauges.

Concurrency: one loop thread through the :mod:`distlr_tpu_torch.sync`
facade; shared state is written under ``_lock``; :meth:`status` is a
deliberately lock-free monitoring snapshot.
"""

from __future__ import annotations

import json
import os
import time
import urllib.request

from distlr_tpu_torch import sync
from distlr_tpu_torch.autopilot.actuators import ActuatorError, Actuators
from distlr_tpu_torch.autopilot.policy import (
    ACTUATORS,
    Decision,
    FleetSignals,
    PolicyEngine,
)
from distlr_tpu_torch.obs import dtrace
from distlr_tpu_torch.obs import tsdb as tsdb_mod
from distlr_tpu_torch.obs.registry import get_registry
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: decision-journal format version, pinned as the file's FIRST line
#: ``{"schema": 1, "kind": "autopilot_decisions", ...}`` (mirroring the
#: chaos event-log pin).  Readers — ``launch top``'s journal
#: pane, federate's last-action column, fleetsim's replay loader —
#: reject headerless or unknown-schema journals LOUDLY instead of
#: misparsing decision lines written by a different build.
JOURNAL_SCHEMA = 1

_reg = get_registry()
_TICKS = _reg.counter(
    "distlr_autopilot_ticks_total",
    "autopilot control-loop ticks by decision rule (steady / holds / "
    "the per-actuator up/down rules / rollback_on_alert)",
    labelnames=("rule",),
)
_ACTIONS = _reg.counter(
    "distlr_autopilot_actions_total",
    "scaling actions the autopilot issued, by actuator and direction",
    labelnames=("actuator", "direction"),
)
_ERRORS = _reg.counter(
    "distlr_autopilot_errors_total",
    "actions an actuator refused or failed (journaled as the "
    "decision's outcome; the daemon holds and retries on later ticks)",
    labelnames=("actuator",),
)
_ROLLBACKS = _reg.counter(
    "distlr_autopilot_rollbacks_total",
    "actions automatically reverted because a bound distlr_alert_* "
    "gauge fired inside the rollback window",
    labelnames=("actuator",),
)
_TARGET = _reg.gauge(
    "distlr_autopilot_target",
    "the autopilot's current desired count per actuator (equals "
    "current in steady state; diverges for exactly one tick per "
    "action)",
    labelnames=("actuator",),
)
_CURRENT = _reg.gauge(
    "distlr_autopilot_current",
    "live actuator count the autopilot observed this tick (-1 while "
    "the actuator endpoint is unreachable)",
    labelnames=("actuator",),
)
_HOLDING = _reg.gauge(
    "distlr_autopilot_holding",
    "1 while the actuator sits in its post-action (or post-alert) "
    "cooldown and the policy will not move it",
    labelnames=("actuator",),
)


def _rate_key(row: dict) -> tuple:
    return (row.get("role"), row.get("rank"))


# The rate window lives in the shared fleet tsdb (one rate arithmetic
# everywhere); the name stays importable, as in the JAX package.
_RateWindow = tsdb_mod.RateWindow


class AutopilotDaemon:
    """One closed control loop over one fleet.

    ``fetch`` (injected for tests and schedcheck) returns the decoded
    ``/fleet.json`` document or raises ``OSError``; ``alert_poll`` is
    a zero-arg callable returning firing bound-alert names (the
    rollout gater's contract).  ``clock`` must be the same clock the
    policy's cooldown arithmetic should follow (:func:`sync.monotonic`
    in production, virtual under schedcheck, hand-stepped in tests).
    """

    def __init__(self, policy: PolicyEngine, actuators: Actuators, *,
                 fetch, alert_poll=None, interval_s: float = 2.0,
                 journal_dir: str | None = None,
                 rate_window_s: float = 10.0, clock=None):
        self.policy = policy
        self.actuators = actuators
        self.fetch = fetch
        self.alert_poll = alert_poll
        self.interval_s = float(interval_s)
        self.clock = clock or sync.monotonic
        self.journal_path: str | None = None
        if journal_dir:
            ap_dir = os.path.join(journal_dir, "autopilot")
            os.makedirs(ap_dir, exist_ok=True)
            self.journal_path = os.path.join(ap_dir, "decisions.jsonl")
        self._rates = _RateWindow(rate_window_s)
        self._lock = sync.Lock()
        self._stop = sync.Event()
        self._thread = None
        self.ticks = 0
        self.actions = 0
        self.errors = 0
        self.last_decision: Decision | None = None

    # -- sensors -----------------------------------------------------------
    def seed_rates_from_history(self, run_dir: str) -> int:
        """Prime the rate window from obs-agg's ``history.jsonl`` (the
        last few lines inside the horizon), so the first live tick
        already has a windowed rate.  Best-effort: no file, no window.
        History rows carry a wall-clock stamp (``updated`` from the
        live aggregator, ``t`` in older fixtures — ``tsdb.load_history``
        accepts both; recognizing only ``t`` used to silently seed 0
        from every REAL history file); the window needs only deltas, so
        rows are rebased onto this daemon's clock."""
        rows = tsdb_mod.load_history(
            os.path.join(run_dir, "history.jsonl"), limit=64)
        if len(rows) < 2:
            return 0
        now = self.clock()
        newest = rows[-1][0]
        seeded = 0
        for t, doc in rows:
            if newest - t > self._rates.window_s:
                continue
            self._rates.push(now - (newest - t),
                             self._totals(doc.get("ranks", [])))
            seeded += 1
        return seeded

    @staticmethod
    def _totals(ranks: list) -> dict:
        tot: dict = {"pushes": 0.0, "route_shed": 0.0, "route_requests": 0.0}
        for row in ranks:
            for key in tot:
                v = row.get(key)
                if isinstance(v, (int, float)):
                    tot[key] += v
        return tot

    def _signals(self, now: float) -> FleetSignals:
        try:
            doc = self.fetch()
        except (OSError, ValueError):
            return FleetSignals(reachable=False)
        ranks = doc.get("ranks", [])
        self._rates.push(now, self._totals(ranks))

        def row_max(key: str) -> float | None:
            vals = [r[key] for r in ranks
                    if isinstance(r.get(key), (int, float))]
            return max(vals) if vals else None

        alerts: tuple = ()
        if self.alert_poll is not None:
            try:
                alerts = tuple(self.alert_poll())
            except Exception as e:  # noqa: BLE001 — poller bugs hold safe
                alerts = (f"autopilot_alert_poll_failed:{type(e).__name__}",)
        return FleetSignals(
            reachable=True,
            alerts=alerts,
            staleness_pushes_p99=row_max("staleness_pushes_p99"),
            push_rate=self._rates.rate("pushes"),
            shed_rate=self._rates.rate("route_shed"),
            route_p99_ms=row_max("route_p99_ms"),
            req_rate=self._rates.rate("route_requests"),
            shard_lag=row_max("shard_lag"),
        )

    # -- one tick ----------------------------------------------------------
    def tick_once(self) -> Decision:
        now = self.clock()
        with dtrace.span("autopilot.tick"):
            signals = self._signals(now)
            current = self.actuators.current()
            decision = self.policy.tick(signals, current, now)
            if decision.action is not None:
                act = decision.action
                with dtrace.span("autopilot.action", tags={
                        "actuator": act.actuator,
                        "direction": act.direction,
                        "to": act.to_count}):
                    try:
                        decision.outcome = self.actuators.apply(
                            act.actuator, act.to_count)
                        _ACTIONS.labels(actuator=act.actuator,
                                        direction=act.direction).inc()
                        if decision.rule == "rollback_on_alert":
                            _ROLLBACKS.labels(actuator=act.actuator).inc()
                        log.info("autopilot: %s %s %d -> %d (%s)",
                                 decision.rule, act.actuator,
                                 act.from_count, act.to_count,
                                 decision.outcome)
                    except ActuatorError as e:
                        decision.outcome = f"error: {e}"
                        _ERRORS.labels(actuator=act.actuator).inc()
                        log.warning("autopilot: %s %s failed: %s",
                                    decision.rule, act.actuator, e)
            self._export(decision, current)
            self._journal(decision)
        with self._lock:
            self.ticks += 1
            if decision.action is not None:
                self.actions += 1
                if decision.outcome and decision.outcome.startswith("error"):
                    self.errors += 1
            self.last_decision = decision
        return decision

    def _export(self, decision: Decision, current: dict) -> None:
        _TICKS.labels(rule=decision.rule).inc()
        for a in ACTUATORS:
            cur = current.get(a)
            _CURRENT.labels(actuator=a).set(-1.0 if cur is None else cur)
            target = cur
            if decision.action is not None and decision.action.actuator == a:
                target = decision.action.to_count
            if target is not None:
                _TARGET.labels(actuator=a).set(float(target))
            _HOLDING.labels(actuator=a).set(
                1.0 if decision.holding.get(a) else 0.0)

    def _journal(self, decision: Decision) -> None:
        if self.journal_path is None:
            return
        # the decision's own "t" is the policy clock (monotonic in
        # production — what the cooldown arithmetic and the replay
        # tests pin); "ts" anchors the line on the wall clock so the
        # incident engine can place it on a fleet timeline
        doc = json.loads(decision.to_json())
        doc["ts"] = round(time.time(), 6)
        with open(self.journal_path, "a") as f:
            if f.tell() == 0:
                f.write(json.dumps(
                    {"schema": JOURNAL_SCHEMA,
                     "kind": "autopilot_decisions"}) + "\n")
            f.write(json.dumps(doc) + "\n")

    # -- lifecycle ---------------------------------------------------------
    @staticmethod
    def read_journal(path: str) -> list[dict]:
        """Load a decision journal, VALIDATING the schema header.

        The shared reader behind fleetsim's ``--replay`` loader and
        ``launch top``'s journal pane: the first line must be the
        ``{"schema": 1, "kind": "autopilot_decisions"}`` pin — a
        headerless file (an older build) or an unknown schema
        raises ``ValueError`` instead of silently misparsing decision
        lines whose shape this build does not know.  Trailing partial
        lines (a live daemon mid-append) are tolerated."""
        with open(path, encoding="utf-8") as f:
            first = f.readline()
            try:
                header = json.loads(first)
            except ValueError:
                header = None
            if (not isinstance(header, dict)
                    or header.get("kind") != "autopilot_decisions"):
                raise ValueError(
                    f"{path}: not a journal — first line must be the "
                    '{"schema": ..., "kind": "autopilot_decisions"} '
                    "header (headerless journals predate the schema; "
                    "re-run the daemon to regenerate)")
            if header.get("schema") != JOURNAL_SCHEMA:
                raise ValueError(
                    f"{path}: journal schema {header.get('schema')!r}, "
                    f"this build reads {JOURNAL_SCHEMA}")
            docs = []
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    docs.append(json.loads(line))
                except ValueError:
                    break  # a torn tail ends the readable prefix
            return docs

    def run_forever(self) -> None:
        while not self._stop.is_set():
            t0 = self.clock()
            try:
                self.tick_once()
            except Exception:  # a bad tick must not kill the daemon
                log.exception("autopilot tick failed; holding")
            elapsed = self.clock() - t0
            self._stop.wait(max(0.05, self.interval_s - elapsed))

    def start(self) -> "AutopilotDaemon":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = sync.Thread(target=self.run_forever,
                                       daemon=True, name="distlr-autopilot")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.actuators.close()

    def status(self) -> dict:
        """Lock-free monitoring snapshot (torn reads tolerated — the
        counters are ints and the decision swap is atomic on CPython;
        audited in the concurrency baseline, cross-referenced to the
        ``autopilot_tick_stop`` schedcheck scenario)."""
        last = self.last_decision
        return {
            "ticks": self.ticks,
            "actions": self.actions,
            "errors": self.errors,
            "last_rule": last.rule if last else None,
            "last_action": (last.action.to_doc()
                            if last and last.action else None),
            "holding": dict(last.holding) if last else {},
        }

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def fleet_fetcher(fleet_url: str, *, timeout_s: float = 2.0):
    """The production ``fetch``: GET ``<fleet_url>/fleet.json``."""
    url = fleet_url.rstrip("/") + "/fleet.json"

    def fetch() -> dict:
        with urllib.request.urlopen(url, timeout=timeout_s) as r:
            return json.load(r)

    return fetch
