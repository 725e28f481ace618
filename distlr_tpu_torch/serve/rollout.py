"""Canary ramps with automatic rollback: safe version rollout.

Counterpart of ``distlr_tpu/serve/rollout.py``.  ``launch rollout`` drives
a routing tier's ``SPLIT`` / ``PROMOTE`` admin lines
(:mod:`~distlr_tpu_torch.serve.router`) through a staged weight ramp (for
example 5% -> 25% -> 50% -> 100% with a hold at each stage) while polling
an alert source: the ``/fleet.json`` of a running aggregator
(:func:`fleet_alert_poller`), or none for an unwatched ramp.  A bound
alert firing mid-ramp rolls the split back in one admin round trip; the
primary never stopped serving.

Every transition is journaled as JSONL under ``<journal_dir>/rollout/``,
with the JAX package's event names (``start``, ``stage``, ``promote``,
``rollback``, ``rollback_error``, ``abort``) and outcomes (``promoted``,
``rolled_back``, ``aborted``), and recorded in the JAX package's
``distlr_rollout_*`` registry series (the split weight, transitions by
event, rollbacks).  Stdlib only.
"""

from __future__ import annotations

import json
import os
import re
import socket
import time
import urllib.request

from distlr_tpu_torch.obs.registry import get_registry
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_reg = get_registry()
_ROLLOUT_WEIGHT = _reg.gauge(
    "distlr_rollout_weight",
    "current canary split weight of an in-flight rollout (candidate "
    "share of the tenant's traffic; 0 after a rollback)",
    labelnames=("tenant", "candidate"),
)
_ROLLOUT_TRANSITIONS = _reg.counter(
    "distlr_rollout_transitions_total",
    "rollout state transitions by event (start/stage/promote/"
    "rollback/abort)",
    labelnames=("event",),
)
_ROLLOUT_ROLLBACKS = _reg.counter(
    "distlr_rollout_rollbacks_total",
    "canary ramps rolled back automatically by a firing alert gauge",
    labelnames=("tenant", "candidate"),
)


def parse_stages(spec: str) -> list[tuple[float, float]]:
    """``"0.05:10,0.25:10,1.0:30"`` -> ``[(weight, hold_s), ...]``.  Weights
    ascend in (0, 1] and the last is 1.0 (a ramp that never reaches full
    weight cannot promote); a stage without ``:hold`` holds 5 s."""
    stages: list[tuple[float, float]] = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        w, _, hold = part.partition(":")
        try:
            weight = float(w)
            hold_s = float(hold) if hold else 5.0
        except ValueError as e:
            raise ValueError(f"bad stage {part!r}: {e}") from None
        if not 0.0 < weight <= 1.0:
            raise ValueError(f"stage weight must be in (0, 1], got {weight}")
        if hold_s < 0:
            raise ValueError(f"stage hold must be >= 0s, got {hold_s}")
        stages.append((weight, hold_s))
    if not stages:
        raise ValueError("ramp needs at least one stage")
    if any(b[0] <= a[0] for a, b in zip(stages, stages[1:])):
        raise ValueError(f"stage weights must ascend, got {spec!r}")
    if stages[-1][0] != 1.0:
        raise ValueError(f"last stage must be weight 1.0 (full cut-over), got {stages[-1][0]}")
    return stages


#: alert label keys that attribute an alert to a model version: an alert
#: carrying any of them belongs to the named model(s); one carrying none
#: is fleet-wide
ATTRIBUTION_KEYS = ("model", "tenant", "candidate", "namespace")


def attributable(alert: dict, model: str) -> bool:
    """Whether a ``/fleet.json`` alert names ``model`` in one of its
    :data:`ATTRIBUTION_KEYS` labels (an alert with none of them is
    fleet-scoped, and False)."""
    labels = alert.get("labels") or {}
    named = [str(labels[k]) for k in ATTRIBUTION_KEYS if k in labels]
    return bool(named) and str(model) in named


def fleet_alert_poller(fleet_url: str, *, names=None, prefix: str = "distlr_alert_",
                       timeout_s: float = 2.0, scope_model: str | None = None,
                       scope_slo: str | None = None):
    """An ``alert_poll`` callable over an aggregator's ``/fleet.json``: the
    firing alerts (``name{labels}``) bound by ``names`` (exact) or
    ``prefix``.  An unreachable aggregator reports the synthetic
    ``rollout_fleet_unreachable``: a blind ramp is never safe.
    ``scope_model`` keeps only alerts :func:`attributable` to that model;
    ``scope_slo`` only those labelled ``slo=<name>``.  The unreachable
    alert always gates."""
    url = fleet_url.rstrip("/") + "/fleet.json"
    bound = set(names) if names else None

    def poll() -> list[str]:
        try:
            with urllib.request.urlopen(url, timeout=timeout_s) as r:
                doc = json.load(r)
        except (OSError, ValueError):
            return ["rollout_fleet_unreachable"]
        firing = []
        for a in doc.get("alerts", []):
            if not a.get("firing"):
                continue
            name = a.get("name", "")
            if bound is not None:
                if name not in bound:
                    continue
            elif not name.startswith(prefix):
                continue
            if scope_model is not None and not attributable(a, scope_model):
                continue
            if scope_slo is not None and str((a.get("labels") or {}).get("slo")) != str(scope_slo):
                continue
            labels = a.get("labels") or {}
            shown = ",".join(f"{k}={v}" for k, v in sorted(labels.items()) if k != "threshold")
            firing.append(f"{name}{{{shown}}}" if shown else name)
        return firing

    return poll


class RouterAdmin:
    """Line-protocol client of the router's admin verbs, one connection a
    call (a ramp sends a handful of lines over minutes)."""

    def __init__(self, host: str, port: int, *, timeout_s: float = 10.0):
        self.host, self.port = host, int(port)
        self.timeout_s = float(timeout_s)

    def send(self, line: str) -> str:
        with socket.create_connection((self.host, self.port), timeout=self.timeout_s) as s:
            f = s.makefile("rwb")
            f.write((line.strip() + "\n").encode())
            f.flush()
            reply = f.readline()
        if not reply:
            raise ConnectionError(f"router {self.host}:{self.port} closed mid-exchange")
        return reply.decode().rstrip("\n")

    def expect_ok(self, line: str) -> str:
        reply = self.send(line)
        if not reply.startswith("OK"):
            raise RuntimeError(f"router refused {line.split()[0]}: {reply}")
        return reply

    def models(self) -> dict:
        return json.loads(self.send("MODELS"))


class RolloutController:
    """One canary ramp: tenant -> candidate through staged weights.

    ``alert_poll``: a zero-argument callable returning the currently
    firing bound alerts (:func:`fleet_alert_poller`); None ramps on the
    stage timers alone, logged loudly, since rollback is then manual.
    """

    def __init__(self, admin: RouterAdmin, tenant: str, candidate: str, stages, *,
                 alert_poll=None, poll_interval_s: float = 0.5, shadow_fraction: float = 0.0,
                 journal_dir: str | None = None, settle_s: float = 0.0):
        if isinstance(stages, str):
            stages = parse_stages(stages)
        if not stages:
            raise ValueError("ramp needs at least one stage")
        self.admin = admin
        self.tenant = str(tenant)
        self.candidate = str(candidate)
        self.stages = [(float(w), float(h)) for w, h in stages]
        self.alert_poll = alert_poll
        self.poll_interval_s = float(poll_interval_s)
        self.shadow_fraction = float(shadow_fraction)
        self.settle_s = float(settle_s)
        self.journal_path: str | None = None
        if journal_dir:
            rollout_dir = os.path.join(journal_dir, "rollout")
            os.makedirs(rollout_dir, exist_ok=True)
            seq = 0
            for name in os.listdir(rollout_dir):
                m = re.match(r"ramp-(\d+)\.jsonl$", name)
                if m:
                    seq = max(seq, int(m.group(1)) + 1)
            self.journal_path = os.path.join(rollout_dir, f"ramp-{seq:04d}.jsonl")
        #: the current split weight (0 after a rollback or a promotion)
        self.weight = 0.0
        self._weight_g = _ROLLOUT_WEIGHT.labels(tenant=self.tenant, candidate=self.candidate)
        self.transitions: list[dict] = []

    def _set_weight(self, weight: float) -> None:
        self.weight = weight
        self._weight_g.set(weight)

    def _journal(self, event: str, **detail) -> dict:
        doc = {"t": round(time.time(), 3), "event": event, "tenant": self.tenant,
               "candidate": self.candidate, **detail}
        self.transitions.append(doc)
        _ROLLOUT_TRANSITIONS.labels(event=event).inc()
        if self.journal_path:
            with open(self.journal_path, "a") as f:
                f.write(json.dumps(doc) + "\n")
        return doc

    def _firing(self) -> list[str]:
        if self.alert_poll is None:
            return []
        try:
            return list(self.alert_poll())
        except Exception as e:  # noqa: BLE001 — a poller bug fails the ramp safe
            return [f"rollout_alert_poll_failed:{type(e).__name__}"]

    def _hold(self, hold_s: float) -> list[str]:
        """Hold at the current weight, polling; the firing set that broke
        the hold, or [] when it held clean."""
        deadline = time.monotonic() + hold_s
        while True:
            firing = self._firing()
            if firing:
                return firing
            if time.monotonic() >= deadline:
                return []
            time.sleep(min(self.poll_interval_s, max(0.0, deadline - time.monotonic())))

    def run(self) -> dict:
        """Drive the ramp to promotion or rollback.  The outcome doc (also
        the journal's last line): ``promoted``, ``rolled_back`` (with the
        alerts and the stage it stopped at), or ``aborted`` (alerts before
        the ramp, or a registry problem)."""
        hosted = self.admin.models().get("models", {})
        for m in (self.tenant, self.candidate):
            if m not in hosted:
                self._journal("abort", reason=f"unknown model {m!r}")
                return {"outcome": "aborted",
                        "reason": f"model {m!r} not registered (hosted: {sorted(hosted)})"}
        if hosted[self.candidate].get("up", 0) < 1:
            self._journal("abort", reason="candidate has no healthy replica")
            return {"outcome": "aborted",
                    "reason": f"candidate {self.candidate!r} has no healthy replica — "
                              "nothing to ramp onto"}
        firing = self._firing()
        if firing:
            self._journal("abort", reason="alerts firing pre-ramp", alerts=firing)
            return {"outcome": "aborted", "alerts": firing,
                    "reason": "bound alerts already firing before the ramp started — "
                              "fix the fleet first"}
        if self.alert_poll is None:
            log.warning("ramp %s -> %s runs UNWATCHED (no alert poller): rollback can only "
                        "be manual", self.tenant, self.candidate)
        self._journal("start", stages=[[w, h] for w, h in self.stages],
                      shadow=self.shadow_fraction or None, watched=self.alert_poll is not None)
        if self.shadow_fraction > 0:
            # watch the candidate against live traffic before it takes any
            try:
                self.admin.expect_ok(f"SHADOW {self.tenant} {self.candidate} "
                                     f"{self.shadow_fraction:g}")
            except (OSError, RuntimeError) as e:
                return self._rollback("shadow", [f"rollout_admin_failed:{e}"])
            if self.settle_s > 0:
                broke = self._hold(self.settle_s)
                if broke:
                    return self._rollback("shadow", broke)
        for i, (weight, hold_s) in enumerate(self.stages):
            try:
                self.admin.expect_ok(f"SPLIT {self.tenant} {self.candidate} {weight:g}")
            except (OSError, RuntimeError) as e:
                # a failed exchange mid-ramp must not leave the last stage's
                # split live and unwatched
                return self._rollback(i, [f"rollout_admin_failed:{e}"])
            self._set_weight(weight)
            self._journal("stage", stage=i, weight=weight, hold_s=hold_s)
            log.info("ramp %s -> %s: stage %d/%d at weight %.2f (hold %.1fs)", self.tenant,
                     self.candidate, i + 1, len(self.stages), weight, hold_s)
            broke = self._hold(hold_s)
            if broke:
                return self._rollback(i, broke)
        try:
            self.admin.expect_ok(f"PROMOTE {self.tenant} {self.candidate}")
        except (OSError, RuntimeError) as e:
            # at full weight with a failed cut-over: clear the split rather
            # than serve 100% canary indefinitely
            return self._rollback(len(self.stages) - 1, [f"rollout_admin_failed:{e}"])
        if self.shadow_fraction > 0:
            # PROMOTE clears it router-side; one idempotent line for older routers
            try:
                self.admin.send(f"SHADOW {self.tenant} {self.candidate} 0")
            except OSError:
                pass
        self._set_weight(0.0)
        doc = self._journal("promote")
        log.info("ramp %s -> %s: PROMOTED (%d stages clean)", self.tenant, self.candidate,
                 len(self.stages))
        return {"outcome": "promoted", "stages": len(self.stages),
                "journal": self.journal_path, "transitions": doc["t"]}

    def _rollback(self, stage, alerts: list[str]) -> dict:
        try:
            self.admin.expect_ok(f"SPLIT {self.tenant} {self.candidate} 0")
            if self.shadow_fraction > 0:
                self.admin.send(f"SHADOW {self.tenant} {self.candidate} 0")
        except (OSError, RuntimeError) as e:
            # the rollback line failed; the router may be down (then it
            # serves no split either)
            self._journal("rollback_error", error=str(e))
        self._set_weight(0.0)
        _ROLLOUT_ROLLBACKS.labels(tenant=self.tenant, candidate=self.candidate).inc()
        self._journal("rollback", stage=stage, alerts=alerts)
        log.warning("ramp %s -> %s: ROLLED BACK at stage %s — firing: %s", self.tenant,
                    self.candidate, stage, ", ".join(alerts))
        return {"outcome": "rolled_back", "stage": stage, "alerts": alerts,
                "journal": self.journal_path}
