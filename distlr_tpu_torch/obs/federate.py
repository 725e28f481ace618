"""Fleet federation: one scrape for a whole run (the port's copy of
``distlr_tpu/obs/federate.py``, stdlib only).

* **endpoint discovery**: every launched process with
  ``Config.obs_run_dir`` set writes ``<run_dir>/endpoints/<role>-<rank>
  .json`` (role, rank, host, port, pid) next to its ``METRICS
  host:port`` announcement; :func:`discover_endpoints` re-lists the
  directory every poll, so late joiners appear without restarts.
  One-shot processes that cannot hold a port bank a JSON registry
  snapshot under ``<run_dir>/snapshots/<role>-<rank>.json`` (the
  ``DISTLR_METRICS_SNAPSHOT`` twin); the scraper merges both sources.
  A run dir written by processes of both packages is one fleet.

* **federation**: :class:`FleetScraper` polls each endpoint's
  ``/metrics.json`` and merges the families into ONE fleet registry:
  counters sum across ranks, histograms merge bucket-wise (boundary
  mismatches are rejected loudly, never silently summed), and gauges
  keep per-rank identity through added ``role``/``rank`` labels (an
  original label named ``role``/``rank`` is renamed ``exported_*``, the
  Prometheus federation convention).  ``distlr_fleet_scrape_*``
  meta-series mark every rank up / stale / down.

* **derived alerts**: :func:`evaluate_alerts` computes
  ``distlr_alert_*`` 0/1 gauges (threshold carried as a label) from the
  merged families: barrier-wait p99 vs median step time, PS push error
  rate, scrape staleness, async weight age vs step time, retry rate,
  shadow PSI and SLO burn.  The inputs (``distlr_fleet_*`` value gauges)
  are exported too, so the thresholds are auditable from the same scrape.

``launch obs-agg`` serves the merged view as ``/metrics`` +
``/metrics.json`` + ``/fleet.json`` (the per-rank summary ``launch top``
renders) + ``/query`` (the tsdb).  The ``distlr_jax_*`` runtime series
keep the JAX package's names in the port (:mod:`distlr_tpu_torch.obs.torchrt`),
so the ``jax_compiles`` and ``device_mb`` columns read either package.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import threading
import time
import urllib.request

from distlr_tpu_torch.obs import incident as incident_mod
from distlr_tpu_torch.obs import slo as slo_mod
from distlr_tpu_torch.obs import tsdb as tsdb_mod
from distlr_tpu_torch.obs.registry import MetricsRegistry, percentile_from_counts
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Ops whose failures count toward the push error-rate alert.
_PUSH_OPS = ("push", "push_pull", "push_init")


class FleetMergeError(ValueError):
    """Two ranks disagree on a family's shape (type, label names, or
    histogram bucket boundaries) — summing them would silently alias two
    meanings onto one series, so the merge refuses instead."""


# ---------------------------------------------------------------------------
# endpoint discovery
# ---------------------------------------------------------------------------

def endpoint_path(run_dir: str, role: str, rank: int | str) -> str:
    return os.path.join(run_dir, "endpoints", f"{role}-{rank}.json")


def write_endpoint(run_dir: str, role: str, rank: int | str, host: str,
                   port: int, *, pid: int | None = None) -> str:
    """Atomically publish this process's scrape endpoint into the run
    dir (the fleet-discovery contract every ``launch`` subcommand
    honors when ``--obs-run-dir`` is set)."""
    path = endpoint_path(run_dir, role, rank)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        with open(path) as f:
            prev = json.load(f)
        if (prev.get("host"), prev.get("port")) != (host, int(port)):
            # Two processes claimed the same (role, rank) — e.g. two
            # `ps-server` hosts sharing a run dir, neither passing
            # --process-id.  The merge keys on (role, rank), so the
            # first publisher silently vanishes from the fleet (no
            # scrape, no down alert).  Surface it loudly; the fix is a
            # distinct rank per process (--process-id / --worker-ranks).
            log.warning(
                "fleet endpoint %s-%s already published by %s:%s "
                "(pid %s); overwriting with %s:%s — give each process a "
                "distinct rank (--process-id) or the hidden one will "
                "neither scrape nor alert",
                role, rank, prev.get("host"), prev.get("port"),
                prev.get("pid"), host, port)
    except (OSError, ValueError):
        pass  # absent or unreadable: normal first publish
    doc = {
        "role": str(role),
        "rank": int(rank),
        "host": host,
        "port": int(port),
        "pid": os.getpid() if pid is None else int(pid),
        "started_at": time.time(),
    }
    # per-pid tmp name: two processes racing to publish the same (role,
    # rank) — e.g. replicas launched in the same instant without
    # --process-id — must land on the warning above, not crash in
    # os.replace because one mv'd the other's shared tmp file away
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def discover_endpoints(run_dir: str) -> list[dict]:
    """All parseable endpoint files under ``<run_dir>/endpoints``,
    sorted by (role, rank).  Unparseable files (a writer mid-crash) are
    skipped, not fatal — the next poll retries them."""
    d = os.path.join(run_dir, "endpoints")
    out = []
    if not os.path.isdir(d):
        return out
    for name in sorted(os.listdir(d)):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                doc = json.load(f)
            out.append({
                "role": str(doc["role"]),
                "rank": int(doc["rank"]),
                "host": str(doc["host"]),
                "port": int(doc["port"]),
                "pid": int(doc.get("pid", 0)),
            })
        except (OSError, ValueError, KeyError):
            continue
    out.sort(key=lambda e: (e["role"], e["rank"]))
    return out


def discover_snapshot_files(run_dir: str) -> list[dict]:
    """Banked JSON registry snapshots under ``<run_dir>/snapshots``
    (``<role>-<rank>.json``, the DISTLR_METRICS_SNAPSHOT twin) — the
    portless half of the fleet (one-shot bench processes)."""
    d = os.path.join(run_dir, "snapshots")
    out = []
    if not os.path.isdir(d):
        return out
    for name in sorted(os.listdir(d)):
        stem, ext = os.path.splitext(name)
        if ext != ".json" or "-" not in stem:
            continue
        role, _, rank = stem.rpartition("-")
        if not rank.isdigit():
            continue
        out.append({"role": role, "rank": int(rank),
                    "path": os.path.join(d, name)})
    out.sort(key=lambda e: (e["role"], e["rank"]))
    return out


# ---------------------------------------------------------------------------
# snapshot math helpers (shared by the merge and /fleet.json summaries)
# ---------------------------------------------------------------------------

def _hist_parts(entry: dict) -> tuple[tuple[float, ...], list[int], int]:
    """Decompose one histogram series snapshot into ``(boundaries,
    per-bucket counts incl. the +Inf slot, total count)`` — the
    snapshot's bucket dict is CUMULATIVE (Prometheus ``le`` semantics)."""
    pairs = sorted((float(b), int(c)) for b, c in entry["buckets"].items())
    bounds = tuple(b for b, _ in pairs)
    counts, prev = [], 0
    for _, cum in pairs:
        counts.append(cum - prev)
        prev = cum
    total = int(entry["count"])
    counts.append(total - prev)  # +Inf slot
    return bounds, counts, total


def _snap_hist_percentiles(snap: dict, name: str, qs: tuple[float, ...],
                           where: dict | None = None):
    """Percentiles of a histogram family in one rank's snapshot, summing
    every series whose labels contain ``where``.  None when absent/empty."""
    fam = snap.get(name)
    if not fam or fam.get("type") != "histogram":
        return None
    bounds = None
    counts: list[int] = []
    for s in fam.get("series", []):
        if where and any(s["labels"].get(k) != v for k, v in where.items()):
            continue
        b, c, _ = _hist_parts(s)
        if bounds is None:
            bounds, counts = b, list(c)
        elif b == bounds:
            counts = [x + y for x, y in zip(counts, c)]
    if bounds is None or sum(counts) == 0:
        return None
    return tuple(percentile_from_counts(bounds, counts, q) for q in qs)


def _snap_sum(snap: dict, name: str, where: dict | None = None) -> float:
    """Sum of a counter/gauge family's series values in one snapshot."""
    fam = snap.get(name)
    if not fam:
        return 0.0
    tot = 0.0
    for s in fam.get("series", []):
        if where and any(s["labels"].get(k) != v for k, v in where.items()):
            continue
        if "value" in s:
            tot += float(s["value"])
    return tot


def _snap_max(snap: dict, name: str) -> float | None:
    fam = snap.get(name)
    if not fam:
        return None
    vals = [float(s["value"]) for s in fam.get("series", []) if "value" in s]
    return max(vals) if vals else None


_bad_journals_warned: set[str] = set()


def _read_autopilot_last_action(run_dirs: list[str]) -> dict | None:
    """Tail the autopilot's decision journal for the last ACTION (not
    the last tick — steady/hold rows carry no action).  Best-effort:
    the journal is append-only JSONL, so reading the final few KB is
    enough, and a missing/partial file just yields None.  The FIRST
    line must be the ``{"schema": 1}`` header — a headerless
    or unknown-schema journal is rejected LOUDLY (warned once per
    path), because its decision lines may not mean what this build
    thinks they mean."""
    from distlr_tpu_torch.autopilot.daemon import JOURNAL_SCHEMA  # noqa: PLC0415

    for d in run_dirs:
        path = os.path.join(d, "autopilot", "decisions.jsonl")
        try:
            with open(path, "rb") as f:
                try:
                    header = json.loads(f.readline().decode(
                        "utf-8", "replace"))
                except ValueError:
                    header = None
                if (not isinstance(header, dict)
                        or header.get("kind") != "autopilot_decisions"
                        or header.get("schema") != JOURNAL_SCHEMA):
                    if path not in _bad_journals_warned:
                        _bad_journals_warned.add(path)
                        log.warning(
                            "ignoring autopilot journal %s: missing or "
                            "unknown schema header (want {\"schema\": %d, "
                            "\"kind\": \"autopilot_decisions\"})",
                            path, JOURNAL_SCHEMA)
                    continue
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - 65536))
                lines = f.read().decode("utf-8", "replace").splitlines()
        except OSError:
            continue
        for line in reversed(lines):
            try:
                doc = json.loads(line)
            except ValueError:
                continue
            if isinstance(doc, dict) and doc.get("action"):
                return {"t": doc.get("t"), "rule": doc.get("rule"),
                        "outcome": doc.get("outcome"), **doc["action"]}
    return None


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------

def merge_snapshots(snaps: dict[tuple[str, int], dict], *,
                    registry: MetricsRegistry | None = None,
                    on_conflict: str = "raise") -> tuple[MetricsRegistry,
                                                         list[str]]:
    """Merge per-rank registry snapshots into one fleet registry.

    ``snaps`` maps ``(role, rank)`` to that rank's ``/metrics.json``
    document.  Merge rules (the federation contract):

    * **counters** sum across ranks under their original labels (fleet
      totals: ops, bytes, samples);
    * **histograms** merge bucket-wise — identical boundary ladders sum
      per-bucket; a mismatched ladder raises :class:`FleetMergeError`
      (``on_conflict="raise"``) or drops that rank's family and records
      it in the returned conflict list (``"drop"``, what the live
      scraper does — loudly, via log + meta-counter, never by summing
      misaligned buckets);
    * **gauges** keep per-rank identity: ``role``/``rank`` labels are
      prepended (original labels named ``role``/``rank`` are renamed
      ``exported_role``/``exported_rank``), because summing a gauge
      (a rate, an age, an up-flag) across ranks destroys exactly the
      per-rank signal a fleet view exists to show.

    A family whose TYPE or label names differ across ranks conflicts as
    a whole (same policy as buckets).  Ranks merge in sorted order, so
    first-seen shape wins and the outcome is deterministic.
    """
    if on_conflict not in ("raise", "drop"):
        raise ValueError(f"on_conflict must be raise|drop, got {on_conflict!r}")
    reg = registry if registry is not None else MetricsRegistry()
    conflicts: list[str] = []
    # first-seen shape per family: (kind, labelnames, bounds|None)
    shapes: dict[str, tuple] = {}

    def _conflict(rank_key, name, why):
        msg = (f"fleet merge: {name!r} from {rank_key[0]}-{rank_key[1]} "
               f"conflicts with the first-seen shape ({why})")
        if on_conflict == "raise":
            raise FleetMergeError(msg)
        log.error("%s — dropping this rank's family, NOT summing it", msg)
        conflicts.append(f"{rank_key[0]}-{rank_key[1]}:{name}")

    for rank_key in sorted(snaps):
        role, rank = rank_key
        for name, fam in snaps[rank_key].items():
            kind = fam.get("type", "gauge")
            series = fam.get("series", [])
            if not series:
                continue  # no children yet: label names unknowable
            labelnames = tuple(series[0]["labels"])
            bounds = None
            if kind == "histogram":
                bounds = _hist_parts(series[0])[0]
            seen = shapes.get(name)
            if seen is None:
                shapes[name] = (kind, labelnames, bounds)
            elif seen[0] != kind or seen[1] != labelnames:
                _conflict(rank_key, name,
                          f"type/labels {kind}/{labelnames} vs "
                          f"{seen[0]}/{seen[1]}")
                continue
            elif kind == "histogram" and seen[2] != bounds:
                _conflict(rank_key, name,
                          f"bucket boundaries {bounds} vs {seen[2]}")
                continue

            help_ = fam.get("help", "")
            if kind == "counter":
                out = reg.counter(name, help_, labelnames)
                for s in series:
                    out.labels(**s["labels"]).inc(float(s["value"]))
            elif kind == "histogram":
                out = reg.histogram(name, help_, labelnames, buckets=bounds)
                for s in series:
                    b, counts, total = _hist_parts(s)
                    if b != bounds:
                        _conflict(rank_key, name,
                                  f"bucket boundaries {b} vs {bounds}")
                        continue
                    child = out.labels(**s["labels"])
                    # merge bucket-wise into the child's internal counts
                    # (same package; a public "add counts" API would only
                    # exist for this one caller)
                    with child._lock:
                        for i, c in enumerate(counts):
                            child._counts[i] += c
                        child._sum += float(s["sum"])
                        child._count += total
            else:  # gauge (and any future untyped): per-rank identity
                renamed = tuple(
                    f"exported_{n}" if n in ("role", "rank") else n
                    for n in labelnames
                )
                out = reg.gauge(name, help_, ("role", "rank") + renamed)
                for s in series:
                    labels = {"role": role, "rank": str(rank)}
                    labels.update(
                        (f"exported_{k}" if k in ("role", "rank") else k, v)
                        for k, v in s["labels"].items()
                    )
                    out.labels(**labels).set(float(s["value"]))
    return reg, conflicts


# ---------------------------------------------------------------------------
# derived alerts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AlertThresholds:
    """Thresholds behind the ``distlr_alert_*`` gauges.  Each gauge
    carries its threshold as a label, so a scrape is self-describing."""

    #: barrier-wait p99 fires above this multiple of the median step time
    #: (a healthy BSP barrier is ~one peer's step; a straggler is many).
    barrier_wait_ratio: float = 2.0
    #: minimum barrier_wait observations before the stall alert may fire:
    #: every run records a couple of one-time startup/exit rendezvous
    #: spans whose wait is legitimately long (peers still parsing shards)
    #: — two samples of startup skew are not a straggler.
    barrier_min_count: int = 8
    #: PS push error+timeout rate (errors / total push-family ops).
    push_error_rate: float = 0.01
    #: seconds since a rank's last successful scrape before it alerts.
    scrape_stale_s: float = 10.0
    #: async weight age fires above this multiple of the median step time
    #: (Hogwild self-staleness is ~1 in-flight step; 10x means a worker
    #: is computing on ancient weights).
    weight_age_ratio: float = 10.0
    #: fleet retry fraction — the share of KV op ATTEMPTS that are
    #: retry re-issues (retries / total attempts; failed attempts count
    #: in the denominator, so the ratio is bounded [0, 1) and rises
    #: toward 1 as every op needs more tries).  Above this,
    #: distlr_alert_ps_retry_rate fires — the "network is degraded but
    #: the retry layer is absorbing it" signal; it alerts BEFORE the
    #: error-rate alert (retries precede failures).
    retry_rate: float = 0.05
    #: shadow-scoring PSI (distlr_tenant_shadow_psi) above which
    #: distlr_alert_shadow_psi fires PER (tenant, candidate) series —
    #: the one alert family ATTRIBUTABLE to a specific model version,
    #: which is what lets `launch rollout` gate a candidate's ramp on
    #: the candidate's OWN evidence instead of any fleet alert (the
    #: scoped-SLO-gating contract; see serve.rollout.attributable).
    #: Same default as the drift detector's PSI threshold.
    shadow_psi: float = 0.25

    @classmethod
    def resolve(cls, path: str | None = None, **overrides) -> "AlertThresholds":
        """Effective thresholds for one run: dataclass defaults, overlaid
        by a JSON thresholds file, overlaid by non-``None`` explicit
        overrides (the ``launch obs-agg`` CLI flags).  Unknown keys —
        in the file or the overrides — raise: a typo must not silently
        leave a default in force."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw: dict = {}
        if path:
            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                raise ValueError(
                    f"thresholds file {path} must hold a JSON object")
            unknown = sorted(set(doc) - names)
            if unknown:
                raise ValueError(
                    f"unknown threshold(s) {unknown} in {path}; "
                    f"known: {sorted(names)}")
            kw.update(doc)
        for k, v in overrides.items():
            if k not in names:
                raise ValueError(f"unknown threshold override {k!r}; "
                                 f"known: {sorted(names)}")
            if v is not None:
                kw[k] = v
        for k, v in list(kw.items()):
            # values must be numbers NOW, not when evaluate_alerts
            # formats a threshold label mid-cycle (where the daemon's
            # bad-cycle guard would swallow the crash every scrape and
            # the alert gauges would silently never publish)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(
                    f"threshold {k!r} must be a number, got {v!r}")
            if k == "barrier_min_count":
                if v != int(v):
                    # truncating 8.7 -> 8 would label an effective value
                    # the operator never wrote
                    raise ValueError(
                        f"threshold {k!r} must be an integer, got {v!r}")
                kw[k] = int(v)
            else:
                kw[k] = float(v)
        return cls(**kw)


def _merged_hist_child(reg: MetricsRegistry, name: str,
                       prefer: dict | None = None, *,
                       strict: bool = False):
    """A histogram child to take percentiles from: the labeled child
    matching ``prefer`` if it has observations, else (non-``strict``
    only) the busiest child.  ``strict`` is for label-selective reads
    like the barrier-wait phase, where falling back to a DIFFERENT
    label's series would alert on the wrong signal."""
    fam = reg.get(name)
    if fam is None or fam.kind != "histogram":
        return None
    children = fam.children()
    if not children:
        return None
    if prefer:
        want = tuple(prefer.get(n, None) for n in fam.labelnames)
        for values, child in children:
            if values == want and child.count:
                return child
        if strict:
            return None
    best = max(children, key=lambda vc: vc[1].count)[1]
    return best if best.count else None


def evaluate_alerts(reg: MetricsRegistry, *, thresholds: AlertThresholds,
                    rank_ages: dict[tuple[str, int], float] | None = None,
                    ) -> list[dict]:
    """Compute the ``distlr_alert_*`` 0/1 gauges (+ their
    ``distlr_fleet_*`` input-value gauges) inside the merged registry.

    Returns the structured alert list ``/fleet.json`` carries.  All six
    alert families are always declared — a scrape can tell "not firing"
    from "aggregator doesn't compute this".
    """
    t = thresholds
    alerts: list[dict] = []

    def emit(gauge, labels: dict, firing: bool, value, threshold):
        gauge.labels(**labels).set(1.0 if firing else 0.0)
        # non-finite values (a never-scraped rank's inf age) must not
        # reach json.dumps: Python would emit the bare token Infinity,
        # which is not JSON — every non-Python /fleet.json consumer
        # would reject the scrape exactly when a rank is down
        if value is not None and not math.isfinite(value):
            value = None
        alerts.append({"name": gauge.name, "labels": dict(labels),
                       "firing": bool(firing),
                       "value": None if value is None else round(value, 6),
                       "threshold": threshold})

    step = _merged_hist_child(reg, "distlr_train_step_seconds",
                              prefer={"loop": "ps"})
    step_p50 = step.percentile(0.5) if step is not None else None
    if step_p50 is not None:
        reg.gauge("distlr_fleet_step_seconds_p50",
                  "fleet median training step time (alert denominator)",
                  ).set(step_p50)

    # 1. barrier-wait p99 vs step time — the straggler alert.
    bw = _merged_hist_child(reg, "distlr_phase_seconds",
                            prefer={"phase": "barrier_wait"}, strict=True)
    bw_p99 = bw.percentile(0.99) if bw is not None else None
    if bw_p99 is not None:
        reg.gauge("distlr_fleet_barrier_wait_p99_seconds",
                  "fleet p99 barrier-wait phase time").set(bw_p99)
    g = reg.gauge("distlr_alert_barrier_wait_stall",
                  "1 while barrier-wait p99 exceeds threshold x median "
                  "step time (a straggler is holding the BSP round)",
                  ("threshold",))
    firing = (bw_p99 is not None and step_p50 is not None and step_p50 > 0
              and bw.count >= t.barrier_min_count
              and bw_p99 > t.barrier_wait_ratio * step_p50)
    emit(g, {"threshold": f"{t.barrier_wait_ratio:g}x_step_p50"},
         firing, bw_p99, t.barrier_wait_ratio)

    # 2. PS push error rate, from the merged op-outcome counters.
    ops = reg.get("distlr_ps_client_ops_total")
    total = bad = 0.0
    if ops is not None and ops.labelnames == ("op", "status"):
        for (op, status), child in ops.children():
            if op in _PUSH_OPS:
                total += child.value
                if status in ("error", "timeout"):
                    bad += child.value
    rate = (bad / total) if total else 0.0
    reg.gauge("distlr_fleet_push_error_rate",
              "fleet PS push error+timeout fraction").set(rate)
    g = reg.gauge("distlr_alert_ps_push_errors",
                  "1 while the fleet's PS push error+timeout rate "
                  "exceeds the threshold label", ("threshold",))
    emit(g, {"threshold": f"{t.push_error_rate:g}"},
         total > 0 and rate > t.push_error_rate, rate, t.push_error_rate)

    # 3. scrape staleness, per rank (rank_ages: seconds since last good
    # scrape; inf = never scraped).
    g = reg.gauge("distlr_alert_scrape_stale",
                  "1 while this rank's last successful scrape is older "
                  "than the threshold label (rank wedged or down)",
                  ("role", "rank", "threshold"))
    for (role, rank), age in sorted((rank_ages or {}).items()):
        emit(g, {"role": role, "rank": str(rank),
                 "threshold": f"{t.scrape_stale_s:g}s"},
             age > t.scrape_stale_s, age, t.scrape_stale_s)

    # 4. async weight age vs step time, per rank (merged gauge carries
    # role/rank + the worker's own rank as exported_rank).
    g = reg.gauge("distlr_alert_weight_age",
                  "1 while a rank's async weight age exceeds threshold x "
                  "median step time (worker riding ancient weights)",
                  ("role", "rank", "threshold"))
    stale = reg.get("distlr_train_staleness_seconds")
    if stale is not None and "role" in stale.labelnames:
        per_rank: dict[tuple[str, str], float] = {}
        idx_role = stale.labelnames.index("role")
        idx_rank = stale.labelnames.index("rank")
        for values, child in stale.children():
            key = (values[idx_role], values[idx_rank])
            per_rank[key] = max(per_rank.get(key, 0.0), child.value)
        for (role, rank), age in sorted(per_rank.items()):
            firing = (step_p50 is not None and step_p50 > 0
                      and age > t.weight_age_ratio * step_p50)
            emit(g, {"role": role, "rank": rank,
                     "threshold": f"{t.weight_age_ratio:g}x_step_p50"},
                 firing, age, t.weight_age_ratio)

    # 5. PS retry rate — the resilience layer's "absorbing faults"
    # signal: in-place retries per client op.  Fires while the network
    # is degraded even when every op ultimately SUCCEEDS, i.e. before
    # (and independently of) the push error-rate alert.
    retries = _fam_sum(reg, "distlr_ps_retries_total")
    # denominator = op ATTEMPTS (every issue, including failed tries,
    # lands in distlr_ps_client_ops_total): the ratio is the share of
    # attempts that were re-issues, bounded [0, 1)
    ops_total = _fam_sum(reg, "distlr_ps_client_ops_total")
    retry_rate = (retries / ops_total) if ops_total else 0.0
    reg.gauge("distlr_fleet_ps_retry_rate",
              "fleet in-place KV retry fraction (retry re-issues / "
              "total op attempts)").set(retry_rate)
    g = reg.gauge("distlr_alert_ps_retry_rate",
                  "1 while the fleet's in-place KV retry fraction exceeds "
                  "the threshold label (transient faults being absorbed "
                  "at volume)", ("threshold",))
    emit(g, {"threshold": f"{t.retry_rate:g}"},
         ops_total > 0 and retry_rate > t.retry_rate,
         retry_rate, t.retry_rate)

    # 6. supervisor gave up on a server rank — a dead-and-abandoned
    # range: every key it owned is frozen until a human intervenes.
    # Threshold is structurally 0 (any give-up is an outage), labeled
    # like the other alerts so the scrape stays self-describing.
    gave_up = _fam_sum(reg, "distlr_ps_supervisor_events_total",
                       {"event": "gave-up"})
    g = reg.gauge("distlr_alert_ps_gave_up",
                  "1 while the server supervisor has abandoned a rank "
                  "(respawn budget exhausted — that key range is frozen)",
                  ("threshold",))
    emit(g, {"threshold": "0"}, gave_up > 0, gave_up, 0.0)

    # 7. shadow-scoring PSI per (tenant, candidate) — the one alert
    # family ATTRIBUTABLE to a model version: a shadow-mirrored
    # candidate whose score distribution diverges from its primary past
    # the threshold fires ITS OWN series, and a candidate-scoped ramp
    # (`launch rollout`'s default) rolls back on exactly this evidence
    # — never on an alert the primary or another tenant caused.
    g = reg.gauge("distlr_alert_shadow_psi",
                  "1 while a shadow-scored candidate's score "
                  "distribution diverges from its primary's (PSI above "
                  "the threshold label) — candidate-attributed, the "
                  "scoped rollout gate's input",
                  ("tenant", "candidate", "threshold"))
    psi_fam = reg.get("distlr_tenant_shadow_psi")
    if psi_fam is not None and psi_fam.kind == "gauge":
        names = psi_fam.labelnames
        if "tenant" in names and "candidate" in names:
            it, ic = names.index("tenant"), names.index("candidate")
            for values, child in sorted(psi_fam.children()):
                emit(g, {"tenant": values[it], "candidate": values[ic],
                         "threshold": f"{t.shadow_psi:g}"},
                     child.value > t.shadow_psi, child.value, t.shadow_psi)
    return alerts


def _fam_sum(reg: MetricsRegistry, name: str,
             where: dict | None = None) -> float:
    """Sum of a live merged family's child values, optionally filtered
    by a label subset — the in-registry twin of :func:`_snap_sum`."""
    fam = reg.get(name)
    if fam is None:
        return 0.0
    total = 0.0
    for values, child in fam.children():
        labels = dict(zip(fam.labelnames, values))
        if where and any(labels.get(k) != v for k, v in where.items()):
            continue
        total += child.value
    return total


# ---------------------------------------------------------------------------
# the scraper
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _RankState:
    role: str
    rank: int
    url: str | None = None          # HTTP source
    path: str | None = None         # file-snapshot source
    ok_scrapes: int = 0
    failed_scrapes: int = 0
    last_ok: float | None = None    # monotonic
    last_error: str = ""
    up: bool = False
    snapshot: dict | None = None


#: fleet scrapes kept per history segment before rotation (two segments
#: survive: ~2x this many scrapes of incident context on disk)
HISTORY_MAX_LINES = 2000


class FleetScraper:
    """Polls every discovered rank endpoint and maintains the merged
    fleet registry + the structured ``/fleet.json`` summary.

    Every scrape also appends its ``/fleet.json`` document to a bounded
    ``<first run_dir>/history.jsonl`` (one rotation kept), so ``launch
    top --replay`` can scrub a past incident offline — the metrics-
    timeline complement of the flight recorder's span rings.

    Duck-types the exporter's registry protocol (``prometheus_text()``
    / ``snapshot()``), so a :class:`distlr_tpu_torch.obs.MetricsServer` can
    serve the LATEST merged view directly: ``MetricsServer(registry=
    scraper, extra_json={"/fleet.json": scraper.fleet_json})``.
    """

    def __init__(self, run_dir, *, interval_s: float = 2.0,
                 stale_after_s: float = 10.0, timeout_s: float = 2.0,
                 thresholds: AlertThresholds | None = None,
                 history: bool = True,
                 history_max_lines: int | None = None,
                 slo_spec=None, slo_rules=None,
                 tsdb_raw_points: int = 512,
                 tsdb_rollup_retention_s: float = 3600.0,
                 incidents: bool = True,
                 incident_window_s: float | None = None,
                 incident_settle_s: float | None = None,
                 incident_max: int = 32):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive, got {interval_s}")
        if history_max_lines is None:
            # resolved at call time, not def time: tests (and embedders)
            # override the module-level default
            history_max_lines = HISTORY_MAX_LINES
        if history_max_lines < 1:
            raise ValueError("history_max_lines must be >= 1, got "
                             f"{history_max_lines}")
        # Aggregation of aggregators: several run dirs (a list, or one
        # os.pathsep-joined string — the repeatable `--obs-run-dir` CLI
        # form) federate into ONE scrape, so the trainer fleet and the
        # serving fleet read as one system.  Ranks are keyed (role, rank)
        # across ALL dirs; a collision keeps the first dir's endpoint and
        # warns — give fleets distinct roles/ranks.
        if isinstance(run_dir, str):
            self.run_dirs = [d for d in run_dir.split(os.pathsep) if d]
        else:
            self.run_dirs = list(run_dir)
        if not self.run_dirs:
            raise ValueError("FleetScraper needs at least one run dir")
        self.run_dir = os.pathsep.join(self.run_dirs)
        self.interval_s = float(interval_s)
        self.stale_after_s = float(stale_after_s)
        self.timeout_s = float(timeout_s)
        self.thresholds = thresholds or AlertThresholds(
            scrape_stale_s=stale_after_s)
        self._states: dict[tuple[str, int], _RankState] = {}
        self._conflicts: dict[str, int] = {}
        self._collision_warned: set[tuple[str, int]] = set()
        #: alert instances firing at the last scrape — the flight
        #: recorder triggers on the not-firing -> firing EDGE only, so a
        #: persistently-red fleet dumps once per incident, not per cycle
        self._alerts_firing: set[str] = set()
        self._lock = threading.Lock()
        self._merged = MetricsRegistry()
        self._fleet: dict = {"updated": None, "run_dir": run_dir,
                             "ranks": [], "alerts": [], "totals": {}}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        self.scrapes = 0
        self.history_path = (os.path.join(self.run_dirs[0], "history.jsonl")
                             if history else None)
        self.history_max_lines = int(history_max_lines)
        self._history_lines = self._count_history_lines()
        # the embedded time-series store: every scrape's
        # fleet doc + merged snapshot lands here; recording rules and
        # the SLO engine evaluate over it each tick.  history.jsonl
        # stays the on-disk raw tier (same file, `top --replay` input).
        self.tsdb = tsdb_mod.FleetTSDB(
            raw_points=tsdb_raw_points,
            rollup_retention_s=tsdb_rollup_retention_s)
        self.rules = tsdb_mod.default_rules() + list(slo_rules or [])
        self.slo_engine = (slo_mod.SLOEngine(slo_spec)
                           if slo_spec else None)
        # the incident engine: every alert edge that fires the flight
        # recorder also queues a bundle, assembled one settle window
        # later (so the flight dumps and profiler bursts have landed) on this same scrape thread
        self.incidents_enabled = bool(incidents)
        self.incident_window_s = float(
            incident_window_s if incident_window_s is not None
            else incident_mod.WINDOW_S)
        self.incident_settle_s = float(
            incident_settle_s if incident_settle_s is not None
            else incident_mod.SETTLE_S)
        self.incident_max = int(incident_max)
        self._pending_incidents: list[dict] = []
        self._last_incident_seq = incident_mod.latest_seq(self.run_dirs[0])

    # -- exporter protocol (what MetricsServer calls) ---------------------
    @property
    def merged(self) -> MetricsRegistry:
        with self._lock:
            return self._merged

    def prometheus_text(self) -> str:
        return self.merged.prometheus_text()

    def snapshot(self) -> dict:
        return self.merged.snapshot()

    def fleet_json(self) -> dict:
        with self._lock:
            return self._fleet

    # -- one scrape cycle -------------------------------------------------
    def _fetch(self, st: _RankState) -> None:
        try:
            if st.url is not None:
                with urllib.request.urlopen(st.url + "/metrics.json",
                                            timeout=self.timeout_s) as r:
                    st.snapshot = json.load(r)
            else:
                with open(st.path) as f:
                    st.snapshot = json.load(f)
            st.up = True
            st.ok_scrapes += 1
            st.last_ok = time.monotonic()
            st.last_error = ""
        except Exception as e:  # noqa: BLE001 — any failure = rank not up
            st.up = False
            st.failed_scrapes += 1
            st.last_error = f"{type(e).__name__}: {e}"

    def scrape_once(self) -> MetricsRegistry:
        """Discover + scrape every rank, rebuild the merged registry and
        the /fleet.json summary, and atomically swap them in."""
        targets: dict[tuple[str, int], tuple[str | None, str | None]] = {}
        for d in self.run_dirs:
            for ep in discover_endpoints(d):
                if ep["role"] == "obs-agg":
                    continue  # never scrape ourselves back into the merge
                key = (ep["role"], ep["rank"])
                url = f"http://{ep['host']}:{ep['port']}"
                if key in targets and targets[key][0] not in (None, url):
                    if key not in self._collision_warned:
                        self._collision_warned.add(key)
                        log.warning(
                            "fleet rank %s-%s published from more than one "
                            "run dir; keeping the first dir's endpoint — "
                            "give each fleet distinct roles/ranks",
                            *key)
                    continue
                targets[key] = (url, None)
            for sf in discover_snapshot_files(d):
                targets.setdefault((sf["role"], sf["rank"]),
                                   (None, sf["path"]))

        for key, (url, path) in targets.items():
            st = self._states.get(key)
            if st is None:
                st = self._states[key] = _RankState(key[0], key[1])
            st.url, st.path = url, path
        if targets:
            # Concurrent fetch: one wedged (accepting-but-silent) rank
            # costs timeout_s; fetched serially, N wedged ranks would
            # stretch the cycle to N*timeout_s — blowing past interval_s
            # and aging HEALTHY ranks' scrapes into false stale alerts.
            # One pool for the scraper's lifetime (stop() retires it) —
            # not per cycle, which would churn 16 OS threads every 2 s.
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="distlr-fleet-fetch")
            list(self._pool.map(self._fetch,
                                [self._states[k] for k in targets]))
        for key in list(self._states):
            if key not in targets:
                # endpoint file gone (run dir cleaned): forget the rank
                del self._states[key]

        now_mono = time.monotonic()
        rank_ages = {
            k: (max(0.0, now_mono - st.last_ok) if st.last_ok is not None
                else float("inf"))
            for k, st in self._states.items()
        }
        # Merge up AND stale ranks (stale = missed the latest scrape but
        # answered within stale_after): a single timed-out scrape must
        # not subtract a rank's whole counter contribution from the
        # fleet totals for one cycle — Prometheus rate()/increase() over
        # the merged scrape would read the dip + recovery as a counter
        # reset and report a spurious spike.  Only DOWN ranks drop out.
        merge_snaps = {
            k: st.snapshot for k, st in self._states.items()
            if st.snapshot is not None
            and self._rank_state_name(st, rank_ages[k]) != "down"
        }
        reg, conflicts = merge_snapshots(merge_snaps, on_conflict="drop")
        for c in conflicts:
            self._conflicts[c] = self._conflicts.get(c, 0) + 1
        self._write_meta_series(reg, rank_ages)
        alerts = evaluate_alerts(reg, thresholds=self.thresholds,
                                 rank_ages=rank_ages)
        fleet = self._build_fleet_json(rank_ages, alerts)
        # Feed the embedded tsdb, evaluate recording rules, then the
        # SLO engine.  Burn alerts append onto the SAME alerts list the
        # fleet doc carries, so the flight-recorder edge trigger below
        # and every fleet.json consumer (rollout gate, autopilot, top)
        # inherit them with zero plumbing changes.
        self.tsdb.ingest(fleet, reg.snapshot())
        now_t = self.tsdb.latest_time()
        if now_t is not None:
            for rule in self.rules:
                rule.evaluate(self.tsdb, now_t)
            if self.slo_engine is not None:
                fleet["slo"] = self.slo_engine.evaluate(
                    self.tsdb, reg, now_t, alerts)
        self._write_tsdb_series(reg)
        self._maybe_trigger_flightrec(alerts)
        self._maybe_assemble_incidents(fleet)
        self._append_history(fleet)
        with self._lock:
            self._merged = reg
            self._fleet = fleet
        self.scrapes += 1
        return reg

    # -- scrape history (the `launch top --replay` input) -----------------
    def _count_history_lines(self) -> int:
        if self.history_path is None:
            return 0
        try:
            with open(self.history_path) as f:
                return sum(1 for _ in f)
        except OSError:
            return 0

    def _append_history(self, fleet: dict) -> None:
        if self.history_path is None:
            return
        try:
            if self._history_lines >= self.history_max_lines:
                # bounded: one rotation kept, like the feedback spool's
                # journal segments — an always-on aggregator must never
                # grow a run dir without limit.  The overwritten .1
                # segment's lines are counted into the tsdb's drop
                # counter (`distlr_tsdb_points_dropped_total{tier=
                # history}`) — eviction is loud, never silent.
                try:
                    with open(self.history_path + ".1") as f:
                        lost = sum(1 for _ in f)
                except OSError:
                    lost = 0
                os.replace(self.history_path, self.history_path + ".1")
                self._history_lines = 0
                self.tsdb.count_dropped("history", lost)
            os.makedirs(os.path.dirname(self.history_path), exist_ok=True)
            with open(self.history_path, "a") as f:
                f.write(json.dumps(fleet) + "\n")
            self._history_lines += 1
        except OSError:
            pass  # history is an extra; a full disk must not stop scraping

    def _maybe_trigger_flightrec(self, alerts: list[dict]) -> None:
        """Drop the flight-recorder trigger into every run dir when any
        ``distlr_alert_*`` instance TRANSITIONS to firing: each process
        configured on the dir dumps its ring of the seconds *before*
        the alert (:mod:`distlr_tpu_torch.obs.dtrace`) — exactly the context
        a sampled-only journal would have discarded."""
        from distlr_tpu_torch.obs import dtrace  # noqa: PLC0415  (stdlib-only)

        now_firing = {
            a["name"] + json.dumps(a.get("labels", {}), sort_keys=True)
            for a in alerts if a.get("firing")
        }
        new = now_firing - self._alerts_firing
        self._alerts_firing = now_firing
        if not new:
            return
        reason = ",".join(sorted({k.split("{", 1)[0] for k in new}))
        log.warning("alert(s) newly firing (%s); triggering flight-"
                    "recorder dumps", reason)
        per_dir_seqs: list[int | None] = []
        for d in self.run_dirs:
            try:
                dtrace.trigger(d, alert=reason)
            except OSError as e:
                log.warning("flight-recorder trigger in %s failed: %s",
                            d, e)
            seq = None
            try:
                with open(os.path.join(d, "flightrec",
                                       dtrace.TRIGGER_NAME)) as f:
                    seq = int(json.load(f).get("seq", 0))
            except (OSError, ValueError):
                pass
            per_dir_seqs.append(seq)
        if not self.incidents_enabled:
            return
        # queue the incident bundle for this edge; assembled one settle
        # window later (see _maybe_assemble_incidents) so the flight
        # dumps and profiler bursts stamped with these seqs have landed
        # on disk.  The EDGE gate above is the exactly-one contract: a
        # persistently-firing alert queues once, not once per cycle.
        seq = next((s for s in per_dir_seqs if s is not None), 0)
        self._pending_incidents.append({
            "seq": seq,
            "per_dir_seqs": per_dir_seqs,
            "reason": reason,
            "detected_ts": time.time(),
            "alerts": [dict(a) for a in alerts if a.get("firing")],
            "due": time.monotonic() + self.incident_settle_s,
        })

    def _maybe_assemble_incidents(self, fleet: dict) -> None:
        """Assemble queued incident bundles whose settle window has
        elapsed, enforce retention, and stamp the open-incident seq
        into the fleet doc (the `launch top` ``inc`` column)."""
        if not self.incidents_enabled:
            return
        now = time.monotonic()
        due = [p for p in self._pending_incidents if p["due"] <= now]
        if due:
            self._pending_incidents = [
                p for p in self._pending_incidents if p["due"] > now]
        for p in due:
            try:
                out = incident_mod.assemble(
                    self.run_dirs, seq=p["seq"], reason=p["reason"],
                    detected_ts=p["detected_ts"], alerts=p["alerts"],
                    slo=fleet.get("slo"), per_dir_seqs=p["per_dir_seqs"],
                    window_s=self.incident_window_s,
                    settle_s=self.incident_settle_s, tsdb=self.tsdb)
                if out is not None:
                    self._last_incident_seq = p["seq"]
            except Exception:  # a bad bundle must not stop scraping
                log.exception("incident %s bundle assembly failed",
                              p["seq"])
            incident_mod.prune(self.run_dirs[0], self.incident_max)
        open_seq = None
        if self._pending_incidents:
            open_seq = self._pending_incidents[-1]["seq"]
        elif self._alerts_firing:
            open_seq = self._last_incident_seq
        info = {"open": open_seq, "last": self._last_incident_seq,
                "pending": len(self._pending_incidents)}
        fleet["incident"] = info
        if open_seq is not None:
            for row in fleet.get("ranks", []):
                row["incident_open"] = open_seq

    def _write_tsdb_series(self, reg: MetricsRegistry) -> None:
        """Export the store's own health (a fresh merged registry is
        rebuilt every scrape, so cumulative ``.inc(total)`` yields the
        correct counter values — same pattern as the scrape totals)."""
        st = self.tsdb.stats()
        reg.gauge("distlr_tsdb_series",
                  "live (series, labels) pairs in the embedded fleet "
                  "time-series store").set(st["series"])
        reg.counter("distlr_tsdb_frames_total",
                    "scrape frames ingested into the embedded "
                    "time-series store").inc(st["frames"])
        reg.counter("distlr_tsdb_points_total",
                    "points ingested into the embedded time-series "
                    "store across all series").inc(st["points"])
        drop_c = reg.counter(
            "distlr_tsdb_points_dropped_total",
            "points evicted from a bounded tier (raw ring, rollup "
            "retention, on-disk history rotation) — loud, never "
            "silently truncated", ("tier",))
        for tier, n in sorted(st["dropped"].items()):
            drop_c.labels(tier=tier).inc(n)

    def query_endpoint(self, params: dict) -> dict:
        """The ``/query?expr=...&window=...`` route (`MetricsServer`
        ``extra_query``): evaluate one tsdb expression over a trailing
        window.  ValueError (bad expr / bad window) surfaces as a 400
        JSON error body."""
        expr = params.get("expr")
        if not expr:
            raise ValueError("missing required query param 'expr'")
        window_s = float(params.get("window", 60.0))
        if window_s <= 0:
            raise ValueError(f"window must be positive, got {window_s}")
        return {
            "expr": expr,
            "window_s": window_s,
            "t": self.tsdb.latest_time(),
            "value": self.tsdb.query(expr, window_s=window_s),
        }

    def _rank_state_name(self, st: _RankState, age: float) -> str:
        if st.up:
            return "up"
        return "stale" if age <= self.stale_after_s else "down"

    def _write_meta_series(self, reg: MetricsRegistry, rank_ages) -> None:
        up_g = reg.gauge("distlr_fleet_scrape_up",
                         "1 when this rank answered the latest scrape",
                         ("role", "rank"))
        stale_g = reg.gauge(
            "distlr_fleet_scrape_stale",
            "1 when this rank missed the latest scrape but was up within "
            "stale_after (0 for both healthy and fully-down ranks)",
            ("role", "rank"))
        age_g = reg.gauge("distlr_fleet_scrape_age_seconds",
                          "seconds since this rank's last successful "
                          "scrape (-1 = never scraped)", ("role", "rank"))
        tot_c = reg.counter("distlr_fleet_scrapes_total",
                            "scrape attempts by outcome",
                            ("role", "rank", "status"))
        counts = {"up": 0, "stale": 0, "down": 0}
        for key, st in sorted(self._states.items()):
            role, rank = key
            age = rank_ages[key]
            state = self._rank_state_name(st, age)
            counts[state] += 1
            up_g.labels(role=role, rank=rank).set(1.0 if state == "up" else 0.0)
            stale_g.labels(role=role, rank=rank).set(
                1.0 if state == "stale" else 0.0)
            age_g.labels(role=role, rank=rank).set(
                -1.0 if age == float("inf") else age)
            tot_c.labels(role=role, rank=rank, status="ok").inc(st.ok_scrapes)
            tot_c.labels(role=role, rank=rank,
                         status="error").inc(st.failed_scrapes)
        ranks_g = reg.gauge("distlr_fleet_ranks",
                            "discovered ranks by scrape state", ("state",))
        for state, n in counts.items():
            ranks_g.labels(state=state).set(n)
        if self._conflicts:
            conf_c = reg.counter(
                "distlr_fleet_merge_conflicts_total",
                "per-rank families dropped from the merge (shape/bucket "
                "mismatch — rejected, never silently summed)", ("family",))
            for fam, n in sorted(self._conflicts.items()):
                conf_c.labels(family=fam).inc(n)

    def _build_fleet_json(self, rank_ages, alerts) -> dict:
        ranks = []
        tot_rate = 0.0
        for key, st in sorted(self._states.items()):
            age = rank_ages[key]
            row = {
                "role": st.role, "rank": st.rank,
                "source": st.url or st.path,
                "state": self._rank_state_name(st, age),
                "age_s": None if age == float("inf") else round(age, 3),
                "last_error": st.last_error,
            }
            snap = st.snapshot
            if snap is not None:
                rate = _snap_sum(snap, "distlr_train_samples_per_second")
                if st.up:
                    tot_rate += rate
                row.update({
                    "steps": int(_snap_sum(snap, "distlr_train_steps_total")),
                    "samples_per_s": round(rate, 1),
                    "staleness_s": _snap_max(
                        snap, "distlr_train_staleness_seconds"),
                })
                for label, name, where in (
                    ("step", "distlr_train_step_seconds", None),
                    ("pull", "distlr_ps_client_op_seconds", {"op": "pull"}),
                    ("push", "distlr_ps_client_op_seconds",
                     {"op": "push_pull"}),
                ):
                    p = _snap_hist_percentiles(snap, name, (0.5, 0.99), where)
                    if p is None and label == "push":
                        p = _snap_hist_percentiles(snap, name, (0.5, 0.99),
                                                   {"op": "push"})
                    if p is not None:
                        row[f"{label}_p50_ms"] = round(p[0] * 1e3, 3)
                        row[f"{label}_p99_ms"] = round(p[1] * 1e3, 3)
                p = _snap_hist_percentiles(
                    snap, "distlr_train_staleness_pushes", (0.5, 0.99))
                if p is not None:
                    row["staleness_pushes_p50"] = round(p[0], 1)
                    row["staleness_pushes_p99"] = round(p[1], 1)
                # cumulative request/push counters: `launch top` derives
                # its windowed rates (req/s, push/s over the last N
                # scrapes) from successive values of these
                if snap.get("distlr_serve_requests_total") is not None:
                    row["requests"] = int(
                        _snap_sum(snap, "distlr_serve_requests_total"))
                if snap.get("distlr_ps_client_ops_total") is not None:
                    row["pushes"] = int(
                        _snap_sum(snap, "distlr_ps_client_ops_total",
                                  {"op": "push", "status": "ok"})
                        + _snap_sum(snap, "distlr_ps_client_ops_total",
                                    {"op": "push_pull", "status": "ok"}))
                # runtime introspection (obs.torchrt here): recompile count
                # and live device-buffer footprint per engine/trainer
                # rank — `launch top` renders these next to the rates
                if snap.get("distlr_jax_compiles_total") is not None:
                    row["jax_compiles"] = int(
                        _snap_sum(snap, "distlr_jax_compiles_total"))
                if snap.get("distlr_jax_device_buffer_bytes") is not None:
                    b = _snap_max(snap, "distlr_jax_device_buffer_bytes")
                    if b is not None:
                        row["device_mb"] = round(b / 1e6, 2)
                # feedback-loop ranks: joined-label and drift signals
                if snap.get("distlr_feedback_joined_total") is not None:
                    row["feedback_joined"] = int(
                        _snap_sum(snap, "distlr_feedback_joined_total"))
                if snap.get("distlr_feedback_score_psi") is not None:
                    row["score_psi"] = _snap_max(
                        snap, "distlr_feedback_score_psi")
                if snap.get("distlr_feedback_shard_lag") is not None:
                    # pending unclaimed feedback shards — the autopilot's
                    # worker-band signal (deterministic, unlike the
                    # cumulative latency percentiles)
                    lag = _snap_max(snap, "distlr_feedback_shard_lag")
                    if lag is not None:
                        row["shard_lag"] = lag
                # autopilot ranks (`launch autopilot`): the
                # control loop's own telemetry rolls through fleet.json
                # so `launch top` shows who is steering the fleet
                if snap.get("distlr_autopilot_ticks_total") is not None:
                    row["autopilot_ticks"] = int(
                        _snap_sum(snap, "distlr_autopilot_ticks_total"))
                    row["autopilot_actions"] = int(
                        _snap_sum(snap, "distlr_autopilot_actions_total"))
                    row["autopilot_errors"] = int(
                        _snap_sum(snap, "distlr_autopilot_errors_total"))
                    row["autopilot_rollbacks"] = int(_snap_sum(
                        snap, "distlr_autopilot_rollbacks_total"))
                    row["autopilot_holding"] = int(
                        _snap_sum(snap, "distlr_autopilot_holding"))
                    last = _read_autopilot_last_action(self.run_dirs)
                    if last is not None:
                        row["autopilot_last_action"] = last
                # multi-tenant serving ranks: hosted-model
                # count, per-tenant quota sheds, and the live shadow PSI
                # (the canary ramp's promote/rollback evidence) roll
                # through fleet.json into `launch top`
                if snap.get("distlr_tenant_models") is not None:
                    # the router's purpose-built registration gauge —
                    # counting distinct request labels instead would
                    # under-report versions that took no traffic yet
                    # (exactly the pre-ramp window an operator checks)
                    m = _snap_max(snap, "distlr_tenant_models")
                    if m is not None:
                        row["models"] = int(m)
                if snap.get("distlr_tenant_shed_total") is not None:
                    row["tenant_shed"] = int(
                        _snap_sum(snap, "distlr_tenant_shed_total"))
                if snap.get("distlr_tenant_shadow_psi") is not None:
                    row["shadow_psi"] = _snap_max(
                        snap, "distlr_tenant_shadow_psi")
                if snap.get("distlr_rollout_weight") is not None:
                    row["rollout_weight"] = _snap_max(
                        snap, "distlr_rollout_weight")
                # structured-log signal: cumulative ERROR
                # records (tsdb ingests it per-rank, feeding the
                # fleet:log_error_rate recording rule) and the windowed
                # per-rank ERROR rate read back from the store — one
                # frame behind, like autopilot_last_action
                if snap.get("distlr_log_records_total") is not None:
                    row["log_errors_total"] = int(_snap_sum(
                        snap, "distlr_log_records_total",
                        {"level": "error"}))
                    r = self.tsdb.query(
                        "rate(log_errors_total"
                        f"{{role={st.role},rank={st.rank}}})",
                        window_s=30.0)
                    if r is not None:
                        row["log_errors"] = round(r, 3)
                # routing-tier ranks (`launch route`): surface the
                # admission/health signals next to the trainer rows
                if snap.get("distlr_route_requests_total") is not None:
                    row["route_requests"] = int(
                        _snap_sum(snap, "distlr_route_requests_total"))
                    row["route_shed"] = int(
                        _snap_sum(snap, "distlr_route_shed_total"))
                    row["replicas_up"] = int(
                        _snap_sum(snap, "distlr_route_replica_up"))
                    # end-to-end serve latency as the client sees it
                    # (admission -> reply, retries included): `launch
                    # top` renders these next to the windowed req/s
                    p = _snap_hist_percentiles(
                        snap, "distlr_route_request_seconds", (0.5, 0.99))
                    if p is not None:
                        row["route_p50_ms"] = round(p[0] * 1e3, 3)
                        row["route_p99_ms"] = round(p[1] * 1e3, 3)
            ranks.append(row)
        states = [r["state"] for r in ranks]
        return {
            "updated": time.time(),
            "run_dir": self.run_dir,
            "interval_s": self.interval_s,
            "scrapes": self.scrapes + 1,
            "ranks": ranks,
            "alerts": alerts,
            "totals": {
                "ranks": len(ranks),
                "up": states.count("up"),
                "stale": states.count("stale"),
                "down": states.count("down"),
                "samples_per_s": round(tot_rate, 1),
            },
        }

    # -- lifecycle --------------------------------------------------------
    def run_forever(self) -> None:
        """Foreground scrape loop (``launch obs-agg``); returns when
        :meth:`stop` is called from another thread or on interrupt."""
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                self.scrape_once()
            except Exception:  # a bad cycle must not kill the aggregator
                log.exception("fleet scrape cycle failed; retrying")
            elapsed = time.monotonic() - t0
            self._stop.wait(max(0.05, self.interval_s - elapsed))

    def start(self) -> "FleetScraper":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self.run_forever, daemon=True, name="distlr-fleet-scraper")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s + self.interval_s)
            self._thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
