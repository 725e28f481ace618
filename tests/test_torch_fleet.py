"""The port's fleet observability plane, part one: the thread and clock
facade (``distlr_tpu_torch/sync.py``), the embedded time-series store and
SLO engine (``obs/tsdb.py``, ``obs/slo.py``), federation
(``obs/federate.py``), ``launch top`` (``obs/top.py``) and the series
reference (``obs/metrics_doc.py``), each against the JAX package's
module on the same seeded inputs, on the CPU.

* sync: the passthrough names are the stdlib's, as in JAX; install,
  uninstall and their refusals behave alike.
* tsdb: seeded fleet frames and merged snapshots into both stores give
  equal query values (rates, increases, quantiles, rollups past the raw
  ring, arithmetic), equal stats and equal recording-rule series.
* slo: the same spec file compiles alike and refuses alike; the same
  store gives equal budgets, burn rates, gauges and alert lists.
* federate: seeded per-rank snapshots merge into byte-equal Prometheus
  text; ``evaluate_alerts`` gives equal alerts; a scraper of each package
  over the same run dir gives equal ``fleet.json`` but for its clock
  fields; a run dir written by processes of both packages merges as one
  fleet; ``launch obs-agg --once`` and ``launch fleet-query`` through the
  CLI.
* top: the same fleet documents render the same text, live and replayed.
* metrics_doc: the port's reference has no drift, and its series set,
  kinds and label names are JAX's.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from distlr_tpu import sync as jax_sync
from distlr_tpu.obs import federate as jax_federate
from distlr_tpu.obs import metrics_doc as jax_metrics_doc
from distlr_tpu.obs import slo as jax_slo
from distlr_tpu.obs import top as jax_top
from distlr_tpu.obs import tsdb as jax_tsdb
from distlr_tpu.obs.registry import MetricsRegistry as JaxRegistry
from distlr_tpu_torch import sync
from distlr_tpu_torch.obs import MetricsRegistry, MetricsServer, federate, metrics_doc, slo, top, tsdb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# sync
# ---------------------------------------------------------------------------


def test_sync_passthrough_names_are_the_stdlib_like_jax():
    import queue

    assert sync.SWAPPABLE == jax_sync.SWAPPABLE
    assert not sync.instrumented()
    assert sync.Lock is threading.Lock and sync.Queue is queue.Queue
    assert sync.monotonic is time.monotonic and sync.wall is time.time
    for name in sync.SWAPPABLE + ("Empty", "Full"):
        assert getattr(sync, name) is getattr(jax_sync, name), name


def test_sync_install_uninstall_like_jax():
    owner, fake = object(), (lambda: 123.0)
    for mod in (sync, jax_sync):
        mod.install({"monotonic": fake}, owner=owner)
        try:
            assert mod.instrumented() and mod.monotonic() == 123.0
            with pytest.raises(RuntimeError, match="already instrumented"):
                mod.install({}, owner=object())
            with pytest.raises(RuntimeError, match="non-owner"):
                mod.uninstall(owner=object())
        finally:
            mod.uninstall(owner=owner)
        assert not mod.instrumented() and mod.monotonic is time.monotonic
        mod.uninstall(owner=owner)  # idempotent
        with pytest.raises(ValueError, match="unknown sync names"):
            mod.install({"Nope": fake}, owner=owner)
    # one package's install leaves the other's names alone
    sync.install({"sleep": fake}, owner=owner)
    try:
        assert jax_sync.sleep is time.sleep
    finally:
        sync.uninstall(owner=owner)


# ---------------------------------------------------------------------------
# seeded inputs
# ---------------------------------------------------------------------------

_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0)


def _rank_snapshot(rng, role: str, t: int) -> dict:
    """One rank's ``/metrics.json`` at step ``t``: cumulative counters that
    grow by seeded amounts, seeded histogram observations, gauges."""
    reg = JaxRegistry()
    ops = reg.counter("distlr_ps_client_ops_total", "native KV ops by outcome",
                      labelnames=("op", "status"))
    lat = reg.histogram("distlr_ps_client_op_seconds", "wall seconds per native KV op",
                        labelnames=("op",), buckets=_BUCKETS)
    steps = reg.counter("distlr_train_steps_total", "training steps completed", ("loop",))
    step_s = reg.histogram("distlr_train_step_seconds", "wall seconds per training step",
                           ("loop",), buckets=_BUCKETS)
    rate = reg.gauge("distlr_train_samples_per_second", "throughput", ("loop", "instance"))
    req = reg.counter("distlr_route_requests_total", "lines", labelnames=("listener",))
    shed = reg.counter("distlr_route_shed_total", "shed", labelnames=("listener",))
    rlat = reg.histogram("distlr_route_request_seconds", "route", labelnames=("listener",),
                         buckets=_BUCKETS)
    if role == "ps":
        for _ in range(t):
            ops.labels(op="push_pull", status="ok").inc(int(rng.integers(5, 50)))
            ops.labels(op="push", status="error").inc(int(rng.integers(0, 2)))
            for v in rng.exponential(0.01, 8):
                lat.labels(op="push_pull").observe(float(v))
            steps.labels(loop="ps").inc(int(rng.integers(1, 5)))
            for v in rng.exponential(0.05, 4):
                step_s.labels(loop="ps").observe(float(v))
        rate.labels(loop="ps", instance="0").set(float(rng.uniform(100, 1000)))
    else:
        for _ in range(t):
            req.labels(listener="r:1").inc(int(rng.integers(20, 80)))
            shed.labels(listener="r:1").inc(int(rng.integers(0, 10)))
            for v in rng.exponential(0.02, 8):
                rlat.labels(listener="r:1").observe(float(v))
    return reg.snapshot()


def _snapshots(seed: int, t: int) -> dict:
    rng = np.random.default_rng(seed)
    return {("ps", 0): _rank_snapshot(rng, "ps", t), ("ps", 1): _rank_snapshot(rng, "ps", t),
            ("route", 0): _rank_snapshot(rng, "route", t)}


def _frames(seed: int, n: int) -> list[tuple[dict, dict]]:
    """``n`` (fleet doc, merged snapshot) scrape frames 10 s apart."""
    out = []
    for i in range(1, n + 1):
        snaps = _snapshots(seed, i)
        merged, _ = jax_federate.merge_snapshots(snaps)
        rows = [{"role": r, "rank": k, "state": "up",
                 "pushes": snaps[(r, k)].get("distlr_ps_client_ops_total") and 10.0 * i * (k + 1),
                 "route_requests": 100.0 * i if r == "route" else None,
                 "route_shed": 7.0 * i * i if r == "route" else None}
                for r, k in sorted(snaps)]
        fleet = {"updated": 1000.0 + 10.0 * i, "ranks": rows,
                 "totals": {"samples_per_s": float(i), "ranks": 3, "up": 3}}
        out.append((fleet, merged.snapshot()))
    return out


_QUERIES = [
    "rate(route_requests)", "increase(route_requests)", "last(route_requests)",
    "route_requests", "rate(pushes{role=ps})", "increase(pushes{rank=1})",
    "avg_over_time(fleet:samples_per_s)", "min_over_time(route_shed)",
    "max_over_time(route_shed)", "rate(route_shed) / rate(route_requests)",
    "(increase(route_shed) + 1) * 2 - -3",
    "histogram_quantile(0.99, distlr_route_request_seconds)",
    "histogram_quantile(0.5, distlr_ps_client_op_seconds{op=push_pull})",
    "rate(distlr_ps_client_ops_total{op=push_pull,status=ok})",
    "increase(distlr_train_steps_total)", "rate(ghost)", "1 / 0",
    "fleet:req_rate", "fleet:shed_rate", "fleet:push_rate",
]


def _stores(raw_points=512, retention=3600.0, n=12):
    dbs = (tsdb.FleetTSDB(raw_points=raw_points, rollup_retention_s=retention),
           jax_tsdb.FleetTSDB(raw_points=raw_points, rollup_retention_s=retention))
    rules = (tsdb.default_rules(), jax_tsdb.default_rules())
    for fleet, snap in _frames(7, n):
        for db, rs in zip(dbs, rules):
            assert db.ingest(copy.deepcopy(fleet), copy.deepcopy(snap)) > 0
            for r in rs:
                r.evaluate(db, fleet["updated"])
    return dbs


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


# ---------------------------------------------------------------------------
# tsdb
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw_points,retention", [(512, 3600.0), (3, 3600.0), (3, 30.0)],
                         ids=["raw", "rollups", "evicting"])
def test_tsdb_queries_and_stats_equal_jax(raw_points, retention):
    ours, theirs = _stores(raw_points, retention)
    assert ours.series_names() == theirs.series_names()
    assert ours.stats() == theirs.stats()
    assert ours.latest_time() == theirs.latest_time()
    answered = 0
    for expr in _QUERIES:
        for window in (15.0, 60.0, 1000.0):
            a = ours.query(expr, window_s=window)
            b = theirs.query(expr, window_s=window)
            assert _same(a, b), (expr, window, a, b)
            answered += a is not None
    assert answered > 30
    assert ours.window_snapshot(1010.0, 1100.0) == theirs.window_snapshot(1010.0, 1100.0)


def test_tsdb_refusals_and_helpers_equal_jax(tmp_path):
    for bad in ("rate(", "rate(x", "histogram_quantile(x)", "1 +", "@"):
        with pytest.raises(ValueError) as e1:
            jax_tsdb.check_expr(bad)
        with pytest.raises(ValueError) as e2:
            tsdb.check_expr(bad)
        assert str(e1.value) == str(e2.value)
    for args in [(0.0, 1.0, 10.0, 21.0), (0.0, None, 1.0, 2.0), (5.0, 3.0, 5.0, 9.0),
                 (0.0, 10.0, 2.0, 4.0)]:
        assert tsdb.delta_rate(*args) == jax_tsdb.delta_rate(*args)
    w, jw = tsdb.RateWindow(5.0), jax_tsdb.RateWindow(5.0)
    for t, v in ((0.0, 10.0), (1.0, 30.0), (4.0, 31.0), (9.0, 100.0)):
        w.push(t, {"pushes": v})
        jw.push(t, {"pushes": v})
        assert w.rate("pushes") == jw.rate("pushes")
    path = tmp_path / "history.jsonl"
    path.write_text("".join(json.dumps({"updated" if i % 2 else "t": 10.0 * i, "ranks": []})
                            + "\n" for i in range(9)) + '{"torn')
    assert tsdb.load_history(str(path), limit=4) == jax_tsdb.load_history(str(path), limit=4)
    assert [r.name for r in tsdb.default_rules()] == [r.name for r in jax_tsdb.default_rules()]


# ---------------------------------------------------------------------------
# slo
# ---------------------------------------------------------------------------

_SLO_DOC = {
    "clock_scale": 0.01,
    "burn_windows": [{"name": "fast", "short_s": 1500, "long_s": 3000, "factor": 2},
                     {"name": "slow", "short_s": 3000, "long_s": 9000, "factor": 1}],
    "slos": [
        {"name": "avail", "objective": 0.9, "window_s": 6000,
         "sli": {"kind": "ratio", "bad": "increase(route_shed)",
                 "total": "increase(route_requests)"}, "labels": {"candidate": "v2"}},
        {"name": "p99", "objective": 0.8, "window_s": 6000,
         "sli": {"kind": "threshold",
                 "expr": "histogram_quantile(0.99, distlr_route_request_seconds)",
                 "op": "<=", "bound": 0.05}},
    ],
    "rules": [{"name": "fleet:custom", "expr": "rate(route_requests)", "window_s": 30.0}],
}


def test_slo_engine_equals_jax(tmp_path):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(_SLO_DOC))
    (spec, rules), (jspec, jrules) = slo.load_slo_file(str(path)), jax_slo.load_slo_file(str(path))
    assert [s.__dict__ for s in spec] == [s.__dict__ for s in jspec]
    assert [(r.name, r.expr, r.window_s) for r in rules] == [
        (r.name, r.expr, r.window_s) for r in jrules]
    engines = (slo.SLOEngine(spec), jax_slo.SLOEngine(jspec))
    regs = (MetricsRegistry(), JaxRegistry())
    dbs = (tsdb.FleetTSDB(), jax_tsdb.FleetTSDB())
    fired = 0
    for fleet, snap in _frames(11, 14):
        outs = []
        for db, eng, reg, rs in zip(dbs, engines, regs, (rules, jrules)):
            db.ingest(copy.deepcopy(fleet), copy.deepcopy(snap))
            for r in rs:
                r.evaluate(db, fleet["updated"])
            alerts: list = []
            summaries = eng.evaluate(db, reg, fleet["updated"], alerts)
            outs.append((summaries, alerts))
        assert json.dumps(outs[0], sort_keys=True) == json.dumps(outs[1], sort_keys=True)
        fired += sum(a["firing"] for a in outs[0][1])
    assert fired > 0
    assert regs[0].prometheus_text() == regs[1].prometheus_text()


@pytest.mark.parametrize("doc", [
    {}, {"slos": []}, {"slos": [{"name": "x"}]},
    {"slos": [{"name": "x", "objective": 1.5, "window_s": 60, "sli": {"kind": "ratio"}}]},
    {"slos": [{"name": "x", "objective": 0.9, "window_s": 60,
               "sli": {"kind": "threshold", "expr": "rate(", "op": "<", "bound": 1}}]},
    {"slos": [{"name": "x", "objective": 0.9, "window_s": 60,
               "sli": {"kind": "threshold", "expr": "rate(a)", "op": "~", "bound": 1}}]},
    {"burn_windows": [{"name": "f", "short_s": 10, "long_s": 5, "factor": 1}],
     "slos": [_SLO_DOC["slos"][0]]},
    {"clock_scale": 0, "slos": [_SLO_DOC["slos"][0]]},
], ids=lambda d: "-".join(sorted(d)) or "empty")
def test_slo_spec_refusals_equal_jax(doc):
    with pytest.raises(jax_slo.SLOSpecError) as theirs:
        jax_slo.load_slo_spec(copy.deepcopy(doc))
    with pytest.raises(slo.SLOSpecError) as ours:
        slo.load_slo_spec(copy.deepcopy(doc))
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# federate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_snapshots_and_alerts_equal_jax(seed):
    snaps = _snapshots(seed, 5)
    merged, conflicts = federate.merge_snapshots(copy.deepcopy(snaps))
    jmerged, jconflicts = jax_federate.merge_snapshots(copy.deepcopy(snaps))
    assert conflicts == jconflicts
    assert merged.prometheus_text() == jmerged.prometheus_text()
    assert merged.snapshot() == jmerged.snapshot()
    ages = {("ps", 0): 0.5, ("ps", 1): 30.0, ("route", 0): float("inf")}
    th = dict(barrier_wait_ratio=2.0, push_error_rate=0.001, scrape_stale_s=10.0)
    alerts = federate.evaluate_alerts(merged, thresholds=federate.AlertThresholds(**th),
                                      rank_ages=ages)
    jalerts = jax_federate.evaluate_alerts(jmerged, thresholds=jax_federate.AlertThresholds(**th),
                                           rank_ages=ages)
    assert alerts == jalerts and any(a["firing"] for a in alerts)
    assert merged.prometheus_text() == jmerged.prometheus_text()


def test_merge_refuses_mismatched_ladders_like_jax():
    a, b = JaxRegistry(), JaxRegistry()
    a.histogram("distlr_x_seconds", "x", buckets=(0.1, 1.0)).observe(0.5)
    b.histogram("distlr_x_seconds", "x", buckets=(0.2, 1.0)).observe(0.5)
    snaps = {("w", 0): a.snapshot(), ("w", 1): b.snapshot()}
    with pytest.raises(jax_federate.FleetMergeError) as theirs:
        jax_federate.merge_snapshots(copy.deepcopy(snaps))
    with pytest.raises(federate.FleetMergeError) as ours:
        federate.merge_snapshots(copy.deepcopy(snaps))
    assert str(ours.value) == str(theirs.value)
    assert (federate.merge_snapshots(copy.deepcopy(snaps), on_conflict="drop")[1]
            == jax_federate.merge_snapshots(copy.deepcopy(snaps), on_conflict="drop")[1])


def _write_snapshots(run: str, snaps: dict) -> None:
    d = os.path.join(run, "snapshots")
    os.makedirs(d, exist_ok=True)
    for (role, rank), snap in snaps.items():
        with open(os.path.join(d, f"{role}-{rank}.json"), "w") as f:
            json.dump(snap, f)


def _untimed(fleet: dict) -> dict:
    """A fleet doc without its clock fields (the scrape time, each rank's
    age and the staleness alert's value, an age) and with each rank's
    source relative to its run dir."""
    fleet = copy.deepcopy(fleet)
    run_dir = fleet.pop("run_dir")
    fleet.pop("updated")
    for row in fleet["ranks"]:
        row.pop("age_s", None)
        row["source"] = os.path.relpath(row["source"], run_dir)
    for a in fleet["alerts"]:
        if a["name"] == "distlr_alert_scrape_stale":
            a.pop("value")
    return fleet


def _quiet() -> dict:
    return dict(barrier_wait_ratio=1e9, push_error_rate=1.1, scrape_stale_s=1e9,
                weight_age_ratio=1e9, retry_rate=1.1, shadow_psi=1e9)


def test_fleet_json_of_both_scrapers_equal(tmp_path):
    """Each package's scraper over a copy of one run dir of banked
    snapshots, two scrapes each: ``fleet.json`` equal but for the clock
    fields, the merged text equal but for the scrape-age gauge."""
    runs = {pkg: str(tmp_path / pkg) for pkg in ("ours", "jax")}
    scrapers = {"ours": federate.FleetScraper(runs["ours"], thresholds=federate.AlertThresholds(
                    **_quiet())),
                "jax": jax_federate.FleetScraper(runs["jax"], thresholds=jax_federate.AlertThresholds(
                    **_quiet()))}
    for step in (3, 6):
        for pkg in runs:
            _write_snapshots(runs[pkg], _snapshots(5, step))
            scrapers[pkg].scrape_once()
    ours, theirs = (scrapers[p].fleet_json() for p in ("ours", "jax"))
    assert _untimed(ours) == _untimed(theirs)
    assert {r["role"] for r in ours["ranks"]} == {"ps", "route"}
    assert ours["ranks"][0]["push_p99_ms"] is not None

    def text(s):
        return [line for line in s.prometheus_text().splitlines()
                if "scrape_age_seconds" not in line and "scrape_duration" not in line]

    assert text(scrapers["ours"]) == text(scrapers["jax"])
    for pkg in runs:  # history.jsonl, the `top --replay` input, line for line
        with open(os.path.join(runs[pkg], "history.jsonl")) as f:
            assert len(f.read().splitlines()) == 2
    q = "rate(route_requests)"
    assert scrapers["ours"].query_endpoint({"expr": q, "window": "60"})["expr"] == q


def test_run_dir_of_both_packages_is_one_fleet(tmp_path):
    """A port process and a JAX process publish endpoints into one run dir:
    either package's aggregator discovers both and sums their counters."""
    from distlr_tpu.obs import MetricsServer as JaxServer
    from distlr_tpu.obs import write_endpoint as jax_write_endpoint
    from distlr_tpu_torch.obs import write_endpoint

    run = str(tmp_path)
    reg, jreg = MetricsRegistry(), JaxRegistry()
    reg.counter("distlr_ps_client_ops_total", "ops", ("op", "status")).labels(
        op="push", status="ok").inc(7)
    jreg.counter("distlr_ps_client_ops_total", "ops", ("op", "status")).labels(
        op="push", status="ok").inc(5)
    with MetricsServer(registry=reg) as srv, JaxServer(registry=jreg) as jsrv:
        write_endpoint(run, "ps", 0, srv.host, srv.port)
        jax_write_endpoint(run, "ps", 1, jsrv.host, jsrv.port)
        assert federate.discover_endpoints(run) == jax_federate.discover_endpoints(run)
        for mod in (federate, jax_federate):
            sc = mod.FleetScraper(run, thresholds=mod.AlertThresholds(**_quiet()), history=False)
            merged = sc.scrape_once()
            fleet = sc.fleet_json()
            assert [(r["role"], r["rank"], r["state"]) for r in fleet["ranks"]] == [
                ("ps", 0, "up"), ("ps", 1, "up")]
            fam = merged.get("distlr_ps_client_ops_total")
            assert fam.labels(op="push", status="ok").value == 12


def _launch(*argv, check=True):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", *argv], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    if check:
        assert proc.returncode == 0, proc.stderr
    return proc


def test_obs_agg_once_and_fleet_query_cli(tmp_path):
    run = str(tmp_path / "run")
    _write_snapshots(run, _snapshots(3, 4))
    once = _launch("obs-agg", "--obs-run-dir", run, "--once", "--device", "cpu")
    assert "FLEET ranks=3 up=3 stale=0 down=0" in once.stderr
    assert "distlr_fleet_scrape_up" in once.stdout
    snap = str(tmp_path / "fleet.json")
    _launch("obs-agg", "--obs-run-dir", run, "--once", "--snapshot-path", snap,
            "--device", "cpu")
    with open(snap) as f:
        assert "distlr_ps_client_ops_total" in json.load(f)
    # a live aggregator in-process, queried through the CLI
    sc = federate.FleetScraper(run, thresholds=federate.AlertThresholds(**_quiet()),
                               history=False)
    sc.scrape_once()
    time.sleep(0.05)
    _write_snapshots(run, _snapshots(3, 8))
    sc.scrape_once()
    with MetricsServer(registry=sc, extra_json={"/fleet.json": sc.fleet_json},
                       extra_query={"/query": sc.query_endpoint}) as srv:
        federate.write_endpoint(run, "obs-agg", 0, srv.host, srv.port)
        ok = _launch("fleet-query", "rate(route_requests)", "--obs-run-dir", run)
        assert json.loads(ok.stdout)["value"] > 0
        nodata = _launch("fleet-query", "rate(ghost)", "--obs-run-dir", run, check=False)
        assert nodata.returncode == 1 and json.loads(nodata.stdout)["value"] is None
        bad = _launch("fleet-query", "rate(", "--fleet", f"http://{srv.host}:{srv.port}",
                      check=False)
        assert bad.returncode == 2 and "error" in bad.stderr
        frame = _launch("top", "--obs-run-dir", run, "--iterations", "1", "--no-color").stdout
        assert "route" in frame and "ps" in frame
    none = _launch("fleet-query", "x", "--obs-run-dir", str(tmp_path / "empty"), check=False)
    assert none.returncode == 2 and "no obs-agg endpoint" in none.stderr


# ---------------------------------------------------------------------------
# top
# ---------------------------------------------------------------------------


def _fleet_doc(i: int) -> dict:
    return {
        "updated": 1000.0 + i, "run_dir": "/r", "interval_s": 1.0, "scrapes": i,
        "totals": {"ranks": 3, "up": 2, "stale": 1, "down": 0, "samples_per_s": 12.5 * i},
        "alerts": [{"name": "distlr_alert_ps_push_errors", "labels": {"threshold": "0.01"},
                    "firing": i % 2 == 0, "value": 0.02 * i, "threshold": 0.01}],
        "ranks": [
            {"role": "ps", "rank": 0, "state": "up", "age_s": 0.1, "samples_per_s": 5.0 * i,
             "pull_p50_ms": 1.5, "pull_p99_ms": 9.0, "push_p50_ms": 2.0, "push_p99_ms": 12.0,
             "staleness_s": 0.25, "staleness_pushes_p50": 1.0, "staleness_pushes_p99": 4.0,
             "pushes": 100 * i, "jax_compiles": 3, "device_mb": 512.5},
            {"role": "route", "rank": 0, "state": "up", "age_s": 0.2, "route_requests": 300 * i,
             "route_shed": 2 * i, "route_p50_ms": 1.25, "route_p99_ms": 9.5},
            {"role": "autopilot", "rank": 0, "state": "stale", "age_s": 12.0,
             "autopilot_last_action": {"rule": "ps_up", "actuator": "ps", "to": 3}},
        ],
        "slo": [{"name": "avail", "objective": 0.9, "window_s": 100.0,
                 "budget_remaining": 0.42 - 0.1 * i,
                 "burn": {"fast": {"short": 5.0, "long": 5.0, "factor": 4.0, "firing": True},
                          "slow": {"short": None, "long": None, "factor": 4.0,
                                   "firing": False}}}],
    }


@pytest.mark.parametrize("color", [False, True])
def test_top_frames_equal_jax(color, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 5000.0)  # the header's "age" reads the clock
    tr, jtr = top.RateTracker(window=3), jax_top.RateTracker(window=3)
    for i in range(1, 6):
        doc = _fleet_doc(i)
        ours = top.render_fleet(copy.deepcopy(doc), color=color, rates=tr.update(doc))
        theirs = jax_top.render_fleet(copy.deepcopy(doc), color=color, rates=jtr.update(doc))
        assert ours == theirs
    assert "e2e p50/p99" in ours and "1.25/9.50" in ours and "SLO avail" in ours


def test_top_replay_equals_jax(tmp_path, monkeypatch):
    import io

    monkeypatch.setattr(time, "time", lambda: 5000.0)

    path = tmp_path / "history.jsonl"
    path.write_text("".join(json.dumps(_fleet_doc(i)) + "\n" for i in range(1, 5)) + '{"torn')
    outs = []
    for mod in (top, jax_top):
        buf = io.StringIO()
        assert mod.run_top_replay(str(path), color=False, out=buf, rate_window=3) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "replayed 4 frames" in outs[0]
    buf = io.StringIO()
    assert top.run_top("http://127.0.0.1:1", iterations=1, color=False, out=buf,
                       timeout_s=0.3) == 0
    assert "fleet aggregator unreachable" in buf.getvalue()


# ---------------------------------------------------------------------------
# metrics_doc
# ---------------------------------------------------------------------------

def test_metrics_doc_has_no_drift():
    assert metrics_doc.check() == []
    with open(metrics_doc.doc_path()) as f:
        assert f.read() == metrics_doc.generate()
    assert metrics_doc.doc_path() == os.path.join(REPO, "distlr_tpu_torch", "obs", "METRICS.md")


def test_metrics_doc_series_equal_jax_scan():
    """The port registers every series the JAX package does, with its kind
    and label names, and no other."""
    ours = {r.name: r for r in metrics_doc.collect_registrations()}
    theirs = {r.name: r for r in jax_metrics_doc.collect_registrations()}
    assert set(ours) == set(theirs)
    for name, r in ours.items():
        assert (r.kind, r.labels) == (theirs[name].kind, theirs[name].labels), name


def test_metrics_doc_cli_check():
    proc = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.obs.metrics_doc", "--check"],
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
