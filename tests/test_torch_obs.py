"""The port's observability layer (``distlr_tpu_torch/obs``) against the
JAX package's (``distlr_tpu/obs``), on the CPU.

* The cases of ``tests/test_obs.py`` in the port's scope (the registry,
  the tracer, the exporters, the metrics logger and step timer, a PS run
  end to end and the launch flags), each on the port and, where the two
  can be compared, held to the JAX package: the same operations give
  byte-equal ``prometheus_text()`` and equal ``snapshot()``.
* Family parity: every family a JAX module declares has, once the port's
  twin is imported, the same name, type, label names, HELP and buckets in
  the port's registry (distributed tracing's ``distlr_trace_*`` among
  them, and the fleet tools' federation, SLO, log, profiler, incident
  and autopilot families).
* The runtime probes: the scoring engine's compiles by bucket equal
  JAX's for the same call sequence; the device-bytes gauge moves.
* The per-client counters ``chip_smoke.py`` reads as attributes still
  exist, and each moves with its registry series.

Counters are process-wide, so every check on the global registry reads
the delta of a series around its own run.
"""

import ast
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.data.synthetic import write_synthetic_shards
from distlr_tpu.obs import registry as jax_registry
from distlr_tpu.obs import tracing as jax_tracing
from distlr_tpu.train import metrics as jax_metrics
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.obs import (
    COUNT_BUCKETS,
    DEFAULT_BUCKETS,
    MetricsRegistry,
    MetricsServer,
    PhaseTracer,
    family_total,
    get_registry,
    get_tracer,
    snapshot_env_paths,
    start_metrics_server,
    torchrt,
    write_metrics_snapshot,
)
from distlr_tpu_torch.obs.tracing import COPY_STREAM_TID, PORT_ONLY_PHASES
from distlr_tpu_torch.train.metrics import MetricsLogger, StepTimer

REPO = Path(__file__).resolve().parents[1]
#: the port-only phases of the copy stream, which a CPU run records none of
COPY_STREAM_PHASES = {"pin", "h2d_copy", "copy_wait"}


def _both(fn):
    """Run ``fn(registry)`` on a fresh registry of each package; return
    (port's, JAX's)."""
    ours, theirs = MetricsRegistry(), jax_registry.MetricsRegistry()
    fn(ours)
    fn(theirs)
    return ours, theirs


def _assert_same_exposition(ours, theirs):
    assert ours.prometheus_text() == theirs.prometheus_text()
    assert ours.snapshot() == theirs.snapshot()


def _series(name: str, **labels) -> float:
    """One child of a family of the port's process registry (0 when the
    family or the child does not exist yet)."""
    fam = get_registry().get(name)
    if fam is None:
        return 0.0
    if not labels:
        return fam.value
    values = tuple(str(labels[n]) for n in fam.labelnames)
    for key, child in fam.children():
        if key == values:
            return child.value
    return 0.0


# ---------------------------------------------------------------------------
# tests/test_obs.py's cases, on the port
# ---------------------------------------------------------------------------

class TestRegistryConcurrency:
    def test_counter_exact_under_hammering(self):
        reg = MetricsRegistry()
        c = reg.counter("hammer_total", "x", labelnames=("t",))
        n_threads, n_incs = 8, 10_000
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)  # more preemption inside the adds
        try:
            threads = [threading.Thread(target=lambda i=i: [c.labels(t=i % 2).inc()
                                                            for _ in range(n_incs)])
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert sum(child.value for _, child in c.children()) == n_threads * n_incs
        assert c.labels(t=0).value == n_threads * n_incs / 2

    def test_histogram_exact_count_under_hammering(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat_seconds", "x", buckets=(0.5,))
        n_threads, n_obs = 8, 5_000

        def hammer():
            for k in range(n_obs):
                h.observe(0.1 if k % 2 else 0.9)

        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert h.count == n_threads * n_obs
        snap = h._default().snapshot()
        assert snap["buckets"][0.5] == n_threads * n_obs / 2
        assert snap["inf"] == n_threads * n_obs

    def test_counter_rejects_negative(self):
        for reg in (MetricsRegistry(), jax_registry.MetricsRegistry()):
            with pytest.raises(ValueError, match="counters only go up"):
                reg.counter("c_total").inc(-1)

    def test_duplicate_declaration_idempotent_and_checked(self):
        errors = []
        for reg in (MetricsRegistry(), jax_registry.MetricsRegistry()):
            a = reg.counter("dup_total", "x", labelnames=("op",))
            assert reg.counter("dup_total", "x", labelnames=("op",)) is a
            h = reg.histogram("dup_seconds", "x", buckets=(0.1, 1.0))
            assert reg.histogram("dup_seconds", "x", buckets=(0.1, 1.0)) is h
            msgs = []
            for redeclare in (lambda: reg.counter("dup_total", "x", labelnames=("other",)),
                              lambda: reg.gauge("dup_total"),
                              lambda: reg.histogram("dup_seconds", "x", buckets=(0.5,))):
                with pytest.raises(ValueError) as e:
                    redeclare()
                msgs.append(str(e.value))
            errors.append(msgs)
        assert errors[0] == errors[1]

    def test_label_resolution(self):
        def ops(reg):
            c = reg.counter("lab_total", "x", labelnames=("op", "status"))
            c.labels(op="push", status="ok").inc(2)
            assert c.labels("push", "ok").value == 2
            with pytest.raises(ValueError):
                c.labels(op="push")
            with pytest.raises(ValueError):
                c.inc()

        _assert_same_exposition(*_both(ops))


class TestHistogramMath:
    def test_bucket_boundaries_are_le(self):
        def ops(reg):
            h = reg.histogram("h", "x", buckets=(1.0, 2.0, 4.0))
            for v in (0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 100.0):
                h.observe(v)

        ours, theirs = _both(ops)
        snap = ours.get("h")._default().snapshot()
        assert (snap["buckets"][1.0], snap["buckets"][2.0], snap["buckets"][4.0]) == (2, 4, 6)
        assert (snap["inf"], snap["count"]) == (7, 7)
        assert snap["sum"] == pytest.approx(112.0)
        _assert_same_exposition(ours, theirs)

    @pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
    def test_percentile_interpolation(self, q):
        def ops(reg):
            h = reg.histogram("h", "x", buckets=(1.0, 2.0, 4.0))
            for v in np.random.default_rng(3).lognormal(0.3, 0.8, 200):
                h.observe(float(v))

        ours, theirs = _both(ops)
        assert ours.get("h").percentile(q) == theirs.get("h").percentile(q)
        assert MetricsRegistry().histogram("e", "x", buckets=(1.0,)).percentile(0.5) == 0.0
        top = MetricsRegistry().histogram("t", "x", buckets=(1.0, 2.0))
        top.observe(50.0)
        assert top.percentile(0.99) == 2.0
        with pytest.raises(ValueError):
            ours.get("h").percentile(1.5)

    def test_timer_contextmanager(self):
        h = MetricsRegistry().histogram("h_seconds", "x")
        with h.time():
            pass
        assert h.count == 1 and h.sum >= 0.0


class TestPrometheusText:
    def test_golden_exposition(self):
        """The exact text of tests/test_obs.py's golden case, and the same
        bytes as the JAX registry's for the same operations."""
        def ops(reg):
            reg.counter("app_ops_total", "ops by kind", labelnames=("op",)).labels(op="push").inc(3)
            reg.gauge("app_temp", "current temperature").set(1.5)
            h = reg.histogram("app_lat_seconds", "latency", buckets=(0.01, 0.1))
            h.observe(0.005)
            h.observe(0.5)

        ours, theirs = _both(ops)
        assert ours.prometheus_text() == (
            "# HELP app_lat_seconds latency\n"
            "# TYPE app_lat_seconds histogram\n"
            'app_lat_seconds_bucket{le="0.01"} 1\n'
            'app_lat_seconds_bucket{le="0.1"} 1\n'
            'app_lat_seconds_bucket{le="+Inf"} 2\n'
            "app_lat_seconds_sum 0.505\n"
            "app_lat_seconds_count 2\n"
            "# HELP app_ops_total ops by kind\n"
            "# TYPE app_ops_total counter\n"
            'app_ops_total{op="push"} 3\n'
            "# HELP app_temp current temperature\n"
            "# TYPE app_temp gauge\n"
            "app_temp 1.5\n"
        )
        _assert_same_exposition(ours, theirs)

    def test_label_escaping(self):
        def ops(reg):
            reg.counter("esc_total", "", labelnames=("p",)).labels(p='a"b\\c\nd').inc()

        ours, theirs = _both(ops)
        text = ours.prometheus_text()
        assert '\\"' in text and "\\\\" in text and "\\n" in text
        _assert_same_exposition(ours, theirs)

    def test_json_snapshot_roundtrips(self):
        def ops(reg):
            reg.counter("s_total", "", labelnames=("k",)).labels(k="v").inc(2)
            reg.histogram("s_seconds", "", buckets=(1.0,)).observe(0.5)
            reg.histogram("s_pushes", "", labelnames=("rank",),
                          buckets=COUNT_BUCKETS).labels(rank=0).observe(3)
            reg.gauge("s_big", "").set(1e17)
            reg.gauge("s_neg", "").set(-0.25)

        ours, theirs = _both(ops)
        snap = json.loads(json.dumps(ours.snapshot()))
        assert snap["s_total"]["series"][0] == {"labels": {"k": "v"}, "value": 2}
        hs = snap["s_seconds"]["series"][0]
        assert hs["count"] == 1 and hs["buckets"]["1"] == 1
        assert DEFAULT_BUCKETS == jax_registry.DEFAULT_BUCKETS
        assert COUNT_BUCKETS == jax_registry.COUNT_BUCKETS
        _assert_same_exposition(ours, theirs)


class TestTracer:
    def test_chrome_trace_json_valid(self, tmp_path):
        tracer = PhaseTracer(registry=MetricsRegistry())
        with tracer.phase("compute"):
            pass
        done = threading.Event()

        def other():
            with tracer.phase("h2d"):
                done.set()

        t = threading.Thread(target=other)
        t.start()
        t.join(10)
        assert done.is_set()
        path = str(tmp_path / "trace.json")
        tracer.dump_chrome_trace(path)
        doc = json.load(open(path))
        events = doc["traceEvents"]
        assert {e["name"] for e in events} == {"compute", "h2d"}
        for e in events:
            assert e["ph"] == "X" and e["ts"] >= 0 and e["dur"] >= 0
            assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        assert len({e["tid"] for e in events}) == 2
        # the same document keys as the JAX tracer's
        jt = jax_tracing.PhaseTracer(registry=jax_registry.MetricsRegistry())
        with jt.phase("compute"):
            pass
        theirs = jt.chrome_trace()
        assert set(doc) == set(theirs) and set(events[0]) == set(theirs["traceEvents"][0])

    def test_breakdown_survives_event_cap(self):
        tracer = PhaseTracer(registry=MetricsRegistry(), max_events=2)
        for _ in range(5):
            with tracer.phase("x"):
                pass
        assert tracer.breakdown()["x"]["count"] == 5
        doc = tracer.chrome_trace()
        assert len(doc["traceEvents"]) == 2
        assert doc["otherData"]["dropped_events"] == 3

    def test_bytes_reach_the_breakdown_of_their_phase_only(self):
        tracer = PhaseTracer(registry=MetricsRegistry())
        for n in (100, 28):
            with tracer.phase("pin", nbytes=n):
                pass
        with tracer.phase("compute"):
            pass
        got = tracer.breakdown()
        assert got["pin"]["bytes"] == 128 and got["pin"]["count"] == 2
        assert set(got["compute"]) == {"seconds", "count"}

    def test_attributes_become_args_and_plain_events_keep_jax_keys(self):
        tracer = PhaseTracer(registry=MetricsRegistry())
        tag = {"epoch": 1, "batch": 2}
        with tracer.phase("h2d", args=tag):
            pass
        with tracer.phase("pin", nbytes=64, args=tag):
            pass
        with tracer.phase("compute"):
            pass
        h2d, pin, compute = tracer.chrome_trace()["traceEvents"]
        assert h2d["args"] == tag and pin["args"] == {**tag, "bytes": 64}
        jt = jax_tracing.PhaseTracer(registry=jax_registry.MetricsRegistry())
        with jt.phase("compute"):
            pass
        assert set(compute) == set(jt.chrome_trace()["traceEvents"][0])
        assert set(h2d) - set(compute) == {"args"}

    def test_record_feeds_breakdown_histogram_and_timeline(self):
        """A span timed elsewhere, on the host's perf_counter clock, lands
        where a phase block of the same extent does."""
        reg = MetricsRegistry()
        tracer = PhaseTracer(registry=reg)
        with tracer.phase("compute") as span:
            time.sleep(0.002)
        tracer.record("copy_wait", span.t0, span.t1, args={"epoch": 0, "batch": 0})
        t = time.perf_counter()
        tracer.record("h2d_copy", t + 0.5, t + 0.75, nbytes=4096, tid=COPY_STREAM_TID)
        got = tracer.breakdown()
        assert got["copy_wait"] == got["compute"]
        assert got["h2d_copy"] == {"seconds": 0.25, "count": 1, "bytes": 4096}
        hist = reg.get("distlr_phase_seconds")
        assert hist.labels(phase="copy_wait").sum == hist.labels(phase="compute").sum
        assert hist.labels(phase="h2d_copy").count == 1
        compute, wait, copy = tracer.chrome_trace()["traceEvents"]
        assert (wait["ts"], wait["dur"], wait["tid"]) == (compute["ts"], compute["dur"],
                                                          compute["tid"])
        assert copy["tid"] == COPY_STREAM_TID and copy["dur"] == 250_000.0
        assert copy["ts"] == pytest.approx(compute["ts"] + (t + 0.5 - span.t0) * 1e6, abs=1e-2)

    def test_reset(self):
        reg = MetricsRegistry()
        tracer = PhaseTracer(registry=reg)
        with tracer.phase("x"):
            pass
        tracer.reset()
        assert tracer.breakdown() == {} and tracer.chrome_trace()["traceEvents"] == []
        # the registry histogram keeps the span (tracer resets are local)
        assert reg.get("distlr_phase_seconds").labels(phase="x").count == 1


class TestExporters:
    def test_http_endpoints(self):
        reg = MetricsRegistry()
        reg.counter("up_total").inc()
        with start_metrics_server(registry=reg, port=0) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            text = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
            assert text == reg.prometheus_text() and "up_total 1" in text
            js = json.loads(urllib.request.urlopen(base + "/metrics.json", timeout=10).read())
            assert js == reg.snapshot()
            assert urllib.request.urlopen(base + "/healthz", timeout=10).read() == b"ok\n"
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(base + "/nope", timeout=10)

    def test_write_snapshot(self, tmp_path):
        ours, theirs = _both(lambda reg: reg.gauge("g").set(2))
        from distlr_tpu.obs import write_metrics_snapshot as jax_write

        write_metrics_snapshot(str(tmp_path / "a.prom"), ours)
        jax_write(str(tmp_path / "b.prom"), theirs)
        assert (tmp_path / "a.prom").read_bytes() == (tmp_path / "b.prom").read_bytes()
        assert "g 2" in (tmp_path / "a.prom").read_text()

    def test_write_snapshot_json_twin(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("c_total").inc(3)
        path = str(tmp_path / "metrics.json")
        write_metrics_snapshot(path, reg)
        doc = json.load(open(path))
        assert doc["c_total"]["series"][0]["value"] == 3 and doc["c_total"]["type"] == "counter"

    def test_snapshot_env_multiple_paths(self):
        from distlr_tpu.obs import snapshot_env_paths as jax_paths

        val = os.pathsep.join(["a.prom", "b.json"])
        assert snapshot_env_paths(val) == jax_paths(val) == ["a.prom", "b.json"]
        assert snapshot_env_paths("") == []

    def test_stop_without_start_does_not_deadlock(self):
        srv = MetricsServer(registry=MetricsRegistry(), port=0)
        t = threading.Thread(target=srv.stop, daemon=True)
        t.start()
        t.join(timeout=5)
        assert not t.is_alive(), "stop() without start() deadlocked"
        srv.stop()
        with pytest.raises(RuntimeError, match="stopped"):
            srv.start()

    def test_stop_idempotent_after_start(self):
        srv = MetricsServer(registry=MetricsRegistry(), port=0).start()
        srv.stop()
        srv.stop()

    def test_env_snapshot_banked_at_exit(self, tmp_path):
        """``DISTLR_METRICS_SNAPSHOT`` arms at ``import distlr_tpu_torch.obs``:
        a one-shot process banks both forms at exit."""
        prom, js = tmp_path / "m.prom", tmp_path / "m.json"
        code = ("from distlr_tpu_torch.obs import get_registry\n"
                "get_registry().counter('oneshot_total', 'x').inc(4)\n")
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   DISTLR_METRICS_SNAPSHOT=os.pathsep.join([str(prom), str(js)]))
        subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
        assert "oneshot_total 4" in prom.read_text()
        assert json.loads(js.read_text())["oneshot_total"]["series"][0]["value"] == 4


class TestMetricsLoggerLifecycle:
    def test_log_after_close_raises(self, tmp_path):
        m = MetricsLogger(str(tmp_path / "m.jsonl"), registry=MetricsRegistry())
        m.log(epoch=1, accuracy=0.5)
        m.close()
        assert m.closed
        with pytest.raises(RuntimeError, match="closed"):
            m.log(epoch=2, accuracy=0.6)
        assert [json.loads(ln)["epoch"] for ln in open(tmp_path / "m.jsonl")] == [1]

    def test_log_after_close_raises_without_sink_too(self):
        m = MetricsLogger(registry=MetricsRegistry())
        m.close()
        with pytest.raises(RuntimeError, match="closed"):
            m.log(x=1)

    def test_context_manager(self, tmp_path):
        path = str(tmp_path / "m.jsonl")
        with MetricsLogger(path, registry=MetricsRegistry()) as m:
            m.log(epoch=1, loss=0.1)
        assert m.closed and json.loads(open(path).read())["loss"] == 0.1

    def test_close_idempotent(self):
        m = MetricsLogger(registry=MetricsRegistry())
        m.close()
        m.close()

    def test_numeric_fields_mirror_to_registry(self):
        """The same records mirror into byte-equal registries."""
        def ops(reg):
            with (MetricsLogger if isinstance(reg, MetricsRegistry)
                  else jax_metrics.MetricsLogger)(registry=reg) as m:
                m.log(epoch=3, accuracy=0.75, note="text-is-skipped", flag=True, time=1.0)

        ours, theirs = _both(ops)
        g = ours.get("distlr_train_last")
        assert g.labels(field="accuracy").value == 0.75 and g.labels(field="epoch").value == 3
        assert {v for v, _ in g.children()} == {("accuracy",), ("epoch",)}
        _assert_same_exposition(ours, theirs)


class TestStepTimerRegistry:
    def test_stop_feeds_registry_series(self):
        reg = MetricsRegistry()
        t = StepTimer(loop="unit", registry=reg)
        for n in (128, 64):
            t.start()
            t.stop(n)
        assert reg.get("distlr_train_steps_total").labels(loop="unit").value == 2
        assert reg.get("distlr_train_samples_total").labels(loop="unit").value == 192
        assert reg.get("distlr_train_step_seconds").labels(loop="unit").count == 2
        assert reg.get("distlr_train_samples_per_second").labels(
            loop="unit", instance="0").value == pytest.approx(t.samples_per_sec)
        # JAX's timer declares the same families with the same children
        jreg = jax_registry.MetricsRegistry()
        jt = jax_metrics.StepTimer(loop="unit", registry=jreg)
        for n in (128, 64):
            jt.start()
            jt.stop(n)
        for name in ("distlr_train_steps_total", "distlr_train_samples_total"):
            assert reg.get(name).labels(loop="unit").value == jreg.get(name).labels(
                loop="unit").value
        assert sorted(reg.snapshot()) == sorted(jreg.snapshot())

    def test_rate_gauge_is_per_instance(self):
        reg = MetricsRegistry()
        a = StepTimer(loop="ps", instance="0", registry=reg)
        b = StepTimer(loop="ps", instance="1", registry=reg)
        a.start()
        a.stop(100)
        b.start()
        b.stop(200)
        g = reg.get("distlr_train_samples_per_second")
        assert g.labels(loop="ps", instance="0").value == pytest.approx(a.samples_per_sec)
        assert g.labels(loop="ps", instance="1").value == pytest.approx(b.samples_per_sec)
        assert reg.get("distlr_train_samples_total").labels(loop="ps").value == 300


# ---------------------------------------------------------------------------
# family parity
# ---------------------------------------------------------------------------

#: JAX module -> the port module that declares its families
_PORTED = {
    "distlr_tpu/ps/client.py": "distlr_tpu_torch.ps.client",
    "distlr_tpu/ps/server.py": "distlr_tpu_torch.ps.server",
    "distlr_tpu/ps/membership.py": "distlr_tpu_torch.ps.membership",
    "distlr_tpu/chaos/proxy.py": "distlr_tpu_torch.chaos.proxy",
    "distlr_tpu/serve/engine.py": "distlr_tpu_torch.serve.engine",
    "distlr_tpu/serve/batcher.py": "distlr_tpu_torch.serve.batcher",
    "distlr_tpu/serve/server.py": "distlr_tpu_torch.serve.server",
    "distlr_tpu/serve/router.py": "distlr_tpu_torch.serve.router",
    "distlr_tpu/serve/reload.py": "distlr_tpu_torch.serve.reload",
    "distlr_tpu/serve/hotset.py": "distlr_tpu_torch.serve.hotset",
    "distlr_tpu/serve/rollout.py": "distlr_tpu_torch.serve.rollout",
    "distlr_tpu/serve/tenant.py": "distlr_tpu_torch.serve.tenant",
    "distlr_tpu/feedback/spool.py": "distlr_tpu_torch.feedback.spool",
    "distlr_tpu/feedback/join.py": "distlr_tpu_torch.feedback.join",
    "distlr_tpu/feedback/drift.py": "distlr_tpu_torch.feedback.drift",
    "distlr_tpu/feedback/online.py": "distlr_tpu_torch.feedback.online",
    "distlr_tpu/train/metrics.py": "distlr_tpu_torch.train.metrics",
    "distlr_tpu/train/ps_trainer.py": "distlr_tpu_torch.train.ps_trainer",
    "distlr_tpu/obs/tracing.py": "distlr_tpu_torch.obs.tracing",
    "distlr_tpu/obs/jaxrt.py": "distlr_tpu_torch.obs.torchrt",
    "distlr_tpu/obs/dtrace.py": "distlr_tpu_torch.obs.dtrace",
    "distlr_tpu/autopilot/daemon.py": "distlr_tpu_torch.autopilot.daemon",
    "distlr_tpu/obs/federate.py": "distlr_tpu_torch.obs.federate",
    "distlr_tpu/obs/incident.py": "distlr_tpu_torch.obs.incident",
    "distlr_tpu/obs/log.py": "distlr_tpu_torch.obs.log",
    "distlr_tpu/obs/profile.py": "distlr_tpu_torch.obs.profile",
    "distlr_tpu/obs/slo.py": "distlr_tpu_torch.obs.slo",
}
#: JAX modules whose families the port does not declare yet, by ROADMAP
#: item: none since the fleet tools were ported
_ABSENT: dict[str, str] = {}
#: the runtime probes keep JAX's names and labels, and say in their HELP
#: what each counts in the port
_OWN_HELP = {"distlr_jax_compiles_total", "distlr_jax_device_buffer_bytes",
             "distlr_jax_live_buffers"}


def _declared(path: str) -> list[str]:
    """The family names a module declares (``<registry>.counter("distlr_...")``
    and its gauge / histogram siblings)."""
    names = []
    for node in ast.walk(ast.parse((REPO / path).read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("counter", "gauge", "histogram") and node.args
                and isinstance(node.args[0], ast.Constant)
                and str(node.args[0].value).startswith("distlr_")):
            names.append(node.args[0].value)
    return names


def _declaring_jax_modules() -> set[str]:
    return {str(p.relative_to(REPO)) for p in (REPO / "distlr_tpu").rglob("*.py")
            if _declared(str(p.relative_to(REPO)))}


def test_every_declaring_jax_module_is_ported_or_named_absent():
    assert _declaring_jax_modules() == set(_PORTED) | set(_ABSENT)
    assert sum(len(_declared(p)) for p in _PORTED) >= 100


def _import_declaring(jax_path: str, port_module: str):
    import importlib

    jax_mod = importlib.import_module(jax_path[:-3].replace("/", "."))
    port_mod = importlib.import_module(port_module)
    if port_module.endswith("train.metrics"):
        # the train families are declared by the classes' constructors
        jax_mod.StepTimer(loop="parity")
        jax_mod.MetricsLogger()
        port_mod.StepTimer(loop="parity")
        port_mod.MetricsLogger()


#: the aggregator's modules declare their families in the merged registry
#: of a scrape, not in the process registry
_SCRAPE_DECLARING = ("distlr_tpu/obs/federate.py", "distlr_tpu/obs/slo.py")


def _scrape_registries(tmp_path) -> tuple:
    """Each package's merged registry after one scrape, with an SLO spec,
    over banked snapshots that give every conditional family its input:
    step and barrier-wait histograms, and two ladders of one histogram
    that conflict."""
    import importlib

    bucket_sets = ((0.1, 1.0), (0.2, 1.0))
    for rank, buckets in enumerate(bucket_sets):
        reg = jax_registry.MetricsRegistry()
        reg.histogram("distlr_train_step_seconds", "s", ("loop",)).labels(loop="ps").observe(0.1)
        reg.histogram("distlr_phase_seconds", "s", ("phase",)).labels(
            phase="barrier_wait").observe(0.2)
        reg.histogram("distlr_x_seconds", "x", buckets=buckets).observe(0.5)
        os.makedirs(tmp_path / "snapshots", exist_ok=True)
        (tmp_path / "snapshots" / f"ps-{rank}.json").write_text(json.dumps(reg.snapshot()))
    doc = {"slos": [{"name": "a", "objective": 0.9, "window_s": 60,
                     "sli": {"kind": "ratio", "bad": "increase(x)", "total": "increase(y)"}}]}
    out = []
    for pkg in ("distlr_tpu", "distlr_tpu_torch"):
        federate = importlib.import_module(f"{pkg}.obs.federate")
        slo = importlib.import_module(f"{pkg}.obs.slo")
        scraper = federate.FleetScraper(str(tmp_path), history=False,
                                        slo_spec=slo.load_slo_spec(doc))
        out.append(scraper.scrape_once())
    return tuple(out)


@pytest.mark.parametrize("jax_path", sorted(_PORTED))
def test_family_parity(jax_path, tmp_path):
    _import_declaring(jax_path, _PORTED[jax_path])
    theirs, ours = jax_registry.get_registry(), get_registry()
    if jax_path in _SCRAPE_DECLARING:
        theirs, ours = _scrape_registries(tmp_path)
    names = _declared(jax_path)
    assert names
    for name in names:
        j, p = theirs.get(name), ours.get(name)
        assert j is not None, name
        assert p is not None, f"{name} ({jax_path}) is not declared by {_PORTED[jax_path]}"
        assert (p.kind, p.labelnames, p._child_kw) == (j.kind, j.labelnames, j._child_kw), name
        if name not in _OWN_HELP:
            assert p.help == j.help, name


# ---------------------------------------------------------------------------
# runtime probes
# ---------------------------------------------------------------------------

class TestRuntimeProbes:
    def test_engine_compiles_counted_per_bucket_like_jax(self):
        """The sequence of tests/test_profile.py's engine case, on both
        engines: the first call at a bucket counts one compile, the next
        call at that bucket none; a new bucket counts one more."""
        from distlr_tpu.serve import ScoringEngine as JaxEngine
        from distlr_tpu_torch.serve import ScoringEngine

        D = 53  # a width no other case scores at: the caches are process-wide

        def count(registry, bucket):
            fam = registry.get("distlr_jax_compiles_total")
            if fam is None:
                return 0.0
            return sum(c.value for v, c in fam.children() if v == ("serve.engine", str(bucket)))

        deltas = {}
        for name, eng, reg in (
                ("ours", ScoringEngine(Config(device="cpu", num_feature_dim=D, l2_c=0.0),
                                       max_batch_size=256), get_registry()),
                ("jax", JaxEngine(JaxConfig(num_feature_dim=D, l2_c=0.0), max_batch_size=256),
                 jax_registry.get_registry())):
            eng.set_weights(np.ones(D, np.float32))
            seen = []
            for rows in (3, 5, 100, 200, 7):
                before = {b: count(reg, b) for b in (64, 256)}
                eng.score((np.ones((rows, D), np.float32),))
                seen.append(tuple(count(reg, b) - before[b] for b in (64, 256)))
            deltas[name] = seen
        assert deltas["ours"] == deltas["jax"] == [(1, 0), (0, 0), (0, 1), (0, 0), (0, 0)]

    def test_device_bytes_gauge_counts_live_tensors(self):
        import torch

        keep = torch.zeros(1 << 20, dtype=torch.float32)  # 4 MiB on the CPU
        total = torchrt.sample_device_bytes()
        assert total >= keep.numel() * 4
        assert _series("distlr_jax_device_buffer_bytes") == total
        assert _series("distlr_jax_live_buffers") >= 1
        # throttled: a second sample inside the interval is skipped
        del keep
        torchrt.maybe_sample_device_bytes(min_interval_s=3600.0)
        assert _series("distlr_jax_device_buffer_bytes") == total

    def test_signature_probe_counts_like_a_jit_cache(self):
        """Two probes on one cache (two PS workers on one shared step)
        each count its growth, as two ``JitCacheProbe`` on one jitted
        function do."""
        cache = torchrt.SignatureCache()
        a, b = torchrt.CompileProbe(cache, "t.a"), torchrt.CompileProbe(cache, "t.b")
        assert cache.note(np.zeros((4, 2), np.float32)) and not cache.note(
            np.ones((4, 2), np.float32))
        assert cache.note(np.zeros((4, 2), np.float64))
        assert (a.tick(), a.tick(), b.tick()) == (2, 0, 2)
        assert _series("distlr_jax_compiles_total", site="t.a", bucket="-") == 2

    def test_sync_trainer_compiles_and_phases_like_jax(self, obs_data_dir):
        """One sync fit on each package: the step and eval sites count
        the same compiles, and the tracer sees the JAX trainer's phases."""
        from distlr_tpu.train import Trainer as JaxTrainer
        from distlr_tpu_torch.train import Trainer

        kw = dict(data_dir=obs_data_dir, num_feature_dim=24, num_iteration=2,
                  test_interval=1, batch_size=100, l2_c=0.0)
        got = {}
        for name, trainer, reg, tracer in (
                ("ours", Trainer(Config(device="cpu", **kw)), get_registry(), get_tracer()),
                ("jax", JaxTrainer(JaxConfig(**kw)), jax_registry.get_registry(),
                 jax_tracing.get_tracer())):
            before = {s: family_total_of(reg, "distlr_jax_compiles_total", site=s)
                      for s in ("train.sync.step", "train.sync.eval")}
            tracer.reset()
            trainer.load_data().fit(eval_fn=lambda *_: None)
            trainer.evaluate()
            got[name] = ({s: family_total_of(reg, "distlr_jax_compiles_total", site=s) - v
                          for s, v in before.items()}, tracer.phase_names())
        assert got["ours"][0] == got["jax"][0] == {"train.sync.step": 1, "train.sync.eval": 1}
        # off CUDA the port adds its port-only phases but the copy stream's
        assert got["ours"][1] == got["jax"][1] | (PORT_ONLY_PHASES - COPY_STREAM_PHASES)
        assert {"data_load", "h2d", "compute", "eval"} <= got["jax"][1]

    def test_profile_dir_exports_a_chrome_trace(self, obs_data_dir, tmp_path):
        from distlr_tpu_torch.train import Trainer

        prof = tmp_path / "prof"
        cfg = Config(device="cpu", data_dir=obs_data_dir, num_feature_dim=24, num_iteration=1,
                     batch_size=100, profile_dir=str(prof))
        Trainer(cfg).load_data().fit(eval_fn=lambda *_: None)
        (trace,) = prof.glob("fit-*.pt.trace.json")
        names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
        assert any(str(n).startswith("aten::") for n in names)


class _StubAnchor:
    """An anchor event: ``elapsed_time`` to a stub event is its fixed ms."""

    def elapsed_time(self, event) -> float:
        return event.ms


class _StubEvent:
    def __init__(self, ms: float):
        self.ms = ms


@pytest.mark.parametrize("t_anchor,ms,want", [
    (100.0, 0.0, 100.0), (100.0, 250.0, 100.25), (5.5, 1.5, 5.5015), (7.0, 60_000.0, 67.0)])
def test_device_clock_puts_an_event_on_the_hosts_clock(t_anchor, ms, want):
    clock = torchrt.DeviceClock(_StubAnchor(), t_anchor)
    assert clock.host_time(_StubEvent(ms)) == pytest.approx(want, abs=1e-12)


class _SlowEvent:
    """A timing event whose record and wait take the next of ``waits``
    seconds (none once they run out)."""

    waits: list = []
    made: list = []

    def __init__(self, enable_timing=False):
        _SlowEvent.made.append(self)

    def record(self, stream=None):
        pass

    def synchronize(self):
        if _SlowEvent.waits:
            time.sleep(_SlowEvent.waits.pop(0))


@pytest.mark.parametrize("waits,tries", [
    ([0.005, 0.005], None),                  # retried until narrow
    ([0.004, 0.002, 0.003] + [0.005] * 7, 10),  # all wide: the narrowest kept
])
def test_device_clock_anchors_on_a_narrow_bracket(monkeypatch, waits, tries):
    """An anchor is the midpoint of the host's reads around its record
    and wait; a bracket wider than the slack is taken again, and where
    none is narrow the narrowest is kept."""
    import torch

    monkeypatch.setattr(_SlowEvent, "waits", list(waits))
    monkeypatch.setattr(_SlowEvent, "made", [])
    monkeypatch.setattr(torch.cuda, "Event", _SlowEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    t0 = time.perf_counter()
    clock = torchrt.DeviceClock.take("cuda")
    t1 = time.perf_counter()
    assert t0 < clock.t_anchor < t1
    if tries is None:
        assert len(_SlowEvent.made) >= 3 and clock.anchor is _SlowEvent.made[-1]
        assert clock.width < 0.004
    else:
        assert len(_SlowEvent.made) == tries == torchrt.DeviceClock.ANCHOR_TRIES
        assert clock.anchor is _SlowEvent.made[1] and 0.002 <= clock.width < 0.003


def _fit_spans(data_dir, **kw):
    """One CPU sync fit of 2 epochs of 4 batches (640 train rows in 2
    shards, 100 a worker): the trainer, the tracer's breakdown and its
    events."""
    from distlr_tpu_torch.train import Trainer

    cfg = Config(device="cpu", data_dir=data_dir, num_feature_dim=24, num_iteration=2,
                 test_interval=1, batch_size=100, l2_c=0.0, num_workers=2, **kw)
    trainer = Trainer(cfg).load_data()
    tracer = get_tracer()
    tracer.reset()
    trainer.fit(eval_fn=lambda *_: None)
    return trainer, tracer.breakdown(), tracer.chrome_trace()["traceEvents"]


class TestSyncTrainerPipelineSpans:
    EPOCHS, BATCHES = 2, 4

    @pytest.mark.parametrize("prefetch", [1, 2, 3])
    def test_one_epoch_fill_an_epoch_with_its_first_waits_extent(self, obs_data_dir, prefetch):
        _, phases, events = _fit_spans(obs_data_dir, prefetch=prefetch)
        fills = [e for e in events if e["name"] == "epoch_fill"]
        assert phases["epoch_fill"]["count"] == len(fills) == self.EPOCHS
        waits = {(e["args"]["epoch"], e["args"]["batch"]): e
                 for e in events if e["name"] == "data_load"}
        for fill in fills:
            assert fill["args"]["batch"] == 0
            wait = waits[(fill["args"]["epoch"], 0)]
            assert (fill["ts"], fill["dur"], fill["tid"]) == (wait["ts"], wait["dur"],
                                                              wait["tid"])
        assert phases["test_h2d"]["count"] == 1
        assert not COPY_STREAM_PHASES & set(phases)

    @pytest.mark.parametrize("prefetch", [1, 2])
    def test_every_batch_span_carries_its_epoch_and_batch(self, obs_data_dir, prefetch):
        _, _, events = _fit_spans(obs_data_dir, prefetch=prefetch)
        batch_spans = [e for e in events if e["name"] not in ("eval", "test_h2d")]
        assert all(set(e["args"]) == {"epoch", "batch"} for e in batch_spans)
        want = {(ep, k) for ep in range(self.EPOCHS) for k in range(self.BATCHES)}
        for name in ("h2d", "compute"):
            keys = [(e["args"]["epoch"], e["args"]["batch"]) for e in events
                    if e["name"] == name]
            assert sorted(keys) == sorted(want)
        # each batch's wait, and one more an epoch for its end
        waits = {(e["args"]["epoch"], e["args"]["batch"]) for e in events
                 if e["name"] == "data_load"}
        assert waits == want | {(ep, self.BATCHES) for ep in range(self.EPOCHS)}
        # a batch's copy is enqueued before its step starts
        starts = {(e["name"], e["args"]["epoch"], e["args"]["batch"]): e["ts"]
                  for e in batch_spans}
        assert all(starts[("h2d", ep, k)] < starts[("compute", ep, k)] for ep, k in want)

    def test_step_timer_counts_the_data_wait(self, obs_data_dir):
        """The timer runs from the wait for a batch to the step's end: its
        elapsed time covers the batches' data_load spans and every compute
        span, and the rate it publishes is the samples over that time."""
        trainer, _, events = _fit_spans(obs_data_dir, prefetch=2)
        covered = sum(e["dur"] for e in events
                      if e["name"] == "compute"
                      or (e["name"] == "data_load" and e["args"]["batch"] < self.BATCHES)) / 1e6
        timer = trainer.timer
        assert timer.steps == self.EPOCHS * self.BATCHES
        assert timer.samples == self.EPOCHS * trainer._train_data.num_samples
        assert covered <= timer.elapsed
        window = max(e["ts"] + e["dur"] for e in events) / 1e6 - min(e["ts"] for e in events) / 1e6
        assert timer.elapsed <= window
        assert timer.samples_per_sec == pytest.approx(timer.samples / timer.elapsed)


def _traced_copy(monkeypatch, copy_ms: tuple[float | None, float], compute: tuple[float, float],
                 enqueued: float = 0.0):
    """``Trainer._trace_copy`` of a copy whose events fire ``copy_ms``
    after an anchor at host time 10 s (no start event: None), its first
    leaf enqueued at host time ``enqueued``, for a step whose compute span
    is ``compute``: the recorded phases and events."""
    from distlr_tpu_torch.obs.tracing import Span
    from distlr_tpu_torch.train import Trainer
    from distlr_tpu_torch.train.trainer import _Copy

    tracer = PhaseTracer(registry=MetricsRegistry())
    monkeypatch.setattr("distlr_tpu_torch.train.trainer.get_tracer", lambda: tracer)
    trainer = Trainer(Config(device="cpu", num_feature_dim=8))
    trainer._clock = torchrt.DeviceClock(_StubAnchor(), 10.0)
    span = Span(tracer, "compute", None, None)
    span.t0, span.t1 = compute
    start = None if copy_ms[0] is None else _StubEvent(copy_ms[0])
    copy = _Copy(start, _StubEvent(copy_ms[1]), enqueued, 4096, trainer._clock)
    trainer._trace_copy(copy, span, {"epoch": 3, "batch": 1})
    return tracer.breakdown(), {e["name"]: e for e in tracer.chrome_trace()["traceEvents"]}


@pytest.mark.parametrize("copy_ms,compute,wait_s", [
    ((0.0, 100.0), (10.05, 10.2), 0.05),     # the step waits for the copy's end
    ((0.0, 40.0), (10.05, 10.2), None),      # the copy ended before the step began
    ((0.0, 250.0), (10.05, 10.2), 0.15),     # held to the compute span
    ((60.0, 160.0), (10.1, 10.3), 0.06),
])
def test_trace_copy_puts_the_copy_on_the_hosts_clock(monkeypatch, copy_ms, compute, wait_s):
    phases, events = _traced_copy(monkeypatch, copy_ms, compute)
    copy = events["h2d_copy"]
    assert phases["h2d_copy"]["bytes"] == 4096
    assert copy["tid"] == COPY_STREAM_TID and copy["args"]["batch"] == 1
    assert copy["dur"] == pytest.approx(1e3 * (copy_ms[1] - copy_ms[0]))
    if wait_s is None:
        assert "copy_wait" not in phases
    else:
        assert phases["copy_wait"]["seconds"] == pytest.approx(wait_s, abs=1e-6)
        wait = events["copy_wait"]
        assert wait["args"] == {"epoch": 3, "batch": 1} and "bytes" not in wait["args"]


@pytest.mark.parametrize("start_ms,enqueued,start", [
    (0.0, 9.0, 10.0),       # behind a running copy: the start event
    (0.0, 10.02, 10.02),    # that copy ended before the enqueue returned
    (None, 10.02, 10.02),   # on an idle stream: the enqueue's return
    (None, 10.5, 10.1),     # a copy done before its enqueue returned: empty
])
def test_trace_copy_starts_no_earlier_than_the_enqueue_returned(monkeypatch, start_ms, enqueued,
                                                                start):
    _, events = _traced_copy(monkeypatch, (start_ms, 100.0), (10.05, 10.2), enqueued)
    copy = events["h2d_copy"]
    assert copy["dur"] == pytest.approx(1e6 * (10.1 - start))


@pytest.mark.parametrize("compute,anchored", [((10.5, 10.9), False), ((10.9, 11.2), True)])
def test_trace_copy_anchors_the_clock_anew_after_a_second(monkeypatch, compute, anchored):
    """A step that ends more than a second after the clock's anchor takes
    a new one; the copy's own clock times it all the same."""
    taken = []

    def take(cls, device):
        taken.append(device)
        return cls(_StubAnchor(), 20.0)

    monkeypatch.setattr(torchrt.DeviceClock, "take", classmethod(take))
    phases, events = _traced_copy(monkeypatch, (400.0, 1000.0), compute)
    assert len(taken) == anchored
    assert events["h2d_copy"]["dur"] == pytest.approx(6e5)
    assert phases["copy_wait"]["seconds"] == pytest.approx(min(11.0, compute[1]) - compute[0],
                                                           abs=1e-6)


def family_total_of(registry, name: str, **labels) -> float:
    """The sum of a family's children whose labels include ``labels``."""
    fam = registry.get(name)
    if fam is None:
        return 0.0
    return float(sum(c.value for v, c in fam.children()
                     if all(dict(zip(fam.labelnames, v)).get(k) == str(x)
                            for k, x in labels.items())))


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def obs_data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("obsdata")
    write_synthetic_shards(str(d), 800, 24, num_parts=2, seed=11, sparsity=0.0)
    return str(d)


class TestEndToEnd:
    def test_e2e_metrics_and_trace(self, obs_data_dir, tmp_path):
        """One short async PS run: /metrics serves non-zero trainer,
        PS-server and PS-client series, and the trace holds JAX's phases."""
        from distlr_tpu_torch.train.ps_trainer import run_ps_local

        tracer = get_tracer()
        tracer.reset()
        before = {
            "pull": _series("distlr_ps_client_ops_total", op="pull", status="ok"),
            "push": _series("distlr_ps_client_ops_total", op="push_pull", status="ok"),
            "steps": _series("distlr_train_steps_total", loop="ps"),
            "spawns": family_total("distlr_ps_server_spawns_total", get_registry()),
        }
        cfg = Config(device="cpu", data_dir=obs_data_dir, num_feature_dim=24, num_iteration=3,
                     learning_rate=0.2, l2_c=0.0, batch_size=100, test_interval=1,
                     sync_mode=False, num_workers=2, num_servers=1, ps_timeout_ms=60_000)
        run_ps_local(cfg, save=False, eval_fn=lambda *_: None)
        with start_metrics_server(port=0) as srv:
            text = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                          timeout=10).read().decode()
        assert _series("distlr_ps_client_ops_total", op="pull", status="ok") > before["pull"]
        assert _series("distlr_ps_client_ops_total", op="push_pull",
                       status="ok") > before["push"]
        for needle in ('distlr_ps_client_ops_total{op="pull",status="ok"}',
                       'distlr_ps_client_ops_total{op="push_pull",status="ok"}',
                       "distlr_ps_client_op_seconds_bucket",
                       'distlr_ps_client_bytes_total{op="pull",direction="received"}',
                       'distlr_train_steps_total{loop="ps"}', "distlr_train_staleness_seconds",
                       "distlr_ps_server_spawns_total"):
            assert needle in text, needle
        assert _series("distlr_train_steps_total", loop="ps") > before["steps"]
        assert family_total("distlr_ps_server_spawns_total", get_registry()) > before["spawns"]
        phases = tracer.phase_names()
        assert {"pull", "compute", "push", "barrier_wait", "eval"} <= phases
        path = str(tmp_path / "trace.json")
        tracer.dump_chrome_trace(path)
        names = {e["name"] for e in json.load(open(path))["traceEvents"]}
        assert {"pull", "compute", "push", "barrier_wait", "eval"} <= names

    @pytest.mark.parametrize("sync_mode", [True, False], ids=["sync", "async"])
    def test_ps_phases_and_counts_equal_jax(self, obs_data_dir, sync_mode):
        """The same PS run on each package: the tracer's phase set, and the
        deltas of the client's ops, the workers' steps and samples and the
        servers' spawns, are JAX's."""
        from distlr_tpu.train.ps_trainer import run_ps_local as jax_run
        from distlr_tpu_torch.train.ps_trainer import run_ps_local

        kw = dict(data_dir=obs_data_dir, num_feature_dim=24, num_iteration=2,
                  learning_rate=0.2, l2_c=0.0, batch_size=100, test_interval=1,
                  sync_mode=sync_mode, num_workers=2, num_servers=2, ps_timeout_ms=60_000)
        counted = [("distlr_ps_client_ops_total", {"op": op, "status": "ok"})
                   for op in ("pull", "push_pull", "push_init", "barrier")] + [
            ("distlr_train_steps_total", {"loop": "ps"}),
            ("distlr_train_samples_total", {"loop": "ps"}),
            ("distlr_ps_server_spawns_total", {})]
        got = {}
        for name, run, cfg, reg, tracer in (
                ("ours", run_ps_local, Config(device="cpu", **kw), get_registry(), get_tracer()),
                ("jax", jax_run, JaxConfig(**kw), jax_registry.get_registry(),
                 jax_tracing.get_tracer())):
            tracer.reset()
            before = [family_total_of(reg, n, **lab) for n, lab in counted]
            run(cfg, save=False, eval_fn=lambda *_: None)
            got[name] = ([family_total_of(reg, n, **lab) - b
                          for (n, lab), b in zip(counted, before)], tracer.phase_names())
        assert got["ours"][0] == got["jax"][0]
        assert got["ours"][1] == got["jax"][1]
        assert {"pull", "compute", "push", "barrier_wait", "eval"} <= got["ours"][1]

    def test_launch_obs_flags_wire_through(self, obs_data_dir, tmp_path):
        """``--metrics-port 0 --trace-path`` through the real CLI: the
        METRICS line names a live endpoint during the run, and the trace
        file holds the sync trainer's phases afterwards."""
        trace = str(tmp_path / "sync_trace.json")
        proc = subprocess.Popen(
            [sys.executable, "-m", "distlr_tpu_torch.launch", "sync", "--data-dir",
             obs_data_dir, "--num-feature-dim", "24", "--num-iteration", "2",
             "--test-interval", "1", "--device", "cpu", "--metrics-port", "0",
             "--trace-path", trace],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        announced = [ln for ln in out.splitlines() if ln.startswith("METRICS ")]
        assert announced, out
        host, port = announced[0].split()[1].rsplit(":", 1)
        assert host == "127.0.0.1" and 0 < int(port) < 1 << 16
        names = {e["name"] for e in json.load(open(trace))["traceEvents"]}
        assert {"data_load", "h2d", "compute", "eval"} <= names

    def test_serve_metrics_endpoint_during_traffic(self):
        """A scoring server's per-listener series move with its STATS, and
        one scrape carries them (the card phase's serving check at D = 32)."""
        from distlr_tpu_torch.serve import ScoringEngine, ScoringServer, score_lines_over_tcp

        D = 32
        eng = ScoringEngine(Config(device="cpu", num_feature_dim=D), np.ones(D, np.float32),
                            buckets=(16, 64), max_batch_size=64)
        with ScoringServer(eng, port=0) as srv, start_metrics_server(port=0) as ms:
            listener = f"{srv.host}:{srv.port}"
            before = _series("distlr_serve_requests_total", listener=listener)
            replies = score_lines_over_tcp(srv.host, srv.port, ["1:1 3:1"] * 5 + ["1:x"])
            text = urllib.request.urlopen(f"http://127.0.0.1:{ms.port}/metrics",
                                          timeout=10).read().decode()
            doc = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{ms.port}/metrics.json",
                                                    timeout=10).read())
            stats = srv.stats()
        assert replies[-1].startswith("ERR") and stats["requests"] == 5
        assert _series("distlr_serve_requests_total", listener=listener) - before == 5
        assert _series("distlr_serve_errors_total", listener=listener) == stats["errors"] == 1
        assert f'distlr_serve_requests_total{{listener="{listener}"}}' in text
        assert "distlr_serve_engine_rows_total" in doc


# ---------------------------------------------------------------------------
# the attributes chip_smoke.py reads, against their series
# ---------------------------------------------------------------------------

class TestAttributesMoveWithSeries:
    """``chip_smoke.py`` reads the port's per-client counters as
    attributes; each still exists and equals the delta of its series."""

    def test_retries_and_reconnects(self):
        from distlr_tpu_torch.ps import KVWorker, RetryPolicy, ServerGroup

        before = (_series("distlr_ps_retries_total", op="pull"),
                  _series("distlr_ps_reconnects_total"))
        init = np.arange(8, dtype=np.float32)
        with ServerGroup(2, 1, 8, sync=False) as sg:
            with KVWorker(sg.hosts, 8, timeout_ms=5000, sync_group=False,
                          retry=RetryPolicy(attempts=4, backoff_ms=10.0)) as kv:
                kv.push_init(init)
                sg.procs[1].kill()
                sg.procs[1].wait()
                assert sg.respawn(1)
                with KVWorker(f"127.0.0.1:{sg.ports[1]}", 4) as kv1:
                    kv1.push_init(init[4:], force=True)
                np.testing.assert_array_equal(kv.pull(), init)
        assert kv.retries == {"pull": 1} and kv.reconnects == 1
        assert _series("distlr_ps_retries_total", op="pull") - before[0] == kv.retries["pull"]
        assert _series("distlr_ps_reconnects_total") - before[1] == kv.reconnects

    def test_push_outcome_unknown(self):
        from distlr_tpu_torch.chaos import ChaosFabric, parse_plan
        from distlr_tpu_torch.ps import KVWorker, RetryPolicy, ServerGroup

        plan = parse_plan({"faults": [{"kind": "reset", "links": [0], "after_ops": 4}]})
        before = (_series("distlr_ps_push_outcome_unknown_total"),
                  family_total("distlr_chaos_faults_total", get_registry()))
        with ServerGroup(1, 1, 8, sync=False) as g:
            with ChaosFabric(g.direct_hosts, plan) as fab:
                kv = KVWorker(fab.hosts, 8, timeout_ms=2000, sync_group=False,
                              retry=RetryPolicy(attempts=4, backoff_ms=10))
                kv.push_init(np.zeros(8, np.float32))
                for _ in range(5):
                    kv.push(np.ones(8, np.float32))
                kv.close()
                faults = sum(fab.counters["faults"].values())
        assert kv.push_outcome_unknown == 1
        assert (_series("distlr_ps_push_outcome_unknown_total") - before[0]
                == kv.push_outcome_unknown)
        assert family_total("distlr_chaos_faults_total", get_registry()) - before[1] == faults

    def test_reroutes_epoch_mismatches_and_client_epoch(self):
        from distlr_tpu_torch.ps import KVWorker, MembershipCoordinator, ServerGroup

        D = 64
        before = {n: _series(n) for n in ("distlr_membership_reroutes_total",
                                          "distlr_membership_epoch_mismatches_total",
                                          "distlr_ps_push_outcome_unknown_total")}
        reshards = family_total("distlr_reshard_total", get_registry())
        with ServerGroup(2, 1, D, sync=False, learning_rate=0.25) as g:
            coord = MembershipCoordinator(g)
            with KVWorker(None, D, sync_group=False, route=coord.layout) as kv:
                kv.push_init(np.zeros(D, np.float32))
                stop = threading.Event()

                def pusher():
                    while not stop.is_set():
                        kv.push(np.ones(D, np.float32))

                t = threading.Thread(target=pusher)
                t.start()
                try:
                    time.sleep(0.1)
                    coord.resize(4)
                    time.sleep(0.1)
                    coord.resize(2)
                    time.sleep(0.1)
                finally:
                    stop.set()
                    t.join(30)
                kv.pull()
                assert not t.is_alive()
                assert kv.reroutes >= 1 and kv.client_epoch == 3
                assert _series("distlr_membership_client_epoch") == kv.client_epoch
        assert _series("distlr_membership_reroutes_total") - before[
            "distlr_membership_reroutes_total"] == kv.reroutes
        assert _series("distlr_membership_epoch_mismatches_total") - before[
            "distlr_membership_epoch_mismatches_total"] == kv.epoch_mismatches
        assert _series("distlr_ps_push_outcome_unknown_total") - before[
            "distlr_ps_push_outcome_unknown_total"] == kv.push_outcome_unknown
        assert family_total("distlr_reshard_total", get_registry()) - reshards == 2
        assert _series("distlr_membership_epoch") == coord.epoch == 3
        assert _series("distlr_membership_servers") == g.membership_servers

    def test_online_trainer_pushes(self, tmp_path):
        from distlr_tpu_torch.feedback import OnlineTrainer
        from distlr_tpu_torch.ps import ServerGroup

        D = 16
        rng = np.random.default_rng(5)
        shard_dir = tmp_path / "shards"
        shard_dir.mkdir()
        with open(shard_dir / "shard-000000.libsvm", "w") as f:
            for _ in range(24):
                cols = sorted(rng.choice(D, 3, replace=False))
                f.write(f"{int(rng.integers(2))} " + " ".join(f"{c}:1" for c in cols) + "\n")
        names = ("distlr_feedback_online_pushes_total", "distlr_feedback_examples_trained_total",
                 "distlr_feedback_shards_consumed_total")
        before = {n: _series(n) for n in names}
        cfg = Config(device="cpu", num_feature_dim=D, batch_size=8, l2_c=0.0, sync_mode=False)
        with ServerGroup(1, 1, D, sync=False) as sg:
            trainer = OnlineTrainer(cfg, sg.hosts, str(shard_dir), accum_start=2, accum_max=2,
                                    poll_interval_s=0.01, idle_flush_s=0.0)
            stats = trainer.run(idle_exit_s=0.05)
            trainer.close()
        assert stats["pushes"] == trainer.pushes >= 1
        assert _series(names[0]) - before[names[0]] == trainer.pushes
        assert _series(names[1]) - before[names[1]] == trainer.examples == 24
        assert _series(names[2]) - before[names[2]] == trainer.shards_consumed == 1
        assert _series("distlr_feedback_accum_batches") == trainer.accum_k
