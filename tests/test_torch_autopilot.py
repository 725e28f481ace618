"""The port's fleet autopilot (``distlr_tpu_torch/autopilot``) against the
JAX package's (``distlr_tpu/autopilot``, ``tests/test_autopilot.py``), on
the CPU.

* The policy: one scripted :class:`FleetSignals` sequence through both
  packages' :class:`PolicyEngine` gives the same decisions, byte for byte
  as journal lines, under default and tight configurations.
* The daemon: one scripted ``fleet.json`` sequence with stub actuators
  and an injected clock gives equal decisions and equal journal lines
  but for the wall-clock ``ts``; the journal header and its reader;
  rates seeded from ``history.jsonl``; fail-safe holds.
* The actuators on the port's own endpoints: ``PSActuator`` against the
  port's ``ps-ctl`` coordinator on an elastic group, ``EngineActuator``
  against the port's router through ``RouterAdmin``, ``WorkerActuator``
  spawning and retiring processes.
* ``launch autopilot``: JAX's exit-2 contracts and a bounded run against
  a fleet endpoint, journaling under the run dir.
"""

from __future__ import annotations

import contextlib
import http.server
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from distlr_tpu import autopilot as jax_ap
from distlr_tpu.config import Config as JaxConfig
from distlr_tpu_torch import autopilot as ap
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.ps import KVWorker, MembershipCoordinator, MembershipServer, ServerGroup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32
#: a worker command that parks until retired
SLEEPER = f"{sys.executable} -c 'import time; time.sleep(120)' {{worker_id}}"


class _Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t


class _ScriptActuators:
    """Quacks like :class:`Actuators`; an apply changes the counts the next
    tick sees."""

    def __init__(self, mod, **counts):
        self.mod = mod
        self.counts = {"ps": None, "engine": None, "worker": None, "ps_busy": False, **counts}
        self.applied: list[tuple[str, int]] = []
        self.fail = False

    def current(self) -> dict:
        return dict(self.counts)

    def apply(self, actuator: str, target: int) -> str:
        if self.fail:
            raise self.mod.ActuatorError("scripted refusal")
        self.applied.append((actuator, target))
        self.counts[actuator] = target
        return f"set {actuator}={target}"

    def close(self) -> None:
        pass


def _cur(ps=2, engine=2, worker=2, ps_busy=False) -> dict:
    return {"ps": ps, "engine": engine, "worker": worker, "ps_busy": ps_busy}


#: (signals kwargs, current counts, now): every band both ways, hysteresis,
#: cooldowns, arbitration, the unreachable and alert holds, a rollback
_SIGNALS = [
    ({"push_rate": 100.0, "shed_rate": 0.0, "req_rate": 50.0}, _cur(), 0.0),
    ({"shed_rate": 10.0}, _cur(), 1.0),
    ({"shed_rate": 10.0}, _cur(), 2.0),
    ({"reachable": False}, _cur(engine=3), 3.0),
    ({"alerts": ("distlr_alert_x{}",)}, _cur(engine=3), 4.0),
    ({"shard_lag": 0.25}, _cur(engine=2), 30.0),
    ({"shard_lag": 0.25}, _cur(engine=2), 31.0),
    ({"staleness_pushes_p99": 500.0}, _cur(worker=1), 50.0),
    ({"staleness_pushes_p99": 500.0}, _cur(worker=1), 51.0),
    ({"push_rate": 1.0}, _cur(ps=3, worker=1), 70.0),
    ({"push_rate": 1.0}, _cur(ps=3, worker=1), 71.0),
    ({"push_rate": 1.0}, _cur(ps=3, worker=1, ps_busy=True), 90.0),
    ({"req_rate": 0.1, "shed_rate": 0.0}, _cur(ps=2, worker=1), 110.0),
    ({"req_rate": 0.1, "shed_rate": 0.0}, _cur(ps=2, worker=1), 111.0),
    ({"route_p99_ms": 900.0}, _cur(engine=1, worker=1), 130.0),
    ({"route_p99_ms": 900.0}, _cur(engine=1, worker=1), 131.0),
    ({"shard_lag": 40.0, "route_p99_ms": 900.0}, _cur(engine=8, worker=8), 150.0),
    ({"shard_lag": 40.0}, _cur(engine=8, worker=8), 151.0),
    ({"alerts": ("rollout_fleet_unreachable",)}, _cur(), 152.0),
    ({"push_rate": 900.0}, _cur(ps=None), 170.0),
    ({"push_rate": 900.0}, _cur(ps=None), 171.0),
]


def _journal(mod, cfg_kw: dict) -> list[str]:
    engine = mod.PolicyEngine(mod.PolicyConfig(**cfg_kw))
    return [engine.tick(mod.FleetSignals(**s), dict(c), t).to_json() for s, c, t in _SIGNALS]


@pytest.mark.parametrize("cfg_kw", [{}, {"hysteresis_ticks": 1, "cooldown_s": 5.0},
                                    {"ps_max": 3, "engine_min": 2, "rollback_window_s": 1.0}],
                         ids=["default", "tight", "bounded"])
def test_policy_decisions_equal_jax(cfg_kw):
    ours, theirs = _journal(ap, cfg_kw), _journal(jax_ap, cfg_kw)
    assert ours == theirs
    rules = [json.loads(line)["rule"] for line in ours]
    assert len(set(rules)) >= 5  # the sequence reaches several rules


def test_policy_config_from_config_equals_jax():
    kw = {"autopilot_hysteresis_ticks": 5, "autopilot_engine_max": 3,
          "autopilot_push_rate_high": 400.0, "autopilot_lag_low": 0.5,
          "autopilot_cooldown_s": 2.5}
    ours = ap.PolicyConfig.from_config(Config(device="cpu", **kw))
    theirs = jax_ap.PolicyConfig.from_config(JaxConfig(**kw))
    assert ours.__dict__ == theirs.__dict__
    assert ap.ACTUATORS == jax_ap.ACTUATORS
    assert ap.policy.UNREACHABLE_ALERT == jax_ap.policy.UNREACHABLE_ALERT


def _fleet_script():
    """A scripted fleet.json sequence: shed and push rates that rise, a lag
    that builds, an aggregator outage, a malformed doc."""
    docs = []
    for i in range(1, 13):
        if i == 6:
            docs.append(OSError("aggregator down"))
            continue
        if i == 9:
            docs.append(ValueError("bad json"))
            continue
        docs.append({"ranks": [
            {"role": "route", "rank": 0, "route_shed": 30.0 * i * (i > 3),
             "route_requests": 100.0 * i, "route_p99_ms": 20.0 + i},
            {"role": "ps", "rank": 0, "pushes": 500.0 * i * i,
             "staleness_pushes_p99": 3.0 * i},
            {"role": "online", "rank": 0, "shard_lag": float(i % 5)},
        ]})
    return docs


def _run_daemon(mod, run_dir, *, alerts_at=()):
    docs = iter(_fleet_script())
    clock = _Clock(1000.0)
    tick = [0]

    def fetch():
        doc = next(docs)
        if isinstance(doc, Exception):
            raise doc
        return doc

    def poll():
        return ["distlr_alert_route_shed{}"] if tick[0] in alerts_at else []

    acts = _ScriptActuators(mod, ps=2, engine=1, worker=1)
    d = mod.AutopilotDaemon(mod.PolicyEngine(mod.PolicyConfig(hysteresis_ticks=2, cooldown_s=3.0)),
                            acts, fetch=fetch, alert_poll=poll, journal_dir=run_dir, clock=clock,
                            rate_window_s=5.0)
    rules = []
    for tick[0] in range(12):
        rules.append(d.tick_once().rule)
        clock.t += 1.0
    return rules, acts.applied, os.path.join(run_dir, "autopilot", "decisions.jsonl"), d


@pytest.mark.parametrize("alerts_at", [(), (7, 8)], ids=["clean", "alerts"])
def test_daemon_decisions_and_journal_equal_jax(tmp_path, alerts_at):
    ours = _run_daemon(ap, str(tmp_path / "ours"), alerts_at=alerts_at)
    theirs = _run_daemon(jax_ap, str(tmp_path / "jax"), alerts_at=alerts_at)
    assert ours[0] == theirs[0] and ours[1] == theirs[1]
    assert ours[1]  # the script makes the daemon act
    with open(ours[2]) as f:
        lines = f.read().splitlines()
    with open(theirs[2]) as f:
        jlines = f.read().splitlines()
    assert lines[0] == jlines[0] == json.dumps({"schema": 1, "kind": "autopilot_decisions"})
    assert len(lines) == len(jlines) == 13

    def untimed(line):
        doc = json.loads(line)
        assert isinstance(doc.pop("ts"), float)
        return doc

    assert [untimed(a) for a in lines[1:]] == [untimed(b) for b in jlines[1:]]
    assert ap.AutopilotDaemon.read_journal(ours[2]) == [
        json.loads(line) for line in lines[1:]]
    st, jst = ours[3].status(), theirs[3].status()
    assert {k: v for k, v in st.items() if k != "journal"} == {
        k: v for k, v in jst.items() if k != "journal"}


def test_read_journal_rejects_what_jax_rejects(tmp_path):
    cases = {"headerless": json.dumps({"rule": "steady"}) + "\n",
             "future": json.dumps({"schema": 99, "kind": "autopilot_decisions"}) + "\n",
             "torn": json.dumps({"schema": 1, "kind": "autopilot_decisions"}) + "\n"
             + json.dumps({"rule": "steady", "action": None}) + "\n" + '{"rule": "engi'}
    for name, text in cases.items():
        path = tmp_path / f"{name}.jsonl"
        path.write_text(text)
        try:
            theirs = jax_ap.AutopilotDaemon.read_journal(str(path))
        except ValueError as e:
            with pytest.raises(ValueError) as ours:
                ap.AutopilotDaemon.read_journal(str(path))
            assert ("autopilot_decisions" in str(e)) == ("autopilot_decisions" in str(ours.value))
            assert ("schema 99" in str(e)) == ("schema 99" in str(ours.value))
            continue
        assert ap.AutopilotDaemon.read_journal(str(path)) == theirs == [
            {"rule": "steady", "action": None}]


def test_seed_rates_from_history_like_jax(tmp_path):
    with open(tmp_path / "history.jsonl", "w") as f:
        for i, t in enumerate((100.0, 102.0, 104.0, 106.0)):
            f.write(json.dumps({"updated": t, "ranks": [
                {"role": "route", "rank": 0, "route_shed": 40.0 * i,
                 "route_requests": 100.0 * i}]}) + "\n")
    seeded = []
    for mod in (ap, jax_ap):
        d = mod.AutopilotDaemon(mod.PolicyEngine(mod.PolicyConfig(hysteresis_ticks=1)),
                                _ScriptActuators(mod, engine=1),
                                fetch=lambda: {"ranks": [{"role": "route", "rank": 0,
                                                          "route_shed": 160.0,
                                                          "route_requests": 400.0}]},
                                clock=_Clock(50.0), rate_window_s=10.0)
        n = d.seed_rates_from_history(str(tmp_path))
        seeded.append((n, d.tick_once().to_json()))
    assert seeded[0] == seeded[1]
    assert seeded[0][0] == 4 and json.loads(seeded[0][1])["rule"] == "engine_up"


def test_fleet_fetcher_reads_fleet_json():
    doc = {"ranks": [{"role": "ps", "rank": 0}], "alerts": []}

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(doc).encode()
            self.send_response(200 if self.path == "/fleet.json" else 404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        assert ap.fleet_fetcher(f"http://127.0.0.1:{srv.server_port}")() == doc
    finally:
        srv.shutdown()
        t.join()
    with pytest.raises(OSError):
        ap.fleet_fetcher("http://127.0.0.1:1", timeout_s=0.3)()


# ---------------------------------------------------------------------------
# the actuators on the port's own endpoints
# ---------------------------------------------------------------------------

def test_ps_actuator_resizes_the_ports_elastic_group():
    with ServerGroup(2, 1, D, sync=False) as g:
        coord = MembershipCoordinator(g)
        with KVWorker(g.hosts, D, sync_group=False) as s:
            s.push_init(np.arange(D, dtype=np.float32))
        with MembershipServer(coord) as ctl:
            act = ap.PSActuator(f"127.0.0.1:{ctl.port}")
            assert act.current() == (2, False)
            assert act.scale(4).startswith("resize accepted")  # RESIZE 4 wait=0
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and act.current() != (4, False):
                time.sleep(0.05)
            assert act.current() == (4, False) and g.num_servers == 4
            with KVWorker(g.hosts, D, sync_group=False) as kv:
                np.testing.assert_array_equal(kv.pull(), np.arange(D, dtype=np.float32))
            assert act.scale(4).startswith("resize accepted")  # the current size: a noop
            with pytest.raises(ap.ActuatorError, match="refused"):
                act.scale(0)
    unreachable = ap.PSActuator("127.0.0.1:1", timeout_s=0.3)
    assert unreachable.current() == (None, True)
    with pytest.raises(ap.ActuatorError):
        unreachable.scale(2)


def _tier(n):
    from distlr_tpu_torch.serve import ScoringEngine, ScoringRouter, ScoringServer

    servers = []
    for _ in range(n):
        eng = ScoringEngine(Config(device="cpu", num_feature_dim=8, model="sparse_lr", l2_c=0.0))
        eng.set_weights(np.zeros(8, np.float32))
        servers.append(ScoringServer(eng).start())
    addrs = [f"{s.host}:{s.port}" for s in servers]
    return servers, addrs, ScoringRouter([addrs[0]], max_inflight=4).start()


def test_engine_actuator_promotes_and_demotes_on_the_ports_router():
    servers, addrs, router = _tier(3)
    try:
        act = ap.EngineActuator(f"{router.host}:{router.port}", addrs)
        assert act.current() == 1
        assert act.scale(2) == f"added {addrs[1]}"
        assert act.scale(3) == f"added {addrs[2]}"
        with pytest.raises(ap.ActuatorError, match="no standby"):
            act.scale(4)
        assert act.scale(2) == f"removed {addrs[2]}"  # the youngest goes first
        assert act.scale(1) == f"removed {addrs[1]}"
        assert act.current() == 1 and act.scale(1) == "noop"
        ghost = ap.EngineActuator(f"{router.host}:{router.port}", addrs, model="ghost")
        assert ghost.current() is None
        with pytest.raises(ap.ActuatorError):
            ghost.scale(2)
    finally:
        router.stop()
        for s in servers:
            s.stop()
    with pytest.raises(ValueError, match="host:port"):
        ap.EngineActuator("nonsense", [])


def test_worker_actuator_spawns_and_retires():
    with pytest.raises(ValueError, match="worker_id"):
        ap.WorkerActuator(f"{sys.executable} -c pass")
    act = ap.WorkerActuator(SLEEPER, term_timeout_s=15.0)
    try:
        assert act.current() == 0
        assert act.scale(1).startswith("spawned worker 0")
        assert act.scale(2).startswith("spawned worker 1")
        assert act.scale(1).startswith("retired worker 1")
        assert act.scale(2).startswith("spawned worker 2")  # ids are never reused
    finally:
        act.stop_all()
    assert act.current() == 0
    bad = ap.WorkerActuator("/nonexistent-worker-binary {worker_id}")
    with pytest.raises(ap.ActuatorError, match="spawn"):
        bad.scale(1)


# ---------------------------------------------------------------------------
# launch autopilot
# ---------------------------------------------------------------------------

def _launch(*argv, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", *argv], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("argv,msg", [
    ([], "no fleet source"),
    (["--fleet", "http://127.0.0.1:1", "--router", "127.0.0.1:2"], "--router needs --replica-pool"),
    (["--fleet", "http://127.0.0.1:1"], "nothing to actuate"),
])
def test_launch_autopilot_refusals_like_jax(argv, msg, tmp_path):
    from distlr_tpu import launch as jax_launch
    from distlr_tpu_torch import launch

    outs = []
    for main, extra in ((launch.main, ["--device", "cpu"]), (jax_launch.main, [])):
        with contextlib.redirect_stderr(io.StringIO()) as err:
            outs.append((main(["autopilot", *argv, *extra]), err.getvalue()))
    assert outs[0] == outs[1] and outs[0][0] == 2 and msg in outs[0][1]


def test_launch_autopilot_runs_against_a_fleet_endpoint(tmp_path):
    """``launch autopilot --iterations 3`` with the ps actuator bound to the
    port's coordinator: three ticks journaled under ``--journal-dir``."""
    from distlr_tpu_torch.obs import MetricsServer

    doc = {"ranks": [{"role": "ps", "rank": 0, "pushes": 0.0}], "alerts": [], "totals": {}}
    srv = MetricsServer(port=0, extra_json={"/fleet.json": lambda: doc}).start()
    try:
        with ServerGroup(2, 1, D, sync=False) as g:
            with MembershipServer(MembershipCoordinator(g)) as ctl:
                proc = _launch("autopilot", "--fleet", f"http://{srv.host}:{srv.port}",
                               "--ps-ctl", f"127.0.0.1:{ctl.port}", "--iterations", "3",
                               "--interval", "0.1", "--unwatched", "--journal-dir",
                               str(tmp_path), "--device", "cpu")
    finally:
        srv.stop()
    assert proc.returncode == 0, proc.stderr
    head = json.loads(proc.stdout.split("AUTOPILOT ", 1)[1].splitlines()[0])
    assert head["actuators"] == ["ps"]
    tail = json.loads(proc.stdout.split("AUTOPILOT-EXIT ", 1)[1].splitlines()[0])
    assert tail["ticks"] == 3
    docs = ap.AutopilotDaemon.read_journal(str(tmp_path / "autopilot" / "decisions.jsonl"))
    assert [d["tick"] for d in docs] == [1, 2, 3]
