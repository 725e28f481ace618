"""The port's fleet observability plane, part two: the structured fleet
log (``distlr_tpu_torch/obs/log.py``), the continuous profiler
(``obs/profile.py``) and incident bundles (``obs/incident.py``), each
against the JAX package's module on the same inputs, on the CPU.

* log: the same record sequence, on one injected monotonic clock, gives
  equal journals (after dedupe and the level filter), rings and stats but
  for pid and time; records carry the trace ids of the port's spans; the
  tee attaches to ``distlr_tpu_torch*`` loggers only, never JAX's;
  ``read_records`` merges alike.
* profile: ``prof-agg`` over the same journals (Python windows and the
  native server's CPU windows) writes byte-equal collapsed stacks and
  speedscope JSON but for the exporter name; stacks fold alike; a sampler
  tags its samples with the port's active span; one trigger gives one
  flight dump and one burst window that name each other.
* incident: the same run dir assembles into equal bundles (manifest,
  timeline, postmortem) but for its own path; list, load, render, prune
  and ``latest_seq`` agree; ``launch incident`` and ``launch logs``
  through the CLI.

Clocks are injected (the ``sync`` facade's ``monotonic``) or the
timeline is scripted; no case sleeps more than a second.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time

import pytest

from distlr_tpu import sync as jax_sync
from distlr_tpu.obs import dtrace as jax_dtrace
from distlr_tpu.obs import incident as jax_incident
from distlr_tpu.obs import log as jax_fleetlog
from distlr_tpu.obs import profile as jax_profile
from distlr_tpu_torch import sync
from distlr_tpu_torch.obs import dtrace, incident, profile
from distlr_tpu_torch.obs import log as fleetlog
from distlr_tpu_torch.utils.logging import get_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset():
    yield
    for mod in (profile, jax_profile, fleetlog, jax_fleetlog, dtrace, jax_dtrace):
        mod.reset_for_tests()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _write_jsonl(path: str, recs) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


# ---------------------------------------------------------------------------
# log
# ---------------------------------------------------------------------------

#: (clock step, level, message, template): repeats inside and past the
#: dedupe window, levels under the journal level, distinct templates
_RECORDS = [(0.0, "info", "worker 0 up", None), (0.1, "debug", "tick", None),
            (0.2, "warning", "rank 3 timed out", "rank %d timed out"),
            (0.3, "warning", "rank 4 timed out", "rank %d timed out"),
            (0.4, "warning", "rank 5 timed out", "rank %d timed out"),
            (3.0, "error", "push failed", None), (3.1, "error", "push failed", None),
            (6.0, "warning", "rank 6 timed out", "rank %d timed out"),
            (6.5, "info", "worker 0 up", None), (9.0, "error", "push failed", None),
            (9.1, "loud", "unknown level", None)]


def _log_run(mod, smod, run_dir, **kw):
    clock, owner = _Clock(), object()
    smod.install({"monotonic": clock}, owner=owner)
    try:
        lg = mod.FleetLogger(run_dir, "ps", 2, **kw)
        for step, level, msg, template in _RECORDS:
            clock.t = step
            lg.emit(level, msg, logger="x.y", template=template, args={"n": 1})
        lg.close()
    finally:
        smod.uninstall(owner=owner)
    return lg


def _untimed(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in ("ts", "pid")}


@pytest.mark.parametrize("kw", [{}, {"level": "warning", "dedupe_s": 2.0},
                                {"level": "debug", "ring": 3, "dedupe_s": 0.0}],
                         ids=["default", "warning", "debug-ring3"])
def test_log_journal_ring_and_stats_equal_jax(tmp_path, kw):
    ours = _log_run(fleetlog, sync, str(tmp_path / "ours"), **kw)
    theirs = _log_run(jax_fleetlog, jax_sync, str(tmp_path / "jax"), **kw)
    path = os.path.join("logs", "ps-2.jsonl")
    with open(tmp_path / "ours" / path) as f:
        lines = [json.loads(x) for x in f]
    with open(tmp_path / "jax" / path) as f:
        jlines = [json.loads(x) for x in f]
    assert [_untimed(r) for r in lines] == [_untimed(r) for r in jlines]
    assert len(lines) > 2
    assert [_untimed(r) for r in ours.tail(50)] == [_untimed(r) for r in theirs.tail(50)]
    st, jst = ours.stats(), theirs.stats()
    assert (st["records"], st["suppressed"]) == (jst["records"], jst["suppressed"])
    records = fleetlog.read_records(str(tmp_path / "ours"), level="warning", grep="timed")
    jrecords = jax_fleetlog.read_records(str(tmp_path / "jax"), level="warning", grep="timed")
    assert [_untimed(r) for r in records] == [_untimed(r) for r in jrecords]


def test_log_refusals_equal_jax():
    for kw in ({"level": "loud"}, {"ring": 0}, {"dedupe_s": -1.0}):
        with pytest.raises(ValueError) as theirs:
            jax_fleetlog.FleetLogger(None, "t", 0, **kw)
        with pytest.raises(ValueError) as ours:
            fleetlog.FleetLogger(None, "t", 0, **kw)
        assert str(ours.value) == str(theirs.value)


def test_log_tee_stamps_trace_ids_and_keeps_to_its_package(tmp_path):
    run = str(tmp_path)
    dtrace.configure(run, "ps", 0, sample=1.0)
    early = get_logger("distlr_tpu_torch.fleetlog_test.early")
    fleetlog.configure(run, "ps", 0, dedupe_s=0.0)
    late = get_logger("distlr_tpu_torch.fleetlog_test.late")  # the provider hook
    jax_logger = logging.getLogger("distlr_tpu.fleetlog_test")
    jax_logger.addHandler(logging.NullHandler())
    ctx = dtrace.new_trace()
    with dtrace.use(ctx), dtrace.span("train.step") as sp:
        early.warning("inside %s", "the span")
        ids = dtrace.current_ids()
    late.warning("outside")
    jax_logger.warning("a JAX record")
    fleetlog.stop()
    assert sp is not None
    recs = fleetlog.read_records(run)
    assert [r["msg"] for r in recs] == ["inside the span", "outside"]
    assert recs[0]["trace"] == f"{ids[0]:016x}" and recs[0]["span"] == f"{ids[1]:016x}"
    assert "trace" not in recs[1]
    assert recs[0]["logger"] == "distlr_tpu_torch.fleetlog_test.early"
    # stop() detached the tee: stderr handlers only
    assert all(not isinstance(h, fleetlog._JournalHandler) for h in early.handlers)


def test_launch_logs_cli(tmp_path):
    run = str(tmp_path)
    _write_jsonl(os.path.join(run, "logs", "ps-0.jsonl"), [
        {"type": "meta", "role": "ps", "rank": 0},
        {"type": "record", "ts": 100.0, "level": "info", "role": "ps", "rank": 0,
         "logger": "x", "msg": "hello"},
        {"type": "record", "ts": 101.0, "level": "error", "role": "ps", "rank": 0,
         "logger": "x", "msg": "push failed", "trace": "00000000000000ab", "suppressed": 2}])
    _write_jsonl(os.path.join(run, "spans", "ps-0.jsonl"), [
        {"type": "span", "name": "train.step", "trace": "00000000000000ab",
         "span": "01", "ts": 100.5e6, "dur": 2000.0}])
    outs = []
    for pkg, extra in (("distlr_tpu_torch", ["--device", "cpu"]), ("distlr_tpu", [])):
        outs.append([subprocess.run(
            [sys.executable, "-m", f"{pkg}.launch", "logs", "--obs-run-dir", run, *argv, *extra],
            cwd=REPO, capture_output=True, text=True, timeout=120,
            env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO))
            for argv in (["--json"], ["--trace", "ab", "--json"], ["--level", "error"],
                         ["--grep", "nothing"])])
    for ours, theirs in zip(*outs):
        assert (ours.returncode, ours.stdout) == (theirs.returncode, theirs.stdout)
    assert [p.returncode for p in outs[0]] == [0, 0, 0, 1]
    assert [json.loads(x)["kind"] if "kind" in x else "record"
            for x in outs[0][1].stdout.splitlines()] == ["span", "record"]


# ---------------------------------------------------------------------------
# profile
# ---------------------------------------------------------------------------


def _profile_journals(run: str) -> None:
    _write_jsonl(os.path.join(run, "profiles", "ps-0.jsonl"), [
        {"type": "profwindow", "role": "ps", "rank": 0, "kind": "window", "unit": "samples",
         "samples": 7, "stacks": {"train.step;a.main;b.step": 5, "-;a.main;c.idle": 2}},
        {"type": "profwindow", "role": "ps", "rank": 0, "kind": "burst", "unit": "samples",
         "incident": 0, "samples": 4, "stacks": {"train.step;a.main;b.step": 4}},
        {"type": "profwindow", "unit": "cpu_us", "samples": 1, "stacks": {"x": 1}}])
    with open(os.path.join(run, "profiles", "ps-0.jsonl"), "a") as f:
        f.write('{"type": "profwin')  # a torn tail
    _write_jsonl(os.path.join(run, "profiles", "kvserver-0.jsonl"), [
        {"type": "profwindow", "role": "kvserver", "rank": 0, "unit": "cpu_us", "samples": 900,
         "stacks": {"kv.push_pull;handler": 700, "kv.pull;handler": 200}}])
    _write_jsonl(os.path.join(run, "profiles", "serve-1.jsonl"), [{"type": "meta"}])


def test_prof_agg_output_byte_equal_jax(tmp_path):
    run = str(tmp_path / "run")
    _profile_journals(run)
    second = str(tmp_path / "run2")
    _profile_journals(second)  # a federated second dir: tracks suffixed #2
    tracks = profile.merge_run_dirs([run, second])
    assert tracks == jax_profile.merge_run_dirs([run, second])
    assert sorted(tracks) == ["kvserver-0", "kvserver-0#2", "ps-0", "ps-0#2"]
    for mod, stem in ((profile, "ours"), (jax_profile, "jax")):
        mod.write_collapsed(tracks, str(tmp_path / f"{stem}.collapsed"))
        mod.write_speedscope(tracks, str(tmp_path / f"{stem}.speedscope.json"))
    assert (tmp_path / "ours.collapsed").read_bytes() == (tmp_path / "jax.collapsed").read_bytes()
    ours = (tmp_path / "ours.speedscope.json").read_text()
    theirs = (tmp_path / "jax.speedscope.json").read_text()
    assert ours.replace('"distlr_tpu_torch.obs.profile"', '"distlr_tpu.obs.profile"') == theirs
    assert json.loads(ours)["exporter"] == "distlr_tpu_torch.obs.profile"
    proc = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", "prof-agg",
                           "--obs-run-dir", run, "--out", str(tmp_path / "cli"), "--device", "cpu"],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"PROF {tmp_path / 'cli'} tracks=2 stacks=4 samples=911"


def test_fold_stack_equals_jax_and_sampler_tags_port_spans(tmp_path):
    import sys as _sys

    frame = _sys._getframe()
    for tag in (None, "serve.request"):
        for depth in (2, 64):
            assert profile.fold_stack(frame, tag, depth) == jax_profile.fold_stack(frame, tag,
                                                                                    depth)
    stop, ready = threading.Event(), threading.Event()

    def body():
        with dtrace.use(dtrace.new_trace()), dtrace.span("train.step"):
            ready.set()
            while not stop.is_set():
                sum(range(200))

    dtrace.configure(str(tmp_path), "ps", 0, sample=1.0)
    t = threading.Thread(target=body)
    t.start()
    p = profile.SamplingProfiler(str(tmp_path), "ps", 0, hz=50)
    try:
        ready.wait(5)
        for _ in range(5):
            p.sample_once()
    finally:
        stop.set()
        t.join()
    doc = p.flush_window()
    assert any(k.startswith("train.step;") and "test_torch_fleetlog.body" in k
               for k in doc["stacks"])
    assert (doc["type"], doc["unit"], doc["role"], doc["kind"]) == (
        "profwindow", "samples", "ps", "window")
    assert profile.merge_run_dirs(str(tmp_path))["ps-0"]["samples"] == doc["samples"]


def test_one_trigger_one_dump_one_burst_that_name_each_other(tmp_path):
    run = str(tmp_path)
    dtrace.configure(run, "worker", 0, sample=0.0)
    profile.configure(run, "worker", 0, hz=50, window_s=30, burst_s=0.3)
    with dtrace.use(dtrace.new_trace()), dtrace.span("pre.alert"):
        pass
    dtrace.trigger(run, alert="distlr_alert_test")
    deadline = time.monotonic() + 5
    dumps = []
    while not dumps and time.monotonic() < deadline:
        dumps = glob.glob(os.path.join(run, "flightrec", "worker-0-*.json"))
        time.sleep(0.05)
    time.sleep(0.6)  # the burst window closes
    profile.stop()
    assert len(dumps) == 1
    with open(dumps[0]) as f:
        doc = json.load(f)
    assert doc["profile_journal"] == os.path.join(run, "profiles", "worker-0.jsonl")
    assert doc["profile_incident_seq"] == 0
    with open(os.path.join(run, "profiles", "worker-0.jsonl")) as f:
        bursts = [w for w in map(json.loads, f) if w.get("kind") == "burst"]
    assert len(bursts) == 1 and bursts[0]["incident"] == 0
    assert "distlr_alert_test" in bursts[0]["reason"]
    assert bursts[0]["hz"] == profile.BURST_HZ == jax_profile.BURST_HZ


def test_profrec_trigger_file_equals_jax(tmp_path):
    for mod, stem in ((profile, "ours"), (jax_profile, "jax")):
        run = str(tmp_path / stem)
        for reason in ("a", "b"):
            path = mod.trigger(run, reason)
    docs = []
    for stem in ("ours", "jax"):
        with open(tmp_path / stem / "profiles" / "TRIGGER.json") as f:
            doc = json.load(f)
        doc.pop("ts")
        docs.append(doc)
    assert docs[0] == docs[1] == {"seq": 1, "reason": "b"}
    assert path.endswith(os.path.join("profiles", "TRIGGER.json"))


# ---------------------------------------------------------------------------
# incident
# ---------------------------------------------------------------------------

T0 = 1_700_000_000.0


def _incident_run(run: str) -> None:
    """One run dir with every artifact family an incident collects, on a
    scripted timeline around ``T0``: a clock-probed peer, logs of two ranks,
    a flight dump and a burst window of seq 0, chaos instants, an
    autopilot journal and a rollout journal."""
    _write_jsonl(os.path.join(run, "spans", "obs-agg-0.jsonl"), [
        {"type": "meta", "role": "obs-agg", "rank": 0},
        {"type": "clock", "peer": "10.0.0.2:9001", "offset_s": 2.0},
        {"type": "instant", "name": "chaos.reset", "ts": (T0 - 3.0) * 1e6,
         "tags": {"link": 0, "fault": 2}}])
    _write_jsonl(os.path.join(run, "spans", "ps-0.jsonl"), [
        {"type": "meta", "role": "ps", "rank": 0, "listen": "0.0.0.0:9001"}])
    _write_jsonl(os.path.join(run, "logs", "ps-0.jsonl"), [
        {"type": "meta", "role": "ps", "rank": 0},
        {"type": "record", "ts": T0 + 1.5, "level": "error", "role": "ps", "rank": 0,
         "logger": "x", "msg": "died first", "trace": "00000000000000ab"},
        {"type": "record", "ts": T0 - 500.0, "level": "error", "role": "ps", "rank": 0,
         "logger": "x", "msg": "long before"},
        {"type": "record", "ts": T0, "level": "info", "role": "ps", "rank": 0,
         "logger": "x", "msg": "below warn"}])
    _write_jsonl(os.path.join(run, "logs", "obs-agg-0.jsonl"), [
        {"type": "record", "ts": T0, "level": "warning", "role": "obs-agg", "rank": 0,
         "logger": "y", "msg": "edge seen", "suppressed": 3}])
    os.makedirs(os.path.join(run, "flightrec"), exist_ok=True)
    with open(os.path.join(run, "flightrec", "ps-0-0.json"), "w") as f:
        json.dump({"role": "ps", "rank": 0, "seq": 0, "alert": "distlr_alert_x",
                   "dumped_ts": T0 + 0.5, "spans": [{"name": "a"}], "events": []}, f)
    _write_jsonl(os.path.join(run, "profiles", "ps-0.jsonl"), [
        {"type": "profwindow", "role": "ps", "rank": 0, "kind": "burst", "incident": 0,
         "t0": T0 + 0.2, "t1": T0 + 3.2, "hz": 97.0, "unit": "samples", "samples": 12,
         "reason": "distlr_alert_x", "stacks": {"train.step;a.b": 12}}])
    _write_jsonl(os.path.join(run, "autopilot", "decisions.jsonl"), [
        {"schema": 1, "kind": "autopilot_decisions"},
        {"tick": 1, "t": 5.0, "ts": T0 - 10.0, "rule": "ps_up",
         "action": {"actuator": "ps", "direction": "up", "from": 2, "to": 3},
         "outcome": "resize accepted (epoch 2)", "inputs": {}, "holding": {}}])
    _write_jsonl(os.path.join(run, "rollout", "ramp.jsonl"), [
        {"t": T0 - 20.0, "event": "stage", "stage": 1, "weight": 0.25}])


def _bundle(run: str) -> dict:
    """The bundle of seq 0 with the run dir's path made relative."""
    out = {}
    for name in ("incident.json", "timeline.jsonl", "POSTMORTEM.md"):
        with open(os.path.join(incident.bundle_dir(run, 0), name)) as f:
            out[name] = f.read().replace(os.path.abspath(run), "RUN")
    return out


def test_incident_bundle_equals_jax(tmp_path):
    runs = {"ours": str(tmp_path / "ours"), "jax": str(tmp_path / "jax")}
    for mod, key in ((incident, "ours"), (jax_incident, "jax")):
        _incident_run(runs[key])
        out = mod.assemble(runs[key], seq=0, reason="distlr_alert_x", detected_ts=T0 + 1.0,
                           alerts=[{"name": "distlr_alert_x", "firing": True}], settle_s=6.0)
        assert out == mod.bundle_dir(runs[key], 0)
        assert mod.assemble(runs[key], seq=0, reason="again", detected_ts=T0) is None
    ours, theirs = _bundle(runs["ours"]), _bundle(runs["jax"])
    assert ours == theirs
    doc = incident.load(runs["ours"], 0)
    for kind in ("alert_edge", "chaos", "log", "flight_dump", "profiler_burst", "autopilot",
                 "rollout"):
        assert doc["events"].get(kind, 0) >= 1, (kind, doc["events"])
    assert doc["clock_shifts"] == {"ps-0": -2.0}
    logs = [e for e in doc["timeline"] if e["kind"] == "log"]
    assert [e["src"] for e in logs] == ["ps-0", "obs-agg-0"]  # shifted onto one clock
    for mod, key in ((incident, "ours"), (jax_incident, "jax")):
        for seq in (1, 2):
            mod.assemble(runs[key], seq=seq, reason=f"r{seq}", detected_ts=T0 + seq)
        os.remove(os.path.join(mod.bundle_dir(runs[key], 2), "POSTMORTEM.md"))
        assert mod.render(runs[key], 2).endswith("POSTMORTEM.md")
        assert mod.render(runs[key], 9) is None
        assert mod.latest_seq(runs[key]) == 2
        assert mod.prune(runs[key], keep=2) == 1
    assert [d["seq"] for d in incident.list_incidents(runs["ours"])] == [
        d["seq"] for d in jax_incident.list_incidents(runs["jax"])] == [1, 2]
    assert incident.WINDOW_S == jax_incident.WINDOW_S and incident.SETTLE_S == \
        jax_incident.SETTLE_S


def test_launch_incident_trigger_list_show_render(tmp_path):
    """``launch incident --trigger`` against a live configured process (this
    one): its flight dump and burst window land in the bundle; then the
    listing, ``show`` and ``render`` subcommands read it back."""
    run = str(tmp_path)
    dtrace.configure(run, "worker", 0, sample=1.0)
    profile.configure(run, "worker", 0, hz=50, window_s=30, burst_s=0.3)
    fleetlog.configure(run, "worker", 0, dedupe_s=0.0)
    fleetlog.emit("warning", "before the drill", logger="distlr_tpu_torch.test")
    fleetlog.flush()
    env = dict(os.environ, PYTHONPATH=REPO)

    def cli(*argv):
        return subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", "incident",
                               "--obs-run-dir", run, "--device", "cpu", *argv], cwd=REPO,
                              env=env, capture_output=True, text=True, timeout=120)

    proc = cli("--trigger", "drill", "--incident-settle", "2.0")
    profile.stop()
    assert proc.returncode == 0, proc.stderr
    path = proc.stdout.split("INCIDENT ", 1)[1].strip()
    assert path == incident.bundle_dir(run, 0)
    doc = incident.load(run, 0)
    assert (doc["trigger"], doc["reason"]) == ("manual", "drill")
    assert doc["events"].get("flight_dump", 0) == 1
    assert doc["events"].get("profiler_burst", 0) == 1
    assert doc["events"].get("log", 0) >= 1
    listing = cli()
    assert listing.returncode == 0 and "drill" in listing.stdout
    show = cli("show", "--seq", "0")
    assert json.loads(show.stdout)["reason"] == "drill"
    os.remove(os.path.join(path, "POSTMORTEM.md"))
    assert cli("render").stdout.strip() == f"INCIDENT {os.path.join(path, 'POSTMORTEM.md')}"
    empty = str(tmp_path / "empty")
    none = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", "incident",
                           "--obs-run-dir", empty, "--device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert none.returncode == 1
    shutil.rmtree(run, ignore_errors=True)
