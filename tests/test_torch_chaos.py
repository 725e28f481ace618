"""The port's chaos fabric against the JAX package's, on the CPU.

* Plans: every case of the JAX package's plan validation (the network
  kinds and ``kill``) parses to an equal ``FaultPlan`` in both packages,
  or raises the same ``FaultPlanError`` text.
* Determinism: for delay, throttle, resets at an op and at a byte offset,
  a partition and a kill at an op, one scripted client op sequence through
  the port's fabric (in front of the port's servers) and through the JAX
  package's (in front of its own) gives the same ``events_doc`` JSON, byte
  for byte.
* The faults through a live client: delays delay, a throttle paces, a
  mid-frame cut is never applied, a partition heals under a retry policy
  and spares the other links, time-triggered kills fire once.
* Training behind a plan: ``run_ps_local`` with a delay-only plan, sync
  and async with a durable store, holds the JAX package's weights (rtol
  1e-6 on the numpy step, 1e-5 on torch's CPU step).
* The CLI: ``launch chaos --events-path`` writes the JAX package's event
  document for a scripted client; its errors and ``launch ps
  --chaos-plan``'s exit as JAX's.
"""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from distlr_tpu import launch as jax_launch
from distlr_tpu.chaos import ChaosFabric as JaxChaosFabric
from distlr_tpu.chaos import FaultPlanError as JaxFaultPlanError
from distlr_tpu.chaos import load_plan as jax_load_plan
from distlr_tpu.chaos import parse_plan as jax_parse_plan
from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.ps import KVWorker as JaxKVWorker
from distlr_tpu.ps import RetryPolicy as JaxRetryPolicy
from distlr_tpu.ps import ServerGroup as JaxServerGroup
from distlr_tpu.train import ps_trainer as jax_ps_trainer
from distlr_tpu_torch import launch
from distlr_tpu_torch.chaos import (
    EVENT_SCHEMA,
    ChaosFabric,
    FaultPlanError,
    load_events_doc,
    load_plan,
    parse_plan,
)
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.data.synthetic import write_synthetic_shards
from distlr_tpu_torch.ps import KVWorker, RetryPolicy, ServerGroup
from distlr_tpu_torch.train import ps_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {
    "ours": dict(Group=ServerGroup, KV=KVWorker, Fabric=ChaosFabric, Retry=RetryPolicy,
                 parse=parse_plan),
    "jax": dict(Group=JaxServerGroup, KV=JaxKVWorker, Fabric=JaxChaosFabric,
                Retry=JaxRetryPolicy, parse=jax_parse_plan),
}


def _wait(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# plan validation
# ---------------------------------------------------------------------------

def _d(**kw):
    return {"kind": "delay", "delay_ms": 5, **kw}


#: the JAX package's validation cases (tests/test_chaos.py::TestPlanValidation,
#: tests/test_ps_store.py::TestKillPlanValidation) and a few more
PLANS = {
    "unknown_kind": {"faults": [{"kind": "flood"}]},
    "negative_delay": {"faults": [_d(), {"kind": "delay", "delay_ms": -1}]},
    "unknown_key": {"faults": [_d(bytes_per_sec=10)]},
    "overlapping_windows": {"faults": [_d(window=[1.0, 3.0]),
                                       {"kind": "delay", "delay_ms": 9, "window": [2.0, 4.0]}]},
    "disjoint_windows_and_links": {"faults": [
        _d(window=[1.0, 2.0]), {"kind": "delay", "delay_ms": 9, "window": [2.0, 4.0]},
        {"kind": "partition", "links": [0], "window": [1.0, 2.0]},
        {"kind": "partition", "links": [1], "window": [1.5, 2.5]}]},
    "malformed_window": {"faults": [{"kind": "partition", "window": [3.0, 1.0]}]},
    "window_not_a_pair": {"faults": [{"kind": "partition", "window": [1.0]}]},
    "partition_needs_window": {"faults": [{"kind": "partition"}]},
    "reset_no_offset": {"faults": [{"kind": "reset"}]},
    "reset_both_offsets": {"faults": [{"kind": "reset", "after_ops": 1, "after_bytes": 1}]},
    "reset_zero_ops": {"faults": [{"kind": "reset", "after_ops": 0}]},
    "reset_window": {"faults": [{"kind": "reset", "after_ops": 3, "window": [0, 1]}]},
    "duplicate_links": {"faults": [{"kind": "delay", "delay_ms": 1, "links": [0, 0]}]},
    "negative_link": {"faults": [{"kind": "delay", "delay_ms": 1, "links": [-2]}]},
    "bool_link": {"faults": [{"kind": "delay", "delay_ms": 1, "links": [True]}]},
    "links_not_a_list": {"faults": [{"kind": "delay", "delay_ms": 1, "links": "0"}]},
    "unknown_top_level_key": {"fautls": []},
    "not_an_object": [],
    "faults_not_a_list": {"faults": {}},
    "fault_not_an_object": {"faults": [3]},
    "bad_seed": {"seed": "x", "faults": []},
    "jitter_above_delay": {"faults": [{"kind": "delay", "delay_ms": 2, "jitter_ms": 5}]},
    "throttle_rate_below_1": {"faults": [{"kind": "throttle", "bytes_per_sec": 0.5}]},
    "throttle_rate_not_a_number": {"faults": [{"kind": "throttle", "bytes_per_sec": "fast"}]},
    "every_kind": {"seed": 7, "comment": "c", "faults": [
        {"kind": "delay", "links": "*", "delay_ms": 30, "jitter_ms": 10},
        {"kind": "throttle", "links": [0], "bytes_per_sec": 65536, "window": [2.0, 5.0]},
        {"kind": "reset", "links": [0], "after_ops": 25},
        {"kind": "reset", "links": [1], "after_bytes": 4096},
        {"kind": "partition", "links": [1], "window": [6.0, 7.5]},
        {"kind": "kill", "links": [0], "target": "rank:0", "after_ops": 40},
        {"kind": "kill", "target": "group", "at_s": 3.0}]},
    "kill_after_ops": {"faults": [{"kind": "kill", "links": [0], "target": "rank:0",
                                   "after_ops": 4}]},
    "kill_at_s": {"faults": [{"kind": "kill", "target": "group", "at_s": 3.0}]},
    "kill_window": {"faults": [{"kind": "kill", "links": [0], "target": "rank:0",
                                "after_ops": 2, "window": [0.0, 1.0]}]},
    "kill_no_trigger": {"faults": [{"kind": "kill", "target": "group"}]},
    "kill_both_triggers": {"faults": [{"kind": "kill", "links": [0], "target": "group",
                                       "after_ops": 2, "at_s": 1.0}]},
    "kill_no_target": {"faults": [{"kind": "kill", "at_s": 1.0}]},
    **{f"kill_target_{bad or 'empty'}": {"faults": [{"kind": "kill", "target": bad,
                                                      "at_s": 1.0}]}
       for bad in ("rank:x", "host:0", "rank:", "everything")},
    "kill_after_ops_any_link": {"faults": [{"kind": "kill", "target": "rank:0",
                                            "after_ops": 2}]},
    "kill_after_ops_two_links": {"faults": [{"kind": "kill", "links": [0, 1],
                                             "target": "rank:0", "after_ops": 2}]},
    "kill_zero_ops": {"faults": [{"kind": "kill", "links": [0], "target": "rank:0",
                                  "after_ops": 0}]},
    "kill_at_s_with_links": {"faults": [{"kind": "kill", "links": [0], "target": "group",
                                         "at_s": 1.0}]},
    "kill_negative_at_s": {"faults": [{"kind": "kill", "target": "group", "at_s": -1.0}]},
}


class TestPlans:
    @pytest.mark.parametrize("name", PLANS)
    @pytest.mark.parametrize("seed", [None, 99])
    def test_parse_like_jax(self, name, seed):
        doc = PLANS[name]
        got = []
        for parse, err in ((parse_plan, FaultPlanError), (jax_parse_plan, JaxFaultPlanError)):
            try:
                got.append(("plan", dataclasses.asdict(parse(doc, seed=seed))))
            except err as e:
                got.append(("error", str(e)))
        assert got[0] == got[1]

    def test_load_plan_from_file_and_invalid_json(self, tmp_path):
        p = tmp_path / "plan.json"
        p.write_text(json.dumps({"seed": 7, "faults": [{"kind": "delay", "delay_ms": 1}]}))
        assert load_plan(str(p)).seed == 7 and load_plan(str(p), seed=99).seed == 99
        assert dataclasses.asdict(load_plan(str(p))) == dataclasses.asdict(jax_load_plan(str(p)))
        p.write_text("{nope")
        with pytest.raises(FaultPlanError) as ours:
            load_plan(str(p))
        with pytest.raises(JaxFaultPlanError) as theirs:
            jax_load_plan(str(p))
        assert str(ours.value) == str(theirs.value) and "not valid JSON" in str(ours.value)

    @pytest.mark.parametrize("doc,upstreams", [
        ({"faults": [{"kind": "delay", "delay_ms": 1, "links": [3]}]}, [("127.0.0.1", 1)]),
        ({"faults": [{"kind": "kill", "target": "rank:5", "at_s": 1.0}]}, [("127.0.0.1", 1)]),
        ({"faults": []}, "nohost"),
        ({"faults": []}, []),
    ])
    def test_fabric_refusals_equal_jax(self, doc, upstreams):
        errs = []
        for pkg in PACKAGES.values():
            with pytest.raises(ValueError) as e:
                pkg["Fabric"](upstreams, pkg["parse"](doc))
            errs.append(str(e.value))
        assert errs[0] == errs[1]

    def test_events_doc_schema_and_reader(self, tmp_path):
        p = tmp_path / "events.json"
        p.write_text(json.dumps({"schema": EVENT_SCHEMA, "seed": 0, "truncated": False,
                                 "events": []}))
        assert load_events_doc(str(p))["schema"] == 1
        p.write_text(json.dumps({"events": []}))
        with pytest.raises(ValueError, match="no schema header"):
            load_events_doc(str(p))
        p.write_text(json.dumps({"schema": 2}))
        with pytest.raises(ValueError, match="schema 2 != the pinned 1"):
            load_events_doc(str(p))


# ---------------------------------------------------------------------------
# determinism: one scripted op sequence, both fabrics, equal event logs
# ---------------------------------------------------------------------------

def _ops_pushes(pkg, hosts, dim):
    kv = pkg["KV"](hosts, dim, client_id=0, timeout_ms=2000, sync_group=False,
                   retry=pkg["Retry"](attempts=5, backoff_ms=10, seed=0))
    kv.push_init(np.zeros(dim, np.float32))
    for _ in range(12):
        kv.push(np.ones(dim, np.float32))
    kv.pull()
    kv.close()


def _ops_partition(pkg, hosts, dim):
    h0 = hosts.split(",")[0]
    with pkg["KV"](h0, dim // 2, client_id=7, timeout_ms=2000, sync_group=False) as kv0:
        kv0.push_init(np.zeros(dim // 2, np.float32))
        kv0.pull()
    with pytest.raises(OSError):
        kv = pkg["KV"](hosts, dim, timeout_ms=400, sync_group=False)
        try:
            kv.push_init(np.zeros(dim, np.float32))
        finally:
            kv.close()


#: name -> (plan, servers, dim, the scripted ops)
SCRIPTS = {
    "delay": ({"faults": [{"kind": "delay", "links": "*", "delay_ms": 2, "jitter_ms": 1}]},
              2, 16, _ops_pushes),
    "throttle": ({"faults": [{"kind": "throttle", "links": [1], "bytes_per_sec": 2_000_000}]},
                 2, 16, _ops_pushes),
    "reset_after_ops": ({"faults": [
        {"kind": "delay", "links": "*", "delay_ms": 2, "jitter_ms": 1},
        {"kind": "reset", "links": [0], "after_ops": 6}]}, 1, 8, _ops_pushes),
    "reset_after_bytes": ({"faults": [{"kind": "reset", "after_bytes": 600}]}, 1, 32,
                          _ops_pushes),
    "partition": ({"faults": [{"kind": "partition", "links": [1], "window": [0.0, 30.0]}]},
                  2, 8, _ops_partition),
}


def _scripted(pkg, name, seed=42):
    doc, servers, dim, ops = SCRIPTS[name]
    with pkg["Group"](servers, 1, dim, sync=False) as g:
        with pkg["Fabric"](g.direct_hosts, pkg["parse"](doc), seed=seed) as fab:
            ops(pkg, fab.hosts, dim)
            return fab.events_doc()


def _kill_after_ops(pkg, tmp):
    """A kill at op 4 on link 0 of a durable group: pushes until the
    client sees the cut."""
    plan = pkg["parse"]({"faults": [{"kind": "kill", "links": [0], "target": "rank:0",
                                     "after_ops": 4}]})
    with pkg["Group"](1, 1, 8, sync=False, via_chaos=plan, store_dir=tmp) as g:
        kv = pkg["KV"](g.hosts, 8, client_id=0, sync_group=False, timeout_ms=2000)
        kv.push_init(np.zeros(8, np.float32))
        with pytest.raises(OSError):
            for _ in range(10):
                kv.push(np.ones(8, np.float32))
        kv.close()
        return g.chaos.events_doc()


class TestDeterminism:
    @pytest.mark.parametrize("name", SCRIPTS)
    def test_event_doc_equals_jax_byte_for_byte(self, name):
        ours = _scripted(PACKAGES["ours"], name)
        theirs = _scripted(PACKAGES["jax"], name)
        assert ours["events"], "the plan injected nothing"
        assert json.dumps(ours) == json.dumps(theirs)

    def test_kill_after_ops_event_doc_equals_jax(self, tmp_path):
        ours = _kill_after_ops(PACKAGES["ours"], str(tmp_path / "a"))
        theirs = _kill_after_ops(PACKAGES["jax"], str(tmp_path / "b"))
        assert json.dumps(ours) == json.dumps(theirs)
        assert ours["events"] == [[0, "kill", {"fault": 0, "op": 4, "target": "rank:0"}]]

    def test_same_seed_same_log_and_other_seed_other_jitter(self):
        a = _scripted(PACKAGES["ours"], "reset_after_ops", seed=1)
        b = _scripted(PACKAGES["ours"], "reset_after_ops", seed=1)
        c = _scripted(PACKAGES["ours"], "reset_after_ops", seed=2)
        assert a == b
        assert [e for e in a["events"] if e[1] == "delay"] != \
               [e for e in c["events"] if e[1] == "delay"]
        assert [e for e in a["events"] if e[1] == "reset"] == [[0, "reset",
                                                                {"fault": 1, "op": 6}]]


# ---------------------------------------------------------------------------
# the faults through a live client
# ---------------------------------------------------------------------------

def _plan(*faults):
    return parse_plan({"faults": list(faults)})


class TestFaultKinds:
    def test_delay_delays_and_counts(self):
        with ServerGroup(1, 1, 4, sync=False) as g:
            with ChaosFabric(g.direct_hosts, _plan({"kind": "delay", "delay_ms": 60})) as fab:
                with KVWorker(fab.hosts, 4, timeout_ms=5000, sync_group=False) as kv:
                    kv.push_init(np.zeros(4, np.float32))
                    t0 = time.perf_counter()
                    kv.pull()
                    assert time.perf_counter() - t0 >= 0.055
                c = fab.counters
        assert c["faults"][("delay", 0)] == c["ops_forwarded"][0] == 2  # init, pull
        assert c["delay_ms"][0] == pytest.approx(60.0 * c["faults"][("delay", 0)])
        assert c["bytes"][(0, "c2s")] > 0 and c["bytes"][(0, "s2c")] > 0
        assert len(fab.timeline) == len(fab.events())

    def test_throttle_paces_bytes(self):
        # 8 KB/s over a pull's 4 KB request and 2 KB reply
        with ServerGroup(1, 1, 512, sync=False) as g:
            with KVWorker(g.direct_hosts, 512, timeout_ms=5000, sync_group=False) as kv:
                kv.push_init(np.arange(512, dtype=np.float32))
            with ChaosFabric(g.direct_hosts,
                             _plan({"kind": "throttle", "bytes_per_sec": 8192})) as fab:
                with KVWorker(fab.hosts, 512, timeout_ms=20_000, sync_group=False) as kv:
                    t0 = time.perf_counter()
                    w = kv.pull()
                    assert time.perf_counter() - t0 > 0.5
        np.testing.assert_array_equal(w, np.arange(512, dtype=np.float32))

    def test_reset_after_bytes_drops_the_frame_unapplied(self):
        with ServerGroup(1, 1, 64, sync=False) as g:
            with ChaosFabric(g.direct_hosts, _plan({"kind": "reset", "after_bytes": 3000})) as fab:
                kv = KVWorker(fab.hosts, 64, timeout_ms=2000, sync_group=False,
                              retry=RetryPolicy(attempts=4, backoff_ms=10))
                kv.push_init(np.zeros(64, np.float32))
                for _ in range(6):
                    kv.push(np.ones(64, np.float32))
                w = kv.pull()
                kv.close()
            with KVWorker(g.direct_hosts, 64, timeout_ms=2000, sync_group=False) as probe:
                applied = probe.stats(0)["total_pushes"] - 1
        assert applied <= 6
        np.testing.assert_allclose(w, -0.2 * applied * np.ones(64), rtol=1e-5)
        assert any(e[1] == "reset" for e in fab.events())

    def test_reset_after_ops_is_absorbed_once(self):
        with ServerGroup(1, 1, 8, sync=False) as g:
            with ChaosFabric(g.direct_hosts,
                             _plan({"kind": "reset", "links": [0], "after_ops": 4})) as fab:
                kv = KVWorker(fab.hosts, 8, timeout_ms=2000, sync_group=False,
                              retry=RetryPolicy(attempts=4, backoff_ms=10))
                kv.push_init(np.zeros(8, np.float32))
                for _ in range(5):
                    kv.push(np.ones(8, np.float32))
                kv.close()
        # op 4 (a push) was delivered and its reply cut: absorbed, not re-sent
        assert kv.push_outcome_unknown == 1 and kv.reconnects >= 1

    def test_partition_blocks_then_heals_under_retries(self):
        with ServerGroup(1, 1, 4, sync=False) as g:
            with KVWorker(g.direct_hosts, 4, timeout_ms=1000, sync_group=False) as direct:
                direct.push_init(np.full(4, 3.0, np.float32))
            with ChaosFabric(g.direct_hosts, _plan({"kind": "partition", "links": [0],
                                                    "window": [0.0, 1.2]})) as fab:
                kv = KVWorker(fab.hosts, 4, timeout_ms=500, sync_group=False,
                              retry=RetryPolicy(attempts=8, backoff_ms=100, backoff_max_ms=400,
                                                deadline_s=20))
                t0 = time.perf_counter()
                w = kv.pull()
                took = time.perf_counter() - t0
                kv.close()
        np.testing.assert_array_equal(w, np.full(4, 3.0, np.float32))
        assert took >= 0.4 and any(e[1] == "partition" for e in fab.events())

    def test_at_s_kill_fires_once_and_records_the_plan_offset(self):
        calls = []
        plan = _plan({"kind": "kill", "target": "group", "at_s": 0.05})
        with ChaosFabric([("127.0.0.1", 1)], plan, killer=calls.append) as fab:
            _wait(lambda: calls, timeout=5.0, what="the killer")
            time.sleep(0.3)  # a second firing would land here
            assert calls == ["group"]
            (kill,) = [e for e in fab.events() if e[1] == "kill"]
        assert dict(kill[2:]) == {"at_s": 0.05, "fault": 0, "target": "group"}
        assert fab.counters["faults"][("kill", -1)] == 1

    def test_a_failing_killer_does_not_stop_the_fabric(self):
        def boom(target):
            raise RuntimeError("executor failed")

        plan = _plan({"kind": "kill", "target": "group", "at_s": 0.05})
        with ChaosFabric([("127.0.0.1", 1)], plan, killer=boom) as fab:
            _wait(lambda: [e for e in fab.events() if e[1] == "kill"], timeout=5.0,
                  what="the kill event")

    def test_group_kill_fault_sigkills_every_rank(self):
        plan = _plan({"kind": "kill", "target": "group", "at_s": 0.1})
        with ServerGroup(2, 1, 8, sync=False, via_chaos=plan) as g:
            assert g.hosts != g.direct_hosts and g.hosts == g.chaos.hosts
            _wait(lambda: all(p.poll() is not None for p in g.procs), what="both ranks dead")
            assert [p.returncode for p in g.procs] == [-signal.SIGKILL] * 2
        assert g.chaos is None


# ---------------------------------------------------------------------------
# training behind a plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("chaos") / "data"
    write_synthetic_shards(str(d), 400, 16, num_parts=2, seed=5, sparsity=0.0)
    return str(d)


@pytest.fixture(scope="module")
def delay_plan(tmp_path_factory):
    p = tmp_path_factory.mktemp("plan") / "delay.json"
    p.write_text(json.dumps({"seed": 3, "faults": [
        {"kind": "delay", "links": "*", "delay_ms": 1, "jitter_ms": 0.5}]}))
    return str(p)


#: (mode, Config fields): sync BSP with 2 workers; async with a durable
#: store, one worker (Hogwild with one writer is deterministic)
RUNS = {
    "sync": {"num_workers": 2, "sync_mode": True},
    "async_store": {"num_workers": 1, "sync_mode": False, "ps_store_wal": True},
}


def _train(mode, backend, cfg_cls, trainer, data_dir, plan, store_dir, **extra):
    kw = dict(data_dir=data_dir, num_feature_dim=16, num_servers=2, num_iteration=3,
              batch_size=100, test_interval=3, learning_rate=0.3, l2_c=0.01,
              compute_dtype="float32", reference_rng_init=True, ps_compute_backend=backend,
              chaos_plan=plan, **RUNS[mode], **extra)
    if RUNS[mode].get("ps_store_wal"):
        kw["ps_store_dir"] = store_dir
    report = {}
    call_kw = {"report": report} if trainer is ps_trainer else {}
    weights = trainer.run_ps_local(cfg_cls(**kw), **call_kw)
    return weights, report


@pytest.mark.parametrize("mode", RUNS)
@pytest.mark.parametrize("backend,rtol", [("numpy", 1e-6), ("cpu", 1e-5)])
def test_training_behind_a_plan_holds_jax(mode, backend, rtol, data_dir, delay_plan, tmp_path):
    theirs, _ = _train(mode, backend, JaxConfig, jax_ps_trainer, data_dir, delay_plan,
                       str(tmp_path / "jax"))
    ours, report = _train(mode, backend, Config, ps_trainer, data_dir, delay_plan,
                          str(tmp_path / "ours"), device="cpu")
    for w, jw in zip(ours, theirs):
        np.testing.assert_allclose(w, np.asarray(jw), rtol=rtol, atol=1e-7)
    assert report["chaos_events"]["delay"] > 0 and set(report["chaos_events"]) == {"delay"}
    if RUNS[mode].get("ps_store_wal"):
        assert os.path.isdir(tmp_path / "ours" / "rank-1")


def test_malformed_plan_fails_before_any_server_spawns(data_dir, tmp_path, monkeypatch):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"faults": [{"kind": "flood"}]}))
    monkeypatch.setattr(ServerGroup, "start", lambda self: pytest.fail("a server spawned"))
    with pytest.raises(FaultPlanError, match="unknown fault kind"):
        ps_trainer.run_ps_local(Config(device="cpu", data_dir=data_dir, num_feature_dim=16,
                                       sync_mode=False, chaos_plan=str(bad)))


def test_chaos_seed_defaults_to_the_plan_seed(tmp_path):
    p = tmp_path / "plan.json"
    p.write_text(json.dumps({"seed": 7, "faults": []}))
    for cfg_cls, load, kw in ((Config, load_plan, {"device": "cpu"}),
                              (JaxConfig, jax_load_plan, {})):
        cfg = cfg_cls(chaos_plan=str(p), **kw)
        assert load(cfg.chaos_plan, seed=cfg.chaos_seed).seed == 7
        cfg = cfg_cls(chaos_plan=str(p), chaos_seed=9, **kw)
        assert load(cfg.chaos_plan, seed=cfg.chaos_seed).seed == 9


@pytest.mark.parametrize("kw", [
    {"chaos_seed": -1}, {"chaos_seed": 1 << 64}, {"ps_store_interval_s": 0.0},
    {"ps_store_wal_fsync_s": -0.1}, {"ps_store_wal": True, "sync_mode": False},
    {"ps_store_wal": True, "ps_store_dir": "s"},
])
def test_config_refusals_equal_jax(kw):
    with pytest.raises(ValueError) as ours:
        Config(device="cpu", **kw)
    with pytest.raises(ValueError) as theirs:
        JaxConfig(**kw)
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

class TestCLI:
    def test_launch_chaos_writes_jax_event_doc(self, tmp_path):
        """``launch chaos`` in front of the port's group, a scripted client
        through its HOSTS, SIGTERM (exit 143): the event file equals the
        JAX package's fabric's document for the same client ops."""
        doc, servers, dim, ops = SCRIPTS["reset_after_ops"]
        plan_path, events = tmp_path / "plan.json", tmp_path / "events.json"
        plan_path.write_text(json.dumps(doc))
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        with ServerGroup(servers, 1, dim, sync=False) as g:
            proc = subprocess.Popen(
                [sys.executable, "-m", "distlr_tpu_torch.launch", "chaos", "--upstreams",
                 g.direct_hosts, "--plan", str(plan_path), "--seed", "42", "--events-path",
                 str(events)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
            try:
                line = proc.stdout.readline().split()
                assert line[0] == "HOSTS", line
                ops(PACKAGES["ours"], line[1], dim)
            finally:
                proc.send_signal(signal.SIGTERM)
                assert proc.wait(timeout=30) == 143
        ours = load_events_doc(str(events))
        theirs = _scripted(PACKAGES["jax"], "reset_after_ops", seed=42)
        assert ours == json.loads(json.dumps(theirs))

    @pytest.mark.parametrize("argv", [
        ["--plan", "MISSING"],
        ["--plan", "BAD"],
        ["--plan", "GOOD", "--upstreams", "nohost"],
        ["--plan", "GOOD", "--pids", "1,x"],
    ])
    def test_launch_chaos_errors_exit_2_like_jax(self, argv, tmp_path, capsys):
        (tmp_path / "bad.json").write_text(json.dumps({"faults": [{"kind": "flood"}]}))
        (tmp_path / "good.json").write_text(json.dumps({"faults": []}))
        paths = {"MISSING": str(tmp_path / "none.json"), "BAD": str(tmp_path / "bad.json"),
                 "GOOD": str(tmp_path / "good.json")}
        argv = [paths.get(a, a) for a in argv]
        if "--upstreams" not in argv:
            argv = ["--upstreams", "127.0.0.1:1", *argv]
        errs = []
        for main, extra in ((launch.main, ["--device", "cpu"]), (jax_launch.main, [])):
            assert main(["chaos", *argv, *extra]) == 2
            errs.append(capsys.readouterr().err.strip().splitlines()[-1])
        assert errs[0] == errs[1]

    def test_ps_chaos_plan_requires_local_mode_like_jax(self, tmp_path, capsys):
        errs = []
        for main, extra in ((launch.main, ["--device", "cpu"]), (jax_launch.main, [])):
            assert main(["ps", "--data-dir", str(tmp_path), "--num-feature-dim", "8", "--hosts",
                         "127.0.0.1:1", "--chaos-plan", "p.json", *extra]) == 2
            errs.append(capsys.readouterr().err.strip())
        assert errs[0] == errs[1] and "launch chaos" in errs[0]

    def test_launch_ps_trains_behind_a_plan(self, data_dir, delay_plan, tmp_path):
        d = str(tmp_path / "d")
        shutil.copytree(data_dir, d)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        proc = subprocess.run(
            [sys.executable, "-m", "distlr_tpu_torch.launch", "ps", "--data-dir", d,
             "--num-feature-dim", "16", "--num-workers", "1", "--num-servers", "2", "--async",
             "--num-iteration", "2", "--test-interval", "1", "--chaos-plan", delay_plan,
             "--chaos-seed", "5", "--store-dir", str(tmp_path / "s"), "--store-wal",
             "--device", "cpu"], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert os.path.exists(os.path.join(d, "models", "part-001"))
        assert sorted(os.listdir(tmp_path / "s")) == ["rank-0", "rank-1"]
