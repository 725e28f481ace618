"""The port's PS fault recovery against the JAX package's, on the CPU: the
retry policy and its op classes, in-place reconnects after a server
respawn, checkpoints and resume (against a surviving group and a fresh
one), async worker restarts, and the server supervisor.

The same seeded inputs go through both packages.  The port runs with
``device="cpu"`` under ``ps_compute_backend`` ``"numpy"`` (rtol 1e-6) and
``"cpu"`` (torch on the CPU, rtol 1e-5); sidecars and JSON are held equal
byte for byte; supervisor scripts compare their event kinds, not times.
"""

import contextlib
import dataclasses
import json
import os
import random
import shutil
import threading
import time

import numpy as np
import pytest

from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.ps import KVWorker as JaxKVWorker
from distlr_tpu.ps import RetryPolicy as JaxRetryPolicy
from distlr_tpu.ps import ServerGroup as JaxServerGroup
from distlr_tpu.ps import ServerSupervisor as JaxServerSupervisor
from distlr_tpu.ps.client import FaultRateTracker as JaxFaultRateTracker
from distlr_tpu.train import ps_trainer as jax_ps_trainer
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.data.synthetic import write_synthetic_shards
from distlr_tpu_torch.ps import (
    FaultRateTracker,
    KVWorker,
    RetryPolicy,
    ServerGroup,
    ServerSupervisor,
)
from distlr_tpu_torch.train import ps_trainer

#: (port, JAX) of each piece a script drives
PACKAGES = {
    "ours": dict(Group=ServerGroup, KV=KVWorker, Sup=ServerSupervisor, Config=Config,
                 trainer=ps_trainer, cfg_kw={"device": "cpu"}),
    "jax": dict(Group=JaxServerGroup, KV=JaxKVWorker, Sup=JaxServerSupervisor,
                Config=JaxConfig, trainer=jax_ps_trainer, cfg_kw={}),
}
#: the backends of the port's dense step and their tolerances
BACKENDS = [("numpy", 1e-6), ("cpu", 1e-5)]


@pytest.fixture(scope="module")
def jax_checkpoints_warm(tmp_path_factory):
    """One orbax save before the JAX package's timed runs: its first save
    in a process sets orbax up, which can outlast a peer's receive timeout
    in the BSP round that waits on it."""
    from distlr_tpu.train.checkpoint import Checkpointer as JaxCheckpointer

    with JaxCheckpointer(str(tmp_path_factory.mktemp("warm"))) as ckpt:
        ckpt.save(1, np.zeros(16, np.float32), extra={"epoch": 1})


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("recovery") / "data"
    write_synthetic_shards(str(d), 600, 16, num_parts=2, seed=9, sparsity=0.0)
    return str(d)


def _wait_event(sup, rank, event, deadline_s=10.0) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if any(r == rank and ev == event for _, r, ev in sup.events):
            return True
        time.sleep(0.02)
    return False


class TestRetryPolicy:
    @pytest.mark.parametrize("kw", [
        {"attempts": 0}, {"backoff_ms": -1.0}, {"backoff_ms": 100.0, "backoff_max_ms": 50.0},
        {"jitter": 1.0}, {"jitter": -0.1}, {"deadline_s": 0.0},
        {"adaptive_window_s": 0.0}, {"adaptive_max_scale": 0.5},
    ])
    def test_validation_texts_match_jax(self, kw):
        with pytest.raises(ValueError) as ours:
            RetryPolicy(**kw)
        with pytest.raises(ValueError) as theirs:
            JaxRetryPolicy(**kw)
        assert str(ours.value) == str(theirs.value)

    @pytest.mark.parametrize("kw", [{}, {"jitter": 0.0}, {"backoff_ms": 5.0,
                                                          "backoff_max_ms": 300.0}])
    @pytest.mark.parametrize("scale", [1.0, 2.5, 8.0])
    def test_backoff_sequences_match_jax(self, kw, scale):
        seqs = []
        for cls in (RetryPolicy, JaxRetryPolicy):
            pol, rng = cls(**kw), random.Random(7)
            seqs.append([pol.backoff_s(i, rng, scale) for i in range(10)])
        assert seqs[0] == seqs[1]
        assert max(seqs[0]) <= 1.2 * RetryPolicy(**kw).backoff_max_ms / 1000.0

    @pytest.mark.parametrize("kw", [
        {}, {"ps_retry_attempts": 3},
        {"ps_retry_attempts": 5, "ps_retry_backoff_ms": 10.0, "ps_retry_backoff_max_ms": 40.0,
         "ps_retry_deadline_s": 3.0, "ps_retry_adaptive": True},
    ])
    def test_from_config_matches_jax(self, kw):
        ours = RetryPolicy.from_config(Config(device="cpu", **kw))
        theirs = JaxRetryPolicy.from_config(JaxConfig(**kw))
        if theirs is None:
            assert ours is None
        else:
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)

    def test_policy_is_async_only_like_jax(self):
        for sync in (True, False):
            ours = ps_trainer.ps_retry_policy(Config(device="cpu", sync_mode=sync,
                                                     ps_retry_attempts=3))
            theirs = jax_ps_trainer.ps_retry_policy(JaxConfig(sync_mode=sync,
                                                              ps_retry_attempts=3))
            assert (ours is None) == (theirs is None) == sync

    def test_fault_rate_tracker_matches_jax(self):
        trackers = [FaultRateTracker(window_s=2.0, max_scale=3.0),
                    JaxFaultRateTracker(window_s=2.0, max_scale=3.0)]
        script = [("r", 0.0), ("s", 0.1), ("r", 0.5), ("r", 0.6), ("r", 0.7), ("s", 0.8),
                  ("r", 1.0), ("s", 1.1), ("s", 2.55), ("s", 2.75), ("s", 5.0)]
        out = [[], []]
        for kind, now in script:
            for i, t in enumerate(trackers):
                if kind == "r":
                    t.record(now)
                else:
                    out[i].append(t.scale(now))
        assert out[0] == out[1] == [1.5, 3.0, 3.0, 2.5, 1.5, 1.0]
        for kw in ({"window_s": 0}, {"max_scale": 0.5}):
            with pytest.raises(ValueError) as a:
                FaultRateTracker(**kw)
            with pytest.raises(ValueError) as b:
                JaxFaultRateTracker(**kw)
            assert str(a.value) == str(b.value)


class TestOpClasses:
    def test_every_op_rides_the_class_jax_gives_it(self, monkeypatch):
        """Against one port group (the wire is byte-identical), each public
        op of both clients goes through the retry loop as the same
        ``(op, idempotent)``: pushes carry gradients, the rest re-issue."""
        seen = {"ours": [], "jax": []}
        for cls, who in ((KVWorker, "ours"), (JaxKVWorker, "jax")):
            real = cls._run_with_retry

            def record(self, op, fn, *, idempotent, on_failure=None, _real=real, _who=who):
                seen[_who].append((op, idempotent))
                return _real(self, op, fn, idempotent=idempotent, on_failure=on_failure)

            monkeypatch.setattr(cls, "_run_with_retry", record)
        with ServerGroup(1, 1, 8, sync=False, optimizer="ftrl") as sg:
            for cls in (KVWorker, JaxKVWorker):
                with cls(sg.hosts, 8, timeout_ms=5000, sync_group=False,
                         retry=RetryPolicy(attempts=2) if cls is KVWorker
                         else JaxRetryPolicy(attempts=2)) as kv:
                    kv.push_init(np.zeros(8, np.float32), force=True)
                    kv.push(np.ones(8, np.float32))
                    kv.push_pull(np.ones(8, np.float32))
                    kv.pull()
                    kv.pull_chunked(chunk_rows=4)
                    kv.pull_rows_into(np.zeros(8, np.float32), np.array([1, 5], np.uint64))
                    kv.barrier(7)
                    kv.stats(0)
                    z, n = kv.pull_opt_state()
                    kv.push_init_opt_state(z, n, force=True)
        assert seen["ours"] == seen["jax"]
        assert ("push", False) in seen["ours"] and ("push_pull", False) in seen["ours"]
        assert {op for op, idem in seen["ours"] if idem} == {
            "push_init", "pull", "barrier", "stats", "pull_opt_state", "push_init_opt_state"}


class TestInPlaceReconnect:
    def test_pull_after_respawn_retries_once_without_policy_fails_fast(self):
        """A SIGKILLed rank respawned on its port: the next pull with a
        policy reconnects and succeeds (one retry); without one it fails
        on the poisoned stream."""
        init = np.arange(8, dtype=np.float32)
        with ServerGroup(2, 1, 8, sync=False) as sg:
            with KVWorker(sg.hosts, 8, timeout_ms=5000, sync_group=False,
                          retry=RetryPolicy(attempts=4, backoff_ms=10.0)) as kv, \
                    KVWorker(sg.hosts, 8, timeout_ms=5000, sync_group=False) as bare:
                kv.push_init(init)
                np.testing.assert_array_equal(bare.pull(), init)
                sg.procs[1].kill()
                sg.procs[1].wait()
                assert sg.respawn(1)
                with KVWorker(f"127.0.0.1:{sg.ports[1]}", 4) as kv1:
                    kv1.push_init(init[4:], force=True)
                np.testing.assert_array_equal(kv.pull(), init)
                assert kv.retries == {"pull": 1} and kv.reconnects == 1
                with pytest.raises(OSError):
                    bare.pull()

    def test_respawn_refuses_a_live_rank_and_a_stopped_group(self):
        sg = ServerGroup(1, 1, 4, sync=False).start()
        try:
            assert not sg.respawn(0)  # alive
            sg.procs[0].kill()
            sg.procs[0].wait()
        finally:
            sg.stop()
        assert sg._stopped


def _crash_after_checkpoint(monkeypatch, trainer_mod, epoch: int):
    """Rank 0 raises right after its epoch-``epoch`` checkpoint, once."""
    real = trainer_mod.PSWorker._checkpoint
    state = {"crashed": False}

    def crashing(self, ckpt, ep):
        real(self, ckpt, ep)
        if ep == epoch and not state["crashed"]:
            state["crashed"] = True
            raise RuntimeError("injected crash after checkpoint")

    monkeypatch.setattr(trainer_mod.PSWorker, "_checkpoint", crashing)
    return state


class TestResume:
    @pytest.mark.parametrize("backend,rtol", BACKENDS)
    def test_resume_against_surviving_group_matches_jax(self, data_dir, tmp_path, monkeypatch,
                                                          jax_checkpoints_warm, backend, rtol):
        """JAX's ``test_resume_against_surviving_group`` through both
        packages (600 x 16, 2 workers x 2 servers, checkpoint_interval 2,
        a crash after epoch 2): equal sidecars, equal resumed weights, and
        the port's resume equals its uninterrupted run.  Both start from
        the reference init (Q2), which both packages compute alike."""
        out = {}
        for who, pkg in PACKAGES.items():
            ck = str(tmp_path / who / "ck")
            cfg = pkg["Config"](
                data_dir=data_dir, num_feature_dim=16, num_workers=2, num_servers=2,
                num_iteration=4, learning_rate=0.5, l2_c=0.0, batch_size=-1,
                test_interval=0, sync_mode=True, checkpoint_dir=ck, checkpoint_interval=2,
                ps_timeout_ms=4000, ps_compute_backend=backend, compute_dtype="float32",
                reference_rng_init=True, **pkg["cfg_kw"])
            tr = pkg["trainer"]
            state = _crash_after_checkpoint(monkeypatch, tr, 2)
            sidecar = os.path.join(ck, "ps_latest.json")
            with pkg["Group"](2, 2, 16, learning_rate=0.5, sync=True) as group:
                with pytest.raises(Exception) as e:
                    tr.run_ps_workers(cfg, group.hosts, range(2), save=False)
                assert state["crashed"], (who, e.value)
                with open(sidecar, "rb") as f:
                    crashed = f.read()
                shutil.copytree(ck, str(tmp_path / who / "ck2"))
                resumed = tr.run_ps_workers(cfg, group.hosts, range(2), save=False,
                                            resume=True)
            with open(sidecar, "rb") as f:
                final = f.read()
            fresh = tr.run_ps_local(cfg.replace(checkpoint_dir=str(tmp_path / who / "ck2")),
                                    save=False, resume=True)
            out[who] = (crashed, final, resumed[0], fresh[0])
        assert out["ours"][0] == out["jax"][0] == b'{"epoch": 2, "attempt": 0}'
        assert out["ours"][1] == out["jax"][1] == b'{"epoch": 4, "attempt": 1}'
        np.testing.assert_allclose(out["ours"][2], out["jax"][2], rtol=rtol, atol=1e-6)
        np.testing.assert_allclose(out["ours"][2], out["ours"][3], rtol=rtol, atol=1e-6)
        monkeypatch.undo()
        whole = ps_trainer.run_ps_local(Config(
            data_dir=data_dir, num_feature_dim=16, num_workers=2, num_servers=2,
            num_iteration=4, learning_rate=0.5, l2_c=0.0, batch_size=-1, test_interval=0,
            sync_mode=True, ps_compute_backend=backend, compute_dtype="float32",
            reference_rng_init=True, device="cpu"))
        np.testing.assert_allclose(out["ours"][2], whole[0], rtol=rtol, atol=1e-6)

    def test_bump_resume_attempt_files_match_jax(self, tmp_path):
        """The sidecar ``bump_resume_attempt`` writes, step by step, is the
        JAX package's byte for byte: created at epoch 0 without one, the
        epoch kept and the attempt advanced with one."""
        files = []
        for who, pkg in PACKAGES.items():
            cfg = pkg["Config"](checkpoint_dir=str(tmp_path / who), num_feature_dim=4,
                                **pkg["cfg_kw"])
            sidecar = os.path.join(cfg.checkpoint_dir, "ps_latest.json")
            steps = []
            pkg["trainer"].bump_resume_attempt(cfg)
            steps.append(open(sidecar, "rb").read())
            with open(sidecar, "w") as f:
                json.dump({"epoch": 6}, f)  # a sidecar without an attempt
            pkg["trainer"].bump_resume_attempt(cfg)
            pkg["trainer"].bump_resume_attempt(cfg)
            steps.append(open(sidecar, "rb").read())
            pkg["trainer"].bump_resume_attempt(cfg.replace(checkpoint_dir=None))  # a no-op
            files.append(steps)
        assert files[0] == files[1]
        assert [json.loads(b) for b in files[0]] == [{"epoch": 0, "attempt": 1},
                                                     {"epoch": 6, "attempt": 2}]

    def test_resume_before_first_checkpoint_reinitializes(self, data_dir, tmp_path,
                                                          monkeypatch):
        """Workers crash before any checkpoint; the surviving group holds
        crash-time weights and released barrier 0.  The resume meets at a
        fresh generation and forces the epoch-0 init: it equals a run from
        scratch on a fresh group."""
        ck = str(tmp_path / "ck")
        cfg = Config(data_dir=data_dir, num_feature_dim=16, num_workers=2, num_servers=2,
                     num_iteration=3, learning_rate=0.5, l2_c=0.0, batch_size=-1,
                     test_interval=0, sync_mode=True, checkpoint_dir=ck,
                     checkpoint_interval=0, ps_timeout_ms=4000, ps_compute_backend="numpy",
                     device="cpu")
        real_grad = ps_trainer._np_dense_grad
        state = {"calls": 0, "crashed": False}

        def flaky_grad(*args, **kw):
            state["calls"] += 1
            if not state["crashed"] and state["calls"] == 3:
                state["crashed"] = True
                raise RuntimeError("injected crash before the first checkpoint")
            return real_grad(*args, **kw)

        monkeypatch.setattr(ps_trainer, "_np_dense_grad", flaky_grad)
        sidecar = os.path.join(ck, "ps_latest.json")
        with ServerGroup(2, 2, 16, learning_rate=0.5, sync=True) as group:
            with pytest.raises(Exception):
                ps_trainer.run_ps_workers(cfg, group.hosts, range(2), save=False)
            assert state["crashed"] and not os.path.exists(sidecar)
            monkeypatch.setattr(ps_trainer, "_np_dense_grad", real_grad)
            resumed = ps_trainer.run_ps_workers(cfg, group.hosts, range(2), save=False,
                                                resume=True)
        with open(sidecar) as f:
            assert json.load(f) == {"epoch": 3, "attempt": 1}
        ref = ps_trainer.run_ps_local(cfg.replace(checkpoint_dir=str(tmp_path / "ref")))
        np.testing.assert_allclose(resumed[0], ref[0], rtol=1e-6, atol=1e-7)

    def test_sidecar_without_its_step_raises_like_jax(self, data_dir, tmp_path):
        """A sidecar whose step is missing (a JAX orbax directory, say)
        raises JAX's FileNotFoundError text."""
        msgs = []
        for who, pkg in PACKAGES.items():
            ck = tmp_path / who
            ck.mkdir()
            (ck / "ps_latest.json").write_text('{"epoch": 3, "attempt": 0}')
            cfg = pkg["Config"](data_dir=data_dir, num_feature_dim=16, checkpoint_dir=str(ck),
                                **pkg["cfg_kw"])
            with pytest.raises(FileNotFoundError) as e:
                pkg["trainer"]._ps_resume_state(cfg, 0)
            msgs.append(str(e.value).replace(str(ck), "<ck>"))
        assert msgs[0] == msgs[1]


def _async_cfg(data_dir, **kw):
    common = dict(data_dir=data_dir, num_feature_dim=16, num_workers=2, num_servers=1,
                  num_iteration=6, learning_rate=0.2, l2_c=0.0, batch_size=100,
                  test_interval=0, sync_mode=False, ps_compute_backend="numpy",
                  device="cpu")
    common.update(kw)
    return Config(**common)


class TestRestarts:
    def test_failed_async_worker_restarts_and_run_completes(self, data_dir, monkeypatch):
        real_load = ps_trainer.PSWorker._load_train_iter
        failures = {"left": 1}

        def flaky_load(self):
            if self.rank == 1 and failures["left"] > 0:
                failures["left"] -= 1
                raise RuntimeError("injected worker crash")
            return real_load(self)

        monkeypatch.setattr(ps_trainer.PSWorker, "_load_train_iter", flaky_load)
        report = {}
        results = ps_trainer.run_ps_local(_async_cfg(data_dir), max_restarts=2, report=report)
        assert failures["left"] == 0
        assert all(r is not None and np.isfinite(r).all() for r in results)
        assert report[1]["restarts"] == 1 and report[0]["restarts"] == 0

    def test_async_failure_without_restarts_still_raises(self, data_dir, monkeypatch):
        monkeypatch.setattr(ps_trainer.PSWorker, "_load_train_iter",
                            lambda self: (_ for _ in ()).throw(RuntimeError("boom")))
        with pytest.raises(RuntimeError, match="boom"):
            ps_trainer.run_ps_local(_async_cfg(data_dir, num_iteration=2))

    def test_sync_mode_never_restarts_in_place(self, data_dir, monkeypatch):
        calls = {"n": 0}

        def always_fail(self):
            calls["n"] += 1
            raise RuntimeError("boom")

        monkeypatch.setattr(ps_trainer.PSWorker, "_load_train_iter", always_fail)
        with pytest.raises(RuntimeError):
            ps_trainer.run_ps_local(_async_cfg(data_dir, sync_mode=True, batch_size=-1),
                                    max_restarts=5)
        assert calls["n"] <= 2  # one attempt a rank

    @pytest.mark.parametrize("backend", ["numpy", "cpu"])
    def test_async_worker_crash_mid_training_recovers(self, data_dir, monkeypatch, backend):
        """A worker dies after the startup barrier, restarts, re-sends its
        idempotent init, re-votes the released barrier and rejoins; the
        weights stay finite and a close run's."""
        state = {"calls": 0, "crashed": False}

        def crash_once():
            state["calls"] += 1
            if not state["crashed"] and state["calls"] == 5:
                state["crashed"] = True
                raise RuntimeError("injected mid-training crash")

        if backend == "numpy":
            real = ps_trainer._np_dense_grad

            def flaky(*a, **kw):
                crash_once()
                return real(*a, **kw)
            monkeypatch.setattr(ps_trainer, "_np_dense_grad", flaky)
        else:
            from distlr_tpu_torch.models import linear

            real = linear.BinaryLR.grad

            def flaky(self, *a, **kw):
                crash_once()
                return real(self, *a, **kw)
            monkeypatch.setattr(linear.BinaryLR, "grad", flaky)
        cfg = _async_cfg(data_dir, num_servers=2, num_iteration=8, ps_compute_backend=backend,
                         compute_dtype="float32")
        results = ps_trainer.run_ps_local(cfg, max_restarts=2)
        assert state["crashed"]
        assert all(np.isfinite(r).all() for r in results)


def _script_events(pkg, script) -> list[tuple[int, str]]:
    """Run ``script(group, sup, KV)`` on one package's 2-server async group
    with a fast supervisor; the ``(rank, event)`` kinds it recorded."""
    with pkg["Group"](2, 1, 8, sync=False, learning_rate=1.0) as g:
        sup = pkg["Sup"](g, poll_interval=0.05, snapshot_interval=0.05)
        script(g, sup, pkg["KV"])
    return sorted((r, ev) for _, r, ev in sup.events)


def _kill_and_reseed(g, sup, KV):
    with KV(g.hosts, 8, timeout_ms=5000, sync_group=False) as kv:
        kv.wait(kv.push_init(np.arange(8, dtype=np.float32)))
    ports = list(g.ports)
    with sup:
        time.sleep(0.4)  # a capture after the init
        g.procs[1].kill()
        assert _wait_event(sup, 1, "respawned") and _wait_event(sup, 1, "reseeded")
    assert g.ports == ports and all(g.alive())
    with KV(g.hosts, 8, timeout_ms=5000, sync_group=False) as kv2:
        np.testing.assert_array_equal(kv2.pull(), np.arange(8))
        kv2.shutdown_servers()


def _double_kill(g, sup, KV):
    with KV(g.hosts, 8, timeout_ms=5000, sync_group=False) as kv:
        kv.wait(kv.push_init(np.arange(8, dtype=np.float32)))
    with sup:
        time.sleep(0.4)
        g.procs[0].kill()
        g.procs[1].kill()
        assert _wait_event(sup, 0, "reseeded") and _wait_event(sup, 1, "reseeded")
    with KV(g.hosts, 8, timeout_ms=5000, sync_group=False) as kv2:
        np.testing.assert_array_equal(kv2.pull(), np.arange(8))
        kv2.shutdown_servers()


def _voluntary_shutdown(g, sup, KV):
    with sup:
        with KV(g.hosts, 8, timeout_ms=5000, sync_group=False) as kv:
            kv.wait(kv.push_init(np.zeros(8, np.float32)))
            kv.shutdown_servers()
        for p in g.procs:
            p.wait(timeout=5)
        time.sleep(0.3)  # several polls after the retirement
    assert all(p.poll() == 0 for p in g.procs)


def _kill_before_init(g, sup, KV):
    with sup:
        time.sleep(0.2)
        g.procs[0].kill()
        assert _wait_event(sup, 0, "seeded-zeros")
    with KV(g.hosts, 8, timeout_ms=5000, sync_group=False) as kv:
        assert kv.stats(0)["initialized"] == 1
        kv.shutdown_servers()


def _gave_up(g, sup, KV):
    sup._max_respawns = 1
    with KV(g.hosts, 8, timeout_ms=5000, sync_group=False) as kv:
        kv.wait(kv.push_init(np.ones(8, np.float32)))
    with sup:
        time.sleep(0.3)
        g.procs[1].kill()
        assert _wait_event(sup, 1, "reseeded")
        g.procs[1].kill()
        assert _wait_event(sup, 1, "gave-up")
        time.sleep(0.2)


class TestServerSupervisor:
    def test_sync_group_refused_with_jax_text(self):
        msgs = []
        for pkg in PACKAGES.values():
            with pkg["Group"](1, 1, 4, sync=True) as g:
                with pytest.raises(ValueError, match="async") as e:
                    pkg["Sup"](g)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    @pytest.mark.parametrize("script,kinds", [
        (_kill_and_reseed, [(1, "reseeded"), (1, "respawned")]),
        (_double_kill, [(0, "reseeded"), (0, "respawned"), (1, "reseeded"),
                        (1, "respawned")]),
        (_voluntary_shutdown, []),
        (_kill_before_init, [(0, "respawned"), (0, "seeded-zeros")]),
        (_gave_up, [(1, "gave-up"), (1, "reseeded"), (1, "respawned")]),
    ], ids=["kill", "double_kill", "voluntary_shutdown", "before_init", "gave_up"])
    def test_event_kinds_match_jax(self, script, kinds):
        assert _script_events(PACKAGES["ours"], script) == \
            _script_events(PACKAGES["jax"], script) == kinds

    def test_snapshot_skips_untouched_ranges(self):
        """A rank whose push count has not moved is not re-pulled; a push
        to one range re-captures only that rank (servers' pull counters)."""
        with ServerGroup(2, 1, 8, sync=False, learning_rate=1.0) as g:
            sup = ServerSupervisor(g, poll_interval=0.05, snapshot_interval=0.05)
            with KVWorker(g.hosts, 8, timeout_ms=5000, sync_group=False) as kv:
                kv.wait(kv.push_init(np.zeros(8, np.float32)))
                with sup:
                    t0 = time.monotonic()
                    while not all(sup._snap_valid):
                        assert time.monotonic() - t0 < 10.0, "no snapshot"
                        time.sleep(0.02)
                    time.sleep(0.4)
                    idle = [kv.stats(r)["total_pulls"] for r in (0, 1)]
                    time.sleep(0.4)
                    assert [kv.stats(r)["total_pulls"] for r in (0, 1)] == idle
                    kv.wait(kv.push(np.ones(4, np.float32), np.arange(4, dtype=np.uint64)))
                    time.sleep(0.4)
                    after = [kv.stats(r)["total_pulls"] for r in (0, 1)]
                    assert after[0] > idle[0] and after[1] == idle[1]
                    kv.shutdown_servers()

    def test_snapshot_captures_healthy_ranks_while_one_is_down(self):
        with ServerGroup(2, 1, 8, sync=False, learning_rate=1.0) as g:
            sup = ServerSupervisor(g)  # not started: captures driven here
            with KVWorker(g.hosts, 8, timeout_ms=5000, sync_group=False) as kv:
                kv.wait(kv.push_init(np.arange(8, dtype=np.float32)))
            g.procs[1].kill()
            g.procs[1].wait(timeout=5)
            sup._try_snapshot()
            assert sup._snap_valid[0] and not sup._snap_valid[1]
            np.testing.assert_array_equal(sup._snapshot[:4], np.arange(4))
            with KVWorker(f"127.0.0.1:{g.ports[0]}", 4, timeout_ms=5000,
                          sync_group=False) as kv0:
                kv0.wait(kv0.push(np.ones(4, np.float32)))
            sup._try_snapshot()
            np.testing.assert_array_equal(sup._snapshot[:4], np.arange(4) - 1.0)

    def test_sigkill_recovery_loses_at_most_the_snapshot_window(self):
        """lr 1 and unit gradients on key 0 make w[0] = -(applied updates):
        only the updates pushed after the last capture may be lost."""
        n1, n2, n3 = 5, 3, 4
        g_unit = np.array([1, 0, 0, 0], np.float32)
        with ServerGroup(2, 1, 4, sync=False, learning_rate=1.0) as g:
            sup = ServerSupervisor(g, poll_interval=0.05, snapshot_interval=0.05)
            with sup:
                with KVWorker(g.hosts, 4, timeout_ms=5000, sync_group=False) as kv:
                    kv.wait(kv.push_init(np.zeros(4, np.float32)))
                    for _ in range(n1):
                        kv.wait(kv.push(g_unit))
                    t_a = time.monotonic()
                    while sup._snap_at[0] <= t_a:
                        assert time.monotonic() - t_a < 10.0, "no snapshot"
                        time.sleep(0.02)
                    for _ in range(n2):
                        kv.wait(kv.push(g_unit))
                    g.procs[0].kill()
                assert _wait_event(sup, 0, "respawned") and _wait_event(sup, 0, "reseeded")
                with KVWorker(g.hosts, 4, timeout_ms=5000, sync_group=False) as kv2:
                    for _ in range(n3):
                        kv2.wait(kv2.push(g_unit))
                    w0 = float(kv2.pull()[0])
                    kv2.shutdown_servers()
        assert n1 + n3 <= -w0 <= n1 + n2 + n3, (w0, sup.events)

    def test_ftrl_z_n_restored(self):
        """An FTRL rank's z and n come back with its weights: after the
        re-seed the rank's opt state equals the captured slice bit for bit,
        and the pushes that follow continue an uninterrupted group's
        trajectory."""
        d = 16
        rng = np.random.default_rng(22)
        grads = [rng.normal(size=d).astype(np.float32) for _ in range(10)]
        for gr in grads:
            gr[gr == 0] = 0.5
        ftrl = dict(sync=False, optimizer="ftrl", ftrl_alpha=0.5, ftrl_beta=1.0,
                    ftrl_l1=0.01, ftrl_l2=0.001)
        pol = RetryPolicy(attempts=40, backoff_ms=20.0, deadline_s=20.0)
        with ServerGroup(2, 1, d, **ftrl) as sg:
            sup = ServerSupervisor(sg, poll_interval=0.05, snapshot_interval=0.05)
            with KVWorker(sg.hosts, d, timeout_ms=5000, sync_group=False, retry=pol) as kv:
                kv.push_init(np.zeros(d, np.float32))
                for gr in grads[:5]:
                    kv.wait(kv.push(gr))
                with sup:
                    t0 = time.monotonic()
                    while not all(sup._snap_valid):
                        assert time.monotonic() - t0 < 10.0
                        time.sleep(0.02)
                    sg.procs[1].kill()
                    assert _wait_event(sup, 1, "reseeded")
                    with KVWorker(f"127.0.0.1:{sg.ports[1]}", d // 2, timeout_ms=5000) as k1:
                        z, n = k1.pull_opt_state()
                    assert z.tobytes() == sup._opt_z[d // 2:].tobytes()
                    assert n.tobytes() == sup._opt_n[d // 2:].tobytes()
                    kv.reconnect()
                    for gr in grads[5:]:
                        kv.wait(kv.push(gr))
                    got = kv.pull()
        with ServerGroup(2, 1, d, **ftrl) as ref_g:
            with KVWorker(ref_g.hosts, d, timeout_ms=5000, sync_group=False) as kv:
                kv.push_init(np.zeros(d, np.float32))
                for gr in grads:
                    kv.wait(kv.push(gr))
                want = kv.pull()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_async_training_survives_server_sigkill(self, data_dir):
        """A server SIGKILLed mid-run under the supervisor, with restarts
        and retries: the run completes with trained, finite weights."""
        killed = {}
        cfg = _async_cfg(data_dir, num_servers=2, num_iteration=30, ps_timeout_ms=20_000,
                         ps_retry_attempts=4, test_interval=30)
        evals = []

        def killer(group, stop):
            while not stop.is_set():
                with contextlib.suppress(Exception):
                    with KVWorker(f"127.0.0.1:{group.ports[1]}", 8, timeout_ms=1000) as p:
                        if p.stats(0)["total_pushes"] >= 10:
                            killed["at"] = time.monotonic()
                            group.procs[1].kill()
                            return
                time.sleep(0.02)

        group = ServerGroup(2, 2, 16, learning_rate=0.2, sync=False)
        stop = threading.Event()
        t = threading.Thread(target=killer, args=(group, stop))
        with group, ServerSupervisor(group, poll_interval=0.05, snapshot_interval=0.05) as sup:
            t.start()
            try:
                report = {}
                results = ps_trainer.run_ps_workers(
                    cfg, group.hosts, range(2), max_restarts=5, report=report,
                    eval_fn=lambda ep, acc: evals.append(acc))
            finally:
                stop.set()
                t.join()
        assert "at" in killed, "the kill never fired"
        assert any(ev == "respawned" for _, _, ev in sup.events), sup.events
        assert all(np.isfinite(r).all() for r in results.values())
        assert evals and evals[-1] >= 0.75, evals


class TestEndToEnd:
    def test_launch_ps_checkpoint_then_resume(self, data_dir, tmp_path):
        """``launch ps --checkpoint-dir --checkpoint-interval 1`` then the
        same with ``--resume`` and more epochs: the sidecar advances, as
        JAX's ``launch ps`` leaves it."""
        from distlr_tpu import launch as jax_launch
        from distlr_tpu_torch import launch

        sidecars = []
        for main, ck, extra in ((launch.main, tmp_path / "ours", ["--device", "cpu"]),
                                (jax_launch.main, tmp_path / "jax", [])):
            common = ["ps", "--data-dir", data_dir, "--num-feature-dim", "16",
                      "--num-workers", "2", "--num-servers", "2", "--test-interval", "0",
                      "--checkpoint-dir", str(ck), "--checkpoint-interval", "1",
                      "--ps-compute-backend", "numpy", *extra]
            assert main([*common, "--num-iteration", "2"]) == 0
            first = (ck / "ps_latest.json").read_bytes()
            assert main([*common, "--num-iteration", "4", "--resume"]) == 0
            sidecars.append((first, (ck / "ps_latest.json").read_bytes()))
        assert sidecars[0] == sidecars[1] == (b'{"epoch": 2, "attempt": 0}',
                                              b'{"epoch": 4, "attempt": 1}')

    def test_launch_ps_supervised_async(self, data_dir):
        from distlr_tpu_torch import launch

        assert launch.main(["ps", "--data-dir", data_dir, "--num-feature-dim", "16",
                            "--num-workers", "2", "--num-servers", "2", "--async",
                            "--supervise-servers", "--max-worker-restarts", "2",
                            "--ps-retry-attempts", "4", "--num-iteration", "3",
                            "--test-interval", "0", "--device", "cpu"]) == 0
