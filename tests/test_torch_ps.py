"""The port's parameter-server path on the CPU: its native KV servers and
client (the dense cases of ``tests/test_ps.py``, on real server
processes), the PS worker loop in sync (BSP) and async (Hogwild) mode, and
its parity with the JAX package's ``run_ps_local`` and with the
independent reference oracle.

Tolerances: the host numpy step is the JAX package's arithmetic, rtol
1e-6; the torch CPU step against the JAX package's jitted CPU step, both
with float32 products, rtol 1e-5 (f32 sums in another order); the oracle
as ``tests/test_reference_parity.py`` holds the JAX package (one boundary
flip of accuracy, weights atol 3e-3).
"""

import os
import shutil
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.train.ps_trainer import run_ps_local as jax_run_ps_local
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.data.synthetic import write_synthetic_shards
from distlr_tpu_torch.ps import KVWorker, PSTimeoutError, ServerGroup
from distlr_tpu_torch.train import ps_trainer
from distlr_tpu_torch.train.ps_trainer import run_ps_local, run_ps_workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ps_data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("psdata")
    write_synthetic_shards(str(d), 1200, 16, num_parts=2, seed=4, sparsity=0.0)
    return str(d)


def _cfg(**kw):
    return Config(device="cpu", **kw)


def _rows(data_dir: str, rank: int) -> int:
    with open(os.path.join(data_dir, "train", f"part-00{rank + 1}")) as f:
        return sum(1 for line in f if line.strip())


class TestKVBasics:
    def test_init_pull_roundtrip(self):
        with ServerGroup(1, 1, dim=8) as sg, KVWorker(sg.hosts, 8) as kv:
            init = np.arange(8, dtype=np.float32)
            kv.wait(kv.push(init))
            np.testing.assert_array_equal(kv.pull(), init)

    def test_range_sharding_uneven(self):
        # dim=10 over 3 servers -> ranges [0,3) [3,6) [6,10)
        with ServerGroup(3, 1, dim=10) as sg, KVWorker(sg.hosts, 10) as kv:
            assert [sg.key_range(r) for r in range(3)] == [(0, 3), (3, 6), (6, 10)]
            init = np.linspace(0, 9, 10).astype(np.float32)
            kv.push(init)
            np.testing.assert_allclose(kv.pull(), init)
            keys = np.array([2, 3, 4, 7], dtype=np.uint64)  # crosses range boundaries
            np.testing.assert_allclose(kv.pull(keys), init[[2, 3, 4, 7]])
            assert [kv.stats(r)["dim"] for r in range(3)] == [3, 3, 4]

    def test_async_applies_immediately(self):
        with ServerGroup(1, 2, dim=4, sync=False, learning_rate=1.0) as sg, \
                KVWorker(sg.hosts, 4, sync_group=False) as kv:
            kv.push(np.zeros(4, np.float32))  # init
            kv.push(np.ones(4, np.float32))   # w -= 1*g
            np.testing.assert_allclose(kv.pull(), -np.ones(4))

    def test_sync_push_blocks_until_all_workers(self):
        """The deferred reply is the BSP barrier: one worker's push does
        not return until the other worker pushes too."""
        with ServerGroup(1, 2, dim=4, sync=True, learning_rate=0.5) as sg, \
                KVWorker(sg.hosts, 4, client_id=0) as kv0, \
                KVWorker(sg.hosts, 4, client_id=1) as kv1:
            kv0.push(np.zeros(4, np.float32))  # init (answered at once)
            t_done = []

            def push0():
                kv0.push(np.full(4, 2.0, np.float32))
                t_done.append(time.monotonic())

            th = threading.Thread(target=push0)
            th.start()
            time.sleep(0.3)
            assert not t_done, "sync push returned before all workers pushed"
            t_release = time.monotonic()
            kv1.push(np.full(4, 4.0, np.float32))
            th.join(timeout=5)
            assert not th.is_alive() and t_done and t_done[0] >= t_release - 0.05
            # the correct-mean update: w -= lr * (g0+g1)/2 = -0.5*3
            np.testing.assert_allclose(kv0.pull(), np.full(4, -1.5))

    def test_q1_last_gradient_mode(self):
        with ServerGroup(1, 2, dim=4, sync=True, learning_rate=1.0, last_gradient=True) as sg, \
                KVWorker(sg.hosts, 4, client_id=0) as kv0, \
                KVWorker(sg.hosts, 4, client_id=1) as kv1:
            kv0.push(np.zeros(4, np.float32))
            th = threading.Thread(target=lambda: kv1.push(np.full(4, 4.0, np.float32)))
            th.start()  # the highest rank's push arrives first: still its gradient wins
            time.sleep(0.2)
            kv0.push(np.full(4, 2.0, np.float32))
            th.join(timeout=5)
            # Q1: w -= lr * g_rank1 / W = -4/2 = -2 (NOT the mean -3)
            np.testing.assert_allclose(kv0.pull(), np.full(4, -2.0))

    def test_worker_group_barrier(self):
        with ServerGroup(1, 2, dim=2) as sg, KVWorker(sg.hosts, 2, client_id=0) as kv0, \
                KVWorker(sg.hosts, 2, client_id=1) as kv1:
            released = []

            def b0():
                kv0.barrier()
                released.append(0)

            th = threading.Thread(target=b0)
            th.start()
            time.sleep(0.2)
            assert not released
            kv1.barrier()
            th.join(timeout=5)
            assert released == [0]
            with pytest.raises(ValueError, match="uint16"):
                kv0.barrier(1 << 16)

    def test_connect_failure_raises(self):
        with pytest.raises(ConnectionError):
            KVWorker("127.0.0.1:1", 4)

    def test_invalid_keys_rejected(self):
        with ServerGroup(2, 1, dim=8) as sg, KVWorker(sg.hosts, 8) as kv:
            kv.push(np.zeros(8, np.float32))
            with pytest.raises(ValueError, match="ascending"):
                kv.pull(np.array([5, 2], dtype=np.uint64))
            with pytest.raises(ValueError, match="out of range"):
                kv.pull(np.array([3, 8], dtype=np.uint64))
            with pytest.raises(ValueError, match="vals vs"):
                kv.push(np.zeros(7, np.float32))

    def test_sync_straggler_times_out(self):
        with ServerGroup(1, 2, dim=4) as sg, KVWorker(sg.hosts, 4, timeout_ms=300) as kv:
            kv.push(np.zeros(4, np.float32))
            with pytest.raises(PSTimeoutError, match="timed out"):
                kv.push(np.ones(4, np.float32))  # the second worker never pushes

    def test_shutdown_with_multiple_workers_connected(self):
        """Shutdown terminates the server even while other workers hold
        open connections."""
        with ServerGroup(1, 2, dim=4) as sg:
            kv0 = KVWorker(sg.hosts, 4, client_id=0)
            kv1 = KVWorker(sg.hosts, 4, client_id=1)  # idle second connection
            kv0.push(np.zeros(4, np.float32))
            kv0.shutdown_servers()
            sg.procs[0].wait(timeout=5)
            assert sg.procs[0].returncode == 0 and sg.alive() == [False]
            kv0.close()
            kv1.close()

    def test_worker_failure_does_not_hang_peers(self, ps_data_dir, tmp_path):
        """A worker that dies (its shard is missing) fails the run instead
        of deadlocking the other worker at the sync barrier."""
        broken = tmp_path / "broken"
        shutil.copytree(ps_data_dir, broken)
        (broken / "train" / "part-002").unlink()
        cfg = _cfg(data_dir=str(broken), num_feature_dim=16, num_workers=2, num_servers=1,
                   num_iteration=5, sync_mode=True, test_interval=0)
        t0 = time.monotonic()
        with pytest.raises(FileNotFoundError):
            run_ps_local(cfg)
        assert time.monotonic() - t0 < 30


class TestPSTraining:
    def test_sync_ps_converges(self, ps_data_dir):
        cfg = _cfg(data_dir=ps_data_dir, num_feature_dim=16, num_workers=2, num_servers=2,
                   num_iteration=40, learning_rate=0.5, l2_c=0.0, batch_size=-1,
                   test_interval=20, sync_mode=True)
        evals = []
        results = run_ps_local(cfg, eval_fn=lambda ep, acc: evals.append((ep, acc)))
        assert all(r is not None for r in results)
        # sync: every worker ends with identical weights
        np.testing.assert_allclose(results[0], results[1], atol=1e-5)
        assert [e for e, _ in evals] == [20, 40]
        assert evals[-1][1] > 0.8, f"sync PS accuracy {evals}"

    def test_async_ps_converges(self, ps_data_dir):
        cfg = _cfg(data_dir=ps_data_dir, num_feature_dim=16, num_workers=2, num_servers=1,
                   num_iteration=40, learning_rate=0.2, l2_c=0.0, batch_size=100,
                   test_interval=40, sync_mode=False)
        evals = []
        report = {}
        results = run_ps_local(cfg, eval_fn=lambda ep, acc: evals.append((ep, acc)),
                               report=report)
        assert all(r is not None for r in results)
        assert evals[-1][1] > 0.8, f"async PS accuracy {evals}"
        # every gradient reached the servers: a push a batch of 100 rows,
        # plus rank 0's seeding push
        steps = [40 * -(-_rows(ps_data_dir, r) // 100) for r in (0, 1)]
        assert [report[r]["steps"] for r in (0, 1)] == steps
        assert report[0]["group_pushes"] == sum(steps) + 1

    def test_softmax_ps_converges(self, tmp_path):
        d = str(tmp_path / "mc")
        write_synthetic_shards(d, 1500, 12, num_parts=2, seed=7, num_classes=4, sparsity=0.0)
        cfg = _cfg(data_dir=d, num_feature_dim=12, model="softmax", num_classes=4,
                   num_workers=2, num_servers=2, num_iteration=60, learning_rate=0.5,
                   l2_c=0.0, batch_size=-1, test_interval=30, sync_mode=True)
        accs = []
        run_ps_local(cfg, eval_fn=lambda _e, a: accs.append(a))
        assert accs[-1] > 0.6, f"softmax PS accuracy {accs}"

    def test_workers_join_an_external_group(self, ps_data_dir):
        """Two ``run_ps_workers`` calls with disjoint ranks (the multi-host
        shape) train one model; rank 0's exit retires the servers."""
        cfg = _cfg(data_dir=ps_data_dir, num_feature_dim=16, num_workers=2, num_servers=2,
                   num_iteration=20, learning_rate=0.5, l2_c=0.0, batch_size=-1,
                   test_interval=0, sync_mode=True)
        with ServerGroup(2, 2, dim=16, learning_rate=0.5, sync=True) as group:
            out = {}
            hosts = [threading.Thread(target=lambda r=r: out.update(
                run_ps_workers(cfg, group.hosts, [r]))) for r in (0, 1)]
            for t in hosts:
                t.start()
            for t in hosts:
                t.join(timeout=60)
            assert set(out) == {0, 1}
            np.testing.assert_allclose(out[0], out[1], atol=1e-5)
            for p in group.procs:
                p.wait(timeout=5)
            assert not any(group.alive())

    def test_saves_each_workers_model(self, ps_data_dir, tmp_path):
        d = tmp_path / "d"
        shutil.copytree(ps_data_dir, d)
        cfg = _cfg(data_dir=str(d), num_feature_dim=16, num_workers=2, num_iteration=3,
                   test_interval=0)
        results = run_ps_local(cfg, save=True)
        from distlr_tpu_torch.train.export import load_model_text

        for r in (0, 1):
            np.testing.assert_allclose(load_model_text(str(d / "models" / f"part-00{r + 1}")),
                                       results[r], rtol=1e-5)


class TestFusedPushPull:
    def test_async_applies_and_returns_fresh_weights(self):
        with ServerGroup(2, 1, dim=8, sync=False, learning_rate=1.0) as g, \
                KVWorker(g.hosts, 8, timeout_ms=20_000, sync_group=False) as kv:
            kv.wait(kv.push_init(np.arange(8, dtype=np.float32)))
            w = kv.push_pull(np.ones(8, np.float32))
            np.testing.assert_allclose(w, np.arange(8) - 1.0)
            np.testing.assert_allclose(kv.pull(), w)
            kv.push_init(np.zeros(8, np.float32))  # a no-op once seeded
            np.testing.assert_allclose(kv.pull(), w)
            kv.push_init(np.zeros(8, np.float32), force=True)
            np.testing.assert_array_equal(kv.pull(), np.zeros(8))
            kv.shutdown_servers()

    def test_sync_defers_and_returns_post_round_weights(self):
        with ServerGroup(2, 2, dim=8, sync=True, learning_rate=0.5) as g, \
                KVWorker(g.hosts, 8, client_id=0, timeout_ms=20_000) as kv0, \
                KVWorker(g.hosts, 8, client_id=1, timeout_ms=20_000) as kv1:
            kv0.wait(kv0.push_init(np.zeros(8, np.float32)))
            out = {}
            t = threading.Thread(target=lambda: out.update(
                {1: kv1.push_pull(np.full(8, 3.0, np.float32))}))
            t.start()
            out[0] = kv0.push_pull(np.full(8, 1.0, np.float32))
            t.join(timeout=20)
            # one mean BSP update: -0.5 * (1+3)/2 = -1; both workers see it
            np.testing.assert_allclose(out[0], -np.ones(8), rtol=1e-6)
            np.testing.assert_array_equal(out[0], out[1])
            kv0.shutdown_servers()

    def test_fused_sync_trajectory_equals_serialized(self, ps_data_dir):
        """ps_pipeline does not change sync results: bitwise-equal weights."""
        common = dict(data_dir=ps_data_dir, num_feature_dim=16, num_iteration=6,
                      learning_rate=0.3, l2_c=0.0, batch_size=100, test_interval=0,
                      compat_mode="reference", sync_last_gradient=False,
                      num_workers=2, num_servers=2, sync_mode=True)
        w_fused = run_ps_local(_cfg(ps_pipeline=True, **common))[0]
        w_serial = run_ps_local(_cfg(ps_pipeline=False, **common))[0]
        np.testing.assert_array_equal(w_fused, w_serial)

    def test_pipelined_async_converges(self, ps_data_dir):
        """Double-buffered Hogwild (staleness <= 1 in-flight push)."""
        evals = []
        cfg = _cfg(data_dir=ps_data_dir, num_feature_dim=16, num_iteration=20,
                   learning_rate=0.1, l2_c=0.0, batch_size=100, test_interval=10,
                   sync_mode=False, num_workers=2, num_servers=2, ps_pipeline=True)
        run_ps_local(cfg, eval_fn=lambda ep, a: evals.append((ep, a)))
        assert evals and evals[-1][1] >= 0.80, evals

    def test_serialized_async_reports_its_ops(self, ps_data_dir):
        report = {}
        cfg = _cfg(data_dir=ps_data_dir, num_feature_dim=16, num_iteration=2,
                   batch_size=100, test_interval=0, sync_mode=False, num_workers=2,
                   ps_pipeline=False)
        run_ps_local(cfg, report=report)
        for r in (0, 1):
            batches = 2 * -(-_rows(ps_data_dir, r) // 100)
            assert report[r]["push_count"] == report[r]["grad_count"] == batches
            assert report[r]["pull_count"] == batches + 1  # a pull a batch, then the final one
            assert report[r]["grad_span_ms"] is None  # no card here
            assert report[r]["grad_span_first_ms"] is None


class TestPSComputeDevice:
    """PS workers run their steps on ``cfg.device`` unless the caller asks
    for the host: the JAX package's size rule for ``auto`` is not kept."""

    def test_forced_choices(self):
        cfg = _cfg(num_feature_dim=16)
        assert ps_trainer.ps_compute_device(cfg.replace(ps_compute_backend="numpy")) == "numpy"
        assert ps_trainer.ps_compute_device(
            cfg.replace(ps_compute_backend="cpu")) == torch.device("cpu")
        assert ps_trainer.ps_compute_device(
            Config(ps_compute_backend="default", num_feature_dim=16)) == torch.device("cuda")

    @pytest.mark.parametrize("dim,batch", [
        (123, 256), (20_000, 256), (1_000_000, 4096), (1_000_000, 1024), (1_000_000, -1),
        (1 << 10, 1 << 10), (1 << 10, (1 << 10) - 1), (1 << 10, 1 << 15), (1, 1),
    ])
    def test_auto_thresholds(self, dim, batch):
        # no size moves a step to the host: tiny, the JAX package's 2^20
        # and 2^25 boundaries, the slice's D = 1M x 1,024, a full shard
        cfg = Config(num_feature_dim=dim, batch_size=batch)
        assert ps_trainer.ps_compute_device(cfg) == torch.device("cuda")
        assert ps_trainer.ps_compute_device(cfg.replace(device="cuda:1")) == torch.device("cuda:1")
        # softmax's key space is D x K
        sm = Config(model="softmax", num_classes=10, num_feature_dim=dim, batch_size=batch)
        assert ps_trainer.ps_param_dim(sm) == 10 * dim
        assert ps_trainer.ps_compute_device(sm) == torch.device("cuda")

    def test_auto_on_cpu_takes_the_cpu(self):
        big = _cfg(num_feature_dim=1_000_000, batch_size=4096)
        assert ps_trainer.ps_compute_device(big) == torch.device("cpu")
        assert ps_trainer.ps_compute_device(_cfg(num_feature_dim=16)) == torch.device("cpu")

    def test_invalid_choice_rejected(self):
        with pytest.raises(ValueError, match="ps_compute_backend"):
            Config(ps_compute_backend="gpu")


class TestEntryRules:
    def test_raises_without_cuda_before_any_server(self, ps_data_dir, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(ServerGroup, "start", lambda self: pytest.fail("servers spawned"))
        cfg = Config(data_dir=ps_data_dir, num_feature_dim=16, num_workers=2)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            run_ps_local(cfg)

    @pytest.mark.parametrize("model,kw", [
        ("sparse_lr", {}), ("sparse_softmax", {"num_classes": 3}),
        ("blocked_lr", {"block_size": 4}),
    ])
    @pytest.mark.parametrize("sync", [True, False])
    def test_keyed_families_raise_without_cuda_before_any_server(
            self, ps_data_dir, monkeypatch, model, kw, sync):
        """The keyed families run on the card by default too: without CUDA
        they raise naming the way out, before any server starts, even when
        the steps were asked onto the host."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(ServerGroup, "start", lambda self: pytest.fail("servers spawned"))
        for backend in ("auto", "numpy"):
            cfg = Config(data_dir=ps_data_dir, num_feature_dim=16, model=model, num_workers=2,
                         sync_mode=sync, ps_compute_backend=backend, **kw)
            with pytest.raises(RuntimeError, match='device="cpu"'):
                run_ps_local(cfg)

    @pytest.mark.parametrize("kw,err,match", [
        ({"feature_dtype": "int8"}, ValueError, "feature_dtype"),
    ])
    def test_unported_runs_refused(self, ps_data_dir, kw, err, match):
        with pytest.raises(err, match=match):
            run_ps_local(_cfg(data_dir=ps_data_dir, num_feature_dim=16, **kw))

    def test_checkpoint_dir_runs_like_jax(self, ps_data_dir, tmp_path):
        """``checkpoint_dir`` is ported (A.16.1): rank 0 saves every
        ``checkpoint_interval`` epochs, and the sidecar is the JAX
        package's byte for byte; the port's steps are ``.npz``."""
        ours_cfg, jax_cfg = _parity_cfgs(ps_data_dir, ps_compute_backend="numpy",
                                         checkpoint_interval=5)
        ours = run_ps_local(ours_cfg.replace(checkpoint_dir=str(tmp_path / "ours")))
        ref = jax_run_ps_local(jax_cfg.replace(checkpoint_dir=str(tmp_path / "jax")))
        np.testing.assert_allclose(ours[0], ref[0], rtol=1e-6, atol=1e-7)
        sidecars = [(tmp_path / who / "ps_latest.json").read_bytes() for who in ("ours", "jax")]
        assert sidecars[0] == sidecars[1] == b'{"epoch": 12, "attempt": 0}'
        assert sorted(os.listdir(tmp_path / "ours")) == [
            "ckpt-10.npz", "ckpt-12.npz", "ckpt-5.npz", "ps_latest.json"]
        with np.load(tmp_path / "ours" / "ckpt-12.npz") as z:
            np.testing.assert_array_equal(z["weights"], ours[0])
            assert int(z["epoch"]) == 12


def _parity_cfgs(data_dir, **kw):
    common = dict(data_dir=data_dir, num_feature_dim=16, num_workers=2, num_servers=2,
                  num_iteration=12, learning_rate=0.3, l2_c=0.5, batch_size=-1,
                  test_interval=4, sync_mode=True, compat_mode="reference")
    common.update(kw)
    return Config(device="cpu", **common), JaxConfig(**common)


class TestParityWithJax:
    """``run_ps_local`` in sync mode, 2 workers x 2 servers, full batch,
    reference compat (Q1, Q2, Q4): the port's weights and eval lines
    against the JAX package's."""

    @pytest.mark.parametrize("model", ["binary_lr", "softmax"])
    def test_numpy_step(self, ps_data_dir, tmp_path, model):
        d = ps_data_dir
        kw = {"ps_compute_backend": "numpy"}
        if model == "softmax":
            d = str(tmp_path / "mc")
            write_synthetic_shards(d, 600, 16, num_parts=2, seed=2, num_classes=3,
                                   sparsity=0.0)
            kw.update(model="softmax", num_classes=3)
        ours_cfg, jax_cfg = _parity_cfgs(d, **kw)
        ours_ev, jax_ev = [], []
        ours = run_ps_local(ours_cfg, eval_fn=lambda e, a: ours_ev.append((e, a)))
        ref = jax_run_ps_local(jax_cfg, eval_fn=lambda e, a: jax_ev.append((e, a)))
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        assert [e for e, _ in ours_ev] == [e for e, _ in jax_ev] == [4, 8, 12]
        np.testing.assert_allclose([a for _, a in ours_ev], [a for _, a in jax_ev], atol=1e-6)

    def test_torch_cpu_step(self, ps_data_dir):
        ours_cfg, jax_cfg = _parity_cfgs(ps_data_dir, ps_compute_backend="cpu",
                                         compute_dtype="float32")
        ours = run_ps_local(ours_cfg)
        ref = jax_run_ps_local(jax_cfg)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    def test_async_single_worker_matches(self, ps_data_dir):
        """One async worker has no races: its Hogwild run is deterministic
        and equals the JAX package's."""
        ours_cfg, jax_cfg = _parity_cfgs(ps_data_dir, ps_compute_backend="numpy",
                                         batch_size=100)
        ours = run_ps_local(ours_cfg.replace(sync_mode=False, num_workers=1))
        ref = jax_run_ps_local(jax_cfg.replace(sync_mode=False, num_workers=1))
        np.testing.assert_allclose(ours[0], ref[0], rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def oracle_bin(tmp_path_factory):
    """``benchmarks/reference_oracle.cc`` compiled into a temporary dir
    (nothing is written under ``benchmarks/``)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("cannot build reference_oracle: no g++")
    out = tmp_path_factory.mktemp("oracle") / "reference_oracle"
    r = subprocess.run([cxx, "-std=c++17", "-O3", "-Wall", "-o", str(out),
                        os.path.join(REPO, "benchmarks", "reference_oracle.cc")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f"cannot build reference_oracle: {r.stderr[-400:]}")
    return str(out)


class TestReferenceOracle:
    def test_one_worker_matches_oracle(self, oracle_bin, tmp_path):
        """W=1 sync against the independent oracle (Q2 init, Q4 L2/B, Q5
        wrap), as ``tests/test_reference_parity.py`` holds the JAX package."""
        d = str(tmp_path / "data")
        write_synthetic_shards(d, 1000, 24, num_parts=2, seed=3, sparsity=0.0)
        out = subprocess.run([oracle_bin, f"--data_dir={d}", "--dim=24", "--workers=1",
                              "--iters=20", "--batch=128", "--test_interval=5", "--lr=0.1",
                              "--C=1", "--sync=1", "--seed=0"],
                             capture_output=True, text=True, check=True).stdout
        traj_o, w_o = {}, None
        for line in out.splitlines():
            tok = line.split()
            if tok and tok[0] == "TRAJ":
                traj_o[int(tok[1])] = float(tok[2])
            elif tok and tok[0] == "WEIGHTS":
                w_o = np.array([float(v) for v in tok[1:]], dtype=np.float32)
        assert traj_o and w_o is not None, out[:400]
        cfg = _cfg(data_dir=d, num_feature_dim=24, compat_mode="reference", learning_rate=0.1,
                   l2_c=1.0, num_iteration=20, test_interval=5, num_servers=2,
                   sync_mode=True, num_workers=1, batch_size=128)
        traj_f = {}
        w_f = run_ps_local(cfg, eval_fn=lambda e, a: traj_f.__setitem__(e, a))[0]
        assert traj_f.keys() == traj_o.keys()
        for e in traj_o:
            assert abs(traj_f[e] - traj_o[e]) <= 0.01, (e, traj_f[e], traj_o[e])
        np.testing.assert_allclose(w_f, w_o, atol=3e-3)


class TestSharedState:
    """Worker threads share the launch counters and the server group:
    more threads than cores, with a short switch interval, lose no update."""

    def test_launch_count_survives_threads(self):
        import sys

        from distlr_tpu_torch import ops
        from distlr_tpu_torch.ops import fused_lr

        X = torch.zeros(1, 1, dtype=torch.bfloat16)
        before = ops.fused_lr_grad.launches
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=lambda: [fused_lr._count(ops.fused_lr_grad, X)
                                                        for _ in range(2000)])
                       for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(interval)
        assert ops.fused_lr_grad.launches - before == 16 * 2000
        ops.fused_lr_grad.launches = before

    def test_many_sync_workers_agree(self, tmp_path):
        d = str(tmp_path / "many")
        write_synthetic_shards(d, 1300, 8, num_parts=12, seed=5, sparsity=0.0)
        report = {}
        cfg = _cfg(data_dir=d, num_feature_dim=8, num_workers=12, num_servers=3,
                   num_iteration=4, batch_size=40, test_interval=0, learning_rate=0.3)
        t0 = time.monotonic()
        results = run_ps_local(cfg, report=report)
        assert time.monotonic() - t0 < 60
        for w in results[1:]:
            np.testing.assert_array_equal(w, results[0])
        steps = [report[r]["steps"] for r in range(12)]
        assert len(set(steps)) == 1  # BSP: every worker took every round
        assert report[0]["group_pushes"] == sum(steps) + 1
