"""Live membership resizing of the port's PS (``distlr_tpu_torch/ps``:
``plan_reshard``, ``ServerGroup.spawn_for_resize`` / ``commit_resize``,
``MembershipCoordinator``, the client's epochs and re-route), held to the
JAX package's (``distlr_tpu/ps``, ``tests/test_elastic.py``) on the same
numpy inputs: the planner field for field, the epoch protocol on both
packages' groups, the weights after the same pushes and resizes, the
stats and events of a resize, the ctl wire across the packages, and the
JAX test's "double then halve under chaos" scenario at a small D.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

from distlr_tpu.ps import KVWorker as JaxKVWorker
from distlr_tpu.ps import MembershipCoordinator as JaxCoordinator
from distlr_tpu.ps import MembershipServer as JaxCtl
from distlr_tpu.ps import ServerGroup as JaxServerGroup
from distlr_tpu.ps import layout_client as jax_layout_client
from distlr_tpu.ps.membership import ctl_request as jax_ctl_request
from distlr_tpu.ps.server import plan_reshard as jax_plan_reshard
from distlr_tpu_torch.chaos import parse_plan
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.ps import (
    KVWorker,
    MembershipCoordinator,
    MembershipServer,
    PSEpochError,
    ServerGroup,
    ServerSupervisor,
    layout_client,
)
from distlr_tpu_torch.ps.membership import MembershipError, ctl_request
from distlr_tpu_torch.ps.server import plan_reshard

D = 1000
#: each package's (group, coordinator, client) classes
PACKAGES = {"ours": (ServerGroup, MembershipCoordinator, KVWorker),
            "jax": (JaxServerGroup, JaxCoordinator, JaxKVWorker)}


def _equal_ranges(dim: int, n: int) -> list[tuple[int, int]]:
    return [(dim * r // n, dim * (r + 1) // n) for r in range(n)]


def _without_seconds(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k != "seconds"}


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

_PLAN_CASES = [(dim, old) for dim in (8, 37, 1000) for old in range(1, 9)]


@pytest.mark.parametrize("dim,old", _PLAN_CASES, ids=[f"D{d}-S{o}" for d, o in _PLAN_CASES])
def test_plan_reshard_equals_jax(dim, old):
    """Every new size 1-8 (and the refusals around it), with every rank
    alive and with some dead, with and without reuse: the plan is JAX's
    field for field, and a refusal raises JAX's text."""
    olds = _equal_ranges(dim, old)
    masks = [[True] * old, [r % 3 != 1 for r in range(old)]]
    for new in (0, *range(1, 9), dim + 1):
        for alive in masks:
            for reuse in (True, False):
                try:
                    theirs = jax_plan_reshard(dim, olds, new, alive=alive, allow_reuse=reuse)
                except ValueError as e:
                    with pytest.raises(ValueError) as ours:
                        plan_reshard(dim, olds, new, alive=alive, allow_reuse=reuse)
                    assert str(ours.value) == str(e)
                    continue
                ours = plan_reshard(dim, olds, new, alive=alive, allow_reuse=reuse)
                assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
                assert ours.moved_keys == theirs.moved_keys
    with pytest.raises(ValueError) as ours:
        plan_reshard(dim, olds, 1, alive=[True] * (old + 1))
    with pytest.raises(ValueError) as theirs:
        jax_plan_reshard(dim, olds, 1, alive=[True] * (old + 1))
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# the epoch protocol, the port's client on both packages' groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("package", ["ours", "jax"])
class TestEpochProtocol:
    def test_fence_and_reannounce(self, package):
        group_cls = PACKAGES[package][0]
        with group_cls(1, 1, 32, sync=False) as g:
            with KVWorker(g.hosts, 32, client_id=1, sync_group=False, epoch=1) as kv:
                kv.push_init(np.zeros(32, np.float32))
                kv.pull()
                with KVWorker(g.hosts, 32, client_id=2, sync_group=False) as admin:
                    admin.set_epoch(2)
                    admin.pull()  # never announced: passes the fence
                with pytest.raises(PSEpochError) as ei:
                    kv.pull()
                assert ei.value.epoch == 2 and kv.stats(0)["epoch"] == 2

    def test_connect_time_mismatch_raises(self, package):
        group_cls = PACKAGES[package][0]
        with group_cls(1, 1, 32, sync=False, epoch=3) as g:
            with pytest.raises(PSEpochError) as ei:
                KVWorker(g.hosts, 32, sync_group=False, epoch=2)
            assert ei.value.epoch == 3

    def test_pre_epoch_group_degrades(self, package):
        # --compress=0 hides every capability, as a binary without epochs
        group_cls = PACKAGES[package][0]
        with group_cls(1, 1, 32, sync=False, compress=False) as g:
            with KVWorker(g.hosts, 32, sync_group=False, epoch=1) as kv:
                assert not kv._epoch_armed and kv.client_epoch == 0
                kv.push_init(np.zeros(32, np.float32))
                kv.pull()

    def test_wire_unchanged_without_epoch(self, package):
        group_cls = PACKAGES[package][0]
        with group_cls(1, 1, 32, sync=False) as g:
            with KVWorker(g.hosts, 32, sync_group=False) as kv:
                kv.push_init(np.ones(32, np.float32))
                np.testing.assert_array_equal(kv.pull(), np.ones(32, np.float32))
                assert kv.group_epoch() == 0


# ---------------------------------------------------------------------------
# resizes give the JAX package's weights, stats and events
# ---------------------------------------------------------------------------

_GROUPS = {
    "sgd": {"learning_rate": 0.25},
    "ftrl": {"optimizer": "ftrl", "ftrl_alpha": 0.5, "ftrl_l1": 0.01},
    "opt_segments": {"learning_rate": 0.25, "ftrl_alpha": 0.5,
                     "opt_segments": [(D // 2, "ftrl"), (D, "sgd")]},
}


def _scripted_run(package: str, kw: dict) -> dict:
    """Seed, push, then resize 2 -> 4 -> 2 -> 1 with a push after each;
    the pulls, the stats, the status and the events of each package."""
    group_cls, coord_cls, kv_cls = PACKAGES[package]
    rng = np.random.default_rng(11)
    grads = rng.standard_normal((4, D)).astype(np.float32)
    out = {"pulls": [], "stats": [], "status": []}
    with group_cls(2, 1, D, sync=False, **kw) as g:
        coord = coord_cls(g)
        with kv_cls(None, D, client_id=1, sync_group=False, route=coord.layout) as kv:
            kv.push_init(rng.standard_normal(D).astype(np.float32) * 0.1)
            kv.push(grads[0])
            out["pulls"].append(kv.pull().copy())
            for target, gv in zip((4, 2, 1), grads[1:]):
                out["stats"].append(_without_seconds(coord.resize(target)))
                out["pulls"].append(kv.pull().copy())
                kv.push(gv)
                out["pulls"].append(kv.pull().copy())
                st = coord.status()
                st["last_resize"] = _without_seconds(st["last_resize"])
                out["status"].append(st)
            out["noop"] = coord.resize(1)
        out["events"] = [(name, _without_seconds(detail)) for _, name, detail in coord.events]
        out["ranges"] = list(g.ranges)
    return out


@pytest.mark.parametrize("kind", list(_GROUPS))
def test_resizes_give_jax_weights_stats_and_events(kind):
    ours, theirs = _scripted_run("ours", _GROUPS[kind]), _scripted_run("jax", _GROUPS[kind])
    assert len(ours["pulls"]) == len(theirs["pulls"]) == 7
    for a, b in zip(ours["pulls"], theirs["pulls"]):
        np.testing.assert_array_equal(a, b)
    # a resize keeps the bits at rest
    for i in (0, 2, 4):
        np.testing.assert_array_equal(ours["pulls"][i], ours["pulls"][i + 1])
    assert ours["stats"] == theirs["stats"]
    assert ours["status"] == theirs["status"]
    assert ours["events"] == theirs["events"]
    assert ours["noop"] == theirs["noop"] == {"epoch": 4, "noop": True, "num_servers": 1}
    assert ours["ranges"] == theirs["ranges"] == [(0, D)]
    if kind != "sgd":
        assert [s["reused"] for s in ours["stats"]] == [0, 0, 0]  # a full rebuild


# ---------------------------------------------------------------------------
# clients across a reshard
# ---------------------------------------------------------------------------

class TestClients:
    def test_concurrent_pulls_survive(self):
        with ServerGroup(2, 1, D, sync=False) as g:
            coord = MembershipCoordinator(g)
            w0 = np.linspace(-1, 1, D).astype(np.float32)
            with KVWorker(g.hosts, D, sync_group=False) as s:
                s.push_init(w0)
            kv = KVWorker(None, D, client_id=2, sync_group=False, route=coord.layout)
            errs, stop = [], threading.Event()

            def hammer():
                while not stop.is_set():
                    try:
                        np.testing.assert_array_equal(kv.pull(), w0)
                    except Exception as e:  # noqa: BLE001
                        errs.append(e)
                        return

            t = threading.Thread(target=hammer)
            t.start()
            try:
                coord.resize(4)
                coord.resize(2)
            finally:
                time.sleep(0.1)
                stop.set()
                t.join()
                kv.close()
            assert not errs, errs
            assert kv.reroutes >= 1 and kv.client_epoch == 3

    def test_straddling_push_is_absorbed_and_applied_never_exceeds_issued(self):
        """Known-gradient SGD under two resizes: each coordinate's applies,
        read off the weights, lie in [acked, acked + absorbed]."""
        lr = 0.25
        with ServerGroup(2, 1, D, sync=False, learning_rate=lr) as g:
            coord = MembershipCoordinator(g)
            with KVWorker(None, D, sync_group=False, route=coord.layout) as kv:
                kv.push_init(np.zeros(D, np.float32))
                ones = np.ones(D, np.float32)
                acked, stop = [0], threading.Event()

                def pusher():
                    while not stop.is_set():
                        if kv.push(ones) >= 0:
                            acked[0] += 1

                t = threading.Thread(target=pusher)
                t.start()
                try:
                    time.sleep(0.15)
                    coord.resize(4)
                    time.sleep(0.15)
                    coord.resize(2)
                    time.sleep(0.15)
                finally:
                    stop.set()
                    t.join()
                applied = -kv.pull() / lr
                absorbed = kv.push_outcome_unknown
        assert applied.max() <= acked[0] + absorbed + 1e-3
        assert applied.min() >= acked[0] - 1e-3
        assert kv.epoch_mismatches >= 1 and kv.reroutes >= 2

    def test_route_provider_overrides_stale_hosts(self):
        with ServerGroup(2, 1, D, sync=False) as g:
            coord = MembershipCoordinator(g)
            stale = g.hosts
            w0 = np.arange(D, dtype=np.float32)
            with KVWorker(g.hosts, D, sync_group=False) as s:
                s.push_init(w0)
            coord.resize(4)  # reuses both ranks: the stale hosts still answer
            with KVWorker(stale, D, sync_group=False, route=coord.layout) as kv:
                assert kv.num_servers == 4 and kv._epoch == 2 and kv.hosts == g.hosts
                np.testing.assert_array_equal(kv.pull(), w0)

    def test_push_without_retry_policy_never_double_applies(self):
        """A route and no RetryPolicy: a push whose frames reached the
        server before the link was cut is absorbed, never re-issued."""
        lr = 0.25
        plan = parse_plan({"faults": [{"kind": "reset", "links": [0], "after_ops": 8}]})
        with ServerGroup(1, 1, 32, sync=False, learning_rate=lr, via_chaos=plan) as g:
            coord = MembershipCoordinator(g)
            with KVWorker(None, 32, sync_group=False, route=coord.layout) as kv:
                kv.push_init(np.zeros(32, np.float32))
                ok = 0
                for _ in range(12):
                    try:
                        if kv.push(np.ones(32, np.float32)) >= 0:
                            ok += 1
                    except OSError:
                        pass  # may surface; must not double-apply
                applied = -kv.pull() / lr
                absorbed = kv.push_outcome_unknown
        assert applied.max() <= ok + absorbed + 1e-3
        assert applied.min() >= ok - 1e-3

    def test_a_dim_change_is_refused(self):
        layout = {"status": "active", "epoch": 1, "hosts": "127.0.0.1:1", "dim": 64}
        with ServerGroup(1, 1, 32, sync=False) as g:
            with KVWorker(g.hosts, 32, sync_group=False) as kv:
                with pytest.raises(OSError, match="changed the key-space dim"):
                    kv._apply_layout(layout)


# ---------------------------------------------------------------------------
# rollback, the supervisor, wait
# ---------------------------------------------------------------------------

class TestCoordinator:
    def test_failed_drain_rolls_back(self):
        with ServerGroup(2, 1, D, sync=False) as g:
            coord = MembershipCoordinator(g)
            with KVWorker(g.hosts, D, sync_group=False) as s:
                s.push_init(np.arange(D, dtype=np.float32))
            ports = list(g.ports)
            real = coord._drain

            def broken(*a, **k):
                raise OSError("injected drain failure")

            coord._drain = broken
            with pytest.raises(MembershipError, match="rolled back"):
                coord.resize(4)
            coord._drain = real
            assert (g.num_servers, coord.epoch, g.ports, coord.reshard_failed) == (
                2, 1, ports, 1)
            assert coord.last_resize == {"ok": False, "error": "injected drain failure",
                                         "direction": "grow"}
            with KVWorker(g.hosts, D, sync_group=False, epoch=1) as kv:
                # the fence was lifted: a client at the old epoch still works
                np.testing.assert_array_equal(kv.pull(), np.arange(D, dtype=np.float32))
            assert coord.resize(4)["ok"] and coord.reshard_failed == 0
            assert coord.counters["reshards"] == {"grow": 1}
            assert [e for _, e, _ in coord.events] == [
                "resize_start", "resize_failed", "resize_start", "resize_done"]

    def test_paused_supervisor_records_nothing_and_rebinds(self):
        with ServerGroup(2, 1, D, sync=False) as g:
            with KVWorker(g.hosts, D, sync_group=False) as s:
                s.push_init(np.arange(D, dtype=np.float32))
            with ServerSupervisor(g, poll_interval=0.02, snapshot_interval=0.05) as sup:
                coord = MembershipCoordinator(g, supervisor=sup)
                time.sleep(0.2)
                coord.resize(4)
                assert len(sup._snap_valid) == 4 and not sup._paused.is_set()
                coord.resize(1)  # retires three ranks
                time.sleep(0.3)
                assert sup.events == [] and len(sup._respawns) == 1
                assert g.up == {0: 1, 1: 0, 2: 0, 3: 0} and g.membership_servers == 1

    def test_store_restore_pauses_the_supervisor(self, tmp_path):
        """RESTORE's SIGKILLs are never respawned by a supervisor as well."""
        with ServerGroup(2, 1, 32, sync=False, store_dir=str(tmp_path)) as g:
            with KVWorker(g.hosts, 32, sync_group=False) as s:
                s.push_init(np.ones(32, np.float32))
            paused = []
            with ServerSupervisor(g, poll_interval=0.02) as sup:
                real = g.respawn

                def respawn(rank):
                    paused.append(sup._paused.is_set())
                    return real(rank)

                g.respawn = respawn
                doc = MembershipCoordinator(g, supervisor=sup).store_restore()
                time.sleep(0.2)
            assert doc["restored"] == [0, 1] and paused == [True, True]
            assert sup.events == []

    def test_group_wait_survives_a_retire(self):
        with ServerGroup(2, 1, D, sync=False) as g:
            coord = MembershipCoordinator(g)
            with KVWorker(g.hosts, D, sync_group=False) as s:
                s.push_init(np.zeros(D, np.float32))
            done = threading.Event()
            t = threading.Thread(target=lambda: (g.wait(), done.set()))
            t.start()
            coord.resize(1)  # retires rank 1
            time.sleep(0.3)
            assert not done.is_set(), "a retired rank's exit ended wait()"
            with KVWorker(g.hosts, D, sync_group=False) as kv:
                kv.shutdown_servers()
            t.join(timeout=10)
            assert done.is_set()

    def test_async_resize_and_epoch_guard(self):
        with ServerGroup(2, 1, D, sync=False) as g:
            coord = MembershipCoordinator(g)
            assert coord.resize_async(2) == {"ok": True, "accepted": False, "noop": True,
                                             "epoch": 1, "num_servers": 2}
            with pytest.raises(MembershipError, match="async"):
                MembershipCoordinator(ServerGroup(1, 1, 8)).resize_async(2)
            assert coord.resize_async(4)["accepted"]
            deadline = time.monotonic() + 10
            while (coord.last_resize or {}).get("epoch") != 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert coord.status()["status"] == "active" and g.num_servers == 4
            coord._epoch = 0xFFFF
            with pytest.raises(MembershipError, match="epoch space exhausted"):
                coord.resize(2)


# ---------------------------------------------------------------------------
# the ctl wire across the packages
# ---------------------------------------------------------------------------

_WIRE = [("ours", "jax"), ("jax", "ours"), ("ours", "ours"), ("jax", "jax")]


@pytest.mark.parametrize("client,server", _WIRE, ids=[f"{c}-to-{s}" for c, s in _WIRE])
def test_ctl_wire_and_route_across_the_packages(client, server):
    """``ctl_request`` RESIZE / STATUS / RESIZE n wait=0 from one package's
    client against the other's ``MembershipServer``, and a data client of
    the client's package following the server's resizes through its
    ``layout_client``."""
    request = ctl_request if client == "ours" else jax_ctl_request
    layout = layout_client if client == "ours" else jax_layout_client
    kv_cls = PACKAGES[client][2]
    group_cls, coord_cls, _ = PACKAGES[server]
    ctl_cls = MembershipServer if server == "ours" else JaxCtl
    w0 = np.arange(D, dtype=np.float32)
    with group_cls(2, 1, D, sync=False) as g, ctl_cls(coord_cls(g)) as ctl:
        addr = f"127.0.0.1:{ctl.port}"
        with kv_cls(g.hosts, D, sync_group=False) as s:
            s.push_init(w0)
        with kv_cls(None, D, client_id=3, sync_group=False, route=layout(addr)) as kv:
            assert request(addr, "STATUS")["last_resize"] is None
            grown = request(addr, "RESIZE 4")
            assert (grown["ok"], grown["epoch"], grown["num_servers"]) == (True, 2, 4)
            np.testing.assert_array_equal(kv.pull(), w0)
            assert request(addr, "RESIZE 2 wait=0") == {"ok": True, "accepted": True,
                                                         "target": 2, "epoch": 2}
            deadline = time.monotonic() + 10
            while request(addr, "STATUS")["epoch"] != 3 and time.monotonic() < deadline:
                time.sleep(0.01)
            st = request(addr, "STATUS")
            assert (st["status"], st["num_servers"], st["last_resize"]["ok"]) == (
                "active", 2, True)
            np.testing.assert_array_equal(kv.pull(), w0)
            assert kv.num_servers == 2 and layout(addr)()["hosts"] == g.hosts
            assert request(addr, "RESIZE 0")["ok"] is False
            assert "unknown" in request(addr, "FROB")["error"]


# ---------------------------------------------------------------------------
# the watcher and the online trainer
# ---------------------------------------------------------------------------

def _libsvm(x) -> str:
    return " ".join(f"{i + 1}:{v:g}" for i, v in enumerate(x) if v)


def _make_rows(n, w_true, rng, *, min_margin=3.0):
    """Dense 0/1 rows with an unambiguous label under ``w_true`` (JAX's)."""
    X, y = [], []
    while len(X) < n:
        x = np.zeros(len(w_true), np.float32)
        x[rng.choice(len(w_true), size=4, replace=False)] = 1.0
        m = float(x @ w_true)
        if abs(m) < min_margin:
            continue
        X.append(x)
        y.append(1 if m > 0 else 0)
    return np.stack(X), np.asarray(y, np.int32)


def _write_shards(shard_dir, X, y, per_shard, start_seq=0) -> int:
    os.makedirs(shard_dir, exist_ok=True)
    seq = start_seq
    for lo in range(0, len(y), per_shard):
        path = os.path.join(shard_dir, f"shard-{seq:06d}.libsvm")
        with open(path + ".tmp", "w") as f:
            for i in range(lo, min(lo + per_shard, len(y))):
                f.write(f"{y[i]} {_libsvm(X[i])}\n")
        os.replace(path + ".tmp", path)
        seq += 1
    return seq


def test_watcher_scores_follow_a_resize():
    """``LivePSWatcher(None, route=)`` feeding an engine: after a resize and
    a forced re-seed, the served scores are σ of the new pull's logits."""
    from distlr_tpu_torch.serve import HotReloader, LivePSWatcher, ScoringEngine

    rng = np.random.default_rng(4)
    X = (rng.random((16, 64)) < 0.2).astype(np.float32)
    w1, w2 = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    cfg = Config(device="cpu", num_feature_dim=64, l2_c=0.0, compute_dtype="float32")
    with ServerGroup(2, 1, 64, sync=False) as g:
        coord = MembershipCoordinator(g)
        with KVWorker(g.hosts, 64, sync_group=False) as kv:
            kv.push_init(w1)
        eng = ScoringEngine(cfg, max_batch_size=64)
        watcher = LivePSWatcher(None, 64, route=coord.layout)
        reloader = HotReloader(eng, watcher, interval_s=30)
        try:
            assert reloader._poll_once()
            for w in (w1, w2):
                _, scores = eng.score((X,))
                np.testing.assert_allclose(scores, 1 / (1 + np.exp(-(X @ w))), rtol=1e-5)
                coord.resize(4 if w is w1 else 2)
                with KVWorker(None, 64, route=coord.layout) as kv:
                    kv.push_init(w2, force=True)
                assert reloader._poll_once()
            assert watcher.kv.reroutes == 2 and watcher.hosts == g.hosts
        finally:
            watcher.close()


def test_watcher_reconnect_after_a_failed_poll_re_routes():
    """A poll that failed leaves the watcher to rebuild its handle on the
    next one.  Past a resize the hosts it held are fenced (or retired): a
    routed watcher re-routes there, where a plain reconnect would raise
    the fence's PSEpochError on every later poll."""
    from distlr_tpu_torch.serve import LivePSWatcher

    w = np.linspace(-1, 1, 64).astype(np.float32)
    with ServerGroup(2, 1, 64, sync=False) as g:
        coord = MembershipCoordinator(g)
        with KVWorker(g.hosts, 64, sync_group=False) as kv:
            kv.push_init(w)
        watcher = LivePSWatcher(None, 64, route=coord.layout)
        try:
            assert watcher.poll()[0] == 1
            watcher._needs_reconnect = True  # as a failed poll leaves it
            coord.resize(4)
            with pytest.raises(PSEpochError):
                watcher.kv.reconnect()  # the old layout's ranks are fenced
            version, pulled = watcher.poll()
            assert version == 2 and watcher.kv.reroutes == 1 and watcher.kv.num_servers == 4
            np.testing.assert_array_equal(pulled, w)
        finally:
            watcher.close()


def test_online_trainer_consumes_every_shard_once_across_resizes(tmp_path):
    from distlr_tpu_torch.feedback import OnlineTrainer

    rng = np.random.default_rng(5)
    w_true = np.where(np.arange(32) % 2 == 0, 1.0, -1.0).astype(np.float32)
    X, y = _make_rows(150, w_true, rng)
    cfg = Config(device="cpu", model="binary_lr", num_feature_dim=32, batch_size=25,
                 l2_c=0.0, sync_mode=False, learning_rate=0.5)
    shard_dir = str(tmp_path / "shards")
    with ServerGroup(2, 1, 32, sync=False, learning_rate=0.5) as g:
        coord = MembershipCoordinator(g)
        tr = OnlineTrainer(cfg, None, shard_dir, poll_interval_s=0.01, route=coord.layout)
        try:
            seq = 0
            for i, target in enumerate((4, 2, 1)):
                seq = _write_shards(shard_dir, X[50 * i:50 * (i + 1)], y[50 * i:50 * (i + 1)],
                                    25, start_seq=seq)
                tr.run(max_shards=2)  # flushes its span at the end
                coord.resize(target)
            assert tr.examples == len(y) and tr.shards_consumed == seq == 6
            assert sorted(os.listdir(shard_dir)) == [f"shard-{i:06d}.libsvm.done"
                                                     for i in range(6)]
            w = tr.kv.pull()
            assert tr.kv.reroutes == 3 and tr.kv.client_epoch == 4 and tr.kv.num_servers == 1
        finally:
            tr.close()
    assert float((((X @ w) > 0).astype(np.int32) == y).mean()) > 0.9


# ---------------------------------------------------------------------------
# the scenario: double then halve under chaos
# ---------------------------------------------------------------------------

def test_double_then_halve_fleet_under_chaos(tmp_path):
    """``tests/test_elastic.py::TestElasticAcceptance`` on the port: online
    training and serving live against one group through a partition on
    link 0, the servers doubled then halved, a second engine replica
    added and the first removed, online workers added and retired.  No
    serving error, no supervisor event, every shard once, epoch 3 and two
    servers, applied <= issued + unknown + 1, and the accuracy within a
    point of a static group's on the same data."""
    from distlr_tpu_torch.feedback import OnlineTrainer
    from distlr_tpu_torch.serve import (
        HotReloader,
        LivePSWatcher,
        ScoringEngine,
        ScoringRouter,
        ScoringServer,
        score_lines_over_tcp,
    )

    Dd = 32
    rng = np.random.default_rng(7)
    w_true = np.where(np.arange(Dd) % 2 == 0, 1.0, -1.0).astype(np.float32)
    X, y = _make_rows(600, w_true, rng)
    Xt, yt = _make_rows(200, w_true, rng)
    test_lines = [_libsvm(x) for x in Xt]

    def accuracy(w) -> float:
        return float((((Xt @ w) > 0).astype(np.int32) == yt).mean())

    cfg = Config(device="cpu", model="binary_lr", num_feature_dim=Dd, batch_size=25, l2_c=0.0,
                 sync_mode=False, learning_rate=0.5, ps_retry_attempts=6,
                 ps_retry_backoff_ms=25, ps_retry_deadline_s=30)
    plan = parse_plan({"seed": 3, "faults": [
        {"kind": "partition", "links": [0], "window": [0.9, 1.6]}]})
    shard_dir = tmp_path / "shards"
    group = ServerGroup(2, 1, Dd, sync=False, learning_rate=0.5, via_chaos=plan).start()
    sup = ServerSupervisor(group, poll_interval=0.1).start()
    coord = MembershipCoordinator(group, supervisor=sup)
    trainers, threads, stops, train_errs = [], [], [], []
    try:
        def start_trainer(worker_id):
            tr = OnlineTrainer(cfg, None, str(shard_dir), poll_interval_s=0.05,
                               idle_flush_s=0.3, worker_id=worker_id, claim_stale_s=300,
                               route=coord.layout)
            ev = threading.Event()

            def run():
                try:
                    tr.run(stop=ev)
                    tr._flush_push()
                except Exception as e:  # noqa: BLE001
                    train_errs.append(e)

            th = threading.Thread(target=run, name=f"online-{worker_id}")
            trainers.append(tr)
            threads.append(th)
            stops.append(ev)
            th.start()

        os.makedirs(shard_dir, exist_ok=True)
        start_trainer(0)
        start_trainer(1)
        eng = ScoringEngine(cfg, max_batch_size=64)
        watcher = LivePSWatcher(None, Dd, route=coord.layout, timeout_ms=5000)
        reloader = HotReloader(eng, watcher, interval_s=0.1).start()
        reloader.wait_for_weights(timeout_s=30)
        srv_a = ScoringServer(eng, max_wait_ms=0.5).start()
        router = ScoringRouter([f"{srv_a.host}:{srv_a.port}"]).start()
        serve_errs, served, traffic_stop = [], [0], threading.Event()

        def traffic():
            i = 0
            while not traffic_stop.is_set():
                for r in score_lines_over_tcp(router.host, router.port,
                                              [test_lines[i % len(test_lines)]]):
                    if r.startswith("ERR"):
                        serve_errs.append(r)
                        return
                    served[0] += 1
                i += 1
                time.sleep(0.002)

        traffic_thread = threading.Thread(target=traffic)
        traffic_thread.start()
        srv_b = reloader_b = None
        try:
            seq = _write_shards(shard_dir, X[:200], y[:200], 50)
            time.sleep(0.9)  # the partition opens
            stats = coord.resize(4)
            assert stats["ok"] and stats["epoch"] == 2
            seq = _write_shards(shard_dir, X[200:400], y[200:400], 50, start_seq=seq)
            eng_b = ScoringEngine(cfg, max_batch_size=64)
            watcher_b = LivePSWatcher(None, Dd, route=coord.layout, timeout_ms=5000,
                                      client_id=4094)
            reloader_b = HotReloader(eng_b, watcher_b, interval_s=0.1).start()
            reloader_b.wait_for_weights(timeout_s=30)
            srv_b = ScoringServer(eng_b, max_wait_ms=0.5).start()
            assert router.handle_line(
                f"ADDREPLICA default {srv_b.host}:{srv_b.port}").startswith("OK")
            start_trainer(2)
            time.sleep(0.6)
            stops[1].set()  # retire worker 1 mid-run
            stats = coord.resize(2)
            assert stats["ok"] and stats["epoch"] == 3
            seq = _write_shards(shard_dir, X[400:], y[400:], 50, start_seq=seq)
            assert router.handle_line(
                f"DELREPLICA default {srv_a.host}:{srv_a.port}").startswith("OK")

            def all_consumed():
                return sum(1 for p in os.listdir(shard_dir) if p.endswith(".done")) == seq

            deadline = time.monotonic() + 60
            while not all_consumed() and time.monotonic() < deadline:
                assert not train_errs, train_errs
                time.sleep(0.1)
            assert all_consumed(), sorted(os.listdir(shard_dir))
            time.sleep(0.5)  # the idle flush pushes the last spans
        finally:
            traffic_stop.set()
            traffic_thread.join()
            for ev in stops:
                ev.set()
            for th in threads:
                th.join(timeout=30)
            reloader.stop()
            if reloader_b is not None:
                reloader_b.stop()
            router.stop()
            srv_a.stop()
            if srv_b is not None:
                srv_b.stop()
        assert not train_errs, train_errs
        assert not serve_errs, serve_errs[:3]
        assert served[0] > 100 and router.stats()["errors"] == 0
        assert sup.events == []
        assert sum(t.examples for t in trainers) == len(y)
        assert coord.epoch == 3 and group.num_servers == 2
        issued = sum(t.pushes for t in trainers) + len(trainers)
        unknowns = sum(t.kv.push_outcome_unknown for t in trainers)
        applied = group.global_pushes() - coord.seed_pushes / group.num_servers
        assert applied <= issued + unknowns + 1, (applied, issued, unknowns)
        with KVWorker(group.direct_hosts, Dd, sync_group=False) as kv:
            w_elastic = kv.pull()
    finally:
        for tr in trainers:
            tr.close()
        sup.stop()
        group.stop()
    static_dir = tmp_path / "static_shards"
    _write_shards(static_dir, X, y, 50)
    with ServerGroup(2, 1, Dd, sync=False, learning_rate=0.5) as g2:
        tr = OnlineTrainer(cfg, g2.hosts, str(static_dir), poll_interval_s=0.05)
        tr.run(max_shards=12)
        tr._flush_push()
        with KVWorker(g2.hosts, Dd, sync_group=False) as kv:
            w_static = kv.pull()
        tr.close()
    acc_e, acc_s = accuracy(w_elastic), accuracy(w_static)
    assert acc_s > 0.9 and acc_e >= acc_s - 0.01, (acc_e, acc_s)
    assert json.dumps(coord.last_resize)  # the STATUS surface stays JSON
