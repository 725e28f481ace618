"""The port's feedback loop (``distlr_tpu_torch.feedback``) against the JAX
package's (``distlr_tpu.feedback``), on the CPU, at small sizes.

The same seeded inputs go through both packages.  Tolerances: spool
journals and joined shard files byte for byte, outcome strings and
``stats()`` equal; PSI, ``firing`` and ``fired_total`` equal after every
observation; online-trained weights at rtol 1e-6 with ``stats()`` equal
(each package against its own async ``ServerGroup``, on a copy of one
shard dir); served scores at f32 rtol 1e-5.  One closed-loop run of the
port on ``device="cpu"`` is the only test driven by clocks; it waits on
deadlines, never on fixed sleeps.
"""

import dataclasses
import json
import os
import random
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from distlr_tpu import launch as jax_launch
from distlr_tpu import sync as jax_sync
from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.feedback import drift as jax_drift
from distlr_tpu.feedback import join as jax_join
from distlr_tpu.feedback import online as jax_online
from distlr_tpu.feedback import sink as jax_sink
from distlr_tpu.feedback import spool as jax_spool
from distlr_tpu.ps import KVWorker as JaxKVWorker
from distlr_tpu.ps import ServerGroup as JaxServerGroup
from distlr_tpu.serve.hotset import HotSetTracker as JaxHotSetTracker
from distlr_tpu_torch import launch
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.feedback import clock, drift, join, online, sink, spool
from distlr_tpu_torch.ps import KVWorker, ServerGroup
from distlr_tpu_torch.serve.hotset import HotSetTracker

REPO = Path(__file__).resolve().parents[1]
D = 32


@pytest.fixture
def one_clock(monkeypatch):
    """One injected wall and monotonic clock for both packages."""
    now = {"t": 1_000_000.0}
    monkeypatch.setattr(jax_sync, "wall", lambda: now["t"])
    monkeypatch.setattr(jax_sync, "monotonic", lambda: now["t"])
    monkeypatch.setattr(clock, "wall", lambda: now["t"])
    monkeypatch.setattr(clock, "monotonic", lambda: now["t"])
    return now


def _records(mod, rng, n, *, with_keys=False, models=(None,)):
    """``n`` seeded spool records of package ``mod`` (its SpoolRecord)."""
    out = []
    for i in range(n):
        cols = np.sort(rng.choice(D, size=3, replace=False))
        keys = cols.astype(np.uint64) if with_keys else None
        out.append(mod.SpoolRecord(
            rid=f"r{i}", ts=1000.0 + i * 0.25, line=" ".join(f"{c + 1}:1" for c in cols),
            score=float(rng.random()), version=int(i // 3), keys=keys,
            model=models[i % len(models)]))
    return out


def _files(d) -> dict:
    d = Path(d)
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


class TestSpool:
    @pytest.mark.parametrize("models", [(None,), ("v1", "v2")])
    def test_journals_are_byte_equal(self, tmp_path, models):
        """The same records and tombstones give the same segment files,
        rotation and disk bound included."""
        for mod, tag in ((spool, "ours"), (jax_spool, "jax")):
            sp = mod.FeedbackSpool(str(tmp_path / tag), capacity=5, segment_records=4,
                                   max_segments=2)
            for rec in _records(mod, np.random.default_rng(0), 13, models=models):
                sp.add(rec)
            sp.mark_joined("r11")
            sp.close()
        assert _files(tmp_path / "ours") == _files(tmp_path / "jax")
        assert sorted(_files(tmp_path / "ours")) == ["spool-000002.jsonl", "spool-000003.jsonl"]

    @pytest.mark.parametrize("writer,reader", [(jax_spool, spool), (spool, jax_spool)])
    def test_a_journal_replays_in_the_other_package(self, tmp_path, writer, reader):
        sp = writer.FeedbackSpool(str(tmp_path), segment_records=5)
        for rec in _records(writer, np.random.default_rng(1), 12, models=("v1", None)):
            sp.add(rec)
        sp.mark_joined("r3")
        sp.mark_joined("r7")
        sp.close()
        with open(tmp_path / "spool-000000.jsonl", "a") as f:
            f.write('{"id": "torn')  # a crashed run's last line
        got = []
        for mod in (writer, reader):
            rp = mod.FeedbackSpool(str(tmp_path), capacity=8)
            n = rp.replay(window_s=1.6, now=1002.6)
            got.append((n, [(r.rid, r.ts, r.line, r.score, r.version, r.model, r.keys)
                            for r in rp._records.values()], rp.stats()))
            rp.close()
        assert got[0] == got[1]
        assert got[0][0] == 7 and "r7" not in [r[0] for r in got[0][1]]

    @pytest.mark.parametrize("seed", [0, 1])
    def test_eviction_order_is_the_same_with_each_trackers_counts(self, tmp_path, seed):
        """Each package's spool over its own HotSetTracker, fed the same
        keys: the same records survive, in the same order."""
        rng = np.random.default_rng(seed)
        hot = [rng.choice(D, size=6, replace=False).astype(np.uint64) for _ in range(5)]
        kept = []
        for mod, tracker_cls, tag in ((spool, HotSetTracker, "ours"),
                                      (jax_spool, JaxHotSetTracker, "jax")):
            tracker = tracker_cls(64)
            for keys in hot:
                tracker.observe(keys)
            sp = mod.FeedbackSpool(str(tmp_path / tag), capacity=6, tracker=tracker,
                                   evict_scan=4)
            flags = [sp.add(rec) for rec in _records(mod, np.random.default_rng(seed + 10),
                                                     20, with_keys=True)]
            kept.append((flags, list(sp._records), sp.stats()["evicted"],
                         [r.rid for r in sp.expire_before(1002.0)]))
            sp.close()
        assert kept[0] == kept[1]
        assert kept[0][2] == 14

    def test_fifo_without_a_tracker(self, tmp_path):
        sp = spool.FeedbackSpool(str(tmp_path), capacity=3)
        for rec in _records(spool, np.random.default_rng(2), 5):
            sp.add(rec)
        assert list(sp._records) == ["r2", "r3", "r4"] and sp.evicted == 2

    @pytest.mark.parametrize("family", ["binary_lr", "softmax", "sparse_lr", "blocked_lr"])
    def test_per_row_keys_like_jax(self, family):
        rng = np.random.default_rng(3)
        if family in ("binary_lr", "softmax"):
            X = (rng.random((6, D)) < 0.2).astype(np.float32) * rng.standard_normal((6, D))
            rows = (X.astype(np.float32),)
        else:
            rows = (rng.integers(0, 500, (6, 9)).astype(np.int32),
                    rng.random((6, 9)).astype(np.float32))
        for max_keys in (128, 3):
            ours = spool.per_row_keys(family, rows, max_keys=max_keys)
            theirs = jax_spool.per_row_keys(family, rows, max_keys=max_keys)
            assert len(ours) == len(theirs) == 6
            for a, b in zip(ours, theirs):
                assert a.dtype == b.dtype and np.array_equal(a, b)

    @pytest.mark.parametrize("line", ["1 3:1 5:2", "3:1 5:2", "  0  ", "", "-1 7:0.5",
                                      "label", "1:1", "ab 2:1"])
    def test_strip_label_like_jax(self, line):
        assert spool.strip_label(line) == jax_spool.strip_label(line)


def _join_script(seed, n=80):
    """A seeded event script: requests (some of two models), labels
    (some before their request, some repeated, some never), window ticks."""
    rng = random.Random(seed)
    events, t = [], 5000.0
    for i in range(n):
        t += rng.random() * 0.4
        rid, model = f"q{i}", rng.choice([None, None, "v2"])
        line = " ".join(f"{c}:1" for c in sorted(rng.sample(range(1, D + 1), 3)))
        if rng.random() < 0.15:
            events.append(("label", rid, rng.randint(0, 1), t))  # before its request
        events.append(("scored", rid, line, t, model))
        if rng.random() < 0.6:
            events.append(("label", rid, rng.randint(0, 1), t + rng.random()))
        if rng.random() < 0.1:
            events.append(("label", rid, 1, t + 0.1))  # a duplicate
        if rng.random() < 0.05:
            events.append(("label", f"ghost{i}", 1, t))  # never requested
        if i % 10 == 9:
            events.append(("tick", t))
    events.append(("tick", t + 100.0))
    return events


def _drops(mod_spool) -> dict:
    """Drops by reason so far: the port's count, or the JAX registry's."""
    if mod_spool is spool:
        return dict(spool.DROPPED)
    from distlr_tpu.obs.registry import get_registry

    text = get_registry().prometheus_text()
    return {m[0]: float(m[1]) for m in
            re.findall(r'distlr_feedback_dropped_total\{reason="(\w+)"\} (\S+)',
                                     text)}


def _run_join(mod_spool, mod_join, out, script, **kw):
    before = _drops(mod_spool)
    sp = mod_spool.FeedbackSpool(str(out / "spool"))
    j = mod_join.LabelJoiner(sp, str(out / "shards"), **kw)
    outcomes = []
    for ev in script:
        if ev[0] == "scored":
            _, rid, line, ts, model = ev
            j.scored(mod_spool.SpoolRecord(rid=rid, ts=ts, line=line, score=0.5, version=1,
                                           model=model))
        elif ev[0] == "label":
            outcomes.append(j.label(ev[1], ev[2], ts=ev[3]))
        else:
            j.tick(ev[1])
    j.flush()
    sp.close()
    after = _drops(mod_spool)
    drops = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    return outcomes, j.stats(), _files(out / "shards"), drops


class TestJoiner:
    @pytest.mark.parametrize("seed,neg", [(0, 0.0), (1, 0.5), (2, 1.0)])
    def test_the_same_events_give_the_same_shards(self, tmp_path, seed, neg):
        script = _join_script(seed)
        kw = dict(window_s=2.0, negative_rate=neg, shard_records=7, seed=seed,
                  max_pending_labels=4, recent_joined=16)
        ours = _run_join(spool, join, tmp_path / "ours", script, **kw)
        theirs = _run_join(jax_spool, jax_join, tmp_path / "jax", script, **kw)
        assert ours == theirs
        assert any(name.startswith("v2/shard-") for name in ours[2])
        assert ours[1]["joined"] > 10 and ours[3]["unmatched_label"] > 0

    def test_shard_numbers_resume_past_an_earlier_run(self, tmp_path):
        for tag in ("ours", "jax"):
            d = tmp_path / tag / "shards"
            d.mkdir(parents=True)
            for name in ("shard-000004.libsvm.done", "shard-000006.libsvm.claim",
                         "shard-000002.libsvm"):
                (d / name).write_text("1 1:1\n")
        script = _join_script(3, n=30)
        kw = dict(window_s=1.0, negative_rate=0.3, shard_records=5, seed=3)
        ours = _run_join(spool, join, tmp_path / "ours", script, **kw)
        theirs = _run_join(jax_spool, jax_join, tmp_path / "jax", script, **kw)
        assert ours == theirs and "shard-000007.libsvm" in ours[2]

    @pytest.mark.parametrize("kw", [{"window_s": 0}, {"negative_rate": 1.5},
                                    {"shard_records": 0}])
    def test_validation_like_jax(self, tmp_path, kw):
        msgs = []
        for mod_spool, mod_join in ((spool, join), (jax_spool, jax_join)):
            with pytest.raises(ValueError) as e:
                mod_join.LabelJoiner(mod_spool.FeedbackSpool(str(tmp_path)), str(tmp_path), **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


class TestDrift:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_psi_firing_and_counts_after_every_observation(self, seed):
        rng = np.random.default_rng(seed)
        ours = drift.ScoreDriftDetector(block=50, threshold=0.2)
        theirs = jax_drift.ScoreDriftDetector(block=50, threshold=0.2)
        for step in range(40):
            centre = 0.2 if step < 15 else (0.8 if step < 25 else 0.8 + 0.01 * (step % 2))
            batch = np.clip(rng.normal(centre, 0.1, int(rng.integers(1, 70))), 0, 1)
            ours.observe(batch)
            theirs.observe(batch)
            assert (ours.psi_last, ours.firing, ours.fired_total, ours.cleared_total) == (
                theirs.psi_last, theirs.firing, theirs.fired_total, theirs.cleared_total)
        assert ours.stats() == theirs.stats()
        assert ours.fired_total >= 1 and ours.cleared_total >= 1

    @pytest.mark.parametrize("seed", [0, 1])
    def test_psi_same_bits(self, seed):
        rng = np.random.default_rng(seed)
        p, q = rng.integers(0, 40, 10), rng.integers(0, 40, 10)
        assert drift.psi(p, q) == jax_drift.psi(p, q)

    @pytest.mark.parametrize("kw", [{"block": 0}, {"bins": 1}, {"threshold": 0},
                                    {"smoothing": 0}])
    def test_validation_like_jax(self, kw):
        with pytest.raises(ValueError) as a:
            drift.ScoreDriftDetector(**kw)
        with pytest.raises(ValueError) as b:
            jax_drift.ScoreDriftDetector(**kw)
        assert str(a.value) == str(b.value)


class TestSink:
    def test_scored_label_tick_on_one_clock(self, tmp_path, one_clock):
        """Both sinks on one injected clock: the same outcomes, stats and
        shards, the idle flush included."""
        results = []
        for mod, tag in ((sink, "ours"), (jax_sink, "jax")):
            one_clock["t"] = 1_000_000.0
            s = mod.FeedbackSink(str(tmp_path / tag / "spool"), str(tmp_path / tag / "shards"),
                                 window_s=1.0, negative_rate=0.5, shard_records=4,
                                 drift_block=8, idle_flush_s=2.0, seed=7)
            outcomes = []
            r = np.random.default_rng(5)
            for step in range(12):
                X = (r.random((3, D)) < 0.2).astype(np.float32)
                lines = [" ".join(f"{c + 1}:1" for c in np.flatnonzero(x)) or "1:1" for x in X]
                ids = [f"s{step}-{i}" if i < 2 else None for i in range(3)]
                s.scored(lines, (X,), r.random(3), version=step, ids=ids,
                         model="v1" if step % 4 == 0 else None)
                outcomes.append(s.label(f"s{step}-0", step % 2))
                one_clock["t"] += 0.4
                s.tick()
            one_clock["t"] += 5.0
            s.tick()  # expire the window
            one_clock["t"] += 5.0
            s.tick()  # the idle flush
            results.append((outcomes, s.stats(), _files(tmp_path / tag / "shards")))
            s.stop()
        assert results[0] == results[1]
        assert results[0][1]["join"]["negatives"] > 0


def _libsvm(x):
    return " ".join(f"{i + 1}:{v:g}" for i, v in enumerate(x) if v)


def _make_rows(n, w_true, rng, *, min_margin=2.0):
    """Dense 0/1 rows with an unambiguous label under ``w_true`` (the JAX
    package's test rows)."""
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


def _write_shards(shard_dir, family, n_shards, rows_per, seed, K=3):
    """Seeded shards of one family: binary 0/1 labels, or class ids."""
    rng = np.random.default_rng(seed)
    os.makedirs(shard_dir, exist_ok=True)
    w_true = np.where(np.arange(D) % 2 == 0, 1.0, -1.0).astype(np.float32)
    for s in range(n_shards):
        X, y = _make_rows(rows_per, w_true, rng)
        if family in ("softmax", "sparse_softmax"):
            y = (X @ np.arange(D) % K).astype(np.int32)
        with open(os.path.join(shard_dir, f"shard-{s:06d}.libsvm"), "w") as f:
            for i in range(rows_per):
                f.write(f"{y[i]} {_libsvm(X[i])}\n")


def _online_run(pkg, cfg_kw, group_kw, shard_dir, *, servers=2, ns=None, trainer_kw=None):
    """One package's OnlineTrainer against its own async group over
    ``shard_dir``; returns (pulled weights of the trained slice, stats)."""
    if pkg == "ours":
        cfg, group_cls, kv_cls, trainer_cls = (Config(device="cpu", **cfg_kw), ServerGroup,
                                               KVWorker, online.OnlineTrainer)
    else:
        cfg, group_cls, kv_cls, trainer_cls = (JaxConfig(**cfg_kw), JaxServerGroup,
                                               JaxKVWorker, jax_online.OnlineTrainer)
    per_dim = D * (cfg.num_classes if cfg.model in ("softmax", "sparse_softmax") else 1)
    total = per_dim * (2 if ns is not None else 1)
    kw = dict(accum_start=1, accum_growth=2.0, accum_growth_every=2, accum_max=4,
              poll_interval_s=0.01, **(trainer_kw or {}))
    if ns is not None:
        kw.update(ns_base=ns * per_dim, ns_total_dim=total)
    n = len([f for f in os.listdir(shard_dir) if f.endswith(".libsvm")])
    with group_cls(servers, 1, total, sync=False, learning_rate=cfg.learning_rate,
                   **group_kw) as sg:
        tr = trainer_cls(cfg, sg.hosts, shard_dir, **kw)
        stats = tr.run(max_shards=n)
        tr.close()
        with kv_cls(sg.hosts, total, client_id=7) as kv:
            w = kv.pull()
    lo = 0 if ns is None else ns * per_dim
    return w[lo:lo + per_dim], stats


_FAMILIES = {
    "binary_lr": {},
    "softmax": {"num_classes": 3},
    "sparse_lr": {},
    "sparse_softmax": {"num_classes": 3},
}
_RULES = {
    "sgd": {},
    "ftrl": {"optimizer": "ftrl", "ftrl_alpha": 0.5, "ftrl_beta": 1.0, "ftrl_l1": 0.001},
}


class TestOnlineTrainer:
    @pytest.mark.parametrize("rule", sorted(_RULES))
    @pytest.mark.parametrize("family", sorted(_FAMILIES))
    def test_weights_and_stats_like_jax(self, tmp_path, family, rule):
        _write_shards(tmp_path / "src", family, 4, 24, seed=11)
        cfg_kw = dict(model=family, num_feature_dim=D, batch_size=8, l2_c=0.01,
                      sync_mode=False, learning_rate=0.5, **_FAMILIES[family])
        if rule == "ftrl":
            cfg_kw["ps_optimizer"] = "ftrl"
        got = {}
        for pkg in ("ours", "jax"):
            shutil.copytree(tmp_path / "src", tmp_path / pkg)
            got[pkg] = _online_run(pkg, cfg_kw, _RULES[rule], str(tmp_path / pkg))
        np.testing.assert_allclose(got["ours"][0], got["jax"][0], rtol=1e-6, atol=0)
        assert got["ours"][1] == got["jax"][1]
        assert got["ours"][1]["accum_k"] > 1 and np.abs(got["ours"][0]).max() > 0
        assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "jax"))

    @pytest.mark.parametrize("family", ["binary_lr", "sparse_lr"])
    def test_int8_pushes_like_jax(self, tmp_path, family):
        _write_shards(tmp_path / "src", family, 3, 24, seed=12)
        cfg_kw = dict(model=family, num_feature_dim=D, batch_size=12, l2_c=0.0,
                      sync_mode=False, learning_rate=0.5, ps_compress="int8")
        got = {}
        for pkg in ("ours", "jax"):
            shutil.copytree(tmp_path / "src", tmp_path / pkg)
            got[pkg] = _online_run(pkg, cfg_kw, {}, str(tmp_path / pkg))
        np.testing.assert_allclose(got["ours"][0], got["jax"][0], rtol=1e-6, atol=0)
        assert got["ours"][1] == got["jax"][1]

    def test_namespace_like_jax(self, tmp_path):
        _write_shards(tmp_path / "src", "binary_lr", 3, 16, seed=13)
        cfg_kw = dict(model="binary_lr", num_feature_dim=D, batch_size=8, l2_c=0.0,
                      sync_mode=False, learning_rate=0.5)
        got = {}
        for pkg in ("ours", "jax"):
            shutil.copytree(tmp_path / "src", tmp_path / pkg)
            got[pkg] = _online_run(pkg, cfg_kw, {}, str(tmp_path / pkg), ns=1)
        np.testing.assert_allclose(got["ours"][0], got["jax"][0], rtol=1e-6, atol=0)
        assert got["ours"][1] == got["jax"][1]

    def test_blocked_lr_refused_with_jax_message(self, tmp_path):
        msgs = []
        for cfg, cls in ((Config(model="blocked_lr", num_feature_dim=D, block_size=8,
                                 device="cpu"), online.OnlineTrainer),
                         (JaxConfig(model="blocked_lr", num_feature_dim=D, block_size=8),
                          jax_online.OnlineTrainer)):
            with pytest.raises(ValueError, match="RAW categorical") as e:
                cls(cfg, "127.0.0.1:1", str(tmp_path))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    def test_retry_and_route_like_jax(self, tmp_path):
        """The trainer's client gets ``RetryPolicy.from_config(cfg)`` as
        JAX's does, and with a membership ``route`` (no hosts) follows the
        coordinator through a resize."""
        from distlr_tpu.ps import RetryPolicy as JaxRetryPolicy

        cfg = Config(device="cpu", num_feature_dim=D, sync_mode=False, ps_retry_attempts=3)
        with ServerGroup(1, 1, D, sync=False) as sg:
            tr = online.OnlineTrainer(cfg, sg.hosts, str(tmp_path))
            try:
                assert dataclasses.asdict(tr.kv.retry) == dataclasses.asdict(
                    JaxRetryPolicy.from_config(JaxConfig(num_feature_dim=D, sync_mode=False,
                                                         ps_retry_attempts=3)))
            finally:
                tr.kv.close()
        from distlr_tpu_torch.ps import MembershipCoordinator

        with ServerGroup(2, 1, D, sync=False) as sg:
            coord = MembershipCoordinator(sg)
            tr = online.OnlineTrainer(Config(device="cpu", num_feature_dim=D, sync_mode=False),
                                      None, str(tmp_path), route=coord.layout)
            try:
                assert tr.kv.hosts == sg.hosts and tr.kv.client_epoch == 1
                coord.resize(4)
                np.testing.assert_array_equal(tr.kv.pull(), np.zeros(D, np.float32))
                assert (tr.kv.reroutes, tr.kv.num_servers, tr.kv.client_epoch) == (1, 4, 2)
            finally:
                tr.kv.close()

    def test_client_id_and_idle_flush(self, tmp_path):
        """The online client id is JAX's; a partial span is pushed after
        the idle flush, and an idle exit returns."""
        assert online.OnlineTrainer.ONLINE_CLIENT_ID == jax_online.OnlineTrainer.ONLINE_CLIENT_ID
        _write_shards(tmp_path / "s", "binary_lr", 1, 8, seed=14)
        cfg = Config(device="cpu", num_feature_dim=D, batch_size=8, l2_c=0.0, sync_mode=False)
        with ServerGroup(1, 1, D, sync=False) as sg:
            tr = online.OnlineTrainer(cfg, sg.hosts, str(tmp_path / "s"), accum_start=4,
                                      accum_max=4, poll_interval_s=0.01, idle_flush_s=0.0)
            stats = tr.run(idle_exit_s=0.05)
            tr.close()
        assert stats == {"shards_consumed": 1, "examples": 8, "pushes": 1, "accum_k": 4,
                         "pending": 0}


class TestClaims:
    def test_a_jax_worker_and_a_port_worker_share_one_dir(self, tmp_path):
        """Two workers, one of each package, claim from one shard dir:
        every shard is consumed exactly once."""
        _write_shards(tmp_path / "s", "binary_lr", 12, 10, seed=15)
        cfg_kw = dict(num_feature_dim=D, batch_size=10, l2_c=0.0, sync_mode=False)
        with ServerGroup(1, 1, D, sync=False) as sg:
            workers = [online.OnlineTrainer(Config(device="cpu", **cfg_kw), sg.hosts,
                                            str(tmp_path / "s"), worker_id=0,
                                            poll_interval_s=0.01),
                       jax_online.OnlineTrainer(JaxConfig(**cfg_kw), sg.hosts,
                                                str(tmp_path / "s"), worker_id=1,
                                                poll_interval_s=0.01)]
            stats = [None, None]

            def run(i):
                stats[i] = workers[i].run(idle_exit_s=0.3)

            threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            for w in workers:
                w.close()
        assert sum(s["shards_consumed"] for s in stats) == 12
        assert sum(s["examples"] for s in stats) == 120
        names = sorted(os.listdir(tmp_path / "s"))
        assert names == [f"shard-{i:06d}.libsvm.done" for i in range(12)]

    def test_stale_claim_reclaimed_fresh_claim_kept(self, tmp_path):
        _write_shards(tmp_path / "s", "binary_lr", 2, 6, seed=16)
        d = tmp_path / "s"
        os.rename(d / "shard-000000.libsvm", d / "shard-000000.libsvm.claim")
        os.utime(d / "shard-000000.libsvm.claim", (0, time.time() - 100))
        os.rename(d / "shard-000001.libsvm", d / "shard-000001.libsvm.claim")
        cfg = Config(device="cpu", num_feature_dim=D, batch_size=6, l2_c=0.0, sync_mode=False)
        with ServerGroup(1, 1, D, sync=False) as sg:
            tr = online.OnlineTrainer(cfg, sg.hosts, str(d), claim_stale_s=30.0,
                                      poll_interval_s=0.01)
            stats = tr.run(idle_exit_s=0.1)
            tr.close()
        assert stats["shards_consumed"] == 1
        assert sorted(os.listdir(d)) == ["shard-000000.libsvm.done", "shard-000001.libsvm.claim"]

    def test_claim_is_exclusive(self, tmp_path):
        _write_shards(tmp_path / "s", "binary_lr", 1, 4, seed=17)
        path = str(tmp_path / "s" / "shard-000000.libsvm")
        tr = object.__new__(online.OnlineTrainer)
        assert tr._claim(path) == path + ".claim"
        assert tr._claim(path) is None


class TestServeProtocol:
    """``ID`` / ``LABEL`` lines and JSON ``"ids"`` through both servers,
    each with its own sink."""

    def _servers(self, tmp_path, with_feedback=True):
        from distlr_tpu.feedback import FeedbackSink as JaxSink
        from distlr_tpu.serve import ScoringEngine as JaxEngine
        from distlr_tpu.serve import ScoringServer as JaxServer
        from distlr_tpu_torch.feedback import FeedbackSink
        from distlr_tpu_torch.serve import ScoringEngine, ScoringServer

        w = np.linspace(-1, 1, D).astype(np.float32)
        out = []
        for eng, srv_cls, sink_cls, tag in (
                (ScoringEngine(Config(device="cpu", num_feature_dim=D, l2_c=0.0,
                                      compute_dtype="float32"), max_batch_size=64),
                 ScoringServer, FeedbackSink, "ours"),
                (JaxEngine(JaxConfig(num_feature_dim=D, l2_c=0.0, compute_dtype="float32"),
                           max_batch_size=64), JaxServer, JaxSink, "jax")):
            eng.set_weights(w)
            s = (sink_cls(str(tmp_path / tag / "spool"), str(tmp_path / tag / "shards"),
                          window_s=30.0, shard_records=4) if with_feedback else None)
            out.append((srv_cls(eng, feedback=s), s))
        return out

    def test_id_and_label_lines(self, tmp_path):
        lines = ["ID req-1 3:1 5:1", "LABEL req-1 1", "LABEL req-1 0", "LABEL never-seen 1",
                 "LABEL bad", "LABEL x 7", "ID only", "LABEL x 1.0"]
        replies = []
        for srv, _ in self._servers(tmp_path):
            try:
                replies.append([srv.handle_line(ln) for ln in lines])
            finally:
                srv.stop()
        assert replies[0][1:] == replies[1][1:]
        assert replies[0][1:4] == ["OK joined", "OK duplicate", "OK pending"]
        assert replies[0][0] == replies[1][0]

    def test_json_ids_and_stats(self, tmp_path):
        reqs = [json.dumps({"rows": ["1:1", "2:1"], "ids": ["a", None]}), "LABEL a 1",
                json.dumps({"rows": ["1:1"], "ids": ["a", "b"]}),
                json.dumps({"rows": ["1:1"], "ids": "a"})]
        got = []
        for srv, s in self._servers(tmp_path):
            try:
                got.append(([srv.handle_line(r) for r in reqs], srv.stats()["feedback"],
                            len(s.spool)))
            finally:
                srv.stop()
        assert got[0] == got[1]
        assert got[0][0][1] == "OK joined" and got[0][0][2].startswith("ERR ValueError")

    def test_no_sink_err_text(self, tmp_path):
        replies = []
        for srv, _ in self._servers(tmp_path, with_feedback=False):
            try:
                replies.append([srv.handle_line("LABEL x 1"), "feedback" in srv.stats()])
            finally:
                srv.stop()
        assert replies[0] == replies[1]
        assert replies[0][0].startswith("ERR ValueError: this server runs no feedback sink")


class _Loop:
    """serve -> label -> join -> online trainer -> live PS -> hot reload,
    the port's pieces on the CPU (the JAX package's ``_LoopHarness``)."""

    def __init__(self, tmp_path):
        from distlr_tpu_torch.feedback import FeedbackSink, OnlineTrainer
        from distlr_tpu_torch.serve import (
            HotReloader,
            LivePSWatcher,
            ScoringEngine,
            ScoringServer,
        )

        self.cfg = Config(device="cpu", model="binary_lr", num_feature_dim=D, batch_size=24,
                          l2_c=0.0, sync_mode=False, ps_timeout_ms=20_000,
                          compute_dtype="float32")
        self.group = ServerGroup(1, 1, D, sync=False, optimizer="ftrl", ftrl_alpha=1.0,
                                 ftrl_beta=1.0, ftrl_l1=0.001, ftrl_l2=0.0).start()
        self.trainer = OnlineTrainer(self.cfg, self.group.hosts, str(tmp_path / "shards"),
                                     accum_start=1, accum_growth=2.0, accum_growth_every=50,
                                     accum_max=4, poll_interval_s=0.05, idle_flush_s=0.2)
        self.sink = FeedbackSink(str(tmp_path / "spool"), str(tmp_path / "shards"),
                                 model="binary_lr", window_s=1.0, negative_rate=0.3,
                                 shard_records=24, drift_block=120, drift_threshold=0.15,
                                 tick_interval_s=0.1, idle_flush_s=0.3)
        self.engine = ScoringEngine(self.cfg, max_batch_size=64)
        self.reloader = HotReloader(self.engine, LivePSWatcher(self.group.hosts, D),
                                    interval_s=0.1, jitter=0.0).start()
        self.reloader.wait_for_weights(timeout_s=20.0)
        self.server = ScoringServer(self.engine, feedback=self.sink, max_wait_ms=1.0,
                                    reloader=self.reloader).start()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self.trainer.run, kwargs={"stop": self._stop},
                                        daemon=True)
        self._thread.start()
        self._sock = socket.create_connection((self.server.host, self.server.port), timeout=30)
        self._f = self._sock.makefile("rwb")
        self._next = 0

    def exchange(self, line):
        self._f.write((line + "\n").encode())
        self._f.flush()
        reply = self._f.readline().decode().rstrip("\n")
        assert reply, "server closed mid-stream"
        return reply

    def drive(self, X, y, rng):
        for i in range(len(y)):
            rid = f"r{self._next}"
            self._next += 1
            assert not self.exchange(f"ID {rid} {_libsvm(X[i])}").startswith("ERR")
            if rng.random() < 0.85:
                assert self.exchange(f"LABEL {rid} {int(y[i])}").startswith("OK")

    def probe(self, X):
        return np.asarray(json.loads(self.exchange(
            json.dumps({"rows": [_libsvm(x) for x in X]})))["scores"], np.float64)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=20)
        self._f.close()
        self._sock.close()
        self.server.stop()
        self.trainer.close()
        self.group.stop()


class TestClosedLoop:
    def test_the_loop_tracks_a_label_flip_on_the_cpu(self, tmp_path):
        """Phase 1 learns from cold, phase 2 follows flipped labels with no
        restart; drift fires, then clears on steady traffic; the served
        scores are σ(X·w) of the group's weights."""
        rng = np.random.default_rng(42)
        w_true = np.where(np.arange(D) % 2 == 0, 1.0, -1.0).astype(np.float32)
        Xp, _ = _make_rows(8, w_true, rng)
        yp = (Xp @ w_true > 0).astype(np.int32)
        pos, neg = Xp[yp == 1], Xp[yp == 0]
        loop = _Loop(tmp_path)
        try:
            def phase(sign, tag, deadline_s=60.0):
                deadline = time.monotonic() + deadline_s
                while True:
                    X, y = _make_rows(60, sign * w_true, rng)
                    loop.drive(X, y, rng)
                    sp, sn = loop.probe(pos).mean(), loop.probe(neg).mean()
                    if (sp > 0.6 and sn < 0.4) if sign > 0 else (sp < 0.4 and sn > 0.6):
                        return
                    assert time.monotonic() < deadline, (
                        f"{tag}: pos={sp:.3f} neg={sn:.3f} {loop.sink.stats()} "
                        f"{loop.trainer.stats()}")
                    loop._stop.wait(0.1)

            phase(+1, "phase1")
            phase(-1, "phase2")
            assert loop.sink.drift.fired_total >= 1, loop.sink.drift.stats()
            deadline = time.monotonic() + 60.0
            while loop.sink.drift.firing:
                X, y = _make_rows(60, -w_true, rng)
                loop.drive(X, y, rng)
                assert time.monotonic() < deadline, loop.sink.drift.stats()
            st = loop.sink.stats()
            assert st["join"]["joined"] > 50 and st["join"]["negatives"] > 0, st
            assert loop.trainer.pushes > 0 and loop.trainer.examples > 0
            # with the trainer stopped, the served scores are σ(X·w) of the
            # group's weights once the reloader has them
            loop._stop.set()
            loop._thread.join(timeout=20)
            with KVWorker(loop.group.hosts, D, client_id=9) as kv:
                w = kv.pull()
            deadline = time.monotonic() + 20.0
            while not np.array_equal(loop.engine.get_weights(), w):
                assert time.monotonic() < deadline, "the reloader never took the final weights"
                loop._stop.wait(0.05)
            z = (Xp.astype(np.float32) @ w).astype(np.float64)
            np.testing.assert_allclose(loop.probe(Xp), 1 / (1 + np.exp(-z)), rtol=1e-5)
        finally:
            loop.close()


def _capture_configs(monkeypatch, argv):
    """The Config each CLI's ``argv`` builds, taken where the command
    constructs its first object (neither package runs anything)."""
    import distlr_tpu.feedback as jax_feedback
    import distlr_tpu.serve as jax_serve

    import distlr_tpu_torch.feedback as feedback
    import distlr_tpu_torch.serve as serve

    seen = {}

    class _Seen(Exception):
        pass

    def grab(key):
        def f(cfg, *a, **k):
            seen[key] = cfg
            raise _Seen
        return f

    monkeypatch.setattr(signal, "signal", lambda *a: None)
    target = "OnlineTrainer" if argv[0] == "online" else "ScoringEngine"
    for mod, key in (((feedback, "ours"), (jax_feedback, "jax")) if argv[0] == "online"
                     else ((serve, "ours"), (jax_serve, "jax"))):
        monkeypatch.setattr(mod, target, grab(key))
    for main, extra, key in ((launch.main, ["--device", "cpu"], "ours"),
                             (jax_launch.main, [], "jax")):
        with pytest.raises(_Seen):
            main([*argv, *extra])
    return seen["ours"], seen["jax"]


_SHARED_FIELDS = ("model", "num_feature_dim", "learning_rate", "l2_c", "batch_size",
                  "ps_timeout_ms", "ps_optimizer", "ps_compress", "ps_accum_start",
                  "ps_accum_growth", "ps_accum_growth_every", "ps_accum_max", "sync_mode",
                  "feedback_spool_dir", "feedback_shard_dir", "feedback_window_s",
                  "feedback_negative_rate", "feedback_shard_records", "feedback_capacity",
                  "feedback_drift_block", "feedback_drift_threshold", "serve_port",
                  "serve_reload_interval_s", "serve_model_id")


class TestCLI:
    @pytest.mark.parametrize("argv", [
        ["online", "--num-feature-dim", "32", "--hosts", "127.0.0.1:1", "--shard-dir", "s"],
        ["online", "--num-feature-dim", "32", "--hosts", "127.0.0.1:1", "--shard-dir", "s",
         "--accum-max", "8", "--l2-c", "0", "--ps-compress", "int8"],
        ["serve", "--num-feature-dim", "32", "--model-file", "m", "--feedback-spool", "sp"],
        ["serve", "--num-feature-dim", "32", "--model-file", "m", "--feedback-spool", "sp",
         "--feedback-shards", "sh", "--feedback-window", "2", "--feedback-negative-rate", "0.3",
         "--feedback-shard-records", "8", "--feedback-capacity", "100", "--drift-block", "64",
         "--drift-threshold", "0.1", "--model-id", "v1", "--port", "0"],
    ])
    def test_both_clis_give_equal_configs(self, argv, monkeypatch):
        ours, theirs = _capture_configs(monkeypatch, argv)
        for f in _SHARED_FIELDS:
            assert getattr(ours, f) == getattr(theirs, f), f
        if argv[0] == "online" and "--accum-max" not in argv:
            assert ours.ps_accum_max == 64 and Config().ps_accum_max == 1

    def test_online_through_both_clis_gives_equal_weights(self, tmp_path, monkeypatch):
        monkeypatch.setattr(signal, "signal", lambda *a: None)
        _write_shards(tmp_path / "src", "binary_lr", 3, 20, seed=18)
        got = {}
        for main, group_cls, kv_cls, extra, tag in (
                (launch.main, ServerGroup, KVWorker, ["--device", "cpu"], "ours"),
                (jax_launch.main, JaxServerGroup, JaxKVWorker, [], "jax")):
            shutil.copytree(tmp_path / "src", tmp_path / tag)
            with group_cls(1, 1, D, sync=False, optimizer="ftrl", ftrl_alpha=0.5) as sg:
                assert main(["online", "--num-feature-dim", str(D), "--l2-c", "0",
                             "--batch-size", "10", "--hosts", sg.hosts, "--shard-dir",
                             str(tmp_path / tag), "--max-shards", "3", "--accum-max", "4",
                             "--accum-growth-every", "2", "--poll-interval", "0.01",
                             *extra]) == 0
                with kv_cls(sg.hosts, D, client_id=9) as kv:
                    got[tag] = kv.pull()
        np.testing.assert_allclose(got["ours"], got["jax"], rtol=1e-6, atol=0)
        assert np.abs(got["ours"]).max() > 0

    def test_online_needs_hosts(self, tmp_path, capsys):
        assert launch.main(["online", "--shard-dir", str(tmp_path), "--device", "cpu"]) == 2
        assert "online needs --hosts" in capsys.readouterr().err

    def test_online_ps_ctl_follows_the_coordinator_like_jax(self, tmp_path, monkeypatch):
        """``launch online --ps-ctl`` (no ``--hosts``) against each package's
        elastic group, resized 2 -> 4 before it starts: the same weights."""
        from distlr_tpu.ps import MembershipCoordinator as JaxCoordinator
        from distlr_tpu.ps import MembershipServer as JaxCtl

        from distlr_tpu_torch.ps import MembershipCoordinator, MembershipServer

        monkeypatch.setattr(signal, "signal", lambda *a: None)
        _write_shards(tmp_path / "src", "binary_lr", 2, 20, seed=19)
        got = {}
        for main, group_cls, coord_cls, ctl_cls, kv_cls, extra, tag in (
                (launch.main, ServerGroup, MembershipCoordinator, MembershipServer, KVWorker,
                 ["--device", "cpu"], "ours"),
                (jax_launch.main, JaxServerGroup, JaxCoordinator, JaxCtl, JaxKVWorker, [],
                 "jax")):
            shutil.copytree(tmp_path / "src", tmp_path / tag)
            with group_cls(2, 1, D, sync=False, optimizer="ftrl", ftrl_alpha=0.5) as sg:
                coord = coord_cls(sg)
                with ctl_cls(coord) as ctl:
                    assert coord.resize(4)["ok"]
                    assert main(["online", "--num-feature-dim", str(D), "--l2-c", "0",
                                 "--batch-size", "10", "--ps-ctl", f"127.0.0.1:{ctl.port}",
                                 "--shard-dir", str(tmp_path / tag), "--max-shards", "2",
                                 "--poll-interval", "0.01", *extra]) == 0
                with kv_cls(sg.hosts, D, client_id=9) as kv:
                    got[tag] = kv.pull()
        np.testing.assert_allclose(got["ours"], got["jax"], rtol=1e-6, atol=0)
        assert np.abs(got["ours"]).max() > 0

    def test_serve_feedback_without_cuda_raises(self, tmp_path, monkeypatch):
        import torch

        from distlr_tpu_torch.train.export import save_model_text

        save_model_text(str(tmp_path / "m"), np.zeros(D, np.float32))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="--device cpu"):
            launch.main(["serve", "--num-feature-dim", str(D), "--model-file",
                         str(tmp_path / "m"), "--feedback-spool", str(tmp_path / "sp")])
        assert not (tmp_path / "sp").exists()

    def test_serve_and_online_subprocesses_close_the_loop(self, tmp_path):
        """``ps-server`` -> ``online`` -> ``serve --feedback-spool`` as the
        port's CLI on the CPU: labelled ``ID`` lines become a shard when
        ``serve`` stops (SIGTERM flushes it), ``online`` consumes it and
        exits on its shard bound, and the group's weights moved."""
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        procs = []

        def start(*argv, ready):
            proc = subprocess.Popen([sys.executable, "-m", "distlr_tpu_torch.launch", *argv],
                                    cwd=REPO, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            procs.append(proc)
            line = proc.stdout.readline()
            assert line.startswith(ready), (line, proc.stderr.read() if proc.poll() else "")
            return line.split()[1]

        try:
            hosts = start("ps-server", "--num-feature-dim", str(D), "--async",
                          "--ps-optimizer", "ftrl", "--ftrl-alpha", "1.0", "--device", "cpu",
                          ready="HOSTS ")
            start("online", "--num-feature-dim", str(D), "--l2-c", "0", "--hosts", hosts,
                  "--shard-dir", str(tmp_path / "shards"), "--max-shards", "1",
                  "--poll-interval", "0.05", ready="ONLINE ")
            addr = start("serve", "--num-feature-dim", str(D), "--ps-hosts", hosts, "--port",
                         "0", "--device", "cpu", "--feedback-spool", str(tmp_path / "spool"),
                         "--feedback-shards", str(tmp_path / "shards"), ready="SERVING ")
            from distlr_tpu_torch.serve import score_lines_over_tcp

            host, port = addr.rsplit(":", 1)
            rng = np.random.default_rng(19)
            w_true = np.where(np.arange(D) % 2 == 0, 1.0, -1.0).astype(np.float32)
            X, y = _make_rows(20, w_true, rng)
            lines = [ln for i in range(20) for ln in (f"ID c{i} {_libsvm(X[i])}",
                                                       f"LABEL c{i} {y[i]}")]
            replies = score_lines_over_tcp(host, int(port), lines)
            assert all(r == "OK joined" for r in replies[1::2]), replies
            procs[2].send_signal(signal.SIGTERM)
            assert procs[2].wait(timeout=60) == 143
            assert procs[1].wait(timeout=60) == 0
            with KVWorker(hosts, D, client_id=9) as kv:
                w = kv.pull()
            assert float(((X @ w > 0).astype(np.int32) == y).mean()) > 0.8
            assert sorted(os.listdir(tmp_path / "shards")) == ["shard-000000.libsvm.done"]
            procs[0].send_signal(signal.SIGTERM)
            assert procs[0].wait(timeout=60) == 143
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
