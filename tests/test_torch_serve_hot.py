"""The port's hot-row serving on the CPU, against the JAX package's:
``HotSetTracker`` on one observe sequence, and ``LivePSWatcher`` with
``vals_per_key`` rows and a tracker on one server group and one sequence
of polls (full, hot, the coverage fallback, ``full_refresh_every`` and an
idle no-op).  Tolerance: none; the tables and the tracker's numbers are
held equal.
"""

import numpy as np
import pytest

from distlr_tpu.serve import HotSetTracker as JaxHotSetTracker
from distlr_tpu.serve import LivePSWatcher as JaxLivePSWatcher
from distlr_tpu_torch.ps import KVWorker, ServerGroup
from distlr_tpu_torch.serve import HotSetTracker, LivePSWatcher


class TestHotSetTracker:
    @pytest.mark.parametrize("capacity,decay_every", [(16, 50), (64, 10_000), (4, 7)])
    def test_same_numbers_as_jax_on_one_observe_sequence(self, capacity, decay_every):
        rng = np.random.default_rng(capacity)
        ours = HotSetTracker(capacity, decay=0.5, decay_every=decay_every)
        theirs = JaxHotSetTracker(capacity, decay=0.5, decay_every=decay_every)
        for step in range(60):
            # a Zipf-like stream that drifts halfway through
            base = 0 if step < 30 else 40
            keys = (base + rng.zipf(1.5, size=int(rng.integers(1, 20))) % 80).astype(np.uint64)
            ours.observe(keys)
            theirs.observe(keys)
            assert ours.coverage() == theirs.coverage()
            if step % 5 == 4:
                np.testing.assert_array_equal(ours.hot_keys(), theirs.hot_keys())
            assert ours.stats() == theirs.stats()
            probe = [keys, None, np.array([], np.uint64), np.arange(10, dtype=np.uint64)]
            assert ours.importance(keys) == theirs.importance(keys)
            assert ours.importance_many(probe) == theirs.importance_many(probe)
        assert ours.decays == theirs.decays and ours.evictions == theirs.evictions

    def test_idle_coverage_is_one_and_bad_args_refused(self):
        t = HotSetTracker(8)
        assert t.coverage() == 1.0 and t.hot_keys().size == 0
        t.observe([])
        assert t.stats()["observed"] == 0
        for kw, match in (({"capacity": 0}, "capacity"), ({"capacity": 4, "decay": 0.0}, "decay"),
                          ({"capacity": 4, "decay_every": 0}, "decay_every")):
            with pytest.raises(ValueError, match=match):
                HotSetTracker(**kw)
            with pytest.raises(ValueError, match=match):
                JaxHotSetTracker(**kw)


def _watchers(hosts, dim, vpk, tracker_cap, **kw):
    ours = LivePSWatcher(hosts, dim, vals_per_key=vpk, client_id=4001, chunk_rows=7,
                         hot_tracker=HotSetTracker(tracker_cap) if tracker_cap else None, **kw)
    theirs = JaxLivePSWatcher(hosts, dim, vals_per_key=vpk, client_id=4002, chunk_rows=7,
                              hot_tracker=(JaxHotSetTracker(tracker_cap) if tracker_cap
                                           else None), **kw)
    return ours, theirs


def _poll_both(ours, theirs, expect_kind):
    a, b = ours.poll(), theirs.poll()
    if expect_kind is None:
        assert a is None and b is None
        return None
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    assert a[1].dtype == np.float32
    sa, sb = ours.stats(), theirs.stats()
    assert sa == sb, (sa, sb)
    assert sa["last_kind"] == expect_kind
    return a[1]


class TestLivePSWatcher:
    """The port's watcher and the JAX package's on one async group, fed the
    same request keys, publish the same tables poll after poll."""

    @pytest.mark.parametrize("servers,vpk,dim", [(2, 4, 96), (3, 4, 100), (2, 1, 64)])
    def test_same_tables_as_jax_poll_by_poll(self, servers, vpk, dim):
        rows = dim // vpk
        rng = np.random.default_rng(dim)
        with ServerGroup(servers, 1, dim=dim, sync=False, learning_rate=1.0) as sg, \
                KVWorker(sg.hosts, dim, sync_group=False) as kv:
            kv.push_init(rng.standard_normal(dim).astype(np.float32))
            ours, theirs = _watchers(sg.hosts, dim, vpk, 8, full_refresh_every=3)
            aligned = vpk == 1 or (dim * 1 // servers) % vpk == 0
            assert ours.vals_per_key == theirs.vals_per_key == (vpk if aligned else 1)
            assert ours.row_width == theirs.row_width == vpk

            def traffic(keys):
                keys = np.asarray(keys, np.uint64)
                ours.hot_tracker.observe(keys)
                theirs.hot_tracker.observe(keys)

            def train():  # a gradient on every flat slot: hot and cold rows move
                kv.push(rng.standard_normal(dim).astype(np.float32))

            t0 = _poll_both(ours, theirs, "full")       # no cached table yet
            hot = [1, 3, rows - 1]
            traffic(hot)
            train()
            _poll_both(ours, theirs, "full")            # coverage 0: the set was empty
            traffic(hot)
            train()
            t2 = _poll_both(ours, theirs, "hot")
            now = kv.pull()
            # hot rows are current, cold rows keep the last full pull's values
            view, fresh = t2.reshape(rows, vpk), now.reshape(rows, vpk)
            np.testing.assert_array_equal(view[hot], fresh[hot])
            cold = [r for r in range(rows) if r not in hot]
            assert not np.array_equal(view[cold], fresh[cold])
            assert not np.array_equal(t2, t0)
            traffic(hot)
            _poll_both(ours, theirs, "hot")
            traffic([0, 2, 4, 5])                       # a shift: coverage drops
            _poll_both(ours, theirs, "full")
            for kind in ("hot", "hot", "hot", "full"):  # full_refresh_every=3
                traffic([0, 2, 4, 5])
                train()
                _poll_both(ours, theirs, kind)
            st = ours.stats()
            assert (st["mode"], st["full_reloads"], st["hot_reloads"]) == ("hot", 4, 5)
            assert st["hot_set"] == theirs.stats()["hot_set"]
            ours.close()
            theirs.close()

    def test_idle_replica_reports_nothing(self):
        """With no traffic the hot set stays empty: after the first full
        pull a poll publishes nothing (no identical table re-uploaded)."""
        with ServerGroup(2, 1, dim=32, sync=False) as sg:
            with KVWorker(sg.hosts, 32) as kv:
                kv.push_init(np.arange(32, dtype=np.float32))
            ours, theirs = _watchers(sg.hosts, 32, 4, 8, full_refresh_every=0)
            _poll_both(ours, theirs, "full")
            for _ in range(3):
                _poll_both(ours, theirs, None)
            assert ours.stats() == theirs.stats()
            assert ours.stats()["full_reloads"] == 1 and ours.stats()["hot_reloads"] == 0
            ours.close()
            theirs.close()

    @pytest.mark.parametrize("servers,dim", [(2, 96), (3, 100)])
    def test_without_tracker_full_pulls_of_rows(self, servers, dim):
        init = np.linspace(-1, 1, dim).astype(np.float32)
        with ServerGroup(servers, 1, dim=dim, sync=False) as sg:
            with KVWorker(sg.hosts, dim) as kv:
                kv.push_init(init)
            ours, theirs = _watchers(sg.hosts, dim, 4, 0)
            np.testing.assert_array_equal(_poll_both(ours, theirs, "full"), init)
            assert ours.stats()["last_rows"] == dim // 4 and ours.stats()["mode"] == "full"
            ours.close()
            theirs.close()

    @pytest.mark.parametrize("kw,match", [({"min_coverage": 0.0}, "min_coverage"),
                                          ({"min_coverage": 1.5}, "min_coverage"),
                                          ({"full_refresh_every": -1}, "full_refresh_every")])
    def test_bad_refresh_options_refused_like_jax(self, kw, match):
        with ServerGroup(1, 1, dim=8) as sg:
            with pytest.raises(ValueError, match=match) as theirs:
                JaxLivePSWatcher(sg.hosts, 8, **kw)
            with pytest.raises(ValueError, match=match) as ours:
                LivePSWatcher(sg.hosts, 8, **kw)
        assert str(ours.value) == str(theirs.value)
