"""The port's durable PS store against the JAX package's, on the CPU.

* The disk formats: the port's constants equal the native header's
  ``kStore*`` / ``kWal*``; on stores the port's servers wrote (snapshot
  only, with a WAL, FTRL, two generations, two ranks) and on synthesized
  torn and corrupt files, both packages' readers give equal documents
  (``scan_rank``, ``rank_doc``, ``inspect_store`` at a fixed clock) and
  equal arrays (``read_snapshot``, ``iter_wal``), or the same error.
* Kill -9 recovery: with the WAL a SIGKILLed group comes back with every
  acknowledged push, its weights equal bit for bit to the pre-kill pull and
  to the JAX package's group fed the same pushes; without it the loss is
  bounded by the snapshot interval.
* The supervisor's store events in the JAX package's sequence for its
  three scenarios; the group's spawn flags and validations as JAX's.
* The JAX package's two disaster drills on the port's classes: a kill
  fault at an exact op, and a whole-group power loss that one retrying
  client rides.
* The coordinator endpoint (``LAYOUT`` ... ``RESTORE``, ``RESIZE``'s
  refusals and the unknown-verb text) answers JAX's JSON, and ``launch
  ps-ctl`` / ``ps-server --store-dir`` behave as JAX's.
"""

import dataclasses
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import distlr_tpu.ps.server as jax_server_mod
from distlr_tpu import launch as jax_launch
from distlr_tpu.chaos import parse_plan as jax_parse_plan
from distlr_tpu.ps import KVWorker as JaxKVWorker
from distlr_tpu.ps import ServerGroup as JaxServerGroup
from distlr_tpu.ps import ServerSupervisor as JaxServerSupervisor
from distlr_tpu.ps import membership as jax_membership
from distlr_tpu.ps import store as jax_store
from distlr_tpu_torch import launch
from distlr_tpu_torch.chaos import parse_plan
from distlr_tpu_torch.ps import KVWorker, RetryPolicy, ServerGroup, ServerSupervisor
from distlr_tpu_torch.ps import membership, store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(REPO, "distlr_tpu_torch", "ps", "native", "kv_protocol.h")
NOW = 1_900_000_000.0
LR = 0.2


def _wait(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _names(sup):
    return [e[2] for e in sup.events]


def _snap_now(group, rank=0):
    """SIGUSR1: the server writes a snapshot now."""
    os.kill(group.procs[rank].pid, signal.SIGUSR1)


def _scan(group, rank=0):
    return store.scan_rank(group.store_rank_dir(rank))


def _kv(group, dim, **kw):
    return KVWorker(group.hosts, dim, sync_group=False, timeout_ms=2000, **kw)


def _flip_last_byte(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size - 1)
        byte = f.read(1)
        f.seek(size - 1)
        f.write(bytes([byte[0] ^ 0xFF]))


# ---------------------------------------------------------------------------
# the disk formats
# ---------------------------------------------------------------------------

def _header_constants() -> dict[str, int]:
    with open(HEADER) as f:
        text = f.read()
    return {k: int(v, 0) for k, v in
            re.findall(r"constexpr uint\d+_t (k(?:Store|Wal)\w+) = (0x[0-9A-Fa-f]+|\d+);", text)}


class TestFormat:
    def test_constants_equal_the_native_header(self):
        consts = _header_constants()
        assert {
            "kStoreMagic": store.STORE_MAGIC, "kStoreVersion": store.STORE_VERSION,
            "kStoreHeaderSize": store.STORE_HEADER_SIZE,
            "kStoreGenerations": store.STORE_GENERATIONS,
            "kStoreFlagFtrl": store.STORE_FLAG_FTRL,
            "kStoreFlagInitialized": store.STORE_FLAG_INITIALIZED,
            "kWalMagic": store.WAL_MAGIC, "kWalHeaderSize": store.WAL_HEADER_SIZE,
            "kWalRecordHeaderSize": store.WAL_RECORD_HEADER_SIZE,
        } == consts

    def test_structs_and_constants_equal_jax(self):
        for name in ("STORE_MAGIC", "STORE_VERSION", "STORE_HEADER_SIZE", "STORE_GENERATIONS",
                     "STORE_FLAG_FTRL", "STORE_FLAG_INITIALIZED", "WAL_MAGIC", "WAL_HEADER_SIZE",
                     "WAL_RECORD_HEADER_SIZE"):
            assert getattr(store, name) == getattr(jax_store, name), name
        for name in ("SNAP_HEADER_STRUCT", "WAL_SEGMENT_STRUCT", "WAL_RECORD_STRUCT"):
            assert getattr(store, name).format == getattr(jax_store, name).format, name


# --- stores the port's servers write --------------------------------------

def _write_snapshot(root):
    with ServerGroup(1, 1, 8, sync=False, store_dir=root, store_interval_s=60.0) as g:
        with _kv(g, 8) as kv:
            kv.push_init(np.full(8, 1.0, np.float32))
            for _ in range(3):
                kv.push(np.full(8, 1.0, np.float32))
            _snap_now(g)
            _wait(lambda: _scan(g).snapshot_clock >= 4, what="snapshot at clock 4")
            kv.shutdown_servers()
        g.wait()


def _write_wal(root):
    rng = np.random.default_rng(3)
    with ServerGroup(1, 1, 16, sync=False, store_dir=root, store_interval_s=60.0,
                     store_wal=True, store_wal_fsync_s=0.01) as g:
        with _kv(g, 16) as kv:
            kv.push_init(rng.standard_normal(16).astype(np.float32))
            for _ in range(6):
                kv.push(rng.standard_normal(16).astype(np.float32))
            _snap_now(g)
            _wait(lambda: _scan(g).snapshot_clock >= 7, what="snapshot at clock 7")
            for _ in range(5):
                kv.push(rng.standard_normal(16).astype(np.float32))
            g.procs[0].kill()
            g.procs[0].wait()


def _write_ftrl(root):
    with ServerGroup(1, 1, 4, sync=False, optimizer="ftrl", store_dir=root,
                     store_interval_s=60.0) as g:
        with _kv(g, 4) as kv:
            kv.push_init(np.zeros(4, np.float32))
            kv.push(np.array([1.0, -2.0, 0.5, 3.0], np.float32))
            _snap_now(g)
            _wait(lambda: _scan(g).snapshot_clock >= 2, what="FTRL snapshot")
            kv.shutdown_servers()
        g.wait()


def _write_two_generations(root):
    with ServerGroup(1, 1, 4, sync=False, store_dir=root, store_interval_s=60.0) as g:
        with _kv(g, 4) as kv:
            kv.push_init(np.zeros(4, np.float32))
            _snap_now(g)
            _wait(lambda: _scan(g).snapshot_clock >= 1, what="generation 1")
            kv.push(np.full(4, 1.0, np.float32))
            _snap_now(g)
            _wait(lambda: _scan(g).snapshot_clock >= 2, what="generation 2")
            g.procs[0].kill()
            g.procs[0].wait()


def _write_two_ranks(root):
    with ServerGroup(2, 1, 10, sync=False, store_dir=root, store_interval_s=60.0,
                     store_wal=True) as g:
        with _kv(g, 10) as kv:
            kv.push_init(np.arange(10, dtype=np.float32))
            kv.push(np.ones(10, np.float32))
            for r in range(2):
                _snap_now(g, r)
            _wait(lambda: min(_scan(g, r).snapshot_clock for r in range(2)) >= 2,
                  what="both ranks' snapshots")
            kv.shutdown_servers()
        g.wait()


def _best_generation(rank_dir):
    return store.scan_rank(rank_dir).best.path


def _torn(rank_dir):
    path = _best_generation(rank_dir)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 6)


def _bad_crc(rank_dir):
    _flip_last_byte(_best_generation(rank_dir))


def _both_corrupt(rank_dir):
    for m in store.scan_rank(rank_dir).generations:
        if m.present:
            _flip_last_byte(m.path)


def _short_header(rank_dir):
    with open(_best_generation(rank_dir), "r+b") as f:
        f.truncate(12)


def _bad_magic(rank_dir):
    with open(_best_generation(rank_dir), "r+b") as f:
        f.write(b"\x00\x00\x00\x00")


def _last_segment(rank_dir):
    return store.wal_segments(rank_dir)[-1][1]


def _wal_torn_tail(rank_dir):
    path = _last_segment(rank_dir)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 10)


def _wal_torn_header(rank_dir):
    path = _last_segment(rank_dir)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - (store.WAL_RECORD_HEADER_SIZE + 16 * 12) + 7)


def _wal_bad_crc(rank_dir):
    _flip_last_byte(_last_segment(rank_dir))


def _wal_bad_segment(rank_dir):
    with open(_last_segment(rank_dir), "r+b") as f:
        f.write(b"\x01\x02\x03\x04")


#: (the writer, the corruption applied after it, or None)
STORES = {
    "snapshot": (_write_snapshot, None),
    "wal": (_write_wal, None),
    "ftrl": (_write_ftrl, None),
    "two_generations": (_write_two_generations, None),
    "two_ranks": (_write_two_ranks, None),
    "torn": (_write_two_generations, _torn),
    "bad_crc": (_write_two_generations, _bad_crc),
    "both_corrupt": (_write_two_generations, _both_corrupt),
    "short_header": (_write_two_generations, _short_header),
    "bad_magic": (_write_two_generations, _bad_magic),
    "wal_torn_tail": (_write_wal, _wal_torn_tail),
    "wal_torn_header": (_write_wal, _wal_torn_header),
    "wal_bad_crc": (_write_wal, _wal_bad_crc),
    "wal_bad_segment": (_write_wal, _wal_bad_segment),
}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Each store of STORES, written once by the port's servers."""
    out = {}
    written = {}
    for name, (writer, corrupt) in STORES.items():
        root = str(tmp_path_factory.mktemp(name))
        if writer not in written:
            writer(root)
            written[writer] = root
        else:
            shutil.copytree(written[writer], root, dirs_exist_ok=True)
        if corrupt is not None:
            corrupt(os.path.join(root, "rank-0"))
        out[name] = root
    return out


def _same_result(fn_ours, fn_theirs):
    """Both readers' results, as plain data, or both errors' texts."""
    got = []
    for fn, err in ((fn_ours, store.StoreError), (fn_theirs, jax_store.StoreError)):
        try:
            got.append(("ok", fn()))
        except err as e:
            got.append(("error", str(e)))
    assert got[0] == got[1]
    return got[0]


def _plain(x):
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if hasattr(x, "tobytes"):
        return bytes(x.tobytes())
    return x


class TestReaders:
    @pytest.mark.parametrize("name", STORES)
    def test_docs_equal_jax(self, stores, name):
        root = stores[name]
        ours = store.inspect_store(root, now=NOW)
        assert ours == jax_store.inspect_store(root, now=NOW)
        json.dumps(ours)
        for rank in ours["ranks"]:
            d = os.path.join(root, f"rank-{rank}")
            rs, jrs = store.scan_rank(d), jax_store.scan_rank(d)
            assert dataclasses.asdict(rs) == dataclasses.asdict(jrs)
            assert (rs.best is None) == (jrs.best is None)
            assert (rs.corrupt, rs.recovered_clock, rs.snapshot_clock, rs.wal_records,
                    rs.torn) == (jrs.corrupt, jrs.recovered_clock, jrs.snapshot_clock,
                                 jrs.wal_records, jrs.torn)
            assert store.rank_doc(rs, now=NOW) == jax_store.rank_doc(jrs, now=NOW)

    @pytest.mark.parametrize("name", STORES)
    def test_payloads_equal_jax(self, stores, name):
        d = os.path.join(stores[name], "rank-0")
        for path in store.snapshot_paths(d):
            _same_result(lambda: _plain(store.read_snapshot(path)),
                         lambda: _plain(jax_store.read_snapshot(path)))
        for _, path in store.wal_segments(d):
            _same_result(lambda: [_plain(r) for r in store.iter_wal(path)],
                         lambda: [_plain(r) for r in jax_store.iter_wal(path)])
            assert _plain(store.scan_wal(path)) == _plain(jax_store.scan_wal(path))

    def test_snapshot_roundtrip(self, stores):
        rs = store.scan_rank(os.path.join(stores["snapshot"], "rank-0"))
        best = rs.best
        assert best.valid and best.initialized and not best.has_ftrl
        assert (best.version, best.dim, best.push_clock) == (store.STORE_VERSION, 8, 4)
        meta, weights, z, n = store.read_snapshot(best.path)
        assert z is None and n is None
        # 1.0 init, 3 pushes of gradient 1.0 at lr 0.2
        np.testing.assert_allclose(np.asarray(weights, np.float32), 0.4, atol=1e-6)

    def test_ftrl_snapshot_carries_accumulators(self, stores):
        best = store.scan_rank(os.path.join(stores["ftrl"], "rank-0")).best
        assert best.has_ftrl
        _, _, z, n = store.read_snapshot(best.path)
        np.testing.assert_array_equal(np.asarray(n, np.float32),
                                      np.array([1.0, 4.0, 0.25, 9.0], np.float32))

    @pytest.mark.parametrize("name,why,best_clock", [
        ("torn", "torn", 1), ("bad_crc", "CRC", 1), ("short_header", "short header", 1),
        ("bad_magic", "bad magic", 1),
    ])
    def test_a_rejected_generation_falls_back_one(self, stores, name, why, best_clock):
        rs = store.scan_rank(os.path.join(stores[name], "rank-0"))
        assert rs.corrupt == 1 and rs.best.push_clock == best_clock
        bad = next(m for m in rs.generations if m.present and not m.valid)
        assert why in bad.why
        with pytest.raises(store.StoreError, match=re.escape(why)):
            store.read_snapshot(bad.path)

    def test_both_corrupt_is_never_restored(self, stores, tmp_path):
        root = str(tmp_path / "s")
        shutil.copytree(stores["both_corrupt"], root)
        rs = store.scan_rank(os.path.join(root, "rank-0"))
        assert rs.best is None and rs.corrupt == 2 and rs.recovered_clock == 0
        # a cold start on the burned store comes up empty
        with ServerGroup(1, 1, 4, sync=False, store_dir=root) as g:
            with _kv(g, 4) as kv:
                kv.push_init(np.full(4, 7.0, np.float32))
                np.testing.assert_array_equal(kv.pull(), np.full(4, 7.0, np.float32))
                kv.shutdown_servers()
            g.wait()

    def test_torn_wal_tail_is_reported_and_replay_stops_there(self, stores):
        intact = store.scan_rank(os.path.join(stores["wal"], "rank-0"))
        rs = store.scan_rank(os.path.join(stores["wal_torn_tail"], "rank-0"))
        assert rs.torn and rs.wal_records == intact.wal_records - 1
        assert rs.recovered_clock == intact.recovered_clock - 1
        assert rs.segments[-1].why == "torn record payload"

    def test_bad_segment_header_raises_on_iteration(self, stores):
        path = _last_segment(os.path.join(stores["wal_bad_segment"], "rank-0"))
        with pytest.raises(store.StoreError, match="bad segment magic"):
            list(store.iter_wal(path))

    def test_inspect_store_of_a_missing_root_raises_like_jax(self, tmp_path):
        _same_result(lambda: store.inspect_store(str(tmp_path / "none")),
                     lambda: jax_store.inspect_store(str(tmp_path / "none")))


# ---------------------------------------------------------------------------
# the group: validations and spawn flags
# ---------------------------------------------------------------------------

class _FakeProc:
    def __init__(self, cmd, **_):
        self.cmd = cmd
        self.stdout = self
        self.pid = 0

    def readline(self):
        return "PORT 1\n"

    def poll(self):
        return 0

    def wait(self, timeout=None):
        return 0

    def close(self):
        pass


class TestGroup:
    @pytest.mark.parametrize("kw", [
        {"store_wal": True},
        {"store_wal": True, "sync": True, "store_dir": "S"},
        {"store_dir": "S", "store_interval_s": 0.0},
        {"store_dir": "S", "store_wal": True, "store_wal_fsync_s": -1.0},
    ])
    def test_validations_raise_jax_texts(self, kw):
        kw = {"sync": False, **kw}
        with pytest.raises(ValueError) as ours:
            ServerGroup(1, 1, 4, **kw)
        with pytest.raises(ValueError) as theirs:
            JaxServerGroup(1, 1, dim=4, **kw)
        assert str(ours.value) == str(theirs.value)

    def test_store_rank_dir(self, tmp_path):
        assert ServerGroup(1, 1, 4, store_dir=str(tmp_path)).store_rank_dir(1) == str(
            tmp_path / "rank-1")
        with pytest.raises(ValueError, match="no store_dir"):
            ServerGroup(1, 1, 4).store_rank_dir(0)

    @pytest.mark.parametrize("kw", [
        {"store_interval_s": 5.0},
        {"store_interval_s": 0.5},
        {"store_wal": True},
        {"store_wal": True, "store_wal_fsync_s": 0.01, "store_interval_s": 60.0},
        {"store_wal": True, "optimizer": "ftrl"},
    ])
    def test_spawn_flags_equal_jax(self, kw, tmp_path, monkeypatch):
        root = str(tmp_path / "s")
        seen = []
        monkeypatch.setattr(jax_server_mod.subprocess, "Popen",
                            lambda cmd, **k: seen.append(_FakeProc(cmd)) or seen[-1])
        jg = JaxServerGroup(3, 2, 24, sync=False, binary="BIN", store_dir=root, **kw)
        jg.start()
        jg.stop()
        ours = ServerGroup(3, 2, 24, sync=False, store_dir=root, **kw)
        assert [ours._command("BIN", r) for r in range(3)] == [p.cmd for p in seen]

    def test_epoch_is_jax_default(self):
        assert ServerGroup(1, 1, 4).epoch == JaxServerGroup(1, 1, dim=4).epoch == 1

    @pytest.mark.parametrize("kw", [{"sync": True}, {"sync": False, "store_dir": "S"}])
    def test_plan_resize_refusals_equal_jax(self, kw):
        with pytest.raises(ValueError) as ours:
            ServerGroup(2, 1, 8, **kw).plan_resize(3)
        with pytest.raises(ValueError) as theirs:
            JaxServerGroup(2, 1, dim=8, **kw).plan_resize(3)
        assert str(ours.value) == str(theirs.value)

    def test_plan_resize_past_the_refusals_equals_jax(self):
        with ServerGroup(2, 1, 8, sync=False) as g, \
                JaxServerGroup(2, 1, dim=8, sync=False) as jg:
            ours, theirs = dataclasses.asdict(g.plan_resize(3)), dataclasses.asdict(jg.plan_resize(3))
        assert ours == theirs and ours["spawn"] == [1, 2]


# ---------------------------------------------------------------------------
# kill -9 recovery
# ---------------------------------------------------------------------------

def _wal_run(Group, KV, root, grads, dim):
    """Init and push ``grads`` into a 2-rank async WAL group, pull, SIGKILL
    every rank, scan the store, restart on it, pull: (before, scans,
    after)."""
    with Group(2, 1, dim, sync=False, store_dir=root, store_interval_s=60.0, store_wal=True,
               store_wal_fsync_s=0.01) as g:
        with KV(g.hosts, dim, sync_group=False, timeout_ms=2000) as kv:
            kv.push_init(grads[0])
            for gr in grads[1:]:
                kv.push(gr)
            before = kv.pull()
            for p in g.procs:
                p.kill()
                p.wait()
    # before the restart, which snapshots its recovery and starts a new segment
    scans = [store.scan_rank(os.path.join(root, f"rank-{r}")) for r in range(2)]
    with Group(2, 1, dim, sync=False, store_dir=root, store_wal=True) as g:
        with KV(g.hosts, dim, sync_group=False, timeout_ms=2000) as kv:
            after = kv.pull()
            kv.shutdown_servers()
        g.wait()
    return before, scans, after


class TestKillNineRecovery:
    def test_wal_rpo_is_zero_and_equals_jax_bit_for_bit(self, tmp_path):
        dim, pushes = 48, 8
        rng = np.random.default_rng(11)
        grads = [rng.standard_normal(dim).astype(np.float32) for _ in range(1 + pushes)]
        before, scans, after = _wal_run(ServerGroup, KVWorker, str(tmp_path / "ours"), grads,
                                        dim)
        assert after.tobytes() == before.tobytes()
        for rs in scans:
            assert rs.recovered_clock == 1 + pushes and rs.wal_records == 1 + pushes
        jbefore, _, jafter = _wal_run(JaxServerGroup, JaxKVWorker, str(tmp_path / "jax"), grads,
                                      dim)
        assert jafter.tobytes() == after.tobytes() and jbefore.tobytes() == before.tobytes()

    def test_snapshot_only_rpo_bounded_by_interval(self, tmp_path):
        interval = 0.2
        with ServerGroup(1, 1, 8, sync=False, store_dir=str(tmp_path),
                         store_interval_s=interval) as g:
            with _kv(g, 8) as kv:
                kv.push_init(np.zeros(8, np.float32))
                ack_times = []
                for _ in range(30):
                    kv.push(np.full(8, 1.0, np.float32))
                    ack_times.append(time.monotonic())
                    time.sleep(0.02)
                t_kill = time.monotonic()
                g.procs[0].kill()
                g.procs[0].wait()
        rs = store.scan_rank(str(tmp_path / "rank-0"))
        lost = max(0, 1 + len(ack_times) - rs.recovered_clock)
        window = 2.0 * interval  # one interval and one of the writer's slack
        in_window = sum(1 for t in ack_times if t_kill - t <= window)
        assert lost <= in_window + 1, f"lost {lost}; {in_window} acks in the last {window} s"
        assert rs.corrupt == 0 and rs.wal_records == 0


# ---------------------------------------------------------------------------
# the supervisor's store events
# ---------------------------------------------------------------------------

def _sup_disk_ahead(Group, Sup, KV, root):
    with Group(1, 1, 8, sync=False, store_dir=root, store_interval_s=60.0, store_wal=True,
               store_wal_fsync_s=0.01) as g:
        with Sup(g, poll_interval=0.05, snapshot_interval=30.0) as sup:
            kv = KV(g.hosts, 8, sync_group=False, timeout_ms=2000)
            kv.push_init(np.zeros(8, np.float32))
            for _ in range(6):
                kv.push(np.full(8, 1.0, np.float32))
            kv.close()
            pid0 = g.procs[0].pid
            g.procs[0].kill()
            _wait(lambda: g.procs[0].pid != pid0 and g.procs[0].poll() is None, what="respawn")
            _wait(lambda: "reseeded-from-store" in _names(sup), what="reseeded-from-store")
            with KV(g.hosts, 8, sync_group=False, timeout_ms=2000) as kv2:
                np.testing.assert_allclose(kv2.pull(), -LR * 6, atol=1e-5)
        return [e[1:] for e in sup.events]


def _sup_store_stale(Group, Sup, KV, root):
    with Group(1, 1, 8, sync=False, store_dir=root, store_interval_s=600.0) as g:
        with Sup(g, poll_interval=0.05, snapshot_interval=0.1) as sup:
            kv = KV(g.hosts, 8, sync_group=False, timeout_ms=2000)
            kv.push_init(np.zeros(8, np.float32))
            for _ in range(3):
                kv.push(np.full(8, 1.0, np.float32))
            os.kill(g.procs[0].pid, signal.SIGUSR1)  # the disk at clock 4
            _wait(lambda: store.scan_rank(g.store_rank_dir(0)).snapshot_clock >= 4,
                  what="disk at 4")
            for _ in range(8):
                kv.push(np.full(8, 1.0, np.float32))
            kv.close()
            time.sleep(0.4)  # the RAM snapshot overtakes the disk
            pid0 = g.procs[0].pid
            g.procs[0].kill()
            _wait(lambda: g.procs[0].pid != pid0 and g.procs[0].poll() is None, what="respawn")
            _wait(lambda: "reseeded" in _names(sup), what="the RAM re-seed")
        return [e[1:] for e in sup.events]


def _sup_corrupt(Group, Sup, KV, root):
    with Group(1, 1, 8, sync=False, store_dir=root, store_interval_s=60.0) as g:
        kv = KV(g.hosts, 8, sync_group=False, timeout_ms=2000)
        kv.push_init(np.zeros(8, np.float32))
        # the supervisor's first capture sees the initialized rank, so its
        # re-seed after the corrupt recovery is the RAM snapshot's
        with Sup(g, poll_interval=0.05, snapshot_interval=30.0) as sup:
            _wait(lambda: sup._snap_valid[0], what="the first capture")
            kv.push(np.full(8, 1.0, np.float32))
            os.kill(g.procs[0].pid, signal.SIGUSR1)
            _wait(lambda: store.scan_rank(g.store_rank_dir(0)).snapshot_clock >= 2,
                  what="snapshot")
            kv.close()
            best = store.scan_rank(g.store_rank_dir(0)).best
            pid0 = g.procs[0].pid
            g.procs[0].kill()
            g.procs[0].wait()
            _flip_last_byte(best.path)
            _wait(lambda: g.procs[0].pid != pid0 and g.procs[0].poll() is None, what="respawn")
            _wait(lambda: len(sup.events) >= 3, what="the re-seed")
        return [e[1:] for e in sup.events]


class TestSupervisorStoreEvents:
    @pytest.mark.parametrize("scenario,want", [
        (_sup_disk_ahead, [(0, "respawned"), (0, "reseeded-from-store")]),
        (_sup_store_stale, [(0, "respawned"), (0, "store-stale"), (0, "reseeded")]),
        (_sup_corrupt, [(0, "respawned"), (0, "store-corrupt-fallback"), (0, "reseeded")]),
    ], ids=["disk_ahead", "store_stale", "corrupt"])
    def test_events_in_jax_sequence(self, scenario, want, tmp_path):
        ours = scenario(ServerGroup, ServerSupervisor, KVWorker, str(tmp_path / "ours"))
        theirs = scenario(JaxServerGroup, JaxServerSupervisor, JaxKVWorker,
                          str(tmp_path / "jax"))
        assert ours == theirs == want

    def test_store_health_by_rank(self, tmp_path):
        with ServerGroup(2, 1, 8, sync=False, store_dir=str(tmp_path), store_interval_s=0.1,
                         store_wal=True) as g:
            with ServerSupervisor(g, poll_interval=0.05, snapshot_interval=0.1) as sup:
                with _kv(g, 8) as kv:
                    kv.push_init(np.zeros(8, np.float32))
                    kv.push(np.ones(8, np.float32))
                _wait(lambda: len(sup.store_health) == 2
                      and all(h["snapshot_age_s"] is not None
                              for h in sup.store_health.values()), what="store health")
                h = sup.store_health[0]
        assert h["snapshot_bytes"] > 0 and h["wal_bytes"] > 0
        assert h["corrupt_generations"] == 0 and h["wal_lag_records"] >= 0


# ---------------------------------------------------------------------------
# the disaster drills
# ---------------------------------------------------------------------------

class TestDisasterDrill:
    def test_after_ops_kill_fires_at_exact_op_and_rank_recovers(self, tmp_path):
        plan = parse_plan({"faults": [
            {"kind": "kill", "links": [0], "target": "rank:0", "after_ops": 4}]})
        with ServerGroup(1, 1, 8, sync=False, via_chaos=plan, store_dir=str(tmp_path),
                         store_interval_s=60.0, store_wal=True, store_wal_fsync_s=0.01) as g:
            with ServerSupervisor(g, poll_interval=0.05, snapshot_interval=30.0) as sup:
                pid0 = g.procs[0].pid
                kv = _kv(g, 8)
                kv.push_init(np.zeros(8, np.float32))  # op 1
                acked = 0
                with pytest.raises(OSError):
                    for _ in range(10):
                        kv.push(np.full(8, 1.0, np.float32))
                        acked += 1
                        time.sleep(0.02)
                kv.close()
                kills = [e for e in g.chaos.events() if e[1] == "kill"]
                assert len(kills) == 1
                detail = dict(kills[0][2:])
                assert detail["op"] == 4 and detail["target"] == "rank:0"
                _wait(lambda: g.procs[0].pid != pid0 and g.procs[0].poll() is None,
                      what="respawn")
                _wait(lambda: "reseeded-from-store" in _names(sup), what="reseed audit")
                # the op-4 push raced the SIGKILL: applied may run one ahead
                applied = _scan(g).recovered_clock - 1
                assert acked <= applied <= acked + 1
                with _kv(g, 8) as kv2:
                    np.testing.assert_allclose(kv2.pull(), -LR * applied, atol=1e-5)

    def test_whole_group_power_loss_client_resumes(self, tmp_path):
        """A 2-rank async WAL group SIGKILLed whole by a time-triggered
        kill; the supervisor restarts every rank from the store and the
        same retrying client carries on.  The recovered clocks cover every
        server-acknowledged push before the cut; each client-acknowledged
        push lands once, less those the retry policy absorbed
        (``push_outcome_unknown``)."""
        plan = parse_plan({"faults": [{"kind": "kill", "target": "group", "at_s": 0.5}]})
        grad = 0.1
        with ServerGroup(2, 1, 32, sync=False, via_chaos=plan, store_dir=str(tmp_path),
                         store_interval_s=0.5, store_wal=True, store_wal_fsync_s=0.01) as g:
            with ServerSupervisor(g, poll_interval=0.05, snapshot_interval=0.5) as sup:
                pids = [p.pid for p in g.procs]
                kv = _kv(g, 32, retry=RetryPolicy(attempts=10, backoff_ms=50))
                kv.push_init(np.zeros(32, np.float32))
                acked = unknown = 0

                def kills():
                    return [e for e in g.chaos.events() if e[1] == "kill"]

                def push_until(done, budget_s):
                    nonlocal acked, unknown
                    deadline = time.monotonic() + budget_s
                    while not done() and time.monotonic() < deadline:
                        try:
                            kv.push(np.full(32, grad, np.float32))
                            acked += 1
                        except OSError:
                            unknown += 1
                            time.sleep(0.05)
                        time.sleep(0.005)

                push_until(kills, 10.0)
                assert kills(), "the time-triggered kill never fired"
                survived, absorbed_at_cut = acked, kv.push_outcome_unknown
                _wait(lambda: all(p.pid != old and p.poll() is None
                                  for p, old in zip(g.procs, pids)), what="every respawn")
                clocks = [_scan(g, r).recovered_clock for r in range(2)]
                assert min(clocks) >= 1 + survived - absorbed_at_cut, clocks
                push_until(lambda: acked >= survived + 20, 10.0)
                kv.close()
                assert len(kills()) == 1 and dict(kills()[0][2:])["target"] == "group"
                assert acked >= survived + 20, f"{acked} acks, {unknown} unknown"
                assert "reseeded-from-store" in _names(sup)
                absorbed = kv.push_outcome_unknown
                with _kv(g, 32) as kv2:
                    w = kv2.pull()
        lo = -LR * grad * (acked + unknown) - 1e-4
        hi = -LR * grad * (acked - absorbed) + 1e-4
        assert np.all(w >= lo) and np.all(w <= hi), (w[0], lo, hi)
        for r in range(2):
            sl = w[slice(*g.key_range(r))]
            assert np.allclose(sl, sl[0], atol=1e-5), f"rank {r}'s slice is not uniform"


# ---------------------------------------------------------------------------
# the coordinator endpoint and the CLI
# ---------------------------------------------------------------------------

def _store_summary(doc: dict) -> dict:
    """What a ``STORE`` reply says of each rank once its snapshot landed
    (the documents themselves are held to JAX's in :class:`TestReaders`)."""
    return {"ok": doc["ok"], "ranks": {
        r: (d["recovered_clock"], d["snapshot_clock"], d["corrupt_generations"],
            d["wal"]["records"], d["dim"]) for r, d in doc["ranks"].items()}}


def _ctl_answers(Group, KV, Coord, Server, root, **group_kw):
    """The coordinator's reply to each verb over TCP, the group's ports
    masked out, and the weights after ``RESTORE``."""
    with Group(2, 1, 8, store_dir=root, **group_kw) as g:
        with KV(g.hosts, 8, sync_group=False, timeout_ms=2000) as kv:
            kv.push_init(np.ones(8, np.float32))
        with Server(Coord(g)) as srv:
            addr = f"127.0.0.1:{srv.port}"
            out = {}
            for line in ("LAYOUT", "STATUS", "RESIZE 2", "RESIZE 3", "RESIZE 2 wait=0",
                         "SNAPSHOT"):
                out[line] = membership.ctl_request(addr, line)
            _wait(lambda: all(store.scan_rank(g.store_rank_dir(r)).snapshot_clock >= 1
                              for r in range(2)), what="the snapshots")
            out["STORE"] = _store_summary(membership.ctl_request(addr, "STORE"))
            for line in ("RESTORE", "status", "RESIZE x", "FLY me", "LAYOUT extra"):
                out[line] = membership.ctl_request(addr, line)
            with KV(g.hosts, 8, sync_group=False, timeout_ms=2000) as kv:
                out["pull after RESTORE"] = kv.pull().tolist()
    return json.loads(re.sub(r"127\.0\.0\.1:\d+", "H", json.dumps(out)))


class TestCoordinator:
    def test_verbs_answer_jax_json(self, tmp_path):
        kw = dict(sync=False, store_interval_s=60.0, store_wal=True)
        ours = _ctl_answers(ServerGroup, KVWorker, membership.MembershipCoordinator,
                            membership.MembershipServer, str(tmp_path / "a"), **kw)
        theirs = _ctl_answers(JaxServerGroup, JaxKVWorker, jax_membership.MembershipCoordinator,
                              jax_membership.MembershipServer, str(tmp_path / "b"), **kw)
        assert ours == theirs
        assert ours["RESIZE 3"]["ok"] is False and "durable" in ours["RESIZE 3"]["error"]
        assert ours["FLY me"]["error"].startswith("unknown command 'FLY me'")
        assert ours["pull after RESTORE"] == [1.0] * 8

    def test_sync_group_refusal_equals_jax(self, tmp_path):
        answers = []
        for Group, Coord in ((ServerGroup, membership.MembershipCoordinator),
                             (JaxServerGroup, jax_membership.MembershipCoordinator)):
            with Group(2, 1, 8, sync=True) as g:
                srv = (membership.MembershipServer if Coord is membership.MembershipCoordinator
                       else jax_membership.MembershipServer)(Coord(g))
                answers.append([srv.handle_line(v) for v in ("RESIZE 4", "STORE", "SNAPSHOT")])
                srv.stop()
        assert answers[0] == answers[1]

    def test_live_resize_and_layout_client_follow_jax(self):
        """``RESIZE 3`` and ``RESIZE 3 wait=0`` reshard the group as JAX's
        coordinator does; ``layout_client`` reads the new layout."""
        for ms, group_cls in ((membership, ServerGroup), (jax_membership, JaxServerGroup)):
            with group_cls(2, 1, 8, sync=False) as g:
                coord = ms.MembershipCoordinator(g)
                srv = ms.MembershipServer(coord).start()
                try:
                    done = json.loads(srv.handle_line("RESIZE 3"))
                    assert (done["ok"], done["epoch"], done["num_servers"]) == (True, 2, 3)
                    accepted = json.loads(srv.handle_line("RESIZE 2 wait=0"))
                    assert accepted == {"ok": True, "accepted": True, "target": 2, "epoch": 2}
                    deadline = time.monotonic() + 10
                    while coord.status()["epoch"] != 3 and time.monotonic() < deadline:
                        time.sleep(0.01)
                    lay = ms.layout_client(f"127.0.0.1:{srv.port}")()
                    assert (lay["epoch"], lay["num_servers"], lay["hosts"]) == (3, 2, g.hosts)
                finally:
                    srv.stop()

    def test_ctl_request_rejects_a_bad_address_like_jax(self):
        for fn in (membership.ctl_request, jax_membership.ctl_request):
            with pytest.raises(ValueError, match="ps-ctl address must be host:port"):
                fn("nohost", "LAYOUT")


class TestCLI:
    def test_ps_ctl_store_offline_prints_jax_json(self, stores, capsys, monkeypatch):
        monkeypatch.setattr(time, "time", lambda: NOW)
        lines = []
        for main in (launch.main, jax_launch.main):
            assert main(["ps-ctl", "store", "--store-dir", stores["two_ranks"]]) == 0
            lines.append([ln for ln in capsys.readouterr().out.splitlines()
                          if ln.startswith("PSCTL ")])
        assert lines[0] == lines[1] and len(lines[0]) == 1

    @pytest.mark.parametrize("argv,code", [
        (["ps-ctl", "status"], 2), (["ps-ctl", "--ctl", "127.0.0.1:9", "resize"], 2),
        (["ps-ctl", "--ctl", "127.0.0.1:9", "resize", "0"], 2),
        (["ps-ctl", "--ctl", "nohost", "status"], 1),
    ])
    def test_ps_ctl_errors_exit_like_jax(self, argv, code, capsys, tmp_path):
        errs = []
        for main in (launch.main, jax_launch.main):
            assert main(argv) == code
            errs.append(capsys.readouterr().err.strip())
        assert errs[0] == errs[1]

    def test_ps_ctl_store_missing_dir_exits_1_like_jax(self, capsys, tmp_path):
        errs = []
        for main in (launch.main, jax_launch.main):
            assert main(["ps-ctl", "store", "--store-dir", str(tmp_path / "none")]) == 1
            errs.append(capsys.readouterr().err.strip())
        assert errs[0] == errs[1]

    def test_ps_server_store_chain(self, tmp_path, capsys):
        """``launch ps-server --async --store-dir --store-wal`` prints HOSTS
        and PSCTL; ``ps-ctl`` snapshot, store and resize answer; after
        SIGTERM a restart on the directory serves the same weights."""
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        root = str(tmp_path / "s")
        argv = [sys.executable, "-m", "distlr_tpu_torch.launch", "ps-server",
                "--num-feature-dim", "16", "--num-servers", "2", "--async", "--store-dir", root,
                "--store-wal", "--store-wal-fsync", "0.01"]

        def start():
            proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.DEVNULL, text=True)
            hosts = proc.stdout.readline().split()
            ctl = proc.stdout.readline().split()
            assert hosts[0] == "HOSTS" and ctl[0] == "PSCTL", (hosts, ctl)
            return proc, hosts[1], ctl[1].replace("0.0.0.0", "127.0.0.1")

        def ctl(addr, *cmd):
            code = launch.main(["ps-ctl", "--ctl", addr, *cmd])
            line = next(ln for ln in capsys.readouterr().out.splitlines()
                        if ln.startswith("PSCTL "))
            return code, json.loads(line[len("PSCTL "):])

        proc, hosts, addr = start()
        try:
            with KVWorker(hosts, 16, sync_group=False, timeout_ms=2000) as kv:
                kv.push_init(np.arange(16, dtype=np.float32))
                kv.push(np.ones(16, np.float32))
                before = kv.pull()
            assert ctl(addr, "snapshot") == (0, {"ok": True, "signalled": 2, "num_servers": 2})
            code, doc = ctl(addr, "store")
            assert code == 0 and sorted(doc["ranks"]) == ["0", "1"]
            assert all(r["recovered_clock"] == 2 for r in doc["ranks"].values())
            code, doc = ctl(addr, "resize", "3")
            assert code == 3 and "durable (store_dir) group" in doc["error"]
        finally:
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 143
        proc, hosts, addr = start()
        try:
            with KVWorker(hosts, 16, sync_group=False, timeout_ms=2000) as kv:
                assert kv.pull().tobytes() == before.tobytes()
        finally:
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 143


def test_kill_plan_parses_like_jax():
    doc = {"faults": [{"kind": "kill", "target": "group", "at_s": 0.5},
                      {"kind": "kill", "links": [0], "target": "rank:0", "after_ops": 4}]}
    assert dataclasses.asdict(parse_plan(doc)) == dataclasses.asdict(jax_parse_plan(doc))
