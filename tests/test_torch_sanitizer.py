"""The port's native sanitizer matrix (``distlr_tpu_torch/ps/build.py``),
held to the JAX package's, case for case: ``tests/test_sanitizer_matrix.py``
and ``tests/test_ps_tsan.py``.

``DISTLR_NATIVE_VARIANT={tsan,asan,ubsan}`` routes every ``ServerGroup``
spawn of the port (the start, a supervisor's respawn, a resize's spawns)
and, for tsan, its ctypes client onto instrumented builds of the port's
own copies of the native sources.  The e2e cases run a workload script that
imports only ``distlr_tpu_torch.ps`` in a subprocess (the TSan client
needs the runtime preloaded) and fail on any report file or a nonzero
exit; the group cases drive the TSan server in this process through
``ServerGroup(binary=...)``; the ``slow`` cases run the port's chaos and
elastic suites under the TSan pair.  The refusals and
``sanitizer_environ`` are compared with the JAX package's on the same
inputs.
"""

from __future__ import annotations

import glob
import os
import shutil
import signal
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

from distlr_tpu.ps import build as jax_build
from distlr_tpu_torch.ps import KVWorker, MembershipCoordinator, ServerGroup, ServerSupervisor
from distlr_tpu_torch.ps import build
from distlr_tpu_torch.ps import client as ps_client
from distlr_tpu_torch.ps.client import PSRejectedError

REPO = Path(__file__).resolve().parents[1]

needs_toolchain = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


def _libtsan() -> str | None:
    """The TSan runtime's path, or None when the toolchain lacks it."""
    if shutil.which("g++") is None:
        return None
    out = subprocess.run(["g++", "-print-file-name=libtsan.so"],
                         capture_output=True, text=True).stdout.strip()
    return out if os.path.sep in out and os.path.exists(out) else None


def _reports(log_base: str) -> list[str]:
    return [Path(f).read_text() for f in glob.glob(log_base + ".*")]


# ---------------------------------------------------------------------------
# e2e: a workload subprocess under each variant
# ---------------------------------------------------------------------------

#: concurrent clients (one handle a thread), pushes, pulls, fused ops,
#: stats probes and an in-place reconnect a thread: the client library's
#: reader and retry surface under whichever sanitizer is active
_WORKLOAD = textwrap.dedent("""
    import threading
    import numpy as np
    from distlr_tpu_torch.ps import KVWorker, ServerGroup

    dim, workers, steps = 64, 3, 15
    errors = []
    with ServerGroup(2, workers, dim, learning_rate=0.1, sync=False) as group:
        def run(rank):
            with KVWorker(group.hosts, dim, client_id=rank, timeout_ms=60_000,
                          sync_group=False) as kv:
                if rank == 0:
                    kv.push_init(np.zeros(dim, np.float32))
                kv.barrier(0)
                for i in range(steps):
                    w = kv.pull()
                    if i % 3 == 0:
                        kv.push_pull(w * 0.01 + 1.0)
                    else:
                        kv.push(w * 0.01 + 1.0)
                    if i == steps // 2:
                        kv.reconnect()
                    kv.stats(rank % 2)
                kv.barrier(1)
                if rank == 0:
                    kv.shutdown_servers()

        def guarded(rank):
            try:
                run(rank)
            except Exception as e:
                errors.append(e)
                group.stop()

        ts = [threading.Thread(target=guarded, args=(r,), daemon=True) for r in range(workers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errors, errors[0]
        assert not any(t.is_alive() for t in ts), "worker wedged"
        group.wait()
        assert [p.returncode for p in group.procs] == [0, 0], [p.returncode for p in group.procs]
        assert all("_%s-" % VARIANT in p.args[0] for p in group.procs), group.procs[0].args
    print("WORKLOAD_OK")
""")

#: the durable store's snapshot thread and WAL commit thread beside the op
#: threads, SIGUSR1 snapshots landing mid-append, then a SIGKILL and a
#: respawn whose recovery (snapshot load, WAL replay) runs instrumented
_STORE_WORKLOAD = textwrap.dedent("""
    import os
    import signal
    import threading
    import numpy as np
    from distlr_tpu_torch.ps import KVWorker, ServerGroup

    dim, workers, steps = 64, 3, 15
    store = os.path.abspath("store")
    errors = []
    with ServerGroup(2, workers, dim, learning_rate=0.1, sync=False, store_dir=store,
                     store_interval_s=0.1, store_wal=True, store_wal_fsync_s=0.02) as group:
        def run(rank):
            with KVWorker(group.hosts, dim, client_id=rank, timeout_ms=60_000,
                          sync_group=False) as kv:
                if rank == 0:
                    kv.push_init(np.zeros(dim, np.float32))
                kv.barrier(0)
                for i in range(steps):
                    w = kv.pull()
                    kv.push(w * 0.01 + 1.0)
                    if i == steps // 2 and rank == 0:
                        for p in group.procs:
                            os.kill(p.pid, signal.SIGUSR1)
                    kv.stats(rank % 2)
                kv.barrier(1)

        def guarded(rank):
            try:
                run(rank)
            except Exception as e:
                errors.append(e)
                group.stop()

        ts = [threading.Thread(target=guarded, args=(r,), daemon=True) for r in range(workers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errors, errors[0]
        assert not any(t.is_alive() for t in ts), "worker wedged"
        group.procs[0].kill()
        group.procs[0].wait()
        assert group.respawn(0)
        assert "_%s-" % VARIANT in group.procs[0].args[0], group.procs[0].args
        with KVWorker(group.hosts, dim, client_id=9, timeout_ms=60_000, sync_group=False) as kv:
            assert kv.pull().shape == (dim,)
            kv.shutdown_servers()
        group.wait()
        assert [p.returncode for p in group.procs] == [0, 0], [p.returncode for p in group.procs]
    print("WORKLOAD_OK")
""")

_OPTS_VAR = {"tsan": "TSAN_OPTIONS", "asan": "ASAN_OPTIONS", "ubsan": "UBSAN_OPTIONS"}


def _run_variant(variant: str, tmp_path, *, preload: str | None = None,
                 workload_src: str = _WORKLOAD, timeout: int = 120) -> None:
    """Build the variant's artifacts, run ``workload_src`` under it in a
    fresh interpreter (the port's PS package only: no host suppressions),
    and fail on any report or a nonzero exit."""
    build.server_binary(variant)
    script = tmp_path / "workload.py"
    script.write_text(f"VARIANT = {variant!r}\n" + workload_src)
    log_base = str(tmp_path / f"{variant}_report")
    env = os.environ.copy()
    env.pop("LD_PRELOAD", None)
    env["DISTLR_NATIVE_VARIANT"] = variant
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # exitcode=66 marks a reporting process; log_path makes every report
    # a file to scan
    env[_OPTS_VAR[variant]] = f"log_path={log_base} exitcode=66"
    if preload:
        env["LD_PRELOAD"] = preload
    proc = subprocess.run([sys.executable, str(script)], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=timeout)
    reports = _reports(log_base)
    assert not reports, f"{variant} reports:\n" + "\n".join(reports)
    assert proc.returncode == 0 and "WORKLOAD_OK" in proc.stdout, (
        f"{variant} workload rc={proc.returncode}\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")


@needs_toolchain
@pytest.mark.parametrize("variant", ["asan", "ubsan"])
def test_server_variant_e2e(variant, tmp_path):
    _run_variant(variant, tmp_path)


@needs_toolchain
def test_tsan_client_and_server_e2e(tmp_path):
    """The port's client library itself under TSan, against the TSan
    server, in one workload."""
    rt = _libtsan()
    if rt is None:
        pytest.skip("toolchain has no libtsan runtime")
    _run_variant("tsan", tmp_path, preload=rt)


@needs_toolchain
def test_tsan_server_store_e2e(tmp_path):
    """The durable store's snapshot and WAL threads under TSan, SIGUSR1
    snapshots racing WAL appends, then a SIGKILL and a respawn on the same
    variant whose recovery runs instrumented too."""
    rt = _libtsan()
    if rt is None:
        pytest.skip("toolchain has no libtsan runtime")
    _run_variant("tsan", tmp_path, preload=rt, workload_src=_STORE_WORKLOAD)


# ---------------------------------------------------------------------------
# every spawn of a group on the variant, with its options
# ---------------------------------------------------------------------------


def _wait_for(cond, timeout_s: float) -> None:
    """Poll ``cond()`` every 25 ms for at most ``timeout_s``."""
    stop = threading.Event()
    for _ in range(int(timeout_s / 0.025)):
        if cond():
            return
        stop.wait(0.025)


def _spawn_env(proc) -> dict:
    """A running server's environment, from ``/proc/<pid>/environ``."""
    raw = Path(f"/proc/{proc.pid}/environ").read_bytes()
    return dict(kv.split("=", 1) for kv in raw.decode().split("\0") if "=" in kv)


@needs_toolchain
def test_every_spawn_runs_the_groups_variant(monkeypatch, tmp_path):
    """Under asan the start, a supervisor's respawn and a resize's spawns
    all run the asan build with ``sanitizer_environ()``'s options, and a
    variant changed after the group was made reaches none of them; with
    the variable unset the group runs the standard build and inherits the
    environment."""
    log_base = str(tmp_path / "asan")
    monkeypatch.setenv("DISTLR_NATIVE_VARIANT", "asan")
    monkeypatch.setenv("ASAN_OPTIONS", f"log_path={log_base} exitcode=66")
    dim = 64
    asan = build.server_binary("asan")
    group = ServerGroup(2, 1, dim, sync=False)
    monkeypatch.setenv("DISTLR_NATIVE_VARIANT", "ubsan")  # too late for this group
    with group:
        assert group.variant == "asan" and group.binary == asan
        with ServerSupervisor(group, poll_interval=0.05, snapshot_interval=0.05) as sup:
            coord = MembershipCoordinator(group, supervisor=sup)
            with KVWorker(None, dim, sync_group=False, route=coord.layout) as kv:
                kv.push_init(np.arange(dim, dtype=np.float32))
                threading.Event().wait(0.3)  # a few snapshot cycles past the seed
                group.procs[1].kill()
                _wait_for(lambda: (1, "reseeded") in [(r, ev) for _, r, ev in sup.events], 10.0)
                assert coord.resize(4)["ok"]
                np.testing.assert_array_equal(kv.pull(), np.arange(dim, dtype=np.float32))
        assert len(group.procs) == 4
        for proc in group.procs:
            assert proc.args[0] == str(asan)
            opts = _spawn_env(proc)["ASAN_OPTIONS"].split()
            assert f"log_path={log_base}" in opts and "detect_leaks=0" in opts
            assert f"suppressions={build.NATIVE_DIR / 'asan.supp'}" in opts
        with KVWorker(group.hosts, dim, sync_group=False) as kv:
            kv.shutdown_servers()
        group.wait()
        assert [p.returncode for p in group.procs] == [0] * 4
    assert _reports(log_base) == []
    monkeypatch.delenv("DISTLR_NATIVE_VARIANT")
    monkeypatch.delenv("ASAN_OPTIONS")
    with ServerGroup(1, 1, dim, sync=False) as plain:
        assert plain.variant == "" and plain.procs[0].args[0] == str(build.server_binary(""))
        assert "ASAN_OPTIONS" not in _spawn_env(plain.procs[0])


@needs_toolchain
def test_client_library_follows_the_variant(monkeypatch):
    """asan and ubsan keep the standard client; tsan refuses without the
    runtime preloaded even after the standard client was loaded in this
    process (the loaded library is kept per variant)."""
    monkeypatch.delenv("DISTLR_NATIVE_VARIANT", raising=False)
    standard = build.client_lib()
    ps_client._load()
    for v in ("asan", "ubsan"):
        monkeypatch.setenv("DISTLR_NATIVE_VARIANT", v)
        assert build.client_lib() == standard
    monkeypatch.setenv("DISTLR_NATIVE_VARIANT", "tsan")
    monkeypatch.delenv("LD_PRELOAD", raising=False)
    with pytest.raises(RuntimeError, match="LD_PRELOAD"):
        ps_client._load()
    monkeypatch.setenv("LD_PRELOAD", "/x/libtsan.so.2")
    tsan = build.client_lib()
    assert tsan != standard and tsan.name.startswith("libdistlr_torch_kv_tsan-")


@needs_toolchain
def test_build_sanitizers_builds_the_matrix():
    """``python -m distlr_tpu_torch.ps.build sanitizers`` builds the
    standard pair and every variant, each its own hashed artifact."""
    proc = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.ps.build", "sanitizers"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    paths = dict(line.split(": ", 1) for line in proc.stdout.splitlines() if ": " in line)
    assert set(paths) == {"server", "client", "client_tsan", "server_tsan", "server_asan",
                          "server_ubsan"}
    assert len(set(paths.values())) == 6 and all(Path(p).exists() for p in paths.values())
    assert paths["server_asan"] == str(build.server_binary("asan"))
    bad = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.ps.build"], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert bad.returncode == 2 and "sanitizers" in bad.stderr


# ---------------------------------------------------------------------------
# refusals and options, against the JAX package's
# ---------------------------------------------------------------------------


@needs_toolchain
def test_tsan_client_requires_preload(monkeypatch):
    """Without the runtime preloaded both packages refuse with the same
    instruction."""
    monkeypatch.setenv("DISTLR_NATIVE_VARIANT", "tsan")
    monkeypatch.delenv("LD_PRELOAD", raising=False)
    texts = []
    for mod in (build, jax_build):
        with pytest.raises(RuntimeError, match="LD_PRELOAD") as info:
            mod.client_lib()
        texts.append(str(info.value))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("value", ["valgrind", "msan", "TSAN2"])
def test_bogus_variant_rejected(monkeypatch, value):
    monkeypatch.setenv("DISTLR_NATIVE_VARIANT", value)
    texts = []
    for mod in (build, jax_build):
        with pytest.raises(ValueError, match="DISTLR_NATIVE_VARIANT") as info:
            mod.native_variant()
        texts.append(str(info.value))
    assert texts[0] == texts[1]
    with pytest.raises(ValueError, match="DISTLR_NATIVE_VARIANT"):
        ServerGroup(1, 1, 8)


@pytest.mark.parametrize("value,expect", [("", ""), ("none", ""), (" NONE ", ""),
                                          ("Tsan", "tsan"), (" asan", "asan"),
                                          ("UBSAN", "ubsan")])
def test_variant_names_as_jax(monkeypatch, value, expect):
    monkeypatch.setenv("DISTLR_NATIVE_VARIANT", value)
    assert build.native_variant() == jax_build.native_variant() == expect


_ENVIRON_CASES = {
    "empty": {},
    "host_noise": {"log_path=/tmp/x exitcode=66 report_mutex_bugs=0 "
                   "suppressions=/tmp/host_noise.supp": None},
    "colon_joined": {"log_path=/tmp/x:report_mutex_bugs=0:suppressions=/tmp/h.supp:halt_on_error=1":
                     None},
    "leaks_set": {"detect_leaks=1 log_path=/tmp/y": None},
    "tabs_and_newlines": {"exitcode=66\tlog_path=/tmp/z\nverbosity=1  ": None},
}


@pytest.mark.parametrize("variant", ["tsan", "asan", "ubsan"])
@pytest.mark.parametrize("case", list(_ENVIRON_CASES))
def test_sanitizer_environ_matches_jax(monkeypatch, variant, case):
    """Both packages' ``sanitizer_environ`` on the same environment give
    the same options, but for the suppression file's path (each its own
    package's checked-in file); the standard build gives None in both."""
    var = _OPTS_VAR[variant]
    base = {"PATH": "/usr/bin", "OTHER": "1"}
    for opts in _ENVIRON_CASES[case]:
        base[var] = opts
    monkeypatch.setenv("DISTLR_NATIVE_VARIANT", variant)
    ours, theirs = build.sanitizer_environ(dict(base)), jax_build.sanitizer_environ(dict(base))
    supp_ours = f"suppressions={build.NATIVE_DIR / f'{variant}.supp'}"
    supp_theirs = f"suppressions={os.path.join(jax_build.native_dir(), f'{variant}.supp')}"
    assert supp_ours in ours[var].split() and supp_theirs in theirs[var].split()
    assert ours[var].replace(supp_ours, "S") == theirs[var].replace(supp_theirs, "S")
    assert {k: v for k, v in ours.items() if k != var} == \
           {k: v for k, v in theirs.items() if k != var}
    assert "report_mutex_bugs" not in ours[var] and ours[var].count("suppressions=") == 1
    assert ours == build.sanitizer_environ(dict(base), variant=variant)
    monkeypatch.delenv("DISTLR_NATIVE_VARIANT")
    assert build.sanitizer_environ(dict(base)) is None is jax_build.sanitizer_environ(dict(base))


@pytest.mark.parametrize("name", ["tsan.supp", "asan.supp", "ubsan.supp"])
def test_suppression_files_equal_jax(name):
    ours = (build.NATIVE_DIR / name).read_bytes()
    assert ours == (Path(jax_build.native_dir()) / name).read_bytes()


@pytest.mark.parametrize("name", ["kv_server.cc", "kv_client.cc", "kv_protocol.h"])
def test_native_sources_equal_jax(name):
    """A sanitizer is flags, not source: the port's native sources stay
    the JAX package's bytes."""
    assert (build.NATIVE_DIR / name).read_bytes() == \
           (Path(jax_build.native_dir()) / name).read_bytes()


def test_variant_flags_are_jax_makefile_flags():
    """Each variant's compiler flags are the JAX Makefile's for its
    target, and each builds under its own hashed name."""
    make = (Path(jax_build.native_dir()) / "Makefile").read_text()
    sanflags = next(line.split("=", 1)[1].split() for line in make.splitlines()
                    if line.startswith("SANFLAGS"))
    assert list(build.SANITIZER_FLAGS) == sanflags
    for v, target in (("tsan", "distlr_kv_server_tsan:"), ("asan", "distlr_kv_server_asan:"),
                      ("ubsan", "distlr_kv_server_ubsan:")):
        rule = make.split(target, 1)[1].split("\n\n", 1)[0].replace("\\\n", " ")
        assert all(flag in rule.split() for flag in build._VARIANTS[v][2]), (v, rule)


# ---------------------------------------------------------------------------
# groups on the TSan server in this process (tests/test_ps_tsan.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def tsan_env(tmp_path, monkeypatch):
    """The TSan server binary and a check that scans its reports; the
    variable stays unset, so this process keeps the standard client."""
    monkeypatch.delenv("DISTLR_NATIVE_VARIANT", raising=False)
    binary = build.server_binary("tsan")
    log_base = str(tmp_path / "tsan")
    monkeypatch.setenv("TSAN_OPTIONS", f"log_path={log_base} exitcode=66")

    def assert_no_reports(group: ServerGroup):
        group.wait()
        codes = [p.returncode for p in group.procs]
        reports = _reports(log_base)
        assert not reports, "ThreadSanitizer reports:\n" + "\n".join(reports)
        assert all(c == 0 for c in codes), f"TSan server exit codes {codes} (66 = race)"
        assert all(p.args[0] == str(binary) for p in group.procs)

    return binary, assert_no_reports


def _run_threads(workers: int, fn, group: ServerGroup) -> None:
    """``fn(rank)`` on ``workers`` threads; the first failure stops the
    group so its peers do not wait out the barrier."""
    errors: list[Exception] = []

    def guarded(rank: int):
        try:
            fn(rank)
        except Exception as e:  # noqa: BLE001
            errors.append(e)
            group.stop()

    threads = [threading.Thread(target=guarded, args=(r,), daemon=True)
               for r in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, f"worker failed: {errors[0]!r}"
    assert not any(t.is_alive() for t in threads), "worker thread wedged"


@needs_toolchain
@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_server_race_free_under_tsan(tsan_env, sync):
    binary, assert_no_reports = tsan_env
    dim, workers, steps = 64, 4, 30
    group = ServerGroup(2, workers, dim, learning_rate=0.1, sync=sync, binary=binary)
    with group:
        def run(rank: int):
            with KVWorker(group.hosts, dim, client_id=rank, timeout_ms=60_000) as kv:
                if rank == 0:
                    kv.wait(kv.push_init(np.zeros(dim, np.float32)))
                kv.barrier(0)
                for i in range(steps):
                    w = kv.pull()
                    if i % 2:
                        kv.push_pull(w * 0.01 + 1.0)
                    else:
                        kv.wait(kv.push(w * 0.01 + 1.0))
                kv.barrier(1)
                if rank == 0:
                    kv.stats(0), kv.stats(1)
                    kv.shutdown_servers()

        _run_threads(workers, run, group)
        assert_no_reports(group)


@needs_toolchain
def test_ftrl_opt_segments_under_tsan(tsan_env):
    """Per-namespace optimizers under concurrent pushes and concurrent
    opt-state pulls of each rank (the supervisor's access pattern)."""
    binary, assert_no_reports = tsan_env
    dim, workers, steps = 64, 3, 20
    group = ServerGroup(2, workers, dim, learning_rate=0.1, sync=False, binary=binary,
                        opt_segments=[(32, "ftrl"), (64, "sgd")], ftrl_alpha=0.1, ftrl_l1=0.01)
    with group:
        stop = threading.Event()
        probe_errors: list[Exception] = []
        snapshots = [0]

        def prober():
            try:
                while not stop.is_set():
                    for rank, port in enumerate(group.ports):
                        lo, hi = group.key_range(rank)
                        try:
                            with KVWorker(f"127.0.0.1:{port}", hi - lo, client_id=0xFFFE,
                                          timeout_ms=30_000, sync_group=False) as kv:
                                kv.stats(0)
                                try:
                                    kv.pull_opt_state()
                                except PSRejectedError:
                                    pass  # a rank without an FTRL slice
                                snapshots[0] += 1
                        except OSError:
                            return  # the group is shutting down
            except Exception as e:  # noqa: BLE001
                probe_errors.append(e)

        probe = threading.Thread(target=prober, daemon=True)
        probe.start()

        def run(rank: int):
            with KVWorker(group.hosts, dim, client_id=rank, timeout_ms=60_000,
                          sync_group=False) as kv:
                if rank == 0:
                    kv.push_init(np.zeros(dim, np.float32))
                kv.barrier(0)
                for i in range(steps):
                    w = kv.pull()
                    kv.push(np.sign(w) * 0.01 + (0.001 * (rank + i)))
                kv.barrier(1)
                if rank == 0:
                    kv.shutdown_servers()

        _run_threads(workers, run, group)
        stop.set()
        probe.join(timeout=30)
        assert not probe.is_alive(), "opt-state prober wedged"
        assert not probe_errors, f"prober failed: {probe_errors[0]!r}"
        assert snapshots[0] > 0, "prober took no concurrent snapshots"
        assert_no_reports(group)


@needs_toolchain
def test_epoch_fence_and_resize_under_tsan(tsan_env):
    """A live resize (fence, drain, commit) while route-following clients
    push, on the TSan build; the resize's spawns run it too."""
    binary, assert_no_reports = tsan_env
    dim, workers = 64, 3
    group = ServerGroup(2, workers, dim, learning_rate=0.1, sync=False, binary=binary)
    with group:
        coord = MembershipCoordinator(group)
        stop = threading.Event()
        errors: list[Exception] = []

        def run(rank: int):
            with KVWorker(None, dim, client_id=rank, timeout_ms=60_000, sync_group=False,
                          route=coord.layout) as kv:
                if rank == 0:
                    kv.push_init(np.zeros(dim, np.float32))
                steps = 0
                while not stop.is_set() and steps < 200:
                    w = kv.pull()
                    kv.push(w * 0.01 + 1.0)
                    steps += 1

        def guarded(rank: int):
            try:
                run(rank)
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                stop.set()

        threads = [threading.Thread(target=guarded, args=(r,), daemon=True)
                   for r in range(workers)]
        for t in threads:
            t.start()
        try:
            grow = coord.resize(4)
            shrink = coord.resize(2)
            assert grow["ok"] and shrink["ok"]
            assert coord.epoch == 3
        finally:
            stop.set()
        for t in threads:
            t.join(timeout=120)
        assert not errors, f"client failed through the resize: {errors[0]!r}"
        assert not any(t.is_alive() for t in threads), "client wedged"
        with KVWorker(group.hosts, dim, client_id=99, timeout_ms=30_000,
                      sync_group=False) as kv:
            kv.shutdown_servers()
        assert_no_reports(group)


@needs_toolchain
@pytest.mark.parametrize("codec", ["int8", "signsgd"])
def test_codec_pushes_under_tsan(tsan_env, codec):
    """Codec-negotiated pushes (int8 against SGD, 1-bit signs against the
    majority vote) under concurrent clients on the TSan build."""
    binary, assert_no_reports = tsan_env
    dim, workers, steps = 64, 3, 20
    group = ServerGroup(2, workers, dim, learning_rate=0.01, sync=False, binary=binary,
                        optimizer="signsgd" if codec == "signsgd" else "sgd")
    with group:
        def run(rank: int):
            with KVWorker(group.hosts, dim, client_id=rank, timeout_ms=60_000,
                          sync_group=False, compress=codec) as kv:
                assert kv.compress_active == codec
                if rank == 0:
                    kv.push_init(np.zeros(dim, np.float32))
                kv.barrier(0)
                rng = np.random.default_rng(rank)
                for _ in range(steps):
                    kv.push(rng.standard_normal(dim).astype(np.float32))
                    kv.pull()
                kv.barrier(1)
                if rank == 0:
                    kv.shutdown_servers()

        _run_threads(workers, run, group)
        assert_no_reports(group)


@needs_toolchain
def test_supervised_respawn_under_tsan(tsan_env, tmp_path):
    """An int8-pushing async group with the WAL under a supervisor: rank 1
    SIGKILLed and respawned from its store on the same TSan build, the
    pull after it equal to the one before (every acknowledged push is in
    the log)."""
    binary, assert_no_reports = tsan_env
    dim = 64
    group = ServerGroup(2, 1, dim, learning_rate=0.1, sync=False, binary=binary,
                        store_dir=str(tmp_path / "store"), store_wal=True,
                        store_wal_fsync_s=0.01)
    with group, ServerSupervisor(group, poll_interval=0.05, snapshot_interval=60.0) as sup:
        with KVWorker(group.hosts, dim, sync_group=False, timeout_ms=60_000,
                      compress="int8") as kv:
            kv.push_init(np.zeros(dim, np.float32))
            rng = np.random.default_rng(0)
            for _ in range(8):
                kv.push(rng.standard_normal(dim).astype(np.float32))
            before = kv.pull()
            os.kill(group.procs[1].pid, signal.SIGKILL)
            for _ in range(400):
                if (1, "reseeded-from-store") in [(r, ev) for _, r, ev in sup.events]:
                    break
                threading.Event().wait(0.025)
        with KVWorker(group.hosts, dim, sync_group=False, timeout_ms=60_000) as kv:
            np.testing.assert_array_equal(kv.pull(), before)
            kv.shutdown_servers()
        assert (1, "reseeded-from-store") in [(r, ev) for _, r, ev in sup.events], sup.events
        sup.stop()
        assert_no_reports(group)


# ---------------------------------------------------------------------------
# the port's chaos and elastic suites under the TSan pair
# ---------------------------------------------------------------------------


#: host-process noise of the jaxlib this environment installs beside the
#: entries of ``tests/tsan_host.supp``: its XLA runtime now ships as
#: ``libjax_common.so`` (``xla_extension.so`` there), uninstrumented, and
#: its compiler threads race inside it on the pytest process's own JIT
#: compiles; no native process of the port loads it
_HOST_SUPP_EXTRA = "called_from_lib:libjax_common.so\nrace:libjax_common.so\n"


def _host_supp(tmp_path) -> Path:
    """``tests/tsan_host.supp`` (read, never edited) and
    :data:`_HOST_SUPP_EXTRA`, as one file for the pytest process."""
    path = tmp_path / "tsan_host.supp"
    path.write_text((REPO / "tests" / "tsan_host.supp").read_text() + _HOST_SUPP_EXTRA)
    return path


def _run_suite_under_tsan(tmp_path, pytest_args: list[str], timeout: int) -> None:
    rt = _libtsan()
    if rt is None:
        pytest.skip("toolchain has no libtsan runtime")
    build.server_binary("tsan")
    log_base = str(tmp_path / "suite_report")
    env = os.environ.copy()
    env["DISTLR_NATIVE_VARIANT"] = "tsan"
    env["LD_PRELOAD"] = rt
    env["JAX_PLATFORMS"] = "cpu"
    # the suites hold the port against the JAX package, so the pytest
    # process loads jaxlib: its audited host noise and report_mutex_bugs=0
    # apply to this process only, since sanitizer_environ strips both from
    # every spawned server
    env["TSAN_OPTIONS"] = (f"log_path={log_base} exitcode=66 report_mutex_bugs=0 "
                           f"suppressions={_host_supp(tmp_path)}")
    proc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                           *pytest_args], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    reports = _reports(log_base)
    assert not reports, "TSan reports:\n" + "\n".join(reports)
    assert proc.returncode == 0, (f"suite under TSan rc={proc.returncode}\n"
                                  f"stdout tail:\n{proc.stdout[-4000:]}\n"
                                  f"stderr tail:\n{proc.stderr[-2000:]}")


@needs_toolchain
@pytest.mark.slow
def test_chaos_suite_under_tsan(tmp_path):
    """The port's chaos suite with both native sides TSan-instrumented:
    zero unsuppressed reports."""
    _run_suite_under_tsan(tmp_path, ["tests/test_torch_chaos.py", "-m", "not slow"],
                          timeout=3000)


@needs_toolchain
@pytest.mark.slow
def test_elastic_suite_under_tsan(tmp_path):
    """The port's elastic suite with both native sides TSan-instrumented:
    zero unsuppressed reports."""
    _run_suite_under_tsan(tmp_path, ["tests/test_torch_elastic.py", "-m", "not slow"],
                          timeout=3000)


#: the chaos suite's cases that drive only the port's fabric (the parity
#: cases also run the JAX package's proxy in this process, whose pumps keep
#: the close-under-recv race the port's proxy no longer has), and the
#: protocol witnesses; not the traced ``run_ps_local`` rehearsal, whose
#: servers profile under ``--obs-run-dir`` and flush that profile from
#: their SIGTERM handler, which TSan reports as signal-unsafe
_PORT_ONLY_CHAOS = ("delay_delays or partition_blocks or reset_after or throttle_paces "
                    "or same_seed or group_kill or launch_ps_trains or TestWitnesses")


@needs_toolchain
@pytest.mark.slow
def test_port_proxy_traffic_under_tsan(tmp_path):
    """The port's proxy alone under TSan: the chaos suite's port-only
    traffic (delays, partitions, resets after ops and bytes, throttles,
    kills, training behind a plan) and the protocol conformance witnesses
    and traced chaos run, both native sides instrumented: zero reports.
    Each connection's sockets are closed once, by the last of its two
    pumps out."""
    _run_suite_under_tsan(tmp_path, ["tests/test_torch_chaos.py",
                                     "tests/test_torch_protocol_conformance.py",
                                     "-m", "not slow", "-k", _PORT_ONLY_CHAOS], timeout=3000)
