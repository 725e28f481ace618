"""The port's server groups under each update rule and ``launch ps-server``,
against the JAX package's, on the CPU.

* ``ServerGroup``: the spawn command of every optimizer, codec switch and
  per-namespace map equals the JAX package's flag for flag (an ``sgd``
  group's is the one it always was), and the validations raise JAX's
  errors.
* Per-namespace optimizers: a ``v1:ftrl,v2`` group moves ``v1`` by the
  FTRL oracle and ``v2`` by SGD, on pushes through ``KVNamespace``; the
  JAX package's namespace views of the same group read the same bytes.
* The CLI: ``launch ps-server`` hosts a group that ``launch ps --hosts``
  trains into; SIGTERM stops it with no server left behind; its errors
  exit as JAX's; ``launch ps`` with the FTRL, codec and accumulation flags
  runs through both packages' CLIs; ``launch serve --ps-namespaces
  v1:ftrl,v2`` serves ``v1`` as JAX's does.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import distlr_tpu.ps.server as jax_server_mod
from distlr_tpu import launch as jax_launch
from distlr_tpu.ps import KVWorker as JaxKVWorker
from distlr_tpu.ps import ServerGroup as JaxServerGroup
from distlr_tpu.serve import ScoringServer as JaxServer
from distlr_tpu_torch import launch
from distlr_tpu_torch.data.synthetic import write_synthetic_shards
from distlr_tpu_torch.ps import KVWorker, ServerGroup, namespace_layout
from distlr_tpu_torch.serve import ScoringServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHA, BETA, L1, L2 = 0.5, 1.0, 0.01, 0.1
FTRL = {"ftrl_alpha": ALPHA, "ftrl_beta": BETA, "ftrl_l1": L1, "ftrl_l2": L2}


def _ftrl_oracle(w0, grads):
    """``tests/test_ftrl.py``'s float32 FTRL-Proximal oracle."""
    w = np.array(w0, np.float32).copy()
    z, n = np.zeros_like(w), np.zeros_like(w)
    a, b, r1, r2 = (np.float32(v) for v in (ALPHA, BETA, L1, L2))
    for g in grads:
        g = np.asarray(g, np.float32)
        touched = g != 0
        n_new = (n + g * g).astype(np.float32)
        sigma = ((np.sqrt(n_new) - np.sqrt(n)) / a).astype(np.float32)
        z = np.where(touched, (z + g - sigma * w).astype(np.float32), z)
        n = np.where(touched, n_new, n)
        w_new = np.where(np.abs(z) <= r1, np.float32(0.0),
                         (-(z - np.sign(z) * r1) / ((b + np.sqrt(n)) / a + r2)).astype(np.float32))
        w = np.where(touched, w_new, w).astype(np.float32)
    return w


class _FakeProc:
    """What the JAX group's spawn reads of a server process."""

    def __init__(self, cmd, **_):
        self.cmd = cmd
        self.stdout = self

    def readline(self):
        return "PORT 1\n"

    def poll(self):
        return 0

    def wait(self, timeout=None):
        return 0

    def close(self):
        pass


def _jax_commands(monkeypatch, *args, **kw) -> list[list[str]]:
    """The command lines the JAX package's group spawns, captured."""
    seen = []

    def popen(cmd, **popen_kw):
        seen.append(_FakeProc(cmd, **popen_kw))
        return seen[-1]

    monkeypatch.setattr(jax_server_mod.subprocess, "Popen", popen)
    group = JaxServerGroup(*args, binary="BIN", **kw)
    group.start()
    group.stop()
    return [p.cmd for p in seen]


def _our_commands(*args, **kw) -> list[list[str]]:
    group = ServerGroup(*args, **kw)
    ports = kw.get("ports") or [0] * group.num_servers
    return [group._command("BIN", r, ports[r]) for r in range(group.num_servers)]


class TestServerGroupSpawn:
    def test_sgd_command_is_unchanged(self):
        """An sgd group spawns the command it always did: no optimizer,
        FTRL or codec flag."""
        assert _our_commands(2, 3, 10, learning_rate=0.5, sync=False) == [
            ["BIN", "--port=0", "--num_workers=3", "--dim=5", "--lr=0.5", "--sync=0",
             "--last_gradient=0", "--bind_any=0"],
            ["BIN", "--port=0", "--num_workers=3", "--dim=5", "--lr=0.5", "--sync=0",
             "--last_gradient=0", "--bind_any=0"]]

    @pytest.mark.parametrize("kw", [
        {},
        {"last_gradient": True},
        {"optimizer": "ftrl", **FTRL},
        {"optimizer": "signsgd", "learning_rate": 0.01},
        {"compress": False},
        {"optimizer": "ftrl", "compress": False},
        {"bind_any": True, "ports": [7001, 7002, 7003]},
        {"opt_segments": [(12, "ftrl"), (24, "sgd")], **FTRL},
        {"opt_segments": [(12, "sgd"), (24, "ftrl")]},
        {"opt_segments": [(8, "ftrl"), (24, "sgd")], "optimizer": "ftrl"},
    ])
    def test_commands_equal_jax(self, kw, monkeypatch):
        ours = _our_commands(3, 2, 24, **kw)
        assert ours == _jax_commands(monkeypatch, 3, 2, 24, **kw)

    @pytest.mark.parametrize("kw", [
        {"optimizer": "adam"},
        {"optimizer": "ftrl", "last_gradient": True},
        {"optimizer": "signsgd", "last_gradient": True},
        {"opt_segments": [(8, "ftrl")], "optimizer": "signsgd"},
        {"opt_segments": [(8, "ftrl")], "last_gradient": True},
        {"opt_segments": [(4, "adam"), (8, "sgd")]},
        {"opt_segments": [(6, "sgd"), (4, "ftrl")]},
        {"opt_segments": [(4, "sgd")]},
    ])
    def test_validation_raises_jax_errors(self, kw):
        with pytest.raises(ValueError) as ours:
            ServerGroup(1, 1, 8, **kw)
        with pytest.raises(ValueError) as theirs:
            JaxServerGroup(1, 1, 8, **kw)
        assert str(ours.value) == str(theirs.value)

    @pytest.mark.parametrize("kw,want", [
        ({}, False), ({"optimizer": "ftrl"}, True), ({"optimizer": "signsgd"}, False),
        ({"opt_segments": [(4, "sgd"), (8, "ftrl")]}, True),
        ({"opt_segments": [(4, "sgd"), (8, "sgd")]}, False),
    ])
    def test_has_ftrl_equals_jax(self, kw, want):
        assert ServerGroup(1, 1, 8, **kw).has_ftrl == JaxServerGroup(1, 1, 8, **kw).has_ftrl == want

    def test_fixed_ports_are_bound(self):
        probe = ServerGroup(2, 1, 8).start()
        ports = list(probe.ports)
        probe.stop()  # two ports the kernel just gave out, free again
        with ServerGroup(2, 1, 8, ports=ports) as sg:
            assert sg.ports == ports
            with KVWorker(sg.hosts, 8) as kv:
                kv.push_init(np.arange(8, dtype=np.float32))
                np.testing.assert_array_equal(kv.pull(), np.arange(8, dtype=np.float32))


class TestNamespaceOptimizers:
    def test_ftrl_and_sgd_namespaces_follow_their_oracles(self):
        """``v1:ftrl,v2`` over 2 servers: v1's slice runs FTRL, v2's the
        group's SGD; JAX's namespace views read the same bytes."""
        d, lr = 32, 0.25
        layout = namespace_layout("v1:ftrl,v2", d)
        assert layout == {"v1": (0, d), "v2": (d, d)}
        segments = [(base + dim, opt) for (base, dim), opt in zip(layout.values(),
                                                                  ("ftrl", "sgd"))]
        rng = np.random.default_rng(0)
        w1, w2 = rng.normal(size=d).astype(np.float32), rng.normal(size=d).astype(np.float32)
        g1 = [rng.normal(size=d).astype(np.float32) for _ in range(5)]
        g2 = [rng.normal(size=d).astype(np.float32) for _ in range(5)]
        with ServerGroup(2, 1, 2 * d, sync=False, learning_rate=lr, opt_segments=segments,
                         **FTRL) as sg, KVWorker(sg.hosts, 2 * d, sync_group=False) as kv:
            v1, v2 = (kv.namespace(*layout[m]) for m in ("v1", "v2"))
            v1.push_init(w1)
            v2.push_init(w2, force=True)
            for a, b in zip(g1, g2):
                v1.wait(v1.push(a))
                v2.wait(v2.push(b))
            got1, got2 = v1.pull(), v2.pull()
            with JaxKVWorker(sg.hosts, 2 * d, sync_group=False) as jkv:
                assert jkv.namespace(*layout["v1"]).pull().tobytes() == got1.tobytes()
                assert jkv.namespace(*layout["v2"]).pull().tobytes() == got2.tobytes()
        np.testing.assert_allclose(got1, _ftrl_oracle(w1, g1), rtol=1e-5, atol=1e-6)
        sgd = w2.copy()
        for b in g2:
            sgd = (sgd - np.float32(lr) * b).astype(np.float32)
        np.testing.assert_allclose(got2, sgd, rtol=1e-6, atol=1e-7)


# --- the CLI ----------------------------------------------------------------------
def _children(pid: int) -> list[int]:
    """Live child processes of ``pid`` (from /proc)."""
    kids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            kids.append(int(entry))
    return kids


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _start_ps_server(*argv):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "distlr_tpu_torch.launch", "ps-server",
                             *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines = {}
    deadline = time.monotonic() + 60
    while "HOSTS" not in lines and time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        key, _, rest = line.strip().partition(" ")
        lines[key] = rest
    if "HOSTS" not in lines:
        proc.kill()
        raise AssertionError(f"ps-server did not announce HOSTS: {proc.stderr.read()[-2000:]}")
    if "--namespaces" in argv:
        key, _, rest = proc.stdout.readline().strip().partition(" ")
        lines[key] = rest
    return proc, lines


def _stop(proc, timeout=20) -> int:
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=timeout)
    finally:
        proc.stdout.close()
        proc.stderr.close()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("psserver") / "d")
    write_synthetic_shards(d, 800, 24, num_parts=2, seed=5, sparsity=0.0)
    return d


class TestLaunchPSServer:
    def test_ps_hosts_trains_into_it_and_it_exits_with_the_group(self, data_dir):
        proc, lines = _start_ps_server("--num-feature-dim", "24", "--num-servers", "2",
                                       "--num-workers", "2", "--ps-optimizer", "ftrl",
                                       "--ftrl-alpha", "0.5")
        servers = _children(proc.pid)
        try:
            assert len(servers) == 2 and lines["HOSTS"].count(",") == 1
            env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
            out = subprocess.run(
                [sys.executable, "-m", "distlr_tpu_torch.launch", "ps", "--data-dir", data_dir,
                 "--num-feature-dim", "24", "--num-workers", "2", "--hosts", lines["HOSTS"],
                 "--ps-optimizer", "ftrl", "--ps-compress", "int8", "--num-iteration", "4",
                 "--test-interval", "2", "--device", "cpu"],
                cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
            assert out.returncode == 0, out.stderr[-2000:]
            assert "negotiated 'int8' gradient pushes" in out.stderr
            assert out.stdout.count("accuracy:") == 2
            # rank 0 retired the group: the foreground command ends with it
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                _stop(proc)
        assert not any(_alive(p) for p in servers)
        for part in ("part-001", "part-002"):
            with open(os.path.join(data_dir, "models", part)) as f:
                assert f.readline().strip() == "24"

    def test_sigterm_leaves_no_server(self):
        proc, lines = _start_ps_server("--num-feature-dim", "16", "--num-servers", "2",
                                       "--namespaces", "v1:ftrl,v2", "--async")
        assert lines["NAMESPACES"] == "v1=0,v2=16 per_dim=16"
        servers = _children(proc.pid)
        assert len(servers) == 2
        with KVWorker(lines["HOSTS"], 32, sync_group=False) as kv:
            assert [kv.stats(r)["dim"] for r in range(2)] == [16, 16]
        assert _stop(proc) == 143
        deadline = time.monotonic() + 10
        while any(_alive(p) for p in servers) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not any(_alive(p) for p in servers)

    @pytest.mark.parametrize("argv", [
        ["--ports", "7001"],
        ["--namespaces", "v1:adam,v2"],
        ["--namespaces", "v1:ftrl,v2", "--ps-compress", "signsgd"],
    ])
    def test_errors_exit_2_like_jax(self, argv, capsys, monkeypatch):
        monkeypatch.setattr(signal, "signal", lambda *a: None)
        errs = []
        for mod in (launch, jax_launch):
            assert mod.main(["ps-server", "--num-feature-dim", "8", "--num-servers", "2",
                             *argv]) == 2
            errs.append(capsys.readouterr().err.strip().splitlines()[-1])
        assert errs[0] == errs[1]

    @pytest.mark.parametrize("argv", [["--elastic"], ["--async", "--elastic", "--ctl-port"]])
    def test_elastic_flags_run_like_jax(self, argv, capsys, monkeypatch):
        """``--elastic`` without ``--async`` exits 2 with the JAX package's
        text; with it, ``--ctl-port`` fixes the announced ``PSCTL`` port,
        and ``ps-ctl resize`` reshards the group live (exit 0)."""
        if "--async" not in argv:
            monkeypatch.setattr(signal, "signal", lambda *a: None)
            errs = []
            for mod in (launch, jax_launch):
                assert mod.main(["ps-server", "--num-feature-dim", "8", *argv]) == 2
                errs.append(capsys.readouterr().err.strip().splitlines()[-1])
            assert errs[0] == errs[1]
            return
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        proc, lines = _start_ps_server("--num-feature-dim", "16", "--num-servers", "2",
                                       *argv, str(port))
        try:
            lines["PSCTL"] = proc.stdout.readline().strip().partition(" ")[2]
            assert lines["PSCTL"] == f"0.0.0.0:{port}"
            env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
            out = subprocess.run(
                [sys.executable, "-m", "distlr_tpu_torch.launch", "ps-ctl", "--ctl",
                 f"127.0.0.1:{port}", "resize", "4"],
                cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
            assert out.returncode == 0, out.stderr[-2000:]
            doc = json.loads(out.stdout.strip().splitlines()[-1][len("PSCTL "):])
            assert (doc["ok"], doc["epoch"], doc["num_servers"], doc["reused"],
                    doc["spawned"]) == (True, 2, 4, 2, 2)
            assert len(_children(proc.pid)) == 4
        finally:
            assert _stop(proc) == 143

    @pytest.mark.parametrize("argv", [
        ["--store-dir", "s"],
        ["--store-dir", "s", "--store-interval", "0.5"],
        ["--async", "--store-dir", "s", "--store-wal"],
        ["--async", "--store-dir", "s", "--store-wal", "--store-wal-fsync", "0.02"],
    ])
    def test_store_flags_reach_the_group_like_jax(self, argv, tmp_path, monkeypatch):
        """``ps-server --store-*`` builds the JAX package's group: the same
        mode and store arguments (``--async`` folded in before the Config
        validates, so ``--store-wal`` runs)."""
        import distlr_tpu_torch.ps as port_ps

        seen = {}

        class Built(Exception):
            pass

        def capture(who):
            def init(self, *a, **kw):
                seen[who] = (a, {k: kw[k] for k in ("sync", "store_dir", "store_interval_s",
                                                    "store_wal", "store_wal_fsync_s")})
                raise Built
            return init

        monkeypatch.setattr(port_ps.ServerGroup, "__init__", capture("ours"))
        monkeypatch.setattr(jax_server_mod.ServerGroup, "__init__", capture("theirs"))
        monkeypatch.setattr(signal, "signal", lambda *a: None)
        argv = [str(tmp_path / a) if a == "s" else a for a in argv]
        for main in (launch.main, jax_launch.main):
            with pytest.raises(Built):
                main(["ps-server", "--num-feature-dim", "8", "--num-servers", "2", *argv])
        assert seen["ours"] == seen["theirs"]
        assert seen["ours"][1]["store_dir"] == str(tmp_path / "s")


class TestLaunchPSBothCLIs:
    def test_one_command_line_runs_through_both(self, data_dir, tmp_path, capsys):
        """``launch ps`` with the FTRL, codec and accumulation flags, on the
        host numpy step, through the JAX package's CLI and the port's: the
        same eval epochs, and each worker's model written."""
        import re
        import shutil

        argv = ["--num-feature-dim", "24", "--num-workers", "2", "--num-servers", "2",
                "--num-iteration", "4", "--test-interval", "2", "--batch-size", "100",
                "--ps-compute-backend", "numpy", "--ps-optimizer", "ftrl", "--ftrl-alpha",
                "0.5", "--ftrl-l1", "0.01", "--ps-compress", "int8", "--accum-start", "1",
                "--accum-max", "4", "--accum-growth-every", "2"]
        epochs = []
        for name, mod, extra in (("ours", launch, ["--device", "cpu"]),
                                 ("theirs", jax_launch, [])):
            d = str(tmp_path / name)
            shutil.copytree(data_dir, d, ignore=shutil.ignore_patterns("models"))
            assert mod.main(["ps", "--data-dir", d, *argv, *extra]) == 0
            epochs.append(re.findall(r"Iteration (\d+), accuracy", capsys.readouterr().out))
            assert sorted(os.listdir(os.path.join(d, "models"))) == ["part-001", "part-002"]
        assert epochs[0] == epochs[1] == ["2", "4"]


class TestServeFtrlNamespaces:
    def test_serve_ps_namespaces_with_ftrl_like_jax(self, monkeypatch):
        """``serve --ps-namespaces v1:ftrl,v2 --ps-namespace v1`` serves v1's
        slice of a ``v1:ftrl,v2`` group: the same replies as JAX's."""
        d = 8
        w1 = np.linspace(-1, 1, d).astype(np.float32)
        w2 = np.cos(np.arange(d)).astype(np.float32)
        lines = ["1:1 3:1", "2:1 5:1 8:1"]
        seen = {}
        with ServerGroup(2, 1, 2 * d, sync=False, opt_segments=[(d, "ftrl"), (2 * d, "sgd")]
                         ) as sg:
            with KVWorker(sg.hosts, 2 * d) as kv:
                kv.push_init(np.concatenate([w1, w2]))
            for name, mod, srv_cls in (("ours", launch, ScoringServer),
                                       ("theirs", jax_launch, JaxServer)):
                def probe(self, name=name):
                    seen[name] = [self.handle_line(ln) for ln in lines]
                    self.stop()

                monkeypatch.setattr(srv_cls, "serve_forever", probe)
                monkeypatch.setattr(signal, "signal", lambda *a: None)
                extra = ["--device", "cpu"] if mod is launch else []
                assert mod.main(["serve", "--num-feature-dim", str(d), "--l2-c", "0",
                                 "--reload-interval", "30", "--ps-hosts", sg.hosts,
                                 "--ps-namespaces", "v1:ftrl,v2", "--ps-namespace", "v1",
                                 *extra]) == 0
        for a, b in zip(seen["ours"], seen["theirs"]):
            assert a.split()[0] == b.split()[0]
            assert float(a.split()[1]) == pytest.approx(float(b.split()[1]), abs=1e-5)
        # v1's weights (bf16 products): columns 1 and 3 of the first line
        w1_bf16 = torch.from_numpy(w1).bfloat16().double().numpy()
        assert float(seen["ours"][0].split()[1]) == pytest.approx(
            1 / (1 + np.exp(-(w1_bf16[0] + w1_bf16[2]))), abs=1e-5)
