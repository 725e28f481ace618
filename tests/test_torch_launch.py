"""The port's CLI, its device rule and its kernel build, on the CPU."""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distlr_tpu import launch as jax_launch
from distlr_tpu_torch import launch
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.ops import build
from distlr_tpu_torch.train import Trainer
from distlr_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parents[1]

#: the ``ps`` durable-store and fault-plan flags the port runs (ROADMAP
#: A.16.4-A.16.5), each with a value valid in both packages, or refused by
#: both with the same message (``--store-wal`` on a sync run)
_STORE_CHAOS_PS_FLAGS = (
    ["--store-dir", "st"], ["--store-interval", "0.5"], ["--store-wal-fsync", "0.05"],
    ["--store-wal", "--store-dir", "st"], ["--chaos-plan", "plan.json"],
    ["--chaos-seed", "5"],
)
#: the ``ps`` recovery flags the port runs (ROADMAP A.16.1-A.16.3), each
#: with a value valid in both packages
_RECOVERY_PS_FLAGS = (
    ["--max-worker-restarts", "2"], ["--supervise-servers", "--async"],
    ["--ps-retry-attempts", "3"], ["--ps-retry-backoff", "25"],
    ["--ps-retry-backoff-max", "5000"], ["--ps-retry-deadline", "9.5"],
    ["--ps-retry-adaptive"], ["--checkpoint-dir", "ck"],
    ["--checkpoint-interval", "2"], ["--resume"],
)
EVAL_LINE = re.compile(r"^\d\d:\d\d:\d\d Iteration (\d+), accuracy: (\S+)$", re.M)


def _launch(*argv, env_extra=None, check=True):
    # one intra-op thread: the runs are tiny and share the machine with the suite
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **(env_extra or {}))
    proc = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", *argv],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    if check:
        assert proc.returncode == 0, proc.stderr
    return proc


class TestCLI:
    def test_gen_data_sync_eval_on_cpu(self, tmp_path):
        d = str(tmp_path / "d")
        common = ["--data-dir", d, "--num-feature-dim", "123"]
        _launch("gen-data", *common, "--num-samples", "2000", "--num-parts", "2")
        assert sorted(os.listdir(os.path.join(d, "train"))) == ["part-001", "part-002"]
        out = _launch("sync", *common, "--num-workers", "2", "--num-iteration", "20",
                      "--test-interval", "10", "--learning-rate", "0.5", "--l2-c", "0",
                      "--device", "cpu").stdout
        evals = EVAL_LINE.findall(out)
        assert [int(n) for n, _ in evals] == [10, 20]
        model_file = os.path.join(d, "models", "part-001")
        with open(model_file) as f:
            assert f.readline().strip() == "123"
            assert len(f.readline().split()) == 123
        ev = _launch("eval", *common, "--model-file", model_file, "--device", "cpu").stdout
        m = re.search(r"accuracy: (\S+)\s+test_logloss: (\S+)", ev)
        assert m is not None
        # eval scores the same weights the last sync eval line reported
        assert float(m.group(1)) == pytest.approx(float(evals[-1][1]), abs=1e-4)

    def test_sync_without_cuda_refuses_to_fall_back(self, tmp_path):
        d = str(tmp_path / "d")
        _launch("gen-data", "--data-dir", d, "--num-feature-dim", "8", "--num-samples", "50",
                "--num-parts", "1")
        proc = _launch("sync", "--data-dir", d, "--num-feature-dim", "8",
                       env_extra={"CUDA_VISIBLE_DEVICES": ""}, check=False)
        assert proc.returncode != 0
        assert '--device cpu' in proc.stderr
        assert not os.path.exists(os.path.join(d, "models", "part-001"))

    def test_unported_option_names_its_roadmap_item(self, tmp_path):
        """Formerly refused naming ROADMAP A.21: ``--prof-hz`` and
        ``--prof-window`` now arm the profiler of a ``--obs-run-dir`` run,
        whose windows carry the rate asked for."""
        d, run = str(tmp_path / "d"), str(tmp_path / "run")
        _launch("gen-data", "--data-dir", d, "--num-feature-dim", "8", "--num-samples", "200",
                "--num-parts", "1")
        _launch("sync", "--data-dir", d, "--num-feature-dim", "8", "--num-iteration", "2",
                "--test-interval", "0", "--prof-hz", "5", "--prof-window", "30",
                "--log-level", "debug", "--obs-run-dir", run, "--device", "cpu")
        with open(os.path.join(run, "profiles", "sync-0.jsonl")) as f:
            windows = [json.loads(line) for line in f]
        assert windows and all(w["hz"] == 5.0 for w in windows)
        with open(os.path.join(run, "logs", "sync-0.jsonl")) as f:
            assert '"level": "debug"' in f.readline()  # the journal's meta line


class TestPSCLI:
    """``launch ps``: the parameter-server path on the CPU (``--device cpu``)."""

    @pytest.fixture(scope="class")
    def data_dir(self, tmp_path_factory):
        d = str(tmp_path_factory.mktemp("psdata") / "d")
        _launch("gen-data", "--data-dir", d, "--num-feature-dim", "123", "--num-samples",
                "2000", "--num-parts", "2")
        return d

    def test_gen_data_ps_eval_on_cpu(self, data_dir):
        common = ["--data-dir", data_dir, "--num-feature-dim", "123"]
        out = _launch("ps", *common, "--num-workers", "2", "--num-servers", "2",
                      "--num-iteration", "20", "--test-interval", "10", "--learning-rate",
                      "0.5", "--l2-c", "0", "--device", "cpu").stdout
        evals = EVAL_LINE.findall(out)
        assert [int(n) for n, _ in evals] == [10, 20]
        for part in ("part-001", "part-002"):  # one model file a worker (Q8)
            model_file = os.path.join(data_dir, "models", part)
            with open(model_file) as f:
                assert f.readline().strip() == "123"
                assert len(f.readline().split()) == 123
            ev = _launch("eval", *common, "--model-file", model_file, "--device", "cpu").stdout
            m = re.search(r"accuracy: (\S+)\s+test_logloss: (\S+)", ev)
            # sync workers end with the same weights: eval scores the last line's
            assert m is not None and float(m.group(1)) == pytest.approx(
                float(evals[-1][1]), abs=1e-4)

    def test_async_and_serialized_protocol_run(self, data_dir):
        for extra in (["--async"], ["--async", "--no-ps-pipeline"]):
            out = _launch("ps", "--data-dir", data_dir, "--num-feature-dim", "123",
                          "--num-workers", "2", "--batch-size", "100", "--num-iteration", "4",
                          "--test-interval", "2", "--device", "cpu", *extra).stdout
            assert [int(n) for n, _ in EVAL_LINE.findall(out)] == [2, 4], extra

    def test_workers_join_running_servers(self, data_dir, tmp_path):
        from distlr_tpu_torch.ps import ServerGroup

        d = tmp_path / "d"
        shutil.copytree(data_dir, d)
        with ServerGroup(2, 2, dim=123, learning_rate=0.5) as group:
            _launch("ps", "--data-dir", str(d), "--num-feature-dim", "123", "--num-workers", "2",
                    "--num-iteration", "3", "--test-interval", "0", "--learning-rate", "0.5",
                    "--hosts", group.hosts, "--worker-ranks", "0,1", "--device", "cpu")
            for p in group.procs:  # rank 0's exit retired the servers
                p.wait(timeout=10)
        assert sorted(os.listdir(d / "models")) == ["part-001", "part-002"]

    def test_worker_ranks_need_hosts(self, data_dir):
        proc = _launch("ps", "--data-dir", data_dir, "--num-feature-dim", "123",
                       "--worker-ranks", "0", "--device", "cpu", check=False)
        assert proc.returncode == 2 and "--worker-ranks requires --hosts" in proc.stderr

    def test_ps_without_cuda_refuses_to_fall_back(self, tmp_path):
        d = str(tmp_path / "d")
        _launch("gen-data", "--data-dir", d, "--num-feature-dim", "8", "--num-samples", "50",
                "--num-parts", "1")
        proc = _launch("ps", "--data-dir", d, "--num-feature-dim", "8",
                       env_extra={"CUDA_VISIBLE_DEVICES": ""}, check=False)
        assert proc.returncode != 0
        assert "--device cpu" in proc.stderr
        assert not os.path.exists(os.path.join(d, "models", "part-001"))

    @pytest.mark.parametrize("argv,item", [
        (["--prof-hz", "5"], "A.21"),
        (["--log-level", "debug"], "A.21"),
    ])
    def test_unported_ps_flags_name_their_roadmap_item(self, argv, item, tmp_path):
        """Formerly refused naming ROADMAP ``item``: the flag now reaches
        the ``ps`` Config as it reaches the JAX package's."""
        from distlr_tpu_torch import launch

        argv = ["ps", "--data-dir", str(tmp_path), "--num-feature-dim", "8", *argv]
        cfg = launch.command_config(_PARSER.parse_args(argv + ["--device", "cpu"]))
        jcfg = jax_launch._config_from_args(_JAX_PARSER.parse_args(argv))
        assert (cfg.prof_hz, cfg.log_level) == (jcfg.prof_hz, jcfg.log_level)
        assert (cfg.prof_hz, cfg.log_level) != (Config().prof_hz, Config().log_level)

    @pytest.mark.parametrize("argv", _RECOVERY_PS_FLAGS, ids=lambda a: a[0])
    @pytest.mark.parametrize("hosts", [False, True], ids=["local", "hosts"])
    def test_recovery_flags_reach_the_run_like_jax(self, argv, hosts, tmp_path, monkeypatch):
        """The checkpoint, resume, restart, supervision and retry flags of
        ``launch ps`` reach the run as the JAX package's ``launch ps``
        passes them: the same keyword arguments and Config fields, or the
        same exit 2 and message (``--supervise-servers`` with ``--hosts``)."""
        from distlr_tpu.train import ps_trainer as jax_ps_trainer

        from distlr_tpu_torch.train import ps_trainer

        seen = {}
        for mod, who in ((ps_trainer, "ours"), (jax_ps_trainer, "theirs")):
            for fn in ("run_ps_local", "run_ps_workers"):
                monkeypatch.setattr(mod, fn, lambda cfg, *a, _w=who, _f=fn, **kw:
                                    seen.setdefault(_w, (_f, cfg, kw)))
        common = ["ps", "--data-dir", str(tmp_path), "--num-feature-dim", "8", *argv]
        if hosts:
            common += ["--hosts", "127.0.0.1:1"]
        errs = []
        for main, extra in ((launch.main, ["--device", "cpu"]), (jax_launch.main, [])):
            with contextlib.redirect_stderr(io.StringIO()) as err:
                errs.append((main(common + extra), err.getvalue()))
        assert errs[0] == errs[1]
        if errs[0][0] == 2:
            assert "--supervise-servers applies to local mode" in errs[0][1]
            return
        (fn, cfg, kw), (jfn, jcfg, jkw) = seen["ours"], seen["theirs"]
        assert fn == jfn
        jkw.pop("on_error", None)
        kw.pop("on_error", None)
        assert kw == jkw
        for f in ("checkpoint_dir", "checkpoint_interval", "sync_mode", "ps_retry_attempts",
                  "ps_retry_backoff_ms", "ps_retry_backoff_max_ms", "ps_retry_deadline_s",
                  "ps_retry_adaptive"):
            assert getattr(cfg, f) == getattr(jcfg, f), f

    @pytest.mark.parametrize("argv", _STORE_CHAOS_PS_FLAGS, ids=lambda a: a[0])
    @pytest.mark.parametrize("hosts", [False, True], ids=["local", "hosts"])
    def test_store_and_chaos_flags_reach_the_run_like_jax(self, argv, hosts, tmp_path,
                                                          monkeypatch):
        """The durable-store and fault-plan flags of ``launch ps`` reach the
        run as the JAX package's ``launch ps`` passes them: the same run
        function and Config fields, the same exit 2 and message
        (``--chaos-plan`` with ``--hosts``), or the same refusal."""
        from distlr_tpu.train import ps_trainer as jax_ps_trainer

        from distlr_tpu_torch.train import ps_trainer

        seen = {}
        for mod, who in ((ps_trainer, "ours"), (jax_ps_trainer, "theirs")):
            for fn in ("run_ps_local", "run_ps_workers"):
                monkeypatch.setattr(mod, fn, lambda cfg, *a, _w=who, _f=fn, **kw:
                                    seen.setdefault(_w, (_f, cfg)))
        common = ["ps", "--data-dir", str(tmp_path), "--num-feature-dim", "8", *argv]
        if hosts:
            common += ["--hosts", "127.0.0.1:1"]
        out = []
        for main, extra in ((launch.main, ["--device", "cpu"]), (jax_launch.main, [])):
            with contextlib.redirect_stderr(io.StringIO()) as err:
                try:
                    out.append((main(common + extra), err.getvalue()))
                except ValueError as e:
                    out.append(("ValueError", str(e)))
        assert out[0] == out[1]
        if out[0][0] == "ValueError":
            assert "ps_store_wal requires async mode" in out[0][1]
            return
        if out[0][0] == 2:
            assert hosts and "--chaos-plan applies to local mode" in out[0][1]
            return
        (fn, cfg), (jfn, jcfg) = seen["ours"], seen["theirs"]
        assert fn == jfn == ("run_ps_workers" if hosts else "run_ps_local")
        for f in ("ps_store_dir", "ps_store_interval_s", "ps_store_wal", "ps_store_wal_fsync_s",
                  "chaos_plan", "chaos_seed", "sync_mode"):
            assert getattr(cfg, f) == getattr(jcfg, f), f

    def test_async_store_wal_runs(self, tmp_path, monkeypatch):
        """``launch ps --async --store-wal`` folds ``--async`` into the
        Config before it validates, as both packages' ``ps-server`` do (the
        JAX package's ``launch ps`` validates first and refuses it)."""
        from distlr_tpu_torch.train import ps_trainer

        seen = []
        monkeypatch.setattr(ps_trainer, "run_ps_local", lambda cfg, **kw: seen.append(cfg))
        assert launch.main(["ps", "--data-dir", str(tmp_path), "--num-feature-dim", "8",
                            "--async", "--store-dir", "st", "--store-wal",
                            "--device", "cpu"]) == 0
        assert (seen[0].sync_mode, seen[0].ps_store_wal, seen[0].ps_store_dir) == (
            False, True, "st")

    def test_supervise_servers_needs_async_like_jax(self, tmp_path):
        common = ["ps", "--data-dir", str(tmp_path), "--num-feature-dim", "8",
                  "--supervise-servers"]
        out = []
        for main, extra in ((launch.main, ["--device", "cpu"]), (jax_launch.main, [])):
            with contextlib.redirect_stderr(io.StringIO()) as err:
                out.append((main(common + extra), err.getvalue()))
        assert out[0] == out[1]
        assert out[0][0] == 2 and "--supervise-servers requires --async" in out[0][1]


    @pytest.mark.parametrize("argv", [
        ["--ps-optimizer", "ftrl"],
        ["--ftrl-alpha", "0.3"],
        ["--ftrl-beta", "2.0"],
        ["--ftrl-l1", "0.05"],
        ["--ftrl-l2", "0.5"],
        ["--ps-compress", "int8"],
        ["--accum-start", "2", "--accum-max", "8"],
        ["--accum-growth", "1.5"],
        ["--accum-growth-every", "4"],
        ["--accum-max", "4"],
    ])
    def test_ps_wire_flags_reach_config_like_jax(self, argv, tmp_path, monkeypatch):
        """The FTRL, codec and accumulation flags of ``launch ps`` give the
        run the Config fields the JAX package's ``launch ps`` gives it."""
        from distlr_tpu import launch as jax_launch
        from distlr_tpu.train import ps_trainer as jax_ps_trainer

        from distlr_tpu_torch import launch
        from distlr_tpu_torch.train import ps_trainer

        seen = {}
        monkeypatch.setattr(ps_trainer, "run_ps_local",
                            lambda cfg, **kw: seen.setdefault("ours", cfg))
        monkeypatch.setattr(jax_ps_trainer, "run_ps_local",
                            lambda cfg, **kw: seen.setdefault("theirs", cfg))
        common = ["ps", "--data-dir", str(tmp_path), "--num-feature-dim", "8", *argv]
        assert launch.main([*common, "--device", "cpu"]) == 0
        assert jax_launch.main(common) == 0
        for f in ("ps_optimizer", "ftrl_alpha", "ftrl_beta", "ftrl_l1", "ftrl_l2",
                  "ps_compress", "ps_accum_start", "ps_accum_growth", "ps_accum_growth_every",
                  "ps_accum_max"):
            assert getattr(seen["ours"], f) == getattr(seen["theirs"], f), f
        flag_dest = {"--ps-optimizer": "ps_optimizer", "--ps-compress": "ps_compress"}
        dest = flag_dest.get(argv[0], argv[0][2:].replace("-", "_").replace("accum", "ps_accum"))
        assert getattr(seen["ours"], dest) != getattr(Config(device="cpu"), dest)

    @pytest.mark.parametrize("argv,writer", [
        (["--model", "sparse_lr"], "ctr"),
        (["--model", "blocked_lr", "--block-size", "8"], "raw"),
    ])
    def test_keyed_models_train_through_launch_ps(self, argv, writer, tmp_path):
        """``launch ps`` trains the keyed families (sync, 2 workers x 2
        servers) and each worker writes its model."""
        from distlr_tpu_torch import launch
        from distlr_tpu_torch.data import hashing

        d = str(tmp_path / "d")
        if writer == "ctr":
            hashing.write_ctr_shards(d, 400, 4, 50, 64, 2, seed=1)
        else:
            hashing.write_raw_ctr_shards(d, 400, 4, 50, 2, seed=1)
        assert launch.main(["ps", "--data-dir", d, "--num-feature-dim", "64", "--device", "cpu",
                            "--num-workers", "2", "--num-servers", "2", "--num-iteration", "2",
                            "--batch-size", "50", "--test-interval", "1", *argv]) == 0
        for part in ("part-001", "part-002"):
            with open(os.path.join(d, "models", part)) as f:
                assert f.readline().strip() == "64"
                assert len(f.readline().split()) == 64


def _subparsers(main_fn) -> dict:
    """The subcommand parsers ``main_fn`` builds, read by stopping it at
    ``parse_args``."""
    from unittest import mock

    class _Built(Exception):
        pass

    def stop(parser, *a, **k):
        raise _Built(parser)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", stop):
        try:
            main_fn(["sync"])
        except _Built as built:
            parser = built.args[0]
    (sub,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return parser, sub.choices


# both CLIs' parsers, built once for every case below
_JAX_PARSER, _JAX_SUBS = _subparsers(jax_launch.main)
_PARSER, _SUBS = _subparsers(launch.main)
_SHARED_CASES = [(cmd, opt) for cmd in _SUBS if cmd in _JAX_SUBS
                 for opt in sorted({o for a in _JAX_SUBS[cmd]._actions for o in a.option_strings}
                                   - {"-h", "--help"})]

# flags whose value must come with another flag to be valid in both packages
_WITH = {"--accum-start": ["--accum-max", "4"],
         "--block-groups": ["--model", "blocked_lr", "--block-size", "4"],
         "--store-wal": ["--store-dir", "st"]}
# the subcommands with no Config: their flags go to the writers (gen-data),
# to the coordinator's client (ps-ctl) and to the aggregator's readers (top,
# fleet-query), as in the JAX package
_NO_CONFIG = ("gen-data", "ps-ctl", "top", "fleet-query")
_VALUE = {"--accum-growth": "2.5", "--coordinator": "127.0.0.1:1", "--block-size": "4",
          "--eject-after": "5", "--probe-backoff": "0.25", "--ps-retry-backoff-max": "5000"}
# the flags a command maps onto Config fields itself (the JAX package's
# cmd_serve / cmd_route overrides)
_COMMAND_FIELDS = {
    "serve": {"port": "serve_port", "bind": "serve_host",
              "serve_max_batch_size": "serve_max_batch_size",
              "max_wait_ms": "serve_max_wait_ms", "reload_interval": "serve_reload_interval_s",
              "hot_rows": "serve_hot_rows", "hot_min_coverage": "serve_hot_min_coverage",
              "hot_full_every": "serve_hot_full_every",
              "engine_idle_evict": "serve_engine_idle_evict_s", "model_id": "serve_model_id",
              "feedback_spool": "feedback_spool_dir", "feedback_shards": "feedback_shard_dir",
              "feedback_window": "feedback_window_s",
              "feedback_negative_rate": "feedback_negative_rate",
              "feedback_shard_records": "feedback_shard_records",
              "feedback_capacity": "feedback_capacity", "drift_block": "feedback_drift_block",
              "drift_threshold": "feedback_drift_threshold"},
    "route": {"port": "route_port", "bind": "route_host", "max_inflight": "route_max_inflight",
              "eject_after": "route_eject_after", "health_interval": "route_health_interval_s",
              "probe_backoff": "route_probe_backoff_s",
              "probe_backoff_max": "route_probe_backoff_max_s",
              "backend_timeout": "route_backend_timeout_s", "quota": "route_quota"},
}


def _flag_value(action, opt: str) -> list[str]:
    """A value of ``opt`` other than its default, valid in both packages."""
    if action.nargs == 0:
        return []
    if opt in _VALUE:
        return [_VALUE[opt]]
    if action.choices:
        return [[c for c in action.choices if c != action.default][-1]]
    if action.type is int:
        return ["3"]
    if action.type is float:
        return ["0.5"]
    return ["x"]


@pytest.mark.parametrize("cmd,opt", _SHARED_CASES, ids=[f"{c}:{o}" for c, o in _SHARED_CASES])
def test_shared_flags_match_jax(cmd, opt):
    """Every option string of a JAX subcommand parses on the port's twin
    into the same dest, value and default, then reaches the same Config
    field as in the JAX package, or is refused by both Configs alike."""
    (action,) = [a for a in _JAX_SUBS[cmd]._actions if opt in a.option_strings]
    # a required flag with a value; a required positional with its first
    # choice (ps-ctl's command) or a value (fleet-query's expression)
    required = [x for a in _JAX_SUBS[cmd]._actions if a.required
                for x in ((a.option_strings[0], "x") if a.option_strings
                          else (a.choices[0] if a.choices else "x",))
                if not a.option_strings or a.option_strings[0] != opt]
    argv = [cmd, *required, *_WITH.get(opt, []), opt, *_flag_value(action, opt)]
    device = ["--device", "cpu"] if cmd not in _NO_CONFIG else []
    if not action.required:
        ours_default = _PARSER.parse_args([cmd, *required] + device)
        theirs_default = _JAX_PARSER.parse_args([cmd, *required])
        assert getattr(ours_default, action.dest) == getattr(theirs_default, action.dest)
    ours = _PARSER.parse_args(argv + device)
    theirs = _JAX_PARSER.parse_args(argv)
    assert getattr(ours, action.dest) == getattr(theirs, action.dest)
    if cmd in _NO_CONFIG:
        return
    try:
        jax_cfg = jax_launch._config_from_args(theirs)
    except ValueError as e:
        # refused by the JAX package's Config: by the port's with its text
        with pytest.raises(ValueError) as ours_err:
            launch.command_config(ours)
        assert str(ours_err.value) == str(e)
        return
    cfg = launch.command_config(ours)
    if action.dest in _COMMAND_FIELDS.get(cmd, {}):
        field = _COMMAND_FIELDS[cmd][action.dest]
        assert getattr(cfg, field) == getattr(theirs, action.dest) != getattr(Config(), field)
    elif action.dest in {f.name for f in dataclasses.fields(Config)}:
        assert getattr(cfg, action.dest) == getattr(jax_cfg, action.dest)
    elif action.dest == "feature_shards":
        assert (cfg.mesh_shape, cfg.feature_shards) == (jax_cfg.mesh_shape,
                                                        jax_cfg.feature_shards)


class TestDeviceRule:
    def test_default_trainer_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            Trainer(Config())

    def test_cpu_on_request(self):
        assert resolve_device("cpu") == torch.device("cpu")
        assert Trainer(Config(device="cpu")).device.type == "cpu"

    def test_other_devices_rejected(self):
        with pytest.raises(ValueError, match="cuda, cuda:N or cpu"):
            resolve_device("meta")


class TestKernelBuild:
    def test_default_build_dir_is_the_checkouts_build_kernels(self):
        assert build.default_build_dir() == REPO / "build" / "kernels"
        path = build.library_path("fused_lr_grad")
        assert path.parent == REPO / "build" / "kernels"
        assert re.fullmatch(r"libfused_lr_grad-[0-9a-f]{16}\.so", path.name)

    def test_nvcc_command_targets_sm90a(self, tmp_path, monkeypatch):
        calls = []

        def fake_run(cmd, **kw):
            calls.append(cmd)
            return subprocess.CompletedProcess(cmd, 0, "", "")

        monkeypatch.setattr(build, "find_nvcc", lambda: "/toolkit/bin/nvcc")
        monkeypatch.setattr(subprocess, "run", fake_run)
        out = build.build("fused_lr_grad", build_dir=tmp_path)
        assert out == build.library_path("fused_lr_grad", tmp_path) and out.exists()
        (cmd,) = calls
        assert cmd[0] == "/toolkit/bin/nvcc"
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
        for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
            assert flag in cmd
        assert cmd[-1] == str(build.CSRC_DIR / "fused_lr_grad.cu")
        assert Path(cmd[cmd.index("-o") + 1]).parent == tmp_path
        # a built library is reused, not rebuilt
        build.build("fused_lr_grad", build_dir=tmp_path)
        assert len(calls) == 1

    def test_edited_source_builds_anew(self, tmp_path, monkeypatch):
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        src = csrc / "k.cu"
        src.write_text("// v1\n")
        monkeypatch.setattr(build, "CSRC_DIR", csrc)
        first = build.library_path("k", tmp_path)
        src.write_text("// v2\n")
        assert build.library_path("k", tmp_path) != first

    def test_defines_build_a_library_of_their_own(self, tmp_path, monkeypatch):
        calls = []

        def fake_run(cmd, **kw):
            calls.append(cmd)
            return subprocess.CompletedProcess(cmd, 0, "", "")

        monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
        monkeypatch.setattr(subprocess, "run", fake_run)
        plain = build.build("fused_lr_grad", build_dir=tmp_path)
        traced = build.build("fused_lr_grad", build_dir=tmp_path, defines=("DISTLR_SLICE_TRACE",))
        assert traced != plain and traced.exists()
        assert "-DDISTLR_SLICE_TRACE" in calls[1] and "-DDISTLR_SLICE_TRACE" not in calls[0]

    def test_slice_kernel_benchmark_needs_the_card(self, capsys):
        from distlr_tpu_torch.benchmarks import slice_kernels

        assert slice_kernels.main(["--sweep", "--trace"]) == 2
        assert "needs the card" in capsys.readouterr().err

    def test_wide_sweep_needs_the_card(self, capsys):
        from distlr_tpu_torch.benchmarks import slice_kernels

        assert slice_kernels.main(["--wide", "--batch", "8"]) == 2
        assert "needs the card" in capsys.readouterr().err

    def test_main_path_bits_needs_the_card(self, capsys):
        from distlr_tpu_torch.benchmarks import main_path_bits

        assert main_path_bits.main([]) == 2
        assert "needs the card" in capsys.readouterr().err

    def test_main_path_bits_inputs_are_pinned(self):
        """The digest's inputs come from an integer hash of each index:
        these bits on any machine, whatever the chunking."""
        from distlr_tpu_torch.benchmarks import main_path_bits as bits

        u = bits.hashed_uniform((4, 1000), 0, "cpu")
        assert torch.equal(bits.hashed_uniform((4, 1000), 0, "cpu", chunk=333), u)
        assert float(u.min()) >= -1.0 and float(u.max()) < 1.0
        assert bits.digest(u) == "db76f50582a637a0"
        w, X, y, mask = bits.hashed_inputs(6, 1000, "cpu", masked=2)
        assert X.dtype == torch.bfloat16 and bits.digest(X) == "a4cdee1e4962c59b"
        assert bits.digest(w) == "f832743c3da92667"
        assert y.tolist() == [1, 0, 1, 0, 0, 0] and mask.tolist() == [1, 1, 1, 1, 0, 0]

    def test_compiler_failure_raises_with_its_output(self, tmp_path, monkeypatch):
        monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
        monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: subprocess.CompletedProcess(
            cmd, 2, "", "fused_lr_grad.cu(1): error: bad"))
        with pytest.raises(RuntimeError, match="error: bad"):
            build.build("fused_lr_grad", build_dir=tmp_path)
        # no half-written library left: only the library's build lock
        lib = build.library_path("fused_lr_grad", tmp_path)
        assert [p.name for p in tmp_path.iterdir()] == [f".{lib.name}.lock"]

    def test_missing_nvcc_raises(self, monkeypatch):
        import torch.utils.cpp_extension as cpp_ext

        monkeypatch.setattr(build.shutil, "which", lambda name: None)
        monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.find_nvcc()


class TestMeshCLI:
    """``--feature-shards`` (the 2D feature-sharded step) and ``--cpu-devices``."""

    @pytest.mark.parametrize("argv", [
        ["--feature-shards", "2"],
        ["--num-workers", "2", "--feature-shards", "4"],
        ["--num-workers", "3"],
    ])
    def test_flags_give_jax_mesh_shape(self, argv):
        import argparse

        from distlr_tpu import launch as jax_launch
        from distlr_tpu_torch import launch

        jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
        jax_launch._add_config_flags(jp)
        launch._add_config_flags(tp)
        launch._add_mesh_flags(tp)
        common = ["--num-feature-dim", "24"]
        j = jax_launch._config_from_args(jp.parse_args(common + argv))
        t = launch._config_from_args(tp.parse_args(common + argv + ["--device", "cpu"]))
        for f in ("mesh_shape", "feature_shards", "num_workers"):
            assert getattr(t, f) == getattr(j, f), f

    def test_sync_feature_shards_writes_jax_weights(self, tmp_path):
        from distlr_tpu.config import Config as JaxConfig
        from distlr_tpu.train import Trainer as JaxTrainer
        from distlr_tpu_torch.train import load_model_text

        d = str(tmp_path / "d")
        common = ["--data-dir", d, "--num-feature-dim", "24"]
        _launch("gen-data", *common, "--num-samples", "1200", "--num-parts", "2")
        flags = [*common, "--num-workers", "2", "--feature-shards", "2", "--device", "cpu"]
        out = _launch("sync", *flags, "--num-iteration", "6", "--test-interval", "3",
                      "--learning-rate", "0.5", "--l2-c", "0.01").stdout
        evals = EVAL_LINE.findall(out)
        assert [int(n) for n, _ in evals] == [3, 6]
        model_file = os.path.join(d, "models", "part-001")

        kw = dict(data_dir=d, num_feature_dim=24, num_iteration=6, learning_rate=0.5,
                  l2_c=0.01, test_interval=0, num_workers=2,
                  mesh_shape={"data": 2, "model": 2}, feature_shards=2)
        jt = JaxTrainer(JaxConfig(**kw)).load_data()
        # the port's seeded init (JAX's own is another generator)
        w0 = Trainer(Config(device="cpu", **kw)).init_weights().numpy()
        jt.weights = jt._shard_weights(w0)
        assert jt.feature_sharded
        import numpy as np

        # bf16 products (both CLIs' default): the update is held at rel 1e-2
        got, want = load_model_text(model_file) - w0, np.asarray(jt.fit()) - w0
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
        # eval on the column blocks scores what the last sync line reported
        ev = _launch("eval", *flags, "--model-file", model_file).stdout
        m = re.search(r"accuracy: (\S+)\s+test_logloss: (\S+)", ev)
        assert m is not None and float(m.group(1)) == pytest.approx(float(evals[-1][1]),
                                                                    abs=1e-4)

    def test_feature_shards_must_divide_the_features(self, tmp_path):
        proc = _launch("sync", "--data-dir", str(tmp_path), "--num-feature-dim", "123",
                       "--feature-shards", "2", "--device", "cpu", check=False)
        assert proc.returncode != 0 and "pad the feature dimension" in proc.stderr

    @pytest.mark.parametrize("how", ["flag", "env"])
    def test_cpu_devices_selects_the_cpu(self, tmp_path, how):
        d = str(tmp_path / "d")
        _launch("gen-data", "--data-dir", d, "--num-feature-dim", "8", "--num-samples", "50",
                "--num-parts", "1")
        argv = ["sync", "--data-dir", d, "--num-feature-dim", "8", "--num-iteration", "2"]
        env = {"CUDA_VISIBLE_DEVICES": ""}
        if how == "flag":
            argv += ["--cpu-devices", "4"]
        else:
            env["DISTLR_CPU_DEVICES"] = "4"
        _launch(*argv, env_extra=env)
        assert os.path.exists(os.path.join(d, "models", "part-001"))
