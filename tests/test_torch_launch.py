"""The port's CLI, its device rule and its kernel build, on the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distlr_tpu_torch.config import Config
from distlr_tpu_torch.ops import build
from distlr_tpu_torch.train import Trainer
from distlr_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
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
        proc = _launch("sync", "--data-dir", str(tmp_path), "--model", "softmax",
                       "--device", "cpu", check=False)
        assert proc.returncode != 0
        assert "ROADMAP A.2" in proc.stderr


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
        monkeypatch.setattr(build.subprocess, "run", fake_run)
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
        monkeypatch.setattr(build.subprocess, "run", fake_run)
        plain = build.build("fused_lr_grad", build_dir=tmp_path)
        traced = build.build("fused_lr_grad", build_dir=tmp_path, defines=("DISTLR_SLICE_TRACE",))
        assert traced != plain and traced.exists()
        assert "-DDISTLR_SLICE_TRACE" in calls[1] and "-DDISTLR_SLICE_TRACE" not in calls[0]

    def test_slice_kernel_benchmark_needs_the_card(self, capsys):
        from distlr_tpu_torch.benchmarks import slice_kernels

        assert slice_kernels.main(["--sweep", "--trace"]) == 2
        assert "needs the card" in capsys.readouterr().err

    def test_compiler_failure_raises_with_its_output(self, tmp_path, monkeypatch):
        monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
        monkeypatch.setattr(build.subprocess, "run", lambda cmd, **kw: subprocess.CompletedProcess(
            cmd, 2, "", "fused_lr_grad.cu(1): error: bad"))
        with pytest.raises(RuntimeError, match="error: bad"):
            build.build("fused_lr_grad", build_dir=tmp_path)
        assert list(tmp_path.iterdir()) == []  # no half-written library left

    def test_missing_nvcc_raises(self, monkeypatch):
        import torch.utils.cpp_extension as cpp_ext

        monkeypatch.setattr(build.shutil, "which", lambda name: None)
        monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.find_nvcc()
