"""The port's checkpoints and resume (``checkpoint_dir`` /
``checkpoint_interval`` / ``fit(resume=True)``), on the CPU.

Mirrors ``tests/test_checkpoint.py`` for the sync trainer.  A resumed run
must equal an uninterrupted one bit for bit: the data, the batches and
the arithmetic are the same, and the checkpoint holds the weights'
float32 bits.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distlr_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.data import write_synthetic_shards
from distlr_tpu_torch.data.hashing import write_raw_ctr_shards
from distlr_tpu_torch.train import Trainer
from distlr_tpu_torch.train.checkpoint import Checkpointer

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckptdata")
    write_synthetic_shards(str(d), 800, 24, num_parts=4, seed=2, sparsity=0.0)
    return str(d)


class TestCheckpointer:
    def test_save_restore_roundtrip(self, tmp_path):
        with Checkpointer(str(tmp_path / "ck")) as ck:
            w = np.random.default_rng(0).standard_normal(10).astype(np.float32)
            ck.save(5, w, extra={"epoch": 5})
            assert ck.latest_step() == 5
            state = ck.restore()
            np.testing.assert_array_equal(state["weights"], w)
            assert state["weights"].dtype == np.float32
            assert int(state["epoch"]) == 5

    def test_saves_a_tensor_and_restores_a_given_step(self, tmp_path):
        with Checkpointer(str(tmp_path / "ck")) as ck:
            for s in (1, 2):
                ck.save(s, torch.full((2, 3), float(s)), extra={"epoch": s})
            np.testing.assert_array_equal(ck.restore(1)["weights"], np.ones((2, 3), np.float32))
            assert int(ck.restore()["epoch"]) == 2

    def test_restore_empty_returns_none(self, tmp_path):
        with Checkpointer(str(tmp_path / "empty")) as ck:
            assert ck.restore() is None
            assert ck.latest_step() is None and ck.all_steps() == []

    def test_max_to_keep(self, tmp_path):
        with Checkpointer(str(tmp_path / "gc"), max_to_keep=2) as ck:
            for s in (1, 2, 3, 4):
                ck.save(s, np.zeros(3, np.float32), extra={"epoch": s})
            assert ck.all_steps() == [3, 4]

    def test_default_keeps_three_like_jax(self, tmp_path):
        with Checkpointer(str(tmp_path / "a")) as ours, JaxCheckpointer(str(tmp_path / "b")) as theirs:
            for s in (1, 2, 3, 4, 5):
                for ck in (ours, theirs):
                    ck.save(s, np.full(4, s, np.float32), extra={"epoch": s})
            assert ours.all_steps() == theirs.all_steps() == [3, 4, 5]
            for k in ("weights", "epoch"):
                np.testing.assert_array_equal(ours.restore()[k], theirs.restore()[k])

    def test_no_partial_files_left(self, tmp_path):
        d = tmp_path / "clean"
        with Checkpointer(str(d)) as ck:
            ck.save(1, np.zeros(3, np.float32))
        assert os.listdir(d) == ["ckpt-1.npz"]


def _dense(data_dir, ck_dir, epochs, interval=5):
    return Config(data_dir=data_dir, num_feature_dim=24, learning_rate=0.5, l2_c=0.0,
                  test_interval=0, num_workers=4, num_iteration=epochs,
                  checkpoint_dir=ck_dir, checkpoint_interval=interval, device="cpu")


class TestTrainerResume:
    def test_resume_matches_uninterrupted_bit_for_bit(self, data_dir, tmp_path):
        w_full = Trainer(_dense(data_dir, str(tmp_path / "full"), 20)).load_data().fit()
        ck = str(tmp_path / "resume")
        Trainer(_dense(data_dir, ck, 10)).load_data().fit()
        w_resumed = Trainer(_dense(data_dir, ck, 20)).load_data().fit(resume=True)
        assert torch.equal(w_resumed, w_full)

    def test_resume_with_no_checkpoint_starts_fresh(self, data_dir, tmp_path):
        cfg = _dense(data_dir, str(tmp_path / "fresh"), 3, interval=0)
        w = Trainer(cfg).load_data().fit(resume=True)
        w_plain = Trainer(cfg.replace(checkpoint_dir=None)).load_data().fit()
        assert torch.equal(w, w_plain)

    def test_final_checkpoint_written(self, data_dir, tmp_path):
        ck_dir = str(tmp_path / "final_ck")
        tr = Trainer(_dense(data_dir, ck_dir, 7)).load_data()
        tr.fit()
        with Checkpointer(ck_dir) as ck:
            assert ck.latest_step() == 7
            assert 5 in ck.all_steps()
            np.testing.assert_array_equal(ck.restore()["weights"], tr.weights.numpy())

    def test_resume_past_the_end_trains_nothing(self, data_dir, tmp_path):
        ck = str(tmp_path / "done")
        w = Trainer(_dense(data_dir, ck, 4)).load_data().fit()
        again = Trainer(_dense(data_dir, ck, 4)).load_data().fit(resume=True)
        assert torch.equal(again, w)

    def test_blocked_family_resume_matches_uninterrupted(self, tmp_path):
        """The checkpoint carries the (rows, R) table, not a flat vector."""
        d = str(tmp_path / "rawctr")
        write_raw_ctr_shards(d, 1600, 6, 4, 4, seed=11)
        common = dict(data_dir=d, num_feature_dim=1024, model="blocked_lr", block_size=4,
                      learning_rate=0.5, l2_c=0.0, test_interval=0, checkpoint_interval=3,
                      num_workers=4, device="cpu")
        t_full = Trainer(Config(num_iteration=10, checkpoint_dir=str(tmp_path / "bf"),
                                **common)).load_data().fit()
        ck = str(tmp_path / "br")
        Trainer(Config(num_iteration=5, checkpoint_dir=ck, **common)).load_data().fit()
        t_resumed = Trainer(Config(num_iteration=10, checkpoint_dir=ck,
                                   **common)).load_data().fit(resume=True)
        assert t_resumed.shape == (256, 4)
        assert torch.equal(t_resumed, t_full)


def _launch(*argv):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", *argv],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc


def test_launch_sync_checkpoint_and_resume_on_cpu(tmp_path):
    d, ck = str(tmp_path / "d"), str(tmp_path / "ck")
    _launch("gen-data", "--data-dir", d, "--num-feature-dim", "32", "--num-samples", "600",
            "--num-parts", "2")
    common = ["sync", "--data-dir", d, "--num-feature-dim", "32", "--num-workers", "2",
              "--test-interval", "0", "--device", "cpu", "--checkpoint-dir", ck]
    _launch(*common, "--num-iteration", "4", "--checkpoint-interval", "2")
    with Checkpointer(ck) as c:
        assert c.all_steps() == [2, 4]
    proc = _launch(*common, "--num-iteration", "6", "--checkpoint-interval", "2", "--resume")
    assert "resumed from checkpoint at epoch 4" in proc.stderr
    with Checkpointer(ck) as c:
        assert c.all_steps() == [2, 4, 6]
        resumed = c.restore()["weights"]
    straight = str(tmp_path / "straight")
    _launch("sync", "--data-dir", d, "--num-feature-dim", "32", "--num-workers", "2",
            "--test-interval", "0", "--device", "cpu", "--checkpoint-dir", straight,
            "--num-iteration", "6")
    with Checkpointer(straight) as c:
        np.testing.assert_array_equal(resumed, c.restore()["weights"])
