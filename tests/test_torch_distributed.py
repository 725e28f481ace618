"""Multi-process sync of the port over ``torch.distributed``, on the CPU.

Two ``gloo`` ranks of ``python -m distlr_tpu_torch.launch sync --device
cpu --coordinator ... --num-processes 2 --process-id i`` train one job
whose global data axis spans the processes: both must exit cleanly,
export the same weights to ``part-001`` and ``part-002``, and equal the
port's single-process run of the same row blocks byte for byte (the same
adds: a sum of two is the same either way).  That single-process run,
with f32 products, matches the JAX package's single-process oracle on
the same mesh from the same initial weights at rtol 1e-5, as
``tests/test_distributed.py`` holds its two JAX processes.  And one
command line, run through both packages' CLIs as two processes, gives
the same mesh and the same weights (bf16 products: rel 1e-2).
"""

import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.train import Trainer as JaxTrainer
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.data import write_synthetic_shards
from distlr_tpu_torch.train import Trainer, load_model_text, save_model_text

REPO = Path(__file__).resolve().parents[1]
COMMON = dict(num_feature_dim=24, num_iteration=5, batch_size=-1, learning_rate=0.5, l2_c=0.0)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _flags(cfg: dict) -> list[str]:
    out = []
    for k, v in cfg.items():
        out += [f"--{k.replace('_', '-')}", str(v)]
    return out


def _run_ranks(data_dir: str, extra: list[str], n: int = 2, *,
               package: str = "distlr_tpu_torch", check: bool = True) -> list[str]:
    """``<package>.launch sync`` as ``n`` ranks (gloo on ``--device cpu``
    for the port); each one's output, each exit code 0 (``check``) or not.
    A crashed rank leaves its peers blocked in a collective, so every child
    is killed on the way out."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # JAX children set their own device counts
    argv = [sys.executable, "-m", f"{package}.launch", "sync", "--data-dir", data_dir,
            *_flags(COMMON), "--test-interval", "5",
            "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", str(n), *extra]
    procs = [subprocess.Popen(argv + ["--process-id", str(i)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert (p.returncode == 0) == check, out
    return outs


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return tmp_path_factory.mktemp("torch_dist")


def _data(root, name: str) -> str:
    d = str(root / name)
    write_synthetic_shards(d, 1200, 24, num_parts=2, seed=7)
    return d


@pytest.mark.parametrize("variant,extra,mesh_kw", [
    # no mesh flags: one row block a process, {"data": 2}
    ("plain", [], {}),
    # Q1: the last rank's block stands in for the last-arriving worker
    ("q1", ["--compat-mode", "reference"], {"compat_mode": "reference"}),
    # the global mesh {"data": 2, "model": 2}: a row block a process, each
    # cut into two column blocks
    ("feature_shards", ["--num-workers", "2", "--feature-shards", "2"],
     {"num_workers": 2, "mesh_shape": {"data": 2, "model": 2}, "feature_shards": 2}),
])
def test_two_gloo_ranks_agree(data_root, variant, extra, mesh_kw):
    d = _data(data_root, variant)
    outs = _run_ranks(d, [*extra, "--device", "cpu"])
    for out in outs:
        assert "joined distributed run: process" in out and "gloo" in out
    parts = [os.path.join(d, "models", f"part-00{i}") for i in (1, 2)]
    with open(parts[0], "rb") as a, open(parts[1], "rb") as b:
        assert a.read() == b.read()  # every process exports the same weights

    # the port in one process over the same two row blocks: the same bytes
    kw = {"num_workers": 2, "mesh_shape": {"data": 2}, **mesh_kw}
    one = Trainer(Config(data_dir=d, device="cpu", test_interval=0, **COMMON, **kw)).load_data()
    alone = os.path.join(d, "alone.txt")
    save_model_text(alone, one.fit().numpy())
    with open(parts[0], "rb") as a, open(alone, "rb") as b:
        assert a.read() == b.read()

    # that run with f32 products against the JAX package in one process over
    # the same mesh, from the port's initial weights (its seeded init is not
    # JAX's; Q2's is the same bits)
    f32 = dict(data_dir=d, compute_dtype="float32", test_interval=0, **COMMON, **kw)
    w_port = Trainer(Config(device="cpu", **f32)).load_data().fit().numpy()
    jt = JaxTrainer(JaxConfig(**f32)).load_data()
    jt.weights = jt._shard_weights(Trainer(one.cfg).init_weights().numpy())
    np.testing.assert_allclose(w_port, np.asarray(jt.fit()), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant,extra", [
    # the global data axis: 4 row blocks, 2 a process; Q1 applies block 3's
    ("four_blocks", ["--num-workers", "4", "--cpu-devices", "2"]),
    # {"data": 2, "model": 2} over the two processes
    ("feature_shards", ["--num-workers", "2", "--feature-shards", "2", "--cpu-devices", "2"]),
    # no mesh flags: every device (one a process) on the data axis
    ("default", ["--cpu-devices", "1"]),
])
def test_same_flags_through_both_clis(data_root, variant, extra):
    """One command line of two processes gives JAX's global mesh and its
    weights in the port (``--cpu-devices`` selects the CPU there).  Q2's
    init (``--compat-mode reference``) is the same bits in both packages;
    the products are bf16, so the update is held at rel 1e-2."""
    d = _data(data_root, f"cli_{variant}")
    d_jax = str(data_root / f"cli_{variant}_jax")
    shutil.copytree(d, d_jax)
    argv = [*extra, "--compat-mode", "reference"]
    _run_ranks(d, argv)
    _run_ranks(d_jax, argv, package="distlr_tpu")
    w0 = Trainer(Config(device="cpu", compat_mode="reference", **COMMON)).init_weights().numpy()
    for i in (1, 2):
        got = load_model_text(os.path.join(d, "models", f"part-00{i}"))
        want = load_model_text(os.path.join(d_jax, "models", f"part-00{i}"))
        rel = np.abs((got - w0) - (want - w0)).max() / np.abs(want - w0).max()
        assert rel <= 1e-2, rel


def test_data_axis_must_split_over_the_processes(data_root):
    """``--feature-shards 2`` alone is the mesh {"data": 1, "model": 2}: JAX
    lays its model axis over the two processes; the port keeps a model axis
    inside a process, so every rank refuses rather than train another mesh."""
    d = _data(data_root, "one_block")
    outs = _run_ranks(d, ["--feature-shards", "2", "--device", "cpu"], check=False)
    for out in outs:
        assert "a data axis of 1 row blocks does not split over 2 processes" in out


def test_rank_zero_checkpoints_and_every_rank_resumes(data_root):
    """Rank 0 writes the ``.npz`` checkpoints (after every rank got there);
    on ``--resume`` every rank reads the latest and the run goes on, to
    the weights of an uninterrupted run."""
    from distlr_tpu_torch.train.checkpoint import Checkpointer

    d = _data(data_root, "resume")
    ck = os.path.join(d, "ck")
    ckpt = ["--checkpoint-dir", ck, "--checkpoint-interval", "2"]
    _run_ranks(d, [*ckpt, "--num-iteration", "2", "--device", "cpu"])
    with Checkpointer(ck) as c:
        assert c.all_steps() == [2]
    outs = _run_ranks(d, [*ckpt, "--num-iteration", "5", "--resume", "--device", "cpu"])
    for out in outs:
        assert "resumed from checkpoint at epoch 2" in out
    with Checkpointer(ck) as c:
        assert c.all_steps() == [2, 4, 5]
    resumed = load_model_text(os.path.join(d, "models", "part-002"))
    straight = Trainer(Config(data_dir=d, device="cpu", test_interval=0, num_workers=2,
                              **COMMON)).load_data()
    np.testing.assert_allclose(resumed, straight.fit().numpy(), rtol=1e-5, atol=1e-6)


def test_rank_needs_its_peers_flags(tmp_path):
    """--coordinator without the process count and id is refused before
    any rendezvous."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", "sync",
                           "--data-dir", str(tmp_path), "--device", "cpu",
                           "--coordinator", "127.0.0.1:1"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "--num-processes and --process-id" in proc.stderr
