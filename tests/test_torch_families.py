"""The four other model families of the port against the JAX package's, on
the CPU: ``SoftmaxRegression``, ``SparseBinaryLR``,
``SparseSoftmaxRegression`` and ``BlockedSparseLR`` on shared numpy
inputs, their data paths, ``Trainer.fit`` on the same shards, the text
export of 2-D params, and the ``launch gen-data -> sync -> eval`` chain.

Tolerances: float32 rtol 1e-5 / atol 1e-6 (same math, f32 sums in another
order; the JAX scatter is a ``segment_sum``, the port's an ``index_add_``).
Dense softmax with bfloat16 products rounds X, W and the residual to bf16
at the JAX model's points, then sums in f32: on these inputs the worst
max |Δ| / max |JAX| measured 1.2e-7 (logits, 9.5e-7 absolute) and 1.0e-7
(gradient), held at the same rtol 1e-5 / atol 1e-6.  ``Trainer.fit``:
rtol 1e-4 over the whole run.
"""

import argparse
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.data.hashing import write_ctr_shards as jax_write_ctr_shards
from distlr_tpu.models import get_model as jax_get_model
from distlr_tpu.parallel import make_mesh
from distlr_tpu.train import GlobalShardedData as JaxGlobalShardedData
from distlr_tpu.train import Trainer as JaxTrainer
from distlr_tpu.train.export import load_model_text as jax_load_model_text
from distlr_tpu.train.export import save_model_text as jax_save_model_text
from distlr_tpu_torch import launch
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.convert import params_from_jax, params_to_numpy
from distlr_tpu_torch.data import write_synthetic_shards
from distlr_tpu_torch.data.hashing import write_raw_ctr_shards
from distlr_tpu_torch.models import (
    BlockedSparseLR,
    SoftmaxRegression,
    SparseBinaryLR,
    SparseSoftmaxRegression,
    get_model,
)
from distlr_tpu_torch.train import GlobalShardedData, Trainer, load_model_text, save_model_text

B, D, K, F, R = 40, 64, 4, 5, 4
FAMILIES = ["softmax", "softmax_bf16", "sparse_lr", "sparse_softmax", "blocked_lr"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These checks are tiny: one intra-op thread keeps them from crowding
    the suite's timing-sensitive tests running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config_kw(family):
    kw = {"num_feature_dim": D, "l2_c": 0.3}
    if family.startswith("softmax"):
        kw.update(model="softmax", num_classes=K,
                  compute_dtype="bfloat16" if family == "softmax_bf16" else "float32")
    elif family == "sparse_softmax":
        kw.update(model="sparse_softmax", num_classes=K)
    elif family == "blocked_lr":
        kw.update(model="blocked_lr", block_size=R)
    else:
        kw.update(model=family)
    return kw


def _inputs(family, seed, masked_tail=6):
    """(params, batch) as numpy: dense X for softmax, padded COO for the
    sparse families (pad col 0, pad val 0), row blocks for blocked_lr."""
    rng = np.random.default_rng(seed)
    classes = K if "softmax" in family else 2
    y = rng.integers(0, classes, B).astype(np.int32)
    mask = np.ones(B, np.float32)
    if masked_tail:
        mask[-masked_tail:] = 0
    if family.startswith("softmax"):
        X = rng.standard_normal((B, D)).astype(np.float32)
        return (rng.standard_normal((D, K)) * 0.3).astype(np.float32), (X, y, mask)
    if family == "blocked_lr":
        blocks = rng.integers(0, D // R, (B, 3)).astype(np.int32)
        lane = rng.standard_normal((B, 3, R)).astype(np.float32)
        lane[:, -1, 2:] = 0.0
        return (rng.standard_normal((D // R, R)) * 0.3).astype(np.float32), (blocks, lane, y, mask)
    cols = rng.integers(0, D, (B, F)).astype(np.int32)
    vals = rng.standard_normal((B, F)).astype(np.float32)
    cols[::3, -2:], vals[::3, -2:] = 0, 0.0
    shape = (D, K) if family == "sparse_softmax" else (D,)
    return (rng.standard_normal(shape) * 0.3).astype(np.float32), (cols, vals, y, mask)


def _pair(family, compat_mode):
    kw = _config_kw(family)
    jcfg = JaxConfig(compat_mode=compat_mode, **kw)
    cfg = Config(compat_mode=compat_mode, device="cpu", **kw)
    return jax_get_model(jcfg), get_model(cfg), jcfg, cfg


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-5, atol=1e-6)


def _as_jax(w, batch):
    return jnp.asarray(w), tuple(jnp.asarray(a) for a in batch)


def _as_torch(w, batch):
    return torch.from_numpy(w), tuple(torch.from_numpy(a) for a in batch)


@pytest.mark.parametrize("compat_mode", ["correct", "reference"])
@pytest.mark.parametrize("family", FAMILIES)
class TestModelParity:
    def test_logits_loss_grad(self, family, compat_mode):
        jm, tm, jcfg, cfg = _pair(family, compat_mode)
        w, batch = _inputs(family, 0)
        jw, jb = _as_jax(w, batch)
        tw, tb = _as_torch(w, batch)
        _close(tm.logits(tw, *tb[:-2]), jm.logits(jw, *jb[:-2]))
        _close(tm.loss(tw, tb, cfg), jm.loss(jw, jb, jcfg))
        _close(tm.grad(tw, tb, cfg), jm.grad(jw, jb, jcfg))
        loss, g = tm.value_and_grad(tw, tb, cfg)
        assert g.shape == tm.param_shape == tuple(jm.param_shape)
        _close(loss, jm.loss(jw, jb, jcfg))
        _close(g, jm.grad(jw, jb, jcfg))

    def test_predict_proba_accuracy_logloss(self, family, compat_mode):
        jm, tm, _, _ = _pair(family, compat_mode)
        w, batch = _inputs(family, 1)
        jw, jb = _as_jax(w, batch)
        tw, tb = _as_torch(w, batch)
        np.testing.assert_array_equal(tm.predict(tw, *tb[:-2]).numpy(),
                                      np.asarray(jm.predict(jw, *jb[:-2])))
        _close(tm.proba(tw, *tb[:-2]), jm.proba(jw, *jb[:-2]))
        _close(tm.accuracy(tw, tb), jm.accuracy(jw, jb))
        _close(tm.logloss(tw, tb), jm.logloss(jw, jb))

    def test_all_padding_batch(self, family, compat_mode):
        """n = max(sum(mask), 1): no division by zero, only the L2 term."""
        jm, tm, jcfg, cfg = _pair(family, compat_mode)
        w, batch = _inputs(family, 2)
        batch = (*batch[:-1], np.zeros(B, np.float32))
        jw, jb = _as_jax(w, batch)
        tw, tb = _as_torch(w, batch)
        g = tm.grad(tw, tb, cfg)
        assert torch.isfinite(g).all()
        _close(g, jm.grad(jw, jb, jcfg))
        _close(g, cfg.l2_c * w)
        _close(tm.loss(tw, tb, cfg), jm.loss(jw, jb, jcfg))


class TestInitAndDispatch:
    @pytest.mark.parametrize("family", ["softmax", "sparse_lr", "sparse_softmax"])
    def test_reference_init_bit_equal_to_jax(self, family):
        jm, tm, jcfg, cfg = _pair(family, "reference")
        np.testing.assert_array_equal(tm.init(cfg).numpy(), np.asarray(jm.init(jcfg)))

    @pytest.mark.parametrize("family", ["sparse_lr", "sparse_softmax", "blocked_lr"])
    def test_sparse_families_start_at_zeros(self, family):
        jm, tm, jcfg, cfg = _pair(family, "correct")
        w = tm.init(cfg)
        assert w.dtype == torch.float32 and w.shape == tm.param_shape
        assert not w.any() and not np.asarray(jm.init(jcfg)).any()

    def test_blocked_ignores_reference_init(self):
        _, tm, _, cfg = _pair("blocked_lr", "reference")
        assert not tm.init(cfg).any()

    def test_softmax_uniform_init_is_seeded(self):
        m = SoftmaxRegression(D, K)
        a, b = m.init(Config(random_seed=3, device="cpu")), m.init(Config(random_seed=3, device="cpu"))
        assert torch.equal(a, b) and a.shape == (D, K) and 0 <= a.min() and a.max() < 1

    @pytest.mark.parametrize("family", ["softmax", "sparse_softmax"])
    def test_zero_weights_predict_class_zero(self, family):
        jm, tm, _, _ = _pair(family, "correct")
        w, batch = _inputs(family, 3)
        w = np.zeros_like(w)
        jw, jb = _as_jax(w, batch)
        tw, tb = _as_torch(w, batch)
        assert not tm.predict(tw, *tb[:-2]).any()
        assert not np.asarray(jm.predict(jw, *jb[:-2])).any()

    @pytest.mark.parametrize("model,cls", [
        ("softmax", SoftmaxRegression), ("sparse_lr", SparseBinaryLR),
        ("sparse_softmax", SparseSoftmaxRegression), ("blocked_lr", BlockedSparseLR)])
    def test_get_model(self, model, cls):
        m = get_model(Config(model=model, num_feature_dim=D, device="cpu"))
        assert type(m) is cls

    def test_blocked_block_size_errors(self):
        with pytest.raises(ValueError, match="must be resolved"):
            get_model(Config(model="blocked_lr", block_size=0, device="cpu"))
        with pytest.raises(ValueError, match="multiple of block_size"):
            get_model(Config(model="blocked_lr", num_feature_dim=60, block_size=8, device="cpu"))

    def test_sparse_matches_dense_softmax_on_onehot(self):
        """On one-hot rows the sparse formulation is the dense softmax."""
        w, (cols, vals, y, mask) = _inputs("sparse_softmax", 4, masked_tail=0)
        vals = np.ones_like(vals)
        X = np.zeros((B, D), np.float32)
        np.add.at(X, (np.repeat(np.arange(B), F), cols.reshape(-1)), 1.0)
        cfg = Config(model="sparse_softmax", num_classes=K, num_feature_dim=D, l2_c=0.1,
                     compute_dtype="float32", device="cpu")
        sp, dn = SparseSoftmaxRegression(D, K), SoftmaxRegression(D, K, compute_dtype="float32")
        tw = torch.from_numpy(w)
        sb = tuple(torch.from_numpy(a) for a in (cols, vals, y, mask))
        db = tuple(torch.from_numpy(a) for a in (X, y, mask))
        torch.testing.assert_close(sp.grad(tw, sb, cfg), dn.grad(tw, db, cfg), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(sp.loss(tw, sb, cfg), dn.loss(tw, db, cfg), rtol=1e-5, atol=1e-6)


class TestConfig:
    @pytest.mark.parametrize("model", ["binary_lr", "softmax", "sparse_lr", "sparse_softmax",
                                       "blocked_lr"])
    def test_every_family_builds(self, model):
        assert Config(model=model, device="cpu").model == model

    @pytest.mark.parametrize("kw", [
        {"model": "nope"}, {"block_size": 0}, {"block_size": -1, "model": "blocked_lr"},
        {"block_groups": 2}, {"model": "blocked_lr", "block_groups": -1},
        {"model": "sparse_lr", "feature_dtype": "bfloat16"},
        {"model": "blocked_lr", "feature_dtype": "int8"},
        {"model": "sparse_lr", "feature_dtype": "int8_dot"},
        {"ctr_fields": -1}, {"hash_seed": -1}, {"hash_seed": 1 << 64}])
    def test_rejects_like_jax(self, kw):
        with pytest.raises(ValueError):
            JaxConfig(**kw)
        with pytest.raises(ValueError):
            Config(device="cpu", **kw)


# --- data paths ---------------------------------------------------------------
def _same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    dirs = {"multiclass": str(root / "mc"), "ctr": str(root / "ctr"), "raw": str(root / "raw")}
    write_synthetic_shards(dirs["multiclass"], 900, D, 2, seed=1, num_classes=K)
    jax_write_ctr_shards(dirs["ctr"], 900, 6, 40, D, 2, seed=2)
    write_raw_ctr_shards(dirs["raw"], 900, 6, 8, 3, seed=3, num_distinct_tuples=50)
    return dirs


def _loader_kw(family):
    return {"sparse_lr": dict(sparse=True), "sparse_softmax": dict(sparse=True, multiclass=True),
            "softmax": dict(multiclass=True)}[family]


class TestDataParity:
    @pytest.mark.parametrize("num_shards", [1, 2, 3])
    @pytest.mark.parametrize("family,dir_key,nnz_max", [
        ("softmax", "multiclass", None), ("sparse_lr", "ctr", None), ("sparse_lr", "ctr", 3),
        ("sparse_softmax", "multiclass", None)])
    def test_from_data_dir_matches_jax(self, data_dirs, family, dir_key, nnz_max, num_shards):
        kw = dict(_loader_kw(family), nnz_max=nnz_max) if "sparse" in family else _loader_kw(family)
        ours = GlobalShardedData.from_data_dir(data_dirs[dir_key], "train", num_shards, D, **kw)
        theirs = JaxGlobalShardedData.from_data_dir(data_dirs[dir_key], "train", num_shards, D, **kw)
        assert ours.shard_sizes == theirs.shard_sizes
        _same_batches(ours.batches(64), theirs.batches(64))
        _same_batches([ours.full_batch()], [theirs.full_batch()])

    @pytest.mark.parametrize("num_shards", [1, 2, 3, 4])
    @pytest.mark.parametrize("block_size,block_groups", [(4, 0), (2, 4), (8, 0)])
    def test_from_raw_ctr_dir_matches_jax(self, data_dirs, num_shards, block_size, block_groups):
        kw = dict(data_dir=data_dirs["raw"], model="blocked_lr", num_feature_dim=D,
                  block_size=block_size, block_groups=block_groups, hash_seed=5)
        ours = GlobalShardedData.from_raw_ctr_dir(data_dirs["raw"], "train", num_shards,
                                                  Config(device="cpu", **kw))
        theirs = JaxGlobalShardedData.from_raw_ctr_dir(data_dirs["raw"], "train", num_shards,
                                                       JaxConfig(**kw))
        _same_batches(ours.batches(100), theirs.batches(100))

    @pytest.mark.parametrize("num_shards", [1, 2, 3])
    def test_parts_of_unequal_width_are_padded(self, num_shards):
        """Parts that disagree on NNZ_MAX merge with their trailing dims
        padded, as the JAX class pads them."""
        rng = np.random.default_rng(7)
        parts = [(rng.integers(0, D, (n, w)).astype(np.int32),
                  rng.standard_normal((n, w)).astype(np.float32),
                  rng.integers(0, 2, n).astype(np.int32)) for n, w in ((9, 3), (6, 5))]
        ours = GlobalShardedData._from_parts(parts, num_shards)
        theirs = JaxGlobalShardedData._from_parts(parts, num_shards)
        _same_batches(ours.batches(4), theirs.batches(4))


# --- Trainer.fit ---------------------------------------------------------------
FIT_CASES = {
    "softmax": ("multiclass", dict(model="softmax", num_classes=K, compute_dtype="float32")),
    "sparse_lr": ("ctr", dict(model="sparse_lr")),
    "sparse_softmax": ("multiclass", dict(model="sparse_softmax", num_classes=K, nnz_max=40)),
    "blocked_lr": ("raw", dict(model="blocked_lr", block_size=4, hash_seed=1)),
}


@pytest.mark.parametrize("workers,compat_mode", [(1, "correct"), (2, "correct"), (2, "reference")])
@pytest.mark.parametrize("family", sorted(FIT_CASES))
def test_fit_matches_jax_trainer(data_dirs, family, workers, compat_mode):
    dir_key, extra = FIT_CASES[family]
    kw = dict(data_dir=data_dirs[dir_key], num_feature_dim=D, num_iteration=6, batch_size=100,
              learning_rate=0.5, l2_c=0.01, test_interval=3, compat_mode=compat_mode,
              num_workers=workers, **extra)
    jt = JaxTrainer(JaxConfig(**kw), mesh=make_mesh({"data": workers})).load_data()
    jt.init_weights()
    tt = Trainer(Config(device="cpu", **kw)).load_data()
    tt.weights = params_from_jax(np.asarray(jt.weights), tt.model, "cpu")
    jax_evals, torch_evals = [], []
    jt.fit(eval_fn=lambda e, a: jax_evals.append((e, a)))
    tt.fit(eval_fn=lambda e, a: torch_evals.append((e, a)))

    assert tt.weights.shape == tt.model.param_shape
    np.testing.assert_allclose(params_to_numpy(tt.weights), np.asarray(jt.weights),
                               rtol=1e-4, atol=1e-5)
    jm, tm = jt.evaluate_metrics(), tt.evaluate_metrics()
    n_test = jt._test_data.num_samples
    np.testing.assert_allclose(tm["logloss"], jm["logloss"], rtol=1e-4)
    assert abs(tm["accuracy"] - jm["accuracy"]) <= 1.0 / n_test
    assert [e for e, _ in torch_evals] == [e for e, _ in jax_evals] == [3, 6]
    assert tt.timer.steps == jt.timer.steps
    assert tt.metrics.latest("loss") == pytest.approx(jt.metrics.latest("loss"), rel=1e-4)


def test_sparse_data_refuses_a_quantized_dataset(data_dirs):
    dense = Trainer(Config(data_dir=data_dirs["multiclass"], num_feature_dim=D, model="softmax",
                           num_classes=K, feature_dtype="bfloat16", device="cpu")).load_data()
    assert dense._train_data.X.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="quantized"):
        Trainer(Config(data_dir=data_dirs["multiclass"], num_feature_dim=D, model="softmax",
                       num_classes=K, device="cpu")).load_data(
            train=dense._train_data, test=dense._test_data)


# --- export ----------------------------------------------------------------------
@pytest.mark.parametrize("family", ["softmax", "sparse_softmax", "blocked_lr"])
def test_two_d_params_export_like_jax(tmp_path, family):
    _, tm, _, _ = _pair(family, "correct")
    w = np.random.default_rng(8).standard_normal(tm.param_shape).astype(np.float32)
    ours, theirs = str(tmp_path / "torch.txt"), str(tmp_path / "jax.txt")
    save_model_text(ours, w)
    jax_save_model_text(theirs, w)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    back = load_model_text(theirs, shape=tm.param_shape)
    np.testing.assert_array_equal(back, jax_load_model_text(ours, shape=tm.param_shape))
    np.testing.assert_allclose(back, w, rtol=1e-5)
    t = params_from_jax(back, tm, "cpu")
    assert t.shape == tm.param_shape and t.dtype == torch.float32
    with pytest.raises(ValueError, match="param_shape"):
        params_from_jax(back.reshape(-1), tm, "cpu")


# --- the launch chain ------------------------------------------------------------
EVAL_LINE = re.compile(r"^\d\d:\d\d:\d\d Iteration (\d+), accuracy: (\S+)$", re.M)
CLI_CASES = {
    "softmax": (["--num-feature-dim", "32", "--num-classes", "3"],
                ["--num-feature-dim", "32", "--model", "softmax", "--num-classes", "3"], (32, 3)),
    "sparse_lr": (["--num-feature-dim", "2048", "--ctr-fields", "6", "--ctr-vocab", "50"],
                  ["--num-feature-dim", "2048", "--model", "sparse_lr", "--nnz-max", "6"], (2048,)),
    "sparse_softmax": (["--num-feature-dim", "48", "--num-classes", "4"],
                       ["--num-feature-dim", "48", "--model", "sparse_softmax", "--num-classes", "4"],
                       (48, 4)),
    "blocked_lr": (["--num-feature-dim", "4096", "--ctr-fields", "8", "--ctr-raw",
                    "--ctr-tuples", "64", "--ctr-vocab", "1000"],
                   ["--num-feature-dim", "4096", "--model", "blocked_lr", "--block-size", "8",
                    "--block-groups", "2"], (512, 8)),
}


@pytest.mark.parametrize("family", sorted(CLI_CASES))
def test_launch_gen_data_sync_eval_on_cpu(tmp_path, capsys, family):
    gen_flags, flags, shape = CLI_CASES[family]
    d = str(tmp_path / "d")
    assert launch.main(["gen-data", "--data-dir", d, "--num-samples", "1000",
                        "--num-parts", "2", *gen_flags]) == 0
    assert launch.main(["sync", "--data-dir", d, *flags, "--num-workers", "2",
                        "--num-iteration", "10", "--test-interval", "5", "--learning-rate", "0.5",
                        "--l2-c", "0", "--device", "cpu"]) == 0
    evals = EVAL_LINE.findall(capsys.readouterr().out)
    assert [int(n) for n, _ in evals] == [5, 10]
    model_file = os.path.join(d, "models", "part-001")
    w = load_model_text(model_file, shape=shape)
    assert np.isfinite(w).all() and np.abs(w).max() > 0
    np.testing.assert_array_equal(jax_load_model_text(model_file, shape=shape), w)
    assert launch.main(["eval", "--data-dir", d, *flags, "--model-file", model_file,
                        "--device", "cpu"]) == 0
    m = re.search(r"accuracy: (\S+)\s+test_logloss: (\S+)", capsys.readouterr().out)
    assert m is not None and np.isfinite(float(m.group(2)))
    assert float(m.group(1)) == pytest.approx(float(evals[-1][1]), abs=1e-4)


def test_block_size_auto_resolves_like_jax(tmp_path, capsys):
    d = str(tmp_path / "d")
    assert launch.main(["gen-data", "--data-dir", d, "--num-samples", "4000", "--num-parts", "1",
                        "--ctr-fields", "8", "--ctr-raw", "--ctr-tuples", "32",
                        "--ctr-vocab", "1000"]) == 0
    from distlr_tpu.launch import _resolve_auto_block

    flags = ["--data-dir", d, "--num-feature-dim", "1048576", "--model", "blocked_lr",
             "--block-size", "auto", "--device", "cpu"]
    ours = launch._config_from_args(argparse.Namespace(
        data_dir=d, num_feature_dim=1048576, model="blocked_lr", block_size=0, device="cpu"))
    theirs = _resolve_auto_block(JaxConfig(data_dir=d, num_feature_dim=1048576,
                                           model="blocked_lr", block_size=0))
    assert (ours.block_size, ours.block_groups) == (theirs.block_size, theirs.block_groups)
    assert ours.block_size > 1
    assert launch.main(["sync", *flags, "--num-iteration", "1", "--test-interval", "0"]) == 0


@pytest.mark.parametrize("argv,msg", [
    (["--ctr-raw"], "--ctr-raw requires --ctr-fields"),
    (["--ctr-fields", "4", "--ctr-tuples", "-1"], "non-negative"),
    (["--ctr-fields", "4", "--ctr-tuples", "8"], "--ctr-tuples requires --ctr-raw"),
    (["--ctr-fields", "4", "--num-classes", "3"], "do not apply to CTR shards")])
def test_gen_data_rejects_bad_ctr_flags(tmp_path, capsys, argv, msg):
    d = str(tmp_path / "d")
    assert launch.main(["gen-data", "--data-dir", d, *argv]) == 2
    assert msg in capsys.readouterr().err
    assert not os.path.exists(d)
