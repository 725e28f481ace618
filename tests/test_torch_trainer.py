"""The port's trainer against the JAX package's, on the CPU.

``GlobalShardedData`` must batch exactly as the JAX class does; a whole
``Trainer.fit`` (float32 products) must land on the JAX trainer's weights
and eval metrics; the text model format must be the same bytes both ways.
"""

import os

import numpy as np
import pytest
import torch

from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.parallel import make_mesh
from distlr_tpu.train import GlobalShardedData as JaxGlobalShardedData
from distlr_tpu.train import Trainer as JaxTrainer
from distlr_tpu.train.export import load_model_text as jax_load_model_text
from distlr_tpu.train.export import save_model_text as jax_save_model_text
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.convert import params_from_jax, params_to_numpy
from distlr_tpu_torch.data import write_synthetic_shards
from distlr_tpu_torch.train import GlobalShardedData, Trainer, load_model_text, save_model_text
from distlr_tpu_torch.train.trainer import _prefetch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These checks are tiny: one intra-op thread keeps them from crowding
    the suite's timing-sensitive tests running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shards(sizes, D=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, D)).astype(np.float32),
             rng.integers(0, 2, n).astype(np.int32)) for n in sizes]


def _assert_same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class TestGlobalShardedDataParity:
    @pytest.mark.parametrize("sizes", [[10], [7, 7], [9, 6], [5, 5, 3]])
    @pytest.mark.parametrize("batch", [-1, 2, 4, 16])
    def test_batches_match_jax(self, sizes, batch):
        shards = _shards(sizes)
        _assert_same_batches(GlobalShardedData(shards).batches(batch),
                             JaxGlobalShardedData(shards).batches(batch))
        _assert_same_batches([GlobalShardedData(shards).full_batch()],
                             [JaxGlobalShardedData(shards).full_batch()])

    @pytest.mark.parametrize("sizes,batch", [([10], 4), ([6, 6], 4), ([8, 8], 3), ([5, 5], 7)])
    def test_q5_wrap_matches_jax(self, sizes, batch):
        shards = _shards(sizes, seed=1)
        _assert_same_batches(GlobalShardedData(shards).batches(batch, wrap=True),
                             JaxGlobalShardedData(shards).batches(batch, wrap=True))

    def test_wrap_rejects_unequal_shards(self):
        with pytest.raises(ValueError, match="wrap_final_batch"):
            list(GlobalShardedData(_shards([5, 3])).batches(2, wrap=True))

    def test_bfloat16_leaf_batches_like_float32(self):
        """After the trainer's bf16 conversion the feature leaf is a torch
        tensor; slicing, padding and wrapping must not change."""
        shards = _shards([9, 6], seed=2)
        ref = GlobalShardedData(shards)
        bf = GlobalShardedData(shards)
        bf._feats[0] = torch.from_numpy(bf._feats[0]).to(torch.bfloat16)
        for (xa, ya, ma), (xb, yb, mb) in zip(ref.batches(4), bf.batches(4)):
            assert xb.dtype == torch.bfloat16
            torch.testing.assert_close(xb.float(), torch.from_numpy(xa).to(torch.bfloat16).float())
            np.testing.assert_array_equal(ya, yb)
            np.testing.assert_array_equal(ma, mb)
        eq = GlobalShardedData(_shards([6, 6], seed=3))
        eq_bf = GlobalShardedData(_shards([6, 6], seed=3))
        eq_bf._feats[0] = torch.from_numpy(eq_bf._feats[0]).to(torch.bfloat16)
        for (xa, *_), (xb, *_) in zip(eq.batches(4, wrap=True), eq_bf.batches(4, wrap=True)):
            torch.testing.assert_close(xb.float(), torch.from_numpy(xa).to(torch.bfloat16).float())

    @pytest.mark.parametrize("num_shards", [1, 2, 3])
    def test_from_data_dir_round_robin_matches_jax(self, tmp_path, num_shards):
        write_synthetic_shards(str(tmp_path), 300, 12, num_parts=2, seed=5)
        ours = GlobalShardedData.from_data_dir(str(tmp_path), "train", num_shards, 12)
        theirs = JaxGlobalShardedData.from_data_dir(str(tmp_path), "train", num_shards, 12)
        assert ours.shard_sizes == theirs.shard_sizes
        _assert_same_batches(ours.batches(32), theirs.batches(32))


@pytest.fixture(scope="module")
def fit_data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_fit")
    write_synthetic_shards(str(d), 2000, 64, num_parts=2, seed=0)
    return str(d)


class TestTrainerFitParity:
    @pytest.mark.parametrize("workers", [1, 2])
    @pytest.mark.parametrize("compat_mode", ["correct", "reference"])
    def test_fit_matches_jax_trainer(self, fit_data_dir, workers, compat_mode):
        kw = dict(data_dir=fit_data_dir, num_feature_dim=64, num_iteration=30,
                  batch_size=100, learning_rate=0.5, l2_c=0.01, test_interval=10,
                  compute_dtype="float32", compat_mode=compat_mode, num_workers=workers)
        jt = JaxTrainer(JaxConfig(**kw), mesh=make_mesh({"data": workers})).load_data()
        jt.init_weights()
        tt = Trainer(Config(device="cpu", **kw)).load_data()
        tt.weights = params_from_jax(np.asarray(jt.weights), tt.model, "cpu")
        jax_evals, torch_evals = [], []
        jt.fit(eval_fn=lambda e, a: jax_evals.append((e, a)))
        tt.fit(eval_fn=lambda e, a: torch_evals.append((e, a)))

        np.testing.assert_allclose(params_to_numpy(tt.weights), np.asarray(jt.weights),
                                   rtol=1e-4, atol=1e-5)
        jm, tm = jt.evaluate_metrics(), tt.evaluate_metrics()
        n_test = jt._test_data.num_samples
        np.testing.assert_allclose(tm["logloss"], jm["logloss"], rtol=1e-4)
        assert abs(tm["accuracy"] - jm["accuracy"]) <= 1.0 / n_test
        assert [e for e, _ in torch_evals] == [e for e, _ in jax_evals] == [10, 20, 30]
        np.testing.assert_allclose([a for _, a in torch_evals], [a for _, a in jax_evals],
                                   atol=1.0 / n_test)
        assert tt.timer.steps == jt.timer.steps
        assert tt.metrics.latest("loss") == pytest.approx(jt.metrics.latest("loss"), rel=1e-4)

    def test_reference_init_needs_no_hand_off(self, fit_data_dir):
        """Q2 init is bit-identical, so the reference mode needs no weight
        hand-off between the packages."""
        kw = dict(data_dir=fit_data_dir, num_feature_dim=64, compat_mode="reference")
        jt = JaxTrainer(JaxConfig(**kw), mesh=make_mesh({"data": 1}))
        tt = Trainer(Config(device="cpu", **kw))
        np.testing.assert_array_equal(params_to_numpy(tt.init_weights()),
                                      np.asarray(jt.init_weights()))

    def test_prefetch_depth_does_not_change_the_trajectory(self, fit_data_dir):
        kw = dict(data_dir=fit_data_dir, num_feature_dim=64, num_iteration=3,
                  batch_size=128, compute_dtype="float32", device="cpu")
        serial = Trainer(Config(prefetch=1, **kw)).load_data()
        deep = Trainer(Config(prefetch=3, **kw)).load_data()
        torch.testing.assert_close(serial.fit(), deep.fit(), rtol=0, atol=0)

    def test_bfloat16_features_train(self, fit_data_dir):
        cfg = Config(data_dir=fit_data_dir, num_feature_dim=64, num_iteration=20,
                     batch_size=100, learning_rate=0.5, l2_c=0.0,
                     feature_dtype="bfloat16", device="cpu")
        tt = Trainer(cfg).load_data()
        assert tt._train_data.X.dtype == torch.bfloat16
        tt.fit(eval_fn=lambda e, a: None)
        assert tt.evaluate() > 0.6
        # a float32 trainer refuses the converted dataset
        with pytest.raises(ValueError, match="quantized"):
            Trainer(cfg.replace(feature_dtype="float32")).load_data(
                train=tt._train_data, test=tt._test_data)

    def test_prefetch_producer_error_reaches_the_consumer(self):
        def bad():
            yield (1,)
            raise OSError("disk gone")

        with pytest.raises(OSError, match="disk gone"):
            list(_prefetch(lambda hb: hb, bad(), 2))


class TestTextModelInterchange:
    def test_same_bytes_and_cross_loading(self, tmp_path):
        w = np.random.default_rng(9).standard_normal(37).astype(np.float32)
        ours, theirs = str(tmp_path / "torch.txt"), str(tmp_path / "jax.txt")
        save_model_text(ours, w)
        jax_save_model_text(theirs, w)
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
        np.testing.assert_array_equal(load_model_text(theirs), jax_load_model_text(ours))

    def test_trainer_save_model_loads_in_jax(self, fit_data_dir, tmp_path):
        cfg = Config(data_dir=fit_data_dir, num_feature_dim=64, num_iteration=2,
                     device="cpu")
        tt = Trainer(cfg).load_data()
        tt.fit(eval_fn=lambda e, a: None)
        path = tt.save_model(str(tmp_path / "part-001"))
        assert os.path.exists(path)
        # the text format keeps %g's six significant digits
        np.testing.assert_array_equal(jax_load_model_text(path, shape=(64,)),
                                      load_model_text(path, shape=(64,)))
        np.testing.assert_allclose(load_model_text(path), params_to_numpy(tt.weights),
                                   rtol=1e-5)
