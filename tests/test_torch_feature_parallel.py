"""The port's feature-sharded step (``parallel/feature_parallel.py``)
against the JAX package's, on the same seeded numpy inputs, on the CPU.

The JAX step runs on a ``{"data": 4, "model": 2}`` mesh of the conftest's
8 CPU devices; the port's on the same mesh of row and column blocks, its
wrappers on their plain versions (CPU tensors).  Tolerances, each with
its reason:

* f32 products: rtol 1e-5 (f32 sums in another order: the logits of each
  column block, then their sum);
* bf16 products: the update at rel 1e-2 (the JAX step rounds the residual
  to bf16 before the backward product, the port keeps it f32);
* int8 X, f32 products: rtol 1e-5; int8_dot: the weight grid (wq, s_w)
  and the residual grid equal, the weights at 1e-6 (the same integer sums,
  the scales folded in another order);
* the trainer after 3 epochs: as ``tests/test_torch_trainer.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.models import BinaryLR as JaxBinaryLR
from distlr_tpu.models import SoftmaxRegression as JaxSoftmaxRegression
from distlr_tpu.models.linear import quantize_sym as jax_quantize_sym
from distlr_tpu.parallel import make_mesh as jax_make_mesh
from distlr_tpu.parallel import feature_parallel as jfp
from distlr_tpu.train import Trainer as JaxTrainer
from distlr_tpu_torch import ops
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.convert import params_from_jax, params_to_numpy
from distlr_tpu_torch.data import write_synthetic_shards
from distlr_tpu_torch.models import BinaryLR, SoftmaxRegression, SparseBinaryLR
from distlr_tpu_torch.parallel import feature_parallel as fp
from distlr_tpu_torch.parallel.mesh import make_mesh
from distlr_tpu_torch.train import GlobalShardedData, Trainer

SHAPE = {"data": 4, "model": 2}
D = 16


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(SHAPE)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(SHAPE)


def _batch(n=32, d=D, seed=0, masked=0):
    rng = np.random.default_rng(seed)
    mask = np.ones(n, dtype=np.float32)
    if masked:
        mask[-masked:] = 0.0
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.integers(0, 2, n).astype(np.int32), mask)


def _jax_step(jmodel, jcfg, jmesh, w0, batch):
    step = jfp.make_feature_sharded_train_step(jmodel, jcfg, jmesh)
    w1, m = step(jfp.shard_weights(jnp.asarray(w0), jmesh),
                 jfp.shard_batch_2d(tuple(jnp.asarray(a) for a in batch), jmesh))
    return np.asarray(w1), {k: float(v) for k, v in m.items()}


def _torch_step(model, cfg, mesh, w0, batch):
    step = fp.make_feature_sharded_train_step(model, cfg, mesh)
    w1, m = step(fp.shard_weights(torch.from_numpy(w0.copy()), mesh),
                 fp.shard_batch_2d(batch, mesh, "cpu"))
    return w1.numpy(), {k: float(v) for k, v in m.items()}


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


class TestBinaryLR:
    @pytest.mark.parametrize("kw", [
        {"l2_c": 0.4},
        {"l2_c": 0.4, "l2_scale_by_batch": True},
        {"l2_c": 0.0, "sync_last_gradient": True},  # Q1 is ignored, as in JAX
    ])
    def test_f32_matches_jax_step(self, jmesh, mesh, kw):
        kw = dict(learning_rate=0.2, num_feature_dim=D, compute_dtype="float32", **kw)
        batch = _batch(masked=5)
        w0 = np.random.default_rng(1).standard_normal(D).astype(np.float32)
        jw, jm = _jax_step(JaxBinaryLR(D, compute_dtype="float32"), JaxConfig(**kw), jmesh,
                           w0, batch)
        tw, tm = _torch_step(BinaryLR(D, compute_dtype="float32"), Config(device="cpu", **kw),
                             mesh, w0, batch)
        np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)
        assert set(tm) == set(jm) == {"loss", "grad_norm"}
        for k in jm:
            assert tm[k] == pytest.approx(jm[k], rel=1e-5)

    def test_bf16_update_matches_jax_step(self, jmesh, mesh):
        kw = dict(learning_rate=0.2, l2_c=0.4, num_feature_dim=D)
        batch = _batch(seed=2)
        w0 = np.random.default_rng(3).standard_normal(D).astype(np.float32)
        jw, jm = _jax_step(JaxBinaryLR(D), JaxConfig(**kw), jmesh, w0, batch)
        tw, tm = _torch_step(BinaryLR(D), Config(device="cpu", **kw), mesh, w0, batch)
        assert _rel(w0 - tw, w0 - jw) <= 1e-2
        assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-2)

    def test_matches_the_unsharded_step(self, mesh):
        """Sharding the feature axis does not change the math: the port's
        data-parallel step on the same row blocks."""
        from distlr_tpu_torch.parallel import make_sync_train_step

        cfg = Config(learning_rate=0.2, l2_c=0.4, num_feature_dim=D, compute_dtype="float32",
                     device="cpu")
        model = BinaryLR(D, compute_dtype="float32")
        batch = _batch(seed=4, masked=3)
        w0 = np.random.default_rng(5).standard_normal(D).astype(np.float32)
        tw, tm = _torch_step(model, cfg, mesh, w0, batch)
        dw, dm = make_sync_train_step(model, cfg, SHAPE["data"])(
            torch.from_numpy(w0.copy()), tuple(torch.from_numpy(a) for a in batch))
        np.testing.assert_allclose(tw, dw.numpy(), rtol=1e-6, atol=1e-7)
        assert tm["loss"] == pytest.approx(float(dm["loss"]), rel=1e-6)

    def test_int8_matches_jax_step(self, jmesh, mesh):
        scale = 1.0 / 127.0
        kw = dict(learning_rate=0.2, l2_c=0.1, num_feature_dim=D, compute_dtype="float32",
                  feature_dtype="int8")
        rng = np.random.default_rng(6)
        X = rng.integers(-127, 128, (32, D)).astype(np.int8)
        batch = (X, rng.integers(0, 2, 32).astype(np.int32), np.ones(32, np.float32))
        w0 = rng.standard_normal(D).astype(np.float32)
        jw, _ = _jax_step(JaxBinaryLR(D, compute_dtype="float32", feature_scale=scale),
                          JaxConfig(**kw), jmesh, w0, batch)
        tw, _ = _torch_step(BinaryLR(D, compute_dtype="float32", feature_scale=scale),
                            Config(device="cpu", **kw), mesh, w0, batch)
        np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)

    def test_converges(self, mesh):
        cfg = Config(learning_rate=0.5, l2_c=0.0, num_feature_dim=D, device="cpu")
        rng = np.random.default_rng(5)
        X = rng.standard_normal((256, D)).astype(np.float32)
        y = (X @ rng.standard_normal(D) > 0).astype(np.int32)
        b = fp.shard_batch_2d((X, y, np.ones(256, np.float32)), mesh, "cpu")
        step = fp.make_feature_sharded_train_step(BinaryLR(D), cfg, mesh)
        w = torch.zeros(D)
        for _ in range(100):
            w, _ = step(w, b)
        assert float(fp.make_feature_sharded_eval_step(BinaryLR(D), mesh)(w, b)["accuracy"]) \
            > 0.95


class TestInt8Dot:
    def _inputs(self, seed):
        rng = np.random.default_rng(seed)
        X = rng.integers(-127, 128, (32, D)).astype(np.int8)
        y = rng.integers(0, 2, 32).astype(np.int32)
        return (X, y, np.ones(32, np.float32)), (0.1 * rng.standard_normal(D)).astype(np.float32)

    @pytest.mark.parametrize("seed", [3, 4])
    def test_matches_jax_step(self, jmesh, mesh, seed):
        scale = 1.0 / 127.0
        kw = dict(learning_rate=0.2, l2_c=0.0, num_feature_dim=D, feature_dtype="int8_dot",
                  feature_shards=2)
        batch, w0 = self._inputs(seed)
        jw, jm = _jax_step(dataclasses.replace(JaxBinaryLR(D, int8_dot=True),
                                               feature_scale=scale),
                           JaxConfig(**kw), jmesh, w0, batch)
        tw, tm = _torch_step(BinaryLR(D, int8_dot=True, feature_scale=scale),
                             Config(device="cpu", **kw), mesh, w0, batch)
        np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6)
        assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-6)

    def test_weight_and_residual_grids_are_jax_bits(self):
        """Each weight shard on the global grid (JAX: ``lax.pmax`` of the
        shards' maxima), and the residuals of a data block on their own."""
        _, w = self._inputs(5)
        tw = torch.from_numpy(w)
        w_amax = torch.amax(tw.abs())
        for j in range(SHAPE["model"]):
            part = slice(j * D // 2, (j + 1) * D // 2)
            jq, js = jax_quantize_sym(jnp.asarray(w[part]), jnp.max(jnp.abs(jnp.asarray(w))))
            tq, ts = ops.int8dot_weight_grid(tw[part], w_amax)
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            assert float(ts) == float(js)
        r = np.random.default_rng(6).standard_normal(8).astype(np.float32)
        jq, js = jax_quantize_sym(jnp.asarray(r), jnp.max(jnp.abs(jnp.asarray(r))))
        tq, ts = ops.int8dot_weight_grid(torch.from_numpy(r))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)

    def test_partial_logits_are_jax_bits(self):
        (X, _, _), w = self._inputs(7)
        scale = 1.0 / 127.0
        jm = dataclasses.replace(JaxBinaryLR(D, int8_dot=True), feature_scale=scale)
        tm = BinaryLR(D, int8_dot=True, feature_scale=scale)
        w_amax = torch.amax(torch.from_numpy(w).abs())
        part = slice(0, D // 2)
        # the JAX function inside a model-axis shard_map, one shard a device
        from jax.sharding import PartitionSpec as P

        from distlr_tpu.parallel.mesh import shard_map

        want = shard_map(lambda ws, xs: jfp.partial_logits(jm, ws, xs),
                         mesh=jax_make_mesh({"model": 2}), in_specs=(P("model"), P(None, "model")),
                         out_specs=P("model"), check_vma=False)(jnp.asarray(w), jnp.asarray(X))
        got = fp.partial_logits(tm, torch.from_numpy(w[part]),
                                torch.from_numpy(np.ascontiguousarray(X[:, part])),
                                w_amax=w_amax)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:32])


class TestSoftmax:
    @pytest.mark.parametrize("feature_dtype", ["float32", "int8_dot"])
    def test_matches_jax_step(self, jmesh, mesh, feature_dtype):
        K = 3
        kw = dict(model="softmax", num_classes=K, num_feature_dim=D, learning_rate=0.1,
                  l2_c=0.2, compute_dtype="float32", feature_dtype=feature_dtype)
        rng = np.random.default_rng(0)
        dot = feature_dtype == "int8_dot"
        X = (rng.integers(-127, 128, (32, D)).astype(np.int8) if dot
             else rng.standard_normal((32, D)).astype(np.float32))
        batch = (X, rng.integers(0, K, 32).astype(np.int32), np.ones(32, np.float32))
        W0 = rng.standard_normal((D, K)).astype(np.float32)
        scale = 1.0 / 127.0 if dot else 1.0
        jw, jm = _jax_step(JaxSoftmaxRegression(D, K, compute_dtype="float32", int8_dot=dot,
                                                feature_scale=scale),
                           JaxConfig(**kw), jmesh, W0, batch)
        tw, tm = _torch_step(SoftmaxRegression(D, K, compute_dtype="float32", int8_dot=dot,
                                               feature_scale=scale),
                             Config(device="cpu", **kw), mesh, W0, batch)
        np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)
        for k in jm:
            assert tm[k] == pytest.approx(jm[k], rel=1e-5)


class TestEval:
    @pytest.mark.parametrize("softmax", [False, True])
    def test_matches_jax_eval(self, jmesh, mesh, softmax):
        X, y, mask = _batch(40, D, seed=3, masked=6)
        if softmax:
            y = y + (X[:, 0] > 1).astype(np.int32)
            jmodel, tmodel = (JaxSoftmaxRegression(D, 3, compute_dtype="float32"),
                              SoftmaxRegression(D, 3, compute_dtype="float32"))
            w = np.random.default_rng(2).standard_normal((D, 3)).astype(np.float32)
        else:
            jmodel, tmodel = JaxBinaryLR(D, compute_dtype="float32"), BinaryLR(
                D, compute_dtype="float32")
            w = np.random.default_rng(2).standard_normal(D).astype(np.float32)
        je = jfp.make_feature_sharded_eval_step(jmodel, jmesh)(
            jfp.shard_weights(jnp.asarray(w), jmesh),
            jfp.shard_batch_2d((jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask)), jmesh))
        te = fp.make_feature_sharded_eval_step(tmodel, mesh)(
            torch.from_numpy(w), fp.shard_batch_2d((X, y, mask), mesh, "cpu"))
        assert float(te["accuracy"]) == float(je["accuracy"])
        assert float(te["logloss"]) == pytest.approx(float(je["logloss"]), rel=1e-5)


class TestResidGrad:
    @pytest.mark.parametrize("scale", [1.0, 0.5])
    def test_lr_backward_reference_is_jax_resid_grad(self, scale):
        """``lr_backward_reference / n`` is JAX's ``resid_grad`` times the
        feature scale (which JAX's step multiplies in after it)."""
        rng = np.random.default_rng(8)
        X = (rng.integers(-127, 128, (24, D)).astype(np.int8) if scale != 1.0
             else rng.standard_normal((24, D)).astype(np.float32))
        r = rng.standard_normal(24).astype(np.float32)
        jm = JaxBinaryLR(D, compute_dtype="float32", feature_scale=scale)
        tm = BinaryLR(D, compute_dtype="float32", feature_scale=scale)
        want = np.asarray(jfp.resid_grad(jm, jnp.asarray(r), jnp.asarray(X), 7.0)) * scale
        tX, tr = torch.from_numpy(X), torch.from_numpy(r)
        ref = ops.lr_backward_reference(tX, tr, compute_dtype="float32", feature_scale=scale)
        # f32 sums in another order: held against the largest entry
        assert _rel((ref / 7.0).numpy(), want) <= 1e-6
        # the wrapper takes its plain version on CPU tensors
        np.testing.assert_array_equal(
            ops.lr_backward(tX, tr, compute_dtype="float32", feature_scale=scale).numpy(),
            ref.numpy())
        assert _rel(fp.resid_grad(tm, tr, tX, 7.0).numpy(), want) <= 1e-6

    def test_lr_backward_rounds_x_not_r(self):
        X = torch.tensor([[1.0 + 2**-10, 3.0]])
        r = torch.tensor([1.0 + 2**-12])
        g = ops.lr_backward(X, r)  # bf16 products: X rounded, r kept f32
        torch.testing.assert_close(g, torch.tensor([1.0 + 2**-12, 3.0 * (1.0 + 2**-12)]),
                                   rtol=0, atol=0)

    def test_lr_backward_checks_its_inputs(self):
        with pytest.raises(ValueError, match="r must be"):
            ops.lr_backward(torch.zeros(4, 8), torch.zeros(5))
        with pytest.raises(ValueError, match="feature_scale"):
            ops.lr_backward(torch.zeros(4, 8), torch.zeros(4), feature_scale=0.5)


class TestLayout:
    @pytest.mark.parametrize("batch", [-1, 3, 4])
    def test_column_blocked_batches_are_the_plain_ones_cut(self, batch):
        rng = np.random.default_rng(0)
        shards = [(rng.standard_normal((n, 6)).astype(np.float32),
                   rng.integers(0, 2, n).astype(np.int32)) for n in (7, 5)]
        data = GlobalShardedData(shards)
        for plain, blocked in zip(data.batches(batch), data.batches(batch, column_blocks=3)):
            X, Xb = plain[0], blocked[0]
            assert Xb.shape == (3, X.shape[0], 2) and Xb.is_contiguous()
            for j in range(3):
                np.testing.assert_array_equal(Xb[j].numpy(), X[:, 2 * j:2 * j + 2])
            for a, b in zip(plain[1:], blocked[1:]):
                np.testing.assert_array_equal(a, b)
        Xf = data.full_batch(column_blocks=2)[0]
        np.testing.assert_array_equal(torch.cat(list(Xf), dim=1).numpy(), data.full_batch()[0])

    def test_q5_wrap_batches_too(self):
        rng = np.random.default_rng(1)
        shards = [(rng.standard_normal((6, 4)).astype(np.float32),
                   rng.integers(0, 2, 6).astype(np.int32)) for _ in range(2)]
        data = GlobalShardedData(shards)
        for plain, blocked in zip(data.batches(4, wrap=True),
                                  data.batches(4, wrap=True, column_blocks=2)):
            np.testing.assert_array_equal(torch.cat(list(blocked[0]), dim=1).numpy(), plain[0])

    def test_shard_weights_is_the_tensor(self, mesh):
        w = torch.arange(D, dtype=torch.float32)
        assert fp.shard_weights(w, mesh) is w


class TestValidation:
    def test_requires_model_axis(self):
        with pytest.raises(ValueError, match="model"):
            fp.make_feature_sharded_train_step(BinaryLR(16), Config(num_feature_dim=16,
                                                                    device="cpu"),
                                               make_mesh({"data": 8}))

    def test_requires_divisible_features(self, mesh):
        with pytest.raises(ValueError, match="divisible"):
            fp.make_feature_sharded_train_step(BinaryLR(15), Config(num_feature_dim=16,
                                                                    device="cpu"), mesh)

    def test_rejects_sparse_model(self, mesh):
        with pytest.raises(TypeError, match="dense"):
            fp.make_feature_sharded_train_step(SparseBinaryLR(16), Config(num_feature_dim=16,
                                                                          device="cpu"), mesh)

    def test_batch_must_be_column_blocked(self, mesh):
        step = fp.make_feature_sharded_train_step(BinaryLR(D), Config(num_feature_dim=D,
                                                                      device="cpu"), mesh)
        X, y, m = _batch()
        with pytest.raises(ValueError, match="column-blocked"):
            step(torch.zeros(D), (torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(m)))

    @pytest.mark.parametrize("kw,match", [
        ({"num_feature_dim": 15, "feature_shards": 2}, "divisible"),
        ({"mesh_shape": {"data": 1, "model": 3}, "num_feature_dim": 16}, "divisible"),
        ({"mesh_shape": {"data": 1, "pipe": 2}}, "axes"),
        ({"mesh_shape": {"data": 1, "model": 2}, "feature_shards": 4}, "disagrees"),
    ])
    def test_config_checks_the_mesh(self, kw, match):
        with pytest.raises(ValueError, match=match):
            Config(device="cpu", **kw)


@pytest.fixture(scope="module")
def fit_data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_fp_fit")
    write_synthetic_shards(str(d), 1200, 24, num_parts=2, seed=0)
    return str(d)


class TestTrainerParity:
    @pytest.mark.parametrize("shape", [{"data": 2, "model": 2}, {"data": 1, "model": 4}])
    def test_fit_matches_jax_trainer(self, fit_data_dir, shape):
        kw = dict(data_dir=fit_data_dir, num_feature_dim=24, num_iteration=3, batch_size=100,
                  learning_rate=0.5, l2_c=0.01, test_interval=1, compute_dtype="float32",
                  num_workers=shape["data"], mesh_shape=shape, feature_shards=shape["model"])
        jt = JaxTrainer(JaxConfig(**kw)).load_data()
        jt.init_weights()
        tt = Trainer(Config(device="cpu", **kw)).load_data()
        assert tt.feature_sharded and jt.feature_sharded
        tt.weights = params_from_jax(np.asarray(jt.weights), tt.model, "cpu")
        jax_evals, torch_evals = [], []
        jt.fit(eval_fn=lambda e, a: jax_evals.append((e, a)))
        tt.fit(eval_fn=lambda e, a: torch_evals.append((e, a)))
        np.testing.assert_allclose(params_to_numpy(tt.weights), np.asarray(jt.weights),
                                   rtol=1e-4, atol=1e-5)
        jm, tm = jt.evaluate_metrics(), tt.evaluate_metrics()
        assert tm["logloss"] == pytest.approx(jm["logloss"], rel=1e-4)
        assert abs(tm["accuracy"] - jm["accuracy"]) <= 1.0 / jt._test_data.num_samples
        assert [e for e, _ in torch_evals] == [e for e, _ in jax_evals] == [1, 2, 3]
        assert tt.metrics.latest("loss") == pytest.approx(jt.metrics.latest("loss"), rel=1e-4)

    def test_int8_dot_trainer_matches_jax(self, fit_data_dir):
        kw = dict(data_dir=fit_data_dir, num_feature_dim=24, num_iteration=3, batch_size=-1,
                  learning_rate=0.5, l2_c=0.0, test_interval=0, feature_dtype="int8_dot",
                  num_workers=2, mesh_shape={"data": 2, "model": 2}, feature_shards=2)
        jt = JaxTrainer(JaxConfig(**kw)).load_data()
        jt.init_weights()
        tt = Trainer(Config(device="cpu", **kw)).load_data()
        assert tt.model.feature_scale == jt.model.feature_scale != 1.0
        tt.weights = params_from_jax(np.asarray(jt.weights), tt.model, "cpu")
        np.testing.assert_allclose(params_to_numpy(tt.fit()), np.asarray(jt.fit()), rtol=0,
                                   atol=1e-5)
