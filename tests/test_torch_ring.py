"""The port's ring collectives and ring step against the JAX package's.

The JAX ring runs one ``ppermute`` a hop across the devices of a mesh
axis (the conftest's 8 CPU devices); the port's runs the same hops for
all S column blocks at once on stacked tensors.  The same f32 adds in the
same order give the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distlr_tpu import Config as JaxConfig
from distlr_tpu.models import BinaryLR as JaxBinaryLR
from distlr_tpu.parallel import make_mesh as jax_make_mesh
from distlr_tpu.parallel.feature_parallel import shard_batch_2d as jax_shard_batch_2d
from distlr_tpu.parallel.feature_parallel import shard_weights as jax_shard_weights
from distlr_tpu.parallel.mesh import shard_map
from distlr_tpu.parallel.ring import make_ring_train_step as jax_make_ring_train_step
from distlr_tpu.parallel.ring import ring_all_gather as jax_ring_all_gather
from distlr_tpu.parallel.ring import ring_psum as jax_ring_psum
from distlr_tpu.parallel.ring import ring_reduce_scatter as jax_ring_reduce_scatter
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.models import BinaryLR, SoftmaxRegression
from distlr_tpu_torch.parallel.feature_parallel import (
    make_feature_sharded_train_step,
    shard_batch_2d,
)
from distlr_tpu_torch.parallel.mesh import make_mesh
from distlr_tpu_torch.parallel.ring import (
    make_ring_train_step,
    ring_all_gather,
    ring_psum,
    ring_reduce_scatter,
)


def _on_axis(fn, s, x):
    """``fn`` of each device's part of the flat ``x`` on a 1D ``model``
    mesh of s devices, the devices' results concatenated."""
    return np.asarray(shard_map(fn, mesh=jax_make_mesh({"model": s}), in_specs=P("model"),
                                out_specs=P("model"), check_vma=False)(jnp.asarray(x)))


@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("n", [64, 61, 7, 2])  # divisible, ragged, n < s
class TestRingPrimitives:
    def test_ring_psum_is_jax_bits(self, s, n):
        x = np.random.default_rng(n).standard_normal((s, n)).astype(np.float32)
        want = _on_axis(lambda v: jax_ring_psum(v, "model"), s, x.reshape(-1))
        got = ring_psum(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy().reshape(-1), want)
        # every device holds the sum
        np.testing.assert_allclose(got.numpy(), np.broadcast_to(x.sum(0), (s, n)),
                                   rtol=1e-5, atol=1e-5)

    def test_ring_reduce_scatter_is_jax_bits(self, s, n):
        x = np.random.default_rng(n + 1).standard_normal((s, n)).astype(np.float32)
        want = _on_axis(lambda v: jax_ring_reduce_scatter(v, "model"), s, x.reshape(-1))
        got = ring_reduce_scatter(torch.from_numpy(x))
        assert got.shape == (s, -(-n // s))
        np.testing.assert_array_equal(got.numpy().reshape(-1), want)

    @pytest.mark.parametrize("offset", [0, 1])
    def test_ring_all_gather_is_jax_bits(self, s, n, offset):
        x = np.random.default_rng(n + 2).standard_normal((s, n)).astype(np.float32)
        want = _on_axis(lambda v: jax_ring_all_gather(v, "model", owner_offset=offset), s,
                        x.reshape(-1))
        got = ring_all_gather(torch.from_numpy(x), owner_offset=offset)
        assert got.shape == (s, s * n)
        np.testing.assert_array_equal(got.numpy().reshape(-1), want)
        if offset == 0:  # ordered by rank: every device holds x in order
            np.testing.assert_array_equal(got.numpy(), np.broadcast_to(x.reshape(-1),
                                                                       (s, s * n)))


def _batch(B, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, D)).astype(np.float32),
            rng.integers(0, 2, B).astype(np.int32), np.ones(B, np.float32),
            rng.standard_normal(D).astype(np.float32))


class TestRingTrainStep:
    @pytest.mark.parametrize("l2_scale_by_batch", [False, True])
    def test_matches_jax_ring_step(self, l2_scale_by_batch):
        D, B = 64, 32
        shape = {"data": 2, "model": 4}
        kw = dict(num_feature_dim=D, learning_rate=0.3, l2_c=0.1, compute_dtype="float32",
                  l2_scale_by_batch=l2_scale_by_batch)
        X, y, mask, w0 = _batch(B, D, 1)
        jmesh = jax_make_mesh(shape)
        jw, jm = jax_make_ring_train_step(JaxBinaryLR(D, compute_dtype="float32"),
                                          JaxConfig(**kw), jmesh)(
            jax_shard_weights(jnp.asarray(w0), jmesh), jax_shard_batch_2d((X, y, mask), jmesh))
        mesh = make_mesh(shape)
        tw, tm = make_ring_train_step(BinaryLR(D, compute_dtype="float32"),
                                      Config(device="cpu", **kw), mesh)(
            torch.from_numpy(w0.copy()), shard_batch_2d((X, y, mask), mesh, "cpu"))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
        assert set(tm) == set(jm) == {"loss"}
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)

    def test_matches_psum_step(self):
        D, B = 64, 32
        mesh = make_mesh({"data": 2, "model": 4})
        cfg = Config(num_feature_dim=D, learning_rate=0.3, l2_c=0.1, device="cpu")
        model = BinaryLR(D)
        X, y, mask, w0 = _batch(B, D, 3)
        batch = shard_batch_2d((X, y, mask), mesh, "cpu")
        w_r, m_r = make_ring_train_step(model, cfg, mesh)(torch.from_numpy(w0.copy()), batch)
        w_p, m_p = make_feature_sharded_train_step(model, cfg, mesh)(
            torch.from_numpy(w0.copy()), batch)
        torch.testing.assert_close(w_r, w_p, rtol=2e-6, atol=2e-7)
        torch.testing.assert_close(m_r["loss"], m_p["loss"], rtol=1e-5, atol=0)

    def test_converges(self):
        D, B = 32, 64
        mesh = make_mesh({"data": 2, "model": 2})
        cfg = Config(num_feature_dim=D, learning_rate=0.5, l2_c=0.0, device="cpu")
        rng = np.random.default_rng(2)
        X = rng.standard_normal((B, D)).astype(np.float32)
        y = (X @ rng.standard_normal(D).astype(np.float32) > 0).astype(np.int32)
        batch = shard_batch_2d((X, y, np.ones(B, np.float32)), mesh, "cpu")
        step = make_ring_train_step(BinaryLR(D), cfg, mesh)
        w = torch.zeros(D)
        losses = []
        for _ in range(60):
            w, m = step(w, batch)
            losses.append(float(m["loss"]))
        assert losses[-1] < 0.35 * losses[0]

    def test_rejects_non_binary_model(self):
        with pytest.raises(TypeError, match="BinaryLR"):
            make_ring_train_step(SoftmaxRegression(16, 4), Config(num_feature_dim=16,
                                                                  device="cpu"),
                                 make_mesh({"data": 2, "model": 2}))
