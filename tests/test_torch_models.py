"""The port's ``BinaryLR`` against the JAX package's, on shared numpy inputs.

float32 products: rtol 1e-5 / atol 1e-6 (same math, f32 sums in another
order).  bfloat16 products: max |Δ| / max |ref| <= 1e-2, because the JAX
model rounds the residual to bf16 before the backward product
(``linear.py:219-225``) while the port's kernel keeps it f32, as the TPU
kernel does (``pallas_lr.py:76-78``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.models import BinaryLR as JaxBinaryLR
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.convert import params_from_jax, params_to_numpy
from distlr_tpu_torch.models import BinaryLR, get_model

B, D = 48, 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These checks are tiny: one intra-op thread keeps them from crowding
    the suite's timing-sensitive tests running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, masked_tail=6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, D)).astype(np.float32)
    y = rng.integers(0, 2, B).astype(np.int32)
    mask = np.ones(B, np.float32)
    if masked_tail:
        mask[-masked_tail:] = 0
    w = (rng.standard_normal(D) * 0.2).astype(np.float32)
    return w, (X, y, mask)


def _pair(compute_dtype, compat_mode):
    kw = dict(num_feature_dim=D, compute_dtype=compute_dtype,
              compat_mode=compat_mode, l2_c=0.3)
    jax_cfg, cfg = JaxConfig(**kw), Config(device="cpu", **kw)
    return JaxBinaryLR(D, compute_dtype=compute_dtype), get_model(cfg), jax_cfg, cfg


def _close(got, want, compute_dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if compute_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert rel <= 1e-2, f"rel err {rel}"


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compat_mode", ["correct", "reference"])
class TestBinaryLRParity:
    def test_logits_loss_grad(self, compute_dtype, compat_mode):
        jm, tm, jcfg, cfg = _pair(compute_dtype, compat_mode)
        w, (X, y, mask) = _batch(0)
        jb = (jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask))
        tb = tuple(torch.from_numpy(a) for a in (X, y, mask))
        tw = torch.from_numpy(w)
        _close(tm.logits(tw, tb[0]), jm.logits(jnp.asarray(w), jb[0]), compute_dtype)
        _close(tm.loss(tw, tb, cfg), jm.loss(jnp.asarray(w), jb, jcfg), compute_dtype)
        _close(tm.grad(tw, tb, cfg), jm.grad(jnp.asarray(w), jb, jcfg), compute_dtype)
        loss, g = tm.value_and_grad(tw, tb, cfg)
        _close(loss, jm.loss(jnp.asarray(w), jb, jcfg), compute_dtype)
        _close(g, jm.grad(jnp.asarray(w), jb, jcfg), compute_dtype)

    def test_predict_accuracy_logloss(self, compute_dtype, compat_mode):
        jm, tm, _, _ = _pair(compute_dtype, compat_mode)
        w, (X, y, mask) = _batch(1)
        jb = (jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask))
        tb = tuple(torch.from_numpy(a) for a in (X, y, mask))
        tw, jw = torch.from_numpy(w), jnp.asarray(w)
        z = np.asarray(jm.logits(jw, jb[0]))
        clear = np.abs(z) > 1e-3  # rows whose sign no rounding can flip
        np.testing.assert_array_equal(
            tm.predict(tw, tb[0]).numpy()[clear], np.asarray(jm.predict(jw, jb[0]))[clear])
        _close(tm.proba(tw, tb[0]), jm.proba(jw, jb[0]), compute_dtype)
        _close(tm.accuracy(tw, tb), jm.accuracy(jw, jb), compute_dtype)
        _close(tm.logloss(tw, tb), jm.logloss(jw, jb), compute_dtype)

    def test_all_padding_batch(self, compute_dtype, compat_mode):
        """n = max(sum(mask), 1): no division by zero, only the L2 term."""
        jm, tm, jcfg, cfg = _pair(compute_dtype, compat_mode)
        w, (X, y, _) = _batch(2)
        mask = np.zeros(B, np.float32)
        jb = (jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask))
        tb = tuple(torch.from_numpy(a) for a in (X, y, mask))
        g = tm.grad(torch.from_numpy(w), tb, cfg)
        assert torch.isfinite(g).all()
        _close(g, jm.grad(jnp.asarray(w), jb, jcfg), compute_dtype)
        _close(g, cfg.l2_c * w, compute_dtype)
        _close(tm.loss(torch.from_numpy(w), tb, cfg), jm.loss(jnp.asarray(w), jb, jcfg),
               compute_dtype)


class TestInit:
    def test_reference_init_bit_equal_to_jax(self):
        """Q2: glibc srand(0) rand()/RAND_MAX weights, identical bits."""
        jw = np.asarray(JaxBinaryLR(D).init(JaxConfig(num_feature_dim=D, compat_mode="reference")))
        tw = BinaryLR(D).init(Config(num_feature_dim=D, compat_mode="reference", device="cpu"))
        assert tw.dtype == torch.float32
        np.testing.assert_array_equal(tw.numpy(), jw)

    def test_uniform_init_is_seeded(self):
        m = BinaryLR(D)
        a = m.init(Config(random_seed=3, device="cpu"))
        b = m.init(Config(random_seed=3, device="cpu"))
        c = m.init(Config(random_seed=4, device="cpu"))
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert a.min() >= 0 and a.max() < 1 and a.shape == (D,)


class TestConvert:
    def test_round_trip(self):
        w = np.asarray(JaxBinaryLR(D).init(JaxConfig(num_feature_dim=D)))
        t = params_from_jax(w, BinaryLR(D), device="cpu")
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(params_to_numpy(t), w)
        # the round trip holds a copy: the port's in-place update leaves w be
        t.sub_(1.0)
        assert not np.array_equal(params_to_numpy(t), w)

    def test_shape_mismatch_raises(self):
        with pytest.raises(ValueError, match="param_shape"):
            params_from_jax(np.zeros(D + 1, np.float32), BinaryLR(D), device="cpu")


class TestConfigGates:
    @pytest.mark.parametrize("kw,item", [
        ({"model": "softmax"}, "A.2"),
        ({"model": "sparse_lr"}, "A.4"),
        ({"feature_dtype": "int8"}, "A.3"),
        ({"feature_dtype": "int8_dot"}, "A.3"),
        ({"feature_shards": 2}, "A.7"),
        ({"mesh_shape": {"data": 1, "model": 2}}, "A.7"),
        ({"checkpoint_dir": "ck"}, "A.8"),
        ({"profile_dir": "prof"}, "A.12"),
        ({"sync_mode": False}, "A.9"),
    ])
    def test_unported_options_name_their_roadmap_item(self, kw, item):
        with pytest.raises(NotImplementedError, match=rf"ROADMAP {item}\)"):
            Config(device="cpu", **kw)

    @pytest.mark.parametrize("mode", ["correct", "reference"])
    def test_quirk_gates_resolve_like_jax(self, mode):
        j, t = JaxConfig(compat_mode=mode), Config(compat_mode=mode, device="cpu")
        for gate in ("l2_scale_by_batch", "sync_last_gradient",
                     "reference_rng_init", "wrap_final_batch"):
            assert getattr(t, gate) == getattr(j, gate)

    def test_shared_fields_keep_jax_defaults(self):
        j, t = JaxConfig(), Config()
        for f in ("sync_mode", "learning_rate", "data_dir", "num_feature_dim",
                  "num_iteration", "batch_size", "test_interval", "random_seed",
                  "l2_c", "model", "compute_dtype", "feature_dtype", "compat_mode",
                  "num_workers", "feature_shards", "prefetch", "checkpoint_dir",
                  "checkpoint_interval", "profile_dir"):
            assert getattr(t, f) == getattr(j, f), f
        assert t.device == "cuda"
