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
    # profile_dir names its ROADMAP item; the reference's rendezvous
    # address is accepted and resolved as in JAX (nothing reads it)
    @pytest.mark.parametrize("kw,item", [
        ({"profile_dir": "prof"}, "A.12"),
        ({"ps_host": "10.0.0.1"}, None),
        ({"ps_port": 9000}, None),
    ])
    def test_options_resolve_like_jax_or_name_their_roadmap_item(self, kw, item):
        if item is not None:
            with pytest.raises(NotImplementedError, match=rf"ROADMAP {item}\)"):
                Config(device="cpu", **kw)
            return
        env = {"DMLC_PS_ROOT_URI": "10.0.0.1", "DMLC_PS_ROOT_PORT": "9000"}
        for ours, theirs in ((Config(device="cpu", **kw), JaxConfig(**kw)),
                             (Config.from_env(env, device="cpu"), JaxConfig.from_env(env))):
            assert (ours.ps_host, ours.ps_port) == (theirs.ps_host, theirs.ps_port)

    # the durable store and the fault plan (ROADMAP A.16.4-A.16.5):
    # accepted, with the JAX package's values
    @pytest.mark.parametrize("kw", [
        {"ps_store_dir": "store"},
        {"ps_store_dir": "store", "ps_store_wal": True, "sync_mode": False},
        {"chaos_plan": "plan.json"},
        {"ps_store_dir": "store", "ps_store_interval_s": 0.5, "ps_store_wal": True,
         "ps_store_wal_fsync_s": 0.01, "sync_mode": False, "chaos_plan": "plan.json",
         "chaos_seed": 3},
    ])
    def test_store_and_chaos_options_resolve_like_jax(self, kw):
        j, t = JaxConfig(**kw), Config(device="cpu", **kw)
        for f in ("ps_store_dir", "ps_store_interval_s", "ps_store_wal", "ps_store_wal_fsync_s",
                  "chaos_plan", "chaos_seed", "sync_mode"):
            assert getattr(t, f) == getattr(j, f), f

    # the feedback loop's options (ROADMAP A.11): accepted, with the JAX
    # package's values
    @pytest.mark.parametrize("kw", [
        {"feedback_spool_dir": "spool"},
        {"feedback_window_s": 5.0},
        {"feedback_drift_threshold": 0.5},
        {"feedback_shard_dir": "shards", "feedback_negative_rate": 0.3,
         "feedback_shard_records": 64, "feedback_capacity": 10, "feedback_drift_block": 32},
    ])
    def test_feedback_options_resolve_like_jax(self, kw):
        j, t = JaxConfig(**kw), Config(device="cpu", **kw)
        for f in ("feedback_spool_dir", "feedback_shard_dir", "feedback_window_s",
                  "feedback_negative_rate", "feedback_shard_records", "feedback_capacity",
                  "feedback_drift_block", "feedback_drift_threshold"):
            assert getattr(t, f) == getattr(j, f), f

    @pytest.mark.parametrize("kw", [
        {"feedback_window_s": 0.0}, {"feedback_negative_rate": 1.5},
        {"feedback_shard_records": 0}, {"feedback_capacity": -1},
        {"feedback_drift_block": 0}, {"feedback_drift_threshold": 0.0},
    ])
    def test_feedback_options_refused_like_jax(self, kw):
        with pytest.raises(ValueError) as ours:
            Config(device="cpu", **kw)
        with pytest.raises(ValueError) as theirs:
            JaxConfig(**kw)
        assert str(ours.value) == str(theirs.value)

    # the keyed PS families in async mode and the hot-row serving options
    # (ROADMAP A.15, A.18): accepted, with the JAX package's values
    @pytest.mark.parametrize("kw", [
        {"model": "sparse_lr", "sync_mode": False},
        {"model": "blocked_lr", "block_size": 8, "sync_mode": False},
        {"model": "sparse_softmax", "sync_mode": False},
        {"serve_hot_rows": 1024},
        {"serve_hot_min_coverage": 0.5},
        {"serve_hot_full_every": 0},
    ])
    def test_keyed_ps_and_hot_row_options_resolve_like_jax(self, kw):
        j, t = JaxConfig(**kw), Config(device="cpu", **kw)
        for f in ("model", "sync_mode", "block_size", "serve_hot_rows",
                  "serve_hot_min_coverage", "serve_hot_full_every"):
            assert getattr(t, f) == getattr(j, f), f

    # the retry policy (ROADMAP A.16.2): accepted, with the JAX package's
    # values, and refused with its texts
    @pytest.mark.parametrize("kw", [
        {"ps_retry_attempts": 3},
        {"ps_retry_adaptive": True},
        {"ps_retry_attempts": 4, "ps_retry_backoff_ms": 10.0, "ps_retry_backoff_max_ms": 80.0,
         "ps_retry_deadline_s": 2.5},
    ])
    def test_retry_options_resolve_like_jax(self, kw):
        j, t = JaxConfig(**kw), Config(device="cpu", **kw)
        for f in ("ps_retry_attempts", "ps_retry_backoff_ms", "ps_retry_backoff_max_ms",
                  "ps_retry_deadline_s", "ps_retry_adaptive"):
            assert getattr(t, f) == getattr(j, f), f

    @pytest.mark.parametrize("kw", [
        {"ps_retry_attempts": -1}, {"ps_retry_backoff_ms": -1.0},
        {"ps_retry_backoff_ms": 500.0, "ps_retry_backoff_max_ms": 100.0},
        {"ps_retry_deadline_s": 0.0},
    ])
    def test_retry_options_refused_like_jax(self, kw):
        with pytest.raises(ValueError) as ours:
            Config(device="cpu", **kw)
        with pytest.raises(ValueError) as theirs:
            JaxConfig(**kw)
        assert str(ours.value) == str(theirs.value)

    # the servers' update rule, the wire codec and the accumulation (the
    # first half of ROADMAP A.16): accepted, with the JAX package's values
    @pytest.mark.parametrize("kw", [
        {"ps_optimizer": "ftrl"},
        {"ps_compress": "int8"},
        {"ps_accum_max": 4},
        {"ps_optimizer": "ftrl", "ftrl_alpha": 0.3, "ftrl_beta": 2.0, "ftrl_l1": 0.05,
         "ftrl_l2": 0.5, "ps_compress": "int8"},
        {"ps_compress": "signsgd", "learning_rate": 0.01},
        {"ps_accum_start": 2, "ps_accum_growth": 1.5, "ps_accum_growth_every": 4,
         "ps_accum_max": 16},
    ])
    def test_ps_wire_options_resolve_like_jax(self, kw):
        j, t = JaxConfig(**kw), Config(device="cpu", **kw)
        for f in ("ps_optimizer", "ftrl_alpha", "ftrl_beta", "ftrl_l1", "ftrl_l2",
                  "ps_compress", "ps_accum_start", "ps_accum_growth", "ps_accum_growth_every",
                  "ps_accum_max", "learning_rate"):
            assert getattr(t, f) == getattr(j, f), f

    @pytest.mark.parametrize("kw", [
        {"ps_optimizer": "adagrad"}, {"ps_optimizer": "ftrl", "compat_mode": "reference"},
        {"ftrl_alpha": 0.0}, {"ftrl_beta": -1.0}, {"ftrl_l1": -1.0}, {"ftrl_l2": -0.5},
        {"ps_compress": "gzip"}, {"ps_compress": "int8", "compat_mode": "reference"},
        {"ps_compress": "signsgd", "ps_optimizer": "ftrl"},
        {"ps_accum_start": 0}, {"ps_accum_start": 4, "ps_accum_max": 2},
        {"ps_accum_growth": 0.5}, {"ps_accum_growth_every": 0},
    ])
    def test_ps_wire_options_validate_like_jax(self, kw):
        with pytest.raises(ValueError) as theirs:
            JaxConfig(**kw)
        with pytest.raises(ValueError) as ours:
            Config(device="cpu", **kw)
        assert str(ours.value) == str(theirs.value)

    # a named engine and the router's options (ROADMAP A.17): accepted,
    # with the JAX package's values
    @pytest.mark.parametrize("kw", [
        {"serve_model_id": "v2"},
        {"route_quota": "v2=5:10", "route_port": 8080, "route_host": "0.0.0.0"},
        {"route_max_inflight": 8, "route_eject_after": 5, "route_health_interval_s": 0.5},
        {"route_probe_backoff_s": 0.1, "route_probe_backoff_max_s": 2.0,
         "route_backend_timeout_s": 3.0},
    ])
    def test_named_engine_and_route_options_resolve_like_jax(self, kw):
        j, t = JaxConfig(**kw), Config(device="cpu", **kw)
        for f in ("serve_model_id", "route_quota", "route_port", "route_host",
                  "route_max_inflight", "route_eject_after", "route_health_interval_s",
                  "route_probe_backoff_s", "route_probe_backoff_max_s",
                  "route_backend_timeout_s"):
            assert getattr(t, f) == getattr(j, f), f

    @pytest.mark.parametrize("kw", [
        {"serve_model_id": ""}, {"serve_model_id": "v 2"}, {"serve_model_id": "a@b"},
        {"route_port": 70000}, {"route_max_inflight": 0}, {"route_eject_after": 0},
        {"route_health_interval_s": 0.0}, {"route_probe_backoff_s": 0.0},
        {"route_probe_backoff_s": 3.0, "route_probe_backoff_max_s": 1.0},
        {"route_backend_timeout_s": -1.0},
    ])
    def test_named_engine_and_route_options_validate_like_jax(self, kw):
        with pytest.raises(ValueError) as theirs:
            JaxConfig(**kw)
        with pytest.raises(ValueError) as ours:
            Config(device="cpu", **kw)
        assert str(ours.value) == str(theirs.value)

    @pytest.mark.parametrize("kw,match", [
        ({"serve_hot_rows": -1}, "serve_hot_rows"),
        ({"serve_hot_min_coverage": 0.0}, "serve_hot_min_coverage"),
        ({"serve_hot_min_coverage": 1.5}, "serve_hot_min_coverage"),
        ({"serve_hot_full_every": -1}, "serve_hot_full_every"),
    ])
    def test_hot_row_options_validate_like_jax(self, kw, match):
        with pytest.raises(ValueError, match=match) as theirs:
            JaxConfig(**kw)
        with pytest.raises(ValueError, match=match) as ours:
            Config(device="cpu", **kw)
        assert str(ours.value) == str(theirs.value)

    # the options of ROADMAP A.7 (a 'model' mesh axis: the feature-sharded
    # step), with a feature count the axis divides (the port checks it here,
    # the JAX package when it builds the step)
    @pytest.mark.parametrize("kw", [
        {"feature_shards": 2, "num_feature_dim": 124},
        {"mesh_shape": {"data": 1, "model": 2}, "num_feature_dim": 124},
        {"mesh_shape": {"data": 2, "model": 4}, "num_workers": 2, "feature_shards": 4,
         "num_feature_dim": 124},
    ])
    def test_model_axis_options_resolve_like_jax(self, kw):
        j, t = JaxConfig(**kw), Config(device="cpu", **kw)
        for f in ("mesh_shape", "feature_shards", "num_workers", "num_feature_dim"):
            assert getattr(t, f) == getattr(j, f), f

    @pytest.mark.parametrize("model", ["sparse_lr", "sparse_softmax", "blocked_lr"])
    def test_sparse_family_on_a_model_axis_raises_jax_message(self, model):
        from distlr_tpu.train import Trainer as JaxTrainer
        from distlr_tpu_torch.train import Trainer

        kw = dict(model=model, num_feature_dim=16, mesh_shape={"data": 1, "model": 2})
        with pytest.raises(NotImplementedError) as theirs:
            JaxTrainer(JaxConfig(**kw))
        with pytest.raises(NotImplementedError) as ours:
            Trainer(Config(device="cpu", **kw))
        assert str(ours.value) == str(theirs.value)

    # the options of ROADMAP A.3 (int8 features) and A.8 (checkpoints)
    @pytest.mark.parametrize("kw", [
        {"model": "softmax", "feature_dtype": "int8_dot", "num_classes": 3},
        {"feature_dtype": "int8"},
        {"feature_dtype": "int8_dot"},
        {"checkpoint_dir": "ck", "checkpoint_interval": 5},
    ])
    def test_ported_options_resolve_like_jax(self, kw):
        j, t = JaxConfig(**kw), Config(device="cpu", **kw)
        for f in ("model", "feature_dtype", "compute_dtype", "num_classes", "checkpoint_dir",
                  "checkpoint_interval", "l2_scale_by_batch", "sync_last_gradient"):
            assert getattr(t, f) == getattr(j, f), f
        assert get_model(t).int8_dot == (kw.get("feature_dtype") == "int8_dot")

    # the dense families' PS options (ROADMAP A.9, port PR 9)
    @pytest.mark.parametrize("kw", [
        {"sync_mode": False},
        {"sync_mode": False, "model": "softmax", "num_classes": 3},
        {"num_servers": 3, "ps_compute_backend": "numpy", "ps_pipeline": False,
         "ps_timeout_ms": 0},
    ])
    def test_ported_ps_options_resolve_like_jax(self, kw):
        j, t = JaxConfig(**kw), Config(device="cpu", **kw)
        for f in ("sync_mode", "model", "num_servers", "ps_compute_backend", "ps_pipeline",
                  "ps_timeout_ms", "sync_last_gradient"):
            assert getattr(t, f) == getattr(j, f), f

    @pytest.mark.parametrize("kw,match", [
        ({"ps_compute_backend": "gpu"}, "ps_compute_backend"),
        ({"ps_optimizer": "adam"}, "ps_optimizer"),
        ({"ps_compress": "fp8"}, "ps_compress"),
        ({"num_servers": 0}, "num_servers"),
    ])
    def test_invalid_ps_options_rejected(self, kw, match):
        with pytest.raises(ValueError, match=match):
            Config(device="cpu", **kw)

    def test_ported_serve_options_resolve_like_jax(self):
        kw = {"serve_port": 8123, "serve_host": "0.0.0.0", "serve_max_batch_size": 256,
              "serve_max_wait_ms": 0.5, "serve_reload_interval_s": 0.2,
              "serve_engine_idle_evict_s": 30.0}
        j, t = JaxConfig(**kw), Config(device="cpu", **kw)
        for f in (*kw, "serve_model_id", "serve_hot_rows", "feedback_spool_dir"):
            assert getattr(t, f) == getattr(j, f), f

    @pytest.mark.parametrize("kw", [
        {"serve_port": 70_000}, {"serve_max_batch_size": 0}, {"serve_max_wait_ms": -1.0},
        {"serve_reload_interval_s": 0.0}, {"serve_engine_idle_evict_s": -1.0},
    ])
    def test_invalid_serve_options_rejected_like_jax(self, kw):
        (name,) = kw
        for cls in (JaxConfig, lambda **k: Config(device="cpu", **k)):
            with pytest.raises(ValueError, match=name):
                cls(**kw)

    def test_negative_checkpoint_interval_rejected(self):
        with pytest.raises(ValueError, match="checkpoint_interval"):
            Config(device="cpu", checkpoint_interval=-1)

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
                  "checkpoint_interval", "profile_dir", "num_classes", "nnz_max",
                  "block_size", "block_groups", "ctr_fields", "hash_seed",
                  "num_servers", "ps_host", "ps_port", "ps_compute_backend", "ps_pipeline",
                  "ps_timeout_ms", "ps_retry_attempts", "ps_retry_backoff_ms",
                  "ps_retry_backoff_max_ms", "ps_retry_deadline_s", "ps_retry_adaptive",
                  "ps_optimizer", "ps_compress", "ps_accum_start", "ps_accum_growth",
                  "ps_accum_growth_every", "ps_accum_max", "ps_store_dir",
                  "ps_store_interval_s", "ps_store_wal", "ps_store_wal_fsync_s",
                  "chaos_plan", "chaos_seed"):
            assert getattr(t, f) == getattr(j, f), f
        assert t.device == "cuda"
