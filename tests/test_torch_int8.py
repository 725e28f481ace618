"""int8 feature storage (``feature_dtype`` int8 / int8_dot) in the port,
against the JAX package on the same seeded numpy inputs, on the CPU.

On CPU tensors the int8 wrappers take their plain versions; the CUDA
kernels are held against those on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Tolerances, each with its reason:

* ``quantize_sym``, ``_int8_chunk_len``, the trainer's int8 shards: equal
  (bit / byte identical: the same arithmetic);
* ``_int8_contract``: equal on its int32 routes (exact integer sums, the
  chunks added in the same order), rel 1e-6 on the bf16-convert route and
  the worst-case long contraction (f32 sums in another order);
* int8 features, f32 products: rel 1e-5 (f32 sums in another order);
  bf16 products: rel 1e-2 (the JAX model rounds the residual to bf16
  before the backward product, the port keeps it f32);
* int8_dot: wq, rq and both scales equal; logits and gradient rel 1e-6;
* trainers after 3 epochs: int8 rel 1e-5 (f32 products), int8_dot 1e-4.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.data.synthetic import write_synthetic_shards as jax_write_synthetic_shards
from distlr_tpu.models import BinaryLR as JaxBinaryLR
from distlr_tpu.models import SoftmaxRegression as JaxSoftmaxRegression
from distlr_tpu.models import linear as jax_linear
from distlr_tpu.parallel import make_mesh
from distlr_tpu.train import Trainer as JaxTrainer
from distlr_tpu_torch import ops
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.convert import params_from_jax, params_to_numpy
from distlr_tpu_torch.models import BinaryLR, SoftmaxRegression
from distlr_tpu_torch.ops import int8
from distlr_tpu_torch.train import Trainer

REPO = Path(__file__).resolve().parents[1]
B, D, K = 64, 256, 5
EVAL_LINE = re.compile(r"^\d\d:\d\d:\d\d Iteration (\d+), accuracy: (\S+)$", re.M)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These checks are small: one intra-op thread keeps them from crowding
    the suite's timing-sensitive tests running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _quantized(seed, b=B, d=D, masked_tail=5):
    """(w, Xq, y, mask, scale): an int8 X quantized as the trainer does."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((b, d)).astype(np.float32)
    scale = float(np.abs(X).max()) / 127.0
    Xq = np.clip(np.rint(X / scale), -127, 127).astype(np.int8)
    y = rng.integers(0, 2, b).astype(np.int32)
    mask = np.ones(b, np.float32)
    if masked_tail and b > 1:
        mask[-min(masked_tail, b - 1):] = 0
    w = (rng.standard_normal(d) * 0.5).astype(np.float32)
    return w, Xq, y, mask, scale


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --- the primitives ----------------------------------------------------------
class TestQuantizeSym:
    @pytest.mark.parametrize("case", ["normal", "ties", "zero", "negative_zero", "clipped"])
    def test_bit_identical_to_jax(self, case):
        rng = np.random.default_rng(3)
        if case == "normal":
            x = rng.standard_normal(1000).astype(np.float32)
            max_abs = np.abs(x).max()
        elif case == "ties":
            # max_abs 127 makes the grid step exactly 1.0 in f32: every
            # value below is an exact .5 tie, rounded half to even
            x = np.array([0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 126.5, -126.5, 125.5],
                         np.float32)
            max_abs = np.float32(127.0)
            assert np.float32(127.0) * np.float32(1.0 / 127.0) == 1.0
        elif case == "zero":
            x = np.zeros(16, np.float32)
            max_abs = np.float32(0.0)
        elif case == "negative_zero":
            x = np.array([-0.0, 0.0, -0.0, 1.0], np.float32)
            max_abs = np.float32(1.0)
        else:  # values beyond max_abs clip to +-127
            x = np.array([-3.0, 3.0, 1.0, -0.01], np.float32)
            max_abs = np.float32(1.0)
        qj, sj = jax_linear.quantize_sym(jnp.asarray(x), jnp.asarray(max_abs))
        qt, st = int8.quantize_sym(torch.from_numpy(x), torch.tensor(max_abs))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert np.asarray(sj).tobytes() == st.numpy().tobytes()
        if case == "ties":
            np.testing.assert_array_equal(qt.numpy(), [0, 2, 2, 4, 0, -2, -2, 126, -126, 126])


class TestInt8Contract:
    @pytest.mark.parametrize("k", [1, 133_144, 133_145, 1024 * 131 ** 2, 150_001, 2 ** 20])
    def test_chunk_len_matches_jax(self, k):
        assert int8._int8_chunk_len(k) == jax_linear._int8_chunk_len(k)
        assert int8._INT8_ACC_MAX == jax_linear._INT8_ACC_MAX == 133_144

    @pytest.mark.parametrize("route,k", [("unchunked", 300), ("chunked", 1024 * 131),
                                         ("convert", 150_001)])
    @pytest.mark.parametrize("a_axis", [0, 1])
    def test_matches_jax(self, route, k, a_axis):
        n_c = int8._int8_chunk_len(k)
        assert {"unchunked": n_c == k, "chunked": n_c is not None and n_c < k,
                "convert": n_c is None}[route]
        rng = np.random.default_rng(k)
        a = rng.integers(-127, 128, (3, k) if a_axis else (k, 3)).astype(np.int8)
        b = rng.integers(-127, 128, (k, 2)).astype(np.int8)
        want = np.asarray(jax_linear._int8_contract(jnp.asarray(a), jnp.asarray(b), a_axis))
        got = int8.int8_contract(*_t(a, b), a_axis).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        if route == "convert":  # f32 sums of exact products, in another order
            assert _rel(got, want) <= 1e-6
        else:  # exact int32 chunks added in the same order
            np.testing.assert_array_equal(got, want)

    def test_long_contraction_does_not_wrap_int32(self):
        """Every product +127 * 127 over 150,000 > 133,144 terms: one int32
        sum would wrap; the chunked form stays exact (closed form)."""
        d = 150_000
        want = 127.0 * 127.0 * d
        X, w = np.full((2, d), 127, np.int8), np.full(d, 127, np.int8)
        np.testing.assert_allclose(int8.int8_contract(*_t(X, w), 1).numpy(), [want] * 2,
                                   rtol=1e-6)
        r, Xb = np.full(d, 127, np.int8), np.full((d, 3), 127, np.int8)
        got = int8.int8_contract(*_t(r, Xb), 0).numpy()
        np.testing.assert_allclose(got, [want] * 3, rtol=1e-6)
        jax_got = np.asarray(jax_linear._int8_contract(jnp.asarray(r), jnp.asarray(Xb), 0))
        np.testing.assert_array_equal(got, jax_got)


# --- the models ----------------------------------------------------------------
def _jax_batch(Xq, y, mask):
    return jnp.asarray(Xq), jnp.asarray(y), jnp.asarray(mask)


class TestBinaryLRInt8:
    @pytest.mark.parametrize("cd,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
    def test_int8_matches_jax(self, cd, tol):
        w, Xq, y, mask, scale = _quantized(0)
        cfg = dict(num_feature_dim=D, l2_c=0.1, compute_dtype=cd)
        jm = JaxBinaryLR(D, compute_dtype=cd, feature_scale=scale)
        tm = BinaryLR(D, compute_dtype=cd, feature_scale=scale)
        jb, tb = _jax_batch(Xq, y, mask), _t(Xq, y, mask)
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
        # the logits need no residual: f32 sums in another order either way
        assert _rel(tm.logits(tw, tb[0]), jm.logits(jw, jb[0])) <= 1e-5
        assert _rel(tm.grad(tw, tb, Config(device="cpu", **cfg)),
                    jm.grad(jw, jb, JaxConfig(**cfg))) <= tol
        loss, g = tm.value_and_grad(tw, tb, Config(device="cpu", **cfg))
        assert _rel(loss, jm.loss(jw, jb, JaxConfig(**cfg))) <= 1e-5
        assert _rel(g, jm.grad(jw, jb, JaxConfig(**cfg))) <= tol

    def test_int8_dot_matches_jax(self):
        w, Xq, y, mask, scale = _quantized(1)
        cfg = dict(num_feature_dim=D, l2_c=0.1)
        jm = JaxBinaryLR(D, feature_scale=scale, int8_dot=True)
        tm = BinaryLR(D, feature_scale=scale, int8_dot=True)
        jb, tb = _jax_batch(Xq, y, mask), _t(Xq, y, mask)
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
        wq_j, sw_j = jax_linear.quantize_sym(jw, jnp.max(jnp.abs(jw)))
        wq_t, sw_t = int8.quantize_sym(tw, tw.abs().max())
        np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j))
        assert sw_t.numpy().tobytes() == np.asarray(sw_j).tobytes()
        zj, zt = jm.logits(jw, jb[0]), tm.logits(tw, tb[0])
        assert _rel(zt, zj) <= 1e-6
        rj = (1 / (1 + jnp.exp(-zj)) - jb[1]) * jb[2]
        rt = tm.residual(zt, tb[1], tb[2])
        rq_j, sr_j = jax_linear.quantize_sym(rj, jnp.max(jnp.abs(rj)))
        rq_t, sr_t = int8.quantize_sym(rt, rt.abs().max())
        np.testing.assert_array_equal(rq_t.numpy(), np.asarray(rq_j))
        assert sr_t.numpy().tobytes() == np.asarray(sr_j).tobytes()
        assert _rel(tm.grad(tw, tb, Config(device="cpu", **cfg)),
                    jm.grad(jw, jb, JaxConfig(**cfg))) <= 1e-6
        assert _rel(tm.loss(tw, tb, Config(device="cpu", **cfg)),
                    jm.loss(jw, jb, JaxConfig(**cfg))) <= 1e-6

    def test_scale_needs_an_int8_x(self):
        w, Xq, _, _, _ = _quantized(2)
        with pytest.raises(ValueError, match="int8 X"):
            BinaryLR(D, feature_scale=0.5).logits(torch.from_numpy(w),
                                                  torch.from_numpy(Xq.astype(np.float32)))


class TestSoftmaxInt8:
    def _data(self, seed):
        w, Xq, _, mask, scale = _quantized(seed)
        rng = np.random.default_rng(seed + 100)
        W = (rng.standard_normal((D, K)) * 0.1).astype(np.float32)
        y = rng.integers(0, K, B).astype(np.int32)
        return W, Xq, y, mask, scale

    @pytest.mark.parametrize("fd,cd,tol", [("int8", "float32", 1e-5), ("int8", "bfloat16", 1e-2),
                                           ("int8_dot", "bfloat16", 1e-6)])
    def test_matches_jax(self, fd, cd, tol):
        W, Xq, y, mask, scale = self._data(4)
        cfg = dict(model="softmax", num_feature_dim=D, num_classes=K, l2_c=0.1,
                   compute_dtype=cd, feature_dtype=fd)
        dot = fd == "int8_dot"
        jm = JaxSoftmaxRegression(D, K, compute_dtype=cd, feature_scale=scale, int8_dot=dot)
        tm = SoftmaxRegression(D, K, compute_dtype=cd, feature_scale=scale, int8_dot=dot)
        jb, tb = _jax_batch(Xq, y, mask), _t(Xq, y, mask)
        jW, tW = jnp.asarray(W), torch.from_numpy(W)
        assert _rel(tm.logits(tW, tb[0]), jm.logits(jW, jb[0])) <= (1e-6 if dot else 1e-5)
        assert _rel(tm.grad(tW, tb, Config(device="cpu", **cfg)),
                    jm.grad(jW, jb, JaxConfig(**cfg))) <= tol
        assert _rel(tm.loss(tW, tb, Config(device="cpu", **cfg)),
                    jm.loss(jW, jb, JaxConfig(**cfg))) <= 1e-5


# --- the plain versions of the int8 kernels -----------------------------------
# (B, D, masked tail): an odd D (no bulk copies on the card), B = 1
KERNEL_SHAPES = [(64, 256, 5), (37, 1003, 4), (1, 333, 0)]


class TestInt8KernelsPlain:
    @pytest.mark.parametrize("b,d,tail", KERNEL_SHAPES)
    @pytest.mark.parametrize("cd", ["float32", "bfloat16"])
    def test_int8_wrappers_match_jax(self, b, d, tail, cd):
        """K1 (single pass), K2 (streaming forward) and K3 (the two-read
        path's gradient) against the JAX model's logits and gradient."""
        w, Xq, y, mask, scale = _quantized(b + d, b, d, tail)
        jm = JaxBinaryLR(d, compute_dtype=cd, feature_scale=scale)
        jcfg = JaxConfig(num_feature_dim=d, l2_c=0.0, compute_dtype=cd)
        jb = _jax_batch(Xq, y, mask)
        z_j = jm.logits(jnp.asarray(w), jb[0])
        g_j = np.asarray(jm.grad(jnp.asarray(w), jb, jcfg)) * max(mask.sum(), 1.0)
        tw, tX, ty, tm = _t(w, Xq, y, mask)
        kw = dict(compute_dtype=cd, feature_scale=scale)
        g1, z1 = ops.fused_lr_grad(tw, tX, ty, tm, with_logits=True, **kw)
        g3 = ops.fused_lr_grad_two_launch(tw, tX, ty, tm, **kw)
        z2 = ops.lr_logits(tw, tX, **kw)
        z4 = ops.lr_logits_row_blocks(tw, tX, **kw)
        tol = 1e-5 if cd == "float32" else 1e-2
        for z in (z1, z2, z4):
            assert _rel(z, z_j) <= 1e-5
        for g in (g1, g3):
            assert _rel(g, g_j) <= tol

    @pytest.mark.parametrize("b,d,tail", KERNEL_SHAPES)
    def test_int8dot_wrappers_match_jax(self, b, d, tail):
        """K4's pair against the JAX model's int8_dot logits and gradient."""
        w, Xq, y, mask, scale = _quantized(b * d, b, d, tail)
        jm = JaxBinaryLR(d, feature_scale=scale, int8_dot=True)
        jb = _jax_batch(Xq, y, mask)
        z_j = jm.logits(jnp.asarray(w), jb[0])
        g_j = np.asarray(jm.grad(jnp.asarray(w), jb, JaxConfig(num_feature_dim=d, l2_c=0.0)))
        tw, tX, ty, tm = _t(w, Xq, y, mask)
        z = ops.lr_logits_int8dot(tw, tX, feature_scale=scale)
        z2, r = ops.lr_logits_int8dot(tw, tX, ty, tm, feature_scale=scale)
        g, zg = ops.fused_lr_grad_int8dot(tw, tX, ty, tm, feature_scale=scale, with_logits=True)
        g_back = ops.lr_backward_int8dot(tX, r, feature_scale=scale)
        for zz in (z, z2, zg):
            assert _rel(zz, z_j) <= 1e-6
        n = float(max(mask.sum(), 1.0))
        for gg in (g, g_back):
            assert _rel(gg / n, g_j) <= 1e-6
        torch.testing.assert_close(g, ops.fused_lr_grad_int8dot_reference(
            tw, tX, ty, tm, feature_scale=scale), rtol=0, atol=0)

    def test_all_masked_int8dot_gradient_is_zero(self):
        w, Xq, y, _, scale = _quantized(9)
        g = ops.fused_lr_grad_int8dot(*_t(w, Xq, y, np.zeros(B, np.float32)), feature_scale=scale)
        assert float(g.abs().max()) == 0.0

    @pytest.mark.parametrize("call", ["float16_x", "scaled_float_x", "int8dot_wrapper"])
    def test_wrappers_refuse_the_other_dtype(self, call):
        """The dense wrappers take f32, bf16 and int8 X, a scale only with
        int8; the int8_dot pair int8 alone."""
        w, Xq, y, mask, _ = _quantized(5)
        tw, tX, ty, tm = _t(w, Xq, y, mask)
        if call == "float16_x":
            with pytest.raises(TypeError, match="X must be"):
                ops.fused_lr_grad(tw, tX.half(), ty, tm)
        elif call == "scaled_float_x":
            with pytest.raises(ValueError, match="dequantizes an int8 X"):
                ops.lr_logits(tw, tX.float(), feature_scale=0.5)
        else:
            with pytest.raises(TypeError, match="X must be"):
                ops.lr_logits_int8dot(tw, tX.float())

    def test_plan_slices_are_16_column_multiples(self):
        for dim in (1003, 1_000_000, 1_000_003):
            for kernel in ("grad", "logits"):
                plan = ops.lr_launch_plan(37, dim, x_dtype=torch.int8, kernel=kernel)
                assert plan.single_pass and plan.slice_cols % 16 == 0
        wide = ops.lr_wide_plan(64, 6_000_000, x_dtype=torch.int8, compute_dtype="int8")
        assert wide.slice_cols % 16 == 0 and wide.slice_cols <= int8._INT8_ACC_MAX
        assert not ops.fused_lr_supported(64, 6_000_000, x_dtype=torch.int8)
        assert ops.fused_lr_supported(8, 5_406_720, x_dtype=torch.int8)
        assert not ops.fused_lr_supported(8, 5_406_721, x_dtype=torch.int8)


# --- the int8 single pass's plans: 16 compute warps where they fit -----------
# test_torch_ops.PLAN_SHAPES, beside the int8 single pass's shape bounds
INT8_PLAN_SHAPES = [(1, 1), (7, 13), (100, 1000), (3, 129), (64, 1055), (5, 1056),
                    (4096, 16384), (2048, 1_000_000), (8, 2_162_688), (8, 2_162_689),
                    (8, 2_500_001), (8, 5_045_568), (8, 5_406_720)]
SMEM_LIMIT, SMEM_PER_SM, STATIC = 232_448, 233_472, 3_072
# the int8 single pass's bound on 132 SMs, by product type (fused_lr_supported)
INT8_BOUNDS = {"bfloat16": 5_406_720, "float32": 5_045_568}


class TestInt8Plans:
    @pytest.mark.parametrize("cd", ["bfloat16", "float32"])
    @pytest.mark.parametrize("b,d", INT8_PLAN_SHAPES)
    def test_warps_rows_and_stages_fit(self, b, d, cd):
        """The plan's compute warps, rows and stages fit one block's shared
        memory, the ring's per-warp sums (16 stages at 8 warps, 8 at 16) and
        the register tile (20 groups a thread at 8 warps, 4 at 16); 16 warps
        only with bf16 products, wherever their register tile holds the
        slice."""
        plan = ops.lr_launch_plan(b, d, x_dtype=torch.int8, compute_dtype=cd)
        assert plan.single_pass == (d <= INT8_BOUNDS[cd])
        if not plan.single_pass:
            return
        warps = plan.compute_warps
        assert warps in (8, 16)
        w_bytes = 2 if cd == "bfloat16" else 4
        ring = plan.stages * plan.rows * plan.slice_cols
        assert plan.smem_bytes == ring + plan.slice_cols * w_bytes + STATIC <= SMEM_LIMIT
        assert plan.smem_bytes + 1_024 <= SMEM_PER_SM
        assert 1 <= plan.rows <= min(4, b) and 2 <= plan.stages <= 16 * 8 // warps
        groups = plan.slice_cols // 8
        assert plan.groups_per_thread == -(-groups // (warps * 32))
        assert plan.groups_per_thread <= {8: 20, 16: 4}[warps]
        fits_wide = -(-groups // 512) <= 4
        assert (warps == 16) == (cd == "bfloat16" and fits_wide)

    def test_main_path_plan(self):
        """(2048, 1M) int8 with bf16 products: 16 compute warps, 2 groups a
        thread, 4-row tiles in 7 stages, as the 8-warp plan had."""
        plan = ops.lr_launch_plan(2048, 1_000_000, x_dtype=torch.int8)
        assert (plan.ctas, plan.slice_cols, plan.rows, plan.stages) == (132, 7584, 4, 7)
        assert (plan.compute_warps, plan.groups_per_thread) == (16, 2)
        eight = ops.lr_launch_plan(2048, 1_000_000, x_dtype=torch.int8, compute_warps=8)
        assert (eight.rows, eight.stages, eight.groups_per_thread) == (4, 7, 4)

    def test_bound_keeps_eight_warps(self):
        """The int8 bound stays 5,406,720: there the slice needs a register
        tile of 20 groups, which only the 8-warp instances hold."""
        plan = ops.lr_launch_plan(8, 5_406_720, x_dtype=torch.int8)
        assert plan.single_pass and (plan.compute_warps, plan.groups_per_thread) == (8, 20)
        assert not ops.fused_lr_supported(8, 5_406_721, x_dtype=torch.int8)

    @pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("cd", ["bfloat16", "float32"])
    @pytest.mark.parametrize("b,d", INT8_PLAN_SHAPES)
    def test_float_plans_keep_eight_warps(self, b, d, x_dtype, cd):
        for kernel in ("grad", "logits"):
            plan = ops.lr_launch_plan(b, d, x_dtype=x_dtype, compute_dtype=cd, kernel=kernel)
            assert plan.compute_warps == 8
            assert plan.groups_per_thread == -(-(plan.slice_cols // 8) // 256)

    @pytest.mark.parametrize("kw", [dict(x_dtype=torch.bfloat16), dict(compute_dtype="float32"),
                                    dict(kernel="logits")])
    def test_sixteen_warps_only_for_the_int8_bf16_single_pass(self, kw):
        args = {"x_dtype": torch.int8, "compute_dtype": "bfloat16", "kernel": "grad", **kw}
        plan = ops.lr_launch_plan(2048, 1_000_000, compute_warps=16, **args)
        assert not plan.single_pass and plan.smem_bytes == 0

    def test_emulated_order_matches_jax(self):
        """The 16-warp single pass's sum order, emulated in plain f32 on 2
        SMs (16 warps of 32 threads a CTA, each thread's groups of 8 columns
        in order, a shuffle-down tree a warp, the warps in order, the CTAs in
        the resolvers' lane-strided order; then g in row order), against
        BinaryLR's logits and gradient with f32 products on bf16-exact w."""
        b, d = 9, 20_000
        w, Xq, y, mask, scale = _quantized(11, b, d, 2)
        w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
        plan = ops.lr_launch_plan(b, d, x_dtype=torch.int8, num_sms=2)
        assert (plan.compute_warps, plan.ctas, plan.groups_per_thread) == (16, 2, 3)
        z, g = _single_pass_emulation(plan, *_t(w, Xq, y.astype(np.float32), mask), scale)
        jm = JaxBinaryLR(d, compute_dtype="float32", feature_scale=scale)
        jb = _jax_batch(Xq, y, mask)
        assert _rel(z, jm.logits(jnp.asarray(w), jb[0])) <= 1e-5
        g_j = jm.grad(jnp.asarray(w), jb, JaxConfig(num_feature_dim=d, l2_c=0.0,
                                                     compute_dtype="float32"))
        assert _rel(g / mask.sum(), g_j) <= 1e-5


def _warp_tree(lanes):
    """A warp's shuffle-down sum over the last axis (32 lanes): lane 0's."""
    lanes = lanes.clone()
    for off in (16, 8, 4, 2, 1):
        lanes[..., :off] = lanes[..., :off] + lanes[..., off:2 * off]
    return lanes[..., 0]


def _single_pass_emulation(plan, w, X, y, mask, scale):
    """The single pass's z and g in its order of f32 additions."""
    threads = plan.compute_warps * 32
    partials = []
    Xf = X.to(torch.float32)
    for a, e in plan.slices():
        cols = plan.groups_per_thread * threads * 8
        xs = torch.zeros(X.shape[0], cols)
        ws = torch.zeros(cols)
        xs[:, :e - a], ws[:e - a] = Xf[:, a:e], w[a:e]
        # group j = k * threads + t: thread t's k-th group, 8 columns each
        xs = xs.view(-1, plan.groups_per_thread, threads, 8)
        ws = ws.view(plan.groups_per_thread, threads, 8)
        acc = torch.zeros(X.shape[0], threads)
        for k in range(plan.groups_per_thread):
            for i in range(8):
                acc = acc + xs[:, k, :, i] * ws[k, :, i]
        warps = _warp_tree(acc.view(-1, plan.compute_warps, 32))
        total = torch.zeros(X.shape[0])
        for v in warps.unbind(1):
            total = total + v
        partials.append(total)
    partials = torch.stack(partials, dim=1)
    lanes = torch.zeros(partials.shape[0], 32)
    for k in range(0, partials.shape[1], 32):
        chunk = partials[:, k:k + 32]
        lanes[:, :chunk.shape[1]] += chunk
    z = _warp_tree(lanes) * scale
    r = (torch.sigmoid(z) - y) * mask
    g = torch.zeros(X.shape[1])
    for b in range(X.shape[0]):
        g = g + r[b] * Xf[b]
    return z, g * scale


class TestSliceKernelsScript:
    """``benchmarks/slice_kernels.py``'s options, on a machine without the
    card (the script's measurements need one)."""

    @pytest.mark.parametrize("argv", [["--times"], ["--trace", "--x-dtype", "int8"],
                                      ["--sweep", "--x-dtype", "int8"],
                                      ["--wide", "--x-dtype", "int8", "--batch", "8"],
                                      ["--trace", "--x-dtype", "int8", "--compute-warps", "8"]])
    def test_exits_without_the_card(self, argv, capsys):
        from distlr_tpu_torch.benchmarks import slice_kernels

        if torch.cuda.is_available():
            pytest.skip("a card is present; this checks the refusal without one")
        assert slice_kernels.main(argv) == 2
        assert "needs the card" in capsys.readouterr().err

    @pytest.mark.parametrize("argv", [["--x-dtype", "fp8"], ["--compute-warps", "many"],
                                      ["--batch"]])
    def test_rejects_bad_options(self, argv):
        from distlr_tpu_torch.benchmarks import slice_kernels

        with pytest.raises(SystemExit) as e:
            slice_kernels.main(argv)
        assert e.value.code == 2

    def test_int8_plans_of_the_sweep(self):
        """Every int8 plan the sweep names either fits or is reported as not
        fitting (never raises), and the default plan is among them."""
        from distlr_tpu_torch.benchmarks import slice_kernels as sk

        seen = set()
        for kernel, plans in (("grad", sk.GRAD_PLANS["int8"]), ("logits", sk.LOGITS_PLANS["int8"])):
            for per_sm, rows, stages, warps in plans:
                plan = ops.lr_launch_plan(sk.B, sk.D, x_dtype=torch.int8, kernel=kernel,
                                          ctas_per_sm=per_sm, rows=rows, stages=stages,
                                          compute_warps=warps)
                if plan.single_pass:
                    seen.add((kernel, per_sm, plan.rows, plan.stages, plan.compute_warps))
        default = ops.lr_launch_plan(sk.B, sk.D, x_dtype=torch.int8)
        assert ("grad", 1, default.rows, default.stages, default.compute_warps) in seen


# --- the trainer ------------------------------------------------------------------
@pytest.fixture(scope="module")
def int8_data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("int8")
    jax_write_synthetic_shards(str(d), 600, D, num_parts=2, seed=7, sparsity=0.3)
    return str(d)


def _trainers(data_dir, fd, workers, **extra):
    kw = dict(data_dir=data_dir, num_feature_dim=D, num_iteration=3, batch_size=-1,
              learning_rate=0.5, l2_c=0.01, test_interval=0, compute_dtype="float32",
              feature_dtype=fd, num_workers=workers, **extra)
    jt = JaxTrainer(JaxConfig(**kw), mesh=make_mesh({"data": workers})).load_data()
    tt = Trainer(Config(device="cpu", **kw)).load_data()
    return jt, tt


class TestTrainerInt8:
    @pytest.mark.parametrize("fd", ["int8", "int8_dot"])
    def test_quantized_shards_byte_identical(self, int8_data_dir, fd):
        jt, tt = _trainers(int8_data_dir, fd, 2)
        assert tt.model.feature_scale == jt.model.feature_scale != 1.0
        assert tt.model.int8_dot == (fd == "int8_dot")
        for split in ("_train_data", "_test_data"):
            ours, theirs = getattr(tt, split), getattr(jt, split)
            assert ours._feats[0].dtype == np.int8
            assert ours._feats[0].tobytes() == np.asarray(theirs._feats[0]).tobytes()
            assert ours._quant_scale == theirs._quant_scale

    @pytest.mark.parametrize("fd,tol", [("int8", 1e-5), ("int8_dot", 1e-4)])
    @pytest.mark.parametrize("workers", [1, 2])
    def test_fit_matches_jax_trainer(self, int8_data_dir, fd, tol, workers):
        jt, tt = _trainers(int8_data_dir, fd, workers)
        jt.init_weights()
        tt.weights = params_from_jax(np.asarray(jt.weights), tt.model, "cpu")
        jt.fit()
        tt.fit()
        assert _rel(params_to_numpy(tt.weights), np.asarray(jt.weights)) <= tol
        jm, tm = jt.evaluate_metrics(), tt.evaluate_metrics()
        assert _rel(tm["logloss"], jm["logloss"]) <= tol

    def test_shared_dataset_across_trainers(self, int8_data_dir):
        """As in JAX: a second int8 Trainer reuses the stored scale; a
        float32 or bfloat16 one fails loudly."""
        _, tr1 = _trainers(int8_data_dir, "int8", 1)
        train, test = tr1._train_data, tr1._test_data
        cfg = Config(data_dir=int8_data_dir, num_feature_dim=D, num_iteration=1,
                     test_interval=0, feature_dtype="int8", device="cpu")
        tr2 = Trainer(cfg).load_data(train=train, test=test)
        assert tr2.model.feature_scale == tr1.model.feature_scale != 1.0
        assert train._feats[0].dtype == np.int8
        with pytest.raises(ValueError, match="quantized by a previous"):
            Trainer(cfg.replace(feature_dtype="float32")).load_data(train=train, test=test)
        with pytest.raises(ValueError, match="already quantized"):
            Trainer(cfg.replace(feature_dtype="bfloat16")).load_data(train=train, test=test)

    def test_inconsistent_scales_raise(self, int8_data_dir):
        _, tr1 = _trainers(int8_data_dir, "int8", 1)
        tr1._test_data._quant_scale = tr1._train_data._quant_scale * 2
        cfg = Config(data_dir=int8_data_dir, num_feature_dim=D, feature_dtype="int8",
                     device="cpu")
        with pytest.raises(ValueError, match="inconsistent quantization scales"):
            Trainer(cfg).load_data(train=tr1._train_data, test=tr1._test_data)

    def test_all_zero_features_take_scale_one(self, tmp_path):
        from distlr_tpu_torch.train import GlobalShardedData

        shard = (np.zeros((6, 8), np.float32), np.array([0, 1] * 3, np.int32))
        cfg = Config(data_dir=str(tmp_path), num_feature_dim=8, feature_dtype="int8",
                     device="cpu")
        tr = Trainer(cfg).load_data(train=GlobalShardedData([shard]),
                                    test=GlobalShardedData([shard]))
        assert tr.model.feature_scale == 1.0
        assert not tr._train_data._feats[0].any()

    def test_chunked_quantization_is_the_whole_array_arithmetic(self, monkeypatch):
        from distlr_tpu_torch.train import trainer

        X = np.random.default_rng(0).standard_normal((3, 50, 40)).astype(np.float32)
        scale = float(np.abs(X).max()) / 127.0
        monkeypatch.setattr(trainer, "_QUANT_CHUNK_BYTES", 7 * 40 * 4)
        assert trainer._int8_scale(X) == scale
        want = np.clip(np.rint(X / scale), -127, 127).astype(np.int8)
        assert trainer._quantize_int8(X, scale).tobytes() == want.tobytes()

    def test_eval_of_int8_needs_the_train_split(self, int8_data_dir):
        cfg = Config(data_dir=int8_data_dir, num_feature_dim=D, feature_dtype="int8",
                     device="cpu")
        with pytest.raises(ValueError, match="train split"):
            Trainer(cfg).load_data(test_only=True)

    def test_softmax_int8_dot_trainer_runs(self, tmp_path):
        d = str(tmp_path / "mc")
        jax_write_synthetic_shards(d, 300, 32, num_parts=1, seed=3, num_classes=3)
        kw = dict(data_dir=d, model="softmax", num_classes=3, num_feature_dim=32,
                  num_iteration=3, test_interval=0, l2_c=0.0, feature_dtype="int8_dot",
                  compute_dtype="float32")
        jt = JaxTrainer(JaxConfig(**kw), mesh=make_mesh({"data": 1})).load_data()
        jt.init_weights()
        tt = Trainer(Config(device="cpu", **kw)).load_data()
        tt.weights = params_from_jax(np.asarray(jt.weights), tt.model, "cpu")
        assert tt.model.int8_dot and tt.model.feature_scale == jt.model.feature_scale != 1.0
        jt.fit()
        tt.fit()
        assert _rel(params_to_numpy(tt.weights), np.asarray(jt.weights)) <= 1e-4


# --- the launch path ----------------------------------------------------------------
def _launch(*argv):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", *argv],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("fd", ["int8", "int8_dot"])
def test_gen_data_sync_eval_on_cpu(tmp_path, fd):
    """gen-data -> sync -> eval with int8 features: eval scores what the
    last sync line reported, within 0.03 of the same run on float32."""
    d = str(tmp_path / "d")
    _launch("gen-data", "--data-dir", d, "--num-feature-dim", "64", "--num-samples", "1000",
            "--num-parts", "2")
    last = {}
    for dtype in ("float32", fd):
        common = ["--data-dir", d, "--num-feature-dim", "64", "--feature-dtype", dtype,
                  "--device", "cpu"]
        out = _launch("sync", *common, "--num-workers", "2", "--num-iteration", "20",
                      "--test-interval", "10", "--learning-rate", "0.5", "--l2-c", "0")
        evals = EVAL_LINE.findall(out)
        assert [int(n) for n, _ in evals] == [10, 20]
        last[dtype] = float(evals[-1][1])
    ev = _launch("eval", *common, "--model-file", os.path.join(d, "models", "part-001"))
    m = re.search(r"accuracy: (\S+)\s+test_logloss: (\S+)", ev)
    assert m is not None and float(m.group(1)) == pytest.approx(last[fd], abs=1e-4)
    assert abs(last[fd] - last["float32"]) <= 0.03, last
