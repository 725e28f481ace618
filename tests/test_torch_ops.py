"""The port's gradient and logits functions against the JAX package's
Pallas kernel (interpret mode) and a float64 numpy oracle, on the CPU.

On CPU tensors the port's wrappers take their plain PyTorch versions; the
CUDA kernels themselves are held against those versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distlr_tpu.ops import fused_lr_grad as jax_fused_lr_grad
from distlr_tpu_torch import ops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These checks are tiny: one intra-op thread keeps them from crowding
    the suite's timing-sensitive tests running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracle_grad(w, X, y, mask):
    z = X.astype(np.float64) @ w
    sig = 1.0 / (1.0 + np.exp(-z))
    return ((sig - y) * mask) @ X


def _inputs(seed, B, D, masked_tail=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, D)).astype(np.float32)
    y = rng.integers(0, 2, B).astype(np.int32)
    mask = np.ones(B, np.float32)
    if masked_tail:
        mask[-masked_tail:] = 0
    w = (rng.standard_normal(D) * 0.1).astype(np.float32)
    return w, X, y, mask


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


class TestFusedLRGradParity:
    def test_matches_jax_kernel_interpret(self):
        """Same bf16 rounding of X and w, f32 sums in another order."""
        w, X, y, mask = _inputs(0, 64, 256, masked_tail=10)
        g_jax = np.asarray(jax_fused_lr_grad(
            jnp.asarray(w), jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask),
            batch_tile=16, interpret=True))
        g = ops.fused_lr_grad(*_torch(w, X, y, mask)).numpy()
        rel = np.abs(g - g_jax).max() / np.abs(g_jax).max()
        assert rel <= 1e-4, f"rel err {rel}"

    def test_matches_float64_oracle(self):
        """bf16 products bound the tolerance, as tests/test_ops.py does."""
        w, X, y, mask = _inputs(1, 64, 256, masked_tail=10)
        g = ops.fused_lr_grad(*_torch(w, X, y, mask)).numpy()
        g_ref = _oracle_grad(w, X, y.astype(np.float64), mask)
        rel = np.abs(g - g_ref).max() / np.abs(g_ref).max()
        assert rel < 5e-2, f"rel err {rel}"

    def test_float32_compute_is_exact_to_f32(self):
        w, X, y, mask = _inputs(2, 48, 96, masked_tail=5)
        g = ops.fused_lr_grad(*_torch(w, X, y, mask), compute_dtype="float32").numpy()
        g_ref = _oracle_grad(w, X, y.astype(np.float64), mask)
        np.testing.assert_allclose(g, g_ref, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("B,D", [(1, 1), (7, 13), (100, 1000), (3, 129)])
    def test_ragged_shapes(self, B, D):
        """The Hopper kernel takes any B, D; the TPU kernel's tile rules
        (B % BT, D % 128) do not apply."""
        assert ops.fused_lr_supported(B, D)
        w, X, y, mask = _inputs(3, B, D)
        g = ops.fused_lr_grad(*_torch(w, X, y, mask), compute_dtype="float32").numpy()
        g_ref = _oracle_grad(w, X, y.astype(np.float64), mask)
        np.testing.assert_allclose(g, g_ref, rtol=1e-4, atol=1e-5)
        z = ops.lr_logits(*_torch(w, X), compute_dtype="float32").numpy()
        np.testing.assert_allclose(z, X.astype(np.float64) @ w, rtol=1e-4, atol=1e-5)

    def test_all_masked_batch_is_zero(self):
        w, X, y, _ = _inputs(4, 32, 64)
        g = ops.fused_lr_grad(*_torch(w, X, y, np.zeros(32, np.float32)))
        assert torch.count_nonzero(g) == 0

    def test_with_logits_returns_the_forward(self):
        w, X, y, mask = _inputs(5, 16, 40)
        g, z = ops.fused_lr_grad(*_torch(w, X, y, mask), with_logits=True)
        torch.testing.assert_close(g, ops.fused_lr_grad(*_torch(w, X, y, mask)))
        torch.testing.assert_close(z, ops.lr_logits(*_torch(w, X)))

    def test_bfloat16_features_match_rounded_float32(self):
        """A bf16 X gives the same products as an f32 X rounded to bf16."""
        w, X, y, mask = _inputs(6, 32, 80, masked_tail=3)
        Xt = torch.from_numpy(X)
        g32 = ops.fused_lr_grad(torch.from_numpy(w), Xt, *_torch(y, mask))
        g16 = ops.fused_lr_grad(torch.from_numpy(w), Xt.to(torch.bfloat16), *_torch(y, mask))
        torch.testing.assert_close(g16, g32, rtol=1e-5, atol=1e-5)

    def test_launch_counters_stay_zero_on_cpu(self):
        """CPU tensors take the plain version, which launches nothing."""
        ops.reset_launch_counts()
        w, X, y, mask = _inputs(7, 8, 16)
        ops.fused_lr_grad(*_torch(w, X, y, mask))
        ops.lr_logits(*_torch(w, X))
        ops.fused_lr_grad_two_launch(*_torch(w, X, y, mask))
        ops.lr_logits_row_blocks(*_torch(w, X))
        assert ops.fused_lr_grad.launches == 0
        assert ops.lr_logits.launches == 0
        assert ops.fused_lr_grad_two_launch.launches == 0
        assert ops.lr_logits_row_blocks.launches == 0

    def test_two_launch_wrappers_match_jax_kernel_interpret(self):
        """The two-launch path (taken above the single pass's bound) holds
        the same function: its plain version against the Pallas kernel."""
        w, X, y, mask = _inputs(9, 32, 384, masked_tail=4)
        g_jax = np.asarray(jax_fused_lr_grad(
            jnp.asarray(w), jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask),
            batch_tile=16, interpret=True))
        g, z = ops.fused_lr_grad_two_launch(*_torch(w, X, y, mask), with_logits=True)
        rel = np.abs(g.numpy() - g_jax).max() / np.abs(g_jax).max()
        assert rel <= 1e-4, f"rel err {rel}"
        torch.testing.assert_close(z, ops.lr_logits_row_blocks(*_torch(w, X)))
        torch.testing.assert_close(z, ops.lr_logits(*_torch(w, X)))


# the single pass's shared-memory bound on 132 SMs, computed by hand:
# 132 * floor8((232_448 - 3_072) / (2 * x_bytes + w_bytes)), where the
# slice of w and two stages of one row must fit next to the static 3 KB
BOUNDS = [
    (torch.bfloat16, "bfloat16", 5_045_568),   # 6 bytes a column
    (torch.bfloat16, "float32", 3_784_704),    # 8
    (torch.float32, "bfloat16", 3_027_552),    # 10
    (torch.float32, "float32", 2_522_784),     # 12
]
PLAN_SHAPES = [(1, 1), (7, 13), (100, 1000), (3, 129), (64, 1055), (5, 1056),
               (4096, 16384), (2048, 1_000_000), (8, 2_500_001), (8, 5_045_568)]


class TestLaunchPlan:
    @pytest.mark.parametrize("kernel", ops.fused_lr.KERNELS)
    @pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("B,D", PLAN_SHAPES)
    def test_slices_cover_dim_exactly(self, B, D, x_dtype, kernel):
        plan = ops.lr_launch_plan(B, D, x_dtype=x_dtype, kernel=kernel)
        slices = plan.slices()
        assert len(slices) == plan.ctas >= 1
        assert slices[0][0] == 0 and slices[-1][1] == D
        for (a, b), (c, _) in zip(slices, slices[1:]):
            assert b == c, "slices must abut: no gap, no overlap"
            assert (b - a) % 8 == 0 and b - a == plan.slice_cols
        assert 0 < slices[-1][1] - slices[-1][0] <= plan.slice_cols

    @pytest.mark.parametrize("kernel", ops.fused_lr.KERNELS)
    @pytest.mark.parametrize("x_dtype,compute_dtype,bound", BOUNDS)
    @pytest.mark.parametrize("B,D", PLAN_SHAPES)
    def test_shared_memory_fits(self, B, D, x_dtype, compute_dtype, bound, kernel):
        plan = ops.lr_launch_plan(B, D, x_dtype=x_dtype, compute_dtype=compute_dtype,
                                  kernel=kernel)
        assert plan.single_pass == (D <= bound)
        if not plan.single_pass:
            return
        assert plan.smem_bytes <= 232_448
        # every block of an SM, each with the 1 KB the card keeps back
        assert plan.ctas_per_sm * (plan.smem_bytes + 1_024) <= 233_472
        x_bytes = 2 if x_dtype == torch.bfloat16 else 4
        w_bytes = 2 if compute_dtype == "bfloat16" else 4
        ring = plan.stages * plan.rows * plan.slice_cols * x_bytes
        assert plan.smem_bytes == ring + plan.slice_cols * w_bytes + 3_072
        assert 1 <= plan.rows <= min(4, B) and plan.stages >= 2
        assert plan.groups_per_thread * 256 * 8 >= plan.slice_cols

    @pytest.mark.parametrize("x_dtype,compute_dtype,bound", BOUNDS)
    def test_bound_flips_at_the_computed_dim(self, x_dtype, compute_dtype, bound):
        kw = dict(x_dtype=x_dtype, compute_dtype=compute_dtype)
        assert ops.fused_lr_supported(8, bound, **kw)
        assert not ops.fused_lr_supported(8, bound + 1, **kw)
        above = ops.lr_launch_plan(8, bound + 1, **kw)
        assert (above.rows, above.stages, above.smem_bytes) == (0, 0, 0)
        assert not ops.lr_launch_plan(8, bound + 1, kernel="logits", **kw).single_pass

    @pytest.mark.parametrize("D", [1, 8, 9, 500, 1048])
    def test_narrow_dim_uses_fewer_ctas(self, D):
        """Below 132 * 8 columns every block owns 8 (one group)."""
        plan = ops.lr_launch_plan(16, D)
        assert plan.slice_cols == 8 and plan.ctas == -(-D // 8) < 132

    def test_main_path_plan(self):
        """(2048, 1M) bf16: one block per SM owning 7,576 columns, 2-row
        (30 KB) tiles in 7 stages; the streaming logits two blocks per SM."""
        grad = ops.lr_launch_plan(2048, 1_000_000)
        assert (grad.ctas, grad.ctas_per_sm, grad.slice_cols) == (132, 1, 7576)
        assert (grad.rows, grad.stages, grad.groups_per_thread) == (2, 7, 4)
        logits = ops.lr_launch_plan(2048, 1_000_000, kernel="logits")
        assert (logits.ctas, logits.ctas_per_sm, logits.slice_cols) == (264, 2, 3792)
        assert (logits.rows, logits.stages) == (4, 2)

    def test_plan_follows_the_sm_count(self):
        plan = ops.lr_launch_plan(64, 1_000_000, num_sms=114)
        assert plan.ctas == 114 and plan.slice_cols == 8776

    @pytest.mark.parametrize("kw,err", [
        (dict(batch=0, dim=8), ValueError), (dict(batch=4, dim=0), ValueError),
        (dict(batch=4, dim=8, kernel="backward"), ValueError),
        (dict(batch=4, dim=8, compute_dtype="int8"), ValueError),
        (dict(batch=4, dim=8, x_dtype=torch.float16), TypeError)])
    def test_rejects(self, kw, err):
        with pytest.raises(err):
            ops.lr_launch_plan(**kw)


class TestInputChecks:
    @pytest.mark.parametrize("bad", ["w_shape", "y_shape", "x_dtype", "compute_dtype", "x_rank"])
    def test_rejects(self, bad):
        w, X, y, mask = _torch(*_inputs(8, 8, 16))
        kw = {}
        if bad == "w_shape":
            w = w[:-1]
        elif bad == "y_shape":
            y = y[:-1]
        elif bad == "x_dtype":
            X = X.to(torch.float16)
        elif bad == "compute_dtype":
            kw["compute_dtype"] = "int8"
        elif bad == "x_rank":
            X = X.reshape(-1)
        with pytest.raises((ValueError, TypeError)):
            ops.fused_lr_grad(w, X, y, mask, **kw)

    def test_meta_tensors_are_refused(self):
        """Only cpu (plain version) and cuda (kernel) tensors are taken."""
        X = torch.empty(4, 8, device="meta")
        w = torch.empty(8, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            ops.lr_logits(w, X)
