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

from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.models import BinaryLR as JaxBinaryLR
from distlr_tpu.ops import fused_lr_grad as jax_fused_lr_grad
from distlr_tpu.parallel import feature_parallel as jfp
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


# shapes above the single pass's bf16 bound: PLAN_SHAPES' at small SM
# counts (which put the bound within CPU-sized shapes), and the card
# tests' at 132 SMs
WIDE_SHAPES = [(B, D, n) for n in (2, 8) for B, D in PLAN_SHAPES
               if not ops.fused_lr_supported(B, D, num_sms=n)] + [
    (1, 5_045_569, 132), (8, 6_000_000, 132), (64, 6_000_000, 132), (2048, 6_000_000, 132),
    (7, 6_000_003, 132), (33, 3_100_001, 132)]
DTYPE_PAIRS = [(x, c) for x in (torch.bfloat16, torch.float32) for c in ("bfloat16", "float32")]


def _row_sum(partials):
    """Each row's partials summed as the epilogue's warp does: lane k adds
    columns k, k + 32, ... in order, then a shuffle-down tree."""
    lanes = partials.new_zeros(partials.shape[0], 32)
    for k in range(0, partials.shape[1], 32):
        chunk = partials[:, k:k + 32]
        lanes[:, :chunk.shape[1]] += chunk
    for off in (16, 8, 4, 2, 1):
        lanes[:, :off] = lanes[:, :off] + lanes[:, off:2 * off]
    return lanes[:, 0]


def _wide_emulation(plan, w, X, y, mask):
    """The two-read path's order in plain f32: each block's partial dot
    over its slice, the row totals in the epilogue's order, the residual,
    then g = rᵀX."""
    partials = torch.stack([X[:, a:b] @ w[a:b] for a, b in plan.slices()], dim=1)
    z = _row_sum(partials)
    r = (torch.sigmoid(z) - y) * mask
    return r @ X, z


class TestWidePlan:
    @pytest.mark.parametrize("x_dtype,compute_dtype", DTYPE_PAIRS)
    @pytest.mark.parametrize("B,D,num_sms", WIDE_SHAPES)
    def test_slices_cover_dim_in_whole_waves(self, B, D, num_sms, x_dtype, compute_dtype):
        plan = ops.lr_wide_plan(B, D, x_dtype=x_dtype, compute_dtype=compute_dtype,
                                num_sms=num_sms)
        slices = plan.slices()
        assert slices[0][0] == 0 and slices[-1][1] == D
        for (a, b), (c, _) in zip(slices, slices[1:]):
            assert b == c and (b - a) % 8 == 0 and b - a == plan.slice_cols
        # whole waves: short by fewer blocks than one per 8 SMs, where
        # slices rounded up to 8 columns leave the last blocks none
        wave = plan.ctas_per_sm * num_sms
        assert 0 <= plan.waves * wave - plan.ctas < max(1, num_sms // 8)
        assert ops.fused_lr.whole_waves(plan, num_sms)
        assert not plan.single_pass and plan.kernel == "logits"

    @pytest.mark.parametrize("x_dtype,compute_dtype", DTYPE_PAIRS)
    @pytest.mark.parametrize("B,D,num_sms", WIDE_SHAPES)
    def test_shared_memory_fits(self, B, D, num_sms, x_dtype, compute_dtype):
        plan = ops.lr_wide_plan(B, D, x_dtype=x_dtype, compute_dtype=compute_dtype,
                                num_sms=num_sms)
        assert plan.ctas_per_sm * (plan.smem_bytes + 1_024) <= 233_472
        x_bytes = 2 if x_dtype == torch.bfloat16 else 4
        w_bytes = 2 if compute_dtype == "bfloat16" else 4
        ring = plan.stages * plan.rows * plan.slice_cols * x_bytes
        assert plan.smem_bytes == ring + plan.slice_cols * w_bytes + 3_072
        assert 1 <= plan.rows <= min(4, B) and plan.stages == 2

    def test_wide_trainer_plan(self):
        """(64, 6M) bf16 on 132 SMs: 3 waves of 3 blocks per SM, 1,187
        blocks of 5,056 columns, 3-row tiles, about 72 KB each."""
        plan = ops.lr_wide_plan(64, 6_000_000)
        assert (plan.ctas, plan.ctas_per_sm, plan.waves) == (1187, 3, 3)
        assert (plan.slice_cols, plan.rows, plan.stages, plan.smem_bytes) == (5056, 3, 2, 73_856)

    def test_below_the_bound_one_wave(self):
        plan = ops.lr_wide_plan(2048, 1_000_000)
        assert (plan.waves, plan.ctas, plan.rows) == (1, 396, 4) and not plan.single_pass

    def test_waves_follow_the_rows(self):
        """One row a block: the fewest waves, as w's slice then costs the
        ring least; many rows: narrower slices, for 4-row tiles."""
        assert ops.lr_wide_plan(1, 5_045_569).waves == 2
        assert ops.lr_wide_plan(8, 5_045_569).waves == 4
        plan = ops.lr_wide_plan(8, 40_000_000)
        assert plan.waves > 4 and ops.fused_lr.whole_waves(plan, 132)

    @pytest.mark.parametrize("D", [1, 13, 1000, 3100])
    def test_narrow_dim_takes_one_partial_wave(self, D):
        plan = ops.lr_wide_plan(16, D)
        assert plan.waves == 1 and plan.slice_cols == 8 and plan.ctas == -(-D // 8) < 396

    def test_overrides(self):
        plan = ops.lr_wide_plan(64, 6_000_000, ctas_per_sm=2, waves=1)
        assert (plan.rows, plan.stages, plan.smem_bytes, plan.ctas) == (0, 0, 0, 264)
        plan = ops.lr_wide_plan(64, 6_000_000, ctas_per_sm=3, waves=2)
        assert (plan.ctas, plan.slice_cols, plan.rows, plan.stages) == (792, 7576, 1, 2)

    def test_single_pass_refuses_other_plans(self):
        """The wide plan never reaches the cooperative single pass (checked
        before any library is touched)."""
        w, X, y, mask = _torch(*_inputs(0, 4, 16))
        for plan in (ops.lr_wide_plan(4, 16), ops.lr_launch_plan(4, 16, kernel="logits")):
            with pytest.raises(ValueError, match="single pass"):
                ops.fused_lr.run_single_pass(None, plan, w, X, y, mask, "bfloat16")
        with pytest.raises(ValueError, match="streaming"):
            ops.fused_lr.run_streaming(None, ops.lr_launch_plan(4, 16), w, X, "bfloat16")

    @pytest.mark.parametrize("kw", [dict(ctas_per_sm=0), dict(waves=0), dict(dim=0),
                                    dict(batch=0), dict(compute_dtype="int8")])
    def test_rejects(self, kw):
        args = {"batch": 4, "dim": 8, **kw}
        with pytest.raises(ValueError):
            ops.lr_wide_plan(args.pop("batch"), args.pop("dim"), **args)

    def test_emulated_order_matches_jax(self):
        """The wide plan's sum order at 2 SMs (7 waves of 6 blocks) on
        bf16-exact f32 inputs, against BinaryLR.logits / grad and the
        Pallas kernel (interpret mode, on a copy padded to its tile
        rules with zero columns and masked rows)."""
        B, D = 5, 100_003
        w, X, y, mask = _inputs(10, B, D, masked_tail=1)
        X = torch.from_numpy(X).to(torch.bfloat16).float().numpy()
        w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
        plan = ops.lr_wide_plan(B, D, x_dtype=torch.float32, compute_dtype="float32", num_sms=2)
        assert (plan.ctas, plan.waves) == (42, 7) and not ops.fused_lr_supported(
            B, D, x_dtype=torch.float32, compute_dtype="float32", num_sms=2)
        g, z = _wide_emulation(plan, *_torch(w, X), *_torch(y.astype(np.float32), mask))

        def rel(got, want):
            got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
            return np.abs(got - want).max() / np.abs(want).max()

        model = JaxBinaryLR(D, compute_dtype="float32")
        cfg = JaxConfig(num_feature_dim=D, l2_c=0.0, compute_dtype="float32")
        assert rel(z, model.logits(jnp.asarray(w), jnp.asarray(X))) <= 1e-5
        g_model = model.grad(jnp.asarray(w), (jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask)),
                             cfg)
        assert rel(g / mask.sum(), g_model) <= 1e-5
        Bp, Dp = 16, -(-D // 128) * 128
        Xp = np.zeros((Bp, Dp), np.float32)
        Xp[:B, :D] = X
        pad = lambda v, n: np.concatenate([v, np.zeros(n - len(v), v.dtype)])  # noqa: E731
        g_pallas = np.asarray(jax_fused_lr_grad(
            jnp.asarray(pad(w, Dp)), jnp.asarray(Xp), jnp.asarray(pad(y, Bp)),
            jnp.asarray(pad(mask, Bp)), batch_tile=16, interpret=True))[:D]
        assert rel(g, g_pallas) <= 1e-5


# --- the float backward's grid: column tiles x row splits ---------------------
BACKWARD_SHAPES = [(1, 1), (1, 250_000), (3, 250_000), (5, 250_000), (37, 1003), (33, 12),
                   (1024, 250_000), (2048, 500_000), (2049, 600_016), (2048, 1_000_000),
                   (64, 6_000_000), (8, 40_000_000)]


def _backward_emulation(plan, X, r):
    """The float backward's order in plain f32: each split's sum over its
    rows, then the splits summed in split order."""
    parts = [r[a:b] @ X[a:b] for a, b in plan.row_ranges()]
    g = parts[0]
    for part in parts[1:]:
        g = g + part
    return g


class TestBackwardPlan:
    @pytest.mark.parametrize("num_sms", [132, 16, 2, 1])
    @pytest.mark.parametrize("B,D", BACKWARD_SHAPES)
    def test_rows_covered_once_in_order(self, B, D, num_sms):
        plan = ops.lr_backward_plan(B, D, num_sms=num_sms)
        ranges = plan.row_ranges()
        assert len(ranges) == plan.splits and ranges[0][0] == 0 and ranges[-1][1] == B
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert b == c
        assert all(b > a for a, b in ranges)  # no split without a row
        assert 1 <= plan.splits <= min(B, 8)
        assert (plan.col_tiles - 1) * 2048 < D <= plan.col_tiles * 2048
        # one cluster a tile: its size divides the grid's rows of blocks
        assert plan.cluster == plan.splits <= 8 and plan.blocks % plan.cluster == 0
        assert plan.blocks == plan.col_tiles * plan.splits
        # every block has an SM of its own wherever the rows are split
        assert plan.splits == 1 or plan.blocks <= num_sms

    @pytest.mark.parametrize("B,D", [(64, 6_000_000), (2048, 1_000_000), (8, 40_000_000),
                                     (1024, 250_000), (2048, 270_336), (1, 250_000)])
    def test_one_split_where_a_second_would_share_an_sm(self, B, D):
        """67 or more tiles on 132 SMs (2,930, 489, 123 at the
        feature-sharded block, 132), or one row."""
        assert ops.lr_backward_plan(B, D).splits == 1

    @pytest.mark.parametrize("D,splits", [(135_168, 2), (135_169, 1), (67_584, 4), (32_768, 8),
                                          (2048, 8)])
    def test_narrow_blocks_split_their_rows(self, D, splits):
        """66 tiles take 2 splits, 33 take 4, 16 or fewer 8 (the cluster's
        most); 67 tiles one."""
        plan = ops.lr_backward_plan(1024, D)
        assert plan.splits == splits and plan.blocks <= 132
        assert plan.splits == 8 or (plan.splits + 1) * plan.col_tiles > 132

    def test_main_path_plans(self):
        """On 132 SMs: the feature-sharded step's blocks at S = 4 and 8."""
        plan = ops.lr_backward_plan(1024, 250_000)
        assert (plan.col_tiles, plan.splits, plan.blocks) == (123, 1, 123)
        plan = ops.lr_backward_plan(1024, 125_000)
        assert (plan.col_tiles, plan.splits, plan.blocks) == (62, 2, 124)
        assert ops.lr_backward_plan(5, 125_000).row_ranges() == [(0, 2), (2, 5)]
        assert ops.lr_backward_plan(3, 4096).splits == 3  # capped at B

    def test_a_function_of_its_arguments(self):
        a = ops.lr_backward_plan(1024, 125_000, num_sms=100)
        b = ops.lr_backward_plan(1024, 125_000, num_sms=100)
        assert a == b and a.as_dict() == b.as_dict()
        assert a.as_dict()["blocks"] == a.blocks and a.as_dict()["cluster"] == a.splits
        assert ops.lr_backward_plan(1024, 125_000, num_sms=132) != a

    @pytest.mark.parametrize("kw", [dict(batch=0), dict(dim=0), dict(num_sms=0)])
    def test_rejects(self, kw):
        args = {"batch": 4, "dim": 8, **kw}
        with pytest.raises(ValueError):
            ops.lr_backward_plan(args.pop("batch"), args.pop("dim"), **args)

    @pytest.mark.parametrize("B,num_sms", [(37, 132), (3, 132), (37, 2)])
    def test_emulated_order_matches_jax(self, B, num_sms):
        """The kernel's order (per-split f32 sums, then the splits in
        order) at a small odd shape, 8 splits, splits capped at B = 3, and
        2 splits on two SMs, against JAX's ``resid_grad`` (n = 1, f32
        products) and the Pallas kernel's gradient (interpret mode, on a
        copy padded to its tile rules with zero columns and masked rows)
        on the residuals JAX computes; bf16-exact f32 inputs."""
        D = 1003
        w, X, y, mask = _inputs(12, B, D, masked_tail=1)
        X = torch.from_numpy(X).to(torch.bfloat16).float().numpy()
        w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
        plan = ops.lr_backward_plan(B, D, num_sms=num_sms)
        assert plan.splits == {37: 8 if num_sms == 132 else 2, 3: 3}[B]

        def rel(got, want):
            got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
            return np.abs(got - want).max() / np.abs(want).max()

        model = JaxBinaryLR(D, compute_dtype="float32")
        z = np.asarray(model.logits(jnp.asarray(w), jnp.asarray(X)))
        r = ((1.0 / (1.0 + np.exp(-z.astype(np.float64))) - y) * mask).astype(np.float32)
        g = _backward_emulation(plan, *_torch(X, r)).numpy()
        assert rel(g, jfp.resid_grad(model, jnp.asarray(r), jnp.asarray(X), 1.0)) <= 1e-5
        Bp, Dp = -(-B // 16) * 16, -(-D // 128) * 128
        Xp = np.zeros((Bp, Dp), np.float32)
        Xp[:B, :D] = X
        pad = lambda v, n: np.concatenate([v, np.zeros(n - len(v), v.dtype)])  # noqa: E731
        g_pallas = np.asarray(jax_fused_lr_grad(
            jnp.asarray(pad(w, Dp)), jnp.asarray(Xp), jnp.asarray(pad(y, Bp)),
            jnp.asarray(pad(mask, Bp)), batch_tile=16, interpret=True))[:D]
        assert rel(g, g_pallas) <= 1e-5

    @pytest.mark.parametrize("B,D", [(37, 1003), (3, 1003), (1024, 4096)])
    def test_emulated_order_matches_the_plain_version_at_bf16(self, B, D):
        """With X rounded to bf16 and r kept f32, as ``lr_backward`` on
        the card computes it."""
        rng = np.random.default_rng(B)
        X = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)).to(torch.bfloat16)
        r = torch.from_numpy(rng.standard_normal(B).astype(np.float32))
        g = _backward_emulation(ops.lr_backward_plan(B, D), X.float(), r)
        ref = ops.lr_backward_reference(X, r)
        assert float((g - ref).abs().max() / ref.abs().max()) <= 1e-5
