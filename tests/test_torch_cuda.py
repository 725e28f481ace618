"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  On the card
(where JAX is absent, so the JAX-importing ``tests/conftest.py`` is
skipped)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX.
"""

import pytest
import torch

from distlr_tpu_torch import ops
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.train import GlobalShardedData, Trainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, B, D, x_dtype, seed=0):
    """Random inputs with the last B // 5 rows masked (every row when B < 5)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    X = torch.randn(B, D, device=cuda, generator=gen).to(x_dtype)
    w = torch.randn(D, device=cuda, generator=gen) / D ** 0.5
    y = (torch.rand(B, device=cuda, generator=gen) < 0.5).to(torch.int32)
    mask = torch.ones(B, device=cuda)
    mask[-(B // 5):] = 0
    return w, X, y, mask


def _counts():
    return {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("B,D", [(64, 256), (100, 1000), (5, 13), (512, 4096)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_kernels_match_plain(cuda, B, D, x_dtype, compute_dtype):
    w, X, y, mask = _inputs(cuda, B, D, x_dtype)
    launches = ops.fused_lr_grad.launches
    g, z = ops.fused_lr_grad(w, X, y, mask, compute_dtype=compute_dtype, with_logits=True)
    torch.cuda.synchronize()
    assert ops.fused_lr_grad.launches == launches + 1
    g_ref = ops.fused_lr_grad_reference(w, X, y, mask, compute_dtype=compute_dtype)
    z_ref = ops.lr_logits_reference(w, X, compute_dtype=compute_dtype)
    # both sum in f32, in different orders
    assert (g - g_ref).abs().max() <= 1e-3 * g_ref.abs().max()
    assert (z - z_ref).abs().max() <= 1e-3 * z_ref.abs().max()
    torch.testing.assert_close(ops.lr_logits(w, X, compute_dtype=compute_dtype), z)


def test_kernel_is_deterministic(cuda):
    w, X, y, mask = _inputs(cuda, 300, 5000, torch.bfloat16)
    assert torch.equal(ops.fused_lr_grad(w, X, y, mask), ops.fused_lr_grad(w, X, y, mask))


# B not a multiple of R (2 or 4), D not a multiple of 8 (no bulk copies),
# D < 132 * 8 (fewer CTAs), a wide slice (several register groups a thread)
@pytest.mark.parametrize("B,D", [(7, 1003), (5, 500), (33, 70_001), (130, 600_000)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_single_pass_matches_plain(cuda, B, D, x_dtype, compute_dtype):
    w, X, y, mask = _inputs(cuda, B, D, x_dtype, seed=B)
    assert ops.fused_lr_supported(B, D, x_dtype=x_dtype, compute_dtype=compute_dtype)
    before = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    g = ops.fused_lr_grad(w, X, y, mask, compute_dtype=compute_dtype)
    z = ops.lr_logits(w, X, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    after = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    assert after["fused_lr_grad"] == before["fused_lr_grad"] + 1
    assert after["lr_logits"] == before["lr_logits"] + 1
    assert after["fused_lr_grad_two_launch"] == before["fused_lr_grad_two_launch"]
    # f32 sums in different orders
    assert _rel(g, ops.fused_lr_grad_reference(w, X, y, mask, compute_dtype=compute_dtype)) <= 1e-3
    assert _rel(z, ops.lr_logits_reference(w, X, compute_dtype=compute_dtype)) <= 1e-3


def test_misaligned_features_take_plain_loads(cuda):
    """A row view that is not 16-byte aligned cannot feed bulk copies."""
    w, X, y, mask = _inputs(cuda, 9, 4096, torch.bfloat16)
    Xv = X.reshape(-1)[1:1 + 8 * 4088].view(8, 4088)  # D % 8 == 0, 2 bytes off
    g = ops.fused_lr_grad(w[:4088], Xv, y[:8], mask[:8])
    assert _rel(g, ops.fused_lr_grad_reference(w[:4088], Xv, y[:8], mask[:8])) <= 1e-3


def test_above_the_bound_takes_the_two_launch_path(cuda):
    D = 5_045_569  # one column past the bf16 single pass's bound on 132 SMs
    w, X, y, mask = _inputs(cuda, 10, D, torch.bfloat16)
    if ops.fused_lr_supported(10, D, num_sms=torch.cuda.get_device_properties(0).multi_processor_count):
        pytest.skip("this card's SM count puts the bound above the test shape")
    before = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    g = ops.fused_lr_grad(w, X, y, mask)
    z = ops.lr_logits(w, X)
    torch.cuda.synchronize()
    after = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    assert after["fused_lr_grad"] == before["fused_lr_grad"]
    assert after["lr_logits"] == before["lr_logits"]
    assert after["fused_lr_grad_two_launch"] == before["fused_lr_grad_two_launch"] + 1
    assert after["lr_logits_row_blocks"] == before["lr_logits_row_blocks"] + 1
    assert _rel(g, ops.fused_lr_grad_reference(w, X, y, mask)) <= 1e-3
    assert _rel(z, ops.lr_logits_reference(w, X)) <= 1e-3


# above the single pass's bound on 132 SMs: one column past the bf16 bound
# at one row; the wide trainer's shapes; a D that is not a multiple of 8;
# an f32 X past both of its bounds (3,027,552 and 2,522,784)
WIDE_CASES = [
    (1, 5_045_569, torch.bfloat16, "bfloat16"),
    (8, 6_000_000, torch.bfloat16, "bfloat16"),
    (8, 6_000_000, torch.bfloat16, "float32"),
    (64, 6_000_000, torch.bfloat16, "bfloat16"),
    (7, 6_000_003, torch.bfloat16, "bfloat16"),
    (33, 3_100_001, torch.float32, "bfloat16"),
    (33, 3_100_001, torch.float32, "float32"),
]


@pytest.mark.parametrize("B,D,x_dtype,compute_dtype", WIDE_CASES)
def test_two_read_path_matches_plain_above_the_bound(cuda, B, D, x_dtype, compute_dtype):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if ops.fused_lr_supported(B, D, x_dtype=x_dtype, compute_dtype=compute_dtype, num_sms=sms):
        pytest.skip("this card's SM count puts the bound above the test shape")
    w, X, y, mask = _inputs(cuda, B, D, x_dtype, seed=B)
    if B < 5:
        mask.fill_(1.0)
    before = _counts()
    g, z = ops.fused_lr_grad(w, X, y, mask, compute_dtype=compute_dtype, with_logits=True)
    z_rows = ops.lr_logits(w, X, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    after = _counts()
    assert after["fused_lr_grad_two_launch"] == before["fused_lr_grad_two_launch"] + 1
    assert after["lr_logits_row_blocks"] == before["lr_logits_row_blocks"] + 1
    assert after["fused_lr_grad"] == before["fused_lr_grad"]
    assert after["lr_logits"] == before["lr_logits"]
    # f32 sums in different orders
    g_ref = ops.fused_lr_grad_reference(w, X, y, mask, compute_dtype=compute_dtype)
    assert _rel(g, g_ref) <= 1e-3
    assert _rel(z, ops.lr_logits_reference(w, X, compute_dtype=compute_dtype)) <= 1e-3
    # the epilogue's z is the forward's: the same bits as lr_logits_row_blocks
    assert torch.equal(z, z_rows)
    # fixed sum orders, no atomics: the same bits on a second call
    g2, z2 = ops.fused_lr_grad_two_launch(w, X, y, mask, compute_dtype=compute_dtype,
                                          with_logits=True)
    assert torch.equal(g, g2) and torch.equal(z, z2)
    assert torch.equal(z_rows, ops.lr_logits_row_blocks(w, X, compute_dtype=compute_dtype))


def test_two_read_path_takes_misaligned_rows(cuda):
    """Above the bound, a row view 2 bytes off 16-byte alignment: the
    producer fills the stages with plain loads, the backward takes its
    scalar path."""
    D = 5_999_992  # a multiple of 8
    w, X, y, mask = _inputs(cuda, 9, D + 8, torch.bfloat16)
    Xv = X.reshape(-1)[1:1 + 8 * D].view(8, D)
    w, y, mask = w[:D], y[:8], mask[:8]
    before = _counts()
    g = ops.fused_lr_grad(w, Xv, y, mask)
    z = ops.lr_logits(w, Xv)
    torch.cuda.synchronize()
    after = _counts()
    assert after["fused_lr_grad_two_launch"] == before["fused_lr_grad_two_launch"] + 1
    assert after["lr_logits_row_blocks"] == before["lr_logits_row_blocks"] + 1
    assert _rel(g, ops.fused_lr_grad_reference(w, Xv, y, mask)) <= 1e-3
    assert _rel(z, ops.lr_logits_reference(w, Xv)) <= 1e-3


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_wide_plan_counts_the_cards_waves(cuda, x_dtype, compute_dtype):
    """The two-read plan's blocks per SM are the runtime's figure for the
    streaming kernel, which its launch bounds hold at WIDE_CTAS_PER_SM (the
    CPU plans' default), and that many of the plan's blocks fit an SM with
    their shared memory."""
    fl = ops.fused_lr
    per_sm = fl.streaming_blocks_per_sm(fl._lib(), x_dtype, compute_dtype)
    assert per_sm == fl.WIDE_CTAS_PER_SM
    X = torch.empty((), dtype=x_dtype, device=cuda).expand(64, 6_000_000)
    plan = fl.wide_plan_for(X, compute_dtype)
    assert plan.ctas_per_sm == per_sm and plan.smem_bytes
    assert fl.whole_waves(plan, torch.cuda.get_device_properties(0).multi_processor_count)
    assert fl.streaming_blocks_per_sm(fl._lib(), x_dtype, compute_dtype,
                                      plan.dynamic_smem_bytes) == per_sm


def test_main_path_kernels_keep_their_bits(cuda):
    """The single pass and the streaming logits at the trainer's shape,
    (2048, 1M) bf16, give the bits recorded in main_path_bits.RECORDED,
    under both compute types.  A new toolkit may move them: re-record with
    ``python -m distlr_tpu_torch.benchmarks.main_path_bits`` only after
    checking that the kernels' sources did not change their sums."""
    from distlr_tpu_torch.benchmarks import main_path_bits as bits

    if torch.cuda.get_device_properties(0).multi_processor_count != bits.RECORDED["sms"]:
        pytest.skip("the recorded digests follow the launch plan of a 132-SM card")
    assert bits.main_path_digests(cuda) == bits.RECORDED["digests"]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_with_logits_agrees_with_lr_logits(cuda, x_dtype):
    w, X, y, mask = _inputs(cuda, 257, 300_000, x_dtype)
    _, z = ops.fused_lr_grad(w, X, y, mask, with_logits=True)
    z_ref = ops.lr_logits(w, X)
    assert (z - z_ref).abs().max() <= 1e-5 * z_ref.abs().max()


def test_slice_kernels_are_deterministic(cuda):
    w, X, y, mask = _inputs(cuda, 512, 1_000_000, torch.bfloat16)
    g1, z1 = ops.fused_lr_grad(w, X, y, mask, with_logits=True)
    g2, z2 = ops.fused_lr_grad(w, X, y, mask, with_logits=True)
    assert torch.equal(g1, g2) and torch.equal(z1, z2)
    assert torch.equal(ops.lr_logits(w, X), ops.lr_logits(w, X))


@pytest.mark.parametrize("D", [256, 100_003, 1_000_000])
def test_all_masked_batch_is_exactly_zero(cuda, D):
    w, X, y, _ = _inputs(cuda, 64, D, torch.bfloat16)
    g = ops.fused_lr_grad(w, X, y, torch.zeros(64, device=cuda))
    assert float(g.abs().max()) == 0.0


def test_non_contiguous_features_refused(cuda):
    w, X, y, mask = _inputs(cuda, 16, 64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_lr_grad(w[:32], X[:, ::2], y, mask)


# --- int8 features: the int8 instances (K1-K3) and the int8_dot pair (K4) ----
INT8_SCALE = 3.0 / 127.0


def _rel0(a, b):
    """``_rel`` that takes two all-zero results (an all-masked batch) as equal."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _int8_inputs(cuda, B, D, seed=0):
    """An int8 X uniform in [-127, 127], the last B // 5 rows masked (every
    row when B < 5)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    X = torch.randint(-127, 128, (B, D), device=cuda, generator=gen, dtype=torch.int8)
    w = torch.randn(D, device=cuda, generator=gen) / D ** 0.5
    y = (torch.rand(B, device=cuda, generator=gen) < 0.5).to(torch.int32)
    mask = torch.ones(B, device=cuda)
    mask[-(B // 5):] = 0
    return w, X, y, mask


# D % 16 != 0 (no bulk copies), B = 1, fewer CTAs than SMs, a wide slice,
# above the single pass's bound (B = 1 there too), two chunks of staged
# residuals in the two-read backward
@pytest.mark.parametrize("B,D", [(64, 256), (37, 1003), (1, 333), (130, 600_000),
                                 (9, 5_500_000), (1, 6_000_000), (2049, 600_016)])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_int8_kernels_match_plain(cuda, B, D, compute_dtype):
    s = INT8_SCALE
    w, X, y, mask = _int8_inputs(cuda, B, D, seed=B)
    kw = dict(compute_dtype=compute_dtype, feature_scale=s)
    single = ops.fused_lr_supported(B, D, x_dtype=torch.int8, compute_dtype=compute_dtype)
    before = _counts()
    g, z = ops.fused_lr_grad(w, X, y, mask, with_logits=True, **kw)
    torch.cuda.synchronize()
    after = _counts()
    assert after["fused_lr_grad_int8"] == before["fused_lr_grad_int8"] + single
    assert after["fused_lr_grad_two_launch_int8"] == (
        before["fused_lr_grad_two_launch_int8"] + (not single))
    assert after["fused_lr_grad"] == before["fused_lr_grad"]
    g_ref = ops.fused_lr_grad_reference(w, X, y, mask, **kw)
    z_ref = ops.lr_logits_reference(w, X, **kw)
    assert _rel0(g, g_ref) <= 1e-3 and _rel0(z, z_ref) <= 1e-3
    assert _rel0(ops.lr_logits(w, X, **kw), z_ref) <= 1e-3
    assert _rel0(ops.lr_logits_row_blocks(w, X, **kw), z_ref) <= 1e-3
    assert _rel0(ops.fused_lr_grad_two_launch(w, X, y, mask, **kw), g_ref) <= 1e-3


@pytest.mark.parametrize("B,D", [(64, 256), (37, 1003), (1, 333), (130, 600_000),
                                 (9, 6_000_000)])
def test_int8dot_kernels_match_plain(cuda, B, D):
    """The forward against the plain int8 contraction (int32 chunks in
    both: equal but for the f32 sums across slices); the backward given
    the same residuals quantizes them alike, so its int32 sums are equal."""
    s = INT8_SCALE
    w, X, y, mask = _int8_inputs(cuda, B, D, seed=D)
    before = _counts()
    z, r = ops.lr_logits_int8dot(w, X, y, mask, feature_scale=s)
    g = ops.lr_backward_int8dot(X, r, feature_scale=s)
    torch.cuda.synchronize()
    after = _counts()
    assert after["lr_logits_int8dot"] == before["lr_logits_int8dot"] + 1
    assert after["lr_backward_int8dot"] == before["lr_backward_int8dot"] + 1
    assert _rel0(z, ops.lr_logits_int8dot_reference(w, X, feature_scale=s)) <= 1e-5
    assert _rel0(g, ops.lr_backward_int8dot_reference(X, r, feature_scale=s)) <= 1e-6
    assert torch.equal(ops.fused_lr_grad_int8dot(w, X, y, mask, feature_scale=s),
                       ops.fused_lr_grad_int8dot(w, X, y, mask, feature_scale=s))


def test_int8dot_long_backward_does_not_wrap(cuda):
    """140,000 rows of all-127 X with every residual 1: rq is all 127, the
    exact sum 127^2 * 140,000 exceeds int32, the kernel flushes in time."""
    X = torch.full((140_000, 64), 127, dtype=torch.int8, device=cuda)
    g = ops.lr_backward_int8dot(X, torch.ones(140_000, device=cuda))
    s_r = float(ops.fused_lr.sym_scale(torch.ones((), device=cuda)))
    closed = 127.0 * 127.0 * 140_000 * s_r
    assert float((g.double() - closed).abs().max()) <= 1e-6 * closed


@pytest.mark.parametrize("m,k,n", [(1, 2048, 1000), (37, 1003, 10), (20, 64, 8)])
def test_int8_mm_is_exact(cuda, m, k, n):
    """The plain int8_dot versions' GEMM (torch._int_mm, padded to its
    shape rules) against f64 products, exact for these integer sums."""
    from distlr_tpu_torch.ops.int8 import int8_mm

    gen = torch.Generator(device=cuda).manual_seed(m)
    a = torch.randint(-127, 128, (m, k), device=cuda, generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), device=cuda, generator=gen, dtype=torch.int8)
    assert torch.equal(int8_mm(a, b).double(), a.double() @ b.double())


def test_int8_single_pass_is_deterministic(cuda):
    w, X, y, mask = _int8_inputs(cuda, 512, 1_000_000)
    g1, z1 = ops.fused_lr_grad(w, X, y, mask, feature_scale=0.5, with_logits=True)
    g2, z2 = ops.fused_lr_grad(w, X, y, mask, feature_scale=0.5, with_logits=True)
    assert torch.equal(g1, g2) and torch.equal(z1, z2)


def test_int8_two_read_is_deterministic(cuda):
    """The int8 two-read gradient and its backward alone give the same bits
    on a second call."""
    w, X, y, mask = _int8_inputs(cuda, 64, 6_000_000)
    g1 = ops.fused_lr_grad_two_launch(w, X, y, mask, feature_scale=0.5)
    assert torch.equal(g1, ops.fused_lr_grad_two_launch(w, X, y, mask, feature_scale=0.5))
    lib, r = ops.fused_lr._int8_lib(), torch.randn(64, device=cuda)
    b1 = ops.fused_lr.run_backward(lib, X, r, "bfloat16", 0.5)
    assert torch.equal(b1, ops.fused_lr.run_backward(lib, X, r, "bfloat16", 0.5))


# the int8 backward: B = 1, B = 2049 (two chunks of staged residuals), an
# unaligned X view and D % 8 != 0 (its scalar path), a partial last
# column block, and the trainer's shape
@pytest.mark.parametrize("B,D,offset", [(1, 6_000_000, 0), (2049, 600_016, 0), (37, 1003, 0),
                                        (64, 60_000, 1), (5, 13, 0), (64, 6_000_000, 0)])
def test_int8_backward_matches_plain(cuda, B, D, offset):
    s = INT8_SCALE
    gen = torch.Generator(device=cuda).manual_seed(B + D)
    flat = torch.randint(-127, 128, (B * D + offset,), device=cuda, generator=gen,
                         dtype=torch.int8)
    X = flat[offset:].view(B, D)
    assert X.is_contiguous() and (X.data_ptr() % 16 != 0) == (offset != 0)
    r = torch.randn(B, device=cuda, generator=gen)
    g = ops.fused_lr.run_backward(ops.fused_lr._int8_lib(), X, r, "bfloat16", s)
    # f32 sums in row order against f64 ones
    assert _rel0(g.double(), (r.double() @ X.double()) * s) <= 1e-4
    w, y = torch.randn(D, device=cuda, generator=gen) / D ** 0.5, (r > 0).to(torch.int32)
    mask = torch.ones(B, device=cuda)
    before = ops.fused_lr_grad_two_launch.int8.launches
    g2 = ops.fused_lr_grad_two_launch(w, X, y, mask, feature_scale=s)
    torch.cuda.synchronize()
    assert ops.fused_lr_grad_two_launch.int8.launches == before + 1
    assert _rel0(g2, ops.fused_lr_grad_reference(w, X, y, mask, feature_scale=s)) <= 1e-3


def test_int8_backward_grid_is_whole_waves(cuda):
    """The backward's grid is the blocks an SM holds (the runtime's
    figure) times the SMs, fewer where D has fewer column blocks."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    X = torch.empty((), dtype=torch.int8, device=cuda).expand(64, 6_000_000)
    grid = ops.fused_lr.int8_backward_grid(X)
    assert grid["blocks_per_sm"] >= 1 and grid["blocks"] == grid["blocks_per_sm"] * sms
    assert ops.fused_lr.int8_backward_grid(X[:, :333])["blocks"] == 1


def test_int8_single_pass_takes_the_plans_warps(cuda):
    """The plan's compute warps reach the launch: at (256, 1M) int8 with
    bf16 products the plan takes 16 (on 132 SMs), 8 warps launch too, both
    match the plain version, and warp counts or register tiles that no
    instance has are refused."""
    import dataclasses

    fl = ops.fused_lr
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    w, X, y, mask = _int8_inputs(cuda, 256, 1_000_000)
    plan = fl.launch_plan_for(X)
    if sms == 132:
        assert (plan.compute_warps, plan.groups_per_thread) == (16, 2)
    lib = fl._int8_lib()
    ref = fl.fused_lr_grad_reference(w, X, y, mask, feature_scale=0.5)
    for warps in (16, 8):
        p = fl.lr_launch_plan(256, 1_000_000, x_dtype=torch.int8, compute_warps=warps,
                              num_sms=sms)
        assert p.single_pass and p.compute_warps == warps
        g, _ = fl.run_single_pass(lib, p, w, X, y, mask, "bfloat16", feature_scale=0.5)
        assert _rel(g, ref) <= 1e-3
    for bad in (dataclasses.replace(plan, compute_warps=12),
                dataclasses.replace(plan, compute_warps=16, groups_per_thread=8)):
        with pytest.raises(RuntimeError, match="launch failed"):
            fl.run_single_pass(lib, bad, w, X, y, mask, "bfloat16", feature_scale=0.5)
    f32 = dataclasses.replace(fl.launch_plan_for(X, "float32"), compute_warps=16)
    with pytest.raises(RuntimeError, match="launch failed"):
        fl.run_single_pass(lib, f32, w, X, y, mask, "float32", feature_scale=0.5)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32", "int8"])
def test_int8_wide_plan_counts_the_cards_waves(cuda, compute_dtype):
    fl = ops.fused_lr
    per_sm = fl.streaming_blocks_per_sm(fl._int8_lib(), torch.int8, compute_dtype)
    X = torch.empty((), dtype=torch.int8, device=cuda).expand(64, 6_000_000)
    plan = fl.wide_plan_for(X, compute_dtype)
    assert plan.ctas_per_sm == per_sm >= 1 and plan.smem_bytes
    assert plan.slice_cols % 16 == 0
    assert fl.whole_waves(plan, torch.cuda.get_device_properties(0).multi_processor_count)


@pytest.mark.parametrize("fd", ["int8", "int8_dot"])
def test_int8_trainer_on_card_matches_cpu(cuda, fd):
    import numpy as np

    rng = np.random.default_rng(0)
    shards = [(rng.standard_normal((300, 512)).astype(np.float32),
               rng.integers(0, 2, 300).astype(np.int32)) for _ in range(2)]
    kw = dict(num_feature_dim=512, num_iteration=3, batch_size=-1, learning_rate=0.5,
              l2_c=0.01, test_interval=0, compute_dtype="float32", feature_dtype=fd,
              num_workers=2)
    weights = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(Config(device=dev, **kw)).load_data(
            train=GlobalShardedData(shards), test=GlobalShardedData(shards[:1]))
        tr.weights = torch.linspace(-0.1, 0.1, 512, device=dev)
        weights[dev] = tr.fit().cpu()
    assert _rel(weights["cuda"], weights["cpu"]) <= 1e-4


def test_trainer_on_card_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(0)
    X = torch.randn(400, 40, generator=gen).numpy()
    y = (torch.rand(400, generator=gen) < 0.5).to(torch.int32).numpy()
    kw = dict(num_feature_dim=40, num_iteration=5, batch_size=64, num_workers=2,
              compute_dtype="float32", test_interval=0)
    data = lambda: GlobalShardedData([(X[:200], y[:200]), (X[200:], y[200:])])  # noqa: E731
    on_card = Trainer(Config(**kw)).load_data(train=data(), test=data())
    on_cpu = Trainer(Config(device="cpu", **kw)).load_data(train=data(), test=data())
    ops.reset_launch_counts()
    w_card = on_card.fit()
    assert ops.fused_lr_grad.launches == 5 * 4 * 2  # epochs x steps x shards
    torch.testing.assert_close(w_card.cpu(), on_cpu.fit(), rtol=1e-4, atol=1e-5)


# --- the other model families (library GEMMs, gathers and index_add_) -------
def _family_shards(family, seed=0):
    """Two shards of one family's leaves, made with numpy from ``seed``."""
    import numpy as np

    from distlr_tpu_torch.data.hashing import encode_blocked, make_ctr_dataset

    rng = np.random.default_rng(seed)
    if family == "softmax":
        X = rng.standard_normal((400, 40)).astype(np.float32)
        leaves = (X, rng.integers(0, 5, 400).astype(np.int32))
    else:
        raw, cols, vals, y, _ = make_ctr_dataset(400, 6, 50, 4096, seed=seed)
        if family == "sparse_softmax":
            y = rng.integers(0, 5, 400).astype(np.int32)
        leaves = (*encode_blocked(raw, 4096 // 8, 8, seed=seed), y) if family == "blocked_lr" \
            else (cols, vals, y)
    return [tuple(a[:200] for a in leaves), tuple(a[200:] for a in leaves)]


@pytest.mark.parametrize("compat_mode", ["correct", "reference"])
@pytest.mark.parametrize("family", ["softmax", "sparse_lr", "sparse_softmax", "blocked_lr"])
def test_family_step_on_card_matches_cpu(cuda, family, compat_mode):
    """Five epochs of 64-row steps over two workers' shards on the card and
    on the CPU land on the same weights: the sparse scatters add
    atomically in another order, dense softmax sums its bf16 products in
    another order (rel 1e-4 / 1e-3)."""
    D = 40 if family == "softmax" else 4096
    kw = dict(model=family, num_feature_dim=D, num_classes=5, num_iteration=5, batch_size=64,
              num_workers=2, learning_rate=0.3, l2_c=0.01, test_interval=0,
              compat_mode=compat_mode)
    on_card = Trainer(Config(**kw)).load_data(train=GlobalShardedData(_family_shards(family)),
                                              test=GlobalShardedData(_family_shards(family, 1)))
    on_cpu = Trainer(Config(device="cpu", **kw)).load_data(
        train=GlobalShardedData(_family_shards(family)),
        test=GlobalShardedData(_family_shards(family, 1)))
    w0 = on_cpu.init_weights() + 0.01
    on_card.weights, on_cpu.weights = w0.cuda(), w0.clone()
    ops.reset_launch_counts()
    w_card = on_card.fit()
    assert w_card.is_cuda and w_card.shape == on_card.model.param_shape
    assert not any(_counts().values())  # no kernel of ops is on these paths
    w_cpu = on_cpu.fit()
    assert _rel(w_card.cpu(), w_cpu) <= (1e-3 if family == "softmax" else 1e-4)
    m_card, m_cpu = on_card.evaluate_metrics(), on_cpu.evaluate_metrics()
    assert abs(m_card["logloss"] - m_cpu["logloss"]) <= 1e-4 * abs(m_cpu["logloss"])


@pytest.mark.parametrize("m,k,n", [(64, 1000, 10), (2048, 96, 10), (5, 13, 3)])
def test_bf16_mm_has_an_f32_result(cuda, m, k, n):
    """``torch.mm(a, b, out_dtype=torch.float32)`` on bf16 operands returns
    f32, equal to the f32 product of the same bf16 values up to the order
    of the f32 sums (not rounded to bf16)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(m, k, device=cuda, generator=gen).to(torch.bfloat16)
    b = torch.randn(k, n, device=cuda, generator=gen).to(torch.bfloat16)
    got = torch.mm(a, b, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    want = a.float() @ b.float()
    assert _rel(got, want) <= 1e-5
    assert _rel(torch.mm(a.t().contiguous().t(), b, out_dtype=torch.float32), want) <= 1e-5
    if k >= 96:  # a bf16 result would be off by ~2^-9 of the largest value
        assert not torch.equal(got, (a @ b).float())


def test_softmax_products_on_card_match_cpu(cuda):
    """The dense softmax model's forward and backward GEMMs on a bf16 X on
    the card against the same model on the CPU."""
    from distlr_tpu_torch.models import SoftmaxRegression

    gen = torch.Generator().manual_seed(1)
    X = torch.randn(300, 777, generator=gen).to(torch.bfloat16)
    W = torch.randn(777, 10, generator=gen) * 0.1
    R = torch.randn(300, 10, generator=gen)
    m = SoftmaxRegression(777, 10)
    assert _rel(m.logits(W.cuda(), X.cuda()).cpu(), m.logits(W, X)) <= 1e-5
    assert _rel(m._backward(W.cuda(), (X.cuda(),), R.cuda()).cpu(), m._backward(W, (X,), R)) <= 1e-5


# --- the on-device generation probes (ops/gen_roofline.py) -------------------
def _roofline_calls(cuda, bt, dt, reps, seed=0):
    """kernel name -> (wrapper call, plain call) on the same inputs."""
    from distlr_tpu_torch.ops import gen_roofline as gr

    gen = torch.Generator(device=cuda).manual_seed(seed)
    s = torch.tensor([seed], dtype=torch.int32, device=cuda)
    w = torch.randn(1, dt, device=cuda, generator=gen) / dt ** 0.5
    y = (torch.rand(bt, 1, device=cuda, generator=gen) < 0.5).float()
    x = torch.randn(bt, dt, device=cuda, generator=gen)
    wm = torch.randn(dt, gr.MXU_N, device=cuda, generator=gen) / dt ** 0.5
    return {
        "gen": (lambda: ops.roofline_gen(s, bt=bt, dt=dt, reps=reps),
                lambda: gr.roofline_gen_reference(s, bt=bt, dt=dt, reps=reps)),
        "fwd": (lambda: ops.roofline_fwd(s, w, bt=bt, reps=reps),
                lambda: gr.roofline_fwd_reference(s, w, bt=bt, reps=reps)),
        "full": (lambda: ops.roofline_full(s, w, y, reps=reps),
                 lambda: gr.roofline_full_reference(s, w, y, reps=reps)),
        "hash": (lambda: ops.roofline_hash(w, bt=bt, reps=reps),
                 lambda: gr.roofline_hash_reference(w, bt=bt, reps=reps)),
        "const": (lambda: ops.roofline_const(x, w, reps=reps),
                  lambda: gr.roofline_const_reference(x, w, reps=reps)),
        "mxu": (lambda: ops.roofline_mxu(x, wm, reps=reps),
                lambda: gr.roofline_mxu_reference(x, wm, reps=reps)),
    }


@pytest.mark.parametrize("bt,dt,reps", [(64, 1024, 8), (256, 8192, 64)])
@pytest.mark.parametrize("name", ["gen", "fwd", "full", "hash", "const", "mxu"])
def test_roofline_kernel_matches_plain(cuda, name, bt, dt, reps):
    kern, plain = _roofline_calls(cuda, bt, dt, reps)[name]
    wrapper = getattr(ops, f"roofline_{name}")
    launches = wrapper.launches
    got = kern()
    torch.cuda.synchronize()
    assert wrapper.launches == launches + 1
    ref = plain()
    assert got.shape == ref.shape
    if name == "gen":
        # the same words summed as f32 in the same (ascending t) order
        assert torch.equal(got, ref)
    else:
        # f32 sums in different orders
        assert (got - ref).abs().max() <= 1e-3 * ref.abs().max()


def test_roofline_kernels_are_deterministic(cuda):
    for kern, _ in _roofline_calls(cuda, 64, 1024, 8).values():
        assert torch.equal(kern(), kern())


def test_mxu_reads_w_the_right_way_round(cuda):
    """Two row strips, eight depth slices, three passes, on random x and w
    that are not symmetric in any sense: a B read transposed, a misplaced
    swizzle unit or a slice summed twice moves the product far past the
    tolerance."""
    from distlr_tpu_torch.ops import gen_roofline as gr

    bt, dt, reps = 128, 2048, 3
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(bt, dt, device=cuda, generator=gen) + torch.arange(dt, device=cuda) / dt
    w = torch.randn(dt, gr.MXU_N, device=cuda, generator=gen) / dt ** 0.5
    got = ops.roofline_mxu(x, w, reps=reps)
    ref = gr.roofline_mxu_reference(x, w, reps=reps)
    # f32 sums in different orders
    assert (got - ref).abs().max() <= 1e-3 * ref.abs().max()
    # the same function with each 128-column block of w's slices transposed
    # differs from the product by the product's own size
    wt = w.view(dt // 128, 128, 128).transpose(1, 2).reshape(dt, 128)
    assert (gr.roofline_mxu_reference(x, wt, reps=reps) - ref).abs().max() > 0.1 * ref.abs().max()
    assert torch.equal(got, ops.roofline_mxu(x, w, reps=reps))


@pytest.mark.parametrize("bt,dt", [(64, 1024), (128, 2048), (256, 8192), (5, 384)])
@pytest.mark.parametrize("name", ["gen", "fwd", "full", "hash", "const", "mxu"])
def test_probe_plan_scratch_is_the_kernels(cuda, name, bt, dt):
    from distlr_tpu_torch.ops import gen_roofline as gr

    if name == "mxu" and (bt % 64 or dt % 256):
        pytest.skip("the mxu kernel does not take this tile")
    lib = gr._lib()
    assert lib.distlr_roofline_scratch_len(gr._KIND[name], bt, dt) == gr.probe_plan(name, bt, dt)["scratch"]


@pytest.mark.parametrize("name", ["gen", "fwd", "full", "hash", "const", "mxu"])
def test_probe_call_launches_its_planned_kernels(cuda, name):
    """torch.profiler's CUDA kernels of one call at the published tile:
    const is one launch, mxu the wgmma kernel and the slices' sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distlr_tpu_torch.ops import gen_roofline as gr

    kern, _ = _roofline_calls(cuda, gr.BT, gr.DT, gr.REPS)[name]
    kern()  # build and load first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kern()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    planned = gr.probe_plan(name)["kernels"]
    assert len(names) == len(planned), names
    assert all(p in n for p, n in zip(planned, names)), names


def test_roofline_shapes_the_kernels_refuse(cuda):
    w = torch.ones(1, 200, device=cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        ops.roofline_hash(w, bt=8, reps=1)
    with pytest.raises(ValueError, match="multiple of 64"):
        ops.roofline_mxu(torch.ones(8, 256, device=cuda), torch.ones(256, 128, device=cuda), reps=1)


# --- the scoring engine on the card ------------------------------------------


def _one_hot_rows(n, D, fields=39, seed=0):
    """``n`` host rows with one 1.0 in each of ``fields`` column ranges."""
    import numpy as np  # noqa: PLC0415

    rng = np.random.default_rng(seed)
    per = D // fields
    cols = rng.integers(0, per, size=(n, fields)) + np.arange(fields) * per
    X = np.zeros((n, D), np.float32)
    X[np.arange(n)[:, None], cols] = 1.0
    return X


def _serve_weights(D, seed=0):
    """Centred weights whose logits on :func:`_one_hot_rows` have a
    deviation of about 1.5 (no residual saturates)."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(D, generator=gen) * (1.5 / 39 ** 0.5)).numpy()


def test_engine_on_card_matches_plain_at_64_rows(cuda):
    from distlr_tpu_torch.serve import ScoringEngine  # noqa: PLC0415

    D = 1_000_000
    eng = ScoringEngine(Config(num_feature_dim=D, l2_c=0.0))
    assert eng.device.type == "cuda" and eng.product_dtype == torch.bfloat16
    w = _serve_weights(D)
    eng.set_weights(w)
    X = _one_hot_rows(40, D)
    before = _counts()
    labels, scores = eng.score((X,))
    after = _counts()
    # one streaming forward for the 64-row bucket, and nothing else
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {"lr_logits": 1}
    assert eng.stats()["bucket_hits"] == {64: 1}
    z = ops.lr_logits_reference(torch.from_numpy(w).to(cuda),
                                torch.from_numpy(X).to(cuda, torch.bfloat16)).cpu()
    assert (torch.from_numpy(scores) - torch.sigmoid(z)).abs().max() <= 1e-5
    clear = z.abs() > 1e-3
    assert torch.equal(torch.from_numpy(labels)[clear], (z > 0).to(torch.int32)[clear])


def test_engine_swap_under_concurrent_scoring(cuda):
    """Every batch scored while another thread swaps the weights scores on
    one of the two tables, bit for bit: no torn or freed table is read."""
    import threading  # noqa: PLC0415

    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.serve import ScoringEngine  # noqa: PLC0415

    D = 200_000
    eng = ScoringEngine(Config(num_feature_dim=D, l2_c=0.0))
    w1, w2 = _serve_weights(D, 1), _serve_weights(D, 2)
    X = _one_hot_rows(64, D, seed=3)
    expected = []
    for w in (w1, w2):
        eng.set_weights(w)
        expected.append(eng.score((X,))[1])
    assert not np.array_equal(*expected)
    stop, seen, errors = threading.Event(), [], []

    def scorer():
        try:
            while not stop.is_set():
                seen.append(eng.score((X,))[1])
        except Exception as e:  # surfaced below
            errors.append(e)

    import time  # noqa: PLC0415

    t = threading.Thread(target=scorer)
    t.start()
    # swap until the scorer has scored often enough, whatever its pace
    swaps, deadline = 0, time.monotonic() + 60
    while (swaps < 60 or len(seen) < 30) and not errors and time.monotonic() < deadline:
        eng.set_weights((w1, w2)[swaps % 2])
        swaps += 1
    stop.set()
    t.join(timeout=60)
    assert not t.is_alive() and not errors and len(seen) >= 30, (len(seen), errors)
    assert all(np.array_equal(s, expected[0]) or np.array_equal(s, expected[1]) for s in seen)


def test_engine_eviction_frees_the_device_table(cuda):
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.serve import ScoringEngine  # noqa: PLC0415

    D = 1_000_000
    eng = ScoringEngine(Config(num_feature_dim=D, l2_c=0.0), idle_evict_s=3600.0)
    eng.set_weights(_serve_weights(D))
    X = _one_hot_rows(8, D)
    first = eng.score((X,))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    assert eng.maybe_evict(now=1e12) and not eng.resident
    assert held - torch.cuda.memory_allocated() >= D * 4
    again = eng.score((X,))
    assert eng.resident
    assert np.array_equal(first[1], again[1]) and np.array_equal(first[0], again[0])


def test_router_over_two_replicas_on_card_matches_plain(cuda):
    """One ``ScoringRouter`` in front of two one-engine replicas at
    D = 4,096 on the card: every reply within 1e-5 of σ(plain logits), the
    traffic spread over both replicas, each request one ``lr_logits``."""
    import json  # noqa: PLC0415

    from distlr_tpu_torch.serve import (  # noqa: PLC0415
        ScoringEngine,
        ScoringRouter,
        ScoringServer,
        score_lines_over_tcp,
    )

    D = 4096
    w = _serve_weights(D, 4)
    X = _one_hot_rows(24, D, seed=5)
    lines = [" ".join(f"{c + 1}:1" for c in row.nonzero()[0]) for row in X]
    servers = []
    for _ in range(2):
        eng = ScoringEngine(Config(num_feature_dim=D, l2_c=0.0), max_batch_size=64)
        eng.set_weights(w)
        servers.append(ScoringServer(eng, max_wait_ms=0.5).start())
    before = _counts()
    try:
        with ScoringRouter(",".join(f"{s.host}:{s.port}" for s in servers), seed=0) as router:
            replies = score_lines_over_tcp(router.host, router.port, lines + ["STATS"])
    finally:
        for s in servers:
            s.stop()
    after = _counts()
    stats = json.loads(replies.pop())
    scores = torch.tensor([float(r.split()[1]) for r in replies], dtype=torch.float64)
    z = ops.lr_logits_reference(torch.from_numpy(w).to(cuda),
                                torch.from_numpy(X).to(cuda, torch.bfloat16)).cpu()
    assert (scores - torch.sigmoid(z.double())).abs().max() <= 1e-5
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "lr_logits": len(lines)}
    assert stats["requests"] == len(lines) and stats["errors"] == 0
    assert all(r["requests"] > 0 for r in stats["replicas"])


def test_labelled_request_on_card_journals_the_plain_score(cuda, tmp_path):
    """An ``ID`` request and its ``LABEL`` through a server with a feedback
    sink at D = 4,096 on the card: the journal holds the score of the plain
    forward (to its 6 digits), one ``lr_logits`` launched, and the joined
    shard holds the label and the request's features."""
    import json  # noqa: PLC0415

    from distlr_tpu_torch.feedback import FeedbackSink  # noqa: PLC0415
    from distlr_tpu_torch.serve import ScoringEngine, ScoringServer  # noqa: PLC0415

    D = 4096
    w = _serve_weights(D, 6)
    X = _one_hot_rows(1, D, seed=7)
    line = " ".join(f"{c + 1}:1" for c in X[0].nonzero()[0])
    eng = ScoringEngine(Config(num_feature_dim=D, l2_c=0.0), max_batch_size=64)
    eng.set_weights(w)
    sink = FeedbackSink(str(tmp_path / "spool"), str(tmp_path / "shards"), window_s=60.0)
    before = _counts()
    with ScoringServer(eng, max_wait_ms=0.5, feedback=sink) as srv:
        reply = srv.handle_line(f"ID q1 {line}")
        assert srv.handle_line("LABEL q1 1") == "OK joined"
    after = _counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {"lr_logits": 1}
    z = ops.lr_logits_reference(torch.from_numpy(w).to(cuda),
                                torch.from_numpy(X).to(cuda, torch.bfloat16)).cpu()
    want = float(torch.sigmoid(z.double())[0])
    with open(tmp_path / "spool" / "spool-000000.jsonl") as f:
        docs = [json.loads(ln) for ln in f]
    assert docs[0]["id"] == "q1" and docs[0]["line"] == line
    assert abs(docs[0]["score"] - round(want, 6)) <= 1e-5
    assert abs(float(reply.split()[1]) - want) <= 1e-5
    assert docs[1] == {"joined": "q1"}
    assert (tmp_path / "shards" / "shard-000000.libsvm").read_text() == f"1 {line}\n"


# --- the feature-sharded step (lr_backward, column blocks) ------------------
# aligned shapes, D not a multiple of 8, a block whose rows break 16-byte
# alignment (12 bf16 columns), a view at an odd offset; the step's blocks
# at S = 4 (one split) and S = 8 (two splits in a cluster), few rows at
# that width, one row, and B under the split count (3 splits of 1 row)
@pytest.mark.parametrize("B,D,offset", [(64, 4096, 0), (1024, 250_000, 0), (7, 1003, 0),
                                        (33, 12, 0), (16, 96, 5), (1024, 125_000, 0),
                                        (5, 250_000, 0), (5, 125_000, 0), (1, 250_000, 0),
                                        (3, 4096, 0)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_lr_backward_matches_plain(cuda, B, D, offset, x_dtype):
    gen = torch.Generator(device=cuda).manual_seed(B + D)
    if x_dtype == torch.int8:
        flat = torch.randint(-127, 128, (B * D + offset,), device=cuda, generator=gen,
                             dtype=torch.int8)
        kw = dict(feature_scale=3.0 / 127.0)
    else:
        flat = torch.randn(B * D + offset, device=cuda, generator=gen).to(x_dtype)
        kw = {}
    X = flat[offset:].view(B, D)
    r = torch.randn(B, device=cuda, generator=gen)
    for cd in ("bfloat16", "float32"):
        before = _counts()
        g = ops.lr_backward(X, r, compute_dtype=cd, **kw)
        torch.cuda.synchronize()
        after = _counts()
        name = "lr_backward_int8" if x_dtype == torch.int8 else "lr_backward"
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {name: 1}
        ref = ops.lr_backward_reference(X, r, compute_dtype=cd, **kw)
        assert _rel(g, ref) <= 1e-3
        assert torch.equal(g, ops.lr_backward(X, r, compute_dtype=cd, **kw))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_backward_plan_fits_the_cards_occupancy(cuda, x_dtype, compute_dtype):
    """The kernel library's plan is lr_backward_plan's on the runtime's SM
    count (backward_plan_for raises otherwise); the kernel fits the 2
    blocks an SM its launch bounds ask for, every split grid gives each
    block an SM of its own, its cluster is one the card schedules, and the
    full-width shapes take one split."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, D in [(1024, 250_000), (1024, 125_000), (5, 125_000), (1, 250_000), (3, 4096),
                 (37, 1003), (2048, 1_000_000), (64, 6_000_000)]:
        X = torch.empty((), dtype=x_dtype, device=cuda).expand(B, D)
        plan = ops.fused_lr.backward_plan_for(X, compute_dtype)
        assert plan["num_sms"] == sms and plan["blocks_per_sm"] >= 2
        assert plan["splits"] <= min(B, 8) and plan["blocks"] % plan["cluster"] == 0
        if plan["splits"] > 1:
            assert plan["clusters_resident"] >= 1 and plan["blocks"] <= sms
        else:
            assert plan["clusters_resident"] == 0
        if (B, D) == (1024, 125_000):
            assert plan["splits"] == 2
        if D >= 250_000:
            assert plan["splits"] == 1


def test_lr_logits_int8dot_takes_a_global_grid(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    X = torch.randint(-127, 128, (64, 4096), device=cuda, generator=gen, dtype=torch.int8)
    w = torch.randn(8192, device=cuda, generator=gen)
    amax = torch.amax(w.abs())
    z = ops.lr_logits_int8dot(w[:4096], X, w_amax=amax)
    ref = ops.lr_logits_int8dot_reference(w[:4096].cpu(), X.cpu(), w_amax=amax.cpu())
    assert _rel(z.cpu(), ref) <= 1e-6


@pytest.mark.parametrize("fd", ["float32", "bfloat16", "int8", "int8_dot"])
def test_feature_sharded_trainer_on_card_matches_cpu(cuda, fd):
    import numpy as np  # noqa: PLC0415

    rng = np.random.default_rng(1)
    X = rng.standard_normal((400, 48)).astype(np.float32)
    y = rng.integers(0, 2, 400).astype(np.int32)
    kw = dict(num_feature_dim=48, num_iteration=4, batch_size=64, num_workers=2,
              mesh_shape={"data": 2, "model": 4}, compute_dtype="float32", test_interval=0,
              feature_dtype=fd)
    data = lambda: GlobalShardedData([(X[:200], y[:200]), (X[200:], y[200:])])  # noqa: E731
    on_card = Trainer(Config(**kw)).load_data(train=data(), test=data())
    on_cpu = Trainer(Config(device="cpu", **kw)).load_data(train=data(), test=data())
    on_cpu.weights = on_cpu.init_weights().clone()
    on_card.weights = on_cpu.weights.to(cuda)
    ops.reset_launch_counts()
    w_card = on_card.fit()
    steps = 4 * 4  # epochs x steps
    counts = _counts()
    if fd == "int8_dot":
        assert counts["lr_logits_int8dot"] == counts["lr_backward_int8dot"] == steps * 2 * 4
    else:
        sfx = "_int8" if fd == "int8" else ""
        assert counts["lr_logits" + sfx] == counts["lr_backward" + sfx] == steps * 2 * 4
    assert counts["fused_lr_grad"] == counts["fused_lr_grad_int8"] == 0
    tol = 1e-4 if fd != "int8_dot" else 1e-3
    assert _rel(w_card.cpu(), on_cpu.fit()) <= tol
    got, want = on_card.evaluate_metrics(), on_cpu.evaluate_metrics()
    assert abs(got["accuracy"] - want["accuracy"]) <= 1 / 400


def test_int8_push_of_a_card_gradient_reads_back_its_codec_and_ratio(cuda):
    """A worker's gradient computed on the card (one ``fused_lr_grad``
    launch), read back and pushed int8-coded into a 2-server group: the
    worker reads back ``compress_active`` "int8", a byte ratio above 8,
    and the servers hold w minus the decoded gradient of each slice."""
    import numpy as np

    from distlr_tpu_torch.compress import int8_roundtrip
    from distlr_tpu_torch.models import get_model
    from distlr_tpu_torch.ps import KVWorker, ServerGroup

    B, D = 256, 100_000
    w, X, y, mask = _inputs(cuda, B, D, torch.bfloat16, seed=3)
    cfg = Config(num_feature_dim=D, l2_c=0.0)
    launches = ops.fused_lr_grad.launches
    g = get_model(cfg).grad(w, (X, y, mask), cfg).cpu().numpy()
    assert ops.fused_lr_grad.launches == launches + 1
    w0 = w.cpu().numpy()
    with ServerGroup(2, 1, D, sync=False, learning_rate=1.0) as sg, \
            KVWorker(sg.hosts, D, sync_group=False, compress="int8") as kv:
        assert kv.compress_active == "int8"
        kv.push_init(w0)
        kv.wait(kv.push(g))
        got = kv.pull()
        ratio = kv.compress_ratio
    assert ratio > 8.0
    decoded = np.concatenate([int8_roundtrip(g[:D // 2]), int8_roundtrip(g[D // 2:])])
    np.testing.assert_array_equal(got, (w0 - decoded).astype(np.float32))


def test_ps_sync_crash_and_resume_on_card_equals_the_uninterrupted_run(cuda, tmp_path,
                                                                       monkeypatch):
    """Sync PS at a small width on the card (2 workers x 2 servers, each
    gradient one ``fused_lr_grad`` launch): rank 0 raises after its
    epoch-2 checkpoint, the job resumes against the surviving group, and
    its weights equal an uninterrupted run's (the kernel is
    deterministic)."""
    import json
    import os

    from distlr_tpu_torch.data.synthetic import write_synthetic_shards
    from distlr_tpu_torch.ps import ServerGroup
    from distlr_tpu_torch.train import ps_trainer

    d = str(tmp_path / "data")
    write_synthetic_shards(d, 2048, 4096, num_parts=2, seed=9, sparsity=0.5)
    cfg = Config(data_dir=d, num_feature_dim=4096, num_workers=2, num_servers=2,
                 num_iteration=4, learning_rate=0.5, l2_c=0.0, batch_size=256,
                 test_interval=0, sync_mode=True, checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_interval=2, ps_timeout_ms=10_000)
    real = ps_trainer.PSWorker._checkpoint
    state = {"crashed": False}

    def crashing(self, ckpt, epoch):
        real(self, ckpt, epoch)
        if epoch == 2 and not state["crashed"]:
            state["crashed"] = True
            raise RuntimeError("injected crash after checkpoint")

    monkeypatch.setattr(ps_trainer.PSWorker, "_checkpoint", crashing)
    launches = ops.fused_lr_grad.launches
    with ServerGroup(2, 2, 4096, learning_rate=0.5, sync=True) as group:
        with pytest.raises(Exception):
            ps_trainer.run_ps_workers(cfg, group.hosts, range(2))
        assert state["crashed"]
        resumed = ps_trainer.run_ps_workers(cfg, group.hosts, range(2), resume=True)
    assert ops.fused_lr_grad.launches > launches
    with open(os.path.join(cfg.checkpoint_dir, "ps_latest.json")) as f:
        assert json.load(f) == {"epoch": 4, "attempt": 1}
    monkeypatch.undo()
    whole = ps_trainer.run_ps_local(cfg.replace(checkpoint_dir=None))
    assert _rel(torch.from_numpy(resumed[0]), torch.from_numpy(whole[0])) <= 1e-5


def test_wal_recovery_of_card_gradients_equals_the_pre_kill_pull(cuda, tmp_path):
    """Four pushes of gradients the card computed (one ``fused_lr_grad``
    launch each, at the weights just pulled) into a 2-server async group
    with a WAL; both servers SIGKILLed and the group restarted on its store:
    the pull equals the pre-kill pull bit for bit (the replay applies the
    same f32 updates in the same order)."""
    from distlr_tpu_torch.models import get_model
    from distlr_tpu_torch.ps import KVWorker, ServerGroup, store

    B, D = 256, 100_000
    w, X, y, mask = _inputs(cuda, B, D, torch.bfloat16, seed=5)
    cfg = Config(num_feature_dim=D, l2_c=0.01)
    model = get_model(cfg)
    root = str(tmp_path / "store")
    launches = ops.fused_lr_grad.launches
    with ServerGroup(2, 1, D, sync=False, store_dir=root, store_interval_s=60.0,
                     store_wal=True, store_wal_fsync_s=0.01) as g:
        with KVWorker(g.hosts, D, sync_group=False, timeout_ms=10_000) as kv:
            kv.push_init(w.cpu().numpy())
            for _ in range(4):
                w_now = torch.from_numpy(kv.pull()).to(cuda)
                kv.wait(kv.push(model.grad(w_now, (X, y, mask), cfg).cpu().numpy()))
            before = kv.pull()
            for p in g.procs:
                p.kill()
                p.wait()
    assert ops.fused_lr_grad.launches == launches + 4
    for r in range(2):
        assert store.scan_rank(f"{root}/rank-{r}").recovered_clock == 1 + 4
    with ServerGroup(2, 1, D, sync=False, store_dir=root, store_wal=True) as g:
        with KVWorker(g.hosts, D, sync_group=False, timeout_ms=10_000) as kv:
            after = kv.pull()
    assert after.tobytes() == before.tobytes()


def test_ftrl_reshard_of_card_gradients_equals_a_static_group(cuda):
    """Eight ``fused_lr_grad`` gradients made on the card pushed into a
    2-server async FTRL group, four before a live 2 -> 4 reshard (a full
    rebuild: weights and z/n move) and four after, a pull between: the
    pull equals a static 2-server group's after the same pushes bit for
    bit."""
    from distlr_tpu_torch.ps import KVWorker, MembershipCoordinator, ServerGroup

    B, D = 256, 100_000
    _, X, y, mask = _inputs(cuda, B, D, torch.bfloat16, seed=7)
    gen = torch.Generator(device=cuda).manual_seed(8)
    launches = ops.fused_lr_grad.launches
    grads = [ops.fused_lr_grad(torch.randn(D, generator=gen, device=cuda) * 0.01, X, y,
                               mask).cpu().numpy() for _ in range(8)]
    assert ops.fused_lr_grad.launches == launches + 8
    with ServerGroup(2, 1, D, sync=False, optimizer="ftrl") as g:
        coord = MembershipCoordinator(g)
        with KVWorker(None, D, sync_group=False, route=coord.layout) as kv:
            kv.push_init(torch.zeros(D).numpy())
            for gv in grads[:4]:
                kv.push(gv)
            before = kv.pull()
            stats = coord.resize(4)
            # an idempotent op re-routes: a push fenced by the resize would
            # be absorbed, never re-issued
            assert kv.pull().tobytes() == before.tobytes() and kv.reroutes == 1
            for gv in grads[4:]:
                kv.push(gv)
            elastic = kv.pull()
    assert (stats["reused"], stats["spawned"], stats["keys_moved"]) == (0, 4, D)
    with ServerGroup(2, 1, D, sync=False, optimizer="ftrl") as g:
        with KVWorker(g.hosts, D, sync_group=False) as kv:
            kv.push_init(torch.zeros(D).numpy())
            for gv in grads:
                kv.push(gv)
            static = kv.pull()
    assert elastic.tobytes() == static.tobytes()


def test_asan_group_of_card_gradients_equals_a_standard_group(cuda, tmp_path, monkeypatch):
    """``fused_lr_grad`` gradients made on the card at (512, 1M), pushed by
    two workers into a sync 2-server group built under
    ``DISTLR_NATIVE_VARIANT=asan`` and into a standard one: the pulls are
    equal bit for bit, the asan servers exit 0 and write no report."""
    import glob
    import threading

    from distlr_tpu_torch.ps import KVWorker, ServerGroup
    from distlr_tpu_torch.ps import build as ps_build

    B, D, rounds = 512, 1_000_000, 3
    shards = [_inputs(cuda, B, D, torch.bfloat16, seed=20 + r)[1:] for r in range(2)]
    w0 = (torch.randn(D, generator=torch.Generator().manual_seed(21)) * 0.01).numpy()
    log_base = str(tmp_path / "asan")

    def run(variant):
        if variant:
            monkeypatch.setenv("DISTLR_NATIVE_VARIANT", variant)
            monkeypatch.setenv("ASAN_OPTIONS", f"log_path={log_base} exitcode=66")
        else:
            monkeypatch.delenv("DISTLR_NATIVE_VARIANT", raising=False)
        final, errors = {}, []
        with ServerGroup(2, 2, D, sync=True, learning_rate=0.5) as group:
            assert group.binary == ps_build.server_binary(variant)

            def worker(rank):
                try:
                    X, y, mask = shards[rank]
                    with KVWorker(group.hosts, D, client_id=rank, timeout_ms=120_000) as kv:
                        if rank == 0:
                            kv.wait(kv.push_init(w0))
                        kv.barrier(0)
                        w = kv.pull()
                        for _ in range(rounds):
                            g = ops.fused_lr_grad(torch.from_numpy(w).to(cuda), X, y, mask) / B
                            w = kv.push_pull(g.cpu().numpy())
                        final[rank] = w
                        kv.barrier(1)
                        if rank == 0:
                            kv.shutdown_servers()
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                    group.stop()

            threads = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not errors, errors[0]
            group.wait()
            codes = [p.returncode for p in group.procs]
        return final, codes

    launches = ops.fused_lr_grad.launches
    asan, asan_codes = run("asan")
    assert ops.fused_lr_grad.launches == launches + 2 * rounds
    plain, _ = run("")
    assert asan_codes == [0, 0] and glob.glob(log_base + "*") == []
    assert asan[0].tobytes() == asan[1].tobytes() == plain[0].tobytes()


# --- observability on the card (the obs registry, torch.profiler) -----------
def test_device_bytes_gauge_reads_the_cards_allocator(cuda):
    from distlr_tpu_torch.obs import get_registry, torchrt  # noqa: PLC0415

    held = torch.zeros(1 << 20, device=cuda)  # 4 MiB on the card
    torch.cuda.synchronize()
    total = torchrt.sample_device_bytes()
    assert total == torch.cuda.memory_allocated() >= held.numel() * 4
    assert get_registry().get("distlr_jax_device_buffer_bytes").value == total
    live = get_registry().get("distlr_jax_live_buffers").value
    assert live == torch.cuda.memory_stats()["active.all.current"] >= 1


def test_profile_dir_trace_names_both_hand_kernels(cuda, tmp_path):
    """``Config.profile_dir`` on the card: the Chrome trace of ``fit``
    names the gradient's single pass and the eval's streaming forward."""
    import json  # noqa: PLC0415

    gen = torch.Generator().manual_seed(1)
    X = torch.randn(512, 4096, generator=gen).numpy()
    y = (torch.rand(512, generator=gen) < 0.5).to(torch.int32).numpy()
    data = lambda: GlobalShardedData([(X, y)])  # noqa: E731
    cfg = Config(num_feature_dim=4096, num_iteration=2, batch_size=-1, test_interval=1,
                 feature_dtype="bfloat16", compute_dtype="bfloat16",
                 profile_dir=str(tmp_path / "prof"))
    Trainer(cfg).load_data(train=data(), test=data()).fit(eval_fn=lambda *_: None)
    (trace,) = (tmp_path / "prof").glob("fit-*.pt.trace.json")
    names = " ".join(str(e.get("name")) for e in json.loads(trace.read_text())["traceEvents"])
    assert "lr_grad_single_pass_kernel" in names and "lr_logits_streaming_kernel" in names


def _pipeline_trainer(B=512, D=65_536, batches=3, epochs=2):
    """A bf16 trainer of ``batches`` batches of B rows at width D for
    ``epochs`` epochs, an eval each epoch; and the bytes of one batch."""
    from distlr_tpu_torch.train.trainer import _as_tensor  # noqa: PLC0415

    gen = torch.Generator().manual_seed(3)
    X = torch.rand(B * batches, D, generator=gen).numpy()
    y = (torch.rand(B * batches, generator=gen) < 0.5).to(torch.int32).numpy()
    data = lambda: GlobalShardedData([(X, y)])  # noqa: E731
    cfg = Config(num_feature_dim=D, num_iteration=epochs, batch_size=B, test_interval=1,
                 feature_dtype="bfloat16", compute_dtype="bfloat16")
    trainer = Trainer(cfg).load_data(train=data(), test=data())
    batch_bytes = sum(_as_tensor(a).nbytes for a in next(trainer._train_data.batches(B)))
    return trainer, batch_bytes


def _batch_events(events, name):
    return {(e["args"]["epoch"], e["args"]["batch"]): e for e in events if e["name"] == name}


def test_fit_traces_each_batchs_pin_copy_and_wait(cuda):
    """A short fit on the card: one ``pin`` and one ``h2d_copy`` a step,
    each of the batch's bytes; at most one ``copy_wait`` a step, inside
    its ``compute`` span; each copy ends before its step does."""
    from distlr_tpu_torch.obs import get_tracer  # noqa: PLC0415
    from distlr_tpu_torch.obs.tracing import COPY_STREAM_TID  # noqa: PLC0415

    trainer, batch_bytes = _pipeline_trainer()
    tracer = get_tracer()
    tracer.reset()
    trainer.fit(eval_fn=lambda *_: None)
    phases, events = tracer.breakdown(), tracer.chrome_trace()["traceEvents"]
    steps = 2 * 3
    assert phases["compute"]["count"] == phases["pin"]["count"] == steps
    assert phases["h2d_copy"]["count"] == steps
    assert phases["pin"]["bytes"] == phases["h2d_copy"]["bytes"] == steps * batch_bytes
    assert phases.get("copy_wait", {"count": 0})["count"] <= steps
    assert phases["epoch_fill"]["count"] == 2 and phases["test_h2d"]["count"] == 1
    computes = _batch_events(events, "compute")
    copies = _batch_events(events, "h2d_copy")
    assert set(copies) == set(computes) == set(_batch_events(events, "pin"))
    for key, copy in copies.items():
        step = computes[key]
        assert copy["tid"] == COPY_STREAM_TID and copy["dur"] > 0
        assert copy["ts"] + copy["dur"] <= step["ts"] + step["dur"] + 1e3  # µs; the clocks' error
    for key, wait in _batch_events(events, "copy_wait").items():
        step = computes[key]
        assert wait["ts"] == step["ts"] and wait["dur"] <= step["dur"]


def test_h2d_copy_spans_match_the_profilers_copies(cuda, tmp_path):
    """Each ``h2d_copy`` span, on the host's clock, covers its batch's
    pinned ``Memcpy HtoD`` copies (its leaves, in order) in a
    ``torch.profiler`` trace of the same fit: the profiler's clock set on
    the host's by the median offset, both ends within 200 µs."""
    import json  # noqa: PLC0415
    import statistics  # noqa: PLC0415

    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    from distlr_tpu_torch.obs import get_tracer  # noqa: PLC0415

    trainer, _ = _pipeline_trainer()
    leaves = len(next(trainer._train_data.batches(512)))
    tracer = get_tracer()
    tracer.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.fit(eval_fn=lambda *_: None)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    pinned = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
                     and "HtoD" in e["name"] and "Pinned" in e["name"]),
                    key=lambda e: float(e["ts"]))
    spans = sorted((e for e in tracer.chrome_trace()["traceEvents"] if e["name"] == "h2d_copy"),
                   key=lambda e: e["ts"])
    assert len(spans) == 6 and len(pinned) == leaves * len(spans)
    pairs = []
    for i, span in enumerate(spans):
        group = pinned[leaves * i:leaves * (i + 1)]
        start = float(group[0]["ts"])
        end = max(float(e["ts"]) + float(e["dur"]) for e in group)
        pairs.append((start - span["ts"], end - (span["ts"] + span["dur"])))
    offset = statistics.median(d for d, _ in pairs)
    assert all(abs(d0 - offset) <= 200 and abs(d1 - offset) <= 200 for d0, d1 in pairs), pairs


def test_metrics_scrape_during_a_serving_burst(cuda):
    """Scrapes of ``/metrics`` while eight clients score on the card: every
    scrape parses, and the listener's request series ends at the burst's
    count, equal to the server's STATS."""
    import json  # noqa: PLC0415
    import threading  # noqa: PLC0415
    import urllib.request  # noqa: PLC0415

    from distlr_tpu_torch.obs import get_registry, start_metrics_server  # noqa: PLC0415
    from distlr_tpu_torch.serve import (  # noqa: PLC0415
        ScoringEngine,
        ScoringServer,
        score_lines_over_tcp,
    )

    D = 100_000
    eng = ScoringEngine(Config(num_feature_dim=D, l2_c=0.0), _serve_weights(D))
    lines = [f"{i % D + 1}:1 {(7 * i) % D + 1}:1" for i in range(64)]
    with ScoringServer(eng, port=0) as srv, start_metrics_server(port=0) as ms:
        listener = f"{srv.host}:{srv.port}"
        fam = get_registry().get("distlr_serve_requests_total")
        base = fam.labels(listener=listener).value
        errors, scrapes = [], []

        def client():
            try:
                for _ in range(4):
                    score_lines_over_tcp(srv.host, srv.port, lines)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            text = urllib.request.urlopen(f"http://127.0.0.1:{ms.port}/metrics",
                                          timeout=10).read().decode()
            scrapes.append(text.count("\n"))
        for t in threads:
            t.join(60)
        doc = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{ms.port}/metrics.json",
                                                timeout=10).read())
        stats = srv.stats()
    assert not errors and scrapes
    assert fam.labels(listener=listener).value - base == 8 * 4 * 64 == stats["requests"]
    assert [s["value"] for s in doc["distlr_serve_requests_total"]["series"]
            if s["labels"] == {"listener": listener}] == [8 * 4 * 64]


def test_sampled_ps_step_on_card_equals_untraced(cuda, tmp_path):
    """A sync PS run on the card (2 workers x 2 servers, each gradient one
    ``fused_lr_grad``) with tracing armed at sample 1 and the servers
    journaling: the weights equal the untraced run's bit for bit, and every
    step is a ``train.step`` with its ``ps.push_pull`` and a server span
    under it."""
    import os

    from distlr_tpu_torch.data.synthetic import write_synthetic_shards
    from distlr_tpu_torch.obs import dtrace
    from distlr_tpu_torch.train import ps_trainer

    d, run = str(tmp_path / "data"), str(tmp_path / "run")
    write_synthetic_shards(d, 1024, 4096, num_parts=2, seed=9, sparsity=0.5)
    cfg = Config(data_dir=d, num_feature_dim=4096, num_workers=2, num_servers=2,
                 num_iteration=3, learning_rate=0.5, l2_c=0.0, batch_size=256,
                 test_interval=0, sync_mode=True, ps_timeout_ms=10_000)
    plain = ps_trainer.run_ps_local(cfg)
    launches = ops.fused_lr_grad.launches
    dtrace.configure(run, "ps", 0, sample=1.0)
    try:
        traced = ps_trainer.run_ps_local(cfg.replace(obs_run_dir=run, trace_sample=1.0))
        dtrace.flush()
    finally:
        dtrace.reset_for_tests()
    assert ops.fused_lr_grad.launches - launches == 2 * 3 * 2
    assert all(torch.equal(torch.from_numpy(a), torch.from_numpy(b))
               for a, b in zip(traced, plain))
    recs = [r for name in sorted(os.listdir(os.path.join(run, "spans")))
            for r in dtrace.read_journal(os.path.join(run, "spans", name))
            if r.get("type") == "span"]
    by_span = {r["span"]: r for r in recs}
    steps = [r for r in recs if r["name"] == "train.step"]
    assert len(steps) == 2 * 3 * 2
    kv = [r for r in recs if r["name"] == "kv.push_pull"]
    assert len(kv) == len(steps) * 2
    assert all(by_span[by_span[r["parent"]]["parent"]]["name"] == "train.step" for r in kv)


def test_traced_request_on_card_scores_as_untraced(cuda, tmp_path):
    """A served request at D = 4,096 on the card, through a router, with
    tracing armed at sample 1: its reply equals the untraced reply byte for
    byte, and the server's ``serve.infer`` span lies in the router's
    trace."""
    import os

    from distlr_tpu_torch.obs import dtrace
    from distlr_tpu_torch.serve import (  # noqa: PLC0415
        ScoringEngine,
        ScoringRouter,
        ScoringServer,
        score_lines_over_tcp,
    )

    D = 4096
    eng = ScoringEngine(Config(num_feature_dim=D, l2_c=0.0), _serve_weights(D, 4))
    lines = [" ".join(f"{c + 1}:1" for c in row.nonzero()[0])
             for row in _one_hot_rows(8, D, seed=3)]
    replies = []
    with ScoringServer(eng, max_wait_ms=0.5) as srv:
        for sample in (None, 1.0):
            if sample is not None:
                dtrace.configure(str(tmp_path), "tier", 0, sample=sample)
            try:
                with ScoringRouter(f"{srv.host}:{srv.port}", seed=0) as router:
                    replies.append(score_lines_over_tcp(router.host, router.port, lines))
                dtrace.flush()
            finally:
                dtrace.reset_for_tests()
    assert replies[0] == replies[1] and not any(r.startswith("ERR") for r in replies[0])
    recs = [r for r in dtrace.read_journal(os.path.join(tmp_path, "spans", "tier-0.jsonl"))
            if r.get("type") == "span"]
    routes = {r["trace"] for r in recs if r["name"] == "route.request"}
    infers = [r for r in recs if r["name"] == "serve.infer"]
    assert len(routes) == len(lines) and infers
    assert all(r["trace"] in routes for r in infers)
