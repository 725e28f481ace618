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
    gen = torch.Generator(device=cuda).manual_seed(seed)
    X = torch.randn(B, D, device=cuda, generator=gen).to(x_dtype)
    w = torch.randn(D, device=cuda, generator=gen) / D ** 0.5
    y = (torch.rand(B, device=cuda, generator=gen) < 0.5).to(torch.int32)
    mask = torch.ones(B, device=cuda)
    mask[-(B // 5):] = 0
    return w, X, y, mask


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


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


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


def test_roofline_shapes_the_kernels_refuse(cuda):
    w = torch.ones(1, 200, device=cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        ops.roofline_hash(w, bt=8, reps=1)
    with pytest.raises(ValueError, match="multiple of 64"):
        ops.roofline_mxu(torch.ones(8, 256, device=cuda), torch.ones(256, 128, device=cuda), reps=1)
