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
