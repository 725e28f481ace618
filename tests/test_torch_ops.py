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
        assert ops.fused_lr_grad.launches == 0
        assert ops.lr_logits.launches == 0


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
