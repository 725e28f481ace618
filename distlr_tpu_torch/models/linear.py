"""Dense binary logistic regression on PyTorch tensors.

Counterpart of ``distlr_tpu/models/linear.py::BinaryLR``: a frozen class
whose methods are functions of the weight tensor and a batch
``(X, y, mask)`` (``mask`` flags real rows; padded rows are 0).  The
gradient is closed-form — the reference's formula
``(σ(Xw) − y)ᵀX / n + C·w[/n]`` (``src/lr.cc:38-40``, quirk Q4) — so no
autograd is involved.

The dense products go through the Hopper kernels of
:mod:`distlr_tpu_torch.ops` on CUDA tensors (their plain versions on CPU
tensors): the gradient is one ``fused_lr_grad`` call and the logits one
``lr_logits`` call, both f32 for a bf16 X without an f32 copy of X.
"""

from __future__ import annotations

import dataclasses

import torch

from distlr_tpu_torch.config import Config
from distlr_tpu_torch.ops import fused_lr_grad, lr_logits
from distlr_tpu_torch.utils.reference_rng import reference_init_weights


def _batch_count(mask) -> torch.Tensor:
    """``n = max(sum(mask), 1)`` as f32: an all-padding batch divides by 1."""
    return torch.clamp(mask.to(torch.float32).sum(), min=1.0)


def _masked_mean(values, mask):
    return (values * mask.to(torch.float32)).sum() / _batch_count(mask)


def _l2_grad(w, cfg: Config, batch_n):
    # Q4 gate: reference divides the L2 term by the batch size
    # (src/lr.cc:40); "correct" applies C*w un-scaled.
    term = cfg.l2_c * w
    return term / batch_n if cfg.l2_scale_by_batch else term


def _l2_loss(w, cfg: Config, mask):
    reg = 0.5 * cfg.l2_c * torch.sum(w * w)
    return reg / _batch_count(mask) if cfg.l2_scale_by_batch else reg


def logloss_terms(z, y):
    """Per-row logloss from logits: log(1 + e^z) - y*z, via logaddexp for
    stability (``jax.nn.softplus`` in the JAX model)."""
    return torch.logaddexp(z, torch.zeros_like(z)) - y.to(torch.float32) * z


@dataclasses.dataclass(frozen=True)
class BinaryLR:
    """Dense binary logistic regression: params = w of shape (D,), f32."""

    num_features: int
    # Product dtype; sums are always f32.  "float32" for parity runs.
    compute_dtype: str = "bfloat16"

    @property
    def param_shape(self) -> tuple[int, ...]:
        return (self.num_features,)

    def init(self, cfg: Config, device="cpu") -> torch.Tensor:
        if cfg.reference_rng_init:
            # Q2 parity: srand(0); rand()/RAND_MAX per weight (lr.h:10).
            w = torch.from_numpy(reference_init_weights(self.num_features, 0))
        else:
            gen = torch.Generator().manual_seed(cfg.random_seed)
            w = torch.rand(self.num_features, generator=gen, dtype=torch.float32)
        return w.to(device)

    def logits(self, w, X):
        return lr_logits(w, X, compute_dtype=self.compute_dtype)

    def loss(self, w, batch, cfg: Config):
        X, y, mask = batch
        return self._loss_from_logits(w, self.logits(w, X), y, mask, cfg)

    def _loss_from_logits(self, w, z, y, mask, cfg: Config):
        return _masked_mean(logloss_terms(z, y), mask) + _l2_loss(w, cfg, mask)

    def grad(self, w, batch, cfg: Config):
        X, y, mask = batch
        n = _batch_count(mask)
        g = fused_lr_grad(w, X, y, mask, compute_dtype=self.compute_dtype)
        return g / n + _l2_grad(w, cfg, n)

    def value_and_grad(self, w, batch, cfg: Config):
        """``(loss, grad)`` from one kernel call: the loss reuses the
        forward's logits, so X is not read a third time."""
        X, y, mask = batch
        g, z = fused_lr_grad(w, X, y, mask, compute_dtype=self.compute_dtype,
                             with_logits=True)
        n = _batch_count(mask)
        return self._loss_from_logits(w, z, y, mask, cfg), g / n + _l2_grad(w, cfg, n)

    def predict(self, w, X):
        # Reference decision rule: z > 0 (src/lr.cc:100-106).
        return (self.logits(w, X) > 0).to(torch.int32)

    def proba(self, w, X):
        """P(y=1) per row."""
        return torch.sigmoid(self.logits(w, X))

    def accuracy(self, w, batch):
        X, y, mask = batch
        correct = (self.predict(w, X) == y).to(torch.float32)
        return _masked_mean(correct, mask)

    def logloss(self, w, batch):
        """Mean test logloss WITHOUT the L2 term (the parity metric)."""
        X, y, mask = batch
        return _masked_mean(logloss_terms(self.logits(w, X), y), mask)


def get_model(cfg: Config) -> BinaryLR:
    if cfg.model == "binary_lr":
        return BinaryLR(cfg.num_feature_dim, compute_dtype=cfg.compute_dtype)
    raise NotImplementedError(f"model {cfg.model!r} is not ported (see Config)")
