"""The linear model families on PyTorch tensors.

Counterpart of ``distlr_tpu/models/linear.py``: frozen classes whose
methods are functions of the parameter tensor and a batch
``(*inputs, y, mask)`` (``mask`` flags real rows; padded rows are 0).
Gradients are closed-form — the reference's formula
``(σ(Xw) − y)ᵀX / n + C·w[/n]`` (``src/lr.cc:38-40``, quirk Q4) and its
softmax twin — so no autograd is involved.

- ``BinaryLR``: dense X; its products go through the Hopper kernels of
  :mod:`distlr_tpu_torch.ops` on CUDA tensors (their plain versions on
  CPU tensors): the gradient is one ``fused_lr_grad`` call and the logits
  one ``lr_logits`` call, both f32 for a bf16 X without an f32 copy of X.
  An int8 X (``feature_dtype="int8"``) goes through the same two calls,
  which launch the kernels' int8 instances with the dataset's
  ``feature_scale``; ``int8_dot`` takes the int8 x int8 pair.
- ``SoftmaxRegression``: dense X, params (D, K); both products are one
  GEMM each with f32 sums and an f32 result, from operands rounded to
  ``compute_dtype`` — as the JAX model's ``jnp.dot(...,
  preferred_element_type=f32)``, which rounds the residual too.  With
  ``int8_dot`` both are chunked int8 GEMMs (``torch._int_mm``), as the JAX
  model's ``_int8_contract`` runs XLA dots and no kernel of its own.

``feature_scale`` and ``int8_dot`` follow ``distlr_tpu/models/linear.py``:
the scale multiplies z before the sigmoid and multiplies g; int8_dot
quantizes w over its whole extent and the residual over the batch
(:func:`quantize_sym`) and folds ``s_w · feature_scale`` into z and
``s_r · feature_scale`` into g before the division by n.
- ``SparseBinaryLR`` / ``SparseSoftmaxRegression``: padded-COO
  ``(cols, vals)``; a gather forward and an ``index_add_`` gradient (the
  JAX ``segment_sum``).
- ``BlockedSparseLR``: row-blocked ``(blocks, lane_vals)``; R-wide row
  gathers and an ``index_add_`` of R-wide rows.

On the card ``index_add_`` adds in no fixed order, so the sparse
gradients are not bit-stable between calls: hold them at a tolerance.
"""

from __future__ import annotations

import dataclasses

import torch

from distlr_tpu_torch.config import Config
from distlr_tpu_torch.ops import fused_lr_grad, fused_lr_grad_int8dot, lr_logits, lr_logits_int8dot
from distlr_tpu_torch.ops.int8 import quantize_sym
from distlr_tpu_torch.ops.int8 import int8_contract as _int8_contract
from distlr_tpu_torch.ops.int8 import mm_f32 as _mm_f32
from distlr_tpu_torch.utils.reference_rng import reference_init_weights

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def _uniform_or_reference(shape, cfg: Config) -> torch.Tensor:
    """The dense models' init: Q2's glibc ``srand(0)`` ``rand()/RAND_MAX``
    per weight (``lr.h:10``), else a seeded uniform [0, 1)."""
    n = 1
    for d in shape:
        n *= d
    if cfg.reference_rng_init:
        return torch.from_numpy(reference_init_weights(n, 0).reshape(shape))
    gen = torch.Generator().manual_seed(cfg.random_seed)
    return torch.rand(shape, generator=gen, dtype=torch.float32)


def _zeros_or_reference(shape, cfg: Config) -> torch.Tensor:
    """The sparse models' init: zeros, or Q2's reference weights.  A
    positive-mean init would bias every logit by ~F/2, and at CTR scale
    SGD touches each weight too rarely to unwind that."""
    if cfg.reference_rng_init:
        return _uniform_or_reference(shape, cfg)
    return torch.zeros(shape, dtype=torch.float32)


class _BinaryHead:
    """Labels in {0, 1}: sigmoid residual, decision ``z > 0``
    (``src/lr.cc:100-106``)."""

    def row_loss(self, z, y):
        return logloss_terms(z, y)

    def residual(self, z, y, mask):
        return (torch.sigmoid(z) - y.to(torch.float32)) * mask.to(torch.float32)

    def predict_from_logits(self, z):
        return (z > 0).to(torch.int32)

    def proba_from_logits(self, z):
        """P(y=1) per row."""
        return torch.sigmoid(z)


class _SoftmaxHead:
    """Labels in {0..K-1}: softmax residual ``p − onehot(y)``, decision
    argmax (the first of tied classes, as ``jnp.argmax``: a zero W
    predicts class 0)."""

    num_classes: int

    def row_loss(self, z, y):
        return -torch.log_softmax(z, dim=-1).gather(-1, y.long()[:, None])[:, 0]

    def residual(self, z, y, mask):
        onehot = torch.nn.functional.one_hot(y.long(), self.num_classes).to(torch.float32)
        return (torch.softmax(z, dim=-1) - onehot) * mask.to(torch.float32)[:, None]

    def predict_from_logits(self, z):
        return torch.argmax(z, dim=-1).to(torch.int32)

    def proba_from_logits(self, z):
        """(B, K) class probabilities."""
        return torch.softmax(z, dim=-1)


class _LinearModel:
    """The surface every family shares, from its ``logits(params,
    *inputs)``, its head and ``_backward(params, inputs, resid)`` (the
    gradient of the summed loss, before the division by n)."""

    def loss(self, w, batch, cfg: Config):
        *inputs, y, mask = batch
        return _masked_mean(self.row_loss(self.logits(w, *inputs), y), mask) + _l2_loss(w, cfg, mask)

    def grad(self, w, batch, cfg: Config):
        return self.value_and_grad(w, batch, cfg)[1]

    def value_and_grad(self, w, batch, cfg: Config):
        """``(loss, grad)`` from one forward."""
        *inputs, y, mask = batch
        z = self.logits(w, *inputs)
        n = _batch_count(mask)
        g = self._backward(w, inputs, self.residual(z, y, mask))
        loss = _masked_mean(self.row_loss(z, y), mask) + _l2_loss(w, cfg, mask)
        return loss, g / n + _l2_grad(w, cfg, n)

    def predict(self, w, *inputs):
        return self.predict_from_logits(self.logits(w, *inputs))

    def proba(self, w, *inputs):
        return self.proba_from_logits(self.logits(w, *inputs))

    def accuracy(self, w, batch):
        *inputs, y, mask = batch
        correct = (self.predict(w, *inputs) == y).to(torch.float32)
        return _masked_mean(correct, mask)

    def logloss(self, w, batch):
        """Mean test logloss WITHOUT the L2 term (the parity metric)."""
        *inputs, y, mask = batch
        return _masked_mean(self.row_loss(self.logits(w, *inputs), y), mask)


@dataclasses.dataclass(frozen=True)
class BinaryLR(_BinaryHead, _LinearModel):
    """Dense binary logistic regression: params = w of shape (D,), f32."""

    num_features: int
    # Product dtype; sums are always f32.  "float32" for parity runs.
    compute_dtype: str = "bfloat16"
    # Dequantization scale of an int8 X (feature_dtype int8 / int8_dot):
    # X holds round(X_real / scale), and z and g are multiplied by it.
    feature_scale: float = 1.0
    # feature_dtype="int8_dot": w and the residual are quantized to int8 per
    # step and both products are int8 x int8 (X must be int8).
    int8_dot: bool = False

    @property
    def param_shape(self) -> tuple[int, ...]:
        return (self.num_features,)

    def init(self, cfg: Config, device="cpu") -> torch.Tensor:
        return _uniform_or_reference(self.param_shape, cfg).to(device)

    def logits(self, w, X):
        if self.int8_dot:
            return lr_logits_int8dot(w, X, feature_scale=self.feature_scale)
        return lr_logits(w, X, compute_dtype=self.compute_dtype, feature_scale=self.feature_scale)

    def _grad_sum(self, w, X, y, mask, with_logits=False):
        """The unnormalized gradient (and the logits) from one kernel call
        (int8_dot: the forward and the backward kernel)."""
        if self.int8_dot:
            return fused_lr_grad_int8dot(w, X, y, mask, feature_scale=self.feature_scale,
                                         with_logits=with_logits)
        return fused_lr_grad(w, X, y, mask, compute_dtype=self.compute_dtype,
                             feature_scale=self.feature_scale, with_logits=with_logits)

    def grad(self, w, batch, cfg: Config):
        X, y, mask = batch
        n = _batch_count(mask)
        g = self._grad_sum(w, X, y, mask)
        return g / n + _l2_grad(w, cfg, n)

    def value_and_grad(self, w, batch, cfg: Config):
        """``(loss, grad)`` from one kernel call: the loss reuses the
        forward's logits, so X is not read a third time."""
        X, y, mask = batch
        g, z = self._grad_sum(w, X, y, mask, with_logits=True)
        n = _batch_count(mask)
        loss = _masked_mean(self.row_loss(z, y), mask) + _l2_loss(w, cfg, mask)
        return loss, g / n + _l2_grad(w, cfg, n)


@dataclasses.dataclass(frozen=True)
class SoftmaxRegression(_SoftmaxHead, _LinearModel):
    """Multinomial softmax regression: params = W of shape (D, K), f32."""

    num_features: int
    num_classes: int
    compute_dtype: str = "bfloat16"
    feature_scale: float = 1.0  # see BinaryLR.feature_scale
    int8_dot: bool = False      # see BinaryLR.int8_dot: W (D, K) on one grid

    @property
    def param_shape(self) -> tuple[int, ...]:
        return (self.num_features, self.num_classes)

    def init(self, cfg: Config, device="cpu") -> torch.Tensor:
        return _uniform_or_reference(self.param_shape, cfg).to(device)

    def logits(self, W, X):
        if self.int8_dot:
            Wq, s_w = quantize_sym(W, W.abs().max())
            return _int8_contract(X, Wq, 1) * (s_w * self.feature_scale)
        cdt = _DTYPES[self.compute_dtype]
        z = _mm_f32(X.to(cdt), W.to(cdt))
        return z * self.feature_scale if self.feature_scale != 1.0 else z

    def _backward(self, W, inputs, resid):
        (X,) = inputs
        if self.int8_dot:
            rq, s_r = quantize_sym(resid, resid.abs().max())
            return _int8_contract(X, rq, 0) * (s_r * self.feature_scale)
        cdt = _DTYPES[self.compute_dtype]
        g = _mm_f32(X.to(cdt).t(), resid.to(cdt))
        return g * self.feature_scale if self.feature_scale != 1.0 else g


@dataclasses.dataclass(frozen=True)
class SparseBinaryLR(_BinaryHead, _LinearModel):
    """Binary LR over padded-COO batches ``(cols, vals, y, mask)``:
    ``cols`` / ``vals`` are (B, NNZ_MAX), pad col 0 and pad val 0."""

    num_features: int

    @property
    def param_shape(self) -> tuple[int, ...]:
        return (self.num_features,)

    def init(self, cfg: Config, device="cpu") -> torch.Tensor:
        return _zeros_or_reference(self.param_shape, cfg).to(device)

    def logits(self, w, cols, vals):
        return torch.sum(w[cols] * vals, dim=-1)

    def _backward(self, w, inputs, resid):
        cols, vals = inputs
        contrib = (resid[:, None] * vals).reshape(-1)
        return torch.zeros_like(w).index_add_(0, cols.reshape(-1), contrib)


@dataclasses.dataclass(frozen=True)
class SparseSoftmaxRegression(_SoftmaxHead, _LinearModel):
    """Multinomial softmax over padded-COO batches: params W (D, K); each
    active feature gathers one K-wide row of W."""

    num_features: int
    num_classes: int

    @property
    def param_shape(self) -> tuple[int, ...]:
        return (self.num_features, self.num_classes)

    def init(self, cfg: Config, device="cpu") -> torch.Tensor:
        return _zeros_or_reference(self.param_shape, cfg).to(device)

    def logits(self, W, cols, vals):
        return torch.sum(W[cols] * vals[..., None], dim=-2)

    def _backward(self, W, inputs, resid):
        cols, vals = inputs
        contrib = (vals[..., None] * resid[:, None, :]).reshape(-1, self.num_classes)
        return torch.zeros_like(W).index_add_(0, cols.reshape(-1), contrib)


@dataclasses.dataclass(frozen=True)
class BlockedSparseLR(_BinaryHead, _LinearModel):
    """Binary LR over row-blocked batches ``(blocks (B, G), lane_vals
    (B, G, R), y, mask)``: params are a (num_blocks, R) table and each
    sample gathers G R-wide rows (:func:`distlr_tpu_torch.data.hashing.
    hash_group_blocks`)."""

    num_blocks: int
    block_size: int = 8

    @property
    def param_shape(self) -> tuple[int, ...]:
        return (self.num_blocks, self.block_size)

    def init(self, cfg: Config, device="cpu") -> torch.Tensor:
        # untrained rows (unseen conjunctions) contribute nothing
        return torch.zeros(self.param_shape, dtype=torch.float32, device=device)

    def logits(self, t, blocks, lane_vals):
        return torch.sum(t[blocks] * lane_vals, dim=(-1, -2))

    def _backward(self, t, inputs, resid):
        blocks, lane_vals = inputs
        contrib = (resid[:, None, None] * lane_vals).reshape(-1, self.block_size)
        return torch.zeros_like(t).index_add_(0, blocks.reshape(-1), contrib)


def get_model(cfg: Config):
    int8_dot = cfg.feature_dtype == "int8_dot"
    if cfg.model == "binary_lr":
        return BinaryLR(cfg.num_feature_dim, compute_dtype=cfg.compute_dtype, int8_dot=int8_dot)
    if cfg.model == "softmax":
        return SoftmaxRegression(cfg.num_feature_dim, cfg.num_classes,
                                 compute_dtype=cfg.compute_dtype, int8_dot=int8_dot)
    if cfg.model == "sparse_lr":
        return SparseBinaryLR(cfg.num_feature_dim)
    if cfg.model == "sparse_softmax":
        return SparseSoftmaxRegression(cfg.num_feature_dim, cfg.num_classes)
    if cfg.model == "blocked_lr":
        if cfg.block_size == 0:
            raise ValueError(
                "block_size=0 (auto) must be resolved before building a "
                "model — see data.hashing.resolve_auto_block_size (the "
                "launch CLI does this for --block-size auto)")
        if cfg.num_feature_dim % cfg.block_size:
            raise ValueError(
                f"num_feature_dim ({cfg.num_feature_dim}) must be a multiple "
                f"of block_size ({cfg.block_size}) for blocked_lr")
        return BlockedSparseLR(cfg.num_feature_dim // cfg.block_size, cfg.block_size)
    raise ValueError(f"unknown model {cfg.model!r}")
