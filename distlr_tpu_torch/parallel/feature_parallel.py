"""Feature-axis (model) sharding: the 2D ``data x model`` sync step.

Counterpart of ``distlr_tpu/parallel/feature_parallel.py``.  The
reference range-shards its key space over S server processes
(``GetServerKeyRanges``, reference ``src/main.cc:98-101``); the JAX step
shards the weight vector and the feature axis of every batch over a
mesh's ``model`` axis.  Here the S shards are S contiguous column blocks
of one card's tensors (:mod:`distlr_tpu_torch.parallel.mesh`), and each
data block i and column block j is one pair of kernel launches.  Per
step, for mesh axes (data = W, model = S):

* ``z_ij = X_ij · w_j`` — :func:`partial_logits`: ``ops.lr_logits`` (its
  int8 and int8_dot instances) for ``BinaryLR``;
* ``z_i = Σ_j z_ij`` in shard order — the logits need every column block
  before any residual exists, so the step reads X twice;
* ``r_i = (σ(z_i) − y_i)·mask_i`` — the residual from the summed logits;
* ``g_ij = r_iᵀ X_ij / n_i`` — :func:`resid_grad`: ``ops.lr_backward``
  (``lr_backward_int8dot`` for int8_dot);
* ``g = mean_i (g_i + L2)`` over the data axis (an ``all_reduce`` across
  processes), then the shard-local SGD update.

The JAX step runs XLA dots; here the Hopper kernels are the dense path of
``BinaryLR`` as everywhere else in the port.  Dense softmax keeps its
cuBLAS bf16 GEMMs a block, as ``SoftmaxRegression`` does.

Two departures from the JAX functions, neither in the result: an int8
X's ``feature_scale`` is applied once, inside the kernels (the JAX step
multiplies it in :func:`partial_logits` and after :func:`resid_grad`);
and ``BinaryLR``'s backward keeps the residual f32 where JAX rounds it to
``compute_dtype`` (bf16 parity is held at rel 1e-2, as for ``BinaryLR``).

**Layout.**  The weights stay one (D,) or (D, K) tensor; shard j is the
contiguous view ``w[j·D/S:(j+1)·D/S]``, so export, checkpoints and eval
take the tensor as it is (:func:`shard_weights` returns its argument).
The kernels need a contiguous X, and a column view of a (B, D) matrix is
not one, so a batch's X comes column-blocked, (S, rows, D/S):
``X[j, i·b:(i+1)·b]`` is a contiguous (b, D/S) block.
:func:`column_blocks` builds that layout in one host copy (the trainer
builds it in the copy each batch already costs: ``GlobalShardedData``).

Like the JAX step, this one ignores Q1 (``sync_last_gradient``): the
gradients always meet in a mean over ``data``.
"""

from __future__ import annotations

import torch

from distlr_tpu_torch import ops
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.models import BinaryLR, SoftmaxRegression
from distlr_tpu_torch.models.linear import logloss_terms
from distlr_tpu_torch.ops.int8 import int8_contract, mm_f32, quantize_sym
from distlr_tpu_torch.parallel.data_parallel import all_reduce_sum, eval_metrics
from distlr_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, num_data_shards

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_mesh(mesh: Mesh, num_features: int) -> None:
    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError("feature-sharded step needs a mesh with a 'model' axis")
    s = mesh.shape[MODEL_AXIS]
    if num_features % s != 0:
        raise ValueError(
            f"num_features={num_features} must be divisible by the model-axis "
            f"size {s} (pad the feature dimension)"
        )


def _per_sample_logloss(z, y, is_softmax: bool):
    """Per-row logloss from the summed logits (the models' ``row_loss``)."""
    if is_softmax:
        return -torch.log_softmax(z, dim=-1).gather(-1, y.long()[:, None])[:, 0]
    return logloss_terms(z, y)


def partial_logits(model, w_shard, X_shard, *, w_amax=None):
    """This column block's contribution to the logits, feature-scaled; the
    caller sums the blocks (in order, or over the ring).

    int8_dot quantizes the weight shard on the grid of ``w_amax``, the
    maximum |w| over every shard (the JAX step's ``lax.pmax``; default:
    the shard's own), so the weight side matches the unsharded int8_dot
    path bit for bit."""
    fs = model.feature_scale
    if isinstance(model, SoftmaxRegression):
        if model.int8_dot:
            wq, s_w = ops.int8dot_weight_grid(w_shard, w_amax)
            return int8_contract(X_shard, wq, 1) * (s_w * fs)
        cdt = _DTYPES[model.compute_dtype]
        z = mm_f32(X_shard.to(cdt), w_shard.to(cdt))
        return z * fs if fs != 1.0 else z
    if model.int8_dot:
        return ops.lr_logits_int8dot(w_shard, X_shard, feature_scale=fs, w_amax=w_amax)
    return ops.lr_logits(w_shard, X_shard, compute_dtype=model.compute_dtype, feature_scale=fs)


def resid_grad(model, resid, X_shard, n):
    """This column block's gradient term ``rᵀX_shard · feature_scale / n``,
    int8_dot-aware: ``resid`` (B,) gives (D/S,), (B, K) gives (D/S, K).

    The residuals are the same for every block (computed from the summed
    logits), so int8_dot's residual grid, ``max|r|`` over this data
    block, is the same for each; it is the JAX step's.  Unlike the JAX
    function, the feature scale is applied here: the kernels apply it."""
    fs = model.feature_scale
    if isinstance(model, SoftmaxRegression):
        if model.int8_dot:
            rq, s_r = quantize_sym(resid, resid.abs().max())
            return int8_contract(X_shard, rq, 0) * (s_r * fs) / n
        cdt = _DTYPES[model.compute_dtype]
        g = mm_f32(X_shard.to(cdt).t(), resid.to(cdt))
        return (g * fs if fs != 1.0 else g) / n
    if model.int8_dot:
        return ops.lr_backward_int8dot(X_shard, resid, feature_scale=fs) / n
    return ops.lr_backward(X_shard, resid, compute_dtype=model.compute_dtype,
                           feature_scale=fs) / n


def _dense_model(model) -> bool:
    return isinstance(model, (BinaryLR, SoftmaxRegression))


def _check_batch(X, y, s: int, shard_cols: int, local_blocks: int) -> int:
    """The rows of a data block of a column-blocked batch."""
    if X.dim() != 3 or X.shape[0] != s or X.shape[2] != shard_cols:
        raise ValueError(f"X must be column-blocked ({s}, rows, {shard_cols}) "
                         f"(shard_batch_2d), got {tuple(X.shape)}")
    rows = X.shape[1]
    if y.shape != (rows,) or rows % local_blocks:
        raise ValueError(f"a batch of {rows} rows (y {tuple(y.shape)}) does not split into "
                         f"{local_blocks} row blocks")
    return rows // local_blocks


def _shards(w, s: int):
    d = w.shape[0] // s
    return [w[j * d:(j + 1) * d] for j in range(s)]


def _w_amax(model, w):
    return torch.amax(w.abs()) if model.int8_dot else None


def model_axis_sum(parts):
    """The column blocks' terms summed in shard order (the JAX step's
    ``psum`` over ``model``)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def make_feature_sharded_train_step(model, cfg: Config, mesh: Mesh, *,
                                    with_metrics: bool = True, model_sum=model_axis_sum):
    """The 2D-parallel sync step: ``step(w, (X, y, mask)) -> (w, metrics)``.

    ``w`` is the whole (D,) or (D, K) tensor, updated in place (the JAX
    step donates it); ``X`` is column-blocked (S, rows, D/S) and holds,
    with ``y`` and ``mask``, this process's row blocks (:func:`shard_batch_2d`).
    ``model_sum`` sums the S column blocks' partial logits and |w_j|²
    (a list of S tensors -> their sum; the ring step passes its ring
    allreduce).  ``metrics``: the mean per-block ``loss`` (L2 term over
    every shard included) at the pre-update ``w``, and the applied
    gradient's ``grad_norm``."""
    if not _dense_model(model):
        raise TypeError(f"feature sharding supports dense models, got {type(model).__name__}")
    _check_mesh(mesh, model.num_features)
    is_softmax = isinstance(model, SoftmaxRegression)
    s = mesh.shape[MODEL_AXIS]
    local, num_shards = mesh.local_data_shards, num_data_shards(mesh)

    def step(w, batch):
        X, y, mask = batch
        b = _check_batch(X, y, s, model.num_features // s, local)
        w_shards = _shards(w, s)
        w_amax = _w_amax(model, w)
        wsq = model_sum([torch.sum(wj * wj) for wj in w_shards])
        g_sum, loss_sum = None, None
        for i in range(local):
            rows = slice(i * b, (i + 1) * b)
            y_i, m_i = y[rows], mask[rows].to(torch.float32)
            n = torch.clamp(m_i.sum(), min=1.0)
            z = model_sum([partial_logits(model, w_shards[j], X[j, rows], w_amax=w_amax)
                           for j in range(s)])
            resid = model.residual(z, y_i, m_i)
            g = torch.cat([resid_grad(model, resid, X[j, rows], n) for j in range(s)])
            # L2 on each shard (the gradient of 0.5·C·|w|² is shard-local)
            l2 = cfg.l2_c * w
            g = g + (l2 / n if cfg.l2_scale_by_batch else l2)
            g_sum = g if g_sum is None else g_sum + g
            if with_metrics:
                reg = 0.5 * cfg.l2_c * wsq
                loss = (torch.sum(_per_sample_logloss(z, y_i, is_softmax) * m_i) / n
                        + (reg / n if cfg.l2_scale_by_batch else reg))
                loss_sum = loss if loss_sum is None else loss_sum + loss
        if with_metrics:
            g_sum, loss_sum = all_reduce_sum(mesh, g_sum, loss_sum)
        else:
            (g_sum,) = all_reduce_sum(mesh, g_sum)
        g = g_sum / num_shards
        metrics = {}
        if with_metrics:
            metrics = {"loss": loss_sum / num_shards,
                       "grad_norm": torch.sqrt(sum(torch.sum(gj * gj) for gj in _shards(g, s)))}
        w.sub_(cfg.learning_rate * g)
        return w, metrics

    return step


def make_feature_sharded_eval_step(model, mesh: Mesh):
    """Global masked eval (``{"accuracy", "logloss"}``, as
    :func:`~distlr_tpu_torch.parallel.make_eval_step`) of column-blocked
    batches: each column block's logits over every row of the batch, one
    launch a block, summed in shard order."""
    if not _dense_model(model):
        raise TypeError(f"feature sharding supports dense models, got {type(model).__name__}")
    _check_mesh(mesh, model.num_features)
    is_softmax = isinstance(model, SoftmaxRegression)
    s = mesh.shape[MODEL_AXIS]

    def evaluate(w, batch):
        X, y, mask = batch
        _check_batch(X, y, s, model.num_features // s, 1)
        w_amax = _w_amax(model, w)
        z = model_axis_sum([partial_logits(model, wj, X[j], w_amax=w_amax)
                            for j, wj in enumerate(_shards(w, s))])
        m = mask.to(torch.float32)
        correct = torch.sum((model.predict_from_logits(z) == y).to(torch.float32) * m)
        ll_sum = torch.sum(_per_sample_logloss(z, y, is_softmax) * m)
        return eval_metrics(mesh, correct, ll_sum, m.sum())

    return evaluate


def column_blocks(X, num_blocks: int, *, pad_rows: int | None = None,
                  pin_memory: bool = False) -> torch.Tensor:
    """X (numpy or torch) in the column-blocked layout, in one copy: a
    (rows, D) matrix becomes (S, rows, D/S); a (W, bw, D) stack of W row
    blocks becomes (S, W·b, D/S) with each block's rows padded with zeros
    to ``pad_rows`` = b (default bw).  ``pin_memory`` allocates the result
    in page-locked memory, ready for an asynchronous copy to the card."""
    t = X if isinstance(X, torch.Tensor) else torch.from_numpy(X)
    if t.dim() == 2:
        t = t[None]
    W, bw, D = t.shape
    if D % num_blocks:
        raise ValueError(f"{D} columns do not split into {num_blocks} column blocks "
                         "(pad the feature dimension)")
    b = bw if pad_rows is None else pad_rows
    d = D // num_blocks
    make = torch.zeros if b > bw else torch.empty
    out = make((num_blocks, W * b, d), dtype=t.dtype, pin_memory=pin_memory)
    out.view(num_blocks, W, b, d)[:, :, :bw].copy_(t.unflatten(-1, (num_blocks, d))
                                                   .permute(2, 0, 1, 3))
    return out


def shard_batch_2d(batch, mesh: Mesh, device="cuda"):
    """``(X, y, mask)`` on ``device`` with X column-blocked over the mesh's
    ``model`` axis: a (rows, D) X is relaid out (:func:`column_blocks`), an
    (S, rows, D/S) one is taken as it is."""
    X, y, mask = batch
    s = mesh.shape[MODEL_AXIS]
    X = torch.as_tensor(X) if X.ndim == 3 else column_blocks(X, s)
    if X.shape[0] != s:
        raise ValueError(f"a column-blocked X has {s} blocks on its first axis, "
                         f"got {tuple(X.shape)}")
    return tuple(torch.as_tensor(a).to(device) for a in (X, y, mask))


def shard_weights(w, mesh: Mesh):
    """The weights as they are: shard j of the model axis is the contiguous
    view ``w[j·D/S:(j+1)·D/S]`` of the one tensor, which the steps take
    themselves (the JAX function places the shards on the devices)."""
    _check_mesh(mesh, w.shape[0])
    return w
