"""Synchronous data-parallel step on one card.

Counterpart of ``distlr_tpu/parallel/data_parallel.py``.  There the W
reference workers are the ``data`` axis of a mesh and their gradients
meet in a ``pmean``.  Here the W shards are W contiguous row blocks of
the global batch — the layout :class:`GlobalShardedData` builds, worker
i's rows at block i — and the step takes the gradient of each block,
then their mean.  Multi-process NCCL training is ROADMAP A.6.

Quirk Q1: the reference's sync server applies the *last-arriving*
worker's gradient divided by W (``src/main.cc:63-77``);
``cfg.sync_last_gradient`` reproduces that with the highest block
standing in for "last-arriving", as the JAX step does.
"""

from __future__ import annotations

import torch

from distlr_tpu_torch.config import Config


def _blocks(batch, num_shards: int):
    """Split each leaf of ``batch`` into ``num_shards`` contiguous row
    blocks (views, no copy)."""
    rows = batch[0].shape[0]
    if rows % num_shards:
        raise ValueError(f"batch of {rows} rows does not split into {num_shards} shards")
    b = rows // num_shards
    return [tuple(leaf[i * b:(i + 1) * b] for leaf in batch) for i in range(num_shards)]


def make_sync_train_step(model, cfg: Config, num_shards: int):
    """Build ``step(w, batch) -> (w, metrics)``; ``w`` is updated in place
    (the JAX step donates it).  ``metrics`` holds the mean per-shard
    ``loss`` at the pre-update ``w`` and the applied gradient's
    ``grad_norm``, as device scalars."""

    def step(w, batch):
        blocks = _blocks(batch, num_shards)
        if cfg.sync_last_gradient:
            # Q1 compat: only the highest block's gradient is applied, / W
            losses = [model.loss(w, blk, cfg) for blk in blocks[:-1]]
            loss_last, g = model.value_and_grad(w, blocks[-1], cfg)
            losses.append(loss_last)
        else:
            losses, grads = zip(*(model.value_and_grad(w, blk, cfg) for blk in blocks))
            g = grads[0]
            for g_i in grads[1:]:
                g = g + g_i
        g = g / num_shards
        metrics = {
            "loss": torch.stack(list(losses)).mean(),
            "grad_norm": torch.sqrt(torch.sum(g * g)),
        }
        w.sub_(cfg.learning_rate * g)
        return w, metrics

    return step


def make_eval_step(model):
    """``evaluate(w, batch) -> {"accuracy", "logloss"}``: exact global
    masked means over the whole eval batch ``(*inputs, y, mask)`` (the JAX
    step's psum'd sums), from one forward: X is read once."""

    def evaluate(w, batch):
        *inputs, y, mask = batch
        z = model.logits(w, *inputs)
        m = mask.to(torch.float32)
        correct = torch.sum((model.predict_from_logits(z) == y).to(torch.float32) * m)
        total = torch.clamp(m.sum(), min=1.0)
        return {"accuracy": correct / total,
                "logloss": torch.sum(model.row_loss(z, y) * m) / total}

    return evaluate
