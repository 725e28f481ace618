"""Synchronous data-parallel step, on one card or across processes.

Counterpart of ``distlr_tpu/parallel/data_parallel.py``.  There the W
reference workers are the ``data`` axis of a mesh and their gradients
meet in a ``pmean``.  Here the W shards are W contiguous row blocks of
the global batch — the layout :class:`GlobalShardedData` builds, worker
i's rows at block i — and the step takes the gradient of each block,
then their mean.  When the mesh's data axis spans the processes of a
``torch.distributed`` group (:func:`~distlr_tpu_torch.parallel.mesh.
make_mesh`), each process holds its own blocks: it sums their gradients
(and losses), one ``all_reduce`` sums those over the processes, and the
sum is divided by the global W.

Quirk Q1: the reference's sync server applies the *last-arriving*
worker's gradient divided by W (``src/main.cc:63-77``);
``cfg.sync_last_gradient`` reproduces that with the highest block of the
global data axis (the last process's last block) standing in for
"last-arriving", as the JAX step does over its global mesh.
"""

from __future__ import annotations

import torch

from distlr_tpu_torch.config import Config
from distlr_tpu_torch.parallel.mesh import as_mesh, num_data_shards


def _blocks(batch, num_shards: int):
    """Split each leaf of ``batch`` into ``num_shards`` contiguous row
    blocks (views, no copy)."""
    rows = batch[0].shape[0]
    if rows % num_shards:
        raise ValueError(f"batch of {rows} rows does not split into {num_shards} shards")
    b = rows // num_shards
    return [tuple(leaf[i * b:(i + 1) * b] for leaf in batch) for i in range(num_shards)]


def all_reduce_sum(mesh, *tensors):
    """The tensors summed over the processes of the mesh's data axis, from
    one ``all_reduce`` of their values packed together; as given in one
    process.  Every process gets the same bits."""
    if mesh.group is None:
        return tensors
    import torch.distributed as dist  # noqa: PLC0415

    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    out, k = [], 0
    for t in tensors:
        out.append(flat[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    return tuple(out)


def make_sync_train_step(model, cfg: Config, mesh):
    """Build ``step(w, batch) -> (w, metrics)``; ``w`` is updated in place
    (the JAX step donates it).  ``mesh`` is a :class:`Mesh` or an int W
    (W row blocks in this process).  ``batch`` holds this process's blocks.
    ``metrics`` holds the mean per-shard ``loss`` at the pre-update ``w``
    and the applied gradient's ``grad_norm``, as device scalars."""
    mesh = as_mesh(mesh)
    local, num_shards = mesh.local_data_shards, num_data_shards(mesh)
    holds_last = mesh.process_index == mesh.num_processes - 1

    def step(w, batch):
        blocks = _blocks(batch, local)
        if cfg.sync_last_gradient:
            # Q1 compat: only the highest block's gradient is applied, / W
            losses = [model.loss(w, blk, cfg) for blk in blocks[:-1]]
            loss_last, g = model.value_and_grad(w, blocks[-1], cfg)
            losses.append(loss_last)
            if not holds_last:
                g = torch.zeros_like(g)
        else:
            losses, grads = zip(*(model.value_and_grad(w, blk, cfg) for blk in blocks))
            g = grads[0]
            for g_i in grads[1:]:
                g = g + g_i
        g, loss_sum = all_reduce_sum(mesh, g, torch.stack(list(losses)).sum())
        g = g / num_shards
        metrics = {
            "loss": loss_sum / num_shards,
            "grad_norm": torch.sqrt(torch.sum(g * g)),
        }
        w.sub_(cfg.learning_rate * g)
        return w, metrics

    return step


def make_eval_step(model, mesh=None):
    """``evaluate(w, batch) -> {"accuracy", "logloss"}``: exact global
    masked means over the eval batch ``(*inputs, y, mask)`` (the JAX
    step's psum'd sums), from one forward: X is read once.  Across
    processes each one evaluates its own rows and the sums meet in one
    ``all_reduce``."""
    mesh = as_mesh(1 if mesh is None else mesh)

    def evaluate(w, batch):
        *inputs, y, mask = batch
        z = model.logits(w, *inputs)
        m = mask.to(torch.float32)
        correct = torch.sum((model.predict_from_logits(z) == y).to(torch.float32) * m)
        return eval_metrics(mesh, correct, torch.sum(model.row_loss(z, y) * m), m.sum())

    return evaluate


def eval_metrics(mesh, correct, ll_sum, count) -> dict:
    """``{"accuracy", "logloss"}`` from this process's sums of correct
    predictions, per-row loglosses and mask, summed over the processes."""
    correct, ll_sum, count = all_reduce_sum(mesh, correct, ll_sum, count)
    total = torch.clamp(count, min=1.0)
    return {"accuracy": correct / total, "logloss": ll_sum / total}
