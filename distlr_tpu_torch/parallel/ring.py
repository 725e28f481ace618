"""Explicit ring collectives over the column blocks, and a ring-based
feature-sharded training step.

Counterpart of ``distlr_tpu/parallel/ring.py``.  There each of the S
devices of a mesh axis holds its own ``x``, and a hop is one
``lax.ppermute`` from device i to i+1: a chunked **reduce-scatter**
(S − 1 hops) then a chunked **all-gather** (S − 1 hops) is an allreduce
whose every hop moves 1/S of the data.  Here the S "devices" are the S
column blocks of one card, so their values come stacked on a leading
axis — ``xs[i]`` is device i's ``x`` — and each hop runs for every device
at once: device i adds device i−1's outgoing chunk into its own copy of
that chunk, ``prev + recvd``, as the JAX hop does.  The sums come out in
JAX's order, bit for bit: the pad to ``ceil(n/s)·s``, the chunk each
device sends at step t (``(i − t) mod s``) and the rotated ownership that
reduce-scatter leaves (device i owns chunk ``(i + 1) mod s``).
"""

from __future__ import annotations

import torch

from distlr_tpu_torch.config import Config
from distlr_tpu_torch.models import BinaryLR
from distlr_tpu_torch.parallel.feature_parallel import make_feature_sharded_train_step
from distlr_tpu_torch.parallel.mesh import Mesh


def ring_reduce_scatter(xs: torch.Tensor) -> torch.Tensor:
    """Ring reduce-scatter of the S devices' flat ``xs[i]`` (``xs``: (S, n)).

    Returns (S, ceil(n/S)): row i is device i's fully reduced chunk, chunk
    ``(i + 1) mod S`` of the zero-padded input.  S − 1 hops."""
    s, n = xs.shape
    chunk = -(-n // s)
    acc = torch.nn.functional.pad(xs, (0, chunk * s - n)).reshape(s, s, chunk).clone()
    dev = torch.arange(s, device=xs.device)
    src = (dev - 1) % s
    for step in range(s - 1):
        # device i receives device i-1's chunk (i-1-step) mod s and adds it
        # into its own copy of that chunk
        c = (dev - 1 - step) % s
        recvd = acc[src, c]
        acc[dev, c] = acc[dev, c] + recvd
    return acc[dev, (dev + 1) % s]


def ring_all_gather(chunks: torch.Tensor, *, owner_offset: int = 0) -> torch.Tensor:
    """Ring all-gather: device i contributes ``chunks[i]`` and ends with all
    S chunks, ordered by owner.  ``owner_offset=k``: device i's chunk is
    logically chunk ``(i + k) mod S`` (reduce-scatter leaves ownership
    rotated by one).  Returns (S, S · chunk): row i is device i's result
    (every row the same).  S − 1 hops."""
    s = chunks.shape[0]
    dev = torch.arange(s, device=chunks.device)
    out = torch.zeros((s, s) + tuple(chunks.shape[1:]), dtype=chunks.dtype,
                      device=chunks.device)
    cur = (dev + owner_offset) % s
    out[dev, cur] = chunks
    for _ in range(s - 1):
        recvd = out[(dev - 1) % s, cur[(dev - 1) % s]]
        cur = (cur - 1) % s
        out[dev, cur] = recvd
    return out.reshape((s, -1) + tuple(chunks.shape[2:]))


def ring_psum(xs: torch.Tensor) -> torch.Tensor:
    """Allreduce of the S devices' ``xs[i]`` as ring reduce-scatter + ring
    all-gather: (S, ...) where every row is the sum, 2(S − 1) hops of
    1/S of the data each."""
    s = xs.shape[0]
    flat = xs.reshape(s, -1)
    full = ring_all_gather(ring_reduce_scatter(flat), owner_offset=1)
    return full[:, :flat.shape[1]].reshape(xs.shape)


def _ring_sum(parts):
    """The column blocks' terms summed by a ring allreduce; every device
    ends with the same sum: device 0's."""
    return ring_psum(torch.stack(parts))[0]


def make_ring_train_step(model, cfg: Config, mesh: Mesh, *, with_metrics: bool = True):
    """Feature-sharded sync step whose model-axis sums are ring allreduces
    (:func:`~distlr_tpu_torch.parallel.feature_parallel.
    make_feature_sharded_train_step` with the ring's sum; ``BinaryLR``
    only).  ``metrics``: ``{"loss"}``, as the JAX ring step's."""
    if not isinstance(model, BinaryLR):
        raise TypeError("ring step supports BinaryLR (dense weights)")
    inner = make_feature_sharded_train_step(model, cfg, mesh, with_metrics=with_metrics,
                                            model_sum=_ring_sum)

    def step(w, batch):
        w, metrics = inner(w, batch)
        return w, {k: v for k, v in metrics.items() if k == "loss"}

    return step
