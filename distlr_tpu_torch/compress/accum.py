"""AdaBatch-style local gradient accumulation (the port's copy of
``distlr_tpu/compress/accum.py``).

One accumulator is one worker's "push every k batches" state: gradients
sum into a local full-width f32 buffer, a flush pushes their MEAN (one
PS update of effective batch ``k * B``), and ``k`` grows on a schedule:
times ``growth`` every ``growth_every`` flushes, capped at ``max_k``
(AdaBatch, arXiv:1712.02029).  The span divides push traffic by ``k``;
the wire codec divides each push's bytes, and the two multiply.

The span's ``k`` is the attribute :attr:`GradientAccumulator.k`, and
the owner's registry gauge when one is given (the PS worker's
``distlr_train_accum_batches{rank}``, the online trainer's
``distlr_feedback_accum_batches``), set at construction and at every
growth.  Not thread-safe: one accumulator a worker.  Within a span the caller reuses the weights it
pulled at span start.
"""

from __future__ import annotations

import numpy as np


class GradientAccumulator:
    """Local mean-gradient accumulation with a growing flush span."""

    def __init__(self, dim: int, *, start: int = 1, growth: float = 2.0,
                 growth_every: int = 32, max_k: int = 64, gauge=None):
        if start < 1 or max_k < start:
            raise ValueError(f"need 1 <= start <= max_k, got {start}/{max_k}")
        if growth < 1.0:
            raise ValueError(f"growth must be >= 1, got {growth}")
        if growth_every <= 0:
            raise ValueError(f"growth_every must be positive, got {growth_every}")
        self.dim = int(dim)
        #: the current span: batches a flush
        self.k = int(start)
        self.growth = float(growth)
        self.growth_every = int(growth_every)
        self.max_k = int(max_k)
        #: completed flushes (the pushes the owner issued)
        self.flushes = 0
        self._buf = np.zeros(self.dim, np.float32)
        self._batches = 0
        self._gauge = gauge
        if gauge is not None:
            gauge.set(self.k)

    @property
    def batches(self) -> int:
        """Batches accumulated since the last flush (0 = span start: time
        for the caller to refresh its pulled weights)."""
        return self._batches

    @property
    def ready(self) -> bool:
        """True once the current span is full: flush now."""
        return self._batches >= self.k

    def add(self, g: np.ndarray) -> None:
        """Accumulate one full-width dense gradient."""
        self._buf += np.asarray(g, np.float32).reshape(-1)
        self._batches += 1

    def add_at(self, idx: np.ndarray, g: np.ndarray) -> None:
        """Accumulate a keyed gradient: ``g[i]`` lands on flat coordinate
        ``idx[i]`` (unique indices, as a batch's unique keys are)."""
        self._buf[np.asarray(idx, np.int64)] += np.asarray(g, np.float32).reshape(-1)
        self._batches += 1

    def add_rows(self, rows: np.ndarray, g: np.ndarray, vpk: int) -> None:
        """Accumulate a row-keyed gradient: row ``rows[i]`` owns flat slots
        ``[rows[i]*vpk, (rows[i]+1)*vpk)``; ``g`` holds ``len(rows)*vpk``
        values row-major."""
        view = self._buf.reshape(-1, vpk)
        view[np.asarray(rows, np.int64)] += np.asarray(g, np.float32).reshape(-1, vpk)
        self._batches += 1

    def flush_dense(self) -> np.ndarray | None:
        """Mean gradient of the span (None for an empty span), then reset
        and advance the schedule.  The array is a fresh buffer."""
        if self._batches == 0:
            return None
        g = self._buf / np.float32(self._batches)
        self._reset_and_advance()
        return g

    def flush_keyed(self, vpk: int = 1):
        """:meth:`flush_dense`, keyed: ``(row_keys, vals)`` of the rows the
        span touched (any nonzero lane), vals row-major ``len(keys)*vpk``.
        None for an empty span; empty arrays when the span's gradients
        cancelled to exact zeros (the schedule still advances: a sync
        caller pushes the empty frame as its BSP vote, an async caller
        skips it)."""
        if self._batches == 0:
            return None
        view = (self._buf / np.float32(self._batches)).reshape(-1, vpk)
        rows = np.flatnonzero((view != 0).any(axis=1)).astype(np.uint64)
        vals = view[rows.astype(np.int64)].reshape(-1)
        self._reset_and_advance()
        return rows, vals

    def _reset_and_advance(self) -> None:
        self._buf[:] = 0.0
        self._batches = 0
        self.flushes += 1
        if self.flushes % self.growth_every == 0:
            grown = max(self.k + 1, int(round(self.k * self.growth)))
            self.k = min(self.max_k, grown)
            if self._gauge is not None:
                self._gauge.set(self.k)
