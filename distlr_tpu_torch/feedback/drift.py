"""Score-distribution drift detection for the serving tier (the port's
copy of ``distlr_tpu/feedback/drift.py``).

Consecutive fixed-size blocks of served scores are compared with the
Population Stability Index over a fixed [0, 1] bin grid:

    PSI = sum_b (p_b - q_b) * ln(p_b / q_b)

where ``q`` is the previous completed block and ``p`` the current one.
PSI above the threshold sets :attr:`ScoreDriftDetector.firing`.  The
reference window rolls (each completed block becomes the next one's
reference), so the alert fires while the distribution moves and clears
once it settles, even at a new level.  Block boundaries count requests,
not time, so the same traffic gives the same PSI series.

The JAX package also exports the latest PSI and the alert as registry
gauges (``distlr_feedback_score_psi``, ``distlr_alert_score_drift``);
here they are the attributes :attr:`psi_last` and :attr:`firing` until
the port has a metrics registry (ROADMAP A.12).
"""

from __future__ import annotations

import threading

import numpy as np


class ScoreDriftDetector:
    """Block-wise PSI over served scores in [0, 1].

    Thread-safe; ``observe`` is called from request-handler threads.
    """

    def __init__(self, *, block: int = 512, bins: int = 10,
                 threshold: float = 0.25, smoothing: float = 1e-3):
        if block <= 0 or bins <= 1:
            raise ValueError(
                f"need block > 0 and bins > 1, got {block}/{bins}")
        if threshold <= 0:
            raise ValueError(f"threshold must be positive, got {threshold}")
        if smoothing <= 0:
            raise ValueError(f"smoothing must be positive, got {smoothing}")
        self.block = int(block)
        self.bins = int(bins)
        self.threshold = float(threshold)
        self.smoothing = float(smoothing)
        self._lock = threading.Lock()
        self._cur = np.zeros(self.bins, np.int64)
        self._cur_n = 0
        self._ref: np.ndarray | None = None
        self.psi_last: float | None = None
        self.blocks = 0
        self.firing = False
        self.fired_total = 0
        self.cleared_total = 0

    def observe(self, scores) -> None:
        """Feed served scores (out-of-range values clamp into the edge
        bins).  Blocks close at exactly ``block`` observations whatever
        the call granularity, so a burst larger than a block splits."""
        scores = np.asarray(scores, np.float64).reshape(-1)
        if scores.size == 0:
            return
        idx = np.clip((scores * self.bins).astype(np.int64), 0, self.bins - 1)
        with self._lock:
            pos = 0
            while pos < idx.size:
                take = min(self.block - self._cur_n, idx.size - pos)
                self._cur += np.bincount(idx[pos:pos + take], minlength=self.bins)
                self._cur_n += int(take)
                pos += take
                if self._cur_n >= self.block:
                    self._roll_locked()

    def _roll_locked(self) -> None:
        """Close the current block: compare it with the reference block,
        then make it the next reference."""
        cur = self._cur.copy()
        self._cur[:] = 0
        self._cur_n = 0
        self.blocks += 1
        if self._ref is not None:
            self.psi_last = psi(cur, self._ref, smoothing=self.smoothing)
            firing = self.psi_last > self.threshold
            if firing and not self.firing:
                self.fired_total += 1
            elif self.firing and not firing:
                self.cleared_total += 1
            self.firing = firing
        self._ref = cur

    def stats(self) -> dict:
        with self._lock:
            return {
                "blocks": self.blocks,
                "psi": None if self.psi_last is None else round(self.psi_last, 6),
                "firing": self.firing,
                "fired_total": self.fired_total,
                "cleared_total": self.cleared_total,
                "block_size": self.block,
                "threshold": self.threshold,
            }


def psi(p_counts, q_counts, *, smoothing: float = 1e-3) -> float:
    """PSI of two histograms (the detector's and the shadow mirror's)."""
    p = np.asarray(p_counts, np.float64)
    q = np.asarray(q_counts, np.float64)
    if p.shape != q.shape or p.sum() <= 0 or q.sum() <= 0:
        raise ValueError("need two same-shape non-empty histograms")
    p = p / p.sum() + smoothing
    q = q / q.sum() + smoothing
    return float(np.sum((p - q) * np.log(p / q)))


__all__ = ["ScoreDriftDetector", "psi"]
