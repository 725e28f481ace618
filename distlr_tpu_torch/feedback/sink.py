"""FeedbackSink: the serving front-end's one handle on the feedback loop
(the port's copy of ``distlr_tpu/feedback/sink.py``).

It holds the spool, the label joiner and the drift detector behind the
two calls :class:`~distlr_tpu_torch.serve.server.ScoringServer` makes:

* :meth:`FeedbackSink.scored` after a batch is scored: journal each row
  (id, feature line, score, weights version, touched keys) and feed the
  drift detector;
* :meth:`FeedbackSink.label` on a ``LABEL <id> <y>`` line.

A daemon ticker drives the window expiry (negative sampling) and
flushes a partial shard after ``idle_flush_s`` without new examples, so
the tail of a burst still reaches the online trainer.
"""

from __future__ import annotations

import itertools
import threading

from distlr_tpu_torch.feedback import clock
from distlr_tpu_torch.feedback.drift import ScoreDriftDetector
from distlr_tpu_torch.feedback.join import LabelJoiner
from distlr_tpu_torch.feedback.spool import (
    FeedbackSpool,
    SpoolRecord,
    per_row_keys,
    strip_label,
)


class FeedbackSink:
    """Spool + joiner + drift detector behind the serve front-end."""

    def __init__(self, spool_dir: str, shard_dir: str, *,
                 model: str = "binary_lr", capacity: int = 100_000,
                 window_s: float = 60.0, negative_rate: float = 0.0,
                 shard_records: int = 1024, tracker=None,
                 drift_block: int = 512, drift_threshold: float = 0.25,
                 tick_interval_s: float = 0.5, idle_flush_s: float = 5.0,
                 seed: int = 0, replay: bool = True):
        self.model = model
        self.spool = FeedbackSpool(spool_dir, capacity=capacity, tracker=tracker)
        if replay:
            # labels that arrive across a serve restart join their impression
            self.spool.replay(window_s=window_s)
        self.joiner = LabelJoiner(self.spool, shard_dir, window_s=window_s,
                                  negative_rate=negative_rate,
                                  shard_records=shard_records, seed=seed)
        self.drift = ScoreDriftDetector(block=drift_block, threshold=drift_threshold)
        self.tick_interval_s = float(tick_interval_s)
        self.idle_flush_s = float(idle_flush_s)
        self._auto_ids = itertools.count()
        self._last_emit_seen = 0
        self._last_emit_at = clock.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- serve-side entry points ------------------------------------------
    def scored(self, lines: list[str], rows: tuple, scores, *,
               version: int, ids: list[str | None] | None = None,
               trace: tuple[int, int] | None = None,
               model: str | None = None) -> None:
        """Journal one scored batch.  ``lines`` are the request lines (a
        label token is stripped here), ``rows`` the engine's encoded host
        leaves of the same batch, ``scores`` the served scores.
        ``ids[i] = None`` gets an automatic id: such a row is never
        labelled but feeds the drift detector and the negative sampling.
        ``model``: the model id that scored the batch (its own shard
        subdirectory); None = the flat layout.  ``trace`` is accepted and
        ignored until the port traces requests (ROADMAP A.12)."""
        now = clock.wall()
        keys = per_row_keys(self.model, rows)
        for i, line in enumerate(lines):
            rid = ids[i] if ids is not None and ids[i] is not None \
                else f"auto-{next(self._auto_ids)}"
            self.joiner.scored(SpoolRecord(
                rid=str(rid), ts=now, line=strip_label(line),
                score=float(scores[i]), version=int(version),
                keys=keys[i] if i < len(keys) else None, model=model))
        self.drift.observe(scores)

    def label(self, rid: str, y: int) -> str:
        """Outcome string (``joined`` / ``pending`` / ``duplicate``)."""
        return self.joiner.label(str(rid), int(y))

    # -- ticker ------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.tick_interval_s):
            self.tick()

    def tick(self, now: float | None = None) -> None:
        self.joiner.tick(now)
        emitted = self.joiner.joined + self.joiner.negatives
        mono = clock.monotonic()
        if emitted != self._last_emit_seen:
            self._last_emit_seen = emitted
            self._last_emit_at = mono
        elif (self.joiner.stats()["buffered"]
              and mono - self._last_emit_at >= self.idle_flush_s):
            # a quiet tail: the online trainer sees the last joins of a burst
            self.joiner.flush()
            self._last_emit_at = mono

    def start(self) -> "FeedbackSink":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="distlr-feedback-tick")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.joiner.flush()
        self.spool.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def stats(self) -> dict:
        return {
            "spool": self.spool.stats(),
            "join": self.joiner.stats(),
            "drift": self.drift.stats(),
        }
