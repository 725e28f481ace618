"""Delayed-label join: scored requests and late labels become training
shards (the port's copy of ``distlr_tpu/feedback/join.py``).

Labels arrive seconds to minutes after the impression was scored, over
the serve line protocol (``LABEL <id> <y>``).  The joiner matches each
label to its spooled request within a window and emits the joined
examples as ``<label> <features>`` libsvm lines, in rotating shard files
(``shard-NNNNNN.libsvm``, written to ``.tmp`` then ``os.replace``-d) that
the online trainer (:mod:`distlr_tpu_torch.feedback.online`) consumes.

* **label before request**: an unknown id is held in a bounded pending
  buffer and joined the moment its request shows up.
* **duplicate labels**: the first label wins; repeats are counted
  (``duplicate_label``), never emitted again.
* **expired window**: a request never labelled within ``window_s`` is
  emitted as a label-0 example with probability ``negative_rate``
  (``random.Random(seed)``, the JAX package's stream), else dropped.

The files are the JAX package's byte for byte.  JAX also writes a
``.trace`` sidecar for shards whose records carry a distributed trace;
no record carries one until ROADMAP A.12, and an untraced shard has no
sidecar in either package.  The registry counters of the JAX joiner are
the attributes of :meth:`LabelJoiner.stats` here (ROADMAP A.12).
"""

from __future__ import annotations

import os
import random
import re
import threading

from distlr_tpu_torch.feedback import clock
from distlr_tpu_torch.feedback.spool import FeedbackSpool, SpoolRecord, drop


class LabelJoiner:
    """Join labels to spooled requests; emit libsvm training shards.

    Thread-safe: request-handler threads call :meth:`scored` /
    :meth:`label` while a ticker thread calls :meth:`tick`.  Every spool
    membership operation runs under the joiner's lock, so a request's
    check-then-spool and a label's pop-then-hold cannot interleave (the
    spool never calls back into the joiner: no lock-order cycle).
    """

    def __init__(self, spool: FeedbackSpool, out_dir: str, *,
                 window_s: float = 60.0, negative_rate: float = 0.0,
                 shard_records: int = 1024, max_pending_labels: int = 10_000,
                 recent_joined: int = 8192, seed: int = 0):
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        if not 0.0 <= negative_rate <= 1.0:
            raise ValueError(
                f"negative_rate must be in [0, 1], got {negative_rate}")
        if shard_records <= 0:
            raise ValueError(
                f"shard_records must be positive, got {shard_records}")
        self.spool = spool
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.window_s = float(window_s)
        self.negative_rate = float(negative_rate)
        self.shard_records = int(shard_records)
        self.max_pending_labels = int(max_pending_labels)
        self._recent_cap = int(recent_joined)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        #: labels that arrived before their request: rid -> (label, ts)
        self._pending: dict[str, tuple[int, float]] = {}
        #: recently joined rids (bounded, insertion-ordered): the
        #: duplicate-label detector
        self._recent: dict[str, None] = {}
        #: pending shard lines per model (``None`` = the flat layout):
        #: (text, rid or None)
        self._buffers: dict[str | None, list[tuple[str, str | None]]] = {}
        # per-model shard sequence, resumed lazily after any shard an
        # earlier run left (restarting at 0 would clobber unconsumed work)
        self._seqs: dict[str | None, int] = {}
        self.joined = 0
        self.negatives = 0
        self.shards_written = 0

    @staticmethod
    def _next_shard_seq(out_dir: str) -> int:
        # .claim (a shard a trainer owns now) and .trace sidecars count too:
        # reusing their number would clobber a reclaimed unconsumed shard
        seq = 0
        try:
            names = os.listdir(out_dir)
        except OSError:
            return 0
        for name in names:
            m = re.match(r"shard-(\d+)\.libsvm(\.done|\.claim|\.trace(\.done)?)?$", name)
            if m:
                seq = max(seq, int(m.group(1)) + 1)
        return seq

    # -- ingest ------------------------------------------------------------
    def scored(self, rec: SpoolRecord) -> None:
        """A request was scored: spool it, or join it at once when its
        label already arrived."""
        with self._lock:
            pend = self._pending.pop(rec.rid, None)
            if pend is not None:
                self._join_locked(rec.rid, pend[0], rec)
                return
            self.spool.add(rec)

    def label(self, rid: str, y: int, *, ts: float | None = None) -> str:
        """A label event arrived.  Returns the outcome: ``"joined"``,
        ``"pending"`` (request not seen yet) or ``"duplicate"``."""
        now = clock.wall() if ts is None else ts
        y = int(y)
        with self._lock:
            rec = self.spool.pop(rid)
            if rec is not None:
                self._join_locked(rid, y, rec)
                return "joined"
            if rid in self._recent or rid in self._pending:
                drop("duplicate_label")
                return "duplicate"
            if len(self._pending) >= self.max_pending_labels:
                # bounded: shed the oldest held label
                del self._pending[next(iter(self._pending))]
                drop("unmatched_label")
            self._pending[rid] = (y, now)
            return "pending"

    # -- the join ----------------------------------------------------------
    def _join_locked(self, rid: str, y: int, rec: SpoolRecord) -> None:
        self._remember_locked(rid)
        self.joined += 1
        self._emit_locked(y, rec.line, rid=rid, model=rec.model)

    def _remember_locked(self, rid: str) -> None:
        self._recent[rid] = None
        while len(self._recent) > self._recent_cap:
            del self._recent[next(iter(self._recent))]

    def _model_dir(self, model: str | None) -> str:
        return self.out_dir if model is None else os.path.join(self.out_dir, model)

    def _emit_locked(self, y: int, line: str, rid: str | None = None,
                     model: str | None = None) -> None:
        buf = self._buffers.setdefault(model, [])
        buf.append((f"{int(y)} {line}", rid))
        if len(buf) >= self.shard_records:
            self._write_shard_locked(model)

    def _write_shard_locked(self, model: str | None = None) -> None:
        buffer = self._buffers.get(model)
        if not buffer:
            return
        out_dir = self._model_dir(model)
        seq = self._seqs.get(model)
        if seq is None:
            os.makedirs(out_dir, exist_ok=True)
            seq = self._next_shard_seq(out_dir)
        path = os.path.join(out_dir, f"shard-{seq:06d}.libsvm")
        side = f"{path}.trace"
        if os.path.exists(side):
            # an orphan of a crash between a sidecar's write and its
            # shard's: a same-numbered untraced shard must not inherit it
            try:
                os.unlink(side)
            except OSError:
                pass
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(text for text, _rid in buffer) + "\n")
        os.replace(tmp, path)  # atomic: the trainer never sees a torn shard
        # tombstones after the shard is durable: a crash in between
        # replays the record, and never drops a label
        for _text, rid in buffer:
            if rid is not None:
                self.spool.mark_joined(rid)
        self._seqs[model] = seq + 1
        buffer.clear()
        self.shards_written += 1

    # -- window expiry -----------------------------------------------------
    def tick(self, now: float | None = None) -> None:
        """Resolve everything older than the window: never-labelled
        requests go through the negative sampling, held labels whose
        request never came are dropped as unmatched."""
        now = clock.wall() if now is None else now
        cutoff = now - self.window_s
        with self._lock:
            for rec in self.spool.expire_before(cutoff):
                self._remember_locked(rec.rid)
                if self.negative_rate and self._rng.random() < self.negative_rate:
                    self.negatives += 1
                    self._emit_locked(0, rec.line, model=rec.model)
                else:
                    drop("expired")
            stale = [rid for rid, (_, ts) in self._pending.items() if ts < cutoff]
            for rid in stale:
                del self._pending[rid]
                drop("unmatched_label")

    def flush(self) -> None:
        """Force out every model's partial shard (shutdown, tests, idle
        flushes)."""
        with self._lock:
            for model in list(self._buffers):
                self._write_shard_locked(model)

    def stats(self) -> dict:
        with self._lock:
            return {
                "joined": self.joined,
                "negatives": self.negatives,
                "pending_labels": len(self._pending),
                "buffered": sum(len(b) for b in self._buffers.values()),
                "shards_written": self.shards_written,
                "window_s": self.window_s,
                "negative_rate": self.negative_rate,
            }
