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

The files are the JAX package's byte for byte.  A joined record whose
request was traced is a ``feedback.join`` span under the request's
``feedback.spool`` span, and a shard with any traced record gets a
``.trace`` sidecar (a JSON list of ``<tid>/<sid>`` tokens or nulls, one a
line) written before the shard, which the online trainer reads when it
claims the shard; an untraced shard has none.  The joiner records the JAX joiner's series
(``distlr_feedback_joined_total``, ``_negative_sampled_total``,
``_join_delay_seconds``, ``_shards_written_total``, ``_pending_labels``)
beside the attributes of :meth:`LabelJoiner.stats`.
"""

from __future__ import annotations

import json
import os
import random
import re

from distlr_tpu_torch import sync
from distlr_tpu_torch.feedback.spool import FeedbackSpool, SpoolRecord, drop
from distlr_tpu_torch.obs import dtrace
from distlr_tpu_torch.obs.registry import get_registry

_reg = get_registry()
_JOINED = _reg.counter(
    "distlr_feedback_joined_total",
    "label events joined to their spooled request within the window",
)
_NEGATIVE = _reg.counter(
    "distlr_feedback_negative_sampled_total",
    "never-labeled requests emitted as negative (label-0) examples by "
    "the negative-sampling policy at window expiry",
)
_JOIN_DELAY = _reg.histogram(
    "distlr_feedback_join_delay_seconds",
    "seconds between a request being scored and its label joining",
)
_SHARDS = _reg.counter(
    "distlr_feedback_shards_written_total",
    "joined training shards emitted for the online trainer",
)
_PENDING_LABELS = _reg.gauge(
    "distlr_feedback_pending_labels",
    "label events holding for a request that has not arrived yet",
)


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
        self._lock = sync.Lock()
        #: labels that arrived before their request: rid -> (label, ts)
        self._pending: dict[str, tuple[int, float]] = {}
        #: recently joined rids (bounded, insertion-ordered): the
        #: duplicate-label detector
        self._recent: dict[str, None] = {}
        #: pending shard lines per model (``None`` = the flat layout):
        #: (text, (trace_id, span_id) or None, rid or None)
        self._buffers: dict[str | None, list[tuple]] = {}
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
                self._join_locked(rec.rid, pend[0], rec, now=pend[1])
                _PENDING_LABELS.set(len(self._pending))
                return
            self.spool.add(rec)

    def label(self, rid: str, y: int, *, ts: float | None = None) -> str:
        """A label event arrived.  Returns the outcome: ``"joined"``,
        ``"pending"`` (request not seen yet) or ``"duplicate"``."""
        now = sync.wall() if ts is None else ts
        y = int(y)
        with self._lock:
            rec = self.spool.pop(rid)
            if rec is not None:
                self._join_locked(rid, y, rec, now=now)
                return "joined"
            if rid in self._recent or rid in self._pending:
                drop("duplicate_label")
                return "duplicate"
            if len(self._pending) >= self.max_pending_labels:
                # bounded: shed the oldest held label
                del self._pending[next(iter(self._pending))]
                drop("unmatched_label")
            self._pending[rid] = (y, now)
            _PENDING_LABELS.set(len(self._pending))
            return "pending"

    # -- the join ----------------------------------------------------------
    def _join_locked(self, rid: str, y: int, rec: SpoolRecord, *, now: float) -> None:
        delay = max(0.0, now - rec.ts)
        _JOIN_DELAY.observe(delay)
        self._remember_locked(rid)
        self.joined += 1
        _JOINED.inc()
        trace = rec.trace
        if trace is not None:
            # continue the request's trace: the join span parents under the
            # feedback.spool span, and its ids ride the shard's sidecar
            ctx = dtrace.TraceContext(trace[0], trace[1], True)
            with dtrace.span("feedback.join", tags={"delay_s": round(delay, 3), "y": int(y)},
                             ctx=ctx) as sp:
                trace = (sp.ctx.trace_id, sp.ctx.span_id)
        self._emit_locked(y, rec.line, trace, rid=rid, model=rec.model)

    def _remember_locked(self, rid: str) -> None:
        self._recent[rid] = None
        while len(self._recent) > self._recent_cap:
            del self._recent[next(iter(self._recent))]

    def _model_dir(self, model: str | None) -> str:
        return self.out_dir if model is None else os.path.join(self.out_dir, model)

    def _emit_locked(self, y: int, line: str, trace: tuple[int, int] | None = None,
                     rid: str | None = None, model: str | None = None) -> None:
        buf = self._buffers.setdefault(model, [])
        buf.append((f"{int(y)} {line}", trace, rid))
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
        # the sidecar first: the rename that makes the shard claimable must
        # find it in place (the trainer reads it when it claims the shard)
        side = f"{path}.trace"
        if any(tr is not None for _, tr, _r in buffer):
            stmp = f"{side}.tmp"
            with open(stmp, "w") as f:
                json.dump([None if tr is None else f"{tr[0]:016x}/{tr[1]:016x}"
                           for _, tr, _r in buffer], f)
            os.replace(stmp, side)
        elif os.path.exists(side):
            # an orphan of a crash between a sidecar's write and its
            # shard's: a same-numbered untraced shard must not inherit it
            try:
                os.unlink(side)
            except OSError:
                pass
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(text for text, _tr, _rid in buffer) + "\n")
        os.replace(tmp, path)  # atomic: the trainer never sees a torn shard
        # tombstones after the shard is durable: a crash in between
        # replays the record, and never drops a label
        for _text, _tr, rid in buffer:
            if rid is not None:
                self.spool.mark_joined(rid)
        self._seqs[model] = seq + 1
        buffer.clear()
        self.shards_written += 1
        _SHARDS.inc()

    # -- window expiry -----------------------------------------------------
    def tick(self, now: float | None = None) -> None:
        """Resolve everything older than the window: never-labelled
        requests go through the negative sampling, held labels whose
        request never came are dropped as unmatched."""
        now = sync.wall() if now is None else now
        cutoff = now - self.window_s
        with self._lock:
            for rec in self.spool.expire_before(cutoff):
                self._remember_locked(rec.rid)
                if self.negative_rate and self._rng.random() < self.negative_rate:
                    self.negatives += 1
                    _NEGATIVE.inc()
                    self._emit_locked(0, rec.line, rec.trace, model=rec.model)
                else:
                    drop("expired")
            stale = [rid for rid, (_, ts) in self._pending.items() if ts < cutoff]
            for rid in stale:
                del self._pending[rid]
                drop("unmatched_label")
            if stale:
                _PENDING_LABELS.set(len(self._pending))

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
