"""Request-log spool: the serving tier's journal of what it scored (the
port's copy of ``distlr_tpu/feedback/spool.py``).

Every scored request is journaled (feature line, served score, the
engine weights version that scored it, a timestamp), so a label that
arrives seconds to minutes later can be joined to the exact impression
it describes (:mod:`distlr_tpu_torch.feedback.join`).

Two bounds:

* **on disk**: an append-only JSONL journal rotated into segments of
  ``segment_records`` lines, at most ``max_segments`` of them (the oldest
  deleted first).  The lines are the JAX package's, key for key, so a
  journal written by either package replays in the other.
* **in memory**: at most ``capacity`` records await their label.  Past
  it the oldest ``evict_scan`` records are scored by the serving
  :class:`~distlr_tpu_torch.serve.hotset.HotSetTracker`'s decayed key
  counts and the least important one is dropped; without a tracker, FIFO.

The JAX package counts spooled, dropped and resident records in registry
series; here they are the attributes :attr:`FeedbackSpool.spooled`,
:attr:`~FeedbackSpool.evicted` and :data:`DROPPED` until ROADMAP A.12.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
from collections import Counter

import numpy as np

from distlr_tpu_torch.feedback import clock

#: feedback-loop records dropped, by reason: ``capacity`` (spool eviction),
#: ``expired`` (window elapsed, negative sample not drawn),
#: ``duplicate_label`` and ``unmatched_label`` (the JAX package's
#: ``distlr_feedback_dropped_total`` series)
DROPPED: Counter = Counter()
_DROPPED_LOCK = threading.Lock()


def drop(reason: str, n: int = 1) -> None:
    """Count a feedback-loop drop (shared with the joiner, so every
    discarded record lands in one count, split by reason)."""
    with _DROPPED_LOCK:
        DROPPED[reason] += n


@dataclasses.dataclass
class SpoolRecord:
    """One scored request awaiting its label."""

    rid: str                   # request id (caller-supplied or auto)
    ts: float                  # wall-clock seconds at scoring time
    line: str                  # feature line, libsvm grammar, no label
    score: float               # served score (P(y=1) / max class prob)
    version: int               # engine weights version that scored it
    #: PS row keys the request touched (importance input); None = unknown
    keys: np.ndarray | None = None
    #: distributed-trace (trace_id, span_id); always None until the port
    #: traces requests (ROADMAP A.12), but journaled and replayed as JAX's
    trace: tuple[int, int] | None = None
    #: the model id that scored the request (several engines a server):
    #: the joiner writes its example into that model's shard stream;
    #: None = one unnamed engine (flat shards)
    model: str | None = None


class FeedbackSpool:
    """Bounded spool of scored requests, journaled to disk.

    Thread-safe: request-handler threads ``add`` while the joiner's
    ticker expires records and label lines ``pop`` them.
    """

    def __init__(self, directory: str, *, capacity: int = 100_000,
                 tracker=None, segment_records: int = 10_000,
                 max_segments: int = 8, evict_scan: int = 16):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if segment_records <= 0 or max_segments <= 0:
            raise ValueError(
                "segment_records and max_segments must be positive, got "
                f"{segment_records}/{max_segments}")
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.capacity = int(capacity)
        self.tracker = tracker
        self.segment_records = int(segment_records)
        self.max_segments = int(max_segments)
        self.evict_scan = max(int(evict_scan), 1)
        self._lock = threading.Lock()
        #: insertion-ordered: front = oldest
        self._records: dict[str, SpoolRecord] = {}
        # resume the journal after any segment an earlier run left, so two
        # runs never share a segment and the disk bound keeps holding
        existing = sorted(
            int(m.group(1)) for name in os.listdir(directory)
            if (m := re.match(r"spool-(\d+)\.jsonl$", name)))
        self._seg_index = existing[-1] + 1 if existing else 0
        for idx in existing:
            if idx <= self._seg_index - self.max_segments:
                try:
                    os.unlink(self._seg_path(idx))
                except OSError:
                    pass
        self._seg_count = 0
        self._seg_file = None
        self.spooled = 0
        self.evicted = 0
        self.replayed = 0

    # -- journal ----------------------------------------------------------
    def _seg_path(self, index: int) -> str:
        return os.path.join(self.directory, f"spool-{index:06d}.jsonl")

    def _journal_locked(self, rec: SpoolRecord) -> None:
        doc = {
            "id": rec.rid, "ts": round(rec.ts, 3), "line": rec.line,
            "score": round(rec.score, 6), "version": rec.version,
        }
        if rec.model is not None:
            # a label joined across a restart still lands in its model's stream
            doc["model"] = rec.model
        if rec.trace is not None:
            doc["trace"] = f"{rec.trace[0]:016x}/{rec.trace[1]:016x}"
        self._journal_line_locked(doc)

    def _journal_line_locked(self, doc: dict) -> None:
        if self._seg_file is None or self._seg_count >= self.segment_records:
            if self._seg_file is not None:
                self._seg_file.close()
                self._seg_index += 1
            self._seg_file = open(self._seg_path(self._seg_index), "a")
            self._seg_count = 0
            old = self._seg_index - self.max_segments
            if old >= 0:
                try:
                    os.unlink(self._seg_path(old))
                except OSError:
                    pass  # already rotated away by an earlier run
        self._seg_file.write(json.dumps(doc) + "\n")
        self._seg_count += 1

    def mark_joined(self, rid: str) -> None:
        """Journal a join tombstone: a replay after a restart must not
        resurrect a request that was already joined."""
        with self._lock:
            self._journal_line_locked({"joined": rid})

    def replay(self, *, window_s: float, now: float | None = None) -> int:
        """Rebuild the joinable set from the on-disk journal (an earlier
        run's segments): every record still inside the join window and not
        tombstoned becomes joinable again, so a label that arrives across
        a serve restart joins its impression.  Replayed records carry
        ``keys=None`` (keys are not journaled).  Returns the number of
        records restored."""
        now = clock.wall() if now is None else now
        cutoff = now - float(window_s)
        segs = sorted(
            int(m.group(1)) for name in os.listdir(self.directory)
            if (m := re.match(r"spool-(\d+)\.jsonl$", name)))
        recovered: dict[str, SpoolRecord] = {}
        for idx in segs:
            try:
                with open(self._seg_path(idx)) as f:
                    lines = f.read().splitlines()
            except OSError:
                continue
            for raw in lines:
                try:
                    doc = json.loads(raw)
                except ValueError:
                    continue  # the torn last line of a crashed run
                if "joined" in doc:
                    recovered.pop(str(doc["joined"]), None)
                    continue
                if doc.get("ts", 0.0) < cutoff:
                    continue
                trace = None
                tok = doc.get("trace")
                if tok:
                    try:
                        tid, _, sid = tok.partition("/")
                        trace = (int(tid, 16), int(sid, 16))
                    except ValueError:
                        pass
                model = doc.get("model")
                rec = SpoolRecord(
                    rid=str(doc["id"]), ts=float(doc["ts"]),
                    line=str(doc.get("line", "")),
                    score=float(doc.get("score", 0.0)),
                    version=int(doc.get("version", 0)), trace=trace,
                    model=None if model is None else str(model))
                recovered[rec.rid] = rec
        with self._lock:
            n = 0
            for rid, rec in recovered.items():
                if rid in self._records:
                    continue
                self._records[rid] = rec
                n += 1
                if len(self._records) > self.capacity:
                    self._evict_one_locked()
            self.replayed += n
        return n

    # -- importance -------------------------------------------------------
    def _importances(self, window: list[SpoolRecord]) -> list[float]:
        """Tracker-count mass of each record's touched rows, in one
        ``importance_many`` call (one tracker lock an eviction)."""
        if self.tracker is None:
            return [0.0] * len(window)
        many = getattr(self.tracker, "importance_many", None)
        if many is not None:
            return many([rec.keys for rec in window])
        return [0.0 if rec.keys is None or not len(rec.keys)
                else float(self.tracker.importance(rec.keys))
                for rec in window]

    # -- ingest / claim ---------------------------------------------------
    def add(self, rec: SpoolRecord) -> bool:
        """Spool one scored request.  Returns False when the record was
        evicted at once (it was journaled all the same: only the joinable
        working set is bounded)."""
        kept = True
        with self._lock:
            self._journal_locked(rec)
            self._records[rec.rid] = rec
            self.spooled += 1
            if len(self._records) > self.capacity:
                evicted = self._evict_one_locked()
                kept = evicted != rec.rid
        return kept

    def _evict_one_locked(self) -> str:
        """Drop the least important of the oldest ``evict_scan`` records
        (FIFO without a tracker: every importance ties at 0 and the scan
        keeps insertion order)."""
        it = iter(self._records.values())
        window = []
        for _ in range(self.evict_scan):
            try:
                window.append(next(it))
            except StopIteration:
                break
        scores = self._importances(window)
        victim = window[min(range(len(window)), key=scores.__getitem__)]
        del self._records[victim.rid]
        self.evicted += 1
        drop("capacity")
        return victim.rid

    def pop(self, rid: str) -> SpoolRecord | None:
        """Claim a spooled request by id (the label join's hit path)."""
        with self._lock:
            return self._records.pop(rid, None)

    def expire_before(self, cutoff_ts: float) -> list[SpoolRecord]:
        """Remove and return every record scored before ``cutoff_ts`` (the
        never-labelled set, the negative sampling's input); the scan stops
        at the first fresh record."""
        out = []
        with self._lock:
            for rid, rec in list(self._records.items()):
                if rec.ts >= cutoff_ts:
                    break
                out.append(self._records.pop(rid))
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._records),
                "capacity": self.capacity,
                "spooled": self.spooled,
                "evicted": self.evicted,
                "replayed": self.replayed,
                "journal_segment": self._seg_index,
            }

    def close(self) -> None:
        with self._lock:
            if self._seg_file is not None:
                self._seg_file.close()
                self._seg_file = None


def per_row_keys(model: str, rows: tuple, *, max_keys: int = 128) -> list[np.ndarray]:
    """PS row keys touched by each request row: the keyed families read
    their id leaf a row, dense rows their nonzero columns; at most
    ``max_keys`` a row.  ``rows`` are the host arrays
    ``ScoringEngine.encode_lines`` returns, never the device batch."""
    first = np.asarray(rows[0])
    out = []
    if model in ("sparse_lr", "sparse_softmax", "blocked_lr"):
        for i in range(first.shape[0]):
            k = np.unique(first[i].astype(np.int64)).astype(np.uint64)
            out.append(k[:max_keys])
        return out
    for i in range(first.shape[0]):
        k = np.flatnonzero(first[i] != 0).astype(np.uint64)
        out.append(k[:max_keys])
    return out


def strip_label(line: str) -> str:
    """The feature part of a request line: a leading token without ``:``
    is a label and goes (the rule of ``encode_lines``)."""
    line = line.strip()
    if not line:
        return line
    first = line.split(None, 1)
    if ":" in first[0]:
        return line
    return first[1] if len(first) > 1 else ""


def now_ts() -> float:
    return clock.wall()
