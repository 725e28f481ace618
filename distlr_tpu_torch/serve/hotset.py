"""Hot-row working-set tracking: which parameter rows does serving traffic
touch?  The port's copy of ``distlr_tpu/serve/hotset.py``.

A full weight refresh at D = 1M moves the whole table, but a scoring
request reads only the rows its features hash to, and real request
streams are concentrated.  :class:`HotSetTracker` keeps that working set
from live requests, so :class:`distlr_tpu_torch.serve.reload.LivePSWatcher`
refreshes only the hot slice through keyed pulls
(:meth:`~distlr_tpu_torch.ps.KVWorker.pull_rows_into`) and falls back to a
full refresh when the set stops covering the traffic.

Decayed occurrence counts a row key, capped at ``capacity`` (the
top-count survivors), and a coverage window: the share of key occurrences
since the last published snapshot that the snapshot already held.  A
shifting key distribution drives coverage down, and the watcher answers
with a full refresh.  The JAX package's registry gauges wait for ROADMAP
A.12; :meth:`HotSetTracker.stats` carries the same numbers.
"""

from __future__ import annotations

import heapq
import threading

import numpy as np


class HotSetTracker:
    """Decayed count-based working set of parameter row keys, capped.

    Thread-safe: request handler threads ``observe`` while the reload
    poller calls ``hot_keys``/``coverage``.

    * :meth:`observe` — record one request batch's touched row keys
      (``ScoringEngine.row_keys``).
    * :meth:`hot_keys` — publish the current set (sorted row ids, the
      keyed-pull key array) and restart the coverage window.
    * :meth:`coverage` — hit fraction of occurrences since the last
      publish; 1.0 under no traffic (idleness is not evidence of drift).
    """

    def __init__(self, capacity: int, *, decay: float = 0.5,
                 decay_every: int = 10_000, min_count: float = 0.5):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        if decay_every <= 0:
            raise ValueError(f"decay_every must be positive, got {decay_every}")
        self.capacity = int(capacity)
        self.decay = float(decay)
        self.decay_every = int(decay_every)
        self.min_count = float(min_count)
        self._lock = threading.Lock()
        self._counts: dict[int, float] = {}
        #: the published snapshot as a sorted array — hit tests run as
        #: one vectorized np.isin on the request thread, not a per-key
        #: Python loop under the lock
        self._hot_sorted = np.empty(0, np.uint64)
        self._hits = 0
        self._total = 0
        self._since_decay = 0
        self.observed = 0
        self.decays = 0
        self.evictions = 0

    # -- ingest ------------------------------------------------------------
    def observe(self, keys) -> None:
        """Record touched row keys (uint64 array, repeats meaningful)."""
        keys = np.asarray(keys, dtype=np.uint64).reshape(-1)
        if keys.size == 0:
            return
        uniq, cnt = np.unique(keys, return_counts=True)
        n_obs = int(keys.size)
        # hit accounting against the published snapshot, vectorized and
        # lock-free (a stale snapshot reference only misattributes the
        # handful of occurrences racing a publish)
        hot = self._hot_sorted
        hits = int(cnt[np.isin(uniq, hot, assume_unique=True)].sum()) \
            if hot.size else 0
        with self._lock:
            counts = self._counts
            for k, n in zip(uniq.tolist(), cnt.tolist()):
                counts[k] = counts.get(k, 0.0) + n
            self._hits += hits
            self._total += n_obs
            self.observed += n_obs
            self._since_decay += n_obs
            if self._since_decay >= self.decay_every:
                self._decay_locked()
            elif len(counts) > 2 * self.capacity:
                self._enforce_cap_locked()

    def _decay_locked(self) -> None:
        d = self.decay
        self._counts = {k: v * d for k, v in self._counts.items()
                        if v * d >= self.min_count}
        self._since_decay = 0
        self.decays += 1
        self._enforce_cap_locked()

    def _enforce_cap_locked(self) -> None:
        over = len(self._counts) - self.capacity
        if over <= 0:
            return
        keep = heapq.nlargest(self.capacity, self._counts.items(),
                              key=lambda kv: kv[1])
        self._counts = dict(keep)
        self.evictions += over

    # -- read side ---------------------------------------------------------
    def hot_keys(self) -> np.ndarray:
        """The current hot set as a sorted uint64 row-id array (what the
        keyed pull wants), published as the new coverage snapshot."""
        with self._lock:
            self._enforce_cap_locked()
            keys = np.fromiter(self._counts.keys(), dtype=np.uint64,
                               count=len(self._counts))
            keys.sort()
            self._hot_sorted = keys
            self._hits = 0
            self._total = 0
        return keys.copy()  # callers must not alias the live snapshot

    def importance(self, keys) -> float:
        """Decayed-count mass of a key set — how much of the tracked
        traffic touches these rows.  The feedback spool's retention
        score (:mod:`distlr_tpu_torch.feedback.spool`): under capacity
        pressure, requests whose rows nobody asks about are shed first,
        reusing exactly the statistics hot-row reload already pays for."""
        keys = np.asarray(keys, dtype=np.uint64).reshape(-1)
        if keys.size == 0:
            return 0.0
        with self._lock:
            counts = self._counts
            return float(sum(counts.get(int(k), 0.0) for k in keys))

    def importance_many(self, key_sets) -> list[float]:
        """:meth:`importance` for a batch of key sets under ONE lock
        acquisition — the spool's eviction scan calls this per evicted
        record, and per-candidate locking would contend with the
        scoring hot path's :meth:`observe`.  ``None``/empty key sets
        score 0.0."""
        with self._lock:
            counts = self._counts
            return [
                0.0 if keys is None or not len(keys) else
                float(sum(counts.get(int(k), 0.0) for k in keys))
                for keys in key_sets
            ]

    def coverage(self) -> float:
        with self._lock:
            return 1.0 if self._total == 0 else self._hits / self._total

    def stats(self) -> dict:
        with self._lock:
            n, total, hits = len(self._counts), self._total, self._hits
        return {
            "keys": n,
            "capacity": self.capacity,
            "observed": self.observed,
            "coverage": round(1.0 if total == 0 else hits / total, 4),
            "decays": self.decays,
            "evictions": self.evictions,
        }
