"""Request microbatching: coalesce concurrent scoring requests into one
engine batch.

Counterpart of ``distlr_tpu/serve/batcher.py``.  A single request of a few
rows cannot fill a kernel's bucket, but many concurrent connections can:
requests queue briefly and flush as ONE batch when either
``max_batch_size`` rows have accumulated or the oldest request has waited
``max_wait_ms``.  The latency cost is bounded by ``max_wait_ms``; the
throughput gain is the batch occupancy, which the batcher tracks.

Requests are feature-leaf tuples (the engine's ``rows`` layout).  Leaves
are merged by concatenation with trailing-dim zero padding (sparse COO
requests may disagree on NNZ width; pad col/val 0 is the COO padding
convention, and blocked lane padding is likewise 0).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np


def _merge_leaves(leaf_lists: list[tuple[np.ndarray, ...]]) -> tuple[np.ndarray, ...]:
    """Concatenate per-request leaf tuples along the batch axis, padding
    trailing dims to the widest request."""
    merged = []
    for k in range(len(leaf_lists[0])):
        arrs = [req[k] for req in leaf_lists]
        trail = tuple(max(a.shape[j] for a in arrs) for j in range(1, arrs[0].ndim))
        arrs = [np.pad(a, [(0, 0)] + [(0, t - s) for t, s in zip(trail, a.shape[1:])])
                if tuple(a.shape[1:]) != trail else a for a in arrs]
        merged.append(np.concatenate(arrs))
    return tuple(merged)


class MicroBatcher:
    """Thread-safe request coalescer in front of a batch scoring function.

    ``submit(rows) -> Future[(labels, scores)]`` enqueues one request (a
    feature-leaf tuple with ``B`` rows); one flush thread drains the queue
    into merged batches and calls ``score_fn`` once per flush, slicing the
    results back to the requests' futures.  One flush thread is one
    scoring stream: the engine's weight swaps fall between batches.
    """

    def __init__(self, score_fn, *, max_batch_size: int = 1024, max_wait_ms: float = 2.0):
        if max_batch_size <= 0:
            raise ValueError(f"max_batch_size must be positive, got {max_batch_size}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self._score_fn = score_fn
        self.max_batch_size = int(max_batch_size)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._cv = threading.Condition()
        #: (rows, future, enqueue time)
        self._pending: list[tuple[tuple[np.ndarray, ...], Future, float]] = []
        self._pending_rows = 0
        self._closed = False
        self.batches = 0
        self.requests = 0
        self.rows = 0
        self._occupancy_sum = 0.0
        self._coalesced_sum = 0
        self._thread = threading.Thread(target=self._run, daemon=True, name="distlr-microbatch")
        self._thread.start()

    # -- client side -------------------------------------------------------
    def submit(self, rows: tuple[np.ndarray, ...]) -> Future:
        fut: Future = Future()
        n = rows[0].shape[0]
        if n == 0:
            fut.set_result((np.empty(0, np.int32), np.empty(0, np.float32)))
            return fut
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._pending.append((rows, fut, time.monotonic()))
            self._pending_rows += n
            self._cv.notify()
        return fut

    # -- flush thread ------------------------------------------------------
    def _take_batch(self):
        """Block until a flush is due; return the drained requests (None
        once closed and drained).  Flush when >= max_batch_size rows are
        pending or the oldest pending request has waited max_wait_s."""
        with self._cv:
            while True:
                if self._pending:
                    # a closing batcher drains at once
                    if self._closed or self._pending_rows >= self.max_batch_size:
                        break
                    timeout = self._pending[0][2] + self.max_wait_s - time.monotonic()
                    if timeout <= 0:
                        break
                    self._cv.wait(timeout)
                elif self._closed:
                    return None
                else:
                    self._cv.wait()
            taken, took_rows = [], 0
            while self._pending and took_rows < self.max_batch_size:
                req = self._pending.pop(0)
                taken.append(req)
                took_rows += req[0][0].shape[0]
            self._pending_rows -= took_rows
            return taken

    def _run(self):
        while True:
            taken = self._take_batch()
            if taken is None:
                return
            leaf_lists = [req[0] for req in taken]
            futures = [req[1] for req in taken]
            counts = [rows[0].shape[0] for rows in leaf_lists]
            try:
                merged = leaf_lists[0] if len(leaf_lists) == 1 else _merge_leaves(leaf_lists)
                labels, scores = self._score_fn(merged)
            except Exception as e:
                for f in futures:
                    if not f.cancelled():
                        f.set_exception(e)
                continue
            total = sum(counts)
            self.batches += 1
            self.requests += len(taken)
            self.rows += total
            self._occupancy_sum += min(total / self.max_batch_size, 1.0)
            self._coalesced_sum += len(taken)
            lo = 0
            for f, n in zip(futures, counts):
                if not f.cancelled():
                    f.set_result((labels[lo:lo + n], scores[lo:lo + n]))
                lo += n

    # -- stats / lifecycle -------------------------------------------------
    def stats(self) -> dict:
        b = max(self.batches, 1)
        return {
            "batches": self.batches,
            "requests": self.requests,
            "rows": self.rows,
            "mean_occupancy": round(self._occupancy_sum / b, 4),
            "mean_requests_per_batch": round(self._coalesced_sum / b, 2),
            "max_batch_size": self.max_batch_size,
            "max_wait_ms": self.max_wait_s * 1000.0,
        }

    def close(self) -> None:
        """Drain pending requests, then stop the flush thread."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=30.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
