"""Phase spans — per-step timing breakdown + Chrome trace-event dumps.

Every trainer step in this repo is a pipeline of phases (data load,
host->device, compute, pull, push, barrier wait, weight swap, eval) and
every perf question — "why is the async run slower?", "did the prefetch
actually overlap?" — is a question about where the time went *between*
them.  ``trace_phase("pull")`` wraps a block; each span is

* accumulated into a per-phase (total seconds, count) breakdown that
  survives any event-buffer cap (:meth:`PhaseTracer.breakdown`); and
* recorded into the registry histogram ``distlr_phase_seconds{phase=}``
  so the /metrics scrape carries the same story; and
* appended (bounded) as a Chrome trace event, dumpable as JSON that
  loads directly in Perfetto / ``chrome://tracing``.

Spans may run concurrently on many threads (prefetch producer, PS comm
thread, microbatch flusher, N Hogwild workers); each event carries its
thread id so the trace shows real overlap, not an interleaved fiction.

A span is host wall time.  The tracer adds no ``torch.cuda.synchronize``:
CUDA launches return before the card finishes, so a span around a launch
holds the card's time only where the loop already waits inside it (a
read-back of the result, an event wait).  Which of the trainers' phases
do, is said where they open them (``train/trainer.py``,
``train/ps_trainer.py``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

from distlr_tpu_torch.obs.registry import MetricsRegistry, get_registry

#: Bounded event buffer: a long training run must not grow without limit.
#: At ~100 B/event this caps trace memory near 20 MB; the per-phase
#: breakdown keeps aggregating past the cap (only the *timeline* truncates,
#: and the dump records how many events were dropped).
MAX_TRACE_EVENTS = 200_000


class PhaseTracer:
    """Thread-safe span recorder with Chrome trace export."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 max_events: int = MAX_TRACE_EVENTS):
        self._registry = registry or get_registry()
        self._max_events = max_events
        self._lock = threading.Lock()
        self._events: list[tuple[str, int, float, float]] = []
        self._dropped = 0
        self._totals: dict[str, list] = {}  # phase -> [seconds, count]
        self._epoch = time.perf_counter()
        self._hist = self._registry.histogram(
            "distlr_phase_seconds",
            "wall seconds spent per pipeline phase",
            labelnames=("phase",),
        )

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            dur = t1 - t0
            self._hist.labels(phase=name).observe(dur)
            tid = threading.get_ident()
            with self._lock:
                tot = self._totals.get(name)
                if tot is None:
                    self._totals[name] = [dur, 1]
                else:
                    tot[0] += dur
                    tot[1] += 1
                if len(self._events) < self._max_events:
                    self._events.append((name, tid, t0 - self._epoch, dur))
                else:
                    self._dropped += 1

    def breakdown(self) -> dict[str, dict]:
        """``{phase: {"seconds", "count"}}`` accumulated since reset."""
        with self._lock:
            return {
                name: {"seconds": round(sec, 6), "count": count}
                for name, (sec, count) in sorted(self._totals.items())
            }

    def phase_names(self) -> set[str]:
        with self._lock:
            return set(self._totals)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._totals.clear()
            self._dropped = 0
            self._epoch = time.perf_counter()

    # -- Chrome trace-event export ---------------------------------------
    def chrome_trace(self) -> dict:
        """Trace-event JSON object (``ph: "X"`` complete events, us
        timestamps) — loadable in Perfetto / chrome://tracing."""
        pid = os.getpid()
        with self._lock:
            events = [
                {
                    "name": name,
                    "cat": "phase",
                    "ph": "X",
                    "pid": pid,
                    "tid": tid,
                    "ts": round(t0 * 1e6, 3),
                    "dur": round(dur * 1e6, 3),
                }
                for name, tid, t0, dur in self._events
            ]
            dropped = self._dropped
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "distlr_tpu_torch.obs", "pid": pid},
        }
        if dropped:
            doc["otherData"]["dropped_events"] = dropped
        return doc

    def dump_chrome_trace(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
        os.replace(tmp, path)
        return path


_TRACER = PhaseTracer()


def get_tracer() -> PhaseTracer:
    """The process-wide tracer every instrumented loop records into."""
    return _TRACER


def trace_phase(name: str):
    """``with trace_phase("compute"): ...`` on the default tracer."""
    return _TRACER.phase(name)
