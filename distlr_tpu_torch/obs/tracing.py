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
``train/ps_trainer.py``).  A span timed elsewhere, such as a copy timed
on the card by CUDA events and put on the host's clock
(:class:`distlr_tpu_torch.obs.torchrt.DeviceClock`), enters through
:meth:`PhaseTracer.record`.

Beyond the JAX tracer, a span may carry a byte count (summed into its
phase's breakdown as ``bytes``) and attributes (the Chrome event's
``args``); an event with neither has the JAX tracer's keys exactly.
The sync trainer records, besides the JAX trainer's phases, the
:data:`PORT_ONLY_PHASES`; each span of a batch carries
``{"epoch", "batch"}``, so the producer's and the consumer's spans of one
batch join.
"""

from __future__ import annotations

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

#: The sync trainer's phases that the JAX trainer has not
#: (``train/trainer.py``):
#:
#: * ``pin`` — the producer's copy of a batch into page-locked memory,
#:   inside its ``h2d``; bytes: the leaves it copies;
#: * ``h2d_copy`` — the batch's copy to the card, on the copy stream: from
#:   the return of its enqueue (or, behind an earlier copy, a CUDA event
#:   before it) to a CUDA event after it, on the host's clock; exported on
#:   :data:`COPY_STREAM_TID`; bytes: the batch's;
#: * ``copy_wait`` — the start of the step's ``compute`` span until the
#:   batch's copy ended (or the span did), when the copy ended after the
#:   span began: the step's wait for its batch;
#: * ``epoch_fill`` — the ``data_load`` wait for an epoch's first batch,
#:   with its extent: the refill of a pipeline restarted each epoch;
#: * ``test_h2d`` — the test batch's copy to the device at the start of
#:   ``fit``.
#:
#: ``pin``, ``h2d_copy`` and ``copy_wait`` are recorded only where the
#: batches go to a CUDA device through a copy stream.
PORT_ONLY_PHASES = frozenset({"pin", "h2d_copy", "copy_wait", "epoch_fill", "test_h2d"})
#: The Chrome ``tid`` of spans timed on the card's copy stream (no host
#: thread has ident 0).
COPY_STREAM_TID = 0


class Span:
    """A :meth:`PhaseTracer.phase` block: a context manager whose extent on
    the host's ``time.perf_counter`` clock is ``t0`` as it opens and
    ``t1`` once it has closed, when it is recorded.  The block may set
    ``nbytes`` once it knows what it moved."""

    __slots__ = ("_tracer", "_name", "nbytes", "_args", "t0", "t1")

    def __init__(self, tracer: PhaseTracer, name: str, nbytes: int | None,
                 args: dict | None):
        self._tracer, self._name, self.nbytes, self._args = tracer, name, nbytes, args
        self.t0 = self.t1 = None

    def __enter__(self) -> Span:
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        self._tracer.record(self._name, self.t0, self.t1, nbytes=self.nbytes, args=self._args)


class PhaseTracer:
    """Thread-safe span recorder with Chrome trace export."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 max_events: int = MAX_TRACE_EVENTS):
        self._registry = registry or get_registry()
        self._max_events = max_events
        self._lock = threading.Lock()
        # (name, tid, start since the epoch, duration, Chrome args or None)
        self._events: list[tuple[str, int, float, float, dict | None]] = []
        self._dropped = 0
        self._totals: dict[str, list] = {}  # phase -> [seconds, count, bytes or None]
        self._epoch = time.perf_counter()
        self._hist = self._registry.histogram(
            "distlr_phase_seconds",
            "wall seconds spent per pipeline phase",
            labelnames=("phase",),
        )
        # the histogram's child of each phase, looked up once
        self._hist_children: dict[str, object] = {}

    def phase(self, name: str, *, nbytes: int | None = None, args: dict | None = None) -> Span:
        """``with tracer.phase(name) as span:`` times the block as a span
        of ``name``, also when it raises.  ``nbytes``: the bytes the span
        moved; ``args``: its attributes."""
        return Span(self, name, nbytes, args)

    def record(self, name: str, t0: float, t1: float, *, nbytes: int | None = None,
               args: dict | None = None, tid: int | None = None) -> None:
        """A span of ``name`` from ``t0`` to ``t1``, absolute
        ``time.perf_counter`` seconds, timed by the caller: into the
        breakdown, the phase histogram and the timeline as a
        :meth:`phase` block is.  ``tid``: the Chrome thread it is shown
        on (default the calling thread's)."""
        dur = t1 - t0
        child = self._hist_children.get(name)
        if child is None:
            child = self._hist_children.setdefault(name, self._hist.labels(phase=name))
        child.observe(dur)
        if tid is None:
            tid = threading.get_ident()
        if nbytes is not None:
            args = {**(args or {}), "bytes": int(nbytes)}
        with self._lock:
            tot = self._totals.get(name)
            if tot is None:
                self._totals[name] = [dur, 1, nbytes]
            else:
                tot[0] += dur
                tot[1] += 1
                if nbytes is not None:
                    tot[2] = (tot[2] or 0) + nbytes
            if len(self._events) < self._max_events:
                self._events.append((name, tid, t0 - self._epoch, dur, args))
            else:
                self._dropped += 1

    def breakdown(self) -> dict[str, dict]:
        """``{phase: {"seconds", "count"}}`` accumulated since reset, and
        ``"bytes"`` for a phase whose spans gave byte counts."""
        with self._lock:
            out = {}
            for name, (sec, count, nbytes) in sorted(self._totals.items()):
                out[name] = {"seconds": round(sec, 6), "count": count}
                if nbytes is not None:
                    out[name]["bytes"] = nbytes
            return out

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
            events = []
            for name, tid, t0, dur, args in self._events:
                event = {
                    "name": name,
                    "cat": "phase",
                    "ph": "X",
                    "pid": pid,
                    "tid": tid,
                    "ts": round(t0 * 1e6, 3),
                    "dur": round(dur * 1e6, 3),
                }
                if args:
                    event["args"] = dict(args)
                events.append(event)
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


def trace_phase(name: str, **kw):
    """``with trace_phase("compute"): ...`` on the default tracer
    (keywords as :meth:`PhaseTracer.phase`)."""
    return _TRACER.phase(name, **kw)
