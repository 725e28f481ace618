"""Fleet-wide distributed tracing: follow one request across every
process (the port's copy of ``distlr_tpu/obs/dtrace.py``, stdlib only).

:class:`~distlr_tpu_torch.obs.tracing.PhaseTracer` answers "where did
this process spend its time"; this module answers the question that
stops at process boundaries: where did this request, push or label spend
its time across the router, the engine replica, the PS client, the
native KV server and the feedback loop?  Dapper-style: a
:class:`TraceContext` (trace_id, span_id, sampled flag) propagates
through every hop:

* **serve line protocol**: the router mints a context per scoring
  request and forwards ``TRACE <tid>/<sid> <line>``; replicas (and
  nested routers) join it, and replies never carry the prefix.
* **KV wire**: a negotiated flag bit and a 16-byte trailer
  (``kv_protocol.h`` ``kTraced``) stamp an op, and ``distlr_kv_server
  --trace_journal`` logs a handler span joined to the client's op span.
  A group that does not advertise the capability degrades to client-only
  spans, and a zero sample rate leaves the wire byte-identical.
* **feedback loop**: the spool entry remembers its request's context,
  the LABEL join continues it, the shard sidecars carry it to the online
  trainer, and the trainer's flush push stamps it back onto the KV wire.

Two sinks a process:

* **span journal**: sampled spans append (bounded) to
  ``<obs_run_dir>/spans/<role>-<rank>.jsonl``; ``launch trace-agg``
  merges every rank's journal (Python and native, one schema) into one
  Chrome/Perfetto trace, aligning the hosts' clocks by the kHello clock
  probe and putting the chaos proxy's fault events on their track.
* **flight recorder**: a bounded in-memory ring of recent spans (sampled
  or not) and events.  ``launch flightrec`` (and, in the JAX package, an
  alert edge of its aggregator) drops a trigger file into
  ``<run_dir>/flightrec/`` and every configured process dumps its ring.

Sampling is a pure hash of the trace id, so every process (of either
package) that sees a context makes the same decision.  Journals, tokens,
the merged document and the three ``distlr_trace_*`` series are the JAX
module's, name for name.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import random
import threading
import time
from collections import deque

from distlr_tpu_torch.obs.registry import get_registry
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_reg = get_registry()
_SPANS = _reg.counter(
    "distlr_trace_spans_total",
    "distributed-trace spans recorded, by journal destination "
    "(sampled -> span journal + flight ring; unsampled -> ring only)",
    labelnames=("sampled",),
)
# children resolved once: .labels() takes the registry lock, and the
# ring path runs per request even at sample 0
_SPANS_SAMPLED = _SPANS.labels(sampled="true")
_SPANS_UNSAMPLED = _SPANS.labels(sampled="false")
_JOURNAL_DROPPED = _reg.counter(
    "distlr_trace_journal_dropped_total",
    "sampled spans dropped after the per-process span-journal cap",
)
_FLIGHT_DUMPS = _reg.counter(
    "distlr_trace_flightrec_dumps_total",
    "flight-recorder ring dumps (alert-triggered or on demand)",
)

#: per-process span-journal entry cap (the native server uses the same
#: figure; a runaway sampled stream bounds disk, loudly)
MAX_JOURNAL_SPANS = 200_000

#: thread ident -> stack of active span NAMES, readable from OTHER
#: threads (a threading.local cannot be): what the sampling profiler
#: (distlr_tpu_torch.obs.profile) reads to tag each stack sample with the innermost span
#: running on the sampled thread, so flamegraphs split by serve.request
#: vs train.step vs feedback.*.  Mutated only by
#: the owning thread (list append/pop are atomic under the GIL); readers
#: tolerate the race.
_ACTIVE_NAMES: dict[int, list] = {}

#: callables merged into every flight-recorder dump document —
#: ``fn(reason, seq) -> dict`` — so sibling subsystems (the continuous
#: profiler) can cross-reference their own incident artifacts from the
#: flight dump without dtrace importing them.
_FLIGHT_INFO: list = []


def active_span_name(tid: int) -> str | None:
    """Innermost active span name on thread ``tid`` (None when that
    thread is outside every span).  Racy by design — a profiler reading
    a thread mid-pop may see a just-closed span; one sample of drift is
    noise at any sane sampling rate."""
    try:
        return _ACTIVE_NAMES[tid][-1]
    except (KeyError, IndexError):
        return None


def register_flight_info(fn) -> None:
    """Register a provider whose dict is merged into every flight dump
    (idempotent per function object)."""
    if fn not in _FLIGHT_INFO:
        _FLIGHT_INFO.append(fn)


def unregister_flight_info(fn) -> None:
    with contextlib.suppress(ValueError):
        _FLIGHT_INFO.remove(fn)
#: flight-recorder ring capacity (spans + events kept per process)
FLIGHT_CAPACITY = 4096
#: flight-recorder trigger filename inside <run_dir>/flightrec/
TRIGGER_NAME = "TRIGGER.json"


def _hex(v: int | None) -> str | None:
    return None if v is None else f"{v:016x}"


class TraceContext:
    """One hop's view of a distributed trace: which trace, which span
    is current, and whether the trace is sampled (journal + propagate)
    or ring-only."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: int, span_id: int, sampled: bool):
        self.trace_id = int(trace_id)
        self.span_id = int(span_id)
        self.sampled = bool(sampled)

    def token(self) -> str:
        """Wire form of this context (the ``TRACE <token>`` prefix)."""
        return f"{self.trace_id:016x}/{self.span_id:016x}"

    def __repr__(self):  # debugging/test output
        return (f"TraceContext({self.token()}, "
                f"sampled={self.sampled})")


def parse_token(token: str) -> TraceContext:
    """Inverse of :meth:`TraceContext.token`.  A propagated context is
    by definition sampled (unsampled traces never cross the wire)."""
    tid, _, sid = token.partition("/")
    try:
        return TraceContext(int(tid, 16), int(sid, 16), True)
    except ValueError as e:
        raise ValueError(f"malformed trace token {token!r}") from e


def is_sampled(trace_id: int, rate: float) -> bool:
    """Deterministic sampling decision: a pure hash of the trace id, so
    every process agrees without coordination — the per-run sampler."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = hashlib.blake2b(int(trace_id).to_bytes(8, "little"),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") / 2.0 ** 64 < rate


class Span:
    """Handle yielded by :func:`span` while the block runs."""

    __slots__ = ("name", "ctx", "tags", "t0_wall", "t0_perf")

    def __init__(self, name: str, ctx: TraceContext, tags: dict | None):
        self.name = name
        self.ctx = ctx          # the CHILD context (this span's identity)
        self.tags = tags
        self.t0_wall = time.time()
        self.t0_perf = time.perf_counter()

    @property
    def span_id(self) -> int:
        return self.ctx.span_id


class _Tracer:
    """Per-process tracing state: config, thread-local context stack,
    span journal, flight ring, and the trigger watcher."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._rng = random.Random()
        self.configured = False
        self.sample = 0.0
        self.role = "proc"
        self.rank = 0
        self.run_dir: str | None = None
        self._journal_path: str | None = None
        self._journal_file = None
        self._journal_written = 0
        self._journal_unflushed = 0
        self._ring: deque = deque(maxlen=FLIGHT_CAPACITY)
        self._watcher: threading.Thread | None = None
        self._watch_stop = threading.Event()
        self._trigger_seq = -1
        self._atexit_installed = False

    # -- configuration -----------------------------------------------------
    def configure(self, run_dir: str | None, role: str, rank: int, *,
                  sample: float = 0.0,
                  flight_capacity: int = FLIGHT_CAPACITY) -> None:
        """Arm tracing for this process.  ``run_dir=None`` keeps the
        flight ring only (no journal, no trigger watcher).  Safe to call
        again (tests, multi-command processes): the journal re-targets
        and the watcher restarts."""
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        self.stop_watcher()
        with self._lock:
            self.sample = float(sample)
            self.role, self.rank = str(role), int(rank)
            self.run_dir = run_dir
            if self._journal_file is not None:
                self._journal_file.close()
                self._journal_file = None
            self._journal_path = None
            self._journal_written = 0
            self._journal_unflushed = 0
            self._ring = deque(maxlen=int(flight_capacity))
            self._trigger_seq = self._read_trigger_seq()
            self.configured = True
            if run_dir:
                d = os.path.join(run_dir, "spans")
                os.makedirs(d, exist_ok=True)
                self._journal_path = os.path.join(
                    d, f"{self.role}-{self.rank}.jsonl")
        if run_dir:
            self._journal_line({
                "type": "meta", "role": self.role, "rank": self.rank,
                "pid": os.getpid(), "sample": self.sample,
            })
            self._watch_stop.clear()
            self._watcher = threading.Thread(
                target=self._watch_loop, daemon=True,
                name="distlr-flightrec-watch")
            self._watcher.start()
        if not self._atexit_installed:
            import atexit  # noqa: PLC0415

            atexit.register(self.flush)
            self._atexit_installed = True

    def stop_watcher(self) -> None:
        self._watch_stop.set()
        w = self._watcher
        if w is not None and w.is_alive():
            w.join(timeout=2.0)
        self._watcher = None

    def reset_for_tests(self) -> None:
        """Back to the unconfigured state (journal closed, ring empty)."""
        self.stop_watcher()
        with self._lock:
            if self._journal_file is not None:
                self._journal_file.close()
                self._journal_file = None
            self.configured = False
            self.sample = 0.0
            self.run_dir = None
            self._journal_path = None
            self._journal_written = 0
            self._journal_unflushed = 0
            self._ring.clear()
        self._tls = threading.local()
        _ACTIVE_NAMES.clear()
        _FLIGHT_INFO.clear()

    # -- context stack -----------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> TraceContext | None:
        st = self._stack()
        return st[-1] if st else None

    @contextlib.contextmanager
    def use(self, ctx: TraceContext | None):
        """Install ``ctx`` as the thread's current context for the
        block (a no-op passthrough for ``None`` — callers never branch)."""
        if ctx is None:
            yield None
            return
        st = self._stack()
        st.append(ctx)
        try:
            yield ctx
        finally:
            st.pop()

    def new_trace(self) -> TraceContext | None:
        """Mint a root context (the router / front-end entry point).
        ``None`` until :meth:`configure` ran — unconfigured processes
        pay nothing."""
        if not self.configured:
            return None
        tid = self._rng.getrandbits(64) | 1
        return TraceContext(tid, 0, is_sampled(tid, self.sample))

    def current_ids(self) -> tuple[int, int] | None:
        """(trace_id, span_id) of the current SAMPLED context — what
        gets persisted into spool records and shard sidecars."""
        ctx = self.current()
        if ctx is None or not ctx.sampled:
            return None
        return (ctx.trace_id, ctx.span_id)

    def token(self) -> str | None:
        """Wire token of the current sampled context (``None``
        otherwise) — the serve-protocol ``TRACE`` prefix payload."""
        ctx = self.current()
        if ctx is None or not ctx.sampled:
            return None
        return ctx.token()

    # -- spans -------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, tags: dict | None = None,
             ctx: TraceContext | None = None):
        """Record one span under ``ctx`` (default: the current
        context).  With no context at all the block runs untraced and
        the manager yields ``None`` — call sites never branch."""
        parent = ctx if ctx is not None else self.current()
        if parent is None:
            yield None
            return
        child = TraceContext(parent.trace_id,
                             self._rng.getrandbits(64) | 1, parent.sampled)
        sp = Span(name, child, tags)
        st = self._stack()
        st.append(child)
        tid = threading.get_ident()
        names = _ACTIVE_NAMES.setdefault(tid, [])
        names.append(name)
        try:
            yield sp
        finally:
            names.pop()
            if not names:
                _ACTIVE_NAMES.pop(tid, None)
            st.pop()
            self._record(sp, parent.span_id or None)

    def record_span(self, name: str, ctx: TraceContext, t0_wall: float,
                    dur_s: float, tags: dict | None = None) -> TraceContext:
        """Record a span retrospectively (measured by the caller) and
        return its child context — how the online trainer attributes one
        shard-consume interval to each trace it carried."""
        child = TraceContext(ctx.trace_id, self._rng.getrandbits(64) | 1,
                             ctx.sampled)
        rec = self._span_doc(name, child, ctx.span_id or None,
                             t0_wall, dur_s, tags)
        self._sink(rec, child.sampled)
        return child

    def _record(self, sp: Span, parent_id: int | None) -> None:
        dur = time.perf_counter() - sp.t0_perf
        if not sp.ctx.sampled:
            # ring-only span: keep a compact tuple and defer the doc
            # formatting to dump time — this path runs per REQUEST even
            # at sample 0, and the flight dump is rare
            self._ring.append((sp.name, sp.ctx.trace_id, sp.ctx.span_id,
                               parent_id, sp.t0_wall, dur, sp.tags))
            _SPANS_UNSAMPLED.inc()
            return
        rec = self._span_doc(sp.name, sp.ctx, parent_id, sp.t0_wall, dur,
                             sp.tags)
        self._sink(rec, True)

    def _span_doc(self, name, ctx, parent_id, t0_wall, dur_s, tags) -> dict:
        return {
            "type": "span",
            "name": name,
            "trace": _hex(ctx.trace_id),
            "span": _hex(ctx.span_id),
            "parent": _hex(parent_id),
            "ts": round(t0_wall * 1e6, 1),
            "dur": round(max(dur_s, 0.0) * 1e6, 1),
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": dict(tags) if tags else {},
        }

    def _sink(self, rec: dict, sampled: bool) -> None:
        rec["sampled"] = bool(sampled)
        self._ring.append(rec)
        (_SPANS_SAMPLED if sampled else _SPANS_UNSAMPLED).inc()
        if sampled and self._journal_path is not None:
            self._journal_line({k: v for k, v in rec.items()
                                if k != "sampled"})

    def instant(self, name: str, tags: dict | None = None) -> None:
        """A zero-duration timeline marker, journaled unconditionally
        (the chaos proxy's fault events ride this so merged traces show
        'this retry was caused by fault #3' on the link's track)."""
        rec = {
            "type": "instant", "name": name,
            "ts": round(time.time() * 1e6, 1),
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": dict(tags) if tags else {},
        }
        self._ring.append(rec)
        if self._journal_path is not None:
            self._journal_line(rec)

    def event(self, name: str, **tags) -> None:
        """Flight-ring-only structured event (never journaled): cheap
        breadcrumbs for the postmortem dump."""
        self._ring.append({
            "type": "event", "name": name,
            "ts": round(time.time() * 1e6, 1), "args": tags,
        })

    def record_clock(self, peer: str, offset_s: float) -> None:
        """Journal a measured clock offset toward ``peer`` (host:port):
        trace-agg shifts that peer's journal timestamps by it."""
        if self._journal_path is not None:
            self._journal_line({"type": "clock", "peer": peer,
                                "offset_s": round(float(offset_s), 6)})

    # -- journal I/O -------------------------------------------------------
    def _journal_line(self, doc: dict) -> None:
        with self._lock:
            if self._journal_path is None:
                return
            if doc.get("type") == "span":
                if self._journal_written >= MAX_JOURNAL_SPANS:
                    _JOURNAL_DROPPED.inc()
                    return
                self._journal_written += 1
            try:
                if self._journal_file is None:
                    self._journal_file = open(self._journal_path, "a")
                self._journal_file.write(json.dumps(doc) + "\n")
                # batched flush: a per-line flush cost full-sample runs
                # ~20% QPS; readers (trace-agg, tests) call flush()
                # first, atexit flushes the tail, and a torn final line
                # is skipped by the merge reader anyway
                self._journal_unflushed += 1
                if self._journal_unflushed >= 64:
                    self._journal_file.flush()
                    self._journal_unflushed = 0
            except OSError:
                pass  # tracing must never fail the traced work

    def flush(self) -> None:
        with self._lock:
            if self._journal_file is not None:
                with contextlib.suppress(OSError):
                    self._journal_file.flush()
                self._journal_unflushed = 0

    # -- flight recorder ---------------------------------------------------
    def _trigger_path(self) -> str | None:
        if not self.run_dir:
            return None
        return os.path.join(self.run_dir, "flightrec", TRIGGER_NAME)

    def _read_trigger_seq(self) -> int:
        path = self._trigger_path()
        if path is None:
            return -1
        try:
            with open(path) as f:
                return int(json.load(f).get("seq", -1))
        except (OSError, ValueError):
            return -1

    def _watch_loop(self) -> None:
        while not self._watch_stop.wait(0.25):
            path = self._trigger_path()
            if path is None:
                return
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            seq = int(doc.get("seq", -1))
            if seq > self._trigger_seq:
                self._trigger_seq = seq
                self.dump_flight(reason=str(doc.get("alert", "trigger")),
                                 seq=seq)

    @staticmethod
    def _ring_doc(rec) -> dict:
        """Ring entry -> dump schema (unsampled spans ride the ring as
        compact tuples; everything else is already a doc)."""
        if isinstance(rec, dict):
            return rec
        name, tid, sid, parent, ts, dur, tags = rec
        return {
            "type": "span", "name": name, "trace": _hex(tid),
            "span": _hex(sid), "parent": _hex(parent),
            "ts": round(ts * 1e6, 1), "dur": round(max(dur, 0.0) * 1e6, 1),
            "args": dict(tags) if tags else {}, "sampled": False,
        }

    def dump_flight(self, reason: str = "manual",
                    seq: int | None = None) -> str | None:
        """Write the ring to ``<run_dir>/flightrec/<role>-<rank>-<n>.json``
        — the seconds BEFORE now, sampled or not.  Returns the path
        (None without a run dir)."""
        if not self.run_dir:
            return None
        d = os.path.join(self.run_dir, "flightrec")
        os.makedirs(d, exist_ok=True)
        if seq is None:
            seq = self._trigger_seq + 1
        path = os.path.join(d, f"{self.role}-{self.rank}-{seq}.json")
        doc = {
            "role": self.role, "rank": self.rank, "pid": os.getpid(),
            "reason": reason, "dumped_at": time.time(),
            "spans": [self._ring_doc(r) for r in list(self._ring)],
        }
        for fn in list(_FLIGHT_INFO):
            # cross-references from sibling subsystems (e.g. the
            # continuous profiler names the incident's burst-window
            # journal) — a broken provider must not lose the dump
            try:
                doc.update(fn(reason, seq) or {})
            except Exception:  # noqa: BLE001
                log.exception("flight-info provider %r failed", fn)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            return None
        _FLIGHT_DUMPS.inc()
        log.info("flight recorder dumped %d entries -> %s (%s)",
                 len(doc["spans"]), path, reason)
        return path


_TRACER = _Tracer()


# -- module-level API (what every instrumented call site imports) -----------

def configure(run_dir: str | None, role: str, rank: int, *,
              sample: float = 0.0) -> None:
    _TRACER.configure(run_dir, role, rank, sample=sample)


def is_configured() -> bool:
    return _TRACER.configured


def sample_rate() -> float:
    return _TRACER.sample


def new_trace() -> TraceContext | None:
    return _TRACER.new_trace()


def current() -> TraceContext | None:
    return _TRACER.current()


def current_ids() -> tuple[int, int] | None:
    return _TRACER.current_ids()


def token() -> str | None:
    return _TRACER.token()


def use(ctx: TraceContext | None):
    return _TRACER.use(ctx)


def span(name: str, tags: dict | None = None,
         ctx: TraceContext | None = None):
    return _TRACER.span(name, tags, ctx)


def record_span(name: str, ctx: TraceContext, t0_wall: float, dur_s: float,
                tags: dict | None = None) -> TraceContext:
    return _TRACER.record_span(name, ctx, t0_wall, dur_s, tags)


def instant(name: str, tags: dict | None = None) -> None:
    _TRACER.instant(name, tags)


def event(name: str, **tags) -> None:
    _TRACER.event(name, **tags)


def record_clock(peer: str, offset_s: float) -> None:
    _TRACER.record_clock(peer, offset_s)


def flush() -> None:
    _TRACER.flush()


def flight_dump(reason: str = "manual") -> str | None:
    return _TRACER.dump_flight(reason=reason)


def reset_for_tests() -> None:
    _TRACER.reset_for_tests()


def trigger(run_dir: str, alert: str = "manual") -> str:
    """Drop/refresh the flight-recorder trigger file under ``run_dir``:
    every process configured on that run dir dumps its ring within one
    watcher poll.  Called by the fleet aggregator when a
    ``distlr_alert_*`` gauge starts firing, and by ``launch flightrec``
    on demand."""
    d = os.path.join(run_dir, "flightrec")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, TRIGGER_NAME)
    seq = 0
    try:
        with open(path) as f:
            seq = int(json.load(f).get("seq", -1)) + 1
    except (OSError, ValueError):
        pass
    doc = {"seq": seq, "alert": str(alert), "ts": time.time()}
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# trace-agg: merge per-rank span journals into one Chrome/Perfetto trace
# ---------------------------------------------------------------------------

def read_journal(path: str) -> list[dict]:
    """Tolerant JSONL journal reader (torn tail lines skipped), shared
    by trace-agg and the incident engine's artifact collectors."""
    return _read_journal(path)


def _read_journal(path: str) -> list[dict]:
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue  # a line torn mid-write: skip, keep the rest
    except OSError:
        pass
    return out


def merge_run_dirs(run_dirs, *, align_clocks: bool = True) -> dict:
    """Merge every ``<run_dir>/spans/*.jsonl`` journal (Python AND
    native — one schema) into a single Chrome trace-event document.

    * each journal becomes one named process track
      (``process_name = <file stem>``);
    * spans become ``ph: "X"`` complete events carrying
      ``args.trace/span/parent`` so Perfetto queries can follow one
      trace id end to end;
    * ``instant`` records (the chaos proxy's fault events) become
      ``ph: "i"`` markers on their emitting process's track, with the
      faulted op's trace id in args when the frame carried one;
    * clock-skew alignment: ``clock`` records (the client's kHello
      probe) name a peer ``host:port`` and its measured offset; any
      journal whose ``meta.listen`` matches is shifted onto the
      observing client's clock.
    """
    if isinstance(run_dirs, str):
        run_dirs = [run_dirs]
    journals: list[tuple[str, list[dict]]] = []
    seen = set()
    for d in run_dirs:
        spans_dir = os.path.join(d, "spans")
        if not os.path.isdir(spans_dir):
            continue
        for name in sorted(os.listdir(spans_dir)):
            if not name.endswith(".jsonl"):
                continue
            path = os.path.join(spans_dir, name)
            stem = name[:-len(".jsonl")]
            key = stem
            n = 1
            while key in seen:  # same role-rank in two federated dirs
                n += 1
                key = f"{stem}#{n}"
            seen.add(key)
            journals.append((key, _read_journal(path)))

    # clock offsets observed by any client, keyed on the peer's port
    # (the meta.listen host may be 0.0.0.0 while the client dialed a
    # concrete address — the port is the stable join key on one host)
    offsets: dict[str, float] = {}
    if align_clocks:
        for _stem, recs in journals:
            for r in recs:
                if r.get("type") == "clock" and r.get("peer"):
                    port = str(r["peer"]).rpartition(":")[2]
                    offsets[port] = float(r.get("offset_s", 0.0))

    events: list[dict] = []
    n_spans = 0
    traces: set[str] = set()
    for pid, (stem, recs) in enumerate(journals, start=1):
        shift_us = 0.0
        for r in recs:
            if r.get("type") == "meta" and r.get("listen"):
                port = str(r["listen"]).rpartition(":")[2]
                if port in offsets:
                    # server journal: subtract its measured offset so
                    # its timestamps land on the client's clock
                    shift_us = -offsets[port] * 1e6
                break
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": stem}})
        for r in recs:
            kind = r.get("type")
            if kind == "span":
                args = dict(r.get("args") or {})
                args["trace"] = r.get("trace")
                args["span"] = r.get("span")
                args["parent"] = r.get("parent")
                events.append({
                    "name": r.get("name", "?"), "cat": "dtrace", "ph": "X",
                    "pid": pid, "tid": r.get("tid", 0),
                    "ts": round(float(r.get("ts", 0.0)) + shift_us, 1),
                    "dur": float(r.get("dur", 0.0)),
                    "args": args,
                })
                n_spans += 1
                if r.get("trace"):
                    traces.add(r["trace"])
            elif kind == "instant":
                events.append({
                    "name": r.get("name", "?"), "cat": "dtrace", "ph": "i",
                    "pid": pid, "tid": r.get("tid", 0),
                    "ts": round(float(r.get("ts", 0.0)) + shift_us, 1),
                    "s": "p",
                    "args": dict(r.get("args") or {}),
                })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "distlr_tpu_torch.obs.dtrace",
            "journals": [stem for stem, _ in journals],
            "spans": n_spans,
            "trace_ids": sorted(traces),
            "clock_offsets": offsets,
        },
    }


def write_merged_trace(run_dirs, out_path: str) -> dict:
    """Merge and write atomically; returns the document (its
    ``otherData`` carries span/trace counts for callers to report)."""
    doc = merge_run_dirs(run_dirs)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = f"{out_path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out_path)
    return doc
