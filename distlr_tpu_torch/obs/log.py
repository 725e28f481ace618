"""Fleet-wide structured logging (the port's copy of
``distlr_tpu/obs/log.py``, stdlib only).

* a :class:`FleetLogger` journals JSONL records to
  ``<obs_run_dir>/logs/<role>-<rank>.jsonl``: bounded (the dtrace
  span-journal cap), batch-flushed (WARN+ records flush eagerly so an
  incident collector reading mid-flight sees them), and rate-limit
  deduped: identical ``(level, logger, template)`` records inside the
  dedupe window collapse into one journaled record carrying a
  ``suppressed`` count;
* each record is stamped with the active dtrace trace and span ids
  (:func:`distlr_tpu_torch.obs.dtrace.current_ids`), so ``launch logs
  --trace <id>`` pulls one request's log and span story across ranks;
* a bounded in-memory ring keeps the most recent records whatever the
  journal level, as the flight recorder's span ring does;
* records count into ``distlr_log_records_total{level,role}`` (and the
  suppressed and dropped counters), so the fleet scrape sees each rank's
  ERROR rate without reading a file.

The human-readable stderr path is untouched: the loggers
``distlr_tpu_torch.utils.logging.get_logger`` hands out keep their stderr
handler, and this module attaches one extra :class:`logging.Handler` to
the ``distlr_tpu_torch`` and ``distlr_tpu_torch.*`` loggers that tees
every record into the journal (never the JAX package's ``distlr_tpu*``
loggers, so the two packages' journals stay apart in one process).
Shared state is guarded by a :mod:`distlr_tpu_torch.sync` lock; the
monitoring counters are deliberately lock-free reads.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging as _stdlib_logging
import os
import time

from distlr_tpu_torch import sync
from distlr_tpu_torch.obs import dtrace
from distlr_tpu_torch.obs.registry import get_registry
from distlr_tpu_torch.utils import logging as _ulog

_reg = get_registry()
_RECORDS = _reg.counter(
    "distlr_log_records_total",
    "structured log records journaled, by level and role (suppressed "
    "duplicates and below-level records are counted separately)",
    labelnames=("level", "role"),
)
_SUPPRESSED = _reg.counter(
    "distlr_log_suppressed_total",
    "log records collapsed into a dedupe summary instead of journaled, "
    "by level and role",
    labelnames=("level", "role"),
)
_DROPPED = _reg.counter(
    "distlr_log_journal_dropped_total",
    "records dropped after the per-process log-journal cap (the ring "
    "and metrics keep running)",
)

#: record levels, weakest first; numbers mirror the stdlib so stdlib
#: LogRecords map without a table
LEVELS = ("debug", "info", "warning", "error")
_LEVEL_NO = {"debug": 10, "info": 20, "warning": 30, "error": 40}

#: per-process record cap of the journal (dtrace.MAX_JOURNAL_SPANS
#: discipline: a runaway log stream bounds disk, loudly)
MAX_JOURNAL_RECORDS = 200_000
#: default bounded in-memory ring capacity
RING_CAPACITY = 2048
#: default dedupe window seconds (0 journals every record)
DEDUPE_WINDOW_S = 5.0
#: journal lines buffered before a flush (the span journal's budget discipline);
#: WARN+ records flush eagerly regardless
FLUSH_EVERY = 64
#: dedupe-table size bound: past this, expired entries with nothing
#: pending are pruned on insert (stdlib templates are a bounded set,
#: but direct emit() callers with varying messages are not)
DEDUPE_TABLE_MAX = 4096


def _level_name(levelno: int) -> str:
    if levelno >= 40:
        return "error"
    if levelno >= 30:
        return "warning"
    if levelno >= 20:
        return "info"
    return "debug"


class FleetLogger:
    """Per-process structured log sink: dedupe table, bounded ring, and
    a JSONL journal.  ``run_dir=None`` keeps the ring + metrics only
    (no journal) — what bench rows and unit tests use."""

    def __init__(self, run_dir: str | None, role: str, rank: int, *,
                 level: str = "info", ring: int = RING_CAPACITY,
                 dedupe_s: float = DEDUPE_WINDOW_S):
        if level not in LEVELS:
            raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
        if ring < 1:
            raise ValueError(f"ring must be >= 1, got {ring}")
        if dedupe_s < 0:
            raise ValueError(f"dedupe_s must be >= 0, got {dedupe_s}")
        self.run_dir = run_dir
        self.role, self.rank = str(role), int(rank)
        self.level = level
        self.levelno = _LEVEL_NO[level]
        self.dedupe_s = float(dedupe_s)
        self._lock = sync.Lock()
        self._ring: collections.deque = collections.deque(maxlen=int(ring))
        #: dedupe key -> [window_start_monotonic, suppressed_count]
        self._dedupe: dict[tuple, list] = {}
        self._journal_path: str | None = None
        self._journal_file = None
        self._journal_written = 0
        self._journal_unflushed = 0
        # monitoring counters: written under _lock, read lock-free by
        # stats() (monotonic ints; a racing reader sees the previous
        # record's values — audited in the concurrency baseline, raced
        # by the log_ring_incident_assemble schedcheck scenario)
        self.records_total = 0
        self.suppressed_total = 0
        # metric children resolved once (.labels() takes the registry
        # lock, and emit runs on every record)
        self._rec_children = {lv: _RECORDS.labels(level=lv, role=self.role)
                              for lv in LEVELS}
        self._sup_children = {lv: _SUPPRESSED.labels(level=lv,
                                                     role=self.role)
                              for lv in LEVELS}
        if run_dir:
            d = os.path.join(run_dir, "logs")
            os.makedirs(d, exist_ok=True)
            self._journal_path = os.path.join(
                d, f"{self.role}-{self.rank}.jsonl")
            self._journal_line({
                "type": "meta", "role": self.role, "rank": self.rank,
                "pid": os.getpid(), "level": self.level,
            }, eager=True)

    # -- the emit path -----------------------------------------------------
    def emit(self, level: str, msg: str, *, logger: str = "distlr_tpu_torch",
             template: str | None = None, args: dict | None = None) -> dict:
        """Record one structured log record.  ``template`` is the
        dedupe identity (the pre-format message for stdlib records);
        it defaults to ``msg``.  Returns the record dict (its
        ``suppressed`` key is absent unless it closed a dedupe
        window)."""
        if level not in LEVELS:
            level = _level_name(_LEVEL_NO.get(level, 20))
        rec = {
            "type": "record",
            "ts": round(time.time(), 6),
            "level": level,
            "role": self.role,
            "rank": self.rank,
            "logger": logger,
            "msg": str(msg),
        }
        ids = dtrace.current_ids()
        if ids is not None:
            rec["trace"] = f"{ids[0]:016x}"
            rec["span"] = f"{ids[1]:016x}"
        if args:
            rec["args"] = dict(args)
        levelno = _LEVEL_NO[level]
        key = (level, logger, template if template is not None else str(msg))
        now_mono = sync.monotonic()
        with self._lock:
            self._ring.append(rec)
            if levelno < self.levelno:
                return rec  # ring-only: below the journal level
            if self.dedupe_s > 0:
                st = self._dedupe.get(key)
                if st is not None and now_mono - st[0] < self.dedupe_s:
                    st[1] += 1
                    self.suppressed_total += 1
                    self._sup_children[level].inc()
                    return rec
                if st is not None and st[1] > 0:
                    # window expired with duplicates folded in: this
                    # record closes it and carries the count
                    rec["suppressed"] = st[1]
                if len(self._dedupe) >= DEDUPE_TABLE_MAX:
                    # entries with a pending count survive the prune:
                    # their count still has to ride the key's next record
                    cutoff = now_mono - self.dedupe_s
                    for k in [k for k, s in self._dedupe.items()
                              if s[0] < cutoff and not s[1]]:
                        del self._dedupe[k]
                self._dedupe[key] = [now_mono, 0]
            self.records_total += 1
            self._rec_children[level].inc()
            # WARN+ flushes eagerly: the incident collector reads other
            # processes' journals seconds after the alert edge, and an
            # error buried in a 64-line buffer would miss its bundle
            self._journal_line_locked(rec, eager=levelno >= 30)
        return rec

    def handle_stdlib(self, record: _stdlib_logging.LogRecord) -> None:
        """Bridge one stdlib LogRecord (the tee handler's path).  The
        record's pre-format template is the dedupe identity, so a
        formatted message varying per occurrence ("rank 3 timed out")
        still collapses."""
        try:
            msg = record.getMessage()
        except Exception:  # noqa: BLE001 — logging must never fail work
            msg = str(record.msg)
        self.emit(_level_name(record.levelno), msg, logger=record.name,
                  template=str(record.msg))

    # -- journal I/O -------------------------------------------------------
    def _journal_line(self, doc: dict, *, eager: bool = False) -> None:
        with self._lock:
            self._journal_line_locked(doc, eager=eager)

    def _journal_line_locked(self, doc: dict, *, eager: bool = False) -> None:
        if self._journal_path is None:
            return
        if doc.get("type") == "record":
            if self._journal_written >= MAX_JOURNAL_RECORDS:
                _DROPPED.inc()
                return
            self._journal_written += 1
        try:
            if self._journal_file is None:
                self._journal_file = open(self._journal_path, "a")
            self._journal_file.write(json.dumps(doc) + "\n")
            self._journal_unflushed += 1
            if eager or self._journal_unflushed >= FLUSH_EVERY:
                self._journal_file.flush()
                self._journal_unflushed = 0
        except OSError:
            pass  # logging must never fail the logged work

    def flush(self) -> None:
        with self._lock:
            if self._journal_file is not None:
                with contextlib.suppress(OSError):
                    self._journal_file.flush()
                self._journal_unflushed = 0

    def close(self) -> None:
        with self._lock:
            if self._journal_file is not None:
                with contextlib.suppress(OSError):
                    self._journal_file.flush()
                    self._journal_file.close()
                self._journal_file = None

    # -- reads -------------------------------------------------------------
    def tail(self, n: int = 50) -> list[dict]:
        """The most recent ``n`` ring records (every level — the ring
        keeps what the journal level filtered out)."""
        with self._lock:
            recs = list(self._ring)
        return recs[-n:]

    def stats(self) -> dict:
        """Lock-free monitoring snapshot (``AutopilotDaemon.status()``
        stance: monotonic ints, a racing reader sees the previous
        record's values — audited in the concurrency baseline)."""
        return {
            "records": self.records_total,
            "suppressed": self.suppressed_total,
            "journal": self._journal_path,
        }

    def flight_info(self, reason: str, seq: int | None) -> dict:
        """dtrace flight-dump cross-reference: where this process's log
        journal lives, so the flight dump and the incident bundle name
        the same file."""
        return {"log_journal": self._journal_path}


# ---------------------------------------------------------------------------
# the stdlib tee handler + module singleton (what _obs_scope arms)
# ---------------------------------------------------------------------------


class _JournalHandler(_stdlib_logging.Handler):
    """The one extra handler attached to every ``distlr_tpu_torch*`` stdlib
    logger while a FleetLogger is configured: tees each record into the
    journal without touching the stderr handler or its format."""

    def __init__(self, fleet: FleetLogger):
        super().__init__(level=0)
        self.fleet = fleet

    def emit(self, record: _stdlib_logging.LogRecord) -> None:
        try:
            self.fleet.handle_stdlib(record)
        except Exception:  # noqa: BLE001 — logging must never fail work
            pass


_LOGGER: FleetLogger | None = None
_HANDLER: _JournalHandler | None = None
_ATEXIT_INSTALLED = False


def _provider() -> _stdlib_logging.Handler | None:
    return _HANDLER


def _attach_everywhere(handler: _JournalHandler) -> None:
    """Attach to every live ``distlr_tpu_torch*`` logger.  Loggers created
    AFTER configure get the handler through the get_logger provider
    hook (:func:`distlr_tpu_torch.utils.logging.register_extra_handler`)."""
    for name, logger in list(
            _stdlib_logging.Logger.manager.loggerDict.items()):
        if not isinstance(logger, _stdlib_logging.Logger):
            continue
        if name == "distlr_tpu_torch" or name.startswith("distlr_tpu_torch."):
            if handler not in logger.handlers:
                logger.addHandler(handler)


def _detach_everywhere(handler: _JournalHandler) -> None:
    for logger in list(_stdlib_logging.Logger.manager.loggerDict.values()):
        if isinstance(logger, _stdlib_logging.Logger) \
                and handler in logger.handlers:
            logger.removeHandler(handler)


def configure(run_dir: str | None, role: str, rank: int, *,
              level: str = "info", ring: int = RING_CAPACITY,
              dedupe_s: float = DEDUPE_WINDOW_S) -> FleetLogger:
    """Arm (or re-arm) this process's structured log sink and tee every
    ``distlr_tpu_torch*`` stdlib logger into it.  Safe to call again (tests,
    multi-command processes): the previous sink detaches and flushes
    first."""
    global _LOGGER, _HANDLER, _ATEXIT_INSTALLED
    if _LOGGER is not None:
        stop()
    _LOGGER = FleetLogger(run_dir, role, rank, level=level, ring=ring,
                          dedupe_s=dedupe_s)
    _HANDLER = _JournalHandler(_LOGGER)
    _attach_everywhere(_HANDLER)
    _ulog.register_extra_handler(_provider)
    dtrace.register_flight_info(_LOGGER.flight_info)
    if not _ATEXIT_INSTALLED:
        import atexit  # noqa: PLC0415

        atexit.register(flush)
        _ATEXIT_INSTALLED = True
    return _LOGGER


def is_configured() -> bool:
    return _LOGGER is not None


def fleet_logger() -> FleetLogger | None:
    return _LOGGER


def emit(level: str, msg: str, *, logger: str = "distlr_tpu_torch",
         args: dict | None = None) -> dict | None:
    """Module-level emit (debug-level structured records, CLI paths):
    a no-op returning None until :func:`configure` ran."""
    if _LOGGER is None:
        return None
    return _LOGGER.emit(level, msg, logger=logger, args=args)


def flush() -> None:
    if _LOGGER is not None:
        _LOGGER.flush()


def stop() -> None:
    global _LOGGER, _HANDLER
    if _HANDLER is not None:
        _detach_everywhere(_HANDLER)
        _HANDLER = None
    _ulog.unregister_extra_handler(_provider)
    if _LOGGER is not None:
        dtrace.unregister_flight_info(_LOGGER.flight_info)
        _LOGGER.close()
        _LOGGER = None


def reset_for_tests() -> None:
    stop()


# ---------------------------------------------------------------------------
# journal reading (the `launch logs` CLI + the incident collector)
# ---------------------------------------------------------------------------


def read_journal(path: str) -> list[dict]:
    """One journal's records (meta lines skipped; torn tail lines
    skipped, like every obs merge reader)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue
                if doc.get("type") == "record":
                    out.append(doc)
    except OSError:
        pass
    return out


def read_records(run_dirs, *, level: str | None = None,
                 grep: str | None = None, trace: str | None = None,
                 since: float | None = None, until: float | None = None,
                 limit: int | None = None) -> list[dict]:
    """Merge every ``<run_dir>/logs/*.jsonl`` journal into one
    time-ordered record list, optionally filtered by minimum level,
    substring, trace id, and a time window.  The fleet-wide query
    behind ``launch logs`` and the incident bundle's log collection."""
    if isinstance(run_dirs, str):
        run_dirs = [run_dirs]
    min_no = _LEVEL_NO[level] if level else 0
    want_trace = trace.lower().lstrip("0") if trace else None
    out: list[dict] = []
    for d in run_dirs:
        logs_dir = os.path.join(d, "logs")
        if not os.path.isdir(logs_dir):
            continue
        for name in sorted(os.listdir(logs_dir)):
            if not name.endswith(".jsonl"):
                continue
            for rec in read_journal(os.path.join(logs_dir, name)):
                if _LEVEL_NO.get(rec.get("level"), 0) < min_no:
                    continue
                ts = rec.get("ts", 0.0)
                if since is not None and ts < since:
                    continue
                if until is not None and ts > until:
                    continue
                if grep and grep not in rec.get("msg", ""):
                    continue
                if want_trace is not None and \
                        str(rec.get("trace", "")).lstrip("0") != want_trace:
                    continue
                out.append(rec)
    out.sort(key=lambda r: r.get("ts", 0.0))
    if limit is not None and limit > 0:
        out = out[-limit:]
    return out
