"""Fleet-wide continuous profiling (the port's copy of
``distlr_tpu/obs/profile.py``, stdlib only).

A stdlib sampling profiler, a daemon thread walking
``sys._current_frames()`` at a default ~19 Hz, folds every thread's
stack into a bounded table and journals aggregation windows to
``<obs_run_dir>/profiles/<role>-<rank>.jsonl``.  Each sample is tagged
with the innermost active dtrace span on the sampled thread
(:func:`distlr_tpu_torch.obs.dtrace.active_span_name`), so flamegraphs
split by ``serve.request`` vs ``train.step`` vs ``feedback.*`` though
the sampler knows nothing of roles.

Two capture regimes:

* **always-on**: the default rate runs for the life of the process and
  journals one window doc each ``window_s``;
* **burst**: the edge-triggered trigger file the flight recorder uses
  (``<run_dir>/flightrec/TRIGGER.json``, dropped by ``launch obs-agg``
  when a ``distlr_alert_*`` gauge starts firing, or by ``launch
  flightrec`` / ``launch incident --trigger``) switches the sampler to
  ``burst_hz`` for ``burst_s`` seconds, then closes exactly one
  high-resolution window stamped with the incident sequence number;
  the flight dump names this journal and the window names the dump.
  ``launch profrec`` drops a profiler-only trigger
  (``<run_dir>/profiles/TRIGGER.json``) without a flight dump.

``launch prof-agg`` merges every rank's journal (Python samplers and
the native ``distlr_kv_server``'s per-handler CPU windows,
``--prof_journal``, one ``profwindow`` schema) into a fleet-wide
collapsed-stack file and a speedscope JSON with one track per
``<role>-<rank>`` journal.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from distlr_tpu_torch.obs import dtrace
from distlr_tpu_torch.obs.registry import get_registry
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_reg = get_registry()
_SAMPLES = _reg.counter(
    "distlr_prof_samples_total",
    "sampling-profiler stack samples taken (one per observed thread per "
    "tick)",
)
_WINDOWS = _reg.counter(
    "distlr_prof_windows_total",
    "profile aggregation windows journaled, by capture regime",
    labelnames=("kind",),
)
_STACKS_DROPPED = _reg.counter(
    "distlr_prof_stacks_dropped_total",
    "samples folded into the (overflow) bucket after the per-window "
    "distinct-stack cap",
)
_WINDOWS_DROPPED = _reg.counter(
    "distlr_prof_windows_dropped_total",
    "profile windows dropped after the per-process journal cap "
    "(in-memory aggregation keeps running)",
)
_BURSTS = _reg.counter(
    "distlr_prof_bursts_total",
    "high-Hz burst captures begun (alert-edge incidents + manual "
    "`launch profrec` triggers)",
)
_HZ_GAUGE = _reg.gauge(
    "distlr_prof_hz",
    "current sampling rate of the continuous profiler (rises to the "
    "burst rate during an incident capture)",
)

#: default always-on sampling rate.  19 Hz is deliberately prime-ish:
#: a rate that divides common loop periods (10/20/100 Hz) would alias —
#: sampling the same phase of a periodic loop every time and reporting
#: one frame as 100% of a workload that merely shares its period.
DEFAULT_HZ = 19.0
#: default seconds of aggregation per journaled window
DEFAULT_WINDOW_S = 10.0
#: burst regime: rate and duration of the once-per-incident capture
BURST_HZ = 97.0
BURST_S = 3.0
#: distinct folded stacks kept per window; the excess folds into one
#: "(overflow)" bucket so a pathological workload bounds memory + disk
MAX_STACKS = 5000
#: frames kept per sampled stack (deeper recursion truncates, loudly,
#: inside the folded key itself)
MAX_DEPTH = 64
#: per-process journal window cap (like dtrace.MAX_JOURNAL_SPANS: a
#: runaway journal bounds disk, loudly)
MAX_JOURNAL_WINDOWS = 20_000
#: profiler-only trigger filename inside <run_dir>/profiles/
TRIGGER_NAME = "TRIGGER.json"


def _frame_name(code) -> str:
    """``module.function`` — no line numbers, so one logical frame folds
    into one flamegraph node instead of fragmenting per call site."""
    mod = os.path.splitext(os.path.basename(code.co_filename))[0]
    return f"{mod}.{code.co_name}"


def fold_stack(frame, tag: str | None, max_depth: int = MAX_DEPTH) -> str:
    """One thread's frame chain -> a semicolon-folded stack string,
    root-first, prefixed with the dtrace span tag (``-`` when the
    thread is outside every span) — the classic collapsed flamegraph
    format, one line-atom per sample."""
    parts = []
    depth = 0
    f = frame
    while f is not None and depth < max_depth:
        parts.append(_frame_name(f.f_code))
        f = f.f_back
        depth += 1
    if f is not None:
        parts.append("(truncated)")
    parts.append(tag or "-")
    parts.reverse()
    return ";".join(parts)


class SamplingProfiler:
    """Per-process continuous profiler: one daemon thread, two trigger
    watchers, a bounded folded-stack table, and a JSONL window journal.

    ``run_dir=None`` keeps the in-memory aggregate only (no journal, no
    burst triggers) — the mode bench rows use for their
    ``profile_top_frames`` snapshot.
    """

    def __init__(self, run_dir: str | None, role: str, rank: int, *,
                 hz: float = DEFAULT_HZ, window_s: float = DEFAULT_WINDOW_S,
                 burst_hz: float = BURST_HZ, burst_s: float = BURST_S,
                 max_stacks: int = MAX_STACKS):
        if hz <= 0:
            raise ValueError(f"hz must be positive, got {hz}")
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        self.run_dir = run_dir
        self.role, self.rank = str(role), int(rank)
        self.hz = float(hz)
        self.window_s = float(window_s)
        self.burst_hz = max(float(burst_hz), self.hz)
        self.burst_s = float(burst_s)
        self.max_stacks = int(max_stacks)
        self._lock = threading.Lock()
        self._table: dict[str, int] = {}
        self._window_t0 = time.time()
        self._window_samples = 0
        self._window_hz = self.hz
        #: lifetime aggregate (never cleared by window flushes) — what
        #: ``top_frames`` answers from, journal or not
        self._lifetime: dict[str, int] = {}
        self._lifetime_samples = 0
        self._journal_path: str | None = None
        self._journal_windows = 0
        self._cap_warned = False
        if run_dir:
            d = os.path.join(run_dir, "profiles")
            os.makedirs(d, exist_ok=True)
            self._journal_path = os.path.join(
                d, f"{self.role}-{self.rank}.jsonl")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # burst state (mutated by the sampler thread only)
        self._burst_until = 0.0
        self._burst_seq: int | None = None
        self._burst_reason = ""
        self._incident_seq = self._read_seq(self._incident_trigger_path())
        self._manual_seq = self._read_seq(self._manual_trigger_path())

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "SamplingProfiler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="distlr-prof-sampler")
            self._thread.start()
            _HZ_GAUGE.set(self.hz)
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        self._thread = None
        if self._burst_seq is not None:
            # stopping mid-burst: the incident capture is shorter than
            # asked, but it still lands as THE burst window — a process
            # exiting right after an alert must not lose the postmortem
            self._burst_until = 0.0
            self._close_burst()
        # final partial window: a short-lived process (bench, a one-shot
        # launch command) must still leave its profile behind
        self.flush_window(kind="final")
        _HZ_GAUGE.set(0.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- the sampler loop --------------------------------------------------
    def _run(self) -> None:
        own = threading.get_ident()
        next_tick = time.monotonic()
        next_trigger_check = 0.0
        while not self._stop.is_set():
            now_mono = time.monotonic()
            in_burst = now_mono < self._burst_until
            if not in_burst and self._burst_seq is not None:
                # a burst just ended: close ITS window before the next
                # regular sample (or a new trigger) lands in it —
                # exactly one burst window per incident
                self._close_burst()
            if now_mono >= next_trigger_check:
                # same 0.25s cadence as the flight recorder's watcher —
                # checking per sample tick would open the trigger files
                # ~40x/s for nothing
                self._check_triggers()
                next_trigger_check = now_mono + 0.25
            in_burst = time.monotonic() < self._burst_until
            hz = self.burst_hz if in_burst else self.hz
            _HZ_GAUGE.set(hz)
            self.sample_once(exclude={own})
            if not in_burst and \
                    time.time() - self._window_t0 >= self.window_s:
                self.flush_window(kind="window")
            next_tick += 1.0 / hz
            delay = next_tick - time.monotonic()
            if delay <= 0:
                next_tick = time.monotonic()  # fell behind: don't spiral
            else:
                self._stop.wait(delay)

    def sample_once(self, exclude: set | None = None) -> int:
        """Walk every live thread's current frame once; returns the
        number of samples folded in.  Public for deterministic tests."""
        try:
            frames = sys._current_frames()
        except Exception:  # noqa: BLE001 — profiling must never fail work
            return 0
        n = 0
        for tid, frame in frames.items():
            if exclude and tid in exclude:
                continue
            folded = fold_stack(frame, dtrace.active_span_name(tid))
            self._record(folded)
            n += 1
        if n:
            _SAMPLES.inc(n)
        return n

    def _record(self, folded: str, count: int = 1) -> None:
        with self._lock:
            # window and lifetime tables overflow INDEPENDENTLY: a stack
            # squeezed out of one busy window may long be tracked in the
            # lifetime aggregate, and folding it into "(overflow)" there
            # would misattribute the process's genuinely hot frames
            key = folded
            if key not in self._table and \
                    len(self._table) >= self.max_stacks:
                key = "(overflow)"
                _STACKS_DROPPED.inc(count)
            self._table[key] = self._table.get(key, 0) + count
            self._window_samples += count
            lkey = folded
            if lkey not in self._lifetime and \
                    len(self._lifetime) >= self.max_stacks:
                lkey = "(overflow)"
            self._lifetime[lkey] = self._lifetime.get(lkey, 0) + count
            self._lifetime_samples += count

    # -- windows -----------------------------------------------------------
    def _drain_window(self):
        with self._lock:
            table, n = self._table, self._window_samples
            t0 = self._window_t0
            hz = self._window_hz
            self._table = {}
            self._window_samples = 0
            self._window_t0 = time.time()
            self._window_hz = self.hz
        return table, n, t0, hz

    def flush_window(self, kind: str = "window",
                     incident: int | None = None,
                     reason: str | None = None) -> dict | None:
        """Close the current aggregation window and journal it (empty
        windows are skipped — an idle process stays silent on disk).
        Returns the window doc (None when empty)."""
        table, n, t0, hz = self._drain_window()
        if n == 0:
            return None
        doc = {
            "type": "profwindow",
            "role": self.role, "rank": self.rank, "pid": os.getpid(),
            "kind": kind,
            "t0": round(t0, 3), "t1": round(time.time(), 3),
            "hz": hz,
            "unit": "samples",
            "samples": n,
            "stacks": table,
        }
        if incident is not None:
            doc["incident"] = incident
        if reason:
            doc["reason"] = reason
        self._journal(doc)
        _WINDOWS.labels(kind=kind).inc()
        return doc

    def _journal(self, doc: dict) -> None:
        if self._journal_path is None:
            return
        if self._journal_windows >= MAX_JOURNAL_WINDOWS:
            # the cap bounds disk LOUDLY, like dtrace's span-journal
            # cap: count the drop and say so once — a silent stop would
            # read as "the run went idle" in every merged flamegraph
            _WINDOWS_DROPPED.inc()
            if not self._cap_warned:
                self._cap_warned = True
                log.warning(
                    "profile journal %s hit its %d-window cap; further "
                    "windows drop (in-memory aggregation continues)",
                    self._journal_path, MAX_JOURNAL_WINDOWS)
            return
        try:
            with open(self._journal_path, "a") as f:
                f.write(json.dumps(doc) + "\n")
            self._journal_windows += 1  # only LANDED lines consume cap
        except OSError:
            pass  # profiling must never fail the profiled work

    # -- bursts ------------------------------------------------------------
    def _incident_trigger_path(self) -> str | None:
        if not self.run_dir:
            return None
        return os.path.join(self.run_dir, "flightrec", dtrace.TRIGGER_NAME)

    def _manual_trigger_path(self) -> str | None:
        if not self.run_dir:
            return None
        return os.path.join(self.run_dir, "profiles", TRIGGER_NAME)

    @staticmethod
    def _read_seq(path: str | None) -> int:
        if path is None:
            return -1
        try:
            with open(path) as f:
                return int(json.load(f).get("seq", -1))
        except (OSError, ValueError):
            return -1

    def _check_triggers(self) -> None:
        """Edge-triggered burst arming from both trigger files: the
        flight recorder's (alert incidents — ONE incident number shared
        with the flight dump) and the profiler's own (``launch
        profrec``).  A trigger seen mid-burst extends nothing — once
        per incident."""
        for path, attr, source in (
            (self._incident_trigger_path(), "_incident_seq", "alert"),
            (self._manual_trigger_path(), "_manual_seq", "profrec"),
        ):
            if path is None:
                continue
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            seq = int(doc.get("seq", -1))
            if seq > getattr(self, attr):
                setattr(self, attr, seq)
                self._begin_burst(seq, str(doc.get("alert",
                                                   doc.get("reason",
                                                           source))))

    def _begin_burst(self, seq: int, reason: str) -> None:
        if time.monotonic() < self._burst_until:
            return  # already bursting: the running capture owns the window
        # the regular window closes first, so the burst window holds
        # ONLY high-Hz samples of the incident
        self.flush_window(kind="window")
        self._burst_seq = seq
        self._burst_reason = reason
        self._burst_until = time.monotonic() + self.burst_s
        with self._lock:
            self._window_hz = self.burst_hz
        _BURSTS.inc()
        log.info("profile burst: %.0f Hz for %.1fs (seq=%d, %s)",
                 self.burst_hz, self.burst_s, seq, reason)

    def _close_burst(self) -> None:
        seq, reason = self._burst_seq, self._burst_reason
        self._burst_seq = None
        self._burst_reason = ""
        self.flush_window(kind="burst", incident=seq, reason=reason)

    # -- reads -------------------------------------------------------------
    def top_frames(self, n: int = 10) -> list[dict]:
        """Leaf-frame ranking over the LIFETIME aggregate: the
        ``profile_top_frames`` snapshot bench rows carry.  Self time,
        not cumulative — the leaf is where the CPU actually was."""
        leaf: dict[str, int] = {}
        with self._lock:
            items = list(self._lifetime.items())
            total = self._lifetime_samples
        for folded, count in items:
            f = folded.rsplit(";", 1)[-1]
            leaf[f] = leaf.get(f, 0) + count
        ranked = sorted(leaf.items(), key=lambda kv: -kv[1])[:n]
        return [{"frame": f, "samples": c,
                 "share": round(c / total, 4) if total else 0.0}
                for f, c in ranked]

    def flight_info(self, reason: str, seq: int | None) -> dict:
        """dtrace flight-dump cross-reference: the incident's profile
        artifacts, so the two postmortems name each other."""
        return {
            "profile_journal": self._journal_path,
            "profile_incident_seq": seq,
        }


# ---------------------------------------------------------------------------
# module-level singleton (what _obs_scope arms per launch command)
# ---------------------------------------------------------------------------

_PROFILER: SamplingProfiler | None = None


def configure(run_dir: str | None, role: str, rank: int, *,
              hz: float = DEFAULT_HZ, window_s: float = DEFAULT_WINDOW_S,
              burst_hz: float = BURST_HZ,
              burst_s: float = BURST_S) -> SamplingProfiler:
    """Arm (or re-arm) this process's continuous profiler.  Safe to call
    again (tests, multi-command processes): the previous sampler stops
    and flushes first."""
    global _PROFILER
    if _PROFILER is not None:
        stop()
    _PROFILER = SamplingProfiler(run_dir, role, rank, hz=hz,
                                 window_s=window_s, burst_hz=burst_hz,
                                 burst_s=burst_s).start()
    dtrace.register_flight_info(_PROFILER.flight_info)
    return _PROFILER


def is_configured() -> bool:
    return _PROFILER is not None


def profiler() -> SamplingProfiler | None:
    return _PROFILER


def top_frames(n: int = 10) -> list[dict]:
    return _PROFILER.top_frames(n) if _PROFILER is not None else []


def stop() -> None:
    global _PROFILER
    if _PROFILER is not None:
        dtrace.unregister_flight_info(_PROFILER.flight_info)
        _PROFILER.stop()
        _PROFILER = None


def reset_for_tests() -> None:
    stop()


def trigger(run_dir: str, reason: str = "manual") -> str:
    """Drop/refresh the PROFILER-ONLY burst trigger under ``run_dir``
    (``launch profrec``): every sampler on the dir bursts to high Hz
    once, without a flight dump.  Alert incidents instead ride the
    flight recorder's trigger, which arms both."""
    d = os.path.join(run_dir, "profiles")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, TRIGGER_NAME)
    seq = 0
    try:
        with open(path) as f:
            seq = int(json.load(f).get("seq", -1)) + 1
    except (OSError, ValueError):
        pass
    doc = {"seq": seq, "reason": str(reason), "ts": time.time()}
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# prof-agg: merge per-rank profile journals into fleet-wide artifacts
# ---------------------------------------------------------------------------

#: journal "unit" -> speedscope weight unit
_SPEEDSCOPE_UNITS = {"samples": "none", "cpu_us": "microseconds"}


def _read_windows(path: str) -> list[dict]:
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
                    continue  # torn tail line: skip, keep the rest
                if doc.get("type") == "profwindow":
                    out.append(doc)
    except OSError:
        pass
    return out


def merge_run_dirs(run_dirs) -> dict:
    """Merge every ``<run_dir>/profiles/*.jsonl`` journal — Python
    samplers and native ``kv_server`` CPU windows, one schema — into
    per-track aggregates::

        {track: {"unit": ..., "samples": N, "windows": W,
                 "stacks": {folded: count}}}

    keyed by the journal's ``<role>-<rank>`` file stem (suffixed
    ``#2``... on a collision across federated dirs, like trace-agg).
    """
    if isinstance(run_dirs, str):
        run_dirs = [run_dirs]
    tracks: dict[str, dict] = {}
    seen: set[str] = set()
    for d in run_dirs:
        prof_dir = os.path.join(d, "profiles")
        if not os.path.isdir(prof_dir):
            continue
        for name in sorted(os.listdir(prof_dir)):
            if not name.endswith(".jsonl"):
                continue
            stem = name[:-len(".jsonl")]
            key, n = stem, 1
            while key in seen:
                n += 1
                key = f"{stem}#{n}"
            seen.add(key)
            windows = _read_windows(os.path.join(prof_dir, name))
            if not windows:
                continue
            agg: dict[str, int] = {}
            total = 0
            unit = windows[0].get("unit", "samples")
            for w in windows:
                if w.get("unit", "samples") != unit:
                    continue  # one unit per track; mixed lines are drift
                for folded, count in (w.get("stacks") or {}).items():
                    agg[folded] = agg.get(folded, 0) + int(count)
                total += int(w.get("samples", 0))
            tracks[key] = {"unit": unit, "samples": total,
                           "windows": len(windows), "stacks": agg}
    return tracks


def write_collapsed(tracks: dict, out_path: str) -> int:
    """Fleet-wide collapsed-stack file: ``track;frame;... count`` per
    line (the flamegraph.pl / inferno input format, the track prefix
    keeping ranks separable).  Returns the line count."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    n = 0
    tmp = f"{out_path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        for track in sorted(tracks):
            for folded, count in sorted(tracks[track]["stacks"].items()):
                f.write(f"{track};{folded} {count}\n")
                n += 1
    os.replace(tmp, out_path)
    return n


def write_speedscope(tracks: dict, out_path: str) -> dict:
    """Speedscope-compatible JSON (https://www.speedscope.app file
    format, ``sampled`` profiles): one profile per track, shared frame
    table, each distinct folded stack one weighted sample."""
    frames: list[dict] = []
    index: dict[str, int] = {}

    def fi(name: str) -> int:
        i = index.get(name)
        if i is None:
            i = index[name] = len(frames)
            frames.append({"name": name})
        return i

    profiles = []
    for track in sorted(tracks):
        t = tracks[track]
        samples, weights = [], []
        total = 0
        for folded, count in sorted(t["stacks"].items()):
            samples.append([fi(p) for p in folded.split(";")])
            weights.append(count)
            total += count
        profiles.append({
            "type": "sampled",
            "name": track,
            "unit": _SPEEDSCOPE_UNITS.get(t["unit"], "none"),
            "startValue": 0,
            "endValue": total,
            "samples": samples,
            "weights": weights,
        })
    doc = {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": profiles,
        "exporter": "distlr_tpu_torch.obs.profile",
        "name": "distlr fleet profile",
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = f"{out_path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out_path)
    return doc
