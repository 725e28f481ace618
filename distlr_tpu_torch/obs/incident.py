"""Incident engine: alert edges become self-contained postmortem bundles
(the port's copy of ``distlr_tpu/obs/incident.py``, stdlib only).

The fleet detects trouble (burn-rate alerts), reacts to it (the
autopilot, rollout gating) and records fragments of it: flight dumps,
profiler bursts, chaos instants, autopilot decision journals, rollout
ramp journals, tsdb history and structured log journals.  When obs-agg
sees the NOT-FIRING -> FIRING alert edge that fires the flight recorder
(or ``launch incident --trigger`` fires it by hand), this module
assembles

    <run_dir>/incidents/<seq>/
        incident.json     what fired, SLO state, window, artifact refs
        timeline.jsonl    every event, shifted onto ONE clock, sorted
        tsdb.json         headline fleet series around the edge
        POSTMORTEM.md     rendered detection -> evidence -> actions

``seq`` is the flight-recorder trigger sequence: the number stamped into
``flightrec/<role>-<rank>-<seq>.json`` and into the profiler's burst
windows, so the bundle, the dumps and the bursts name each other.

Clocks are aligned by the kHello probe: ``clock`` records in any spans
journal give per-peer offsets keyed by listen port, and every collected
event is shifted by its process's offset before the merge.

Assembly runs on the obs-agg scrape thread; everything here reads
journals other processes write, plus atomic writes into a fresh bundle
dir.
"""

from __future__ import annotations

import json
import os
import time

from distlr_tpu_torch.obs import dtrace
from distlr_tpu_torch.obs import log as fleetlog
from distlr_tpu_torch.obs.registry import get_registry
from distlr_tpu_torch.utils.logging import get_logger

logger = get_logger("distlr_tpu_torch.obs.incident")

_reg = get_registry()
_BUNDLES = _reg.counter(
    "distlr_incident_bundles_total",
    "incident bundles assembled under <run_dir>/incidents/, by trigger",
    labelnames=("trigger",),
)
_EVENTS = _reg.counter(
    "distlr_incident_timeline_events_total",
    "events merged into incident timelines, by kind",
    labelnames=("kind",),
)
_PRUNED = _reg.counter(
    "distlr_incident_pruned_total",
    "old incident bundles removed by the incident_max retention cap",
)

#: default seconds of history collected before the alert edge
WINDOW_S = 120.0
#: default seconds waited after the edge before assembly (must outlast
#: the profiler's burst window so the burst doc lands in its journal)
SETTLE_S = 6.0


# ---------------------------------------------------------------------------
# clock alignment (the kHello offsets, reused record-for-record)
# ---------------------------------------------------------------------------

def clock_shifts(run_dirs) -> tuple[dict, dict]:
    """``(shifts, offsets)``: per-journal-stem second shifts and the
    raw port-keyed peer offsets they derive from.  Same join as
    :func:`dtrace.merge_run_dirs` — ``clock`` records observed by any
    client name a peer ``host:port``; a journal whose ``meta.listen``
    port matches is shifted by ``-offset`` onto the observer's clock.
    Stems without a measured offset shift by 0 (already local)."""
    if isinstance(run_dirs, str):
        run_dirs = [run_dirs]
    journals: list[tuple[str, list[dict]]] = []
    for d in run_dirs:
        spans_dir = os.path.join(d, "spans")
        if not os.path.isdir(spans_dir):
            continue
        for name in sorted(os.listdir(spans_dir)):
            if name.endswith(".jsonl"):
                journals.append(
                    (name[:-len(".jsonl")],
                     dtrace.read_journal(os.path.join(spans_dir, name))))
    offsets: dict[str, float] = {}
    for _stem, recs in journals:
        for r in recs:
            if r.get("type") == "clock" and r.get("peer"):
                port = str(r["peer"]).rpartition(":")[2]
                offsets[port] = float(r.get("offset_s", 0.0))
    shifts: dict[str, float] = {}
    for stem, recs in journals:
        shift = 0.0
        for r in recs:
            if r.get("type") == "meta" and r.get("listen"):
                port = str(r["listen"]).rpartition(":")[2]
                if port in offsets:
                    shift = -offsets[port]
                break
        shifts[stem] = shift
    return shifts, offsets


# ---------------------------------------------------------------------------
# per-artifact-family collectors -> one event schema
# ---------------------------------------------------------------------------
# every collector returns events {"t": shifted_wall_s, "kind": ...,
# "src": journal-stem-or-file, ...detail}


def _collect_logs(run_dirs, shifts, t_lo, t_hi) -> list[dict]:
    events = []
    for rec in fleetlog.read_records(run_dirs, level="warning"):
        stem = f"{rec.get('role', '?')}-{rec.get('rank', '?')}"
        t = float(rec.get("ts", 0.0)) + shifts.get(stem, 0.0)
        if not t_lo <= t <= t_hi:
            continue
        ev = {"t": t, "kind": "log", "src": stem,
              "level": rec.get("level"), "logger": rec.get("logger"),
              "msg": rec.get("msg")}
        for k in ("trace", "span", "suppressed"):
            if rec.get(k) is not None:
                ev[k] = rec[k]
        events.append(ev)
    return events


def _collect_flight_dumps(run_dirs, shifts, seqs) -> list[dict]:
    """The incident's own flight dumps: ``flightrec/<stem>-<seq>.json``
    for that run dir's trigger seq, matched by seq (not window — they
    ARE the incident's artifacts)."""
    events = []
    for d, seq in zip(run_dirs, seqs):
        fdir = os.path.join(d, "flightrec")
        if seq is None or not os.path.isdir(fdir):
            continue
        suffix = f"-{seq}.json"
        for name in sorted(os.listdir(fdir)):
            if not name.endswith(suffix) or name == dtrace.TRIGGER_NAME:
                continue
            path = os.path.join(fdir, name)
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            stem = f"{doc.get('role', '?')}-{doc.get('rank', '?')}"
            ev = {"t": float(doc.get("dumped_at", 0.0))
                  + shifts.get(stem, 0.0),
                  "kind": "flight_dump", "src": stem, "path": path,
                  "reason": doc.get("reason"),
                  "spans": len(doc.get("spans") or [])}
            for k in ("log_journal", "profile_journal"):
                if doc.get(k):
                    ev[k] = doc[k]
            events.append(ev)
    return events


def _collect_bursts(run_dirs, shifts, seqs) -> list[dict]:
    """Profiler burst windows stamped with this incident's seq."""
    events = []
    for d, seq in zip(run_dirs, seqs):
        pdir = os.path.join(d, "profiles")
        if seq is None or not os.path.isdir(pdir):
            continue
        for name in sorted(os.listdir(pdir)):
            if not name.endswith(".jsonl"):
                continue
            path = os.path.join(pdir, name)
            for doc in dtrace.read_journal(path):
                if doc.get("type") != "profwindow" \
                        or doc.get("kind") != "burst" \
                        or doc.get("incident") != seq:
                    continue
                stem = f"{doc.get('role', '?')}-{doc.get('rank', '?')}"
                events.append({
                    "t": float(doc.get("t1", 0.0)) + shifts.get(stem, 0.0),
                    "kind": "profiler_burst", "src": stem, "path": path,
                    "reason": doc.get("reason"),
                    "hz": doc.get("hz"), "samples": doc.get("samples"),
                })
    return events


def _collect_chaos(run_dirs, shifts, t_lo, t_hi) -> list[dict]:
    """Chaos-proxy fault instants out of the spans journals (``ts`` is
    trace microseconds)."""
    events = []
    for d in ([run_dirs] if isinstance(run_dirs, str) else run_dirs):
        spans_dir = os.path.join(d, "spans")
        if not os.path.isdir(spans_dir):
            continue
        for name in sorted(os.listdir(spans_dir)):
            if not name.endswith(".jsonl"):
                continue
            stem = name[:-len(".jsonl")]
            for r in dtrace.read_journal(os.path.join(spans_dir, name)):
                if r.get("type") != "instant" \
                        or not str(r.get("name", "")).startswith("chaos."):
                    continue
                t = float(r.get("ts", 0.0)) / 1e6 + shifts.get(stem, 0.0)
                if not t_lo <= t <= t_hi:
                    continue
                events.append({"t": t, "kind": "chaos", "src": stem,
                               "fault": r.get("name"),
                               "args": dict(r.get("args") or {})})
    return events


def _collect_autopilot(run_dirs, t_lo, t_hi) -> list[dict]:
    """Autopilot decisions (journaled on the observer's clock —
    the daemon runs beside obs-agg, no shift needed).  ``ts`` is the
    journal line's wall anchor; ``t`` is the policy clock (monotonic
    in production), accepted as a fallback for synthetic fixtures that
    stamp epoch seconds directly."""
    events = []
    for d in ([run_dirs] if isinstance(run_dirs, str) else run_dirs):
        path = os.path.join(d, "autopilot", "decisions.jsonl")
        for doc in dtrace.read_journal(path):
            t = float(doc.get("ts", doc.get("t", 0.0)))
            if not t_lo <= t <= t_hi:
                continue
            ev = {"t": t, "kind": "autopilot", "src": "autopilot"}
            for k in ("rule", "action", "outcome"):
                if doc.get(k) is not None:
                    ev[k] = doc[k]
            events.append(ev)
    return events


def _collect_rollout(run_dirs, t_lo, t_hi) -> list[dict]:
    """Rollout ramp transitions (stage/abort/rollback/promoted)."""
    events = []
    for d in ([run_dirs] if isinstance(run_dirs, str) else run_dirs):
        rdir = os.path.join(d, "rollout")
        if not os.path.isdir(rdir):
            continue
        for name in sorted(os.listdir(rdir)):
            if not name.endswith(".jsonl"):
                continue
            for doc in dtrace.read_journal(os.path.join(rdir, name)):
                t = float(doc.get("t", 0.0))
                if not t_lo <= t <= t_hi:
                    continue
                ev = {"t": t, "kind": "rollout", "src": name,
                      "event": doc.get("event")}
                for k, v in doc.items():
                    if k not in ("t", "event"):
                        ev[k] = v
                events.append(ev)
    return events


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

def bundle_dir(run_dir: str, seq: int) -> str:
    return os.path.join(run_dir, "incidents", f"{int(seq):04d}")


def assemble(run_dirs, *, seq: int, reason: str,
             detected_ts: float | None = None,
             alerts: list | None = None, slo: dict | None = None,
             per_dir_seqs: list | None = None,
             window_s: float = WINDOW_S, settle_s: float = SETTLE_S,
             tsdb=None, trigger: str = "alert") -> str | None:
    """Assemble ONE bundle for trigger sequence ``seq`` under
    ``run_dirs[0]/incidents/``.  Idempotent by construction: an
    existing bundle dir for the seq returns ``None`` untouched — the
    exactly-one-bundle-per-incident contract while an alert stays
    firing.  ``per_dir_seqs`` carries each federated run dir's own
    trigger seq (they advance independently); defaults to ``seq`` for
    every dir."""
    if isinstance(run_dirs, str):
        run_dirs = [run_dirs]
    out = bundle_dir(run_dirs[0], seq)
    if os.path.isdir(out):
        return None
    if detected_ts is None:
        detected_ts = time.time()
    if per_dir_seqs is None:
        per_dir_seqs = [seq] * len(run_dirs)
    t_lo = detected_ts - float(window_s)
    t_hi = detected_ts + float(settle_s)

    shifts, offsets = clock_shifts(run_dirs)
    events = [{"t": detected_ts, "kind": "alert_edge", "src": "obs-agg",
               "reason": reason,
               "alerts": [a.get("name") for a in (alerts or [])
                          if a.get("firing")]}]
    events += _collect_chaos(run_dirs, shifts, t_lo, t_hi)
    events += _collect_logs(run_dirs, shifts, t_lo, t_hi)
    events += _collect_flight_dumps(run_dirs, shifts, per_dir_seqs)
    events += _collect_bursts(run_dirs, shifts, per_dir_seqs)
    events += _collect_autopilot(run_dirs, t_lo, t_hi)
    events += _collect_rollout(run_dirs, t_lo, t_hi)
    events.sort(key=lambda e: (e.get("t", 0.0), e.get("kind", "")))

    tmp = f"{out}.{os.getpid()}.tmp"
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "timeline.jsonl"), "w") as f:
        for ev in events:
            ev = dict(ev)
            ev["t"] = round(float(ev["t"]), 6)
            f.write(json.dumps(ev) + "\n")

    if tsdb is not None:
        try:
            snap = tsdb.window_snapshot(t_lo, t_hi)
        except Exception:  # noqa: BLE001 — a bundle beats a perfect bundle
            snap = {}
        with open(os.path.join(tmp, "tsdb.json"), "w") as f:
            json.dump({"window": [round(t_lo, 3), round(t_hi, 3)],
                       "series": snap}, f, indent=1)

    kinds: dict[str, int] = {}
    for ev in events:
        kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
    doc = {
        "seq": int(seq),
        "reason": str(reason),
        "trigger": trigger,
        "detected_ts": round(float(detected_ts), 3),
        "window": [round(t_lo, 3), round(t_hi, 3)],
        "alerts": alerts or [],
        "slo": slo or {},
        "run_dirs": [os.path.abspath(d) for d in run_dirs],
        "per_dir_seqs": list(per_dir_seqs),
        "clock_offsets": offsets,
        "clock_shifts": {k: v for k, v in shifts.items() if v},
        "events": kinds,
        "flight_dumps": [e["path"] for e in events
                         if e["kind"] == "flight_dump"],
        "bursts": [e["path"] for e in events
                   if e["kind"] == "profiler_burst"],
    }
    with open(os.path.join(tmp, "incident.json"), "w") as f:
        json.dump(doc, f, indent=1)
    _render_postmortem(tmp, doc, events)
    try:
        os.rename(tmp, out)
    except OSError:
        # a concurrent assembler won the rename: exactly one bundle
        import shutil  # noqa: PLC0415

        shutil.rmtree(tmp, ignore_errors=True)
        return None
    _BUNDLES.labels(trigger=trigger).inc()
    for k, n in kinds.items():
        _EVENTS.labels(kind=k).inc(n)
    logger.warning("incident %04d (%s): bundle assembled -> %s "
                   "(%d events)", seq, reason, out, len(events))
    return out


# ---------------------------------------------------------------------------
# postmortem rendering
# ---------------------------------------------------------------------------

def _fmt_t(t: float) -> str:
    return time.strftime("%H:%M:%S", time.localtime(t)) \
        + f".{int((t % 1) * 1000):03d}"


def _event_line(ev: dict) -> str:
    k = ev["kind"]
    if k == "alert_edge":
        return f"alert edge: **{ev.get('reason')}** fired"
    if k == "chaos":
        args = ev.get("args") or {}
        link = args.get("link", "?")
        return f"chaos fault `{ev.get('fault')}` on link `{link}`"
    if k == "log":
        extra = f" (x{ev['suppressed']} suppressed)" \
            if ev.get("suppressed") else ""
        return f"{ev.get('level', '?').upper()} " \
               f"`{ev.get('logger')}`: {ev.get('msg')}{extra}"
    if k == "flight_dump":
        return f"flight dump ({ev.get('spans')} spans, " \
               f"reason `{ev.get('reason')}`) -> `{ev.get('path')}`"
    if k == "profiler_burst":
        return f"profiler burst ({ev.get('samples')} samples @ " \
               f"{ev.get('hz')} Hz) -> `{ev.get('path')}`"
    if k == "autopilot":
        act = ev.get("action") or {}
        what = f"{act.get('actuator', '?')} {act.get('direction', '?')} " \
               f"-> {act.get('to', '?')}" if act else "?"
        return f"autopilot `{ev.get('rule')}`: {what} " \
               f"({ev.get('outcome', '?')})"
    if k == "rollout":
        detail = {kk: vv for kk, vv in ev.items()
                  if kk not in ("t", "kind", "src", "event")}
        return f"rollout `{ev.get('event')}` {detail or ''}".rstrip()
    return json.dumps({kk: vv for kk, vv in ev.items() if kk != "t"})


def _render_postmortem(out_dir: str, doc: dict, events: list) -> str:
    t0 = doc["detected_ts"]
    lines = [
        f"# Incident {doc['seq']:04d} — {doc['reason']}",
        "",
        f"*Auto-generated postmortem skeleton; detected "
        f"{time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(t0))} "
        f"(bundle window {doc['window'][0]:.0f}..{doc['window'][1]:.0f}).*",
        "",
        "## Detection",
        "",
    ]
    firing = [a for a in doc.get("alerts", []) if a.get("firing")]
    if firing:
        for a in firing:
            labels = a.get("labels") or {}
            lab = " ".join(f"{k}={v}" for k, v in sorted(labels.items()))
            lines.append(f"- alert **{a.get('name')}**"
                         + (f" ({lab})" if lab else "")
                         + (f" — {a.get('detail')}" if a.get("detail")
                            else ""))
    else:
        lines.append(f"- trigger: {doc.get('trigger')} ({doc['reason']})")
    slo = doc.get("slo") or {}
    for s in slo.get("slos", []) if isinstance(slo, dict) else []:
        lines.append(
            f"- SLO `{s.get('name')}`: budget_remaining="
            f"{s.get('budget_remaining')} burn={s.get('burn', s)}")
    if doc.get("clock_shifts"):
        lines.append("- clock shifts applied: "
                     + ", ".join(f"`{k}` {v:+.3f}s" for k, v in
                                 sorted(doc["clock_shifts"].items())))
    n_by = doc.get("events", {})
    lines += [
        "",
        "## Evidence",
        "",
        f"- {n_by.get('log', 0)} WARN+ log records from "
        f"{len({e['src'] for e in events if e['kind'] == 'log'})} ranks "
        "(`timeline.jsonl`, kind=log)",
        f"- {n_by.get('flight_dump', 0)} flight dumps: "
        + (", ".join(f"`{p}`" for p in doc.get("flight_dumps", []))
           or "none"),
        f"- {n_by.get('profiler_burst', 0)} profiler bursts: "
        + (", ".join(f"`{p}`" for p in doc.get("bursts", [])) or "none"),
        f"- {n_by.get('chaos', 0)} chaos fault events",
        "- headline series around the edge: `tsdb.json`",
        "",
        "## Actions taken",
        "",
    ]
    actions = [e for e in events if e["kind"] in ("autopilot", "rollout")]
    if actions:
        for ev in actions:
            lines.append(f"- `{_fmt_t(ev['t'])}` ({ev['t'] - t0:+.1f}s) "
                         + _event_line(ev))
    else:
        lines.append("- none recorded in the window")
    lines += [
        "",
        "## Timeline",
        "",
        "| t | Δ | src | event |",
        "|---|---|-----|-------|",
    ]
    for ev in events:
        lines.append(f"| {_fmt_t(ev['t'])} | {ev['t'] - t0:+.1f}s "
                     f"| {ev.get('src', '?')} | {_event_line(ev)} |")
    lines.append("")
    path = os.path.join(out_dir, "POSTMORTEM.md")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


# ---------------------------------------------------------------------------
# reading + retention + the `launch incident` verbs
# ---------------------------------------------------------------------------

def list_incidents(run_dir: str) -> list[dict]:
    """Every bundle under ``<run_dir>/incidents/``, oldest first."""
    root = os.path.join(run_dir, "incidents")
    out = []
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name, "incident.json")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        doc["path"] = os.path.join(root, name)
        out.append(doc)
    return out


def latest_seq(run_dir: str) -> int | None:
    """Newest bundle seq (what the `launch top` ``inc`` column shows
    while its alert is still firing)."""
    incidents = list_incidents(run_dir)
    return incidents[-1]["seq"] if incidents else None


def load(run_dir: str, seq: int) -> dict | None:
    """One bundle: its ``incident.json`` plus parsed timeline."""
    d = bundle_dir(run_dir, seq)
    try:
        with open(os.path.join(d, "incident.json")) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    doc["path"] = d
    doc["timeline"] = dtrace.read_journal(
        os.path.join(d, "timeline.jsonl"))
    return doc


def render(run_dir: str, seq: int) -> str | None:
    """(Re-)render a bundle's POSTMORTEM.md from its journaled facts."""
    doc = load(run_dir, seq)
    if doc is None:
        return None
    return _render_postmortem(doc["path"], doc, doc["timeline"])


def prune(run_dir: str, keep: int) -> int:
    """Retention: drop the oldest bundles beyond ``keep`` — loudly,
    via ``distlr_incident_pruned_total`` and a WARNING record."""
    import shutil  # noqa: PLC0415

    incidents = list_incidents(run_dir)
    removed = 0
    for doc in incidents[:max(0, len(incidents) - int(keep))]:
        shutil.rmtree(doc["path"], ignore_errors=True)
        _PRUNED.inc()
        removed += 1
        logger.warning("incident %04d pruned by incident_max=%d retention",
                       doc.get("seq", -1), keep)
    return removed


def manual_trigger(run_dirs, reason: str = "manual", *,
                   window_s: float = WINDOW_S, settle_s: float = SETTLE_S,
                   tsdb=None, wait: bool = True) -> str | None:
    """The ``launch incident --trigger`` path: bump every run dir's
    flight-recorder trigger (dumps rings AND fires profiler bursts),
    wait out the settle window so those
    artifacts land, then assemble.  Returns the bundle path."""
    if isinstance(run_dirs, str):
        run_dirs = [run_dirs]
    detected = time.time()
    seqs = []
    for d in run_dirs:
        dtrace.trigger(d, alert=reason)
        try:
            with open(os.path.join(d, "flightrec",
                                   dtrace.TRIGGER_NAME)) as f:
                seqs.append(int(json.load(f).get("seq", 0)))
        except (OSError, ValueError):
            seqs.append(None)
    if wait:
        time.sleep(float(settle_s))
    return assemble(run_dirs, seq=seqs[0] if seqs and seqs[0] is not None
                    else 0, reason=reason, detected_ts=detected,
                    per_dir_seqs=seqs, window_s=window_s,
                    settle_s=settle_s, tsdb=tsdb, trigger="manual")
