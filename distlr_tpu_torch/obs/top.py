"""``launch top``: a live ANSI terminal dashboard over the fleet scrape
(the port's copy of ``distlr_tpu/obs/top.py``, stdlib only).

Renders the aggregator's ``/fleet.json`` (per-rank step rate, pull/push
p50/p99, staleness in seconds AND pushes-behind, firing alerts) the way
``top`` renders processes: one frame per poll, in-place.  Pure text in,
pure text out — :func:`render_fleet` takes the parsed summary and
returns the frame, so tests assert on content without a terminal.
"""

from __future__ import annotations

import collections
import json
import sys
import time
import urllib.request

from distlr_tpu_torch.obs.tsdb import delta_rate

_RESET = "\x1b[0m"
_BOLD = "\x1b[1m"
_DIM = "\x1b[2m"
_RED = "\x1b[31m"
_GREEN = "\x1b[32m"
_YELLOW = "\x1b[33m"
#: Home + clear-to-end: repaint without the flicker of a full 2J clear.
CLEAR = "\x1b[H\x1b[J"

_STATE_COLOR = {"up": _GREEN, "stale": _YELLOW, "down": _RED}

_COLUMNS = (
    ("role", 9), ("rank", 4), ("state", 6), ("steps", 8),
    ("samples/s", 10), ("req/s", 8), ("push/s", 8), ("e2e p50/p99", 13),
    ("step p50", 9), ("pull p50/p99", 13), ("push p50/p99", 13),
    ("stale s", 8), ("stale pushes", 13), ("compiles", 8), ("dev MB", 8),
    ("mdl", 4), ("t-shed", 7), ("sh-psi", 7), ("lag", 5), ("autopilot", 14),
    ("err/s", 6), ("inc", 5),
)


class RateTracker:
    """Windowed rates from successive ``/fleet.json`` polls: the frame's
    cumulative counters (serve/route requests, ok gradient pushes) are
    differenced against the OLDEST frame in a bounded history — so the
    dashboard shows requests/s and pushes/s over the last N scrapes next
    to the cumulative columns, not a lifetime average that flattens
    every burst."""

    def __init__(self, window: int = 10):
        if window < 2:
            raise ValueError(f"window must be >= 2 frames, got {window}")
        self._hist: collections.deque = collections.deque(maxlen=window)

    @staticmethod
    def _counters(fleet: dict) -> dict:
        cur = {}
        for r in fleet.get("ranks", []):
            req = r.get("requests")
            if req is None:
                req = r.get("route_requests")
            cur[(r.get("role"), r.get("rank"))] = (req, r.get("pushes"))
        return cur

    def update(self, fleet: dict) -> dict:
        """Feed one frame; returns ``{(role, rank): {"req_s", "push_s"}}``
        (values None where the rank exports no such counter)."""
        ts = fleet.get("updated")
        if ts is None:
            return {}
        if self._hist and self._hist[-1][0] == ts:
            # the aggregator hasn't rescraped since our last poll: a
            # duplicate frame would shrink the window without adding data
            pass
        else:
            self._hist.append((ts, self._counters(fleet)))
        if len(self._hist) < 2:
            return {}
        t0, old = self._hist[0]
        t1, new = self._hist[-1]
        if t1 - t0 <= 0:
            return {}
        rates = {}
        for key, (req1, push1) in new.items():
            req0, push0 = old.get(key, (None, None))
            rates[key] = {
                "req_s": delta_rate(t0, req0, t1, req1),
                "push_s": delta_rate(t0, push0, t1, push1),
            }
        return rates


def _c(text: str, code: str, color: bool) -> str:
    return f"{code}{text}{_RESET}" if color else text


def _ms(v) -> str:
    if v is None:
        return "-"
    return f"{v:.2f}" if v < 100 else f"{v:.0f}"


def _pair(p50, p99) -> str:
    if p50 is None and p99 is None:
        return "-"
    return f"{_ms(p50)}/{_ms(p99)}"


def _num(v, fmt="{:.1f}") -> str:
    return "-" if v is None else fmt.format(v)


def _autopilot(r: dict) -> str:
    """The controller rank's cell: actions/rollbacks, the last action
    (``eng+3`` = engine scaled up to 3), and whether it is holding."""
    if r.get("autopilot_ticks") is None:
        return "-"
    cell = (f"{r.get('autopilot_actions', 0)}a/"
            f"{r.get('autopilot_rollbacks', 0)}r")
    last = r.get("autopilot_last_action")
    if last:
        sign = "+" if last.get("direction") == "up" else "-"
        cell += f" {str(last.get('actuator', '?'))[:3]}{sign}{last.get('to')}"
    if r.get("autopilot_holding"):
        cell += " hold"
    return cell


def _rank_cells(r: dict, rates: dict | None = None) -> list[str]:
    rr = (rates or {}).get((r.get("role"), r.get("rank")), {})
    return [
        str(r.get("role", "?")), str(r.get("rank", "?")),
        str(r.get("state", "?")),
        _num(r.get("steps"), "{:d}"), _num(r.get("samples_per_s")),
        _num(rr.get("req_s")), _num(rr.get("push_s")),
        # e2e serve latency: the routing tier's admission-to-reply
        # histogram (the number a user-facing SLO is stated against)
        _pair(r.get("route_p50_ms"), r.get("route_p99_ms")),
        _ms(r.get("step_p50_ms")),
        _pair(r.get("pull_p50_ms"), r.get("pull_p99_ms")),
        _pair(r.get("push_p50_ms"), r.get("push_p99_ms")),
        _num(r.get("staleness_s"), "{:.3f}"),
        _pair(r.get("staleness_pushes_p50"), r.get("staleness_pushes_p99")),
        # runtime introspection: recompile count + live device-buffer
        # footprint (engine/trainer ranks; '-' for roles without a device)
        _num(r.get("jax_compiles"), "{:d}"),
        _num(r.get("device_mb")),
        # multi-tenant serving: hosted model count, per-tenant quota
        # sheds, and the worst live shadow PSI (routing-tier ranks)
        _num(r.get("models"), "{:d}"),
        _num(r.get("tenant_shed"), "{:d}"),
        _num(r.get("shadow_psi"), "{:.3f}"),
        # feedback backlog (pending unclaimed shards) + the autopilot
        # rank's control-loop telemetry (actions, rollbacks, last move)
        _num(r.get("shard_lag"), "{:.0f}"),
        _autopilot(r),
        # structured-log ERROR rate (tsdb-windowed) + the open-incident
        # seq the aggregator stamps while an alert edge's bundle is
        # settling or its alert is still firing
        _num(r.get("log_errors"), "{:.2f}"),
        ("-" if r.get("incident_open") is None
         else f"{int(r['incident_open']):04d}"),
    ]


def render_fleet(fleet: dict, *, color: bool = True,
                 clear: bool = False, rates: dict | None = None) -> str:
    """One dashboard frame from a parsed ``/fleet.json`` document.
    ``rates``: a :class:`RateTracker.update` result — windowed req/s
    and push/s per rank (``-`` without history)."""
    lines: list[str] = []
    tot = fleet.get("totals", {})
    updated = fleet.get("updated")
    if fleet.get("virtual"):
        # a fleetsim-emitted frame: "updated" is the simulator's
        # virtual clock, meaningless against time.time() — scrub by
        # simulated offset instead (rate windows already difference
        # successive "updated" stamps, so they are virtual-safe as-is)
        age = (f"t=+{updated:.1f}s (virtual clock)" if updated is not None
               else "never")
    elif updated:
        age = f"{max(0.0, time.time() - updated):.1f}s ago"
    else:
        age = "never"
    head = (f"distlr fleet top — {fleet.get('run_dir', '?')} — "
            f"{tot.get('up', 0)}/{tot.get('ranks', 0)} up — "
            f"{tot.get('samples_per_s', 0):,.0f} samples/s — updated {age}")
    lines.append(_c(head, _BOLD, color))

    firing = [a for a in fleet.get("alerts", []) if a.get("firing")]
    if firing:
        for a in firing:
            labels = ",".join(f"{k}={v}" for k, v in a.get("labels", {}).items())
            val = a.get("value")
            lines.append(_c(
                f"ALERT {a['name']}{{{labels}}}"
                + (f" value={val}" if val is not None else ""),
                _RED + _BOLD, color))
    else:
        lines.append(_c("alerts: none firing", _DIM, color))
    # SLO error budgets (aggregators running with --slo-file publish a
    # "slo" summary in fleet.json; frames without one render unchanged)
    for s in fleet.get("slo") or []:
        budget = s.get("budget_remaining")
        cell = "budget ?" if budget is None else f"budget {budget:7.1%}"
        burns = []
        for lbl, b in sorted((s.get("burn") or {}).items()):
            long = b.get("long")
            burns.append(f"{lbl} {'-' if long is None else f'{long:.2f}x'}"
                         + (" FIRING" if b.get("firing") else ""))
        line = f"SLO {s.get('name', '?')}: {cell}  " + "  ".join(burns)
        exhausted = budget is not None and budget <= 0
        firing = any(b.get("firing") for b in (s.get("burn") or {}).values())
        code = _RED + _BOLD if (exhausted or firing) else _DIM
        lines.append(_c(line, code, color))
    lines.append("")

    header = "  ".join(name.ljust(w) for name, w in _COLUMNS)
    lines.append(_c(header, _BOLD, color))
    for r in fleet.get("ranks", []):
        cells = _rank_cells(r, rates)
        row = "  ".join(c.ljust(w) for c, (_, w) in zip(cells, _COLUMNS))
        state_color = _STATE_COLOR.get(r.get("state"), "")
        lines.append(_c(row, state_color, color) if state_color else row)
    if not fleet.get("ranks"):
        lines.append(_c("  (no ranks discovered yet — are processes "
                        "running with --obs-run-dir?)", _DIM, color))
    body = "\n".join(lines) + "\n"
    return (CLEAR + body) if clear else body


def run_top_replay(path: str, *, interval: float = 0.0,
                   color: bool | None = None, out=None,
                   rate_window: int = 10) -> int:
    """Offline incident scrubbing (``launch top --replay``): render a
    banked scrape history (``<run_dir>/history.jsonl``, one
    ``/fleet.json`` document per line, written by the aggregator every
    cycle) frame by frame.  Windowed req/s / push/s columns derive from
    the REPLAYED timestamps, so rates read as they did live.  Returns a
    shell-style exit code."""
    out = out or sys.stdout
    if color is None:
        color = bool(getattr(out, "isatty", lambda: False)())
    tracker = RateTracker(window=max(2, rate_window))
    n = 0
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    fleet = json.loads(line)
                except ValueError:
                    continue  # torn tail line: skip, keep scrubbing
                if n and interval > 0:
                    time.sleep(interval)
                frame = render_fleet(fleet, color=color, clear=color,
                                     rates=tracker.update(fleet))
                out.write(frame)
                out.flush()
                n += 1
    except OSError as e:
        out.write(f"cannot replay {path}: {e}\n")
        return 1
    except KeyboardInterrupt:
        if color:
            out.write(_RESET + "\n")
        return 130
    if n == 0:
        out.write(f"no frames in {path} — did the aggregator run with "
                  "history enabled?\n")
        return 1
    out.write(f"replayed {n} frames from {path}\n")
    return 0


def run_top(url: str, *, interval: float = 1.0,
            iterations: int | None = None, color: bool | None = None,
            timeout_s: float = 2.0, out=None, rate_window: int = 10) -> int:
    """Poll ``<url>/fleet.json`` and repaint until interrupted (or for
    ``iterations`` frames — what scripts and tests use).  Returns a
    shell-style exit code.  ``rate_window``: frames of history behind
    the windowed req/s / push/s columns."""
    out = out or sys.stdout
    if color is None:
        color = bool(getattr(out, "isatty", lambda: False)())
    tracker = RateTracker(window=max(2, rate_window))
    n = 0
    try:
        while iterations is None or n < iterations:
            if n:
                time.sleep(interval)
            try:
                with urllib.request.urlopen(url + "/fleet.json",
                                            timeout=timeout_s) as r:
                    fleet = json.load(r)
                frame = render_fleet(fleet, color=color, clear=color,
                                     rates=tracker.update(fleet))
            except Exception as e:  # noqa: BLE001 — show, keep polling
                frame = (CLEAR if color else "") + \
                    f"fleet aggregator unreachable at {url}: {e}\n"
            out.write(frame)
            out.flush()
            n += 1
    except KeyboardInterrupt:
        if color:
            out.write(_RESET + "\n")
        return 130
    return 0
