"""The card's timeline over the measured window, from ``torch.profiler``.

CUDA activity only (CUPTI: kernels, copies, sets), so the host loop is
not slowed by recording every operator.  The Chrome trace is exported to
the run's temporary directory, read back and deleted.  A ``spin_kernel``
(``torch.cuda._sleep``) launched on an idle card just before the window
ties the trace's clock to the host's ``time.perf_counter``, so device
events can be set beside the program's host spans.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import time

#: cycles of the clock marker (about 50 µs)
MARKER_CYCLES = 100_000
_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str    # kernel | memcpy | memset
    name: str
    start: float  # host perf_counter seconds
    end: float
    bytes: int = 0


class DeviceTrace:
    """``start()`` before the window, ``stop(tmp_dir)`` after it."""

    def __init__(self):
        self._prof = None
        self._t_marker = 0.0

    def start(self) -> None:
        import torch  # noqa: PLC0415
        from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self._t_marker = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()

    def stop(self, tmp_dir: str) -> list[Event]:
        import torch  # noqa: PLC0415

        torch.cuda.synchronize()
        self._prof.stop()
        path = os.path.join(tmp_dir, "device_trace.json")
        self._prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.remove(path)
        self._prof = None
        return events_from_chrome(doc, self._t_marker)


def events_from_chrome(doc: dict, t_marker: float) -> list[Event]:
    """The kernels, copies and sets of a Chrome trace on the host's clock,
    by the clock marker's start; none if the marker is missing."""
    raw = [e for e in doc.get("traceEvents", [])
           if e.get("ph") == "X" and e.get("cat") in _KINDS]
    marker = min((e for e in raw if e["cat"] == "kernel" and "spin_kernel" in e["name"]),
                 key=lambda e: float(e["ts"]), default=None)
    if marker is None:
        return []
    offset_us = float(marker["ts"]) - t_marker * 1e6
    out = []
    for e in raw:
        if e is marker:
            continue
        start = (float(e["ts"]) - offset_us) / 1e6
        out.append(Event(_KINDS[e["cat"]], e["name"], start, start + float(e["dur"]) / 1e6,
                         int(e.get("args", {}).get("bytes", 0) or 0)))
    return out


def clip(events: list[Event], t0: float, t1: float) -> list[Event]:
    """The events that overlap [t0, t1], cut to it."""
    return [dataclasses.replace(e, start=max(e.start, t0), end=min(e.end, t1))
            for e in events if e.end > t0 and e.start < t1]


def union(intervals) -> list[tuple[float, float]]:
    """Sorted disjoint cover of ``(start, end)`` intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(events: list[Event]) -> float:
    return sum(b - a for a, b in union((e.start, e.end) for e in events))


def inside(events: list[Event], spans: list[tuple[str, float, float]], name: str) -> list[Event]:
    """The events that start inside a host span called ``name``."""
    cover = union((a, b) for n, a, b in spans if n == name)
    starts = [a for a, _ in cover]
    out = []
    for e in events:
        i = bisect.bisect_right(starts, e.start) - 1
        if i >= 0 and e.start <= cover[i][1]:
            out.append(e)
    return out


def breakdown(events: list[Event], spans: list[tuple[str, float, float]],
              t0: float, t1: float, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps, each named by the host spans open at its middle."""
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, last = [], t0
    for a, b in union((e.start, e.end) for e in events) + [(t1, t1)]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]

    def host_at(t: float) -> str:
        names = sorted({n for n, a, b in spans if a <= t <= b})
        return "+".join(names) if names else "no span"

    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[host_at((a + b) / 2), b - a] for a, b in gaps]}
