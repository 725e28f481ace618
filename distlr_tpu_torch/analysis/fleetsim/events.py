"""The seeded discrete-event loop fleetsim runs on.

Schedcheck's virtual-clock discipline, pointed at fleet scale: a heap
of ``(time, seq, fn, args)`` entries, one ``random.Random(seed)`` for
every stochastic choice, and an append-only structured event log whose
SHA-256 digest IS the determinism contract — identical seed + scenario
⇒ byte-identical log, twice in a row, asserted by the tests.

Rules that keep the digest honest (mirrors ``schedcheck.engine``):

* ties break on insertion order (``seq``), never on object identity;
* every logged float is formatted through :func:`EventLoop.log`'s
  ``json.dumps(..., sort_keys=True)`` — no ``repr`` of dicts or sets;
* nothing reads the wall clock, the pid, or a filesystem path into a
  logged line.  Wall-clock measurements (events/s for the bench row)
  happen OUTSIDE the loop, around :meth:`EventLoop.run`.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import random

__all__ = ["EventLoop"]


class EventLoop:
    """One simulation: virtual clock, seeded RNG, event heap, log."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.now = 0.0
        self._heap: list[tuple[float, int, object, tuple]] = []
        self._seq = 0
        self.events = 0
        self.lines: list[str] = []

    # -- scheduling --------------------------------------------------------
    def at(self, t: float, fn, *args) -> None:
        """Schedule ``fn(*args)`` at virtual time ``t`` (clamped to
        now — the past is immutable)."""
        heapq.heappush(self._heap,
                       (max(float(t), self.now), self._seq, fn, args))
        self._seq += 1

    def after(self, dt: float, fn, *args) -> None:
        self.at(self.now + dt, fn, *args)

    def every(self, interval: float, fn, *, until: float) -> None:
        """Schedule ``fn()`` at ``interval`` cadence through ``until``
        (fixed grid from now — a drifting cadence would make the log
        depend on handler durations, which do not exist here)."""
        t = self.now + interval
        while t <= until:
            self.at(t, fn)
            t += interval

    # -- the log -----------------------------------------------------------
    def log(self, kind: str, **fields) -> None:
        """Append one canonical event line:
        ``<t> <kind> {sorted-json-fields}``."""
        self.lines.append(f"{self.now:.6f} {kind} "
                          + json.dumps(fields, sort_keys=True))

    def digest(self) -> str:
        """SHA-256 over the full log — the byte-identity pin replay
        ids and the mutant suite assert against."""
        return hashlib.sha256(
            "\n".join(self.lines).encode("utf-8")).hexdigest()[:16]

    # -- execution ---------------------------------------------------------
    def run(self, until: float) -> None:
        """Drain the heap through virtual time ``until``."""
        until = float(until)
        while self._heap and self._heap[0][0] <= until:
            t, _seq, fn, args = heapq.heappop(self._heap)
            self.now = t
            self.events += 1
            fn(*args)
        self.now = until
