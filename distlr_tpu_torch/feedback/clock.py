"""The feedback loop's clocks, behind module-level functions.

Every module of :mod:`distlr_tpu_torch.feedback` reads wall time (spool
timestamps, the join window, claim ages) through :func:`wall` and
elapsed time (idle flushes, idle exits) through :func:`monotonic`, so a
test can replace both here and drive the loop on one injected clock.
The JAX package reads the same clocks through its thread and clock
facade (``distlr_tpu/sync.py``), whose copy waits for ROADMAP A.21.
"""

from __future__ import annotations

import time


def wall() -> float:
    """Wall-clock seconds (``time.time``)."""
    return time.time()


def monotonic() -> float:
    """Monotonic seconds (``time.monotonic``)."""
    return time.monotonic()
