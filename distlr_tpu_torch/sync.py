"""The import point for the thread primitives and clocks of the fleet
tools (the port's copy of ``distlr_tpu/sync.py``).

In the default passthrough state every name below is the stdlib object
itself (``sync.Lock is threading.Lock``): a lock made through the facade
costs one module-attribute lookup and behaves as :mod:`threading`'s.
:func:`install` swaps the names onto instrumented twins and a virtual
clock for a deterministic scheduler that owns them, :func:`uninstall`
restores them, and :func:`instrumented` says which state holds.

The modules of the port that take their locks, threads and clocks from
here are the ones the JAX package routes: ``serve/batcher.py``,
``serve/router.py``, ``serve/tenant.py``, ``serve/reload.py``,
``feedback/join.py``, ``feedback/spool.py``, ``feedback/sink.py``,
``feedback/drift.py``, ``feedback/online.py``, ``ps/membership.py``,
``chaos/proxy.py``, ``obs/tsdb.py``, ``obs/log.py`` and
``autopilot/daemon.py``.  Each calls the facade at use time
(``sync.Lock()``), never binds a name at import, so
:mod:`distlr_tpu_torch.analysis.schedcheck` reaches every site.  Modules
the JAX package leaves on :mod:`threading` (the registry, the tracers,
the profiler, ``ps/server.py``, the trainers) keep it here too.
Stdlib only, and cheap to import.
"""

from __future__ import annotations

import queue as _queue
import threading as _threading
import time as _time

# -- passthrough bindings (the production defaults) ---------------------
# Each name is the stdlib object itself, not a wrapper: passthrough must
# be zero-overhead and byte-identical.  schedcheck's install() swaps
# these module attributes for twins and uninstall() restores them.

Lock = _threading.Lock
RLock = _threading.RLock
Condition = _threading.Condition
Event = _threading.Event
Semaphore = _threading.Semaphore
BoundedSemaphore = _threading.BoundedSemaphore
Thread = _threading.Thread
Queue = _queue.Queue

#: queue exception types are shared between passthrough and twins, so
#: ``except sync.Empty`` works identically under both builds
Empty = _queue.Empty
Full = _queue.Full

#: the clock the adopted modules read where timing feeds a scheduling
#: decision (wait deadlines, backoff arithmetic, rate limits).  Under
#: schedcheck these become the VIRTUAL clock — time advances only when
#: every managed task is blocked, which is what makes timed waits
#: deterministic instead of schedule noise.
monotonic = _time.monotonic
wall = _time.time
sleep = _time.sleep

#: every swappable name, in one place (install/uninstall + tests)
SWAPPABLE = (
    "Lock", "RLock", "Condition", "Event", "Semaphore",
    "BoundedSemaphore", "Thread", "Queue", "monotonic", "wall", "sleep",
)

_PASSTHROUGH = {name: globals()[name] for name in SWAPPABLE}
_installed_by: object | None = None


def install(twins: dict, *, owner: object) -> None:
    """Swap the facade onto instrumented twins (schedcheck only).

    ``twins`` maps names from :data:`SWAPPABLE` to replacement
    callables; unnamed entries keep their passthrough binding.
    Refuses to double-install — two schedcheck runtimes in one process
    would corrupt each other's schedules.
    """
    global _installed_by
    if _installed_by is not None:
        raise RuntimeError(
            "distlr_tpu_torch.sync is already instrumented — one schedcheck "
            "runtime at a time")
    unknown = sorted(set(twins) - set(SWAPPABLE))
    if unknown:
        raise ValueError(f"unknown sync names {unknown}; "
                         f"swappable: {SWAPPABLE}")
    for name, fn in twins.items():
        globals()[name] = fn
    _installed_by = owner


def uninstall(*, owner: object) -> None:
    """Restore the passthrough bindings (idempotent per owner)."""
    global _installed_by
    if _installed_by is None:
        return
    if _installed_by is not owner:
        raise RuntimeError("sync.uninstall by a non-owner")
    for name, obj in _PASSTHROUGH.items():
        globals()[name] = obj
    _installed_by = None


def instrumented() -> bool:
    return _installed_by is not None
