"""PyTorch / CUDA runtime introspection -> the metrics registry.

Counterpart of ``distlr_tpu/obs/jaxrt.py``, published under its series
names so one dashboard (and the JAX package's fleet tools, which read
them by name) reads either package:

* **compiles** — ``distlr_jax_compiles_total{site,bucket}``.  The port
  compiles nothing at run time (its kernels are built once, ahead of the
  first launch), so here a *compile* is the first call of an
  instrumented site at a new (shape, dtype) signature: the event on
  which JAX's jit executable cache grows.  A :class:`SignatureCache`
  stands in for one jitted callable's cache (shared where JAX shares the
  callable), and a :class:`CompileProbe` diffs its size per tick, as
  ``JitCacheProbe`` diffs ``_cache_size()``; the same call sequence
  gives JAX's counts at JAX's sites (``train.sync.step`` /
  ``train.sync.eval``, ``train.ps.grad`` / ``train.ps.eval``,
  ``serve.engine`` by bucket).  A ticking counter means new shapes keep
  arriving: on the card, new allocations and kernel plans.
* **device bytes** — ``distlr_jax_device_buffer_bytes`` and
  ``distlr_jax_live_buffers``: on the card ``torch.cuda.memory_allocated()``
  and the caching allocator's live block count
  (``memory_stats()["active.all.current"]``); on the CPU a walk of live
  tensors (``gc.get_objects()``, each storage counted once), the
  counterpart of JAX's ``jax.live_arrays()`` walk.  Hot loops call
  :func:`maybe_sample_device_bytes`: one sample per ``min_interval_s``
  process-wide.

:func:`profiled` is ``Config.profile_dir``: ``torch.profiler`` around a
run, its Chrome trace exported into the directory.  Imports only
``torch`` (lazily, at a sample or a profile) and the registry.
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
import time

from distlr_tpu_torch.obs.registry import get_registry
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_reg = get_registry()
_COMPILES = _reg.counter(
    "distlr_jax_compiles_total",
    "first calls of an instrumented site at a new (shape, dtype) "
    "signature (the event on which JAX's jit cache grows); the serving "
    "engine labels the padded-batch bucket that triggered each one",
    labelnames=("site", "bucket"),
)
_DEVICE_BYTES = _reg.gauge(
    "distlr_jax_device_buffer_bytes",
    "bytes held by live tensors at the last sample (on CUDA "
    "torch.cuda.memory_allocated(); on the CPU the live tensors' "
    "storages)",
)
_LIVE_BUFFERS = _reg.gauge(
    "distlr_jax_live_buffers",
    "live tensor buffers at the last sample (on CUDA the caching "
    "allocator's active blocks; on the CPU the live storages)",
)

_lock = threading.Lock()
_last_walk = 0.0


def _signature(arg):
    """A call argument's part of a signature: a tensor's or array's
    (shape, dtype), a tuple's or list's parts, anything else itself."""
    shape = getattr(arg, "shape", None)
    if shape is not None and hasattr(arg, "dtype"):
        return (tuple(int(s) for s in shape), str(arg.dtype))
    if isinstance(arg, (tuple, list)):
        return tuple(_signature(a) for a in arg)
    return arg


class SignatureCache:
    """The signatures one call site has run at: the counterpart of a
    jitted callable's executable cache.  :meth:`note` before (or after)
    each call; sizes only grow."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seen: set = set()

    def note(self, *args) -> bool:
        """Record a call at ``args``' signature; True when it is new."""
        sig = tuple(_signature(a) for a in args)
        with self._lock:
            if sig in self._seen:
                return False
            self._seen.add(sig)
            return True

    def size(self) -> int:
        with self._lock:
            return len(self._seen)


class CompileProbe:
    """Diff one :class:`SignatureCache`'s size into the compile counter
    (``JitCacheProbe``'s rule): ``tick()`` after a call, or a batch of
    calls, attributes the growth since this probe's last tick (or its
    construction) to ``bucket``."""

    def __init__(self, cache: SignatureCache, site: str):
        self._cache = cache
        self.site = str(site)
        self._tick_lock = threading.Lock()
        self._seen = cache.size()

    def tick(self, bucket: str | int = "-") -> int:
        """Record the new signatures since the last tick under
        ``bucket``; returns the delta."""
        with self._tick_lock:
            size = self._cache.size()
            delta = size - self._seen
            if delta <= 0:
                return 0
            self._seen = size
        _COMPILES.labels(site=self.site, bucket=str(bucket)).inc(delta)
        return delta


def _cuda_in_use() -> bool:
    import torch  # noqa: PLC0415

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _live_tensor_storages() -> tuple[int, int]:
    """(bytes, count) of the distinct storages of the live CPU tensors."""
    import torch  # noqa: PLC0415

    seen: dict[int, int] = {}
    for obj in gc.get_objects():
        # type(), not isinstance(): a module-level deprecation shim may warn
        # when its __class__ is read
        if issubclass(type(obj), torch.Tensor) and obj.layout == torch.strided \
                and obj.device.type == "cpu":
            st = obj.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values()), len(seen)


def sample_device_bytes() -> int:
    """Sample now and publish the gauges; returns the byte total."""
    global _last_walk
    try:
        if _cuda_in_use():
            import torch  # noqa: PLC0415

            total = int(torch.cuda.memory_allocated())
            n = int(torch.cuda.memory_stats().get("active.all.current", 0))
        else:
            total, n = _live_tensor_storages()
    except Exception:  # noqa: BLE001 — introspection must never fail work
        return 0
    _DEVICE_BYTES.set(total)
    _LIVE_BUFFERS.set(n)
    with _lock:
        _last_walk = time.monotonic()
    return total


def maybe_sample_device_bytes(min_interval_s: float = 5.0) -> None:
    """Throttled :func:`sample_device_bytes`, the form hot loops call: one
    sample per interval process-wide, however many call sites tick it."""
    with _lock:
        due = time.monotonic() - _last_walk >= min_interval_s
    if due:
        sample_device_bytes()


@contextlib.contextmanager
def profiled(profile_dir: str | None, device, tag: str):
    """``torch.profiler`` around the block when ``profile_dir`` is set
    (``Config.profile_dir``: the counterpart of ``jax.profiler.trace``):
    CPU activities, and CUDA ones on a CUDA ``device``.  The Chrome trace
    goes to ``<profile_dir>/<tag>-<pid>.pt.trace.json`` when the block
    ends, also when it raises; the path is logged."""
    if not profile_dir:
        yield None
        return
    import torch  # noqa: PLC0415
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    activities = [ProfilerActivity.CPU]
    if getattr(device, "type", str(device)).startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{tag}-{os.getpid()}.pt.trace.json")
    prof = profile(activities=activities)
    try:
        with prof:
            try:
                yield prof
            finally:  # the card's queued work lands inside the trace
                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(path)
        log.info("profiler trace -> %s", path)
