"""Hot weight reload: keep a scoring engine fresh while training runs.

Counterpart of ``distlr_tpu/serve/reload.py``: two weight sources behind
one ``poll() -> (version, weights) | None`` interface, and a poller that
publishes into ``engine.set_weights``.

* :class:`CheckpointWatcher` watches a checkpoint directory written by the
  port's :class:`~distlr_tpu_torch.train.checkpoint.Checkpointer` (one
  ``.npz`` a step; the JAX package's orbax format is not read) and
  reports each new latest step once; the version is the step.
* :class:`LivePSWatcher` pulls the current weights from a running KV
  server group through chunked keyed pulls
  (:meth:`~distlr_tpu_torch.ps.KVWorker.pull_chunked`), ``vals_per_key``
  rows where the group's ranges align.  Pulls neither vote in barriers
  nor count as pushes, so a trainer and the scoring tier run against the
  same group at once; the poll interval is the staleness bound.  With a
  :class:`~distlr_tpu_torch.serve.hotset.HotSetTracker` attached, a poll
  refreshes only the traffic's hot rows
  (:meth:`~distlr_tpu_torch.ps.KVWorker.pull_rows_into`) into a cached
  full table, and falls back to a full refresh when the tracker's
  coverage drops below ``min_coverage`` or every ``full_refresh_every``
  polls.  ``ns_base`` / ``ns_total_dim`` scope it to one model's
  namespace of a group that hosts several
  (:func:`~distlr_tpu_torch.ps.namespace_layout`): every pull addresses
  only ``[ns_base, ns_base + dim)`` of the group's key space.

:class:`HotReloader` polls a source on a background thread with a
jittered interval (replicas started together would otherwise pull the PS
in lockstep), keeps serving the last good weights through failed polls,
and offers :meth:`HotReloader.wait_for_weights` as the start-up gate.

A :class:`~distlr_tpu_torch.ps.RetryPolicy` (``retry=``) retries a PS
blip inside the poll, and a membership ``route`` (``launch serve
--ps-ctl``) makes the watcher follow a live resize: a reshard costs one
re-route inside a poll.  Each live-PS reload counts in the JAX package's
``distlr_serve_reloads_total{kind}`` and ``distlr_serve_reload_rows_total{kind}``
(full table or hot slice).  Each poll is a distributed-trace root of its
own (``serve.reload``), so a sampled reload's pulls and the servers'
``kv.pull`` handler spans lie beside the request and feedback traces.
"""

from __future__ import annotations

import random

import numpy as np

from distlr_tpu_torch import sync
from distlr_tpu_torch.obs import dtrace
from distlr_tpu_torch.obs.registry import get_registry
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_reg = get_registry()
_RELOADS = _reg.counter(
    "distlr_serve_reloads_total",
    "live-PS weight reloads by kind (full table vs hot working-set slice)",
    labelnames=("kind",),
)
_RELOAD_ROWS = _reg.counter(
    "distlr_serve_reload_rows_total",
    "parameter rows fetched by live-PS weight reloads",
    labelnames=("kind",),
)


class CheckpointWatcher:
    """Poll a checkpoint dir; report each new latest step once."""

    def __init__(self, directory: str):
        self._dir = directory
        self._last_step: int | None = None

    def poll(self):
        from distlr_tpu_torch.train.checkpoint import Checkpointer  # noqa: PLC0415

        with Checkpointer(self._dir) as ckpt:
            step = ckpt.latest_step()
            if step is None or step == self._last_step:
                return None
            state = ckpt.restore(step)
        self._last_step = step
        return step, np.asarray(state["weights"]).reshape(-1)

    def close(self) -> None:
        pass


class LivePSWatcher:
    """Pull the current weights from a live KV server group each poll.

    The protocol has no "new version" signal: every poll returns the
    current table with a local version that increases by one.  After a
    failed poll the next one reconnects first, then re-checks that every
    server rank is initialized (the group may have been replaced by an
    unseeded one, which answers pulls with zeros); until then a poll
    reports nothing and the last good weights keep serving.

    ``vals_per_key`` is the engine's row width (the unit of its row keys
    and of the hot tracker); the wire falls back to flat keys when such
    rows straddle a range boundary.  ``hot_tracker``: refresh only the
    hot rows into a cached table, with a full refresh on the first poll,
    when ``coverage() < min_coverage``, or every ``full_refresh_every``
    polls (0 = never forced).  ``route``, a membership layout provider
    (:func:`~distlr_tpu_torch.ps.membership.layout_client`), takes the
    place of ``hosts`` and is followed through live resizes.
    """

    #: client_id of serving pulls, out of the way of trainer worker ranks
    SERVE_CLIENT_ID = 4095

    def __init__(self, hosts: str | None, dim: int, *, vals_per_key: int = 1,
                 chunk_rows: int = 1 << 16, timeout_ms: int = 10_000,
                 client_id: int | None = None, hot_tracker=None,
                 min_coverage: float = 0.95, full_refresh_every: int = 10, retry=None,
                 ns_base: int = 0, ns_total_dim: int | None = None, route=None):
        from distlr_tpu_torch.ps import KVWorker  # noqa: PLC0415

        self.dim = int(dim)
        #: the slice [ns_base, ns_base + dim) of a group of ns_total_dim slots
        #: that this engine serves; N versions' watchers share one group
        #: without reading each other's rows
        self.ns_base = int(ns_base)
        self._wire_dim = int(ns_total_dim) if ns_total_dim else self.dim
        if self.ns_base < 0 or self.ns_base + self.dim > self._wire_dim:
            raise ValueError(f"namespace [{ns_base}, {ns_base + dim}) outside the "
                             f"group's key space [0, {self._wire_dim})")
        # a pull-only client never votes in a BSP barrier
        worker = KVWorker(hosts, self._wire_dim,
                          client_id=self.SERVE_CLIENT_ID if client_id is None else client_id,
                          timeout_ms=timeout_ms, sync_group=True, retry=retry,
                          # a resize that breaks the rows' range alignment
                          # falls back as construction does; equal ranges
                          # over dim % (vpk * S) == 0 stay aligned
                          route=route)
        self._worker = worker
        self.kv = (worker if self._wire_dim == self.dim and not self.ns_base
                   else worker.namespace(self.ns_base, self.dim))
        self._needs_reconnect = False
        self._check_init = True
        #: the requested row width: the unit of the engine's row keys and of
        #: the hot tracker, even when the wire falls back to flat keys
        self.row_width = max(int(vals_per_key), 1)
        self.vals_per_key = self.row_width
        if self.vals_per_key > 1 and not self.kv.supports_vals_per_key(self.vals_per_key):
            # the keyed trainer's rule: rows that straddle a range boundary
            # ride flat keys, the same slots
            log.info("serve pull: vals_per_key=%d rows straddle range boundaries; "
                     "using flat keys", self.vals_per_key)
            self.vals_per_key = 1
        self.chunk_rows = int(chunk_rows)
        if not 0.0 < min_coverage <= 1.0:
            raise ValueError(f"min_coverage must be in (0, 1], got {min_coverage}")
        if full_refresh_every < 0:
            raise ValueError(f"full_refresh_every must be >= 0, got {full_refresh_every}")
        self.hot_tracker = hot_tracker
        self.min_coverage = float(min_coverage)
        self.full_refresh_every = int(full_refresh_every)
        self._version = 0
        self._table: np.ndarray | None = None
        self._since_full = 0
        self.full_reloads = 0
        self.hot_reloads = 0
        self.last_kind: str | None = None
        self.last_rows = 0

    @property
    def hosts(self) -> str:
        """The group's hosts as the client routes now (a resize moves
        them)."""
        return self._worker.hosts

    def _pull_full(self) -> np.ndarray:
        return self.kv.pull_chunked(vals_per_key=self.vals_per_key, chunk_rows=self.chunk_rows)

    def _hot_pull_keys(self, row_keys: np.ndarray) -> np.ndarray:
        """Tracker row ids -> the wire's key space: when the wire fell
        back to flat keys, each R-lane row id expands to its R flat slots
        (ascending in, ascending out)."""
        if self.vals_per_key == self.row_width:
            return row_keys
        r = self.row_width
        return (row_keys[:, None] * r + np.arange(r, dtype=np.uint64)[None, :]).reshape(-1)

    def poll(self):
        if self._needs_reconnect:
            # a still-down PS raises here: one more degraded cycle.  A routed
            # client re-routes: its hosts may have been resized away
            self._worker.recover()
            self._needs_reconnect = False
            self._check_init = True
        ctx = dtrace.new_trace()
        try:
            with dtrace.use(ctx), dtrace.span("serve.reload", tags={"hosts": self.hosts}):
                return self._poll_inner()
        except OSError:
            self._needs_reconnect = True
            raise

    def _poll_inner(self):
        if self._check_init:
            # every rank must be seeded: an unseeded one answers zeros
            if not all(self.kv.stats(r).get("initialized") for r in range(self.kv.num_servers)):
                return None
            self._check_init = False
        if self.hot_tracker is None:
            w = self._pull_full()
            self._version += 1
            self.full_reloads += 1
            self.last_kind, self.last_rows = "full", w.size // self.row_width
            _RELOADS.labels(kind="full").inc()
            _RELOAD_ROWS.labels(kind="full").inc(self.last_rows)
            return self._version, w
        full = (self._table is None
                or self.hot_tracker.coverage() < self.min_coverage
                or (self.full_refresh_every > 0 and self._since_full >= self.full_refresh_every))
        if full:
            self._table = np.ascontiguousarray(self._pull_full(), dtype=np.float32)
            self._since_full = 0
            self.full_reloads += 1
            rows = self._table.size // self.row_width
            # publish a snapshot, so the coverage window restarts over the
            # fresh table (everything is current right after a full pull)
            self.hot_tracker.hot_keys()
            kind = "full"
        else:
            keys = self._hot_pull_keys(self.hot_tracker.hot_keys())
            if keys.size == 0:
                # nothing hot and the cached table already published: a "new"
                # version would re-upload an identical table every poll
                return None
            pulled = self.kv.pull_rows_into(self._table, keys, vals_per_key=self.vals_per_key,
                                            chunk_rows=self.chunk_rows)
            rows = pulled if self.vals_per_key == self.row_width else pulled // self.row_width
            self._since_full += 1
            self.hot_reloads += 1
            kind = "hot"
        self._version += 1
        self.last_kind, self.last_rows = kind, rows
        _RELOADS.labels(kind=kind).inc()
        _RELOAD_ROWS.labels(kind=kind).inc(rows)
        # a COPY: the next hot poll scatters into the table in place, and a
        # request in flight must finish on the weights it started with
        return self._version, self._table.copy()

    def describe_unready(self) -> str:
        """Why no weights came: "PS unreachable" and "PS reachable but
        uninitialized" call for different fixes."""
        from distlr_tpu_torch.ps import KVWorker  # noqa: PLC0415

        try:
            # a fresh probe: this watcher's handle may be the broken thing
            with KVWorker(self.hosts, self._wire_dim, client_id=self.SERVE_CLIENT_ID,
                          timeout_ms=2000) as probe:
                unseeded = [r for r in range(probe.num_servers)
                            if not probe.stats(r).get("initialized")]
        except OSError as e:
            return f"PS unreachable at {self.hosts}: {type(e).__name__}: {e}"
        if unseeded:
            return (f"PS reachable at {self.hosts} but UNINITIALIZED (server rank(s) "
                    f"{unseeded} unseeded) — no trainer has pushed initial weights there yet")
        return (f"PS reachable and initialized at {self.hosts}; polls are failing for "
                "another reason (see reload warnings)")

    def stats(self) -> dict:
        rec = {"mode": "hot" if self.hot_tracker is not None else "full",
               "full_reloads": self.full_reloads, "hot_reloads": self.hot_reloads,
               "last_kind": self.last_kind, "last_rows": self.last_rows}
        if self.ns_base or self._wire_dim != self.dim:
            rec["namespace"] = [self.ns_base, self.dim, self._wire_dim]
        if self.hot_tracker is not None:
            rec["hot_set"] = self.hot_tracker.stats()
        return rec

    def close(self) -> None:
        self.kv.close()


class HotReloader:
    """Background poller: source -> ``engine.set_weights`` swaps.

    Poll errors are counted and logged, never fatal: the engine keeps
    answering on its last good weights.  While degraded, at most one
    warning per ``warn_every_s``; recovery logs once.  Each wait is drawn
    from ``interval_s * (1 ± jitter)`` (``jitter=0``: a fixed cadence).
    """

    #: floor between degraded-cycle warnings (seconds)
    warn_every_s = 10.0

    def __init__(self, engine, source, *, interval_s: float = 1.0, jitter: float = 0.2,
                 _seed: int | None = None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive, got {interval_s}")
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.engine = engine
        self.source = source
        self.interval_s = float(interval_s)
        self.jitter = float(jitter)
        self._rng = random.Random(_seed)
        self.reloads = 0
        self.errors = 0
        self.last_version = None
        self._degraded_since: float | None = None
        self._last_warn = float("-inf")
        self._stop = sync.Event()
        # wait_for_weights (the caller's thread) can overlap the loop, and
        # sources keep per-poll state
        self._poll_lock = sync.Lock()
        self._thread = sync.Thread(target=self._run, daemon=True, name="distlr-hot-reload")

    def _next_wait(self) -> float:
        if not self.jitter:
            return self.interval_s
        return self.interval_s * (1.0 + self.jitter * (2.0 * self._rng.random() - 1.0))

    def _warn_degraded_locked(self, what: str) -> None:
        # called from _poll_once with _poll_lock held
        now = sync.monotonic()
        if now - self._last_warn >= self.warn_every_s:
            self._last_warn = now
            last = (f", version {self.last_version}" if self.last_version is not None
                    else " — none yet")
            log.warning("weight source DEGRADED for %.0fs (%d errors; serving last-good "
                        "weights%s): %s", now - self._degraded_since, self.errors, last, what)

    def _poll_once(self) -> bool:
        with self._poll_lock:
            try:
                got = self.source.poll()
            except Exception as e:
                self.errors += 1
                if self._degraded_since is None:
                    self._degraded_since = sync.monotonic()
                self._warn_degraded_locked(str(e))
                return False
            if got is None:
                # the transport answered but there is nothing to publish
                # (e.g. a replacement PS group not seeded yet): not recovery
                if self._degraded_since is not None:
                    self._warn_degraded_locked("transport answered but published no weights")
                return False
            if self._degraded_since is not None:
                log.info("weight source recovered after %.0fs degraded (%d errors total)",
                         sync.monotonic() - self._degraded_since, self.errors)
                self._degraded_since = None
                self._last_warn = float("-inf")
            version, weights = got
            self.engine.set_weights(weights)
            self.reloads += 1
            self.last_version = version
            return True

    def _run(self):
        while not self._stop.wait(self._next_wait()):
            self._poll_once()

    def start(self) -> "HotReloader":
        self._thread.start()
        return self

    def wait_for_weights(self, timeout_s: float = 30.0) -> None:
        """Block until the engine has weights (the first successful poll):
        the server's start-up gate when no initial weights were given."""
        deadline = sync.monotonic() + timeout_s
        while not self.engine.has_weights:
            if self._poll_once():
                return
            if sync.monotonic() >= deadline:
                detail = ""
                describe = getattr(self.source, "describe_unready", None)
                if callable(describe):
                    try:
                        detail = f": {describe()}"
                    except Exception as e:  # the diagnosis must not mask the timeout
                        detail = f" (diagnosis failed: {e})"
                raise TimeoutError(f"no weights from {type(self.source).__name__} within "
                                   f"{timeout_s:.0f}s{detail}")
            sync.sleep(min(self.interval_s, 0.2))

    def stats(self) -> dict:
        rec = {"reloads": self.reloads, "reload_errors": self.errors,
               "last_version": self.last_version, "interval_s": self.interval_s}
        source_stats = getattr(self.source, "stats", None)
        if callable(source_stats):
            rec["source"] = source_stats()
        return rec

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
        self.source.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
