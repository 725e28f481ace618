"""Python KV worker: a ctypes binding of the port's native client library
(the dense and keyed surface of ``distlr_tpu/ps/client.py``'s ``KVWorker``).

API mirror of ps-lite's ``KVWorker<float>`` as used by the reference
(``Push``/``Pull``/``Wait``, call sites ``src/lr.cc:116-132``,
``src/main.cc:135-148``).  Every op calls the same native entry point the
JAX package's client calls, with the same arguments, so the frames on the
wire are that client's byte for byte.  Each call releases the GIL inside
``ctypes``: a worker blocked in a sync push (the BSP barrier is the
server's deferred reply) does not hold up the other worker threads.

Keyed ops take ``vals_per_key=R`` rows: one u64 row id on the wire per R
values (ps-lite's uniform ``lens``), the keyed PS families' encoding.

Namespaces (:func:`namespace_layout`, :class:`KVNamespace`,
:meth:`KVWorker.namespace`) fold several equal-width model versions into
one group's key space, offset on the client side: the wire carries plain
keyed ops, so the server needs no change.  A namespace may carry its own
server optimizer (``v1:ftrl``).

Gradient wire codecs (``compress="int8"|"signsgd"``,
:mod:`distlr_tpu_torch.compress`) are negotiated at connect and at every
reconnect through the kHello capability handshake; a group that does not
advertise the codec gets dense f32 pushes, and the fallback is logged.
The worker counts the bytes of each delivered push in
:attr:`KVWorker.push_bytes_raw` / :attr:`KVWorker.push_bytes_wire`.

A :class:`RetryPolicy` (``KVWorker(retry=)``) answers a transient
transport fault in place: reconnect, back off, re-issue.  Idempotent ops
are always re-issued; a gradient push only while the native client
proves no byte of it reached a server, else it is absorbed (the Hogwild
staleness class), and a sync group's pushes never.  The worker counts
what the JAX package's registry counts (:attr:`KVWorker.retries`,
``reconnects``, ``push_outcome_unknown``) as attributes.

Membership epochs (``KVWorker(epoch=, route=)``): a client announces the
layout epoch it routes by, and a server whose epoch moved (a live resize,
:mod:`distlr_tpu_torch.ps.membership`) fences its ops with
:class:`PSEpochError`.  With a ``route`` provider the worker re-fetches
the coordinator's layout and rebuilds its handle in place, also without a
retry policy: a reshard costs a re-route, never a restart, and a gradient
push caught by the fence is absorbed, never re-issued.  The JAX package's
membership series are attributes (:attr:`KVWorker.reroutes`,
``epoch_mismatches``, ``client_epoch``).

Not ported yet: the trace spans and registry counters (ROADMAP A.12).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import random
import threading
import time

import numpy as np

from distlr_tpu_torch.ps import wire
from distlr_tpu_torch.ps.build import client_lib
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Order of the counters a server stats probe returns (kv_protocol.h);
#: the ``cpu_*`` tail is per-handler thread-CPU seconds.
STATS_FIELDS = (
    "dim",
    "initialized",
    "pending_sync_pushes",
    "barrier_waiters",
    "total_pushes",
    "total_pulls",
    "cpu_push_seconds",
    "cpu_pull_seconds",
    "cpu_stats_seconds",
    "cpu_barrier_seconds",
    "epoch",
)
if len(STATS_FIELDS) != wire.STATS_VALS or STATS_FIELDS[wire.STATS_VALS_V1 - 1] != "total_pulls":
    raise ImportError("STATS_FIELDS disagrees with kv_protocol.h's kStats layout (ps/wire.py)")

_lock = threading.Lock()
_lib = None


class PSTimeoutError(TimeoutError):
    """A KV op hit the receive timeout: in sync mode, a dead or slow
    worker holding the BSP barrier (the reference deadlocks forever
    there, SURVEY.md §5.3)."""


class PSRejectedError(OSError):
    """The server answered an explicit rejection: the op does not apply
    to its configuration (an FTRL opt-state op against an sgd server,
    say).  Deterministic: re-issuing it cannot succeed."""


class PSEpochError(OSError):
    """A server's membership-epoch fence bounced the op: the layout this
    client routes by is stale (ranks joined or retired, kv_protocol.h
    kEpoch).  Transient by design: re-fetch the layout from the
    coordinator, reconnect, and the op is legal again; a client with a
    ``route`` provider does so itself.  ``epoch`` is the epoch the server
    reported."""

    def __init__(self, msg: str, epoch: int = 0):
        super().__init__(msg)
        self.epoch = int(epoch)


class FaultRateTracker:
    """Sliding-window transport-fault counter -> adaptive backoff scale
    (``distlr_tpu/ps/client.py:204``).

    Scales a policy's backoff base by ``1 + 0.5 * faults`` seen in the
    last ``window_s`` seconds, capped at ``max_scale``: a fault storm
    backs off harder, a quiet window decays back to the base.
    """

    def __init__(self, window_s: float = 30.0, max_scale: float = 8.0):
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        if max_scale < 1.0:
            raise ValueError(f"max_scale must be >= 1, got {max_scale}")
        self.window_s = float(window_s)
        self.max_scale = float(max_scale)
        self._faults: list[float] = []

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        # faults append in time order, so the stale prefix is contiguous
        drop = 0
        for t in self._faults:
            if t >= cutoff:
                break
            drop += 1
        if drop:
            del self._faults[:drop]

    def record(self, now: float | None = None) -> None:
        """One observed transport fault (call at failure time)."""
        now = time.monotonic() if now is None else now
        self._prune(now)
        self._faults.append(now)

    def scale(self, now: float | None = None) -> float:
        """Current backoff-base multiplier in [1, max_scale]."""
        now = time.monotonic() if now is None else now
        self._prune(now)
        return min(self.max_scale, 1.0 + 0.5 * len(self._faults))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """In-place recovery policy for transient KV transport faults
    (``distlr_tpu/ps/client.py:253``): bounded attempts, jittered
    exponential backoff and a per-op wall deadline.

    Only idempotent ops are always re-issued (pulls, stats, barrier
    votes: the server rolls a dead connection's vote out of the count).
    A gradient push is re-issued only while ``kv_op_delivery_began`` is
    0; otherwise its outcome is unknown, and it is counted and absorbed.
    Sync (BSP) pushes are never retried: the deferred reply is the
    barrier, and the timeout is the named straggler signal.
    """

    #: total tries per op, the first issue included (>= 1)
    attempts: int = 4
    #: base of the exponential backoff between tries
    backoff_ms: float = 50.0
    #: backoff cap (jitter applies after the cap)
    backoff_max_ms: float = 2000.0
    #: +/- fraction of each backoff drawn uniformly (0 = a fixed ladder)
    jitter: float = 0.2
    #: wall deadline per op across all tries
    deadline_s: float = 60.0
    #: seed of the jitter draw (None = nondeterministic)
    seed: int | None = None
    #: scale the backoff base by the recent fault rate (FaultRateTracker)
    adaptive: bool = False
    adaptive_window_s: float = 30.0
    adaptive_max_scale: float = 8.0

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")
        if self.backoff_ms < 0 or self.backoff_max_ms < self.backoff_ms:
            raise ValueError(
                "need 0 <= backoff_ms <= backoff_max_ms, got "
                f"{self.backoff_ms}/{self.backoff_max_ms}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        if self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive, got {self.deadline_s}")
        if self.adaptive_window_s <= 0:
            raise ValueError(
                f"adaptive_window_s must be positive, "
                f"got {self.adaptive_window_s}")
        if self.adaptive_max_scale < 1.0:
            raise ValueError(
                f"adaptive_max_scale must be >= 1, "
                f"got {self.adaptive_max_scale}")

    @classmethod
    def from_config(cls, cfg) -> "RetryPolicy | None":
        """The policy a Config asks for, or None when retries are off
        (``ps_retry_attempts == 0``): the one construction the PS workers,
        the online trainer and the serving pulls share."""
        if cfg.ps_retry_attempts <= 0:
            return None
        return cls(
            attempts=cfg.ps_retry_attempts,
            backoff_ms=cfg.ps_retry_backoff_ms,
            backoff_max_ms=cfg.ps_retry_backoff_max_ms,
            deadline_s=cfg.ps_retry_deadline_s,
            adaptive=bool(getattr(cfg, "ps_retry_adaptive", False)),
        )

    def backoff_s(self, retry_index: int, rng: random.Random,
                  scale: float = 1.0) -> float:
        """Sleep before re-issue number ``retry_index`` (0-based);
        ``scale`` multiplies the base, and the cap applies after it."""
        base = min(self.backoff_ms * scale * (2.0 ** retry_index),
                   self.backoff_max_ms)
        if self.jitter:
            base *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(base, 0.0) / 1000.0


def _load():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(client_lib()))
                lib.kv_connect.restype = ctypes.c_void_p
                lib.kv_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
                for name in ("kv_push_vpk", "kv_pull_vpk"):
                    fn = getattr(lib, name)
                    fn.restype = ctypes.c_int
                    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint64, ctypes.c_uint64]
                lib.kv_push_pull_vpk.restype = ctypes.c_int
                lib.kv_push_pull_vpk.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                ]
                lib.kv_push_init.restype = ctypes.c_int
                lib.kv_push_init.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                ]
                lib.kv_barrier.restype = ctypes.c_int
                lib.kv_barrier.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
                lib.kv_wait.restype = ctypes.c_int
                lib.kv_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.kv_shutdown_servers.restype = ctypes.c_int
                lib.kv_shutdown_servers.argtypes = [ctypes.c_void_p]
                lib.kv_set_timeout_ms.restype = ctypes.c_int
                lib.kv_set_timeout_ms.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.kv_set_push_visit_all.restype = ctypes.c_int
                lib.kv_set_push_visit_all.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.kv_timed_out.restype = ctypes.c_int
                lib.kv_timed_out.argtypes = [ctypes.c_void_p]
                lib.kv_op_rejected.restype = ctypes.c_int
                lib.kv_op_rejected.argtypes = [ctypes.c_void_p]
                lib.kv_op_delivery_began.restype = ctypes.c_int
                lib.kv_op_delivery_began.argtypes = [ctypes.c_void_p]
                lib.kv_negotiate_codec.restype = ctypes.c_int
                lib.kv_negotiate_codec.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.kv_last_wire_sent.restype = ctypes.c_uint64
                lib.kv_last_wire_sent.argtypes = [ctypes.c_void_p]
                for name in ("kv_negotiate_epoch", "kv_set_epoch"):
                    fn = getattr(lib, name)
                    fn.restype = ctypes.c_int
                    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
                for name in ("kv_epoch_mismatch", "kv_group_epoch"):
                    fn = getattr(lib, name)
                    fn.restype = ctypes.c_int
                    fn.argtypes = [ctypes.c_void_p]
                for name in ("kv_pull_opt_state", "kv_push_init_opt_state"):
                    fn = getattr(lib, name)
                    fn.restype = ctypes.c_int
                    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint64]
                lib.kv_push_init_opt_state.argtypes += [ctypes.c_int]
                lib.kv_stats.restype = ctypes.c_int
                lib.kv_stats.argtypes = [  # out buffer is float64 (see kv_protocol.h)
                    ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint64,
                ]
                lib.kv_last_error.restype = ctypes.c_char_p
                lib.kv_last_error.argtypes = [ctypes.c_void_p]
                lib.kv_close.restype = None
                lib.kv_close.argtypes = [ctypes.c_void_p]
                _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class KVWorker:
    """Blocking Push/Pull/Wait client over a range-sharded server group.

    ``hosts`` is ``"ip:port,..."`` in server-rank order; server ``r`` of
    ``S`` owns keys ``[r*dim/S, (r+1)*dim/S)``.  ``timeout_ms`` bounds
    every receive (0 blocks forever, the reference's semantics).
    ``sync_group=False`` (an async group) lets keyed pushes skip servers
    whose key slice is empty; a sync group must visit all, because an
    empty push is that worker's vote in the BSP round.  ``compress`` asks
    for a gradient wire codec (``none``, ``int8``, ``signsgd``);
    :attr:`compress_active` is the one in force.  ``retry`` (a
    :class:`RetryPolicy`) re-issues ops after a transport fault, by the
    rules of :meth:`_run_with_retry`.

    ``route``, a zero-argument callable returning the coordinator's layout
    (``{"hosts", "epoch", "status", "dim", ...}``: ``MembershipCoordinator.
    layout`` or :func:`~distlr_tpu_torch.ps.membership.layout_client`),
    makes the worker follow a live resize; its hosts override ``hosts``,
    which may predate a resize, and ``epoch`` defaults to its epoch.
    ``epoch`` announces the layout epoch to every server, so that the
    fence protects this client.  Ops on one worker must not overlap: one
    connection per server, one op at a time.
    """

    def __init__(self, hosts: str | None, dim: int, client_id: int = 0, *,
                 timeout_ms: int = 0, sync_group: bool = True,
                 retry: RetryPolicy | None = None, compress: str = "none",
                 epoch: int | None = None, route=None, route_timeout_s: float = 30.0):
        from distlr_tpu_torch.compress import CODEC_IDS  # noqa: PLC0415

        if compress not in CODEC_IDS:
            raise ValueError(f"compress must be one of {tuple(CODEC_IDS)}, got {compress!r}")
        self._lib = _load()
        self.dim = int(dim)
        self._route = route
        self._route_timeout_s = float(route_timeout_s)
        self._epoch = int(epoch) if epoch else 0
        self._epoch_armed = False
        self._warned_no_epoch = False
        #: the JAX package's membership series, kept here: routing
        #: re-negotiations, ops bounced by a fence, and the epoch this
        #: worker last connected at (0 = none announced)
        self.reroutes = 0
        self.epoch_mismatches = 0
        self.client_epoch = 0
        if route is not None:
            # the coordinator is authoritative: a stale hosts list announced
            # with the current epoch would pass every fence while slicing
            # ranges by the wrong layout
            layout = self._fetch_active_layout()
            if hosts is not None and hosts != layout["hosts"]:
                log.info("route provider overrides stale hosts %s -> %s", hosts,
                         layout["hosts"])
            hosts = layout["hosts"]
            if not self._epoch:
                self._epoch = int(layout.get("epoch") or 0)
        if hosts is None:
            raise ValueError("KVWorker needs hosts or a route provider")
        self.hosts = hosts
        self.num_servers = hosts.count(",") + 1
        self._client_id = client_id
        self._timeout_ms = int(timeout_ms)
        self._sync_group = sync_group
        self.retry = retry
        self._retry_rng = random.Random(retry.seed if retry else None)
        self._fault_rate = (FaultRateTracker(retry.adaptive_window_s, retry.adaptive_max_scale)
                            if retry is not None and retry.adaptive else None)
        #: the JAX package's registry counters, kept here: re-issued ops by
        #: op name, rebuilt handles, and absorbed pushes of unknown outcome
        self.retries: dict[str, int] = {}
        self.reconnects = 0
        self.push_outcome_unknown = 0
        #: the wire codec asked for ("none" = dense f32, never negotiated)
        self.compress = compress
        #: the codec in force after the kHello handshake ("none" when a
        #: server of the group lacks it); None until the first handshake,
        #: so that the first outcome, a fallback too, is always logged
        self.compress_active: str | None = None
        self._codec_id = CODEC_IDS[compress]
        #: bytes of the delivered gradient pushes: ``raw`` what they would
        #: have cost as dense f32 (the keys as given + 4 bytes a value),
        #: ``wire`` what left for the servers (headers + keys + coded
        #: payload, summed over servers); a failed push counts in neither
        self.push_bytes_raw = 0
        self.push_bytes_wire = 0
        self._sign_zero_checked = False  # the first sign-coded push is checked
        self._dense_rows: tuple[np.ndarray, int] | None = None
        self._h = None
        if route is None:
            self._h = self._build_handle()
        else:
            # a route-provided client may start mid-migration or inside a
            # partition: poll through connect failures as a re-route does,
            # within route_timeout_s
            deadline = time.monotonic() + self._route_timeout_s
            while True:
                try:
                    self._h = self._build_handle()
                    break
                except OSError as e:
                    if time.monotonic() >= deadline:
                        raise
                    log.debug("route-provided connect failed (%s); re-fetching layout", e)
                    time.sleep(0.05)
                    self._apply_layout(self._fetch_active_layout())
        # dense default key set 0..D-1, like the reference app (src/lr.cc:117-121)
        self._all_keys = np.arange(self.dim, dtype=np.uint64)

    def _build_handle(self):
        """A new native handle with this worker's hosts, dim, client id,
        timeout and group mode, its codec negotiated when one was asked
        for (the codec state lives a handle) and its epoch announced when
        it has one."""
        lib = self._lib
        h = lib.kv_connect(self.hosts.encode(), self.dim, self._client_id)
        if not h:
            raise ConnectionError(f"could not connect to KV servers at {self.hosts}")
        try:
            if self._timeout_ms and lib.kv_set_timeout_ms(h, self._timeout_ms) != 0:
                raise OSError("failed to set KV socket timeout")
            if not self._sync_group:
                lib.kv_set_push_visit_all(h, 0)
            if self._codec_id:
                got = lib.kv_negotiate_codec(h, self._codec_id)
                if got < 0:
                    raise OSError("codec negotiation failed: " + lib.kv_last_error(h).decode())
                active = self.compress if got == self._codec_id else "none"
                if active != self.compress_active:
                    if active == "none":
                        log.warning("KV group at %s does not advertise codec %r; "
                                    "falling back to dense f32 pushes", self.hosts,
                                    self.compress)
                    else:
                        log.info("negotiated %r gradient pushes with %s", active, self.hosts)
                self.compress_active = active
            else:
                self.compress_active = "none"
            if self._epoch:
                got = lib.kv_negotiate_epoch(h, self._epoch)
                if got < 0:
                    raise OSError("epoch negotiation failed: " + lib.kv_last_error(h).decode())
                if got == 0:
                    # a group that predates epochs: no fencing, as a
                    # pre-epoch client
                    if not self._warned_no_epoch:
                        log.warning("KV group at %s predates membership epochs; "
                                    "epoch fencing disabled for this client", self.hosts)
                        self._warned_no_epoch = True
                    self._epoch_armed = False
                elif got != self._epoch:
                    raise PSEpochError(
                        f"group at {self.hosts} is at membership epoch {got}; this "
                        f"client's layout says {self._epoch} — re-fetch routing from "
                        "the coordinator", epoch=got)
                else:
                    self._epoch_armed = True
                    self.client_epoch = self._epoch
        except Exception:
            lib.kv_close(h)
            raise
        return h

    def reconnect(self) -> None:
        """Rebuild the native handle in place, the way out of a poisoned
        connection (after one failed receive every later op on that stream
        fails); the codec is negotiated and the epoch announced anew.  The
        new connections open before the old ones close, so a failed
        reconnect (servers still down) raises and leaves the old handle as
        it was."""
        h = self._build_handle()
        old, self._h = self._h, h
        if old:
            self._lib.kv_close(old)
        self.reconnects += 1

    def recover(self) -> None:
        """Rebuild the handle after a failed op: :meth:`reconnect`, or for a
        client with a ``route`` a re-route, since a resize may have retired
        or re-fenced the ranks it held."""
        if self._route is not None:
            self._renegotiate_route()
        else:
            self.reconnect()

    # -- membership re-routing ----------------------------------------------
    def _fetch_active_layout(self) -> dict:
        """Poll the route provider until it reports an active layout (a
        client landing mid-migration waits the drain out here), within
        ``route_timeout_s``."""
        deadline = time.monotonic() + self._route_timeout_s
        delay = 0.05
        last: Exception | None = None
        while True:
            layout = None
            try:
                layout = self._route()
            except Exception as e:  # noqa: BLE001 — the coordinator may be mid-flip
                last = e
            if layout is not None and layout.get("status", "active") == "active":
                return layout
            if time.monotonic() >= deadline:
                raise OSError(f"membership layout fetch timed out after "
                              f"{self._route_timeout_s:g}s"
                              + (f" (last error: {last})" if last else
                                 " (coordinator still migrating)"))
            time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
            delay = min(delay * 2, 0.5)

    def _renegotiate_route(self) -> None:
        """The fence's recovery: re-fetch the layout and rebuild the
        handle against the new ranks at the new epoch, polling through a
        migration window within ``route_timeout_s``."""
        deadline = time.monotonic() + self._route_timeout_s
        last: Exception | None = None
        while True:
            self._apply_layout(self._fetch_active_layout())
            try:
                self.reconnect()
            except OSError as e:
                # a PSEpochError here: the fetched layout is already stale
                # (a second resize raced this one); else the new ranks may
                # still be binding.  Poll again either way
                last = e
            else:
                self.reroutes += 1
                log.info("membership re-route: now at epoch %d over %d server(s)",
                         self._epoch, self.num_servers)
                return
            if time.monotonic() >= deadline:
                raise OSError(f"membership re-route failed after "
                              f"{self._route_timeout_s:g}s: {last}")
            time.sleep(0.05)

    def _apply_layout(self, layout: dict) -> None:
        hosts = layout["hosts"]
        if "dim" in layout and int(layout["dim"]) != self.dim:
            raise OSError(f"membership layout changed the key-space dim "
                          f"({self.dim} -> {layout['dim']}): not a reshard — "
                          "this client cannot follow")
        self.hosts = hosts
        self.num_servers = hosts.count(",") + 1
        self._epoch = int(layout.get("epoch") or 0)
        # the range boundaries moved: the dense row encoding re-derives
        self._dense_rows = None

    # -- in-place retry and re-route ---------------------------------------
    def _run_with_retry(self, op: str, fn, *, idempotent: bool, on_failure=None):
        """The retry driver (``distlr_tpu/ps/client.py:735``).  With no
        policy and no route, or for a sync group's gradient push, a plain
        call.  A :class:`PSRejectedError` is never retried.

        The transport ladder (:meth:`_retry_ladder`) runs under a
        membership layer that is live whenever a ``route`` is set, with or
        without a policy.  A resize surfaces as an epoch fence
        (:class:`PSEpochError`) from a running rank or as transport
        exhaustion against a retired one; both recover by re-fetching the
        layout and rebuilding the handle, at most 8 times an op.  A
        gradient push caught by the fence, or whose frames reached a
        kernel (``kv_op_delivery_began``), is absorbed through the
        unknown-outcome path (``-1``, or ``on_failure``), never re-issued:
        a peer whose epoch flipped a moment later may have applied its
        slice.
        """
        if not idempotent and self._sync_group:
            return fn()  # BSP pushes: fail fast, no retry, no re-route
        if self.retry is None and self._route is None:
            return fn()
        max_reroutes = 8 if self._route is not None else 0
        for reroute in range(max_reroutes + 1):
            try:
                return self._retry_ladder(op, fn, idempotent=idempotent, on_failure=on_failure)
            except PSRejectedError:
                raise  # deterministic: identical on every re-issue
            except PSEpochError:
                self.epoch_mismatches += 1
                if reroute >= max_reroutes:
                    raise  # no coordinator to ask, or it keeps handing stale layouts
                if not idempotent:
                    return self._absorb(on_failure, self._renegotiate_route)
                self._renegotiate_route()  # raises OSError on timeout
            except OSError:
                if not idempotent and self._lib.kv_op_delivery_began(self._h):
                    # without a policy the ladder is a plain call, so the
                    # delivery-proof decision lands here
                    return self._absorb(on_failure, self._renegotiate_route)
                if reroute >= max_reroutes:
                    raise
                # transport exhaustion with a route provider: maybe a retired
                # rank.  Nothing of this op was delivered, so re-issue
                self._renegotiate_route()
        raise AssertionError("unreachable")

    def _absorb(self, on_failure, recover):
        """A gradient push of unknown outcome: count it, recover the
        handle best-effort, and resolve it by ``on_failure`` (the fused
        push_pull re-pulls) or as -1; never re-issue it."""
        self.push_outcome_unknown += 1
        with contextlib.suppress(OSError):
            recover()  # best-effort: later ops retry their own
        if on_failure is not None:
            return on_failure()
        return -1

    def _retry_ladder(self, op: str, fn, *, idempotent: bool, on_failure):
        """The transport-fault half of :meth:`_run_with_retry`: reconnect,
        back off and re-issue within the policy's attempts and deadline (a
        plain call without a policy).  A gradient push is re-issued only
        while ``kv_op_delivery_began`` is 0.  :class:`PSEpochError` and
        exhaustion go up to the membership layer."""
        pol = self.retry
        if pol is None:
            return fn()
        deadline = time.monotonic() + pol.deadline_s
        last: Exception | None = None
        for attempt in range(pol.attempts):
            if attempt:
                scale = self._fault_rate.scale() if self._fault_rate is not None else 1.0
                nap = pol.backoff_s(attempt - 1, self._retry_rng, scale)
                time.sleep(min(nap, max(0.0, deadline - time.monotonic())))
                try:
                    self.reconnect()
                except PSEpochError:
                    raise  # resharded while backing off: the layer above re-routes
                except OSError as e:
                    # servers unreachable: the reconnect burns the attempt
                    self._record_fault()
                    last = e
                    if time.monotonic() >= deadline:
                        break
                    continue
                if time.monotonic() >= deadline:
                    # crossed during the backoff: surface the last failure
                    # rather than block a further full receive timeout
                    break
                self.retries[op] = self.retries.get(op, 0) + 1
            try:
                return fn()
            except (PSRejectedError, PSEpochError):
                raise  # both handled a layer up, neither is a fault
            except OSError as e:
                self._record_fault()
                if not idempotent and self._lib.kv_op_delivery_began(self._h):
                    return self._absorb(on_failure, self.reconnect)
                last = e
                if time.monotonic() >= deadline:
                    break
        assert last is not None
        raise last

    def _record_fault(self) -> None:
        if self._fault_rate is not None:
            self._fault_rate.record()

    def _with_retry(self, op: str, fn):
        """Idempotent ops: re-issue is always legal (the server rolls a
        dead connection's state back, so a re-issue counts once)."""
        return self._run_with_retry(op, fn, idempotent=True)

    def _push_with_retry(self, op: str, fn, *, on_unknown=None):
        """Gradient-carrying ops: the delivery-proof rules of
        :meth:`_run_with_retry`."""
        return self._run_with_retry(op, fn, idempotent=False, on_failure=on_unknown)

    def set_timeout(self, timeout_ms: int) -> None:
        """Receive timeout for every op; 0 = block forever."""
        if self._lib.kv_set_timeout_ms(self._h, int(timeout_ms)) != 0:
            raise OSError("failed to set KV socket timeout")
        self._timeout_ms = int(timeout_ms)

    def _check(self, ts: int, what: str) -> int:
        if ts < 0:
            err = self._lib.kv_last_error(self._h).decode()
            if self._lib.kv_timed_out(self._h):
                raise PSTimeoutError(f"KV {what} timed out: {err}")
            if self._lib.kv_epoch_mismatch(self._h):
                raise PSEpochError(f"KV {what} fenced: {err}",
                                   epoch=self._lib.kv_group_epoch(self._h))
            if self._lib.kv_op_rejected(self._h):
                raise PSRejectedError(f"KV {what} rejected: {err}")
            raise OSError(f"KV {what} failed: {err}")
        return ts

    def _validate_keys(self, keys, vpk: int = 1) -> np.ndarray:
        """``keys`` as strictly ascending in-range u64s (the native range
        slicer binary-searches range boundaries).  With ``vpk > 1`` keys
        are row ids over a ``dim // vpk`` row space."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        space = self.dim // vpk
        if keys.size:
            kmax = int(keys.max())
            if kmax >= space:
                raise ValueError(f"key {kmax} out of range (dim={self.dim}"
                                 + (f", vals_per_key={vpk} -> {space} rows)" if vpk > 1
                                    else ")"))
            if keys.size > 1 and not (keys[1:] > keys[:-1]).all():
                raise ValueError("keys must be strictly ascending")
        return keys

    def supports_vals_per_key(self, vpk: int) -> bool:
        """Whether ``vals_per_key=vpk`` ops can be range-sliced over this
        group: every range boundary (``dim*s/S``) must be a multiple of
        vpk, so no row straddles two servers.  Where it is False, callers
        send expanded per-lane keys instead."""
        if vpk <= 1:
            return True
        if self.dim % vpk != 0:
            return False
        return all((self.dim * s // self.num_servers) % vpk == 0
                   for s in range(1, self.num_servers))

    def _default_or_validated(self, keys, vpk: int) -> np.ndarray:
        """The dense default key set (flat ids, so never with ``vpk > 1``:
        that would reinterpret flat ids as row ids), or ``keys`` checked."""
        if keys is None:
            if vpk != 1:
                raise ValueError("vals_per_key > 1 requires explicit row keys (the dense "
                                 "default key set is flat ids, not rows)")
            return self._all_keys
        return self._validate_keys(keys, vpk)

    def _dense_row_encoding(self) -> tuple[np.ndarray, int]:
        """Row keys of a dense default-key push under a codec: the largest
        ``vpk`` (at most the protocol's cap) that divides ``dim`` and
        aligns with the group's range boundaries, so the key frame shrinks
        from ``dim`` u64s to ``dim/vpk`` (at D = 1M, 8 MB of keys become
        2 KB).  Flat keys when no divisor aligns; the uncompressed path
        always keeps the flat dense key set."""
        if self._dense_rows is None:
            best = 1
            for v in range(min(wire.MAX_VALS_PER_KEY, self.dim), 1, -1):
                if self.dim % v == 0 and self.supports_vals_per_key(v):
                    best = v
                    break
            keys = np.arange(self.dim // best, dtype=np.uint64) if best > 1 else self._all_keys
            self._dense_rows = (keys, best)
        return self._dense_rows

    def _push_frame(self, keys, vpk: int, vals: np.ndarray):
        """A gradient push's ``(raw_bytes, keys, vpk)``: ``raw`` is what
        the push would cost as dense f32 (the keys as given + 4 bytes a
        value), and a dense default-key push rides the row encoding when
        a codec is in force (:meth:`_dense_row_encoding`)."""
        if self.compress_active == "signsgd" and not self._sign_zero_checked:
            # 1-bit signSGD has no abstention: an exact zero votes -1, so a
            # mostly-zero gradient walks every untouched weight by +lr a
            # round.  One check, on the first coded push.
            self._sign_zero_checked = True
            if vals.size and np.count_nonzero(vals) < vals.size // 2:
                log.warning("signsgd push is mostly exact zeros (%d of %d coordinates): zero "
                            "votes decode -1 and drift untouched weights by +lr a round; "
                            "push touched keys only, or use compress='int8' for sparse "
                            "gradients", vals.size - np.count_nonzero(vals), vals.size)
        if keys is None and vpk == 1 and self.compress_active != "none":
            raw = self._all_keys.nbytes + vals.nbytes
            keys, vpk = self._dense_row_encoding()
            keys = self._validate_keys(keys, vpk)
        else:
            keys = self._default_or_validated(keys, vpk)
            raw = keys.nbytes + vals.nbytes
        if vals.shape[0] != keys.shape[0] * vpk:
            raise ValueError(f"{vals.shape[0]} vals vs {keys.shape[0]} keys "
                             f"x vals_per_key {vpk}")
        return raw, keys, vpk

    def _account_push(self, raw: int) -> None:
        self.push_bytes_raw += raw
        self.push_bytes_wire += int(self._lib.kv_last_wire_sent(self._h))

    @property
    def compress_ratio(self) -> float | None:
        """Cumulative raw / wire bytes of the delivered pushes (about 1 for
        dense f32; None before the first push)."""
        return self.push_bytes_raw / self.push_bytes_wire if self.push_bytes_wire else None

    def push(self, vals: np.ndarray, keys: np.ndarray | None = None, *,
             vals_per_key: int = 1) -> int:
        """Blocking push; in sync mode it returns only after ALL workers
        pushed (the server's deferred reply is the BSP barrier).  The
        first push to an uninitialized group seeds the weights.

        ``vals_per_key=R``: keys are R-lane ROW ids (row ``k`` owns flat
        slots ``[k*R, (k+1)*R)``) and ``vals`` holds ``len(keys)*R`` floats
        row-major, one u64 of key on the wire per R values (requires
        :meth:`supports_vals_per_key`).  Under a negotiated codec the
        values cross the wire coded."""
        vals = np.ascontiguousarray(vals, dtype=np.float32).reshape(-1)
        raw, keys, vpk = self._push_frame(keys, int(vals_per_key), vals)

        def issue():
            ts = self._check(self._lib.kv_push_vpk(self._h, _ptr(keys), _ptr(vals),
                                                   keys.shape[0], vpk), "push")
            self._account_push(raw)
            return ts
        return self._push_with_retry("push", issue)

    def push_init(self, vals: np.ndarray, keys: np.ndarray | None = None,
                  *, force: bool = False) -> int:
        """Idempotent weight-seeding push: initializes an uninitialized
        group and no-ops otherwise (kInitPush); ``force=True`` overwrites
        live weights (kForceInit)."""
        vals = np.ascontiguousarray(vals, dtype=np.float32).reshape(-1)
        keys = self._default_or_validated(keys, 1)
        if vals.shape[0] != keys.shape[0]:
            raise ValueError(f"{vals.shape[0]} vals vs {keys.shape[0]} keys")

        def issue():
            ts = self._lib.kv_push_init(self._h, _ptr(keys), _ptr(vals), keys.shape[0],
                                        1 if force else 0)
            return self._check(ts, "push_init")
        # idempotent: kInitPush no-ops once seeded, kForceInit re-sends the same values
        return self._with_retry("push_init", issue)

    def push_pull(self, vals: np.ndarray, keys: np.ndarray | None = None, *,
                  vals_per_key: int = 1) -> np.ndarray:
        """Fused push + pull: push a gradient and receive the post-update
        weights for the same keys in ONE round trip per server (the
        reference spends two per batch, ``src/lr.cc:116-132``).  Sync:
        blocks through the BSP round; the reply is the post-round state,
        the same bits as the pull that would have followed.
        ``vals_per_key``: see :meth:`push`."""
        vals = np.ascontiguousarray(vals, dtype=np.float32).reshape(-1)
        raw, keys, vpk = self._push_frame(keys, int(vals_per_key), vals)
        out = np.empty(keys.shape[0] * vpk, dtype=np.float32)

        def issue():
            ts = self._lib.kv_push_pull_vpk(self._h, _ptr(keys), _ptr(vals), _ptr(out),
                                            keys.shape[0], vpk)
            self._check(ts, "push_pull")
            self._account_push(raw)
            return out
        # an unknown push outcome is absorbed; the pull half is re-issued
        # idempotently, so the caller still gets the keys' current weights
        return self._push_with_retry("push_pull", issue,
                                     on_unknown=lambda: self.pull(keys, vals_per_key=vpk))

    def pull(self, keys: np.ndarray | None = None, *, vals_per_key: int = 1) -> np.ndarray:
        """Blocking pull of ``keys`` (default: all ``dim`` weights).
        ``vals_per_key=R``: keys are row ids and the result holds
        ``len(keys)*R`` floats row-major (see :meth:`push`)."""
        vpk = int(vals_per_key)
        keys = self._default_or_validated(keys, vpk)
        out = np.empty(keys.shape[0] * vpk, dtype=np.float32)

        def issue():
            self._check(self._lib.kv_pull_vpk(self._h, _ptr(keys), _ptr(out), keys.shape[0],
                                              vpk), "pull")
            return out
        return self._with_retry("pull", issue)

    def pull_chunked(self, keys: np.ndarray | None = None, *, vals_per_key: int = 1,
                     chunk_rows: int = 1 << 16) -> np.ndarray:
        """Pull a large key set as a sequence of keyed pulls of at most
        ``chunk_rows`` rows each, so a periodic weight refresh never holds a
        server's receive loop for a whole table against a trainer pushing
        to the same group (the scoring tier's read path).  ``keys=None``
        pulls the full row space ``0..dim/vals_per_key`` as explicit keys;
        an ascending ``keys`` array (hot-row serving) is chunked as given;
        an empty one gives an empty f32 array."""
        vpk = int(vals_per_key)
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        if vpk > 1 and not self.supports_vals_per_key(vpk):
            raise ValueError(f"vals_per_key={vpk} rows straddle this group's range "
                             "boundaries; pull with vals_per_key=1 instead")
        if keys is None:
            space = self.dim // vpk
            parts = [self.pull(np.arange(lo, min(lo + chunk_rows, space), dtype=np.uint64),
                               vals_per_key=vpk)
                     for lo in range(0, space, chunk_rows)]
        else:
            keys = self._validate_keys(keys, vpk)
            parts = [self.pull(keys[lo:lo + chunk_rows], vals_per_key=vpk)
                     for lo in range(0, keys.shape[0], chunk_rows)]
        if not parts:
            return np.empty(0, np.float32)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def pull_rows_into(self, table: np.ndarray, keys: np.ndarray, *, vals_per_key: int = 1,
                       chunk_rows: int = 1 << 16) -> int:
        """Keyed hot-slice pull: fetch only the ``keys`` rows and scatter
        them into ``table`` in place (the serving tier's working-set
        refresh, :mod:`distlr_tpu_torch.serve.hotset`).  A refresh moves
        ``rows * (8 + 4*vpk)`` wire bytes; every cold row of ``table``
        keeps the last full pull's value.  ``table`` must be a
        C-contiguous float32 array of ``dim`` elements (flat or
        ``(rows, vals_per_key)``); returns the rows pulled."""
        vpk = int(vals_per_key)
        table = np.asarray(table)
        if table.dtype != np.float32 or table.size != self.dim or not table.flags["C_CONTIGUOUS"]:
            raise ValueError(f"table must be C-contiguous float32 with {self.dim} elements, "
                             f"got {table.dtype} shape {table.shape}")
        keys = self._validate_keys(keys, vpk)
        if keys.size == 0:
            return 0
        vals = self.pull_chunked(keys, vals_per_key=vpk, chunk_rows=chunk_rows)
        table.reshape(self.dim // vpk, vpk)[keys.astype(np.int64)] = vals.reshape(-1, vpk)
        return int(keys.size)

    def pull_opt_state(self) -> tuple[np.ndarray, np.ndarray]:
        """The server's FTRL accumulators ``(z, n)`` over this handle's
        whole key range (kOptState).  One server a handle: the
        ``[z..., n...]`` layout cannot be range-sliced.  Raises
        :class:`PSRejectedError` against a server without FTRL."""
        if self.num_servers != 1:
            raise ValueError("pull_opt_state addresses ONE server per handle (got "
                             f"{self.num_servers}); use a per-rank connection")
        out = np.empty(2 * self.dim, dtype=np.float32)

        def issue():
            self._check(self._lib.kv_pull_opt_state(self._h, _ptr(self._all_keys), _ptr(out),
                                                    self._all_keys.shape[0]), "pull_opt_state")
            return out[:self.dim].copy(), out[self.dim:].copy()
        return self._with_retry("pull_opt_state", issue)

    def push_init_opt_state(self, z: np.ndarray, n: np.ndarray, *,
                            force: bool = False) -> int:
        """Seed the server's FTRL z and n (idempotent as :meth:`push_init`;
        ``force=True`` overwrites): with a forced weight init, a fresh
        group resumes an FTRL trajectory exactly.  One server a handle."""
        if self.num_servers != 1:
            raise ValueError("push_init_opt_state addresses ONE server per handle "
                             f"(got {self.num_servers}); use a per-rank connection")
        z = np.ascontiguousarray(z, dtype=np.float32).reshape(-1)
        n = np.ascontiguousarray(n, dtype=np.float32).reshape(-1)
        if z.shape[0] != self.dim or n.shape[0] != self.dim:
            raise ValueError(f"z/n must each hold dim={self.dim} values, got "
                             f"{z.shape[0]}/{n.shape[0]}")
        buf = np.concatenate([z, n])

        def issue():
            ts = self._lib.kv_push_init_opt_state(self._h, _ptr(self._all_keys), _ptr(buf),
                                                  self._all_keys.shape[0], 1 if force else 0)
            return self._check(ts, "push_init_opt_state")
        return self._with_retry("push_init_opt_state", issue)

    def wait(self, ts: int) -> None:
        """No-op for API parity: push and pull already block (the
        reference pairs every Push/Pull with an immediate Wait)."""
        self._lib.kv_wait(self._h, ts)

    def barrier(self, barrier_id: int = 0) -> None:
        """Worker-group barrier via server 0 (``Postoffice::Barrier``,
        reference ``src/main.cc:150``).  ``barrier_id`` is the
        generation: a late vote for a released generation returns at
        once."""
        if not 0 <= barrier_id <= wire.AUX_MAX:
            # the wire field is u16 (MsgHeader::aux): truncation could
            # alias a released generation
            raise ValueError(f"barrier_id must fit in uint16, got {barrier_id}")
        # a re-vote after a reconnect counts once: closing the failed
        # connection rolls its pending vote out of server 0's count
        self._with_retry("barrier", lambda: self._check(
            self._lib.kv_barrier(self._h, barrier_id), "barrier"))

    def stats(self, server: int = 0) -> dict:
        """Counters of one server (never deferred, so it answers while
        the sync barrier waits)."""
        out = np.zeros(len(STATS_FIELDS), dtype=np.float64)

        def issue():
            n = self._check(self._lib.kv_stats(self._h, server, _ptr(out), out.shape[0]),
                            "stats")
            return {name: float(v) if name.startswith("cpu_") else int(v)
                    for name, v in zip(STATS_FIELDS, out[:n])}
        return self._with_retry("stats", issue)

    def global_pushes(self, *, per_worker_scale: bool = True) -> float:
        """The group's push clock: every server's ``total_pushes`` summed
        and, with ``per_worker_scale``, divided by the server count, so one
        dense push (which lands on every range) ticks it by 1.  The
        seeding push counts too."""
        total = sum(self.stats(r)["total_pushes"] for r in range(self.num_servers))
        return total / self.num_servers if per_worker_scale else float(total)

    def set_epoch(self, epoch: int) -> None:
        """Admin: flip every server of this handle to membership epoch
        ``epoch`` (kEpoch SET), the coordinator's fence.  Clients announce
        through ``epoch=`` and recover through ``route=`` instead."""
        if self._lib.kv_set_epoch(self._h, int(epoch)) != 0:
            raise OSError("epoch set failed: " + self._lib.kv_last_error(self._h).decode())

    def group_epoch(self) -> int:
        """The newest membership epoch any server reported to this handle
        (0 = never epoch-negotiated)."""
        return int(self._lib.kv_group_epoch(self._h))

    def shutdown_servers(self) -> None:
        self._lib.kv_shutdown_servers(self._h)

    def namespace(self, base: int, dim: int) -> "KVNamespace":
        """A view of this worker whose ops address only the flat-slot
        slice ``[base, base + dim)`` (see :class:`KVNamespace`)."""
        return KVNamespace(self, base, dim)

    def close(self) -> None:
        if self._h:
            self._lib.kv_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def parse_namespace_optimizers(spec) -> dict[str, str]:
    """Per-namespace server optimizers of an extended namespaces spec:
    ``"v1:sgd,v2"`` -> ``{"v1": "sgd"}``; entries without a ``:opt``
    suffix are omitted (they ride the group's optimizer), bare specs give
    ``{}``.  Only ``sgd`` and ``ftrl`` are legal a namespace (sign votes
    mean a majority vote only through a uniform signsgd group)."""
    if not isinstance(spec, str):
        return {}
    opts: dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        mid, _, opt = part.partition(":")
        mid, opt = mid.strip(), opt.strip()
        if opt not in ("sgd", "ftrl"):
            raise ValueError(f"namespace optimizer must be sgd|ftrl, got {part!r}")
        opts[mid] = opt
    return opts


def namespace_layout(models, per_model_dim: int) -> dict[str, tuple[int, int]]:
    """Pack equal-width model namespaces into one flat key space:
    ``{model_id: (base, per_model_dim)}`` in spec order, namespace ``i``
    owning flat slots ``[i*D, (i+1)*D)``.  The group is spawned with the
    total dim ``len(models) * per_model_dim``; a server count dividing the
    model count (or one server) keeps every range boundary on a namespace
    boundary.  A ``:opt`` suffix of an entry (:func:`parse_namespace_
    optimizers`) is stripped, so clients repeat the server's spec
    verbatim.

    Equal widths only: a spec asking for per-model dims (``"v1=8192,
    v2=1024"`` or a ``{model: dim}`` mapping) with different widths is
    refused, as in JAX; equal explicit dims spell the uniform case."""
    explicit_dims: dict[str, int] = {}
    if isinstance(models, dict):
        explicit_dims = {str(m): int(d) for m, d in models.items()}
        models = list(models)
    elif isinstance(models, str):
        parsed = []
        for part in models.split(","):
            part = part.strip()
            if not part:
                continue
            mid, eq, dim = part.partition("=")
            mid = mid.partition(":")[0].strip()
            parsed.append(mid)
            if eq:
                try:
                    explicit_dims[mid] = int(dim)
                except ValueError:
                    raise ValueError(f"bad namespace dim in {part!r} "
                                     "(want <model>=<int>)") from None
        models = parsed
    models = list(models)
    if not models:
        raise ValueError("namespace layout needs at least one model id")
    if len(set(models)) != len(models):
        raise ValueError(f"duplicate model ids in {models}")
    if explicit_dims:
        widths = sorted(set(explicit_dims.values()))
        if len(widths) > 1 or (per_model_dim and widths != [int(per_model_dim)]):
            raise ValueError(
                "heterogeneous-dim namespaces are not supported by the "
                f"equal-width layout (asked for {explicit_dims}, "
                f"uniform width {per_model_dim}): per-model widths need "
                "the packed namespace_layout follow-on (cumulative-sum "
                "bases + per-namespace range alignment) tracked in "
                "ROADMAP.md 'Carried minor debts' — until then give "
                "every model the same dim")
        per_model_dim = widths[0]
    if per_model_dim <= 0:
        raise ValueError(f"per_model_dim must be positive, got {per_model_dim}")
    return {m: (i * per_model_dim, per_model_dim) for i, m in enumerate(models)}


class KVNamespace:
    """A model namespace inside one KV server group's key space.

    Namespace ``i`` owns a contiguous flat-slot slice; this view offsets
    every key by the namespace base on the client side, so the wire
    carries plain ascending keyed ops.  The underlying :class:`KVWorker`
    is connected with the group's total dim; the view presents the
    namespace's ``dim`` through the worker's op surface (``vals_per_key``
    rows, ``pull_chunked``, ``pull_rows_into``, ``push_pull``).

    Seeding: the group's ``initialized`` flag is global (the first init
    push wins), so a later namespace's plain ``push_init`` is a no-op; a
    namespace seeding non-zero weights into an initialized group passes
    ``force=True`` (a keyed force-init overwrites only its keys).
    """

    def __init__(self, kv: KVWorker, base: int, dim: int):
        if dim <= 0:
            raise ValueError(f"namespace dim must be positive, got {dim}")
        if base < 0 or base + dim > kv.dim:
            raise ValueError(f"namespace [{base}, {base + dim}) outside the group's "
                             f"key space [0, {kv.dim})")
        self.kv = kv
        self.base = int(base)
        self.dim = int(dim)

    @property
    def num_servers(self) -> int:
        return self.kv.num_servers

    @property
    def compress_active(self):
        return self.kv.compress_active

    def supports_vals_per_key(self, vpk: int) -> bool:
        """Rows work inside the namespace when they work group-wide and
        the slice is row-aligned (base and dim multiples of ``vpk``)."""
        if vpk <= 1:
            return True
        return (self.base % vpk == 0 and self.dim % vpk == 0
                and self.kv.supports_vals_per_key(vpk))

    def _wire_keys(self, keys, vpk: int) -> np.ndarray:
        """Namespace-local row keys -> group row keys; ``keys=None`` is the
        namespace's whole row space as explicit keys."""
        if self.base % vpk != 0 or self.dim % vpk != 0:
            raise ValueError(f"vals_per_key={vpk} does not align with namespace "
                             f"base={self.base}/dim={self.dim}")
        rows = self.dim // vpk
        shift = self.base // vpk
        if keys is None:
            return np.arange(shift, shift + rows, dtype=np.uint64)
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if keys.size:
            kmax = int(keys.max())
            if kmax >= rows:
                raise ValueError(f"key {kmax} outside namespace row space [0, {rows}) "
                                 f"(vals_per_key={vpk})")
        return keys + np.uint64(shift)

    def pull(self, keys=None, *, vals_per_key: int = 1) -> np.ndarray:
        vpk = int(vals_per_key)
        return self.kv.pull(self._wire_keys(keys, vpk), vals_per_key=vpk)

    def pull_chunked(self, keys=None, *, vals_per_key: int = 1,
                     chunk_rows: int = 1 << 16) -> np.ndarray:
        vpk = int(vals_per_key)
        return self.kv.pull_chunked(self._wire_keys(keys, vpk), vals_per_key=vpk,
                                    chunk_rows=chunk_rows)

    def pull_rows_into(self, table: np.ndarray, keys: np.ndarray, *, vals_per_key: int = 1,
                       chunk_rows: int = 1 << 16) -> int:
        """Keyed hot-slice pull into a namespace-sized table."""
        vpk = int(vals_per_key)
        table = np.asarray(table)
        if table.dtype != np.float32 or table.size != self.dim or not table.flags["C_CONTIGUOUS"]:
            raise ValueError(f"table must be C-contiguous float32 with {self.dim} elements, "
                             f"got {table.dtype} shape {table.shape}")
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if keys.size == 0:
            return 0
        vals = self.pull_chunked(keys, vals_per_key=vpk, chunk_rows=chunk_rows)
        table.reshape(self.dim // vpk, vpk)[keys.astype(np.int64)] = vals.reshape(-1, vpk)
        return int(keys.size)

    def push(self, vals: np.ndarray, keys=None, *, vals_per_key: int = 1) -> int:
        vpk = int(vals_per_key)
        return self.kv.push(vals, self._wire_keys(keys, vpk), vals_per_key=vpk)

    def push_pull(self, vals: np.ndarray, keys=None, *, vals_per_key: int = 1) -> np.ndarray:
        vpk = int(vals_per_key)
        return self.kv.push_pull(vals, self._wire_keys(keys, vpk), vals_per_key=vpk)

    def push_init(self, vals: np.ndarray, keys=None, *, force: bool = False) -> int:
        """Seed this namespace's slice (see the class docstring)."""
        return self.kv.push_init(vals, self._wire_keys(keys, 1), force=force)

    def stats(self, server: int = 0) -> dict:
        return self.kv.stats(server)

    def global_pushes(self, **kw) -> float:
        return self.kv.global_pushes(**kw)

    def wait(self, ts: int) -> None:
        self.kv.wait(ts)

    def reconnect(self) -> None:
        self.kv.reconnect()

    def close(self) -> None:
        self.kv.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
