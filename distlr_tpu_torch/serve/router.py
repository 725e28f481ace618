"""The serving tier's routing front-end: one listener over N engine replicas.

Counterpart of ``distlr_tpu/serve/router.py``.  It speaks the replica line
protocol (libsvm line, JSON batch, ``STATS``), so clients cannot tell a
router from a single :class:`~distlr_tpu_torch.serve.server.ScoringServer`:

* **load balancing**: least in-flight among healthy replicas, with a
  rotated tie-break so idle-time traffic still spreads
  (:mod:`~distlr_tpu_torch.serve.balance`).
* **admission control**: a bounded in-flight budget a replica
  (``max_inflight``).  A request that finds every healthy replica full
  gets ``ERR SHED`` (overload: scale up); a tier with no healthy replica
  answers ``ERR ROUTE`` and counts an error (outage: page someone).  Every
  accepted line is answered or refused, never left hanging.
* **failure detection**: passive (``eject_after`` consecutive transport
  failures eject a replica) and active (``STATS`` probes of idle
  replicas); ejected replicas are probed on an exponential backoff and
  reinstated on the first success.
* **retry-once failover**: scoring is idempotent, so a request whose
  replica dies mid-exchange is retried on another replica; an ``ERR``
  reply from a replica (malformed input) passes through untouched.
* **label fan-out**: a ``LABEL <id> <y>`` line is broadcast to every
  healthy replica (of the connection's model), and the best outcome
  (``joined`` > ``duplicate`` > ``pending``) is the reply.  A replica
  without a feedback sink answers ``ERR``; when none accepts, the router
  answers ``ERR LABEL``.
* **multi-tenant registry**: the replica spec may name several model
  versions (``v1=h:p+h:p,v2=h:p``,
  :func:`~distlr_tpu_torch.serve.tenant.parse_model_spec`); requests
  address one by ``MODEL <id>`` scoping or an ``@<id>`` prefix; each
  tenant may carry a token-bucket quota (``ERR SHED tenant``), a SHADOW
  mirror (a fraction of its traffic replayed against a candidate off the
  reply path, compared by PSI) and a SPLIT (the canary ramp's weighted
  routing, driven by ``launch rollout`` through the ``SPLIT`` /
  ``SHADOW`` / ``PROMOTE`` / ``ADDREPLICA`` / ``DELREPLICA`` / ``MODELS``
  admin lines).

The router counts in the JAX package's ``distlr_route_*`` and
``distlr_tenant_*`` registry series (per listener, per replica, per
tenant); ``STATS`` answers from the listener's series (counts as deltas
since the router was made, ``p50_ms`` / ``p99_ms`` from its request
histogram), and each replica's counts are attributes of its
``_Replica``.  A scoring line is a ``route.request`` span under a
distributed-trace context (:mod:`distlr_tpu_torch.obs.dtrace`): the
caller's ``TRACE <tid>/<sid>`` prefix, else a root the router mints; a
sampled context travels to the replica as ``TRACE <token> <line>`` (a
retry resends it as it was).  The router itself is stdlib code: ``launch
route`` needs no card.
"""

from __future__ import annotations

import json
import random
import socket
import socketserver

from distlr_tpu_torch import sync
from distlr_tpu_torch.obs import dtrace
from distlr_tpu_torch.obs.registry import get_registry
from distlr_tpu_torch.serve import balance as _balance
from distlr_tpu_torch.serve import tenant as _tenant
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_reg = get_registry()
_REQ_SECONDS = _reg.histogram(
    "distlr_route_request_seconds",
    "wall seconds per routed request line (admission to reply, incl. "
    "retries)", labelnames=("listener",),
)
_REQUESTS = _reg.counter(
    "distlr_route_requests_total",
    "request lines answered from a replica", labelnames=("listener",),
)
_ERRORS = _reg.counter(
    "distlr_route_errors_total",
    "accepted request lines that failed on every tried replica",
    labelnames=("listener",),
)
_SHED = _reg.counter(
    "distlr_route_shed_total",
    "request lines shed at admission (no healthy replica with a free "
    "in-flight slot)", labelnames=("listener",),
)
_RETRIES = _reg.counter(
    "distlr_route_retries_total",
    "transparent retries on another replica after a transport failure",
    labelnames=("listener",),
)
_REPLICA_UP = _reg.gauge(
    "distlr_route_replica_up",
    "1 while the replica is in rotation (0 = ejected)",
    labelnames=("replica",),
)
_REPLICA_INFLIGHT = _reg.gauge(
    "distlr_route_replica_inflight",
    "requests currently in flight to the replica", labelnames=("replica",),
)
_EJECTIONS = _reg.counter(
    "distlr_route_ejections_total",
    "replica ejections after consecutive transport failures",
    labelnames=("replica",),
)
_REINSTATES = _reg.counter(
    "distlr_route_reinstates_total",
    "ejected replicas reinstated by a successful backoff probe",
    labelnames=("replica",),
)
_EJECT_SUPPRESSED = _reg.counter(
    "distlr_route_eject_suppressed_total",
    "ejections suppressed by the last-healthy floor (the replica "
    "crossed eject_after consecutive failures but is the only healthy "
    "replica left in one of its model pools)",
    labelnames=("replica",),
)
_LABELS = _reg.counter(
    "distlr_route_labels_total",
    "LABEL feedback lines fanned out to replicas, by best outcome "
    "(joined/duplicate/pending/failed)",
    labelnames=("listener", "outcome"),
)


class _Replica:
    """One engine replica: address, bounded in-flight budget, a pool of
    persistent connections, and health state (guarded by the router's lock,
    except the connection pool, which has its own)."""

    def __init__(self, addr: str, *, max_inflight: int, timeout_s: float):
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"replica must be host:port, got {addr!r}")
        if "[" in host or "]" in host or ":" in host:
            # fail at construction, not as per-request gaierrors later
            raise ValueError(f"IPv6 replica addresses are not supported, got {addr!r} "
                             "(use a hostname or IPv4 host:port)")
        self.addr = addr
        self.host, self.port = host, int(port)
        self.timeout_s = timeout_s
        #: model ids this address is registered under: an address under
        #: several ids hosts several engines and gets @-addressed lines; an
        #: address under one id serves it as its default engine, bare lines
        self.models: set[str] = set()
        self._sem = sync.BoundedSemaphore(max_inflight)
        self._pool_lock = sync.Lock()
        self._idle: list[tuple] = []
        self.healthy = True
        self.consecutive_errors = 0
        self.inflight = 0
        self.requests = 0
        self.errors = 0
        self.ejections = 0
        self.reinstates = 0
        self.backoff_s = 0.0
        self.next_probe_at = 0.0
        self.last_ok = 0.0      # monotonic: last successful exchange or probe
        self.last_probe = 0.0
        self._up_g = _REPLICA_UP.labels(replica=addr)
        self._inflight_g = _REPLICA_INFLIGHT.labels(replica=addr)
        self._up_g.set(1.0)
        self._inflight_g.set(0.0)

    def try_acquire(self) -> bool:
        if self._sem.acquire(blocking=False):
            self.inflight += 1
            self._inflight_g.inc()
            return True
        return False

    def release(self) -> None:
        self.inflight -= 1
        self._inflight_g.dec()
        self._sem.release()

    def _dial(self):
        s = socket.create_connection((self.host, self.port), timeout=self.timeout_s)
        return s, s.makefile("rwb")

    def _checkin(self, conn) -> None:
        with self._pool_lock:
            if self.healthy:
                self._idle.append(conn)
                return
        self._close(conn)

    @staticmethod
    def _close(conn) -> None:
        sock, f = conn
        for closer in (f.close, sock.close):
            try:
                closer()
            except OSError:
                pass

    def drain_pool(self) -> None:
        with self._pool_lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            self._close(conn)

    def _roundtrip(self, conn, line: str) -> str:
        _, f = conn
        f.write((line + "\n").encode())
        f.flush()
        reply = f.readline()
        if not reply:
            raise ConnectionError(f"replica {self.addr} closed the connection")
        return reply.decode().rstrip("\n")

    def exchange(self, line: str) -> str:
        """One request/reply toward this replica.  Raises on a transport
        failure (the retry and eject trigger); an ``ERR`` reply is a
        successful exchange.  A failure on a pooled connection is retried
        once on a freshly dialed one first: an idle socket gone stale (the
        replica restarted between bursts) says nothing about the replica,
        and scores are idempotent, so resending is safe."""
        conn = None
        with self._pool_lock:
            if self._idle:
                conn = self._idle.pop()
        if conn is not None:
            try:
                reply = self._roundtrip(conn, line)
            except Exception:  # noqa: BLE001 — a stale pooled socket: dial anew
                self._close(conn)
            else:
                self._checkin(conn)
                return reply
        conn = self._dial()
        try:
            reply = self._roundtrip(conn, line)
        except Exception:
            self._close(conn)
            raise
        self._checkin(conn)
        return reply


class _RouterHandler(socketserver.StreamRequestHandler):
    def handle(self):
        router: ScoringRouter = self.server.router  # type: ignore[attr-defined]
        scope: str | None = None  # MODEL <id> connection scoping
        try:
            for raw in self.rfile:
                line = raw.decode("utf-8", errors="replace").strip()
                if not line:
                    continue
                if line == "MODEL" or line.startswith("MODEL "):
                    reply, scope = router.handle_model_line(line, scope)
                else:
                    reply = router.handle_line(line, model=scope)
                try:
                    self.wfile.write((reply + "\n").encode())
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    return
        except ConnectionResetError:
            pass  # the peer reset mid-read: not an error


class _TCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class ScoringRouter:
    """Health-checked load-balancing front-end over engine replicas.

    ``replicas``: a list (or comma-separated string) of ``host:port``
    addresses of running :class:`ScoringServer` listeners (or nested
    routers), or a multi-model registry spec or mapping
    (``v1=h:p+h:p,v2=h:p``).  One address may serve several models (a
    server hosting several engines): it shares one health state and
    in-flight budget.  ``quotas``: per-tenant token buckets
    (``model=rate[:burst]`` or a mapping).  ``seed`` seeds the split and
    shadow draws.
    """

    def __init__(self, replicas, *, host: str = "127.0.0.1", port: int = 0,
                 max_inflight: int = 64, eject_after: int = 3, health_interval_s: float = 1.0,
                 probe_backoff_s: float = 0.5, probe_backoff_max_s: float = 30.0,
                 backend_timeout_s: float = 30.0, retries: int = 1, quotas=None,
                 shadow_block: int = 256, shadow_queue_max: int = 256, seed: int | None = None):
        models = _tenant.parse_model_spec(replicas)
        if max_inflight <= 0:
            raise ValueError(f"max_inflight must be positive, got {max_inflight}")
        if eject_after < 1:
            raise ValueError(f"eject_after must be >= 1, got {eject_after}")
        if health_interval_s <= 0:
            raise ValueError(f"health_interval_s must be positive, got {health_interval_s}")
        if probe_backoff_s <= 0 or probe_backoff_max_s < probe_backoff_s:
            raise ValueError("need 0 < probe_backoff_s <= probe_backoff_max_s, got "
                             f"{probe_backoff_s}/{probe_backoff_max_s}")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        by_addr: dict[str, _Replica] = {}
        self._model_replicas: dict[str, list[_Replica]] = {}
        for model, addrs in models.items():
            reps = []
            for a in addrs:
                rep = by_addr.get(a)
                if rep is None:
                    rep = by_addr[a] = _Replica(a, max_inflight=max_inflight,
                                                timeout_s=backend_timeout_s)
                rep.models.add(model)
                reps.append(rep)
            self._model_replicas[model] = reps
        self._by_addr = by_addr
        self.replicas = list(by_addr.values())
        self.model_ids = list(models)
        self.default_model = self.model_ids[0]
        self.quotas = _tenant.parse_quota_spec(quotas)
        unknown = sorted(set(self.quotas) - set(self.model_ids))
        if unknown:
            raise ValueError(f"quota names unregistered model(s) {unknown}; hosted: "
                             f"{self.model_ids}")
        #: canary split and shadow state: tenant -> (candidate, fraction)
        self._splits: dict[str, tuple[str, float]] = {}
        self._shadows: dict[str, tuple[str, float]] = {}
        #: after PROMOTE, the model id a tenant's traffic is addressed as on
        #: the wire (one address can host both engines, so swapping the
        #: replica list alone would not select the candidate's engine)
        self._serve_as: dict[str, str] = {}
        self._rng = random.Random(seed)
        self._per_model = {m: {"requests": 0, "shed": 0} for m in self.model_ids}
        self._shadow_block = int(shadow_block)
        self._shadow_queue_max = int(shadow_queue_max)
        self._shadow_mirror: _tenant.ShadowMirror | None = None
        self.max_inflight = int(max_inflight)
        self.eject_after = int(eject_after)
        self.health_interval_s = float(health_interval_s)
        self.probe_backoff_s = float(probe_backoff_s)
        self.probe_backoff_max_s = float(probe_backoff_max_s)
        self.backend_timeout_s = float(backend_timeout_s)
        self.probe_timeout_s = min(float(backend_timeout_s), 2.0)
        self._retries = int(retries)
        self._lock = sync.Lock()   # health state, rotation, counters
        self._rr = 0
        self._t0 = sync.monotonic()
        self._tcp = _TCPServer((host, port), _RouterHandler, bind_and_activate=True)
        self._tcp.router = self  # type: ignore[attr-defined]
        self.host, self.port = self._tcp.server_address[:2]
        listener = f"{self.host}:{self.port}"
        self._req_seconds = _REQ_SECONDS.labels(listener=listener)
        #: the listener's counters, and their values when this router was
        #: made (a router restarted on the same fixed port resolves the
        #: same children)
        self._series = {"requests": _REQUESTS.labels(listener=listener),
                        "errors": _ERRORS.labels(listener=listener),
                        "shed": _SHED.labels(listener=listener),
                        "retries": _RETRIES.labels(listener=listener)}
        self._series_base = {k: c.value for k, c in self._series.items()}
        _tenant.set_model_count(len(self.model_ids))
        self._stop = sync.Event()
        self._started = False
        self._accept_thread = sync.Thread(target=self._tcp.serve_forever, daemon=True,
                                          name="distlr-route-accept")
        self._health_thread = sync.Thread(target=self._health_loop, daemon=True,
                                          name="distlr-route-health")

    def _count(self, name: str) -> None:
        self._series[name].inc()

    # -- replica selection and health ----------------------------------------
    def _acquire(self, excluded: list, model: str | None = None) -> _Replica | None:
        """A healthy replica (of ``model``'s slice when given) with a free
        in-flight slot, in :func:`balance.order_candidates` order."""
        with self._lock:
            pool = self.replicas if model is None else self._model_replicas.get(model, [])
            cands = [r for r in pool if r.healthy and r not in excluded]
            ordered, self._rr = _balance.order_candidates(cands, self._rr)
            for rep in ordered:
                if rep.try_acquire():
                    return rep
            return None

    def _release(self, rep: _Replica) -> None:
        with self._lock:
            rep.release()

    def _note_success(self, rep: _Replica) -> None:
        with self._lock:
            _balance.note_success(rep, sync.monotonic())

    def _note_failure(self, rep: _Replica) -> None:
        with self._lock:
            _balance.note_failure(rep)
            verdict = _balance.eject_verdict(rep, self._pools_locked(rep), self.eject_after)
            if verdict == "eject":
                _balance.eject(rep, sync.monotonic(), self.probe_backoff_s)
                self._post_eject_locked(rep)
            elif verdict == "floor":
                self._floor_locked(rep)

    def _pools_locked(self, rep: _Replica) -> list:
        """The replica lists of every model ``rep`` serves: what the
        last-healthy floor arbitrates over."""
        return [self._model_replicas.get(m, []) for m in sorted(rep.models)]

    def _post_eject_locked(self, rep: _Replica) -> None:
        rep._up_g.set(0.0)
        _EJECTIONS.labels(replica=rep.addr).inc()
        log.warning("replica %s ejected after %d consecutive failures; probing with %.2fs "
                    "backoff", rep.addr, rep.consecutive_errors, rep.backoff_s)
        rep.drain_pool()  # pooled sockets to a suspect replica are suspect

    def _floor_locked(self, rep: _Replica) -> None:
        _EJECT_SUPPRESSED.labels(replica=rep.addr).inc()
        if rep.consecutive_errors == self.eject_after:
            log.warning("replica %s crossed the eject threshold (%d consecutive failures) but "
                        "is the LAST healthy replica of a pool it serves; keeping it in "
                        "rotation (ejection floor)", rep.addr, rep.consecutive_errors)

    def _probe(self, rep: _Replica) -> bool:
        """Active health check: a STATS round trip on a fresh connection."""
        try:
            with socket.create_connection((rep.host, rep.port),
                                          timeout=self.probe_timeout_s) as s:
                f = s.makefile("rwb")
                f.write(b"STATS\n")
                f.flush()
                reply = f.readline()
            ok = bool(reply)
            if ok:
                try:
                    doc = json.loads(reply)
                    if isinstance(doc, dict) and doc.get("replicas_up") == 0:
                        # a nested router answers STATS with its whole tier
                        # down: do not reinstate a subtree that serves nothing
                        ok = False
                except ValueError:
                    pass
        except OSError:
            ok = False
        with self._lock:
            outcome = _balance.probe_result(
                rep, ok, sync.monotonic(), probe_backoff_s=self.probe_backoff_s,
                probe_backoff_max_s=self.probe_backoff_max_s, eject_after=self.eject_after,
                pools=self._pools_locked(rep))
            if outcome == "reinstated":
                rep._up_g.set(1.0)
                _REINSTATES.labels(replica=rep.addr).inc()
                log.info("replica %s reinstated", rep.addr)
            elif outcome == "ejected":
                self._post_eject_locked(rep)
            elif outcome == "floor":
                self._floor_locked(rep)
        return ok

    def _health_loop(self) -> None:
        tick = max(0.01, min(self.health_interval_s, 0.25))
        while not self._stop.wait(tick):
            now = sync.monotonic()
            # a snapshot: ADDREPLICA / DELREPLICA change the list meanwhile
            for rep in list(self.replicas):
                with self._lock:
                    due = _balance.probe_due(rep, now, self.health_interval_s,
                                             self.probe_backoff_s)
                if due:
                    self._probe(rep)

    # -- label fan-out ---------------------------------------------------------
    #: the reply preferred when replicas disagree
    _LABEL_ORDER = {"joined": 0, "duplicate": 1, "pending": 2}

    def _broadcast_label(self, line: str, model: str | None = None) -> str:
        with self._lock:
            pool = self.replicas if model is None else self._model_replicas.get(model, [])
            targets = [r for r in pool if r.healthy]
        best: str | None = None
        for rep in targets:
            with self._lock:
                admitted = rep.try_acquire()
            if not admitted:
                continue  # a saturated replica: its window ages the id out
            try:
                reply = rep.exchange(line)
            except Exception:  # noqa: BLE001 — a transport failure
                self._note_failure(rep)
                continue
            finally:
                self._release(rep)
            self._note_success(rep)
            if reply.startswith("OK"):
                outcome = reply[2:].strip() or "joined"
                if (best is None
                        or self._LABEL_ORDER.get(outcome, 3) < self._LABEL_ORDER.get(best, 3)):
                    best = outcome
                if best in ("joined", "duplicate"):
                    # terminal: only the scoring replica joins, and fanning
                    # further would park the label in every other's buffer
                    break
        _LABELS.labels(listener=f"{self.host}:{self.port}",
                       outcome=best if best is not None else "failed").inc()
        if best is not None:
            return f"OK {best}"
        self._count("errors")
        return ("ERR LABEL: no replica accepted the label (are the replicas running a "
                "feedback sink?)")

    # -- multi-tenant control plane ------------------------------------------
    def _unknown_model(self, model: str) -> str:
        return f"ERR MODEL: unknown model {model!r} (hosted: {','.join(self.model_ids)})"

    def handle_model_line(self, line: str, scope: str | None) -> tuple[str, str | None]:
        """``MODEL <id>`` connection scoping: later unaddressed lines route
        to that model's replicas.  Returns ``(reply, new_scope)``; an
        unknown id keeps the old scope."""
        parts = line.split()
        if len(parts) != 2:
            self._count("errors")
            return "ERR MODEL: need MODEL <id>", scope
        if parts[1] not in self._model_replicas:
            self._count("errors")
            return self._unknown_model(parts[1]), scope
        return f"OK MODEL {parts[1]}", parts[1]

    def _check_models_locked(self, tenant: str, candidate: str) -> None:
        for m in (tenant, candidate):
            if m not in self._model_replicas:
                raise ValueError(f"unknown model {m!r} (hosted: {','.join(self.model_ids)})")
        if tenant == candidate:
            raise ValueError(f"tenant and candidate are both {tenant!r}")

    def set_split(self, tenant: str, candidate: str, weight: float) -> None:
        """Canary split: route ``weight`` of ``tenant``'s scoring traffic
        to ``candidate``; 0 clears it (the rollback)."""
        if not 0.0 <= weight <= 1.0:
            raise ValueError(f"weight must be in [0, 1], got {weight}")
        with self._lock:
            self._check_models_locked(tenant, candidate)
            if weight == 0.0:
                self._splits.pop(tenant, None)
            else:
                self._splits[tenant] = (candidate, float(weight))
        log.info("split: %s -> %s at %.3f", tenant, candidate, weight)

    def set_shadow(self, tenant: str, candidate: str, fraction: float) -> None:
        """Shadow mirror: replay ``fraction`` of ``tenant``'s scoring
        traffic against ``candidate`` off the reply path; 0 clears it."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")
        with self._lock:
            self._check_models_locked(tenant, candidate)
            if fraction == 0.0:
                self._shadows.pop(tenant, None)
            else:
                self._shadows[tenant] = (candidate, float(fraction))
                if self._shadow_mirror is None:
                    self._shadow_mirror = _tenant.ShadowMirror(
                        self._exchange_for_model, queue_max=self._shadow_queue_max,
                        block=self._shadow_block)
        log.info("shadow: %s -> %s at %.3f", tenant, candidate, fraction)

    def promote(self, tenant: str, candidate: str) -> None:
        """The ramp's last step: ``tenant``'s slice becomes ``candidate``'s
        replicas, addressed as the candidate on the wire; its split and
        shadow clear.  The candidate id stays addressable."""
        with self._lock:
            self._check_models_locked(tenant, candidate)
            self._model_replicas[tenant] = list(self._model_replicas[candidate])
            self._serve_as[tenant] = self._serve_as.get(candidate, candidate)
            self._splits.pop(tenant, None)
            self._shadows.pop(tenant, None)
        log.info("promoted: %s now serves %s's replicas", tenant, candidate)

    def add_replica(self, model: str, addr: str) -> None:
        """Register a (possibly new) replica address under ``model``: it
        enters rotation at once, under the usual health machinery.  An
        unknown ``model`` creates a new registry slice."""
        with self._lock:
            rep = self._by_addr.get(addr)
            if rep is None:
                rep = _Replica(addr, max_inflight=self.max_inflight,
                               timeout_s=self.backend_timeout_s)
                self._by_addr[addr] = rep
                self.replicas.append(rep)
            if model not in self._model_replicas:
                self._model_replicas[model] = []
                self.model_ids.append(model)
                self._per_model[model] = {"requests": 0, "shed": 0}
                _tenant.set_model_count(len(self.model_ids))
            pool = self._model_replicas[model]
            if rep in pool:
                raise ValueError(f"replica {addr} already registered under {model!r}")
            rep.models.add(model)
            pool.append(rep)
        log.info("replica %s added under model %s", addr, model)

    def remove_replica(self, model: str, addr: str) -> None:
        """Take a replica out of ``model``'s rotation; requests in flight on
        it complete.  An address left under no model is forgotten."""
        with self._lock:
            rep = self._by_addr.get(addr)
            pool = self._model_replicas.get(model)
            if rep is None or pool is None or rep not in pool:
                raise ValueError(f"replica {addr} not registered under {model!r}")
            pool.remove(rep)
            rep.models.discard(model)
            gone = not any(rep in p for p in self._model_replicas.values())
            if gone:
                self.replicas.remove(rep)
                del self._by_addr[addr]
                rep._up_g.set(0.0)
        if gone:
            rep.drain_pool()
        log.info("replica %s removed from model %s%s", addr, model,
                 " (forgotten)" if gone else "")

    def _handle_admin(self, line: str) -> str:
        parts = line.split()
        verb = parts[0]
        try:
            if verb in ("SPLIT", "SHADOW"):
                if len(parts) != 4:
                    raise ValueError(f"need {verb} <tenant> <candidate> <fraction>")
                frac = float(parts[3])
                (self.set_split if verb == "SPLIT" else self.set_shadow)(
                    parts[1], parts[2], frac)
                return f"OK {verb} {parts[1]} {parts[2]} {frac:g}"
            if verb in ("ADDREPLICA", "DELREPLICA"):
                if len(parts) != 3:
                    raise ValueError(f"need {verb} <model> <host:port>")
                (self.add_replica if verb == "ADDREPLICA" else self.remove_replica)(
                    parts[1], parts[2])
                return f"OK {verb} {parts[1]} {parts[2]}"
            if len(parts) != 3:
                raise ValueError("need PROMOTE <tenant> <candidate>")
            self.promote(parts[1], parts[2])
            return f"OK PROMOTE {parts[1]} {parts[2]}"
        except ValueError as e:
            self._count("errors")
            return f"ERR {verb}: {e}"

    def models_json(self) -> dict:
        """The registry, as the ``MODELS`` reply (what ``launch rollout``
        reads before ramping)."""
        with self._lock:
            return {
                "default": self.default_model,
                "models": {m: {"replicas": [r.addr for r in reps],
                               "up": sum(r.healthy for r in reps)}
                           for m, reps in self._model_replicas.items()},
                "splits": {t: list(sc) for t, sc in self._splits.items()},
                "shadows": {t: list(sc) for t, sc in self._shadows.items()},
                "serves_as": dict(self._serve_as),
            }

    def _exchange_for_model(self, model: str, line: str) -> str:
        """One admission-controlled exchange toward a model's replicas (the
        shadow mirror's send path): no retry, failures raise."""
        rep = self._acquire([], model)
        if rep is None:
            raise ConnectionError(f"no capacity toward model {model!r}")
        try:
            reply = rep.exchange(f"@{model} {line}" if len(rep.models) > 1 else line)
        except Exception:
            self._note_failure(rep)
            raise
        finally:
            self._release(rep)
        self._note_success(rep)
        return reply

    # -- request path ----------------------------------------------------------
    def handle_line(self, line: str, model: str | None = None) -> str:
        """One routed line.  ``model`` is the connection's ``MODEL`` scope;
        a per-request ``@<id>`` prefix overrides it."""
        if line == "STATS":
            return json.dumps(self.stats())
        if line == "MODELS":
            return json.dumps(self.models_json())
        if line.startswith(("SPLIT ", "SHADOW ", "PROMOTE ", "ADDREPLICA ", "DELREPLICA ")):
            return self._handle_admin(line)
        if line.startswith("@"):
            # a model-addressed label broadcasts to that model's replicas,
            # as a scoped one does
            prefix, _, rest = line.partition(" ")
            if rest.startswith("LABEL ") or rest == "LABEL":
                mid = prefix[1:]
                if mid not in self._model_replicas:
                    self._count("errors")
                    return self._unknown_model(mid)
                return self._broadcast_label(rest, mid)
        if line.startswith("LABEL ") or line == "LABEL":
            return self._broadcast_label(line, model)
        if line.startswith("TRACE "):
            parts = line.split(" ", 2)
            if len(parts) != 3:
                self._count("errors")
                return "ERR TRACE: need TRACE <trace_id>/<span_id> <line>"
            try:
                ctx = dtrace.parse_token(parts[1])
            except ValueError as e:
                self._count("errors")
                return f"ERR TRACE: {e}"
            line = parts[2]
        else:
            ctx = dtrace.new_trace()  # None until dtrace.configure ran
        if ctx is None:
            return self._route_line(line, model)
        with dtrace.use(ctx), dtrace.span(
                "route.request", tags={"listener": f"{self.host}:{self.port}"}) as sp:
            reply = self._route_line(line, model)
            if reply.startswith("ERR "):
                sp.tags["error"] = reply.split(":", 1)[0]
            return reply

    def _route_line(self, line: str, scope: str | None = None) -> str:
        # the tenant: an @-prefix, else the connection's scope, else the default
        if line.startswith("@"):
            prefix, _, rest = line.partition(" ")
            tenant, line = prefix[1:], rest.strip()
            if not tenant or not line:
                self._count("errors")
                return "ERR MODEL: need @<id> <request line>"
            if tenant not in self._model_replicas:
                self._count("errors")
                return self._unknown_model(tenant)
        else:
            tenant = scope if scope is not None else self.default_model
        # the tenant's quota, before any replica is touched: a tenant over
        # budget must not take in-flight slots
        q = self.quotas.get(tenant)
        if q is not None and not q.try_admit():
            with self._lock:
                self._per_model[tenant]["shed"] += 1
            _tenant.count_tenant_shed(tenant)
            return f"ERR SHED tenant: {tenant!r} over admission quota ({q.rate:g} req/s)"
        with self._lock:
            split = self._splits.get(tenant)
            shadow = self._shadows.get(tenant)
            serve_model = tenant
            if split is not None and self._rng.random() < split[1]:
                serve_model = split[0]
            # canary-served requests do not mirror (candidate against
            # candidate would read as agreement); decided before the
            # serve_as remap, which renames a promoted tenant's own primary
            canary = serve_model != tenant
            serve_model = self._serve_as.get(serve_model, serve_model)
            mirror = shadow is not None and not canary and self._rng.random() < shadow[1]
        # a sampled context rides to the replica as the TRACE prefix (a
        # retry resends it unchanged: scores are idempotent); the @-model
        # prefix is per replica, below
        tok = dtrace.token()
        t0 = sync.monotonic()
        excluded: list[_Replica] = []
        last_err = "no healthy replica in rotation"
        shed_only = True  # every failure so far was overload, not death
        for attempt in range(self._retries + 1):
            rep = self._acquire(excluded, serve_model)
            if rep is None:
                if attempt == 0:
                    with self._lock:
                        pool = self._model_replicas.get(serve_model, [])
                        any_healthy = any(r.healthy for r in pool)
                    if not any_healthy:
                        # an outage, not overload: an error, not a shed
                        self._count("errors")
                        return "ERR ROUTE: no healthy replica in rotation (all ejected)"
                    self._count("shed")
                    return "ERR SHED: no replica with free capacity (load shed)"
                break  # accepted, but no retry target left: fail loudly
            if attempt > 0:
                # counted once a replacement was actually acquired
                self._count("retries")
            routed = f"@{serve_model} {line}" if len(rep.models) > 1 else line
            wire = f"TRACE {tok} {routed}" if tok else routed
            try:
                reply = rep.exchange(wire)
            except Exception as e:  # noqa: BLE001 — any transport failure
                last_err = f"{type(e).__name__}: {e}"
                shed_only = False
                self._note_failure(rep)
                excluded.append(rep)
                continue
            finally:
                self._release(rep)
            if reply.startswith(("ERR SHED", "ERR ROUTE")):
                # only routers emit these: a nested tier that sheds is
                # overloaded (retry a sibling, do not count toward ejection);
                # one answering ROUTE has a dead subtree (retry and eject)
                last_err = reply
                if reply.startswith("ERR ROUTE"):
                    shed_only = False
                    self._note_failure(rep)
                excluded.append(rep)
                continue
            self._note_success(rep)
            self._req_seconds.observe(sync.monotonic() - t0)
            with self._lock:
                self._per_model[tenant]["requests"] += 1
            self._count("requests")
            _tenant.count_request(tenant)
            if mirror:
                # strictly after the reply is final
                scores = _tenant.extract_scores(reply)
                sm = self._shadow_mirror
                if scores and sm is not None:
                    sm.submit(tenant, shadow[0], line, scores)
            return reply
        if shed_only and excluded:
            # every tried child shed: the tier is overloaded, not down
            self._count("shed")
            return last_err
        self._count("errors")
        return f"ERR ROUTE: request failed on {len(excluded)} replica(s): {last_err}"

    # -- stats -----------------------------------------------------------------
    def stats(self) -> dict:
        """The scalar schema of :meth:`ScoringServer.stats` (requests,
        errors, qps, p50_ms, p99_ms, shed, retries, replica_count) plus the
        per-replica state and the per-model registry."""
        elapsed = max(sync.monotonic() - self._t0, 1e-9)
        with self._lock:
            reps = [{"addr": r.addr, "healthy": r.healthy, "inflight": r.inflight,
                     "requests": r.requests, "errors": r.errors, "ejections": r.ejections,
                     "reinstates": r.reinstates} for r in self.replicas]
            per_model = {}
            for m in self.model_ids:
                pool = self._model_replicas[m]
                pm = {"requests": self._per_model[m]["requests"],
                      "shed": self._per_model[m]["shed"],
                      "replicas": len(pool), "replicas_up": sum(r.healthy for r in pool)}
                if m in self._splits:
                    pm["split"] = list(self._splits[m])
                if m in self._shadows:
                    pm["shadow"] = list(self._shadows[m])
                q = self.quotas.get(m)
                if q is not None:
                    pm["quota"] = q.stats()
                per_model[m] = pm
        n = {k: int(c.value - self._series_base[k]) for k, c in self._series.items()}
        rec = {
            "requests": n["requests"],
            "errors": n["errors"],
            "qps": round(n["requests"] / elapsed, 2),
            "p50_ms": round(self._req_seconds.percentile(0.50) * 1e3, 3),
            "p99_ms": round(self._req_seconds.percentile(0.99) * 1e3, 3),
            "shed": n["shed"],
            "retries": n["retries"],
            "replica_count": len(reps),
            "replicas_up": sum(r["healthy"] for r in reps),
            "replicas": reps,
            "models": len(self.model_ids),
            "per_model": per_model,
        }
        sm = self._shadow_mirror
        if sm is not None:
            rec["shadow"] = sm.stats()
        return rec

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "ScoringRouter":
        self._started = True
        self._accept_thread.start()
        self._health_thread.start()
        log.info("routing on %s:%d over %d replica(s): %s", self.host, self.port,
                 len(self.replicas), ",".join(r.addr for r in self.replicas))
        return self

    def serve_forever(self) -> None:
        """Foreground mode for the CLI: start, then block until stopped."""
        self.start()
        try:
            while self._accept_thread.is_alive():
                self._accept_thread.join(timeout=1.0)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        self._stop.set()
        if self._started:
            # shutdown() blocks forever unless serve_forever ran
            self._tcp.shutdown()
            self._started = False
        self._tcp.server_close()
        if self._shadow_mirror is not None:
            self._shadow_mirror.stop()
        if self._health_thread.is_alive():
            self._health_thread.join(timeout=10.0)
        for rep in self.replicas:
            rep.drain_pool()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
