"""Multi-tenant serving primitives: many model versions, one fleet.

Counterpart of ``distlr_tpu/serve/tenant.py``, the pieces the router and
the scoring server share to make model identity first class:

* :func:`parse_model_spec`: the ``v1=host:p+host:p,v2=host:p`` replica
  registry grammar (a spec without ``=`` is the single-model form under
  :data:`DEFAULT_MODEL`).
* :class:`TenantQuota`: a token-bucket admission budget per tenant, on
  top of the router's in-flight sheds: a tenant past its rate gets an
  explicit ``ERR SHED tenant`` ("this tenant is over budget"), counted
  apart from capacity sheds ("the tier is out of capacity").
* :class:`ShadowMirror`: fire-and-forget mirroring of a fraction of a
  tenant's traffic to a candidate version, off the reply path (a bounded
  queue and a worker thread; a full queue drops the mirror and never
  delays the primary), comparing the two score distributions with the
  block-wise population stability index (PSI) the drift detector uses.

Tenant identity is the model id: ``MODEL <id>`` connection scoping or a
per-request ``@<id>`` prefix addresses it.  The JAX package's
``distlr_tenant_*`` series are recorded here (:func:`count_request`,
:func:`count_tenant_shed`, :func:`set_model_count`, the mirror's outcomes
and PSI); :meth:`TenantQuota.stats` and :meth:`ShadowMirror.stats` carry
the same numbers into the router's ``STATS``.
"""

from __future__ import annotations

import json

import numpy as np

from distlr_tpu_torch import sync
from distlr_tpu_torch.feedback.drift import psi
from distlr_tpu_torch.obs.registry import get_registry

#: model id of unaddressed traffic: a spec without ``=`` registers its
#: replicas here, so single-model clients and replica lists keep working
DEFAULT_MODEL = "default"

_reg = get_registry()
_TENANT_REQUESTS = _reg.counter(
    "distlr_tenant_requests_total",
    "request lines answered per tenant (model id) across the fleet",
    labelnames=("model",),
)
_TENANT_SHED = _reg.counter(
    "distlr_tenant_shed_total",
    "request lines shed by a tenant's token-bucket admission quota "
    "(distinct from distlr_route_shed_total capacity sheds: quota = "
    "'this tenant is over budget', capacity = 'scale the tier up')",
    labelnames=("model",),
)
_TENANT_MODELS = _reg.gauge(
    "distlr_tenant_models",
    "model versions currently registered in this routing tier",
)
_SHADOW_TOTAL = _reg.counter(
    "distlr_tenant_shadow_total",
    "requests mirrored to a candidate model version, by outcome "
    "(scored / error / dropped — dropped means the bounded mirror "
    "queue was full, the primary reply is NEVER delayed)",
    labelnames=("tenant", "candidate", "outcome"),
)
_SHADOW_PSI = _reg.gauge(
    "distlr_tenant_shadow_psi",
    "population stability index between a tenant's primary score "
    "distribution and its shadow candidate's, per completed comparison "
    "block (the promote/rollback evidence a canary ramp reads)",
    labelnames=("tenant", "candidate"),
)


def parse_model_spec(spec) -> dict[str, list[str]]:
    """Replica-registry grammar -> ordered ``{model_id: [host:port, ...]}``.

    ``"v1=h:1+h:2,v2=h:3"``: models separated by commas, a model's
    replicas by ``+``.  ``"h:1,h:2"`` (no ``=`` anywhere) is the
    single-model form: every address under :data:`DEFAULT_MODEL`.  Also
    accepts a mapping or an address list (normalized copies returned)."""
    if isinstance(spec, dict):
        out = {str(m): list(a) for m, a in spec.items()}
    elif isinstance(spec, (list, tuple)):
        out = {DEFAULT_MODEL: [str(a).strip() for a in spec if str(a).strip()]}
    else:
        spec = str(spec)
        if "=" not in spec:
            out = {DEFAULT_MODEL: [a.strip() for a in spec.split(",") if a.strip()]}
        else:
            out = {}
            for part in spec.split(","):
                part = part.strip()
                if not part:
                    continue
                model, eq, addrs = part.partition("=")
                model = model.strip()
                if not eq or not model:
                    raise ValueError(f"bad model spec entry {part!r} (want "
                                     "model=host:port+host:port)")
                if model in out:
                    raise ValueError(f"duplicate model id {model!r} in spec")
                out[model] = [a.strip() for a in addrs.split("+") if a.strip()]
    for model, addrs in out.items():
        if not addrs:
            raise ValueError(f"model {model!r} has no replica addresses")
        if len(set(addrs)) != len(addrs):
            raise ValueError(f"duplicate replica addresses for model {model!r}: {addrs}")
        if any(c in model for c in " \t@=,+"):
            raise ValueError(f"bad model id {model!r} (no spaces or @=,+)")
    if not out:
        raise ValueError("model spec names no models")
    return out


def parse_quota_spec(spec) -> dict[str, "TenantQuota"]:
    """``"v1=100:200,v2=50"`` -> ``{model: TenantQuota(rate, burst)}``
    (``rate`` requests/s, an optional ``:burst`` bucket depth, default
    ``2 * rate``).  Also accepts a ready mapping."""
    if not spec:
        return {}
    if isinstance(spec, dict):
        return {str(m): q if isinstance(q, TenantQuota) else TenantQuota(*q)
                for m, q in spec.items()}
    out: dict[str, TenantQuota] = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        model, eq, rest = part.partition("=")
        if not eq or not model.strip():
            raise ValueError(f"bad quota entry {part!r} (want model=rate[:burst])")
        if model.strip() in out:
            # a silent overwrite would ship a typo'd quota as the effective one
            raise ValueError(f"duplicate quota for model {model.strip()!r}")
        rate, _, burst = rest.partition(":")
        try:
            rate_f = float(rate)
            burst_f = float(burst) if burst else 2.0 * rate_f
        except ValueError as e:
            raise ValueError(f"bad quota entry {part!r}: {e}") from None
        out[model.strip()] = TenantQuota(rate_f, burst_f)
    return out


class TenantQuota:
    """Token-bucket admission budget: ``rate`` tokens/s refill a bucket of
    depth ``burst``; each admitted request spends one.  Thread-safe,
    driven by the monotonic clock (no background thread)."""

    def __init__(self, rate: float, burst: float | None = None):
        if rate <= 0:
            raise ValueError(f"quota rate must be positive, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else 2.0 * self.rate
        if self.burst < 1.0:
            raise ValueError(f"quota burst must be >= 1 token, got {self.burst}")
        self._lock = sync.Lock()
        self._tokens = self.burst
        self._at = sync.monotonic()
        self.admitted = 0
        self.shed = 0

    def try_admit(self, n: float = 1.0, now: float | None = None) -> bool:
        now = sync.monotonic() if now is None else now
        with self._lock:
            # a caller's clock behind ours must never drain the bucket
            self._tokens = min(self.burst,
                               self._tokens + max(0.0, now - self._at) * self.rate)
            self._at = now
            if self._tokens >= n:
                self._tokens -= n
                self.admitted += 1
                return True
            self.shed += 1
            return False

    def stats(self) -> dict:
        with self._lock:
            return {"rate": self.rate, "burst": self.burst, "admitted": self.admitted,
                    "shed": self.shed, "tokens": round(self._tokens, 3)}


def extract_scores(reply: str) -> list[float] | None:
    """The served score(s) of a reply line: ``"<label> <score>"`` for a
    line request, the ``"scores"`` list of a JSON batch reply; None for
    ``ERR`` and unparseable replies (the mirror skips those)."""
    reply = reply.strip()
    if not reply or reply.startswith("ERR"):
        return None
    if reply.startswith("{"):
        try:
            scores = json.loads(reply).get("scores")
            return [float(s) for s in scores] if scores else None
        except (ValueError, TypeError):
            return None
    parts = reply.split()
    if len(parts) != 2:
        return None
    try:
        return [float(parts[1])]
    except ValueError:
        return None


class _ShadowPair:
    """One (tenant, candidate) pair's score histograms and block PSI."""

    def __init__(self, tenant: str, candidate: str, *, block: int, bins: int):
        self.block = block
        self.bins = bins
        self.primary = np.zeros(bins, np.int64)
        self.candidate = np.zeros(bins, np.int64)
        self.pairs = 0
        self.blocks = 0
        self.psi_last: float | None = None
        self._gauge = _SHADOW_PSI.labels(tenant=tenant, candidate=candidate)

    def observe(self, primary: list[float], cand: list[float]) -> None:
        n = min(len(primary), len(cand))
        for hist, scores in ((self.primary, primary[:n]), (self.candidate, cand[:n])):
            idx = np.clip((np.asarray(scores, np.float64) * self.bins).astype(np.int64),
                          0, self.bins - 1)
            hist += np.bincount(idx, minlength=self.bins)
        self.pairs += n
        if self.pairs >= self.block:
            self.psi_last = psi(self.primary, self.candidate)
            self._gauge.set(self.psi_last)
            self.blocks += 1
            self.primary[:] = 0
            self.candidate[:] = 0
            self.pairs = 0


class ShadowMirror:
    """Fire-and-forget shadow scorer: requests are queued with their
    primary scores, and a worker thread replays them against the
    candidate model and feeds each (tenant, candidate) PSI comparison.

    ``exchange(model, line) -> reply`` comes from the router (it reuses
    the replica pools and in-flight budgets, so shadow traffic is
    admission-controlled like any other; a refused or failed mirror is
    dropped).  :meth:`submit` never blocks: a full queue counts a drop.
    """

    def __init__(self, exchange, *, queue_max: int = 256, block: int = 256, bins: int = 10):
        if queue_max <= 0 or block <= 0 or bins <= 1:
            raise ValueError(f"need queue_max/block > 0 and bins > 1, got "
                             f"{queue_max}/{block}/{bins}")
        self._exchange = exchange
        self._queue_max = int(queue_max)
        self.block = int(block)
        self.bins = int(bins)
        self._queue: list[tuple[str, str, str, list[float]]] = []
        self._lock = sync.Lock()
        self._wake = sync.Event()
        self._stop = sync.Event()
        self._pairs: dict[tuple[str, str], _ShadowPair] = {}
        self.submitted = 0
        self.mirrored = 0
        self.dropped = 0
        self.errors = 0
        self._thread = sync.Thread(target=self._run, daemon=True,
                                   name="distlr-shadow-mirror")
        self._thread.start()

    def submit(self, tenant: str, candidate: str, line: str,
               primary_scores: list[float]) -> bool:
        """Queue one mirror; False = dropped (queue full, or stopping).
        Called after the primary reply is final."""
        if self._stop.is_set():
            return False
        with self._lock:
            if len(self._queue) >= self._queue_max:
                self.dropped += 1
                _SHADOW_TOTAL.labels(tenant=tenant, candidate=candidate,
                                     outcome="dropped").inc()
                return False
            self._queue.append((tenant, candidate, line, primary_scores))
            self.submitted += 1
        self._wake.set()
        return True

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                batch, self._queue = self._queue, []
            if not batch:
                self._wake.wait(0.05)
                self._wake.clear()
                continue
            for i, (tenant, candidate, line, primary) in enumerate(batch):
                if self._stop.is_set():
                    # the rest of a dequeued batch is shed, and counted, so
                    # submitted = mirrored + errors + dropped + queued holds
                    with self._lock:
                        self.dropped += len(batch) - i
                    for tnt, cand_id, _line, _primary in batch[i:]:
                        _SHADOW_TOTAL.labels(tenant=tnt, candidate=cand_id,
                                             outcome="dropped").inc()
                    return
                try:
                    reply = self._exchange(candidate, line)
                except Exception:  # noqa: BLE001 — a mirror must never raise
                    reply = None
                cand = extract_scores(reply) if reply is not None else None
                if cand is None:
                    with self._lock:
                        self.errors += 1
                    _SHADOW_TOTAL.labels(tenant=tenant, candidate=candidate,
                                         outcome="error").inc()
                    continue
                # inserted under the lock: stats() iterates the pairs under it
                with self._lock:
                    pair = self._pairs.get((tenant, candidate))
                    if pair is None:
                        pair = self._pairs[(tenant, candidate)] = _ShadowPair(
                            tenant, candidate, block=self.block, bins=self.bins)
                pair.observe(primary, cand)
                # counted once observed, so drain() returns only after the
                # last pair reached its PSI block
                with self._lock:
                    self.mirrored += 1
                _SHADOW_TOTAL.labels(tenant=tenant, candidate=candidate,
                                     outcome="scored").inc()

    def drain(self, timeout_s: float = 5.0) -> None:
        """Block until every submitted mirror was processed, not only
        dequeued."""
        deadline = sync.monotonic() + timeout_s
        while sync.monotonic() < deadline:
            with self._lock:
                if not self._queue and self.mirrored + self.errors >= self.submitted:
                    return
            sync.sleep(0.01)

    def psi(self, tenant: str, candidate: str) -> float | None:
        with self._lock:
            pair = self._pairs.get((tenant, candidate))
        return pair.psi_last if pair is not None else None

    def stats(self) -> dict:
        with self._lock:
            pairs = {f"{t}->{c}": {"pairs": p.pairs, "blocks": p.blocks, "psi": p.psi_last}
                     for (t, c), p in self._pairs.items()}
            # the counters with the queue, in one snapshot: the worker
            # and submit() move them under this lock
            counts = {"mirrored": self.mirrored, "dropped": self.dropped,
                      "errors": self.errors, "queued": len(self._queue)}
        return {**counts, "pairs": pairs}

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5.0)


def set_model_count(n: int) -> None:
    """Publish the routing tier's registered-model count."""
    _TENANT_MODELS.set(float(n))


def count_request(model: str) -> None:
    _TENANT_REQUESTS.labels(model=model).inc()


def count_tenant_shed(model: str) -> None:
    _TENANT_SHED.labels(model=model).inc()
