"""ONE traffic model for the serving tier — shared math, two users.

A load generator (real sockets against a ``launch route`` front-end)
and :mod:`distlr_tpu_torch.analysis.fleetsim` (simulated arrivals
against modeled engines) must stress the control plane with the SAME
offered-load shape, or a policy tuned against one lies about the
other.  Everything here is pure, seeded, stdlib-only arithmetic:

* the **diurnal curve** (:func:`qps_at`) and its open-loop send
  :func:`schedule` — raised cosine from ``base_qps`` to ``peak_qps``
  over ``period_s``, integrated at fixed ``dt`` so the offsets are a
  deterministic function of the four numbers alone;
* **Zipf-skewed popularity** (:class:`ZipfSampler`) — key/feature ids
  drawn ``P(k) ∝ 1/(k+1)^alpha`` via inverse-CDF on a caller-owned
  ``random.Random``, plus :meth:`ZipfSampler.mass` so fleetsim can ask
  "how much of the hot set lands in key range [lo, hi)" without
  sampling at all (the reshard-convergence check);
* **per-tenant mixes** (:func:`parse_tenant_mix` /
  :func:`split_by_mix`) — ``"v1=0.8,v2=0.2"`` specs normalized and
  apportioned by largest remainder, so W senders split across models
  the same way every run;
* a **replayable label-delay distribution** (:class:`LabelDelay`) —
  lognormal parameterized by its own p50/p95 (the two numbers an
  operator actually knows about a feedback pipeline), sampled from a
  caller-owned seeded RNG.

No numpy, no torch: fleetsim imports this on the analysis path where
heavyweight deps are banned, and a load generator keeps its numpy
payload generation on its own side.
"""

from __future__ import annotations

import bisect
import math

__all__ = [
    "LabelDelay",
    "ZipfSampler",
    "parse_tenant_mix",
    "qps_at",
    "schedule",
    "split_by_mix",
]


def qps_at(t: float, base_qps: float, peak_qps: float,
           period_s: float) -> float:
    """The diurnal curve: raised cosine, base at t=0 and t=period, peak
    at t=period/2."""
    phase = (t % period_s) / period_s
    return base_qps + (peak_qps - base_qps) * 0.5 * (1.0 - math.cos(
        2.0 * math.pi * phase))


def schedule(duration_s: float, base_qps: float, peak_qps: float,
             period_s: float, *, dt: float = 0.001) -> list[float]:
    """Deterministic send offsets: integrate the curve in ``dt`` steps
    and emit a send time each time the cumulative expectation crosses
    the next integer."""
    times: list[float] = []
    acc = 0.0
    t = 0.0
    while t < duration_s:
        acc += qps_at(t, base_qps, peak_qps, period_s) * dt
        while acc >= 1.0:
            acc -= 1.0
            times.append(t)
        t += dt
    return times


class ZipfSampler:
    """Zipf-skewed ids over ``[0, n)``: ``P(k) ∝ 1/(k+1)^alpha``.

    ``alpha=0`` degrades to uniform (every existing call site keeps its
    old distribution by default).  Sampling is inverse-CDF bisection on
    ``rng.random()`` — the caller owns the ``random.Random``, so one
    seed makes the whole traffic tape replayable."""

    def __init__(self, n: int, alpha: float = 1.1):
        if n < 1:
            raise ValueError(f"need n >= 1 ids, got {n}")
        if alpha < 0:
            raise ValueError(f"alpha must be >= 0, got {alpha}")
        self.n = int(n)
        self.alpha = float(alpha)
        weights = [1.0 / float(k + 1) ** self.alpha for k in range(self.n)]
        total = sum(weights)
        self._cdf: list[float] = []
        acc = 0.0
        for w in weights:
            acc += w / total
            self._cdf.append(acc)
        self._cdf[-1] = 1.0  # guard the float tail

    def sample(self, rng) -> int:
        return bisect.bisect_left(self._cdf, rng.random())

    def mass(self, lo: int, hi: int) -> float:
        """Probability mass of ids in ``[lo, hi)`` — the expected load
        share of a key range under this popularity, closed-form."""
        lo = max(0, min(self.n, int(lo)))
        hi = max(0, min(self.n, int(hi)))
        if hi <= lo:
            return 0.0
        upper = self._cdf[hi - 1]
        lower = self._cdf[lo - 1] if lo > 0 else 0.0
        return upper - lower


def parse_tenant_mix(spec) -> dict[str, float]:
    """``"v1=0.8,v2=0.2"`` (or a ready mapping) -> normalized weights.
    Rejects empty specs, non-positive weights, and duplicates loudly —
    a silently-dropped tenant is a traffic model lying about the
    fleet."""
    if isinstance(spec, dict):
        items = [(str(k), v) for k, v in spec.items()]
    else:
        items = []
        seen: set[str] = set()
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            name, eq, raw = part.partition("=")
            name = name.strip()
            if not name or not eq:
                raise ValueError(
                    f"tenant mix entry {part!r}: need model=weight")
            if name in seen:
                raise ValueError(f"tenant mix names {name!r} twice")
            seen.add(name)
            items.append((name, raw.strip()))
    if not items:
        raise ValueError(f"empty tenant mix spec {spec!r}")
    mix: dict[str, float] = {}
    for name, raw in items:
        try:
            w = float(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"tenant mix weight for {name!r} must be a number, "
                f"got {raw!r}") from None
        if w <= 0 or not math.isfinite(w):
            raise ValueError(
                f"tenant mix weight for {name!r} must be positive and "
                f"finite, got {w}")
        mix[name] = w
    total = sum(mix.values())
    return {name: w / total for name, w in mix.items()}


def split_by_mix(count: int, mix: dict[str, float]) -> dict[str, int]:
    """Apportion ``count`` identical senders across the mix by largest
    remainder (Hamilton's method): deterministic, sums to ``count``,
    and every tenant with positive weight gets at least the floor of
    its share."""
    if count < 0:
        raise ValueError(f"count must be >= 0, got {count}")
    total = sum(mix.values())
    quotas = [(name, count * w / total) for name, w in mix.items()]
    out = {name: int(q) for name, q in quotas}
    rem = count - sum(out.values())
    by_frac = sorted(quotas, key=lambda nq: (-(nq[1] - int(nq[1])), nq[0]))
    for name, _q in by_frac[:rem]:
        out[name] += 1
    return out


class LabelDelay:
    """Replayable label-arrival delays: lognormal pinned by its own
    p50/p95 (``sigma = ln(p95/p50) / z95``), sampled off a caller-owned
    seeded RNG — the shape feedback pipelines actually show (most
    labels arrive fast, a heavy tail straggles past the join window)."""

    _Z95 = 1.6448536269514722  # Phi^-1(0.95)

    def __init__(self, p50_s: float, p95_s: float):
        if p50_s <= 0 or p95_s < p50_s:
            raise ValueError(
                f"need 0 < p50_s <= p95_s, got {p50_s}/{p95_s}")
        self.p50_s = float(p50_s)
        self.p95_s = float(p95_s)
        self._mu = math.log(self.p50_s)
        self._sigma = (math.log(self.p95_s) - self._mu) / self._Z95

    def sample(self, rng) -> float:
        if self._sigma == 0.0:
            return self.p50_s
        return rng.lognormvariate(self._mu, self._sigma)
