"""Process-wide metrics registry — labeled counters, gauges, histograms.

The port's own copy of ``distlr_tpu/obs/registry.py`` (stdlib only; the
port imports nothing of the JAX package): the same names, the same
family semantics and the same Prometheus exposition text byte for byte,
so one scrape reads the same way from either package.  Every layer of
the port records here: the PS server group and its supervisor, the KV
client, both trainer loops, the microbatcher, the scoring front-end, the
router and the feedback loop.  They record from many threads at once,
so every update is lock-protected (exact counts under contention are a
test contract, ``tests/test_torch_obs.py``).

Model mirrors the Prometheus client library:

* a *family* is a named metric with a fixed label-name tuple
  (``registry.counter("distlr_x_total", "help", labelnames=("op",))``);
* ``family.labels(op="push")`` resolves one *child* (the time series);
  families declared with no label names act as their own child, so
  ``family.inc()`` works directly;
* declaring the same family twice returns the existing one (call sites
  in different modules may race to declare) — a type/label mismatch
  raises instead of silently aliasing two meanings onto one name.

Histograms use FIXED buckets (cumulative, Prometheus semantics): no
per-observation storage, so a million RPCs cost the same memory as ten.
``Histogram.percentile`` interpolates within the owning bucket.

:meth:`MetricsRegistry.reset` drops every family, including those the
port's modules bound at import; callers that want "what did this run
add" read deltas (:func:`family_total` before and after) instead.
"""

from __future__ import annotations

import bisect
import threading
import time

#: Default latency ladder, seconds.  Spans 100 us (jit dispatch, localhost
#: RPC) to 10 s (full-test-set eval, cold compile) — the ranges measured
#: across this repo's phases.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: Ladder for count-valued histograms (e.g. pushes-behind staleness):
#: 0 = perfectly fresh, then doublings to deeply stale, with one wide
#: 4096 top bucket.  Shared as a constant because the fleet merge
#: rejects mismatched boundary ladders — two call sites retuning the
#: "same" metric independently would drop it from every federated view.
COUNT_BUCKETS = (
    0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
    1024.0, 4096.0,
)


def percentile_from_counts(bounds: tuple[float, ...], counts,
                           q: float) -> float:
    """q-quantile (q in [0, 1]) by linear interpolation inside the
    owning bucket, over decomposed per-bucket counts (last slot =
    +Inf).  Observations past the top bucket clamp to the largest
    finite boundary — fixed buckets trade tail resolution for O(1)
    memory; widen the ladder if the tail matters.  ONE implementation,
    shared by live histogram children and the fleet aggregator's
    snapshot math, so /metrics and /fleet.json can never disagree on
    the same data."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = sum(counts)
    if total == 0:
        return 0.0
    rank, cum = q * total, 0.0
    for i, c in enumerate(counts[:-1]):
        prev_cum = cum
        cum += c
        if cum >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (rank - prev_cum) / c if c else 0.0
            return lo + (hi - lo) * frac
    return bounds[-1]


def _format_value(v: float) -> str:
    """Prometheus sample value: integral floats print as integers."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(names, values) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label(str(v))}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc by {amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _HistogramChild:
    __slots__ = ("_lock", "_buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: tuple[float, ...]):
        self._lock = threading.Lock()
        self._buckets = buckets
        self._counts = [0] * (len(buckets) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self._buckets, value)  # bucket is "le" bound
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> dict:
        """Cumulative Prometheus-style view: ``{le: count}`` + sum/count."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, out = 0, {}
        for b, c in zip(self._buckets, counts):
            cum += c
            out[b] = cum
        return {"buckets": out, "inf": total, "sum": s, "count": total}

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile via :func:`percentile_from_counts`
        over this child's live bucket counts."""
        with self._lock:
            counts = list(self._counts)
        return percentile_from_counts(self._buckets, counts, q)


class _Family:
    """One named metric + its children, keyed by label values."""

    kind = "untyped"
    _child_cls: type = _CounterChild

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...],
                 **child_kw):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._child_kw = child_kw
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}
        if not self.labelnames:  # unlabeled family IS its only child
            self._children[()] = self._child_cls(**child_kw)

    def labels(self, *values, **kw):
        if kw:
            if values:
                raise ValueError("pass labels positionally or by name, not both")
            try:
                values = tuple(kw[n] for n in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name} expects labels {self.labelnames}, got {sorted(kw)}"
                ) from e
            if len(kw) != len(self.labelnames):
                raise ValueError(
                    f"{self.name} expects labels {self.labelnames}, got {sorted(kw)}"
                )
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects {len(self.labelnames)} label values "
                f"{self.labelnames}, got {values}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._child_cls(**self._child_kw)
            return child

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; call .labels(...) first"
            )
        return self._children[()]

    def children(self) -> list[tuple[tuple, object]]:
        with self._lock:
            return sorted(self._children.items())

    # mismatch detection for duplicate declarations — includes child
    # construction args (histogram buckets), so two modules cannot
    # silently observe into different ladders under one name
    def signature(self):
        return (self.kind, self.labelnames,
                tuple(sorted(self._child_kw.items())))


class Counter(_Family):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Family):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_Family):
    kind = "histogram"
    _child_cls = _HistogramChild

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def percentile(self, q: float) -> float:
        return self._default().percentile(q)

    @property
    def count(self) -> int:
        return self._default().count

    @property
    def sum(self) -> float:
        return self._default().sum

    def time(self):
        """``with hist.time(): ...`` — observe the block's wall duration."""
        return _Timer(self._default())


class _Timer:
    __slots__ = ("_child", "_t0")

    def __init__(self, child: _HistogramChild):
        self._child = child

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._child.observe(time.perf_counter() - self._t0)


class MetricsRegistry:
    """Thread-safe collection of metric families with text/JSON export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _declare(self, cls, name: str, help: str, labelnames, **kw):
        labelnames = tuple(labelnames)
        wanted = (cls.kind, labelnames, tuple(sorted(kw.items())))
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.signature() != wanted:
                    raise ValueError(
                        f"metric {name!r} already declared as "
                        f"{fam.signature()}, re-declared as {wanted}"
                    )
                return fam
            fam = self._families[name] = cls(name, help, labelnames, **kw)
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = ()) -> Counter:
        return self._declare(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        buckets = tuple(sorted(float(b) for b in buckets))
        if not buckets:
            raise ValueError("histogram needs at least one bucket boundary")
        return self._declare(Histogram, name, help, labelnames,
                             buckets=buckets)

    def get(self, name: str) -> _Family | None:
        with self._lock:
            return self._families.get(name)

    def reset(self) -> None:
        """Drop every family (tests; production registries only grow)."""
        with self._lock:
            self._families.clear()

    # -- export ----------------------------------------------------------
    def prometheus_text(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        lines: list[str] = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in fam.children():
                if fam.kind == "histogram":
                    snap = child.snapshot()
                    for b, cum in snap["buckets"].items():
                        lab = _label_str(fam.labelnames + ("le",),
                                         values + (_format_value(b),))
                        lines.append(f"{fam.name}_bucket{lab} {cum}")
                    lab = _label_str(fam.labelnames + ("le",),
                                     values + ("+Inf",))
                    lines.append(f"{fam.name}_bucket{lab} {snap['inf']}")
                    base = _label_str(fam.labelnames, values)
                    lines.append(
                        f"{fam.name}_sum{base} {_format_value(snap['sum'])}")
                    lines.append(f"{fam.name}_count{base} {snap['count']}")
                else:
                    lab = _label_str(fam.labelnames, values)
                    lines.append(
                        f"{fam.name}{lab} {_format_value(child.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-ready nested view of every family."""
        out: dict = {}
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            series = []
            for values, child in fam.children():
                labels = dict(zip(fam.labelnames, values))
                if fam.kind == "histogram":
                    snap = child.snapshot()
                    series.append({
                        "labels": labels,
                        "buckets": {_format_value(b): c
                                    for b, c in snap["buckets"].items()},
                        "inf": snap["inf"],
                        "sum": snap["sum"],
                        "count": snap["count"],
                    })
                else:
                    series.append({"labels": labels, "value": child.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": series}
        return out


#: The process-wide default registry every subsystem records into.
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


def family_total(name: str, registry: MetricsRegistry | None = None) -> float:
    """Sum of a counter/gauge family's children across all label sets in
    the process registry (0.0 when the family was never declared) — the
    snapshot primitive bench rows and delta-based tests are built on."""
    fam = (registry or REGISTRY).get(name)
    if fam is None:
        return 0.0
    return float(sum(child.value for _v, child in fam.children()))
