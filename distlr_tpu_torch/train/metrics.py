"""Per-step timing and structured metric records.

Counterpart of ``distlr_tpu/train/metrics.py``.  Both classes are thin
wrappers over the process-wide :mod:`distlr_tpu_torch.obs` registry, with
the JAX package's five families: a :class:`StepTimer` feeds the
``distlr_train_steps_total`` / ``distlr_train_samples_total`` counters,
the ``distlr_train_step_seconds`` histogram and the
``distlr_train_samples_per_second`` gauge; a :class:`MetricsLogger`
mirrors every numeric record field into ``distlr_train_last{field=}`` —
so the /metrics scrape sees the same numbers the structured records
carry, without any call-site changes.
"""

from __future__ import annotations

import json
import time

from distlr_tpu_torch.obs.registry import MetricsRegistry
from distlr_tpu_torch.obs.registry import get_registry as _get_registry


class StepTimer:
    """Wall-clock step timer with samples/sec accounting.

    Callers wait for the device (``torch.cuda.synchronize``) before
    :meth:`stop`, since CUDA launches return before the work is done.

    ``loop`` labels this timer's registry series (``"sync"`` for the SPMD
    trainer, ``"ps"`` for PS workers) so concurrent loops in one process
    stay distinguishable in a scrape.  Counters and the step histogram
    are additive, so concurrent timers share one ``loop`` child; the
    throughput GAUGE is per-timer state, so it additionally carries
    ``instance`` (the PS worker rank) — N Hogwild workers scrape as N
    rates to sum, not one last-writer-wins value.
    """

    def __init__(self, loop: str = "sync", instance: str = "0",
                 registry: MetricsRegistry | None = None):
        self.steps = 0
        self.samples = 0
        self.elapsed = 0.0
        self._t0 = None
        reg = registry or _get_registry()
        labels = ("loop",)
        self._steps_c = reg.counter(
            "distlr_train_steps_total", "training steps completed", labels
        ).labels(loop=loop)
        self._samples_c = reg.counter(
            "distlr_train_samples_total", "training samples consumed", labels
        ).labels(loop=loop)
        self._step_h = reg.histogram(
            "distlr_train_step_seconds", "wall seconds per training step",
            labels,
        ).labels(loop=loop)
        self._rate_g = reg.gauge(
            "distlr_train_samples_per_second",
            "cumulative training throughput per timer (sum instances for "
            "process throughput)", ("loop", "instance"),
        ).labels(loop=loop, instance=instance)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, num_samples: int):
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() called without a matching start()")
        dt = time.perf_counter() - self._t0
        self.elapsed += dt
        self.steps += 1
        self.samples += num_samples
        self._t0 = None
        self._steps_c.inc()
        self._samples_c.inc(num_samples)
        self._step_h.observe(dt)
        if self.elapsed > 0:
            self._rate_g.set(self.samples / self.elapsed)

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def sec_per_step(self) -> float:
        return self.elapsed / self.steps if self.steps else 0.0


class MetricsLogger:
    """Collects structured metric records; optional JSONL sink.

    Context-manager friendly: ``with MetricsLogger(path) as m: ...``
    closes the sink on exit.  ``log()`` after ``close()`` raises — a
    silently closed file previously swallowed records.
    """

    def __init__(self, jsonl_path: str | None = None,
                 registry: MetricsRegistry | None = None):
        self.records: list[dict] = []
        self._file = open(jsonl_path, "a") if jsonl_path else None  # noqa: SIM115 (closed by close())
        self._had_file = self._file is not None
        self._closed = False
        reg = registry or _get_registry()
        self._last_g = reg.gauge(
            "distlr_train_last",
            "most recent value of each numeric structured metric field",
            ("field",),
        )

    def log(self, **record) -> dict:
        if self._closed:
            raise RuntimeError(
                "MetricsLogger is closed; log() would lose the record"
                + (" (the JSONL sink is gone)" if self._had_file else "")
            )
        record.setdefault("time", time.time())
        self.records.append(record)
        for key, val in record.items():
            if key != "time" and isinstance(val, (int, float)) \
                    and not isinstance(val, bool):
                self._last_g.labels(field=key).set(val)
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        return record

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
        self._closed = True

    @property
    def closed(self) -> bool:
        """Whether :meth:`close` ran (a scoring server's ``stats()`` then
        stops mirroring its records here)."""
        return self._closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def latest(self, key: str):
        for rec in reversed(self.records):
            if key in rec:
                return rec[key]
        return None
