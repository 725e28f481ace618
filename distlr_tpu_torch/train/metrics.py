"""Per-step timing and structured metric records.

The port's own small counterparts of ``distlr_tpu/train/metrics.py``'s
classes; the JAX ones also feed the ``distlr_tpu.obs`` registry, which is
not ported (ROADMAP A.12).
"""

from __future__ import annotations

import json
import time


class StepTimer:
    """Wall-clock step timer with samples/sec accounting.  Callers wait for
    the device (``torch.cuda.synchronize``) before :meth:`stop`, since
    CUDA launches return before the work is done."""

    def __init__(self):
        self.steps = 0
        self.samples = 0
        self.elapsed = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, num_samples: int):
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() called without a matching start()")
        self.elapsed += time.perf_counter() - self._t0
        self.steps += 1
        self.samples += num_samples
        self._t0 = None

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def sec_per_step(self) -> float:
        return self.elapsed / self.steps if self.steps else 0.0


class MetricsLogger:
    """Collects structured metric records, optionally mirrored to a JSONL
    file.  ``log()`` after ``close()`` raises rather than dropping the
    record."""

    def __init__(self, jsonl_path: str | None = None):
        self.records: list[dict] = []
        self._file = open(jsonl_path, "a") if jsonl_path else None  # noqa: SIM115 (closed by close())
        self._closed = False

    def log(self, **record) -> dict:
        if self._closed:
            raise RuntimeError("MetricsLogger is closed; log() would lose the record")
        record.setdefault("time", time.time())
        self.records.append(record)
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        return record

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def latest(self, key: str):
        for rec in reversed(self.records):
            if key in rec:
                return rec[key]
        return None
