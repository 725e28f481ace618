"""Durable checkpoints of training state, and resume.

Counterpart of ``distlr_tpu/train/checkpoint.py`` with the same interface
(``save`` / ``latest_step`` / ``restore`` / ``all_steps`` / ``close``, a
context manager, ``max_to_keep=3``).  The JAX one stores state through
orbax, which needs JAX; this one keeps its own format: one numpy ``.npz``
per step, ``ckpt-<step>.npz`` in the directory, written under a private
name, flushed to disk and renamed into place, so a reader never finds a
half-written step and a crash mid-save leaves the older steps intact.
The state is the weights (a float32 array of the model's ``param_shape``)
plus the ``extra`` entries (the trainer saves the epoch).
"""

from __future__ import annotations

import os
import re
import tempfile

import numpy as np

_NAME = re.compile(r"^ckpt-(\d+)\.npz$")


class Checkpointer:
    """Saves and restores numbered training states in one directory."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt-{step}.npz")

    def save(self, step: int, weights, *, extra: dict | None = None) -> None:
        """Write the state of ``step`` (``weights``: a tensor or an array),
        then drop the oldest steps beyond ``max_to_keep``."""
        if hasattr(weights, "detach"):
            weights = weights.detach().cpu().numpy()
        state = {"weights": np.asarray(weights)}
        if extra:
            state.update({k: np.asarray(v) for k, v in extra.items()})
        fd, tmp = tempfile.mkstemp(prefix=".ckpt-", suffix=".tmp", dir=self._dir)
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **state)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(step))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        for old in self.all_steps()[:-self._max_to_keep]:
            os.unlink(self._path(old))

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for name in os.listdir(self._dir)
                      if (m := _NAME.match(name)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> dict | None:
        """The state at ``step`` (default: the latest) as a dict of numpy
        arrays; None if the directory holds no step."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        with np.load(self._path(step)) as data:
            return {k: data[k] for k in data.files}

    def close(self) -> None:
        """Nothing is pending: every save is complete when it returns."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
