"""Logging, CHECK-style invariants and the reference-format eval line
(copy of ``check``, ``check_eq``, ``get_logger`` and ``log_eval_line``
from ``distlr_tpu/utils/logging.py``).

A failed check raises :class:`CheckError` where the reference's dmlc
``CHECK`` / ``CHECK_EQ`` macros abort the process (``src/main.cc:49,86``).

The eval line is byte-for-byte the reference's (``src/lr.cc:56-62``), so
trajectories from the reference, the JAX package and this port diff
line for line.
"""

from __future__ import annotations

import logging
import sys
import time

class CheckError(AssertionError):
    """Invariant violation: the equivalent of a failed CHECK."""


def check(cond: bool, msg: str = "") -> None:
    if not cond:
        raise CheckError(f"Check failed: {msg}")


def check_eq(a, b, msg: str = "") -> None:
    if a != b:
        raise CheckError(f"Check failed: {a!r} != {b!r}. {msg}")


_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"


class _LazyStderrHandler(logging.StreamHandler):
    """StreamHandler that re-resolves ``sys.stderr`` at every emit, so a
    logger created while something (pytest capture,
    ``contextlib.redirect_stderr``) temporarily replaced ``sys.stderr``
    does not keep writing to that dead stream."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr


def get_logger(name: str = "distlr_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = _LazyStderrHandler()
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def log_eval_line(iteration: int, accuracy: float, *, stream=None) -> str:
    """Emit the reference-format eval line: ``HH:MM:SS Iteration N, accuracy: A``."""
    line = f"{time.strftime('%H:%M:%S')} Iteration {iteration}, accuracy: {accuracy:g}"
    print(line, file=stream if stream is not None else sys.stdout, flush=True)
    return line
