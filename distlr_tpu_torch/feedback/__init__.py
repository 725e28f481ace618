"""Online learning from served traffic: the closed loop (the port's copy
of ``distlr_tpu/feedback/``).

A scored request goes back into training in four steps, a module each:

* :mod:`~distlr_tpu_torch.feedback.spool`: the serving front-end journals
  every scored request into a bounded on-disk spool, with retention by
  the hot-set tracker's key statistics;
* :mod:`~distlr_tpu_torch.feedback.join`: delayed labels (``LABEL <id>
  <y>`` lines) join their spooled request within a window, never-labelled
  requests go through negative sampling, and joined examples become
  libsvm training shards;
* :mod:`~distlr_tpu_torch.feedback.online`: ``launch online``, a Hogwild
  worker that consumes the shards as they appear and pushes into the live
  PS the engines hot-reload from, with AdaBatch accumulation;
* :mod:`~distlr_tpu_torch.feedback.drift`: block-wise PSI over the served
  scores, firing while the distribution moves.

:mod:`~distlr_tpu_torch.feedback.sink` holds the first, second and last
behind the scoring server; every module reads its locks, threads and
clocks through :mod:`distlr_tpu_torch.sync`.  The server-side half is FTRL-Proximal
(``--ps-optimizer ftrl``).  The exports are lazy (PEP 562), as in the JAX
package.
"""

import importlib

_LAZY = {
    "FeedbackSink": "distlr_tpu_torch.feedback.sink",
    "FeedbackSpool": "distlr_tpu_torch.feedback.spool",
    "SpoolRecord": "distlr_tpu_torch.feedback.spool",
    "per_row_keys": "distlr_tpu_torch.feedback.spool",
    "strip_label": "distlr_tpu_torch.feedback.spool",
    "LabelJoiner": "distlr_tpu_torch.feedback.join",
    "OnlineTrainer": "distlr_tpu_torch.feedback.online",
    "ScoreDriftDetector": "distlr_tpu_torch.feedback.drift",
    "psi": "distlr_tpu_torch.feedback.drift",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
