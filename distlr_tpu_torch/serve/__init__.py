"""The scoring tier of the port: counterpart of ``distlr_tpu/serve/`` for
the engine, the microbatcher, the TCP front-end and hot reload.

``engine`` (bucketed batched scoring over every model family, on the
port's forward kernels for dense ``binary_lr``), ``batcher`` (request
coalescing), ``server`` (the threaded TCP line protocol; ``python -m
distlr_tpu_torch.launch serve``) and ``reload`` (checkpoint-watch and
live-PS weight sources with atomic swaps and jittered polling, and the
hot-row refresh that ``hotset``'s tracker feeds).  Not ported: the
serving control plane (router, balance, tenant, rollout: ROADMAP A.17).
"""

from distlr_tpu_torch.serve.batcher import MicroBatcher
from distlr_tpu_torch.serve.engine import ScoringEngine
from distlr_tpu_torch.serve.hotset import HotSetTracker
from distlr_tpu_torch.serve.reload import CheckpointWatcher, HotReloader, LivePSWatcher
from distlr_tpu_torch.serve.server import ScoringServer, score_lines_over_tcp

__all__ = [
    "CheckpointWatcher",
    "HotReloader",
    "HotSetTracker",
    "LivePSWatcher",
    "MicroBatcher",
    "ScoringEngine",
    "ScoringServer",
    "score_lines_over_tcp",
]
