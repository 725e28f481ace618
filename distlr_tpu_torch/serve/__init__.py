"""The scoring tier of the port: counterpart of ``distlr_tpu/serve/`` for
the engine, the microbatcher, the TCP front-end and hot reload.

``engine`` (bucketed batched scoring over every model family, on the
port's forward kernels for dense ``binary_lr``), ``batcher`` (request
coalescing), ``server`` (the threaded TCP line protocol; ``python -m
distlr_tpu_torch.launch serve``) and ``reload`` (checkpoint-watch and
live-PS weight sources with atomic swaps and jittered polling, and the
hot-row refresh that ``hotset``'s tracker feeds), and the serving
control plane: ``router`` (``ScoringRouter``: balancing, admission,
failover, tenancy; ``launch route``), ``balance`` (its health policy),
``tenant`` (model specs, quotas, the shadow mirror) and ``rollout``
(canary ramps; ``launch rollout``).
"""

from distlr_tpu_torch.serve.batcher import MicroBatcher
from distlr_tpu_torch.serve.engine import ScoringEngine
from distlr_tpu_torch.serve.hotset import HotSetTracker
from distlr_tpu_torch.serve.reload import CheckpointWatcher, HotReloader, LivePSWatcher
from distlr_tpu_torch.serve.rollout import (
    RolloutController,
    RouterAdmin,
    fleet_alert_poller,
    parse_stages,
)
from distlr_tpu_torch.serve.router import ScoringRouter
from distlr_tpu_torch.serve.server import ScoringServer, score_lines_over_tcp
from distlr_tpu_torch.serve.tenant import (
    ShadowMirror,
    TenantQuota,
    parse_model_spec,
    parse_quota_spec,
)

__all__ = [
    "CheckpointWatcher",
    "HotReloader",
    "HotSetTracker",
    "LivePSWatcher",
    "MicroBatcher",
    "RolloutController",
    "RouterAdmin",
    "ScoringEngine",
    "ScoringRouter",
    "ScoringServer",
    "ShadowMirror",
    "TenantQuota",
    "fleet_alert_poller",
    "parse_model_spec",
    "parse_quota_spec",
    "parse_stages",
    "score_lines_over_tcp",
]
