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

Attributes resolve lazily (PEP 562), so the torch-free pieces (the
router's health policy in ``balance``, the tenant specs) import without
loading torch: fleetsim drives ``balance`` on the analysis path.
"""

import importlib

_LAZY = {
    "CheckpointWatcher": "distlr_tpu_torch.serve.reload",
    "HotReloader": "distlr_tpu_torch.serve.reload",
    "HotSetTracker": "distlr_tpu_torch.serve.hotset",
    "LivePSWatcher": "distlr_tpu_torch.serve.reload",
    "MicroBatcher": "distlr_tpu_torch.serve.batcher",
    "RolloutController": "distlr_tpu_torch.serve.rollout",
    "RouterAdmin": "distlr_tpu_torch.serve.rollout",
    "ScoringEngine": "distlr_tpu_torch.serve.engine",
    "ScoringRouter": "distlr_tpu_torch.serve.router",
    "ScoringServer": "distlr_tpu_torch.serve.server",
    "ShadowMirror": "distlr_tpu_torch.serve.tenant",
    "TenantQuota": "distlr_tpu_torch.serve.tenant",
    "fleet_alert_poller": "distlr_tpu_torch.serve.rollout",
    "parse_model_spec": "distlr_tpu_torch.serve.tenant",
    "parse_quota_spec": "distlr_tpu_torch.serve.tenant",
    "parse_stages": "distlr_tpu_torch.serve.rollout",
    "score_lines_over_tcp": "distlr_tpu_torch.serve.server",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
