"""Parameter-server training (sync BSP or async Hogwild over the native KV
server group): the port of ``distlr_tpu/train/ps_trainer.py`` for every
family.

The control flow mirrors the reference worker (``RunWorker``,
``src/main.cc:124-170`` + ``LR::Train``, ``src/lr.cc:28-45``): pull
weights, compute the minibatch gradient, push, repeat.  The gradient is
the model's own: on the card ``BinaryLR.grad`` is one launch of the
``fused_lr_grad`` single pass and eval one ``lr_logits`` launch; softmax
takes its cuBLAS step.  Workers are threads of one process: on one card
their launches go to the same stream and run one after another.

Worker lifecycle, as the reference's:

* every worker computes the identical init (Q2, reference ``srand(0)``);
  rank 0 pushes it as the first (seeding) push and the others wait at the
  group barrier (``src/main.cc:141-150``);
* sync mode: the blocking push IS the BSP barrier (deferred replies);
* rank 0 evaluates every ``test_interval`` epochs and prints the
  reference-format line;
* each worker text-exports its final *pulled* weights to
  ``models/part-00{rank+1}`` (Q8, ``src/main.cc:168-169``).

The keyed families (``sparse_lr``, ``sparse_softmax``, ``blocked_lr``)
pull and push only a batch's unique touched rows (ps-lite's sliced keys,
which the reference app never uses): ``vals_per_key`` rows of R lanes
(blocked) or K classes (sparse softmax) where the group's ranges align,
expanded per-lane keys where a row straddles two servers.  Their
gradients are gathers, a sigmoid or softmax and an ``index_add_`` scatter
on the compute device (:func:`_sparse_batch_grad_torch` and its
siblings), or the JAX package's host numpy functions, copied here, with
``ps_compute_backend="numpy"``.  Their L2 is lazy: only a batch's active
keys decay.

What the servers compute and what crosses the wire follow the config as
in the JAX package: the group runs ``ps_optimizer`` (FTRL with the
``ftrl_*`` parameters) or, under ``ps_compress="signsgd"``, the majority
vote; each worker negotiates the ``ps_compress`` codec; with
``ps_accum_max > 1`` a worker pushes the mean of a growing span of
batches (:class:`~distlr_tpu_torch.compress.GradientAccumulator`),
pulling at each span's start, instead of the fused round a batch.

Fault recovery, the JAX package's ladder: each worker's client retries
transient transport faults in place (``ps_retry_*``, async only); a
failed async worker is rebuilt and rejoins (``max_restarts``); dead
servers of an async group are respawned and re-seeded
(``supervise_servers``, :class:`~distlr_tpu_torch.ps.ServerSupervisor`);
and rank 0 checkpoints every ``checkpoint_interval`` epochs, so a job
resumes (``resume``), against the surviving group or a fresh one.  The
checkpoints are the port's ``.npz`` steps (:mod:`.checkpoint`); the
sidecar ``ps_latest.json`` is the JAX package's byte for byte.

A local group can be durable (``ps_store_dir``: snapshots of each rank's
slice and, with ``ps_store_wal``, a log of every applied push, from which
a respawned rank recovers) and ride a fault plan (``chaos_plan``: the
workers reach the servers through the plan's proxies, whose ``kill``
faults SIGKILL server ranks).

The workers route by the hosts they are given, as the JAX package's do:
a live resize (:mod:`distlr_tpu_torch.ps.membership`) is followed by the
clients built with a ``route`` (serving, the online trainer).

Observability, as the JAX package's: each worker's step timer feeds the
``distlr_train_*{loop="ps"}`` series, its rounds open the tracer's
``data_load`` / ``pull`` / ``compute`` / ``push`` / ``barrier_wait`` /
``eval`` / ``checkpoint`` phases (``compute`` holds the card's time: a
gradient ends in its read-back), async workers set
``distlr_train_staleness_seconds{rank}`` and sample the group's push
clock into the ``distlr_train_staleness_pushes{rank}`` histogram, and
rank 0 runs under ``torch.profiler`` with ``profile_dir``.  The steps'
signatures feed ``distlr_jax_compiles_total`` at JAX's sites
(``train.ps.grad``, ``train.ps.eval``).  Each batch of every loop
variant is a distributed-trace root (:class:`_StepTrace`, the JAX
package's): a sampled step is a ``train.step`` span whose KV ops carry the
trace trailer, so each server's handler span lands under it on the
``launch trace-agg`` timeline; the pipelined Hogwild push takes the step's
context to the comm thread.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from distlr_tpu_torch.compress import GradientAccumulator
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.data.iterator import BlockedDataIter, DataIter, SparseDataIter
from distlr_tpu_torch.data.sharding import part_name
from distlr_tpu_torch.models import get_model
from distlr_tpu_torch.obs import dtrace, torchrt
from distlr_tpu_torch.obs.registry import COUNT_BUCKETS, get_registry
from distlr_tpu_torch.obs.tracing import trace_phase
from distlr_tpu_torch.ps import KVWorker, RetryPolicy, ServerGroup, ServerSupervisor
from distlr_tpu_torch.ps.server import STORE_EVENTS
from distlr_tpu_torch.train.checkpoint import Checkpointer
from distlr_tpu_torch.train.export import save_model_text
from distlr_tpu_torch.train.metrics import MetricsLogger, StepTimer
from distlr_tpu_torch.utils.device import resolve_device
from distlr_tpu_torch.utils.logging import get_logger, log_eval_line

log = get_logger(__name__)

_KEYED_MODELS = ("sparse_lr", "sparse_softmax", "blocked_lr")

#: Gradient staleness, measured as WEIGHT AGE: seconds between pulling
#: the weights a gradient was computed from and that gradient landing on
#: the servers.  In sync BSP this is just the round latency; in async
#: (Hogwild) it is the real staleness bound the convergence analyses
#: (arXiv:1508.05711) reason about.
_STALENESS = get_registry().gauge(
    "distlr_train_staleness_seconds",
    "age of the weights behind the most recent gradient push",
    labelnames=("rank",),
)
#: The same staleness in the unit the Hogwild analyses bound (updates):
#: the group's global push clock (:meth:`KVWorker.global_pushes`) sampled
#: after the pull and again just before the push.  Sampling is throttled
#: (one probed pair per _PUSHES_SAMPLE_INTERVAL_S per worker).
_STALENESS_PUSHES = get_registry().histogram(
    "distlr_train_staleness_pushes",
    "Hogwild gradient staleness in pushes-behind: peer updates applied "
    "between this worker's pull and its push",
    labelnames=("rank",),
    buckets=COUNT_BUCKETS,
)
#: Min seconds between probed pull/push clock pairs per worker.
_PUSHES_SAMPLE_INTERVAL_S = 0.05
#: Cooldown before rebuilding a failed push-clock probe connection (a
#: transient fault must not silence the staleness series for good).
_PROBE_RETRY_COOLDOWN_S = 5.0
_RESTARTS = get_registry().counter(
    "distlr_ps_worker_restarts_total",
    "PS workers rebuilt in place after a failure (max_restarts path)",
)
#: Current AdaBatch span of each PS worker (batches per push).
_ACCUM_K = get_registry().gauge(
    "distlr_train_accum_batches",
    "current AdaBatch accumulation span of the PS worker loop "
    "(batches per push)",
    labelnames=("rank",),
)
#: the signatures of the dense steps, shared by the workers of a process
#: as the JAX package shares one jitted step per (model, L2) (and the
#: eval per model)
_GRAD_SIGS: dict = {}
_EVAL_SIGS: dict = {}
#: the tracer's phase of each timed op (``PSWorker._timed``)
_OP_PHASES = {"pull": "pull", "push": "push", "push_pull": "push", "grad": "compute",
              "prep": "data_load", "checkpoint": "checkpoint"}


class _StepTrace:
    """StepTimer proxy that puts each ``start()``/``stop()`` bracket (one
    batch, in every loop variant) under its own distributed-trace root
    (``distlr_tpu/train/ps_trainer.py``'s ``_StepTrace``).  A sampled
    step is a ``train.step`` span whose KV ops carry the trace trailer;
    with tracing unconfigured ``new_trace()`` is None and a step pays one
    call."""

    def __init__(self, timer: StepTimer, rank: int):
        self._timer = timer
        self._rank = rank
        self._scope: contextlib.ExitStack | None = None

    def start(self) -> None:
        if self._scope is not None:  # an exception ended the last step
            self._scope.close()
        self._timer.start()
        ctx = dtrace.new_trace()
        if ctx is not None:
            scope = contextlib.ExitStack()
            scope.enter_context(dtrace.use(ctx))
            scope.enter_context(dtrace.span("train.step", tags={"rank": self._rank}))
            self._scope = scope

    def stop(self, n: int):
        if self._scope is not None:
            self._scope.close()
            self._scope = None
        return self._timer.stop(n)

    def __getattr__(self, name):
        return getattr(self._timer, name)


def ps_param_dim(cfg: Config) -> int:
    """Flat KV key-space size for a config (must match between servers
    and workers; softmax flattens its (D, K) weight matrix)."""
    return cfg.num_feature_dim * (
        cfg.num_classes if cfg.model in ("softmax", "sparse_softmax") else 1)


def ps_retry_policy(cfg: Config) -> RetryPolicy | None:
    """The workers' retry policy a config asks for, or None: async only,
    since a sync round's failed push is the named straggler signal and a
    retried barrier would mix gradients across rounds.  It sits before
    the restart and resume ladder: only an exhausted policy surfaces the
    failure to ``max_restarts`` or to a resume."""
    if cfg.sync_mode:
        return None
    return RetryPolicy.from_config(cfg)


def server_optimizer(cfg: Config) -> str:
    """The update rule the server group runs: ``signsgd`` compression
    replaces the rule (1-bit votes through another optimizer would be a
    sign mean, not a majority vote), else ``ps_optimizer``.  Local spawns
    and ``launch ps-server`` share it."""
    return "signsgd" if cfg.ps_compress == "signsgd" else cfg.ps_optimizer


def ps_compute_device(cfg: Config):
    """Where PS workers run their dense steps: the string ``"numpy"``
    (host numpy, f32) or a :class:`torch.device`.

    ``ps_compute_backend``: ``numpy`` and ``cpu`` (torch on the CPU) on
    request; ``auto`` and ``default`` take ``cfg.device``.  The JAX
    package's ``auto`` moves small steps to the host by a size rule tuned
    on the TPU's dispatch cost; the port keeps no such rule, so an entry
    point runs on the card unless the caller asks for the host.
    """
    choice = cfg.ps_compute_backend
    if choice == "numpy":
        return "numpy"
    if choice == "cpu":
        return torch.device("cpu")
    return torch.device(cfg.device)


def _np_dense_grad(w, X, y, mask, l2_c, l2_scale_by_batch, num_classes=None):
    """f32 numpy mirror of ``BinaryLR.grad`` / ``SoftmaxRegression.grad``
    (``ps_compute_backend="numpy"``); the quirk gates (Q4 L2/B) are the
    models'.
    The sigmoid is ``0.5·(1 + tanh(0.5 z))``, as the JAX package's."""
    y = np.asarray(y)
    mask = np.asarray(mask, np.float32)
    n = np.float32(max(mask.sum(), 1.0))
    if num_classes is None:
        z = X @ w
        sig = (0.5 * (1.0 + np.tanh(0.5 * z))).astype(np.float32)
        resid = (sig - y.astype(np.float32)) * mask
        g = resid @ X / n
    else:
        z = X @ w  # (B, K)
        z -= z.max(axis=1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=1, keepdims=True)
        p[np.arange(len(y)), y] -= 1.0
        g = X.T @ (p * mask[:, None]) / n
    if l2_c:
        term = np.float32(l2_c) * w
        g = g + (term / n if l2_scale_by_batch else term)
    return np.asarray(g, dtype=np.float32)


def _binary_eval_from_logits(z, y, mask) -> tuple[float, float]:
    """(accuracy, logloss) of binary logits, the masked means in f64."""
    z = np.asarray(z, np.float64)
    m = np.asarray(mask, np.float64)
    n = max(m.sum(), 1.0)
    acc = float((((z > 0).astype(np.int64) == y) * m).sum() / n)
    ll = float(((np.logaddexp(0.0, z) - y * z) * m).sum() / n)
    return acc, ll


def _dense_eval_from_logits(z, y, mask, num_classes=None) -> tuple[float, float]:
    """(accuracy, logloss) from one forward pass's logits: (B,) binary or
    (B, K) softmax (argmax, the first of tied classes)."""
    z = np.asarray(z, np.float64)
    if num_classes is None:
        return _binary_eval_from_logits(z, y, mask)
    m = np.asarray(mask, np.float64)
    n = max(m.sum(), 1.0)
    pred = z.argmax(axis=1)
    zs = z - z.max(axis=1, keepdims=True)
    ll = np.log(np.exp(zs).sum(axis=1)) - zs[np.arange(len(y)), y]
    acc = float(((pred == y) * m).sum() / n)
    return acc, float((ll * m).sum() / n)


def _np_dense_eval(w, X, y, mask, num_classes=None):
    """f32 numpy ``(accuracy, logloss)`` for the dense models."""
    return _dense_eval_from_logits(X @ w, y, mask, num_classes)


def _sparse_batch_grad(w_u, pos, vals, y, mask, l2_c, l2_scale_by_batch):
    """Gradient of the sparse one-hot LR loss wrt the batch's UNIQUE
    touched weights (host numpy; the JAX package's function).

    ``w_u`` are the pulled weights of the batch's unique columns and
    ``pos`` maps each (row, slot) to its index in ``w_u``; the scatter is
    ``np.bincount`` (f64 sums, cast to f32).  L2 is lazy: only keys a real
    (nonzero) value touched decay, so COO padding at key 0 does not give
    bucket 0 every-step decay.
    """
    z = (w_u[pos] * vals).sum(axis=-1)
    sig = 0.5 * (1.0 + np.tanh(0.5 * z))
    n = np.float32(max(mask.sum(), 1))
    resid = ((sig - y) * mask).astype(np.float32)
    contrib = (resid[:, None] * vals).ravel() / n
    g = np.bincount(pos.ravel(), weights=contrib, minlength=len(w_u)).astype(np.float32)
    if l2_c:
        active = np.bincount(pos.ravel(), weights=(vals != 0).ravel().astype(np.float32),
                             minlength=len(w_u)) > 0
        term = np.float32(l2_c) * w_u * active
        g += term / n if l2_scale_by_batch else term
    return g


def _sparse_softmax_batch_grad(W_u, pos, vals, y, mask, l2_c, l2_scale_by_batch):
    """Gradient of the sparse softmax loss wrt the batch's UNIQUE touched
    (D, K) table rows (host numpy; the JAX package's function): ``W_u`` is
    the ``(n_u, K)`` pulled slice; ``np.add.at`` adds in f32, in order.
    Lazy L2 at row granularity with the active-key discount."""
    z = (W_u[pos] * vals[..., None]).sum(axis=1)
    z -= z.max(axis=1, keepdims=True)
    p = np.exp(z, dtype=np.float32)
    p /= p.sum(axis=1, keepdims=True)
    p[np.arange(len(y)), y] -= 1.0
    n = np.float32(max(mask.sum(), 1))
    resid = p * np.asarray(mask, np.float32)[:, None]
    contrib = (vals[..., None] * resid[:, None, :]).reshape(-1, W_u.shape[1]) / n
    g = np.zeros_like(W_u, dtype=np.float32)
    np.add.at(g, pos.ravel(), contrib)
    if l2_c:
        active = np.bincount(pos.ravel(), weights=(vals != 0).ravel().astype(np.float32),
                             minlength=len(W_u)) > 0
        term = np.float32(l2_c) * W_u * active[:, None]
        g += term / n if l2_scale_by_batch else term
    return g


def _expand_block_keys(blocks: np.ndarray, block_size: int) -> np.ndarray:
    """Unique row ids -> their flat KV keys (row b owns the contiguous
    range ``[b*R, (b+1)*R)`` of the ``ps_param_dim`` key space)."""
    r = np.arange(block_size, dtype=np.uint64)
    return (blocks.astype(np.uint64)[:, None] * np.uint64(block_size) + r).reshape(-1)


def _blocked_batch_grad(t_u, pos, lane_vals, y, mask, l2_c, l2_scale_by_batch):
    """Gradient of the blocked LR loss wrt the batch's UNIQUE touched
    table rows (host numpy; the JAX package's function): ``t_u`` is the
    ``(n_u, R)`` pulled slice, ``pos`` maps each (sample, group) to its
    row.  Lazy L2 at row granularity: a row gathered with a real
    (nonzero) lane decays as a unit."""
    z = (t_u[pos] * lane_vals).sum(axis=(-1, -2))
    sig = 0.5 * (1.0 + np.tanh(0.5 * z))
    n = np.float32(max(mask.sum(), 1))
    resid = ((sig - y) * mask).astype(np.float32)
    contrib = (resid[:, None, None] * lane_vals).reshape(-1, t_u.shape[1]) / n
    g = np.zeros_like(t_u, dtype=np.float32)
    np.add.at(g, pos.reshape(-1), contrib)
    if l2_c:
        touched = (lane_vals != 0).any(axis=-1).reshape(-1)
        active = np.zeros(len(t_u), bool)
        np.logical_or.at(active, pos.reshape(-1), touched)
        term = np.float32(l2_c) * t_u * active[:, None]
        g += term / n if l2_scale_by_batch else term
    return g


def _lazy_l2(g, w_u, active, n, l2_c, l2_scale_by_batch):
    """Add the lazy L2 term ``l2_c * w_u`` on the active rows to ``g``."""
    if active.dim() < w_u.dim():
        active = active[:, None]
    term = l2_c * w_u * active
    return g + (term / n if l2_scale_by_batch else term)


def _active_rows(pos, touched, n_u):
    """Rows of the unique slice that a real (nonzero) value touched."""
    return torch.zeros(n_u, dtype=torch.float32, device=pos.device).index_add_(
        0, pos.reshape(-1), touched.reshape(-1).to(torch.float32)) > 0


def _sparse_batch_grad_torch(w_u, pos, vals, y, mask, l2_c, l2_scale_by_batch):
    """:func:`_sparse_batch_grad` in torch on the tensors' device: a
    gather, σ as ``0.5·(1 + tanh(z/2))``, and an ``index_add_`` scatter
    (f32 sums; on the card in any order)."""
    z = (w_u[pos] * vals).sum(dim=-1)
    sig = 0.5 * (1.0 + torch.tanh(0.5 * z))
    n = mask.sum().clamp(min=1).to(torch.float32)
    resid = (sig - y) * mask
    contrib = (resid[:, None] * vals).reshape(-1) / n
    g = torch.zeros_like(w_u).index_add_(0, pos.reshape(-1), contrib)
    if l2_c:
        g = _lazy_l2(g, w_u, _active_rows(pos, vals != 0, w_u.shape[0]), n, l2_c,
                     l2_scale_by_batch)
    return g


def _sparse_softmax_batch_grad_torch(W_u, pos, vals, y, mask, l2_c, l2_scale_by_batch):
    """:func:`_sparse_softmax_batch_grad` in torch on the tensors' device."""
    z = (W_u[pos] * vals[..., None]).sum(dim=1)
    p = torch.softmax(z, dim=1)
    p[torch.arange(y.shape[0], device=y.device), y.long()] -= 1.0
    n = mask.sum().clamp(min=1).to(torch.float32)
    resid = p * mask.to(torch.float32)[:, None]
    contrib = (vals[..., None] * resid[:, None, :]).reshape(-1, W_u.shape[1]) / n
    g = torch.zeros_like(W_u).index_add_(0, pos.reshape(-1), contrib)
    if l2_c:
        g = _lazy_l2(g, W_u, _active_rows(pos, vals != 0, W_u.shape[0]), n, l2_c,
                     l2_scale_by_batch)
    return g


def _blocked_batch_grad_torch(t_u, pos, lane_vals, y, mask, l2_c, l2_scale_by_batch):
    """:func:`_blocked_batch_grad` in torch on the tensors' device."""
    z = (t_u[pos] * lane_vals).sum(dim=(-1, -2))
    sig = 0.5 * (1.0 + torch.tanh(0.5 * z))
    n = mask.sum().clamp(min=1).to(torch.float32)
    resid = (sig - y) * mask
    contrib = (resid[:, None, None] * lane_vals).reshape(-1, t_u.shape[1]) / n
    g = torch.zeros_like(t_u).index_add_(0, pos.reshape(-1), contrib)
    if l2_c:
        g = _lazy_l2(g, t_u, _active_rows(pos, (lane_vals != 0).any(dim=-1), t_u.shape[0]),
                     n, l2_c, l2_scale_by_batch)
    return g


#: family -> (numpy gradient, torch gradient) of the keyed round
_KEYED_GRADS = {
    "sparse_lr": (_sparse_batch_grad, _sparse_batch_grad_torch),
    "sparse_softmax": (_sparse_softmax_batch_grad, _sparse_softmax_batch_grad_torch),
    "blocked_lr": (_blocked_batch_grad, _blocked_batch_grad_torch),
}


def keyed_row_width(cfg: Config) -> int:
    """Values one keyed row owns: ``block_size`` lanes (blocked_lr),
    ``num_classes`` (sparse_softmax), else 1."""
    if cfg.model == "blocked_lr":
        return cfg.block_size
    return cfg.num_classes if cfg.model == "sparse_softmax" else 1


def _keyed_logits(w_u, pos, vals, model: str):
    """Logits of the keyed families from a unique slice: numpy arrays on
    the host or tensors on a device."""
    if model == "blocked_lr":
        return (w_u[pos] * vals).sum(axis=(-1, -2))
    if model == "sparse_softmax":
        return (w_u[pos] * vals[..., None]).sum(axis=1)
    return (w_u[pos] * vals).sum(axis=-1)


def load_ps_iter(cfg: Config, path: str, batch_size: int, *, wrap: bool = False) -> DataIter:
    """A PS worker's iterator over one shard, in its family's batch layout:
    dense rows, padded COO (``sparse_lr``, ``sparse_softmax``) or row
    blocks hashed from raw CTR rows (``blocked_lr``)."""
    if cfg.model in ("sparse_lr", "sparse_softmax"):
        return SparseDataIter.from_file(path, cfg.num_feature_dim, batch_size,
                                        nnz_max=cfg.nnz_max,
                                        multiclass=cfg.model == "sparse_softmax",
                                        wrap_compat=wrap)
    if cfg.model == "blocked_lr":
        from distlr_tpu_torch.data.hashing import resolve_ctr_fields  # noqa: PLC0415

        return BlockedDataIter.from_file(
            path, resolve_ctr_fields(cfg.data_dir, cfg.ctr_fields),
            cfg.num_feature_dim // cfg.block_size, cfg.block_size, batch_size,
            seed=cfg.hash_seed, num_groups=cfg.block_groups, wrap_compat=wrap)
    return DataIter.from_file(path, cfg.num_feature_dim, batch_size,
                              multiclass=cfg.model == "softmax", wrap_compat=wrap)


def check_ps_config(cfg: Config) -> torch.device:
    """Refuse what the port's PS path does not run, then resolve
    ``cfg.device`` (which raises without CUDA unless the CPU was asked
    for, even when ``ps_compute_backend`` puts the steps on the host)."""
    if cfg.model in ("sparse_lr", "blocked_lr") and cfg.sync_last_gradient:
        # Q1 is a dense-reference parity quirk: with keyed pushes "the last
        # worker's gradient" touches an arbitrary key subset a server
        raise ValueError(
            "sync_last_gradient (Q1 compat) is a dense-model parity "
            f"quirk; {cfg.model} PS training requires the correct-mean "
            "update (compat_mode='correct')")
    if cfg.model == "blocked_lr" and cfg.block_size == 0:
        raise ValueError("block_size=0 (auto) must be resolved before PS training "
                         "(launch ps resolves it; see hashing.resolve_auto_block_size)")
    if cfg.feature_dtype != "float32":
        # PS workers stream numpy batches from host RAM each step: there is
        # no resident feature matrix for quantization to shrink
        raise ValueError(
            "feature_dtype quantization applies to the sync trainer's resident "
            "features; PS mode streams host batches (set feature_dtype='float32')")
    return resolve_device(cfg.device)


def _sidecar(cfg: Config) -> str:
    return os.path.join(cfg.checkpoint_dir, "ps_latest.json")


def _write_sidecar(cfg: Config, data: dict) -> None:
    """``ps_latest.json`` as the JAX package writes it: ``json.dump``
    to a temporary name, renamed into place."""
    tmp = _sidecar(cfg) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, _sidecar(cfg))


def _ps_resume_state(cfg: Config, rank: int):
    """``(start_epoch, weights | None, attempt | None)`` from
    ``cfg.checkpoint_dir``; ``attempt`` is None without a sidecar.

    Every rank reads the epoch from the sidecar ``ps_latest.json``, which
    rank 0 writes after each checkpoint, so sync workers agree on the
    epochs left; rank 0 also restores the weights, which reach the
    servers through its init push.  The step restored is the sidecar's,
    not the latest: a crash between a save and the sidecar's rename
    leaves the latest step one interval ahead of the sidecar.
    """
    sidecar = _sidecar(cfg)
    if not os.path.exists(sidecar):
        return 0, None, None
    with open(sidecar) as f:
        data = json.load(f)
    epoch = int(data["epoch"])
    attempt = int(data.get("attempt", 0))
    if rank != 0 or epoch == 0:
        # epoch 0: a resume-attempt sidecar written before the first
        # checkpoint; there is no step to restore, only a barrier
        # generation to advance
        return epoch, None, attempt
    with Checkpointer(cfg.checkpoint_dir) as ckpt:
        state = ckpt.restore(epoch) if epoch in ckpt.all_steps() else None
    if state is None:  # a sidecar without its step (a JAX orbax dir, say)
        raise FileNotFoundError(
            f"{sidecar} names epoch {epoch} but {cfg.checkpoint_dir} holds "
            f"no orbax checkpoint for that step"
        )
    return epoch, np.asarray(state["weights"]).reshape(-1), attempt


def bump_resume_attempt(cfg: Config) -> None:
    """Advance the sidecar's resume-attempt counter, once a resumed job,
    before any worker starts (on the rank-0 host).  Each resume then meets
    at barrier generations the group never released: a surviving group
    answers a vote for a released generation at once, which would let
    peers pull crash-time weights before rank 0's forced init.  Without a
    sidecar (a crash before the first checkpoint) it is created at epoch
    0."""
    if not cfg.checkpoint_dir:
        return
    sidecar = _sidecar(cfg)
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            data = json.load(f)
    else:
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        data = {"epoch": 0, "attempt": 0}
    data["attempt"] = int(data.get("attempt", 0)) + 1
    _write_sidecar(cfg, data)


class PSWorker:
    """One worker's training loop against a KV server group.  The dense
    families pull and push the full weight vector a batch, like the
    reference worker; the keyed families only the batch's unique rows.

    ``op_seconds`` collects the host seconds of each KV op (``pull``,
    ``push``, ``push_pull``), of each gradient (``grad``) and of each
    keyed round's key preparation (``prep``);
    :meth:`report` summarizes them, with the span of each ``model.grad``
    call on the card's stream (CUDA events).  ``device_lock``, shared by
    the workers of one card, holds a gradient's copy to the card, call
    and read-back together: on the card's one stream they run one after
    another anyway, and the events then span this worker's call alone.
    """

    def __init__(self, cfg: Config, rank: int, hosts: str, *,
                 device_lock: threading.Lock | None = None):
        check_ps_config(cfg)
        self.cfg = cfg
        self.rank = rank
        self.model = get_model(cfg)
        # the negotiated wire codec (dense f32 when the group does not
        # advertise it: KVWorker logs the fallback)
        self.kv = KVWorker(hosts, ps_param_dim(cfg), client_id=rank,
                           timeout_ms=cfg.ps_timeout_ms, sync_group=cfg.sync_mode,
                           retry=ps_retry_policy(cfg), compress=cfg.ps_compress)
        #: the barrier generations of this run: 0 (startup) and 1 (exit), or
        #: a fresh pair a resume attempt
        self._barrier_base = 0
        self._sidecar_attempt = 0
        #: in-place restarts before this instance, and the client's fault
        #: counters of the instances it replaced (run_ps_workers)
        self.restarts = 0
        self.prior_faults: dict[str, int] = {}
        #: seconds from run() to the startup barrier's release: with
        #: resume, the sidecar read, the restore and the forced init
        self.rendezvous_s: float | None = None
        self._reaper: threading.Thread | None = None
        self.metrics = MetricsLogger()
        # registry-backed step accounting: the "ps" counters add up over
        # the process's worker threads, each worker's rate gauge is its own
        self.timer = _StepTrace(StepTimer(loop="ps", instance=str(rank)), rank)
        # pushes-behind staleness probing (async only): a second client on
        # the group, built lazily, reading its push clock
        self._hosts = hosts
        self._push_probe: KVWorker | None = None
        self._push_probe_dead = cfg.sync_mode  # sync BSP: staleness is 0
        self._probe_retry_at = 0.0  # monotonic; rebuild cooldown gate
        self._last_pushes_sample = float("-inf")
        self._staleness_pushes = _STALENESS_PUSHES.labels(rank=str(rank))
        self._w_time = 0.0  # when _w_cache was pulled (staleness gauge)
        self._w_pushes: float | None = None  # push clock at _w_cache's arrival
        # runtime introspection (obs.torchrt): the dense steps' signatures,
        # ticked at each epoch's end (the keyed families' torch and numpy
        # gradients have no probe, as their host math has none in JAX)
        self._compile_probes = []
        if cfg.model not in ("sparse_lr", "blocked_lr"):
            grad_key = (self.model, cfg.l2_c, bool(cfg.l2_scale_by_batch))
            self._grad_sigs = _GRAD_SIGS.setdefault(grad_key, torchrt.SignatureCache())
            self._eval_sigs = _EVAL_SIGS.setdefault(self.model, torchrt.SignatureCache())
            self._compile_probes = [torchrt.CompileProbe(self._grad_sigs, "train.ps.grad"),
                                    torchrt.CompileProbe(self._eval_sigs, "train.ps.eval")]
        self.final_weights: np.ndarray | None = None
        #: the group's push clock read by rank 0 at the exit barrier
        self.group_pushes: float | None = None
        self.op_seconds: dict[str, list[float]] = {}
        self._grad_events: list = []
        self._device_lock = device_lock or threading.Lock()
        self._test_features = None  # the test set on the eval device, once
        # pipelined dense path: the last fused reply's weights, and one comm
        # thread (ops on one connection must never overlap)
        self._w_cache: np.ndarray | None = None
        self._comm: ThreadPoolExecutor | None = None
        #: keyed rounds: the unique rows of each and the wire's vals_per_key
        self.keyed_rows: list[int] = []
        self.vals_per_key: int | None = None
        #: the AdaBatch accumulator of a run with ps_accum_max > 1
        self.accum: GradientAccumulator | None = None
        self._test_keyed = None  # the keyed test set's unique rows and positions, once
        if cfg.model in _KEYED_MODELS and cfg.l2_c > 0:
            # only a batch's touched keys decay, scaled by touch frequency,
            # while the sync trainer decays every weight every step
            log.warning("%s PS mode applies L2 lazily (touched keys only); effective "
                        "regularization differs from the sync trainer at the same l2_c "
                        "— see PARITY.md", cfg.model)

    @contextlib.contextmanager
    def _timed(self, op: str, phase: str | None = "op"):
        """Time ``op`` into :attr:`op_seconds`, under the tracer's phase of
        that op (``phase=None``: no span)."""
        phase = _OP_PHASES[op] if phase == "op" else phase
        with trace_phase(phase) if phase else contextlib.nullcontext():
            t0 = time.perf_counter()
            yield
            self.op_seconds.setdefault(op, []).append(time.perf_counter() - t0)

    # -- pushes-behind staleness probing (async/Hogwild only) -------------
    def _sample_push_clock(self) -> float | None:
        """The group's global push clock now, or None when throttled or
        the probe is unavailable.  A non-None return arms one
        :meth:`_record_pushes_behind` call at push time."""
        now = time.perf_counter()
        if now - self._last_pushes_sample < _PUSHES_SAMPLE_INTERVAL_S:
            return None
        if self._push_probe is None:
            if self._push_probe_dead or time.monotonic() < self._probe_retry_at:
                return None
            try:
                self._push_probe = KVWorker(self._hosts, ps_param_dim(self.cfg),
                                            client_id=0xFD00 + self.rank, timeout_ms=2000,
                                            sync_group=False)
            except Exception:  # noqa: BLE001 — observability never stops training
                self._probe_retry_at = time.monotonic() + _PROBE_RETRY_COOLDOWN_S
                return None
        try:
            clock = self._push_probe.global_pushes()
        except Exception:  # noqa: BLE001
            self._drop_push_probe()
            return None
        self._last_pushes_sample = now
        return clock

    def _record_pushes_behind(self, pulled_clock: float | None) -> None:
        """Observe the staleness of the gradient about to be pushed:
        push-time clock minus ``pulled_clock`` (the pull-time sample) =
        peer updates the weights aged by while this worker computed."""
        if pulled_clock is None or self._push_probe is None:
            return
        try:
            clock = self._push_probe.global_pushes()
        except Exception:  # noqa: BLE001
            self._drop_push_probe()
            return
        self._staleness_pushes.observe(max(0.0, clock - pulled_clock))

    def _drop_push_probe(self) -> None:
        """Close a failed probe and rebuild it after the cooldown (under a
        fault plan a transient fault may land on its connection)."""
        probe, self._push_probe = self._push_probe, None
        self._probe_retry_at = time.monotonic() + _PROBE_RETRY_COOLDOWN_S
        if probe is not None:
            with contextlib.suppress(Exception):
                probe.close()

    def _set_staleness(self, since: float) -> None:
        _STALENESS.labels(rank=self.rank).set(time.perf_counter() - since)

    def _num_classes(self):
        return self.cfg.num_classes if self.cfg.model == "softmax" else None

    def _shape_params(self, flat: np.ndarray) -> np.ndarray:
        K = self._num_classes()
        return flat.reshape(self.cfg.num_feature_dim, K) if K else flat

    def _features(self, X: np.ndarray, dev: torch.device) -> torch.Tensor:
        """X on the host as a step on ``dev`` takes it: for the card bf16
        when the products are bf16 (the kernels round X to bf16 anyway,
        and the copy halves), else f32."""
        Xt = torch.from_numpy(np.ascontiguousarray(X))
        if dev.type == "cuda" and self.cfg.compute_dtype == "bfloat16":
            Xt = Xt.to(torch.bfloat16)
        return Xt

    def _load_train_iter(self) -> DataIter:
        # The reference re-reads its shard every epoch (src/main.cc:158-159);
        # it is parsed once here and reset (the same samples).
        path = os.path.join(self.cfg.data_dir, "train", part_name(self.rank))
        return load_ps_iter(self.cfg, path, self.cfg.batch_size,
                            wrap=bool(self.cfg.wrap_final_batch))  # Q5

    def _load_test_iter(self) -> DataIter:
        return load_ps_iter(self.cfg, os.path.join(self.cfg.data_dir, "test", part_name(0)), -1)

    def _grad_fn(self, dev):
        """``compute_g(w_flat, X, y, mask) -> g_flat`` (numpy in and out)
        on ``dev``: host numpy, or the model's ``grad`` on a torch device."""
        cfg = self.cfg
        K = self._num_classes()
        if dev == "numpy":
            def compute_g(wf, X, y, mask):
                with self._timed("grad"):
                    return _np_dense_grad(self._shape_params(wf), X, y, mask, cfg.l2_c,
                                          bool(cfg.l2_scale_by_batch), K).reshape(-1)
            return compute_g

        def compute_g(wf, X, y, mask):
            self._grad_sigs.note(self._shape_params(wf), X, y, mask)
            with self._timed("grad"):
                if dev.type != "cuda":
                    g = self.model.grad(torch.from_numpy(self._shape_params(wf)),
                                        (self._features(X, dev), torch.from_numpy(np.asarray(y)),
                                         torch.from_numpy(np.asarray(mask, np.float32))), cfg)
                    return g.numpy().reshape(-1)
                Xh = self._features(X, dev)  # the host-side cast, unlocked
                with self._device_lock:
                    w = torch.from_numpy(self._shape_params(wf)).to(dev)
                    batch = (Xh.to(dev), torch.from_numpy(np.asarray(y)).to(dev),
                             torch.from_numpy(np.asarray(mask, np.float32)).to(dev))
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    g = self.model.grad(w, batch, cfg)
                    end.record()
                    g = g.cpu()
                self._grad_events.append((start, end))
                return g.numpy().reshape(-1)
        return compute_g

    def _keyed_grad_fn(self, dev, row_width: int):
        """``kgrad(w_u, (pos, vals, y, mask)) -> g_flat`` of the keyed
        families (numpy in and out): the host numpy function, or its torch
        counterpart on ``dev`` (on the card under the device lock, with
        CUDA events around the call, as the dense gradient)."""
        cfg = self.cfg
        np_fn, torch_fn = _KEYED_GRADS[cfg.model]
        l2 = (cfg.l2_c, bool(cfg.l2_scale_by_batch))

        def rows(w_u):
            return w_u if cfg.model == "sparse_lr" else w_u.reshape(-1, row_width)

        if dev == "numpy":
            def kgrad(w_u, rest):
                with self._timed("grad"):
                    return np_fn(rows(w_u), *rest, *l2).reshape(-1)
            return kgrad

        def kgrad(w_u, rest):
            with self._timed("grad"):
                host = [torch.from_numpy(np.ascontiguousarray(a)) for a in (rows(w_u), *rest)]
                if dev.type != "cuda":
                    return torch_fn(*host, *l2).numpy().reshape(-1)
                with self._device_lock:
                    args = [a.to(dev) for a in host]
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    g = torch_fn(*args, *l2)
                    end.record()
                    g = g.cpu()
                self._grad_events.append((start, end))
                return g.numpy().reshape(-1)
        return kgrad

    def _pull_rows(self, rows: np.ndarray, row_width: int) -> np.ndarray:
        """The servers' values of unique ``rows``: ``vals_per_key`` rows
        where the group's ranges align, else expanded per-lane keys."""
        if row_width > 1 and not self.kv.supports_vals_per_key(row_width):
            return self.kv.pull(_expand_block_keys(rows, row_width))
        return self.kv.pull(rows.astype(np.uint64), vals_per_key=row_width)

    def _keyed_evaluate(self, test: DataIter, dev) -> tuple[float, float]:
        """Full-test-set ``(accuracy, logloss)`` of the keyed families: a
        keyed pull of the test set's unique rows, then one forward pass
        (host numpy, or gathers on the compute device)."""
        cfg = self.cfg
        R = keyed_row_width(cfg)
        if self._test_keyed is None:
            test.reset()
            ids, vals, y, mask = test.next_batch()
            ub, pos = np.unique(ids, return_inverse=True)
            pos = pos.reshape(ids.shape)
            if dev != "numpy":
                pos, vals = torch.from_numpy(pos).to(dev), torch.from_numpy(vals).to(dev)
            self._test_keyed = ub, pos, vals, y, mask
        ub, pos, vals, y, mask = self._test_keyed
        w_u = self._pull_rows(ub, R)
        w_u = w_u if cfg.model == "sparse_lr" else w_u.reshape(-1, R)
        if dev == "numpy":
            z = _keyed_logits(w_u, pos, vals, cfg.model)
        else:
            z = _keyed_logits(torch.from_numpy(w_u).to(dev), pos, vals, cfg.model).cpu().numpy()
        return _dense_eval_from_logits(z, y, mask,
                                       cfg.num_classes if cfg.model == "sparse_softmax" else None)

    def _evaluate(self, test: DataIter, dev) -> tuple[float, float]:
        """Full-test-set ``(accuracy, logloss)`` of the servers' weights,
        from one forward pass."""
        if self.cfg.model in _KEYED_MODELS:
            return self._keyed_evaluate(test, dev)
        w = self.kv.pull()
        test.reset()
        Xt, yt, mt = test.next_batch()
        K = self._num_classes()
        if dev == "numpy":
            return _np_dense_eval(self._shape_params(w), Xt, yt, mt.astype(np.float32), K)
        self._eval_sigs.note(self._shape_params(w), Xt, yt, mt)
        if self._test_features is None:
            self._test_features = self._features(Xt, dev).to(dev)
        z = self.model.logits(torch.from_numpy(self._shape_params(w)).to(dev),
                              self._test_features)
        return _dense_eval_from_logits(z.cpu().numpy(), yt, mt, K)

    def run(self, *, eval_fn=None, save: bool = True, resume: bool = False,
            rejoin: bool = False) -> np.ndarray:
        cfg = self.cfg
        t0 = time.perf_counter()
        train = self._load_train_iter()
        test = self._load_test_iter() if self.rank == 0 else None
        start_epoch, restored, attempt = 0, None, None
        if resume and cfg.checkpoint_dir:
            start_epoch, restored, attempt = _ps_resume_state(cfg, self.rank)
        # identical deterministic init on every worker (Q2), or the restored
        # weights; only rank 0 pushes, through the idempotent seeding op.
        # On resume the push is forced: a surviving group holds crash-time
        # weights.  A restarted worker (rejoin) never forces: it would roll
        # its peers back mid-run.
        w0 = restored if restored is not None else self.model.init(cfg).numpy().reshape(-1)
        if self.rank == 0:
            with trace_phase("push"):
                self.kv.wait(self.kv.push_init(w0, force=resume and not rejoin))
        # every rank reads the same sidecar, so all agree on the pair; a
        # rejoining worker's late vote for a released generation returns
        # at once
        self._barrier_base = 0 if attempt is None else 2 * (attempt + 1)
        self._sidecar_attempt = 0 if attempt is None else attempt
        with trace_phase("barrier_wait"):
            self.kv.barrier(self._barrier_base)
        self.rendezvous_s = time.perf_counter() - t0
        ckpt = Checkpointer(cfg.checkpoint_dir) if self.rank == 0 and cfg.checkpoint_dir else None
        # rank 0's loop (the gradients' launches and the KV round trips)
        # under torch.profiler with profile_dir, as JAX's under its trace
        dev = ps_compute_device(cfg)
        with (ckpt if ckpt is not None else contextlib.nullcontext()), torchrt.profiled(
                cfg.profile_dir if self.rank == 0 else None,
                dev if isinstance(dev, torch.device) else "cpu", "ps-rank0"):
            return self._run_epochs(start_epoch, train, test, ckpt, eval_fn=eval_fn, save=save)

    def _checkpoint(self, ckpt: Checkpointer, epoch: int) -> None:
        """Rank 0: the servers' weights as step ``epoch``, then the
        sidecar (its attempt kept: a rejoining worker re-reads it and must
        derive the same barrier pair)."""
        with self._timed("checkpoint"):
            ckpt.save(epoch, self.kv.pull(), extra={"epoch": epoch})
            _write_sidecar(self.cfg, {"epoch": epoch, "attempt": self._sidecar_attempt})

    def _flush_dense_accum(self, accum: GradientAccumulator) -> None:
        """Push one dense accumulation span: its mean gradient."""
        g = accum.flush_dense()
        if g is None:
            return
        if not self.cfg.sync_mode:
            self._set_staleness(self._w_time)
            self._record_pushes_behind(self._w_pushes)
        with self._timed("push"):
            self.kv.wait(self.kv.push(g))

    def _flush_keyed_accum(self, accum: GradientAccumulator, vpk: int) -> None:
        """Push one keyed accumulation span: the mean gradient on the rows
        it touched.  A sync span that cancelled to exact zeros still
        pushes an empty frame: the BSP vote its peers' replies wait on."""
        res = accum.flush_keyed(vpk)
        if res is None:
            return  # no batches in the span: the same on every worker
        rows, vals = res
        if rows.size == 0 and not self.cfg.sync_mode:
            return
        with self._timed("push"):
            self.kv.wait(self.kv.push(vals, rows, vals_per_key=vpk))

    def _run_epochs(self, start_epoch: int, train: DataIter, test: DataIter | None,
                    ckpt: Checkpointer | None, *, eval_fn, save):
        cfg = self.cfg
        dev = ps_compute_device(cfg)
        dev = resolve_device(dev) if isinstance(dev, torch.device) else dev
        keyed = cfg.model in _KEYED_MODELS
        # AdaBatch accumulation: the span's mean a push, k growing on the
        # schedule; a span also ends with its epoch, so epochs stay
        # self-contained for eval and BSP workers stay in lockstep
        accum = self.accum = (GradientAccumulator(
            ps_param_dim(cfg), start=cfg.ps_accum_start, growth=cfg.ps_accum_growth,
            growth_every=cfg.ps_accum_growth_every, max_k=cfg.ps_accum_max,
            gauge=_ACCUM_K.labels(rank=str(self.rank)))
            if cfg.ps_accum_max > 1 else None)
        if keyed:
            kround = self._keyed_round(dev, accum)
        else:
            compute_g = self._grad_fn(dev)
        for epoch in range(start_epoch, cfg.num_iteration):
            train.reset()
            if keyed:
                # serialized in both modes: in sync a pull issued before the
                # round's push would read pre-round weights; the pull and push
                # key sets differ a batch, so no fused op removes a round trip
                for b in train:
                    self.timer.start()
                    kround(b)
                    self.timer.stop(int(b[-1].sum()))
                if accum is not None:
                    self._flush_keyed_accum(accum, self.vals_per_key)
            elif accum is not None:
                # a pull at each span's start, k gradients on the span's
                # weights, one push of their mean: the fused and pipelined
                # protocols give way (the span already removes k-1 of k
                # round trips), as in the JAX package
                for X, y, mask in train:
                    self.timer.start()
                    if accum.batches == 0:
                        with self._timed("pull"):
                            self._w_cache = self.kv.pull()
                        self._w_time = time.perf_counter()
                        self._w_pushes = None if cfg.sync_mode else self._sample_push_clock()
                    accum.add(compute_g(self._w_cache, X, y, mask))
                    if accum.ready:
                        self._flush_dense_accum(accum)
                    self.timer.stop(int(mask.sum()))
                self._flush_dense_accum(accum)
            elif not cfg.ps_pipeline:
                # the reference's serialized protocol: two blocking round
                # trips a batch (src/lr.cc:116-132)
                for X, y, mask in train:
                    self.timer.start()
                    t_pull = time.perf_counter()
                    with self._timed("pull"):
                        w = self.kv.pull()
                    p0 = None if cfg.sync_mode else self._sample_push_clock()
                    g = compute_g(w, X, y, mask)
                    if not cfg.sync_mode:
                        self._set_staleness(t_pull)
                        self._record_pushes_behind(p0)
                    with self._timed("push"):
                        self.kv.wait(self.kv.push(g))
                    self.timer.stop(int(mask.sum()))
            elif cfg.sync_mode:
                # fused BSP: one deferred round trip a batch; the reply is
                # the post-round weights, what the next pull would return
                if self._w_cache is None:
                    with self._timed("pull"):
                        self._w_cache = self.kv.pull()
                for X, y, mask in train:
                    self.timer.start()
                    g = compute_g(self._w_cache, X, y, mask)
                    with self._timed("push_pull"):
                        self._w_cache = self.kv.push_pull(g)
                    self.timer.stop(int(mask.sum()))
            else:
                # pipelined Hogwild: batch k+1's gradient is computed while
                # batch k's fused round trip is in flight on the comm thread
                # (the weights are stale by that one push)
                if self._w_cache is None:
                    with self._timed("pull"):
                        self._w_cache = self.kv.pull()
                    self._w_time = time.perf_counter()
                    self._w_pushes = self._sample_push_clock()
                fut = None
                for X, y, mask in train:
                    self.timer.start()
                    g = compute_g(self._w_cache, X, y, mask)
                    # g rides the weights of _w_time; the pushes-behind twin
                    # is the clock now against the clock at their arrival
                    self._set_staleness(self._w_time)
                    self._record_pushes_behind(self._w_pushes)
                    if fut is not None:
                        self._await_push_pull(fut)
                    # the step's trace context goes along: the comm thread
                    # is another thread, and the op belongs to this step
                    fut = self._comm_pool().submit(self._timed_push_pull, g, dtrace.current())
                    self.timer.stop(int(mask.sum()))
                if fut is not None:
                    self._await_push_pull(fut)
            # runtime introspection (obs.torchrt): this epoch's new step
            # signatures, and the throttled device-bytes gauges
            for probe in self._compile_probes:
                probe.tick()
            torchrt.maybe_sample_device_bytes()
            if (self.rank == 0 and test is not None and cfg.test_interval > 0
                    and (epoch + 1) % cfg.test_interval == 0):
                with trace_phase("eval"):
                    acc, test_ll = self._evaluate(test, dev)
                self.metrics.log(epoch=epoch + 1, accuracy=acc, test_logloss=test_ll,
                                 samples_per_sec=self.timer.samples_per_sec)
                if eval_fn is not None:
                    eval_fn(epoch + 1, acc)
                else:
                    log_eval_line(epoch + 1, acc)
            if (ckpt is not None and cfg.checkpoint_interval > 0
                    and (epoch + 1) % cfg.checkpoint_interval == 0):
                self._checkpoint(ckpt, epoch + 1)
        if (ckpt is not None and cfg.num_iteration > start_epoch
                and ckpt.latest_step() != cfg.num_iteration):
            self._checkpoint(ckpt, cfg.num_iteration)

        with self._timed("pull"):
            self.final_weights = self.kv.pull()
        if save:
            path = os.path.join(cfg.data_dir, "models", part_name(self.rank))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            save_model_text(path, self.final_weights)
        # ps::Finalize(do_barrier=true) parity (src/main.cc:179): a global
        # exit barrier (the startup generation + 1) so no server retires
        # while a peer still trains, then rank 0 reads the push clock and
        # retires the group
        with trace_phase("barrier_wait"):
            self.kv.barrier(self._barrier_base + 1)
        if self.rank == 0:
            self.group_pushes = self.kv.global_pushes()
            self.kv.shutdown_servers()
        return self.final_weights

    def _keyed_round(self, dev, accum: GradientAccumulator | None = None):
        """The keyed round of one batch, ``kround(batch)``: its unique rows
        (``np.unique``), a keyed pull, the gradient, a keyed push of the
        same rows, or with ``accum`` the gradient added at the batch's own
        keys and the span's union of touched rows pushed when it is full.
        Rows wider than one value ride ``vals_per_key`` where the group's
        ranges align, else expanded per-lane keys (the same slots either
        way: the server expands at parse time)."""
        cfg = self.cfg
        row_width = keyed_row_width(cfg)
        vpk = row_width if row_width > 1 and self.kv.supports_vals_per_key(row_width) else 1
        self.vals_per_key = vpk
        if row_width > 1:
            log.info("rank %d keyed wire encoding: %s", self.rank,
                     f"vals_per_key={vpk}" if vpk > 1 else "expanded per-lane keys")
        kgrad = self._keyed_grad_fn(dev, row_width)

        def kround(b):
            with self._timed("prep"):
                ids = b[0]
                ub, pos = np.unique(ids, return_inverse=True)
                keys = (_expand_block_keys(ub, row_width) if row_width > 1 and vpk == 1
                        else ub.astype(np.uint64))
            self.keyed_rows.append(int(keys.size))
            t_pull = time.perf_counter()
            with self._timed("pull"):
                w_u = self.kv.pull(keys, vals_per_key=vpk)
            p0 = None if cfg.sync_mode else self._sample_push_clock()
            g = kgrad(w_u, (pos.reshape(ids.shape), *b[1:]))
            if not cfg.sync_mode:
                self._set_staleness(t_pull)
                self._record_pushes_behind(p0)
            if accum is None:
                with self._timed("push"):
                    self.kv.wait(self.kv.push(g, keys, vals_per_key=vpk))
                return
            if vpk > 1:
                accum.add_rows(keys, g, vpk)
            else:
                accum.add_at(keys, g)
            if accum.ready:
                self._flush_keyed_accum(accum, vpk)
        return kround

    def _comm_pool(self) -> ThreadPoolExecutor:
        if self._comm is None:
            self._comm = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix=f"ps-comm-{self.rank}")
        return self._comm

    def _timed_push_pull(self, g: np.ndarray, ctx=None) -> np.ndarray:
        # the worker's wait for the reply is the trace's push phase; the
        # submitting step's dtrace context is installed on this thread
        with dtrace.use(ctx), self._timed("push_pull", phase=None):
            return self.kv.push_pull(g)

    def _await_push_pull(self, fut) -> None:
        """The pipelined round's reply: the next weights, when they came,
        and the push clock then."""
        with trace_phase("push"):
            self._w_cache = fut.result()
        self._w_time = time.perf_counter()
        self._w_pushes = self._sample_push_clock()

    def report(self) -> dict:
        """Per-worker timing: steps, ``round_ms`` (host clock, a batch
        from its gradient to its push's reply), the mean host ms of each
        KV op and of the gradient, and on the card ``grad_span_ms``, the
        mean over all but the first step of the CUDA events around
        ``model.grad``: the kernel and the host's planning, allocation and
        launch inside the call, which the card waits out
        (``grad_span_first_ms`` is the first step's, with the kernel
        library's load); the codec in force and the bytes of the pushes
        (raw as dense f32, and on the wire), with the accumulation's
        flushes and span when it is on; rank 0 adds its last eval and the
        push clock."""
        span_ms = [s.elapsed_time(e) for s, e in self._grad_events]
        keyed = {}
        if self.keyed_rows:
            # a keyed frame carries a u64 key and vals_per_key f32s a row
            rows = float(np.mean(self.keyed_rows))
            keyed = {"vals_per_key": self.vals_per_key, "keyed_rows_per_round": rows,
                     "wire_bytes_per_round": rows * (8 + 4 * self.vals_per_key)}
        wire = {"compress_active": self.kv.compress_active,
                "push_bytes_raw": self.kv.push_bytes_raw,
                "push_bytes_wire": self.kv.push_bytes_wire,
                "compress_ratio": self.kv.compress_ratio}
        if self.accum is not None:
            wire.update(accum_flushes=self.accum.flushes, accum_k=self.accum.k)
        return {
            "rank": self.rank, "steps": self.timer.steps, **wire, **self.fault_counts(),
            "restarts": self.restarts, "rendezvous_s": self.rendezvous_s,
            "round_ms": 1e3 * self.timer.sec_per_step,
            **{f"{op}_ms": 1e3 * float(np.mean(v)) for op, v in self.op_seconds.items()},
            **{f"{op}_count": len(v) for op, v in self.op_seconds.items()},
            "grad_span_ms": float(np.mean(span_ms[1:])) if len(span_ms) > 1 else None,
            "grad_span_first_ms": span_ms[0] if span_ms else None,
            "group_pushes": self.group_pushes,
            "test_accuracy": self.metrics.latest("accuracy"),
            "test_logloss": self.metrics.latest("test_logloss"),
            **keyed,
        }

    def fault_counts(self) -> dict[str, int]:
        """The client's re-issued ops, rebuilt handles and absorbed pushes,
        summed with those of the instances this one replaced."""
        ours = {"retries": sum(self.kv.retries.values()), "reconnects": self.kv.reconnects,
                "push_outcome_unknown": self.kv.push_outcome_unknown}
        return {k: v + self.prior_faults.get(k, 0) for k, v in ours.items()}

    def close(self, *, wait: bool = True) -> None:
        """Close the client.  The native handle is never freed under a
        live ctypes call: an in-flight push_pull is waited out first.
        ``wait=False`` (the failure path) returns at once and leaves that
        wait, then the close, to a reaper thread, so a restart never
        blocks behind an op to a dead server for ``ps_timeout_ms``."""
        self._drop_push_probe()
        if self._reaper is not None:
            self._reaper.join()  # it closes the client
            return
        comm, self._comm = self._comm, None
        if comm is None:
            self.kv.close()
            return
        if wait:
            comm.shutdown(wait=True)
            self.kv.close()
            return
        comm.shutdown(wait=False, cancel_futures=True)

        def reap():
            comm.shutdown(wait=True)
            self.kv.close()

        self._reaper = threading.Thread(target=reap, daemon=True, name=f"ps-close-{self.rank}")
        self._reaper.start()


def run_ps_workers(cfg: Config, hosts: str, ranks, *, eval_fn=None, save: bool = False,
                   on_error=None, resume: bool = False, max_restarts: int = 0,
                   report: dict | None = None):
    """Run the given worker ranks (threads) against an EXISTING server
    group at ``hosts``; returns ``{rank: final_weights}``.

    Each thread blocks in the native client with the GIL released, so
    async staleness is real.  ``on_error`` runs once for each worker that
    fails for good (local mode tears the servers down with it, so peers
    blocked on the sync barrier fail instead of hanging); the first error
    is raised after every thread ended.  ``report``, when given, receives
    each worker's :meth:`PSWorker.report` by rank.

    ``resume`` continues from ``cfg.checkpoint_dir``, its attempt counter
    bumped once here when rank 0 is local.  ``max_restarts`` (async only):
    a failed worker is rebuilt on a fresh connection and rejoins up to N
    times; a sync worker's failure stays fatal (rounds are counted a
    worker: sync recovery is ``checkpoint_dir`` and ``resume``).
    """
    ranks = list(ranks)
    if resume and 0 in ranks:
        bump_resume_attempt(cfg)
    results: dict[int, np.ndarray | None] = dict.fromkeys(ranks)
    errors: list[BaseException] = []
    workers: list[PSWorker] = []
    device_lock = threading.Lock()  # the workers share one card
    try:
        for r in ranks:
            workers.append(PSWorker(cfg, r, hosts, device_lock=device_lock))

        def fail(e: BaseException) -> None:
            errors.append(e)
            if on_error is not None:
                on_error()

        def run_one(i: int):
            attempts = 0
            while True:
                worker = workers[i]
                try:
                    results[worker.rank] = worker.run(
                        eval_fn=eval_fn if worker.rank == 0 else None, save=save,
                        resume=resume, rejoin=attempts > 0)
                    return
                except Exception as e:  # surfaced to the caller after the join
                    worker.close(wait=False)
                    attempts += 1
                    if cfg.sync_mode or attempts > max_restarts:
                        fail(e)
                        return
                    _RESTARTS.inc()
                    log.warning("worker %d failed (%s); restart %d/%d",
                                worker.rank, e, attempts, max_restarts)
                # a short reconnect window: after a server death a
                # supervisor needs a moment to respawn the rank
                deadline = time.monotonic() + 5.0
                while True:
                    try:
                        workers[i] = PSWorker(cfg, worker.rank, hosts, device_lock=device_lock)
                        break
                    except Exception as e2:
                        if time.monotonic() >= deadline:
                            fail(e2)  # the servers are gone
                            return
                        time.sleep(0.2)
                workers[i].restarts = attempts
                workers[i].prior_faults = worker.fault_counts()

        threads = [threading.Thread(target=run_one, args=(i,), daemon=True,
                                    name=f"ps-worker-{wk.rank}") for i, wk in enumerate(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        for wk in workers:
            wk.close()
    if errors:
        raise errors[0]
    if report is not None:
        report.update({wk.rank: wk.report() for wk in workers})
    return results


def ps_server_group(cfg: Config) -> ServerGroup:
    """The local server group a config trains against (not started):
    ``num_servers`` ranks of its key space, its mode, Q1 quirk, update
    rule, durable store and span journals, behind its fault plan.  The plan is parsed
    here, before any server spawns: a malformed plan fails the launch."""
    via_chaos = None
    if cfg.chaos_plan:
        from distlr_tpu_torch.chaos import load_plan  # noqa: PLC0415

        via_chaos = load_plan(cfg.chaos_plan, seed=cfg.chaos_seed)
    return ServerGroup(cfg.num_servers, cfg.num_workers, ps_param_dim(cfg),
                       learning_rate=cfg.learning_rate, sync=cfg.sync_mode,
                       last_gradient=bool(cfg.sync_last_gradient), via_chaos=via_chaos,
                       optimizer=server_optimizer(cfg), ftrl_alpha=cfg.ftrl_alpha,
                       ftrl_beta=cfg.ftrl_beta, ftrl_l1=cfg.ftrl_l1, ftrl_l2=cfg.ftrl_l2,
                       store_dir=cfg.ps_store_dir, store_interval_s=cfg.ps_store_interval_s,
                       store_wal=cfg.ps_store_wal, store_wal_fsync_s=cfg.ps_store_wal_fsync_s,
                       trace_journal_dir=trace_journal_dir(cfg),
                       prof_journal_dir=prof_journal_dir(cfg), prof_window_s=cfg.prof_window_s)


def prof_journal_dir(cfg: Config) -> str | None:
    """Where locally spawned servers journal their per-handler thread-CPU
    windows: the run dir's ``profiles/``, beside the Python samplers'
    journals, when profiling is armed (``obs_run_dir`` and ``prof_hz``
    above 0); else None."""
    if cfg.obs_run_dir and cfg.prof_hz > 0:
        return os.path.join(cfg.obs_run_dir.split(os.pathsep)[0], "profiles")
    return None


def trace_journal_dir(cfg: Config) -> str | None:
    """Where locally spawned servers journal their handler spans: the run
    dir's ``spans/``, beside the Python ranks' journals, when tracing is
    armed (``obs_run_dir`` and a sample above 0); else None."""
    if cfg.obs_run_dir and cfg.trace_sample > 0:
        return os.path.join(cfg.obs_run_dir.split(os.pathsep)[0], "spans")
    return None


def run_ps_local(cfg: Config, *, eval_fn=None, save: bool = False, resume: bool = False,
                 max_restarts: int = 0, supervise_servers: bool = False,
                 report: dict | None = None):
    """Single-host PS run: ``cfg.num_servers`` native server processes and
    ``cfg.num_workers`` worker threads (the local-mode successor of
    ``examples/local.sh``); returns the workers' final weights in rank
    order.  Multi-host deployments run :func:`run_ps_workers` against a
    group started elsewhere.  ``supervise_servers`` (async only) attaches
    a :class:`~distlr_tpu_torch.ps.ServerSupervisor`; pair it with
    ``max_restarts > 0`` or ``ps_retry_attempts`` so the workers whose
    stream broke carry on.  ``report``, when given, also receives the
    supervisor's ``events`` under ``"supervisor_events"`` (and, for a
    durable group, its ``store_health`` and the store's events under
    ``"store_events"``), and under ``"chaos_events"`` the fault plan's
    events by kind."""
    check_ps_config(cfg)
    group = ps_server_group(cfg)
    with contextlib.ExitStack() as stack:
        stack.enter_context(group)
        fabric = group.chaos  # stop() drops it: keep it for the report
        sup = stack.enter_context(ServerSupervisor(group)) if supervise_servers else None
        results = run_ps_workers(cfg, group.hosts, range(cfg.num_workers), eval_fn=eval_fn,
                                 save=save, on_error=group.stop, resume=resume,
                                 max_restarts=max_restarts, report=report)
    if report is not None and sup is not None:
        report["supervisor_events"] = list(sup.events)
        if group.store_dir:
            report["store_events"] = [e for e in sup.events if e[2] in STORE_EVENTS]
            report["store_health"] = dict(sup.store_health)
    if report is not None and fabric is not None:
        kinds: dict[str, int] = {}
        for e in fabric.events():
            kinds[e[1]] = kinds.get(e[1], 0) + 1
        report["chaos_events"] = kinds
    return [results[r] for r in range(cfg.num_workers)]
