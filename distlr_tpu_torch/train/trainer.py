"""Synchronous trainer on one card — the counterpart of
``distlr_tpu/train/trainer.py``.

Reference control flow (``src/main.cc:124-170`` + ``src/lr.cc:28-45``):
each of W worker processes computes a mean gradient over its shard's
batch, pushes it, and blocks on the server's deferred response — the BSP
barrier; rank 0 evaluates every ``TEST_INTERVAL`` epochs and each worker
text-dumps its weights at the end.  Here the W workers are W contiguous
row blocks of one global batch on one device
(:func:`distlr_tpu_torch.parallel.make_sync_train_step`); with
``batch_size=-1`` each step consumes every worker's full shard, exactly
one reference "iteration".
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading

import numpy as np
import torch

from distlr_tpu_torch.config import Config
from distlr_tpu_torch.data.libsvm import parse_libsvm_file
from distlr_tpu_torch.data.sharding import part_name
from distlr_tpu_torch.models import get_model
from distlr_tpu_torch.parallel import make_eval_step, make_sync_train_step
from distlr_tpu_torch.train.export import save_model_text
from distlr_tpu_torch.train.metrics import MetricsLogger, StepTimer
from distlr_tpu_torch.utils.device import resolve_device
from distlr_tpu_torch.utils.logging import get_logger, log_eval_line

log = get_logger(__name__)


def _take_rows(arr, idx: np.ndarray):
    """``arr[:, idx]`` for a numpy array or a torch tensor."""
    if isinstance(arr, torch.Tensor):
        return arr[:, torch.from_numpy(idx)]
    return arr[:, idx]


def _pad_rows(arr, b: int):
    """Zero-pad axis 1 of ``arr`` (numpy or torch) to length ``b``."""
    extra = (arr.shape[0], b - arr.shape[1]) + tuple(arr.shape[2:])
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr.new_zeros(extra)], dim=1)
    return np.concatenate([arr, np.zeros(extra, dtype=arr.dtype)], axis=1)


class GlobalShardedData:
    """W per-worker shards packed as one global array with lockstep batching
    (copy of the JAX package's class, dense shards only).

    Shards are padded to a common length ``n_pad`` and stacked to
    ``(W, n_pad, ...)``; a global minibatch of per-worker size ``b`` is the
    flattened ``(W*b, ...)`` slice ``[:, k*b:(k+1)*b]`` with a validity
    mask, so worker i's rows are row block i.  The feature leaf is a numpy
    array, or a ``torch.bfloat16`` tensor once the trainer has quantized
    it (numpy has no bfloat16).
    """

    def __init__(self, shards: list[tuple[np.ndarray, ...]]):
        """Each shard is ``(X, y)``; both share the sample (leading) axis."""
        if not shards:
            raise ValueError("need at least one shard")
        self.num_shards = len(shards)
        self.shard_sizes = [len(s[-1]) for s in shards]
        n_pad = max(self.shard_sizes)
        if n_pad == 0:
            raise ValueError("all shards are empty — no training data")
        W = self.num_shards
        n_feat_leaves = len(shards[0]) - 1
        trail = [
            tuple(
                max(s[k].shape[j] for s in shards)
                for j in range(1, shards[0][k].ndim)
            )
            for k in range(n_feat_leaves)
        ]
        self._feats = [
            np.zeros((W, n_pad) + trail[k], dtype=shards[0][k].dtype)
            for k in range(n_feat_leaves)
        ]
        self.y = np.zeros((W, n_pad), dtype=shards[0][-1].dtype)
        self.mask = np.zeros((W, n_pad), dtype=np.float32)
        for i, shard in enumerate(shards):
            n = len(shard[-1])
            for k in range(n_feat_leaves):
                leaf = shard[k]
                sl = (i, slice(0, n)) + tuple(slice(0, d) for d in leaf.shape[1:])
                self._feats[k][sl] = leaf
            self.y[i, :n] = shard[-1]
            self.mask[i, :n] = 1.0
        self.n_pad = n_pad

    @property
    def X(self):
        """The single dense feature matrix."""
        if len(self._feats) != 1:
            raise AttributeError("X is only defined for dense (single-leaf) data")
        return self._feats[0]

    @classmethod
    def from_data_dir(cls, data_dir: str, split: str, num_shards: int, num_features: int):
        """Load ``data_dir/{split}/part-001..`` (reference layout,
        ``src/main.cc:158-159``). If fewer parts exist than shards, parts
        are round-robined; if more, they are concatenated down."""
        parts = [parse_libsvm_file(p, num_features)
                 for p in cls._discover_parts(data_dir, split)]
        return cls._from_parts(parts, num_shards)

    @staticmethod
    def _discover_parts(data_dir: str, split: str) -> list[str]:
        paths = []
        i = 0
        while True:
            p = os.path.join(data_dir, split, part_name(i))
            if not os.path.exists(p):
                break
            paths.append(p)
            i += 1
        if not paths:
            raise FileNotFoundError(f"no shards under {data_dir}/{split}")
        return paths

    @classmethod
    def _from_parts(cls, parts, num_shards: int):
        """Redistribute loaded parts onto ``num_shards`` slots (round-robin
        split when fewer parts, interleaved merge when more)."""
        if len(parts) != num_shards:
            leaves = [np.concatenate([p[k] for p in parts]) for k in range(len(parts[0]))]
            shards = [
                tuple(leaf[i::num_shards] for leaf in leaves) for i in range(num_shards)
            ]
        else:
            shards = parts
        return cls(shards)

    @property
    def num_samples(self) -> int:
        return int(sum(self.shard_sizes))

    def batches(self, per_worker_batch: int, *, wrap: bool = False):
        """One epoch of lockstep global batches ``(X, y, mask)`` shaped
        ``(W*b, ...)``. ``-1`` = full shard per worker (one step/epoch).

        ``wrap=True`` reproduces the reference's Q5 final-batch semantics
        (``include/data_iter.h:44-56``): the short final batch wraps to the
        shard head and re-serves leading samples instead of being
        padded+masked.  Unequal shard sizes reject loudly, since lockstep
        batches cannot wrap every shard at its own offset.
        """
        b = self.n_pad if per_worker_batch == -1 else min(per_worker_batch, self.n_pad)
        if wrap and per_worker_batch != -1 and any(
            sz % per_worker_batch for sz in self.shard_sizes
        ):
            if any(n != self.n_pad for n in self.shard_sizes):
                raise ValueError(
                    "wrap_final_batch (Q5 compat) requires equal-size shards "
                    f"in the sync trainer (got sizes {self.shard_sizes}); "
                    "per-shard wraparound points diverge otherwise — use "
                    "compat_mode='correct'"
                )
            bw, n = per_worker_batch, self.n_pad
            for k in range(-(-n // bw)):
                idx = np.arange(k * bw, (k + 1) * bw) % n
                yield tuple(
                    _take_rows(a, idx).reshape((-1,) + tuple(a.shape[2:]))
                    for a in (*self._feats, self.y, self.mask)
                )
            return

        def _slice(arr, sl, bw):
            out = arr[:, sl]
            if bw < b:  # pad the short final batch to a fixed shape
                out = _pad_rows(out, b)
            return out.reshape((-1,) + tuple(arr.shape[2:]))

        for k in range(-(-self.n_pad // b)):
            sl = slice(k * b, min((k + 1) * b, self.n_pad))
            bw = sl.stop - sl.start
            yield tuple(
                _slice(a, sl, bw) for a in (*self._feats, self.y, self.mask)
            )

    def full_batch(self):
        return tuple(
            a.reshape((-1,) + tuple(a.shape[2:])) for a in (*self._feats, self.y, self.mask)
        )


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def _prefetch(to_device, host_batches, depth: int):
    """Yield ``(host_batch, to_device(host_batch))`` pairs with up to
    ``depth`` batches sliced and copied ahead of the consumer, from a
    background thread (the JAX package's ``_prefetch_to_device``).  The
    host-side slice, the pinning copy and the enqueue of the transfer
    overlap the running step."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()
    errs: list[BaseException] = []

    def produce():
        try:
            for hb in host_batches:
                if stop.is_set():
                    return
                q.put((hb, to_device(hb)))
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            errs.append(e)
        q.put(end)

    t = threading.Thread(target=produce, daemon=True, name="distlr-torch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if errs:
                    raise errs[0]
                return
            yield item
    finally:
        # Consumer may exit early (exception mid-epoch): unblock a
        # producer stuck in q.put so the thread can observe `stop`.
        stop.set()
        with contextlib.suppress(queue.Empty):
            q.get_nowait()


class Trainer:
    """End-to-end sync training: data -> device -> steps -> eval -> export."""

    def __init__(self, cfg: Config, *, metrics: MetricsLogger | None = None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.num_shards = cfg.num_workers
        self.model = get_model(cfg)
        self.metrics = metrics or MetricsLogger()
        self.train_step = make_sync_train_step(self.model, cfg, self.num_shards)
        self.eval_step = make_eval_step(self.model)
        self.timer = StepTimer()
        self.weights: torch.Tensor | None = None
        self._train_data: GlobalShardedData | None = None
        self._test_data: GlobalShardedData | None = None
        # host->device copies run on their own stream, so they overlap steps
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def _quantize_features(self) -> None:
        """Convert loaded dense feature storage to ``cfg.feature_dtype``
        (bfloat16: a ``torch.bfloat16`` tensor, round to nearest even).

        Datasets can be shared across Trainers (``load_data(train=...)``),
        so the conversion is recorded on the object: an already converted
        dataset is kept, and a dtype mismatch fails loudly."""
        fd = self.cfg.feature_dtype
        datasets = [d for d in (self._train_data, self._test_data) if d is not None]
        prev = {d._quant_dtype for d in datasets if getattr(d, "_quant_dtype", None)}
        if prev and prev != {fd}:
            raise ValueError(
                f"dataset was already quantized as {sorted(prev)} by another "
                f"Trainer; this one wants {fd!r}"
            )
        for d in datasets:
            if getattr(d, "_quant_dtype", None) is None:
                d._feats[0] = _as_tensor(d._feats[0]).to(torch.bfloat16)
                d._quant_dtype = fd

    # -- data ---------------------------------------------------------------
    def load_data(self, train: GlobalShardedData | None = None,
                  test: GlobalShardedData | None = None, *, test_only: bool = False):
        """Load the data dir's splits (or take the given datasets).
        ``test_only=True`` skips the train split — eval-only workflows,
        float32 features only."""
        cfg = self.cfg
        if test_only:
            if train is not None:
                raise ValueError("test_only=True contradicts passing train data")
            if cfg.feature_dtype != "float32":
                raise ValueError("test_only loading requires feature_dtype='float32'")
            self._test_data = test or GlobalShardedData.from_data_dir(
                cfg.data_dir, "test", self.num_shards, cfg.num_feature_dim)
            return self
        self._train_data = train or GlobalShardedData.from_data_dir(
            cfg.data_dir, "train", self.num_shards, cfg.num_feature_dim)
        self._test_data = test or GlobalShardedData.from_data_dir(
            cfg.data_dir, "test", self.num_shards, cfg.num_feature_dim)
        if cfg.feature_dtype != "float32":
            self._quantize_features()
        elif any(getattr(d, "_quant_dtype", None)
                 for d in (self._train_data, self._test_data)):
            raise ValueError(
                "dataset was quantized by a previous Trainer; a "
                "feature_dtype='float32' run would train on converted "
                "features — reload the data or match feature_dtype"
            )
        return self

    def _put(self, host_batch) -> tuple[torch.Tensor, ...]:
        """Blocking host->device copy of a batch."""
        return tuple(_as_tensor(a).to(self.device) for a in host_batch)

    def _h2d_async(self, host_batch):
        """Enqueue a batch's copy on the copy stream: ``(tensors, event)``.
        Runs on the prefetch thread; the source is pinned first so the
        copy is a real asynchronous DMA."""
        if self._copy_stream is None:
            return self._put(host_batch), None
        with torch.cuda.stream(self._copy_stream):
            dev = tuple(_as_tensor(a).pin_memory().to(self.device, non_blocking=True)
                        for a in host_batch)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return dev, ready

    def _await(self, item) -> tuple[torch.Tensor, ...]:
        """Make the compute stream wait for a batch's copy; ``record_stream``
        keeps the allocator from reusing its memory while the step still
        reads it."""
        dev, ready = item
        if ready is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(ready)
            for t in dev:
                t.record_stream(compute)
        return dev

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- training -----------------------------------------------------------
    def init_weights(self) -> torch.Tensor:
        self.weights = self.model.init(self.cfg, self.device)
        return self.weights

    def fit(self, *, epochs: int | None = None, eval_fn=None) -> torch.Tensor:
        """Run the training loop; returns the final weights.

        ``eval_fn(epoch, accuracy)`` is called at each test interval
        (default: print the reference-format line)."""
        cfg = self.cfg
        if self._train_data is None:
            self.load_data()
        if self.weights is None:
            self.init_weights()
        epochs = cfg.num_iteration if epochs is None else epochs
        test_batch = None
        if self._test_data is not None:
            test_batch = self._put(self._test_data.full_batch())

        for epoch in range(epochs):
            host_iter = self._train_data.batches(
                cfg.batch_size, wrap=bool(cfg.wrap_final_batch))
            if cfg.prefetch > 1:
                pairs = _prefetch(self._h2d_async, host_iter, cfg.prefetch - 1)
            else:  # prefetch=1: the strictly-serial reference shape
                pairs = ((hb, self._h2d_async(hb)) for hb in host_iter)
            # closing() stops the producer thread deterministically when a
            # step raises
            with contextlib.closing(pairs):
                for host_batch, item in pairs:
                    batch = self._await(item)
                    self.timer.start()
                    self.weights, step_metrics = self.train_step(self.weights, batch)
                    self._sync()
                    self.timer.stop(int(host_batch[-1].sum()))
            if test_batch is not None and cfg.test_interval > 0 and (epoch + 1) % cfg.test_interval == 0:
                em = self.eval_step(self.weights, test_batch)
                acc = float(em["accuracy"])
                self.metrics.log(
                    epoch=epoch + 1,
                    accuracy=acc,
                    test_logloss=float(em["logloss"]),
                    loss=float(step_metrics["loss"]),
                    samples_per_sec=self.timer.samples_per_sec,
                )
                if eval_fn is not None:
                    eval_fn(epoch + 1, acc)
                else:
                    log_eval_line(epoch + 1, acc)
        return self.weights

    def evaluate(self) -> float:
        return self.evaluate_metrics()["accuracy"]

    def evaluate_metrics(self) -> dict:
        """Full-test-set ``{"accuracy", "logloss"}`` as Python floats."""
        em = self.eval_step(self.weights, self._put(self._test_data.full_batch()))
        return {k: float(v) for k, v in em.items()}

    def save_model(self, path: str | None = None) -> str:
        """Text export, reference format & layout: ``models/part-001``
        (single process; the per-worker files of multi-process runs come
        with ROADMAP A.6)."""
        if path is None:
            path = os.path.join(self.cfg.data_dir, "models", part_name(0))
            os.makedirs(os.path.dirname(path), exist_ok=True)
        save_model_text(path, self.weights.detach().cpu().numpy())
        return path
