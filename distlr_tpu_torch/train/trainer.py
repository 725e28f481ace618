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
one reference "iteration".  A mesh with a ``model`` axis cuts the
features into column blocks too (:mod:`distlr_tpu_torch.parallel.
feature_parallel`), and in a ``torch.distributed`` run the data axis
spans the processes: each loads the whole data dir and trains its own
row blocks, as a JAX process does on a global mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import os
import queue
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from distlr_tpu_torch.config import Config
from distlr_tpu_torch.data.hashing import (
    csr_to_padded_coo,
    encode_blocked,
    read_raw_ctr_file,
    resolve_ctr_fields,
)
from distlr_tpu_torch.data.libsvm import parse_libsvm_file
from distlr_tpu_torch.data.sharding import part_name
from distlr_tpu_torch.models import get_model
from distlr_tpu_torch.obs import torchrt
from distlr_tpu_torch.obs.tracing import COPY_STREAM_TID, get_tracer, trace_phase
from distlr_tpu_torch.parallel import make_eval_step, make_sync_train_step
from distlr_tpu_torch.parallel.feature_parallel import column_blocks as column_blocks_of
from distlr_tpu_torch.parallel.feature_parallel import (
    make_feature_sharded_eval_step,
    make_feature_sharded_train_step,
)
from distlr_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh, num_data_shards
from distlr_tpu_torch.train.checkpoint import Checkpointer
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
    (copy of the JAX package's class).

    Shards are padded to a common length ``n_pad`` and stacked to
    ``(W, n_pad, ...)``; a global minibatch of per-worker size ``b`` is the
    flattened ``(W*b, ...)`` slice ``[:, k*b:(k+1)*b]`` with a validity
    mask, so worker i's rows are row block i.  The feature leaf is a numpy
    array (int8 once the trainer has quantized it to int8), or a
    ``torch.bfloat16`` tensor once quantized to bfloat16 (numpy has no
    bfloat16).
    """

    def __init__(self, shards: list[tuple[np.ndarray, ...]]):
        """Each shard is ``(*feature_leaves, y)``: dense ``(X, y)``, padded
        COO ``(cols, vals, y)`` or blocked ``(blocks, lane_vals, y)``; all
        leaves share the sample (leading) axis."""
        if not shards:
            raise ValueError("need at least one shard")
        self.num_shards = len(shards)
        self.shard_sizes = [len(s[-1]) for s in shards]
        n_pad = max(self.shard_sizes)
        if n_pad == 0:
            raise ValueError("all shards are empty — no training data")
        W = self.num_shards
        n_feat_leaves = len(shards[0]) - 1
        # sparse shards may disagree on NNZ_MAX; pad trailing dims to match
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
    def from_data_dir(cls, data_dir: str, split: str, num_shards: int, num_features: int,
                      *, multiclass: bool = False, sparse: bool = False,
                      nnz_max: int | None = None):
        """Load ``data_dir/{split}/part-001..`` (reference layout,
        ``src/main.cc:158-159``). If fewer parts exist than shards, parts
        are round-robined; if more, they are concatenated down.

        ``multiclass`` keeps integer labels verbatim; ``sparse`` keeps rows
        as padded-COO ``(cols, vals)`` leaves, ``nnz_max`` wide, instead of
        densifying them."""
        parts = []
        for p in cls._discover_parts(data_dir, split):
            if sparse:
                (row_ptr, cols, vals), y = parse_libsvm_file(
                    p, num_features, dense=False, multiclass=multiclass)
                parts.append((*csr_to_padded_coo(row_ptr, cols, vals, nnz_max=nnz_max), y))
            else:
                parts.append(parse_libsvm_file(p, num_features, multiclass=multiclass))
        return cls._from_parts(parts, num_shards)

    @classmethod
    def from_raw_ctr_dir(cls, data_dir: str, split: str, num_shards: int, cfg: Config):
        """Load raw-CTR shards (``write_raw_ctr_shards``) as row-blocked
        leaves ``(blocks, lane_vals, y)`` for ``blocked_lr``.  The hash runs
        here, at load time, so train and test share grouping and seed."""
        num_fields = resolve_ctr_fields(data_dir, cfg.ctr_fields)
        num_blocks = cfg.num_feature_dim // cfg.block_size
        parts = []
        for p in cls._discover_parts(data_dir, split):
            raw_ids, y = read_raw_ctr_file(p, num_fields)
            parts.append((*encode_blocked(raw_ids, num_blocks, cfg.block_size,
                                          seed=cfg.hash_seed, num_groups=cfg.block_groups), y))
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

            def _concat(arrs):
                # sparse parts may disagree on their trailing dims (NNZ_MAX)
                trail = tuple(max(a.shape[j] for a in arrs) for j in range(1, arrs[0].ndim))
                return np.concatenate([
                    np.pad(a, [(0, 0)] + [(0, t - s) for t, s in zip(trail, a.shape[1:])])
                    for a in arrs])

            leaves = [_concat([p[k] for p in parts]) for k in range(len(parts[0]))]
            shards = [
                tuple(leaf[i::num_shards] for leaf in leaves) for i in range(num_shards)
            ]
        else:
            shards = parts
        return cls(shards)

    @property
    def num_samples(self) -> int:
        return int(sum(self.shard_sizes))

    def batches(self, per_worker_batch: int, *, wrap: bool = False, column_blocks: int = 1,
                pin_memory: bool = False):
        """One epoch of lockstep global batches ``(X, y, mask)`` shaped
        ``(W*b, ...)``. ``-1`` = full shard per worker (one step/epoch).

        ``wrap=True`` reproduces the reference's Q5 final-batch semantics
        (``include/data_iter.h:44-56``): the short final batch wraps to the
        shard head and re-serves leading samples instead of being
        padded+masked.  Unequal shard sizes reject loudly, since lockstep
        batches cannot wrap every shard at its own offset.

        ``column_blocks=S`` > 1 gives the dense X of each batch in the
        feature-sharded step's layout, (S, W*b, D/S), built in the same one
        host copy as the batch's slice (``pin_memory``: into page-locked
        memory, ready for an asynchronous copy to the card).
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
                    self._leaf(a, _take_rows(a, idx), bw, column_blocks, pin_memory)
                    for a in (*self._feats, self.y, self.mask)
                )
            return

        for k in range(-(-self.n_pad // b)):
            sl = slice(k * b, min((k + 1) * b, self.n_pad))
            yield tuple(
                self._leaf(a, a[:, sl], b, column_blocks, pin_memory)
                for a in (*self._feats, self.y, self.mask)
            )

    def _leaf(self, arr, rows, b: int, column_blocks: int, pin_memory: bool):
        """A batch leaf from ``rows``, the (W, bw, ...) rows of ``arr`` a
        batch takes: flattened to (W*b, ...) with each worker's rows padded
        to ``b`` (the short final batch keeps a fixed shape), or for the
        dense X with column blocks, column-blocked."""
        if column_blocks > 1 and arr is self._feats[0] and len(self._feats) == 1:
            return column_blocks_of(rows, column_blocks, pad_rows=b, pin_memory=pin_memory)
        if rows.shape[1] < b:
            rows = _pad_rows(rows, b)
        return rows.reshape((-1,) + tuple(arr.shape[2:]))

    def full_batch(self, *, column_blocks: int = 1, pin_memory: bool = False):
        return tuple(self._leaf(a, a, self.n_pad, column_blocks, pin_memory)
                     for a in (*self._feats, self.y, self.mask))

    def shards(self, start: int, stop: int) -> GlobalShardedData:
        """The dataset of shards ``start .. stop - 1`` alone (views of this
        one's arrays, with its quantization record): a process's own row
        blocks of a global data axis."""
        part = object.__new__(type(self))
        part.__dict__.update(self.__dict__)
        part._feats = [f[start:stop] for f in self._feats]
        part.y, part.mask = self.y[start:stop], self.mask[start:stop]
        part.num_shards = stop - start
        part.shard_sizes = self.shard_sizes[start:stop]
        return part


def _process_group():
    """The default ``torch.distributed`` group when this process is in one
    (``launch sync --coordinator``), else None."""
    import torch.distributed as dist  # noqa: PLC0415

    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


#: bytes of f32 features converted at a time when quantizing: the
#: elementwise arithmetic gives the same bytes in any cut, and a (2048, 1M)
#: matrix needs no full-size f32 temporaries
_QUANT_CHUNK_BYTES = 1 << 26


def _row_blocks(X: np.ndarray):
    """``(start, stop)`` of blocks of X's rows (all axes but the last)
    holding about ``_QUANT_CHUNK_BYTES`` of X each."""
    n, d = X.size // X.shape[-1], X.shape[-1]
    step = max(1, _QUANT_CHUNK_BYTES // max(1, d * X.itemsize))
    for i in range(0, n, step):
        yield i, min(i + step, n)


def _int8_scale(X: np.ndarray) -> float:
    """``max|X| / 127`` (1.0 for an all-zero X): the JAX trainer's scale."""
    rows = X.reshape(-1, X.shape[-1])
    max_abs = max((float(np.abs(rows[a:b]).max()) for a, b in _row_blocks(X)), default=0.0)
    scale = max_abs / 127.0
    return 1.0 if scale == 0.0 else scale


def _quantize_int8(X: np.ndarray, scale: float) -> np.ndarray:
    """``clip(rint(X / scale), -127, 127)`` as int8, the JAX trainer's
    numpy arithmetic, a block of rows at a time."""
    q = np.empty(X.shape, dtype=np.int8)
    rows, q_rows = X.reshape(-1, X.shape[-1]), q.reshape(-1, X.shape[-1])
    for a, b in _row_blocks(X):
        q_rows[a:b] = np.clip(np.rint(rows[a:b] / scale), -127, 127).astype(np.int8)
    return q


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


class _Copy(NamedTuple):
    """A batch's copy on the copy stream: a timing event recorded before
    it where the stream was still busy with an earlier copy (else None),
    one after it (the batch is ready), the host time its first leaf's
    enqueue returned, the bytes it moves, and the device clock anchored
    before it was enqueued, which puts the events on the host's clock."""

    start: torch.cuda.Event | None
    ready: torch.cuda.Event
    enqueued: float
    nbytes: int
    clock: torchrt.DeviceClock


#: seconds between anchors of the device clock during a fit: the card's
#: clock drifts from the host's by some µs a second
_CLOCK_ANCHOR_S = 1.0


class Trainer:
    """End-to-end sync training: data -> device -> steps -> eval -> export."""

    def __init__(self, cfg: Config, *, metrics: MetricsLogger | None = None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        # num_workers > 1 is the data-axis size; otherwise one row block a
        # process.  The data axis spans every process of a torch.distributed run
        shape = cfg.mesh_shape
        if shape is None and cfg.num_workers > 1:
            shape = {"data": cfg.num_workers}
        self.mesh = make_mesh(shape, group=_process_group())
        self.num_shards = num_data_shards(self.mesh)
        # a 'model' axis selects the 2D data x feature-sharded path
        self.feature_sharded = MODEL_AXIS in self.mesh.axis_names
        if self.feature_sharded and cfg.model in ("sparse_lr", "sparse_softmax", "blocked_lr"):
            # w[cols] / t[blocks] gathers arbitrary buckets: a column-blocked
            # table would split every gather across blocks
            raise NotImplementedError(
                f"{cfg.model} supports data-parallel meshes only (no 'model' axis)")
        self.model = get_model(cfg)
        self.metrics = metrics or MetricsLogger()
        self._build_steps()
        self.timer = StepTimer()
        self.weights: torch.Tensor | None = None
        self._train_data: GlobalShardedData | None = None
        self._test_data: GlobalShardedData | None = None
        # host->device copies run on their own stream, so they overlap steps
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # the copy stream's timing events on the host's clock, anchored
        # at each fit
        self._clock: torchrt.DeviceClock | None = None

    def _build_steps(self) -> None:
        if self.feature_sharded:
            self.train_step = make_feature_sharded_train_step(self.model, self.cfg, self.mesh)
            self.eval_step = make_feature_sharded_eval_step(self.model, self.mesh)
        else:
            self.train_step = make_sync_train_step(self.model, self.cfg, self.mesh)
            self.eval_step = make_eval_step(self.model, self.mesh)
        # runtime introspection (obs.torchrt): the signatures each step
        # runs at, ticked per epoch in fit() — a re-build (load-time
        # quantization) starts them afresh, as a re-jit does in JAX
        self._step_sigs = torchrt.SignatureCache()
        self._eval_sigs = torchrt.SignatureCache()
        self._compile_probes = [torchrt.CompileProbe(self._step_sigs, "train.sync.step"),
                                torchrt.CompileProbe(self._eval_sigs, "train.sync.eval")]

    def _eval(self, batch) -> dict:
        self._eval_sigs.note(self.weights, batch)
        return self.eval_step(self.weights, batch)

    @property
    def _column_blocks(self) -> int:
        return self.mesh.shape[MODEL_AXIS] if self.feature_sharded else 1

    def _quantize_features(self) -> None:
        """Convert loaded dense feature storage to ``cfg.feature_dtype``:
        bfloat16, a ``torch.bfloat16`` tensor (round to nearest even); int8
        and int8_dot, symmetric per-dataset quantization with one scale from
        the train split's max |x| (the test split reuses it, clipped),
        folded into the model as ``feature_scale``.

        Datasets can be shared across Trainers (``load_data(train=...)``),
        so the conversion is recorded on the object: an already converted
        dataset keeps its stored scale (re-quantizing ints would compute
        scale 1), a fresh one is quantized with that scale, and a dtype
        mismatch fails loudly."""
        fd = self.cfg.feature_dtype
        datasets = [d for d in (self._train_data, self._test_data) if d is not None]
        prev = {d._quant_dtype for d in datasets if getattr(d, "_quant_dtype", None)}
        if prev and prev != {fd}:
            raise ValueError(
                f"dataset was already quantized as {sorted(prev)} by another "
                f"Trainer; this one wants {fd!r}"
            )
        fresh = [d for d in datasets if getattr(d, "_quant_dtype", None) is None]
        if fd == "bfloat16":
            for d in fresh:
                d._feats[0] = _as_tensor(d._feats[0]).to(torch.bfloat16)
                d._quant_dtype, d._quant_scale = fd, 1.0
            return
        prev_scales = {d._quant_scale for d in datasets if getattr(d, "_quant_dtype", None)}
        if len(prev_scales) > 1:
            raise ValueError(
                f"shared datasets carry inconsistent quantization scales {prev_scales}")
        scale = prev_scales.pop() if prev_scales else _int8_scale(self._train_data._feats[0])
        for d in fresh:
            d._feats[0] = _quantize_int8(d._feats[0], scale)
            d._quant_dtype, d._quant_scale = fd, scale
        self.model = dataclasses.replace(self.model, feature_scale=scale)
        self._build_steps()

    # -- data ---------------------------------------------------------------
    def load_data(self, train: GlobalShardedData | None = None,
                  test: GlobalShardedData | None = None, *, test_only: bool = False):
        """Load the data dir's splits (or take the given datasets) in the
        layout the model family reads: dense ``X`` (``binary_lr``,
        ``softmax``), padded COO (``sparse_*``) or raw-CTR shards hashed to
        row blocks (``blocked_lr``).  ``test_only=True`` skips the train
        split — eval-only workflows, float32 features only (a quantized
        dtype's scale comes from the train split)."""
        cfg = self.cfg
        if test_only:
            if train is not None:
                raise ValueError("test_only=True contradicts passing train data")
            if cfg.feature_dtype != "float32":
                raise ValueError(
                    "test_only loading requires feature_dtype='float32' "
                    "(quantization scales come from the train split)")
        if cfg.model == "blocked_lr":
            def load(split):
                return GlobalShardedData.from_raw_ctr_dir(cfg.data_dir, split,
                                                          self.num_shards, cfg)
        else:
            def load(split):
                return GlobalShardedData.from_data_dir(
                    cfg.data_dir, split, self.num_shards, cfg.num_feature_dim,
                    multiclass=cfg.model in ("softmax", "sparse_softmax"),
                    sparse=cfg.model in ("sparse_lr", "sparse_softmax"),
                    nnz_max=cfg.nnz_max)
        self._test_data = test or load("test")
        if test_only:
            self._test_data = self._own_shards(self._test_data)
            return self
        self._train_data = train or load("train")
        # feature_dtype is float32 for the sparse families (Config)
        if cfg.feature_dtype != "float32":
            self._quantize_features()
        elif any(getattr(d, "_quant_dtype", None)
                 for d in (self._train_data, self._test_data)):
            raise ValueError(
                "dataset was quantized by a previous Trainer; a "
                "feature_dtype='float32' run would train on converted "
                "features — reload the data or match feature_dtype"
            )
        # after quantizing: the scale is the whole train split's
        self._train_data = self._own_shards(self._train_data)
        self._test_data = self._own_shards(self._test_data)
        return self

    def _own_shards(self, data: GlobalShardedData) -> GlobalShardedData:
        """This process's row blocks of a dataset of the global data axis."""
        if self.mesh.num_processes == 1:
            return data
        if data.num_shards != self.num_shards:
            raise ValueError(f"a dataset of {data.num_shards} shards on a data axis of "
                             f"{self.num_shards} blocks across processes")
        first = self.mesh.first_data_shard
        return data.shards(first, first + self.mesh.local_data_shards)

    def _put(self, host_batch) -> tuple[torch.Tensor, ...]:
        """Blocking host->device copy of a batch."""
        return tuple(_as_tensor(a).to(self.device) for a in host_batch)

    def _h2d_async(self, host_batch, tag: dict | None = None):
        """Enqueue a batch's copy on the copy stream: ``(tensors, copy)``,
        with ``copy`` a :class:`_Copy` (None off CUDA, where the copy is
        blocking).  Runs on the prefetch thread; the leaves are pinned
        first (span ``pin``, ``tag`` its attributes), so the copy is a real
        asynchronous DMA."""
        if self._copy_stream is None:
            return self._put(host_batch), None
        src = [_as_tensor(a) for a in host_batch]
        with trace_phase("pin", args=tag) as pin:
            pinned = [t.pin_memory() for t in src]
            # a column-blocked batch is built pinned: pin_memory() returns it
            pin.nbytes = sum(p.nbytes for p, t in zip(pinned, src)
                             if p.data_ptr() != t.data_ptr())
        clock = self._clock
        ready = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._copy_stream):
            dev = tuple(torch.empty_like(t, device=self.device) for t in pinned)
            # on an idle stream the copy starts as its enqueue returns;
            # behind an earlier copy, when the start event fires
            start = None
            if not self._copy_stream.query():
                start = torch.cuda.Event(enable_timing=True)
                start.record(self._copy_stream)
            dev[0].copy_(pinned[0], non_blocking=True)
            enqueued = time.perf_counter()
            for d, t in zip(dev[1:], pinned[1:]):
                d.copy_(t, non_blocking=True)
            ready.record(self._copy_stream)
        return dev, _Copy(start, ready, enqueued, sum(t.nbytes for t in pinned), clock)

    def _await(self, item) -> tuple[torch.Tensor, ...]:
        """Make the compute stream wait for a batch's copy; ``record_stream``
        keeps the allocator from reusing its memory while the step still
        reads it."""
        dev, copy = item
        if copy is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(copy.ready)
            for t in dev:
                t.record_stream(compute)
        return dev

    def _trace_copy(self, copy: _Copy | None, compute, tag: dict) -> None:
        """Record a batch's copy as ``h2d_copy`` on the card's clock, and
        as ``copy_wait`` the part of its step's ``compute`` span before the
        copy ended.  Its events have completed: the step has synced.  The
        device clock is anchored anew here once a second, the current
        stream idle."""
        if copy is None:
            return
        if compute.t1 - self._clock.t_anchor > _CLOCK_ANCHOR_S:
            self._clock = torchrt.DeviceClock.take(self.device)
        tracer = get_tracer()
        end = copy.clock.host_time(copy.ready)
        start = copy.enqueued
        if copy.start is not None:  # the earlier copy may have ended first
            start = max(start, copy.clock.host_time(copy.start))
        start = min(start, end)
        tracer.record("h2d_copy", start, end, nbytes=copy.nbytes, args=tag,
                      tid=COPY_STREAM_TID)
        waited = min(end, compute.t1)
        if waited > compute.t0:
            tracer.record("copy_wait", compute.t0, waited, args=tag)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _barrier(self) -> None:
        """Every process of the data axis reaches this point (one small
        ``all_reduce`` on the trainer's device, so NCCL and gloo alike)."""
        if self.mesh.group is not None:
            import torch.distributed as dist  # noqa: PLC0415

            dist.all_reduce(torch.zeros(1, device=self.device), group=self.mesh.group)

    def _save_checkpoint(self, ckpt: Checkpointer, epoch: int, *, unless_saved=False) -> None:
        """Rank 0 writes the checkpoint once every process has got here, so
        no process still reads a step that pruning would remove; with
        ``unless_saved``, only if the directory's latest step is not
        ``epoch`` already."""
        self._barrier()
        if self.mesh.process_index == 0 and not (unless_saved and ckpt.latest_step() == epoch):
            ckpt.save(epoch, self.weights, extra={"epoch": epoch})

    # -- training -----------------------------------------------------------
    def init_weights(self) -> torch.Tensor:
        self.weights = self.model.init(self.cfg, self.device)
        return self.weights

    def fit(self, *, epochs: int | None = None, eval_fn=None,
            resume: bool = False) -> torch.Tensor:
        """Run the training loop; returns the final weights.

        ``eval_fn(epoch, accuracy)`` is called at each test interval
        (default: print the reference-format line).  With a
        ``checkpoint_dir``, the weights and the epoch are saved every
        ``checkpoint_interval`` epochs and after the last one; with
        ``resume=True`` training restarts from the latest saved epoch."""
        cfg = self.cfg
        if self._train_data is None:
            self.load_data()
        ckpt = None
        start_epoch = 0
        if cfg.checkpoint_dir:
            ckpt = Checkpointer(cfg.checkpoint_dir)
            state = ckpt.restore() if resume else None
            if state is not None:
                w = np.asarray(state["weights"], dtype=np.float32).reshape(self.model.param_shape)
                self.weights = torch.from_numpy(w).to(self.device)
                start_epoch = int(state["epoch"])
                log.info("resumed from checkpoint at epoch %d", start_epoch)
        if self.weights is None:
            self.init_weights()
        epochs = cfg.num_iteration if epochs is None else epochs
        if self._copy_stream is not None:
            self._clock = torchrt.DeviceClock.take(self.device)
        # torch.profiler around the epochs (cfg.profile_dir), exported
        # also when a step raises
        with torchrt.profiled(cfg.profile_dir, self.device, "fit"):
            self._run_epochs(start_epoch, epochs, eval_fn, ckpt)
            if ckpt is not None and epochs > start_epoch:
                with trace_phase("checkpoint"):
                    self._save_checkpoint(ckpt, epochs, unless_saved=True)
        return self.weights

    def _h2d_traced(self, epoch: int, indexed):
        """``_h2d_async`` of the batch ``indexed`` = ``(k, host batch)``
        of ``epoch``, in a span ``h2d``: the pin (span ``pin``) and the
        enqueue of the copy, host time only."""
        k, host_batch = indexed
        tag = {"epoch": epoch, "batch": k}
        with trace_phase("h2d", args=tag):
            return self._h2d_async(host_batch, tag)

    def _run_epochs(self, start_epoch: int, epochs: int, eval_fn, ckpt) -> None:
        """The epochs, under the JAX trainer's phase spans and the port's
        own (``obs.tracing.PORT_ONLY_PHASES``); each span of a batch
        carries ``{"epoch", "batch"}``.

        * ``test_h2d``: the test batch's blocking copy to the device.
        * ``h2d``, on the prefetch thread when ``prefetch > 1``: the
          batch's ``pin`` into page-locked memory and the enqueue of its
          copy, host time only.  The copy itself is ``h2d_copy``, timed on
          the copy stream and put on the host's clock once its step has
          synced.
        * ``data_load``: this thread's wait for the next batch; for an
          epoch's first batch also ``epoch_fill``, with the same extent.
        * ``compute``: the step's launches and the wait for the card,
          which first waits for the batch's copy (``copy_wait``, the span's
          part before the copy ended) and then runs the step.
        * ``eval``: the forward and the read-back of its metrics (device
          time), and ``checkpoint``.

        The step timer runs from the wait for a batch to the step's end,
        so its rate counts the data wait."""
        cfg = self.cfg
        test_batch = None
        if self._test_data is not None:
            with trace_phase("test_h2d"):
                test_batch = self._test_batch()

        for epoch in range(start_epoch, epochs):
            host_iter = enumerate(self._train_data.batches(
                cfg.batch_size, wrap=bool(cfg.wrap_final_batch),
                column_blocks=self._column_blocks, pin_memory=self._copy_stream is not None))
            to_device = functools.partial(self._h2d_traced, epoch)
            if cfg.prefetch > 1:
                pairs = _prefetch(to_device, host_iter, cfg.prefetch - 1)
            else:  # prefetch=1: the strictly-serial reference shape
                pairs = ((kb, to_device(kb)) for kb in host_iter)
            # closing() stops the producer thread deterministically when a
            # step raises
            with contextlib.closing(pairs):
                it = iter(pairs)
                for k in itertools.count():
                    tag = {"epoch": epoch, "batch": k}
                    self.timer.start()
                    with trace_phase("data_load", args=tag) as wait:
                        pair = next(it, None)
                    if k == 0:
                        get_tracer().record("epoch_fill", wait.t0, wait.t1, args=tag)
                    if pair is None:
                        break
                    (_, host_batch), item = pair
                    batch = self._await(item)
                    with trace_phase("compute", args=tag) as compute:
                        self._step_sigs.note(self.weights, batch)
                        self.weights, step_metrics = self.train_step(self.weights, batch)
                        self._sync()
                    self._trace_copy(item[1], compute, tag)
                    self.timer.stop(int(host_batch[-1].sum()))
            if test_batch is not None and cfg.test_interval > 0 and (epoch + 1) % cfg.test_interval == 0:
                with trace_phase("eval"):
                    em = self._eval(test_batch)
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
            if ckpt is not None and cfg.checkpoint_interval > 0 and (
                    epoch + 1) % cfg.checkpoint_interval == 0:
                with trace_phase("checkpoint"):
                    self._save_checkpoint(ckpt, epoch + 1)
            # runtime introspection (obs.torchrt): epoch-end signature
            # deltas and the throttled device-bytes gauges
            for probe in self._compile_probes:
                probe.tick()
            torchrt.maybe_sample_device_bytes()

    def evaluate(self) -> float:
        return self.evaluate_metrics()["accuracy"]

    def evaluate_metrics(self) -> dict:
        """Full-test-set ``{"accuracy", "logloss"}`` as Python floats."""
        with trace_phase("eval"):
            em = self._eval(self._test_batch())
            return {k: float(v) for k, v in em.items()}

    def _test_batch(self) -> tuple[torch.Tensor, ...]:
        return self._put(self._test_data.full_batch(column_blocks=self._column_blocks))

    def save_model(self, path: str | None = None) -> str:
        """Text export, reference format & layout: ``models/part-00{i+1}``
        with i this process's rank (0 in a single process) — the
        reference's per-worker model files (Q8, ``src/main.cc:168-169``).
        In a ``torch.distributed`` run every process exports the same
        weights to its own file."""
        if path is None:
            path = os.path.join(self.cfg.data_dir, "models", part_name(self.mesh.process_index))
            os.makedirs(os.path.dirname(path), exist_ok=True)
        save_model_text(path, self.weights.detach().cpu().numpy())
        return path
