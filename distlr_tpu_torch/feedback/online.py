"""Continuous (online) trainer: train on what is served (the port's copy
of ``distlr_tpu/feedback/online.py``).

A long-running Hogwild worker consumes the joined training shards of
:mod:`distlr_tpu_torch.feedback.join` as they appear and pushes
gradients into the same live PS group the serving engines hot-reload
from (``launch serve --ps-hosts``).  It has no epochs and no exit
barrier: it never votes in a barrier, never retires the group, and is
one more async client beside the serving pulls.

Gradients accumulate locally in the shared
:class:`~distlr_tpu_torch.compress.GradientAccumulator` and are pushed as
a mean every ``k`` batches, ``k`` growing by ``accum_growth`` every
``accum_growth_every`` pushes up to ``accum_max`` (AdaBatch); the pushes
take the negotiated wire codec of ``cfg.ps_compress``.  The gradients are
the host numpy ones of the JAX package (the port's copies in
:mod:`distlr_tpu_torch.train.ps_trainer`): this trainer touches no
device.

Any number of online trainers may share one shard dir.  A trainer takes
a shard by renaming it to ``<shard>.claim`` (one rename wins), consumes
it, then renames it to ``<shard>.done``; a ``.claim`` older than
``claim_stale_s`` (its mtime is the claim time) is renamed back for
another worker.  ``claim_stale_s`` must exceed the worst consume time of
one shard.

It needs an async server group: a lone push into a sync (BSP) group
would wait forever in the barrier.  The JAX trainer's registry series
(shards consumed, examples, pushes, shard lag, the span ``k``) are the
attributes here until ROADMAP A.12.  Its client retries transport
faults by ``RetryPolicy.from_config(cfg)``, and with a membership
``route`` (``launch online --ps-ctl``) follows a live resize: a reshard
costs the trainer one re-route, never a restart.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from distlr_tpu_torch.config import Config
from distlr_tpu_torch.feedback import clock
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: models the online loop supports: dense full-vector pushes (binary_lr,
#: softmax), keyed sparse pushes (sparse_lr) and keyed per-class rows
#: (sparse_softmax: each feature key owns its num_classes lanes, pushed
#: vals_per_key=K where the group's range boundaries align, as expanded
#: per-lane keys otherwise)
_SUPPORTED = ("binary_lr", "softmax", "sparse_lr", "sparse_softmax")


class OnlineTrainer:
    """Shard-watching Hogwild worker over a live async PS group."""

    #: client id: clear of the batch trainers' ranks (0..) and of the
    #: serving pull client (4095)
    ONLINE_CLIENT_ID = 0x0E00

    def __init__(self, cfg: Config, hosts: str | None, shard_dir: str, *,
                 accum_start: int = 1, accum_growth: float = 2.0,
                 accum_growth_every: int = 32, accum_max: int = 64,
                 poll_interval_s: float = 0.5, idle_flush_s: float = 2.0,
                 client_id: int | None = None, seed_init: bool = True,
                 worker_id: int = 0, claim_stale_s: float = 300.0,
                 ns_base: int = 0, ns_total_dim: int | None = None,
                 route=None):
        if cfg.model == "blocked_lr":
            # feedback shards hold hashed libsvm rows; the grouped row
            # layout of blocked_lr is derivable only from raw categorical
            # shards at ingest
            raise ValueError(
                "online training does not support blocked_lr: feedback "
                "shards are hashed libsvm rows, but blocked_lr's grouped "
                "row layout is only derivable from RAW categorical "
                "shards at ingest time — train blocked models with "
                "`launch ps` on raw-CTR data instead")
        if cfg.model not in _SUPPORTED:
            raise ValueError(
                f"online training supports {_SUPPORTED}, got {cfg.model!r}")
        if worker_id < 0:
            raise ValueError(f"worker_id must be >= 0, got {worker_id}")
        from distlr_tpu_torch.compress import GradientAccumulator  # noqa: PLC0415
        from distlr_tpu_torch.ps import KVWorker, RetryPolicy  # noqa: PLC0415
        from distlr_tpu_torch.train.ps_trainer import ps_param_dim  # noqa: PLC0415

        self.cfg = cfg
        self.shard_dir = shard_dir
        self.dim = ps_param_dim(cfg)
        self.poll_interval_s = float(poll_interval_s)
        self.idle_flush_s = float(idle_flush_s)
        self.worker_id = int(worker_id)
        self.claim_stale_s = float(claim_stale_s)
        # several model namespaces in one group: train only the slice
        # [ns_base, ns_base + dim)
        wire_dim = int(ns_total_dim) if ns_total_dim else self.dim
        worker = KVWorker(
            hosts, wire_dim,
            client_id=self.ONLINE_CLIENT_ID + worker_id if client_id is None else client_id,
            timeout_ms=cfg.ps_timeout_ms,
            sync_group=False,  # Hogwild client: no barriers, keyed shortcut
            retry=RetryPolicy.from_config(cfg),
            compress=cfg.ps_compress,
            route=route)
        self.kv = (worker if wire_dim == self.dim and not ns_base
                   else worker.namespace(int(ns_base), self.dim))
        if seed_init:
            # idempotent: zeros (FTRL's origin) into an unseeded group, a
            # no-op against live weights
            self.kv.push_init(np.zeros(self.dim, np.float32))
        self._accum = GradientAccumulator(
            self.dim, start=accum_start, growth=accum_growth,
            growth_every=accum_growth_every, max_k=accum_max)
        self._w_cache: np.ndarray | None = None
        self.shards_consumed = 0
        self.examples = 0
        self.pushes = 0
        #: unclaimed shards at the last scan (the loop's freshness debt)
        self.lag = 0
        #: seconds spent parsing shards, in the gradients, and consuming
        #: shards in all (pulls and pushes included)
        self.parse_s = 0.0
        self.grad_s = 0.0
        self.consume_s = 0.0
        self._num_classes = (cfg.num_classes
                             if cfg.model in ("softmax", "sparse_softmax") else None)
        # sparse_softmax keyed rows: one key owns K class lanes, as
        # vals_per_key rows where the boundaries align, else expanded keys
        self._row_vpk = 1
        if cfg.model == "sparse_softmax" and self.kv.supports_vals_per_key(cfg.num_classes):
            self._row_vpk = cfg.num_classes

    @property
    def accum_k(self) -> int:
        """Current AdaBatch span (batches a push)."""
        return self._accum.k

    # -- gradient plumbing -------------------------------------------------
    def _dense_batch(self, X, y) -> None:
        from distlr_tpu_torch.train.ps_trainer import _np_dense_grad  # noqa: PLC0415

        cfg = self.cfg
        if self._accum.batches == 0:
            # one pull a span: the span's batches share the weights
            self._w_cache = self.kv.pull()
        K = self._num_classes
        w = self._w_cache.reshape(cfg.num_feature_dim, K) if K else self._w_cache
        mask = np.ones(len(y), np.float32)
        t0 = time.perf_counter()
        g = _np_dense_grad(w, X, y, mask, cfg.l2_c, bool(cfg.l2_scale_by_batch), K)
        self.grad_s += time.perf_counter() - t0
        self._accum.add(g)
        self.examples += len(y)

    def _sparse_batch(self, pc, pv, y) -> None:
        from distlr_tpu_torch.train.ps_trainer import _sparse_batch_grad  # noqa: PLC0415

        cfg = self.cfg
        ub, pos = np.unique(pc, return_inverse=True)
        w_u = self.kv.pull(keys=ub.astype(np.uint64))
        mask = np.ones(len(y), np.float32)
        t0 = time.perf_counter()
        g_u = _sparse_batch_grad(w_u, pos.reshape(pc.shape), pv, y, mask,
                                 cfg.l2_c, bool(cfg.l2_scale_by_batch))
        self.grad_s += time.perf_counter() - t0
        self._accum.add_at(ub, g_u)
        self.examples += len(y)

    def _sparse_softmax_batch(self, pc, pv, y) -> None:
        """Keyed rows a class: each unique feature key owns its K lanes of
        the row-major (D, K) table."""
        from distlr_tpu_torch.train.ps_trainer import (  # noqa: PLC0415
            _expand_block_keys,
            _sparse_softmax_batch_grad,
        )

        cfg = self.cfg
        K = cfg.num_classes
        ub, pos = np.unique(pc, return_inverse=True)
        rows = ub.astype(np.uint64)
        if self._row_vpk > 1:
            w_u = self.kv.pull(keys=rows, vals_per_key=K)
        else:
            w_u = self.kv.pull(keys=_expand_block_keys(rows, K))
        mask = np.ones(len(y), np.float32)
        t0 = time.perf_counter()
        g_u = _sparse_softmax_batch_grad(w_u.reshape(-1, K), pos.reshape(pc.shape), pv, y,
                                         mask, cfg.l2_c, bool(cfg.l2_scale_by_batch))
        self.grad_s += time.perf_counter() - t0
        self._accum.add_rows(ub, g_u.reshape(-1), K)
        self.examples += len(y)

    def _flush_push(self) -> None:
        """Push the accumulated mean gradient (one Hogwild update); the
        accumulator advances its schedule a flush."""
        cfg = self.cfg
        if cfg.model == "sparse_lr":
            res = self._accum.flush_keyed()
            if res is None:
                return
            keys, vals = res
            if keys.size:
                self.kv.wait(self.kv.push(vals, keys=keys))
        elif cfg.model == "sparse_softmax":
            res = self._accum.flush_keyed(vpk=cfg.num_classes)
            if res is None:
                return
            rows, vals = res
            if rows.size:
                if self._row_vpk > 1:
                    self.kv.wait(self.kv.push(vals, keys=rows,
                                              vals_per_key=cfg.num_classes))
                else:
                    from distlr_tpu_torch.train.ps_trainer import (  # noqa: PLC0415
                        _expand_block_keys,
                    )

                    self.kv.wait(self.kv.push(
                        vals, keys=_expand_block_keys(rows, cfg.num_classes)))
        else:
            g = self._accum.flush_dense()
            if g is None:
                return
            self.kv.wait(self.kv.push(g))
        self._w_cache = None
        self.pushes += 1

    # -- shard consumption -------------------------------------------------
    def _scan(self) -> list[str]:
        # ".libsvm.claim" / ".libsvm.done" fail the suffix test: only
        # unclaimed work is seen
        try:
            names = sorted(os.listdir(self.shard_dir))
        except OSError:
            return []
        return [os.path.join(self.shard_dir, n) for n in names
                if n.startswith("shard-") and n.endswith(".libsvm")]

    def _claim(self, path: str) -> str | None:
        """Take a shard with the ``.claim`` rename (one of N workers wins;
        the others get ENOENT and move on).  The mtime is refreshed before
        the rename, so a claim is never born looking stale."""
        claim = path + ".claim"
        try:
            os.utime(path)
        except OSError:
            return None  # a peer claimed or consumed it
        try:
            os.rename(path, claim)
        except OSError:
            return None  # a peer won the race
        return claim

    def _reclaim_stale(self) -> None:
        """Return orphaned claims to the pool: after ``claim_stale_s``
        (from claim time) any worker renames a ``.claim`` back."""
        if self.claim_stale_s <= 0:
            return
        try:
            names = os.listdir(self.shard_dir)
        except OSError:
            return
        now = clock.wall()
        for nm in names:
            if not nm.endswith(".libsvm.claim"):
                continue
            p = os.path.join(self.shard_dir, nm)
            try:
                if now - os.path.getmtime(p) < self.claim_stale_s:
                    continue
                os.rename(p, p[:-len(".claim")])
            except OSError:
                continue  # a peer reclaimed it, or its owner just finished
            log.warning("online[%d]: reclaimed stale claim %s (owner "
                        "presumed dead)", self.worker_id, nm)

    @staticmethod
    def _sidecar_path(path: str) -> str:
        """Trace sidecar of a shard, beside the shard's original name."""
        if path.endswith(".claim"):
            path = path[:-len(".claim")]
        return path + ".trace"

    def consume_shard(self, path: str) -> int:
        """Train over one joined shard; returns the examples consumed."""
        from distlr_tpu_torch.data.hashing import csr_to_padded_coo  # noqa: PLC0415
        from distlr_tpu_torch.data.libsvm import parse_libsvm_lines  # noqa: PLC0415

        t_start = time.perf_counter()
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        if not lines:
            return 0
        cfg = self.cfg
        B = cfg.batch_size if cfg.batch_size > 0 else 256
        n = 0
        t0 = time.perf_counter()
        if cfg.model in ("sparse_lr", "sparse_softmax"):
            (row_ptr, cols, vals), y = parse_libsvm_lines(
                lines, cfg.num_feature_dim, dense=False,
                multiclass=cfg.model == "sparse_softmax")
            pc, pv = csr_to_padded_coo(row_ptr, cols, vals, nnz_max=cfg.nnz_max)
            self.parse_s += time.perf_counter() - t0
            batch_fn = (self._sparse_softmax_batch if cfg.model == "sparse_softmax"
                        else self._sparse_batch)
            for lo in range(0, len(y), B):
                batch_fn(pc[lo:lo + B], pv[lo:lo + B], y[lo:lo + B])
                if self._accum.ready:
                    self._flush_push()
                n += len(y[lo:lo + B])
        else:
            X, y = parse_libsvm_lines(lines, cfg.num_feature_dim, dense=True,
                                      multiclass=self._num_classes is not None)
            self.parse_s += time.perf_counter() - t0
            for lo in range(0, len(y), B):
                self._dense_batch(X[lo:lo + B], y[lo:lo + B])
                if self._accum.ready:
                    self._flush_push()
                n += len(y[lo:lo + B])
        self.shards_consumed += 1
        self.consume_s += time.perf_counter() - t_start
        return n

    # -- the loop ----------------------------------------------------------
    def run(self, *, stop: threading.Event | None = None,
            max_shards: int = 0, idle_exit_s: float | None = None) -> dict:
        """Consume shards until ``stop`` is set, ``max_shards`` shards were
        trained (0 = unbounded), or nothing new came for ``idle_exit_s``
        seconds (None = wait forever)."""
        stop = stop or threading.Event()
        idle_since = clock.monotonic()
        consumed_this_run = 0
        while not stop.is_set():
            # every cycle: under steady traffic the pending list may never
            # drain, and a dead peer's claim must still return to the pool
            self._reclaim_stale()
            pending = self._scan()
            self.lag = len(pending)
            if not pending:
                now = clock.monotonic()
                if self._accum.batches and now - idle_since >= self.idle_flush_s:
                    # a lull: a partial span must not strand its gradients
                    self._flush_push()
                if idle_exit_s is not None and now - idle_since >= idle_exit_s:
                    break
                stop.wait(self.poll_interval_s)
                continue
            for path in pending:
                if stop.is_set():
                    break
                claimed = self._claim(path)
                if claimed is None:
                    continue  # a peer owns this shard
                try:
                    n = self.consume_shard(claimed)
                except FileNotFoundError:
                    # the claim outlived claim_stale_s before the open and a
                    # peer reclaimed it: lose the race, do not die
                    log.warning("online[%d]: claim on %s stolen before consume "
                                "(raise claim_stale_s?)", self.worker_id,
                                os.path.basename(path))
                    continue
                # consumed shards step aside (kept for audit); the sidecar
                # retires with its shard
                try:
                    os.replace(claimed, path + ".done")
                    side = self._sidecar_path(path)
                    if os.path.exists(side):
                        os.replace(side, side + ".done")
                except OSError:
                    log.warning("online[%d]: claim on %s expired while "
                                "consuming (raise claim_stale_s?)",
                                self.worker_id, os.path.basename(path))
                idle_since = clock.monotonic()
                consumed_this_run += 1
                log.info("online[%d]: consumed %s (%d examples, k=%d, %d pushes)",
                         self.worker_id, os.path.basename(path), n, self.accum_k,
                         self.pushes)
                if max_shards and consumed_this_run >= max_shards:
                    self._flush_push()
                    self.lag = len(self._scan())
                    return self.stats()
        self._flush_push()
        return self.stats()

    def stats(self) -> dict:
        return {
            "shards_consumed": self.shards_consumed,
            "examples": self.examples,
            "pushes": self.pushes,
            "accum_k": self.accum_k,
            "pending": len(self._scan()),
        }

    def close(self) -> None:
        self.kv.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
