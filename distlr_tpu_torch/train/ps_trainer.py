"""Parameter-server training (sync BSP or async Hogwild over the native KV
server group): the port of ``distlr_tpu/train/ps_trainer.py`` for the
dense families (``binary_lr``, ``softmax``).

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

Not ported yet: the keyed families (ROADMAP A.15); accumulation, retries
and restarts, checkpoints and resume, supervision, chaos (A.16); the
staleness histograms, trace spans and profiler hooks (A.12).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from distlr_tpu_torch.config import Config, _not_ported
from distlr_tpu_torch.data.iterator import DataIter
from distlr_tpu_torch.data.sharding import part_name
from distlr_tpu_torch.models import get_model
from distlr_tpu_torch.ps import KVWorker, ServerGroup
from distlr_tpu_torch.train.export import save_model_text
from distlr_tpu_torch.train.metrics import MetricsLogger, StepTimer
from distlr_tpu_torch.utils.device import resolve_device
from distlr_tpu_torch.utils.logging import log_eval_line

_DENSE_MODELS = ("binary_lr", "softmax")


def ps_param_dim(cfg: Config) -> int:
    """Flat KV key-space size for a config (must match between servers
    and workers; softmax flattens its (D, K) weight matrix)."""
    return cfg.num_feature_dim * (
        cfg.num_classes if cfg.model in ("softmax", "sparse_softmax") else 1)


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


def check_ps_config(cfg: Config) -> torch.device:
    """Refuse what the port's PS path does not run, then resolve
    ``cfg.device`` (which raises without CUDA unless the CPU was asked
    for, even when ``ps_compute_backend`` puts the steps on the host)."""
    if cfg.model not in _DENSE_MODELS:
        raise _not_ported(f"parameter-server training of {cfg.model} (the keyed PS families)",
                          "A.15")
    if cfg.checkpoint_dir:
        raise _not_ported("checkpoints and resume in PS mode (checkpoint_dir)", "A.16")
    if cfg.feature_dtype != "float32":
        # PS workers stream numpy batches from host RAM each step: there is
        # no resident feature matrix for quantization to shrink
        raise ValueError(
            "feature_dtype quantization applies to the sync trainer's resident "
            "features; PS mode streams host batches (set feature_dtype='float32')")
    return resolve_device(cfg.device)


class PSWorker:
    """One worker's training loop against a KV server group: the full
    weight vector pulled and pushed per batch, like the reference worker.

    ``op_seconds`` collects the host seconds of each KV op (``pull``,
    ``push``, ``push_pull``) and of each gradient (``grad``);
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
        self.kv = KVWorker(hosts, ps_param_dim(cfg), client_id=rank,
                           timeout_ms=cfg.ps_timeout_ms, sync_group=cfg.sync_mode)
        self.metrics = MetricsLogger()
        self.timer = StepTimer()
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

    @contextlib.contextmanager
    def _timed(self, op: str):
        t0 = time.perf_counter()
        yield
        self.op_seconds.setdefault(op, []).append(time.perf_counter() - t0)

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
        return DataIter.from_file(path, self.cfg.num_feature_dim, self.cfg.batch_size,
                                  multiclass=self.cfg.model == "softmax",
                                  wrap_compat=bool(self.cfg.wrap_final_batch))  # Q5

    def _load_test_iter(self) -> DataIter:
        path = os.path.join(self.cfg.data_dir, "test", part_name(0))
        return DataIter.from_file(path, self.cfg.num_feature_dim, -1,
                                  multiclass=self.cfg.model == "softmax")

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

    def _evaluate(self, test: DataIter, dev) -> tuple[float, float]:
        """Full-test-set ``(accuracy, logloss)`` of the servers' weights,
        from one forward pass."""
        w = self.kv.pull()
        test.reset()
        Xt, yt, mt = test.next_batch()
        K = self._num_classes()
        if dev == "numpy":
            return _np_dense_eval(self._shape_params(w), Xt, yt, mt.astype(np.float32), K)
        if self._test_features is None:
            self._test_features = self._features(Xt, dev).to(dev)
        z = self.model.logits(torch.from_numpy(self._shape_params(w)).to(dev),
                              self._test_features)
        return _dense_eval_from_logits(z.cpu().numpy(), yt, mt, K)

    def run(self, *, eval_fn=None, save: bool = True) -> np.ndarray:
        cfg = self.cfg
        train = self._load_train_iter()
        test = self._load_test_iter() if self.rank == 0 else None
        # identical deterministic init on every worker (Q2); only rank 0
        # pushes it, through the idempotent seeding op
        w0 = self.model.init(cfg).numpy().reshape(-1)
        if self.rank == 0:
            self.kv.wait(self.kv.push_init(w0))
        self.kv.barrier(0)
        return self._run_epochs(train, test, eval_fn=eval_fn, save=save)

    def _run_epochs(self, train: DataIter, test: DataIter | None, *, eval_fn, save):
        cfg = self.cfg
        dev = ps_compute_device(cfg)
        dev = resolve_device(dev) if isinstance(dev, torch.device) else dev
        compute_g = self._grad_fn(dev)
        for epoch in range(cfg.num_iteration):
            train.reset()
            if not cfg.ps_pipeline:
                # the reference's serialized protocol: two blocking round
                # trips a batch (src/lr.cc:116-132)
                for X, y, mask in train:
                    self.timer.start()
                    with self._timed("pull"):
                        w = self.kv.pull()
                    g = compute_g(w, X, y, mask)
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
                fut = None
                for X, y, mask in train:
                    self.timer.start()
                    g = compute_g(self._w_cache, X, y, mask)
                    if fut is not None:
                        self._w_cache = fut.result()
                    fut = self._comm_pool().submit(self._timed_push_pull, g)
                    self.timer.stop(int(mask.sum()))
                if fut is not None:
                    self._w_cache = fut.result()
            if (self.rank == 0 and test is not None and cfg.test_interval > 0
                    and (epoch + 1) % cfg.test_interval == 0):
                acc, test_ll = self._evaluate(test, dev)
                self.metrics.log(epoch=epoch + 1, accuracy=acc, test_logloss=test_ll,
                                 samples_per_sec=self.timer.samples_per_sec)
                if eval_fn is not None:
                    eval_fn(epoch + 1, acc)
                else:
                    log_eval_line(epoch + 1, acc)

        with self._timed("pull"):
            self.final_weights = self.kv.pull()
        if save:
            path = os.path.join(cfg.data_dir, "models", part_name(self.rank))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            save_model_text(path, self.final_weights)
        # ps::Finalize(do_barrier=true) parity (src/main.cc:179): a global
        # exit barrier so no server retires while a peer still trains,
        # then rank 0 reads the push clock and retires the group
        self.kv.barrier(1)
        if self.rank == 0:
            self.group_pushes = self.kv.global_pushes()
            self.kv.shutdown_servers()
        return self.final_weights

    def _comm_pool(self) -> ThreadPoolExecutor:
        if self._comm is None:
            self._comm = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix=f"ps-comm-{self.rank}")
        return self._comm

    def _timed_push_pull(self, g: np.ndarray) -> np.ndarray:
        with self._timed("push_pull"):
            return self.kv.push_pull(g)

    def report(self) -> dict:
        """Per-worker timing: steps, ``round_ms`` (host clock, a batch
        from its gradient to its push's reply), the mean host ms of each
        KV op and of the gradient, and on the card ``grad_span_ms``, the
        mean over all but the first step of the CUDA events around
        ``model.grad``: the kernel and the host's planning, allocation and
        launch inside the call, which the card waits out
        (``grad_span_first_ms`` is the first step's, with the kernel
        library's load); rank 0 adds its last eval and the push clock."""
        span_ms = [s.elapsed_time(e) for s, e in self._grad_events]
        return {
            "rank": self.rank, "steps": self.timer.steps,
            "round_ms": 1e3 * self.timer.sec_per_step,
            **{f"{op}_ms": 1e3 * float(np.mean(v)) for op, v in self.op_seconds.items()},
            **{f"{op}_count": len(v) for op, v in self.op_seconds.items()},
            "grad_span_ms": float(np.mean(span_ms[1:])) if len(span_ms) > 1 else None,
            "grad_span_first_ms": span_ms[0] if span_ms else None,
            "group_pushes": self.group_pushes,
            "test_accuracy": self.metrics.latest("accuracy"),
            "test_logloss": self.metrics.latest("test_logloss"),
        }

    def close(self) -> None:
        comm, self._comm = self._comm, None
        if comm is not None:
            # wait out an in-flight push_pull: the native handle must not be
            # freed under a live ctypes call
            comm.shutdown(wait=True)
        self.kv.close()


def run_ps_workers(cfg: Config, hosts: str, ranks, *, eval_fn=None, save: bool = False,
                   on_error=None, report: dict | None = None):
    """Run the given worker ranks (threads) against an EXISTING server
    group at ``hosts``; returns ``{rank: final_weights}``.

    Each thread blocks in the native client with the GIL released, so
    async staleness is real.  ``on_error`` runs once for each failed
    worker (local mode tears the servers down with it, so peers blocked
    on the sync barrier fail instead of hanging); the first error is
    raised after every thread ended.  ``report``, when given, receives
    each worker's :meth:`PSWorker.report` by rank.
    """
    ranks = list(ranks)
    results: dict[int, np.ndarray | None] = dict.fromkeys(ranks)
    errors: list[BaseException] = []
    workers: list[PSWorker] = []
    device_lock = threading.Lock()  # the workers share one card
    try:
        for r in ranks:
            workers.append(PSWorker(cfg, r, hosts, device_lock=device_lock))

        def run_one(worker: PSWorker):
            try:
                results[worker.rank] = worker.run(
                    eval_fn=eval_fn if worker.rank == 0 else None, save=save)
            except Exception as e:  # surfaced to the caller after the join
                errors.append(e)
                if on_error is not None:
                    on_error()

        threads = [threading.Thread(target=run_one, args=(wk,), daemon=True,
                                    name=f"ps-worker-{wk.rank}") for wk in workers]
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


def run_ps_local(cfg: Config, *, eval_fn=None, save: bool = False, report: dict | None = None):
    """Single-host PS run: ``cfg.num_servers`` native server processes and
    ``cfg.num_workers`` worker threads (the local-mode successor of
    ``examples/local.sh``); returns the workers' final weights in rank
    order.  Multi-host deployments run :func:`run_ps_workers` against a
    group started elsewhere."""
    check_ps_config(cfg)
    group = ServerGroup(cfg.num_servers, cfg.num_workers, ps_param_dim(cfg),
                        learning_rate=cfg.learning_rate, sync=cfg.sync_mode,
                        last_gradient=bool(cfg.sync_last_gradient))
    with group:
        results = run_ps_workers(cfg, group.hosts, range(cfg.num_workers), eval_fn=eval_fn,
                                 save=save, on_error=group.stop, report=report)
    return [results[r] for r in range(cfg.num_workers)]
