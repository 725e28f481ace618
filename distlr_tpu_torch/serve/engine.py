"""Batched scoring engine: one forward per padded bucket over every model
family, with hot-swappable weights.

Counterpart of ``distlr_tpu/serve/engine.py``.  Incoming batches are
padded up to a small ladder of bucket sizes (default ``{64, 256, 1024}``
capped at ``max_batch_size``) and larger ones are cut into chunks, as the
JAX engine does to bound its compiles; here the ladder bounds the shapes
the kernels see, and ``bucket_hits`` counts the same things.

* **One forward per bucket.** ``model.logits`` runs once and the labels
  and the scores both come from those logits (the JAX body calls
  ``predict`` and ``proba`` and XLA folds them into one product).  Dense
  ``binary_lr`` on the card is one ``ops.lr_logits`` launch per bucket
  (its int8 instance for int8 features, ``lr_logits_row_blocks`` above
  the slice kernels' width bound), ``int8_dot`` one ``lr_logits_int8dot``.
* **Padding on the card.** The bucket-sized batch is allocated on the
  device, zeroed (the pad rows the JAX engine feeds), and only the real
  rows are copied into it, cast to the product dtype (bf16, or int8 for
  int8 features); the first ``n`` results are kept.  Rows are independent
  in every forward, so the results are the bits of scoring the padded
  batch.  The buffer is freed after the call.
* **Atomic weight swap.** ``set_weights`` copies the new table into a new
  device tensor and only then points ``self._weights`` at it; a ``score``
  call reads that reference once at entry and finishes on the weights it
  read.  The copy and the scoring both run on the current (default)
  stream, so a kernel launched after the swap is queued after the copy,
  and the old table's memory is reused only by work queued after it.
* **Idle eviction.** After ``idle_evict_s`` idle seconds the device table
  is dropped (a host copy stays, and publishes land there); the next
  request copies it back.  On the card the memory returns to PyTorch's
  caching allocator (``torch.cuda.memory_allocated`` drops).

On ``cuda`` the constructor builds and loads the kernel library the
family's forward launches, so a build failure fails the server's start,
not its first request.  The obs registry counters and trace spans of the
JAX engine are not ported (ROADMAP A.12); ``stats()`` reports the same
numbers from plain attributes.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from distlr_tpu_torch.config import Config
from distlr_tpu_torch.models import get_model
from distlr_tpu_torch.utils.device import resolve_device

DEFAULT_BUCKETS = (64, 256, 1024)

_PRODUCT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _next_bucket(n: int, ladder: tuple[int, ...]) -> int:
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


class ScoringEngine:
    """Batched scoring over one model family on ``cfg.device``.

    ``rows`` everywhere below is the family's feature-leaf tuple of host
    numpy arrays with a shared leading (batch) axis: dense ``(X,)``;
    sparse COO ``(cols, vals)``; blocked ``(blocks, lane_vals)``, i.e. the
    train batch layout minus labels and mask.  An int8-feature model's
    ``feature_scale`` is a field of ``self.model``; a caller serving a
    quantization-trained model sets it (``dataclasses.replace``).
    """

    def __init__(self, cfg: Config, weights=None, *, max_batch_size: int = 1024,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS, idle_evict_s: float = 0.0):
        if max_batch_size <= 0:
            raise ValueError(f"max_batch_size must be positive, got {max_batch_size}")
        if idle_evict_s < 0:
            raise ValueError(f"idle_evict_s must be >= 0 (0 = never evict), got {idle_evict_s}")
        if cfg.model == "blocked_lr" and cfg.block_size == 0:
            raise ValueError(
                "block_size=0 (auto) must be resolved before serving — pin "
                "the (R, groups) the model was trained with")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.model = get_model(cfg)
        self.max_batch_size = int(max_batch_size)
        self.buckets = tuple(sorted(
            {b for b in buckets if b < max_batch_size} | {self.max_batch_size}))
        self._lock = threading.Lock()
        self._weights: torch.Tensor | None = None
        self.weights_version = 0
        self._bucket_hits: dict[int, int] = {}
        self.batches_scored = 0
        self.rows_scored = 0
        self.idle_evict_s = float(idle_evict_s)
        self._host_weights: np.ndarray | None = None
        self._last_score_at = time.monotonic()
        self._inflight = 0
        self.evictions = 0
        if self.device.type == "cuda":
            self._build_kernels()
        self._evict_stop: threading.Event | None = None
        if self.idle_evict_s > 0:
            self._evict_stop = threading.Event()
            threading.Thread(target=self._evict_loop, daemon=True,
                             name="distlr-engine-evict").start()
        if weights is not None:
            self.set_weights(weights)

    def _build_kernels(self) -> None:
        """Build and load the library of the kernels this family's forward
        launches (``ops/build.py``: from the checkout's sources at first
        use), before any request or reload thread can race the build."""
        if self.cfg.model != "binary_lr":
            return  # the other families' forwards are library calls
        from distlr_tpu_torch.ops import fused_lr  # noqa: PLC0415

        int8 = self.cfg.feature_dtype in ("int8", "int8_dot")
        with torch.cuda.device(self.device):
            (fused_lr._int8_lib if int8 else fused_lr._lib)()

    @property
    def product_dtype(self) -> torch.dtype:
        """The device dtype of a dense batch: int8 for int8 features, else
        the product dtype (``cfg.compute_dtype``)."""
        if self.cfg.feature_dtype in ("int8", "int8_dot"):
            return torch.int8
        return _PRODUCT_DTYPES[self.cfg.compute_dtype]

    # -- weights ----------------------------------------------------------
    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        return torch.tensor(host, dtype=torch.float32, device=self.device)

    def set_weights(self, weights) -> int:
        """Publish new weights (a host array or a tensor, flat or shaped);
        returns the new version.  Calls already past the reference read
        finish on the old weights; the next batch sees the new ones.  An
        evicted engine's publish stays host-side."""
        if isinstance(weights, torch.Tensor):
            weights = weights.detach().to("cpu", torch.float32).numpy()
        host = np.array(weights, dtype=np.float32).reshape(self.model.param_shape)
        with self._lock:
            if self.idle_evict_s > 0 and self._weights is None and self._host_weights is not None:
                self._host_weights = host
                self.weights_version += 1
                return self.weights_version
        w = self._to_device(host)
        with self._lock:
            self._weights = w
            if self.idle_evict_s > 0:
                self._host_weights = host
            self.weights_version += 1
            return self.weights_version

    @property
    def has_weights(self) -> bool:
        return self._weights is not None or self._host_weights is not None

    @property
    def resident(self) -> bool:
        """Whether the weight table is in device memory right now (False =
        evicted, awaiting its next request)."""
        return self._weights is not None

    def get_weights(self) -> np.ndarray:
        w = self._weights
        if w is not None:
            return w.to("cpu").numpy().copy()
        if self._host_weights is not None:
            return np.array(self._host_weights)
        raise RuntimeError("engine has no weights loaded")

    # -- idle eviction -----------------------------------------------------
    def _evict_loop(self) -> None:
        tick = max(self.idle_evict_s / 4.0, 0.05)
        while not self._evict_stop.wait(tick):
            self.maybe_evict()

    def maybe_evict(self, now: float | None = None) -> bool:
        """Drop the device table if this engine has been idle past
        ``idle_evict_s``; True when an eviction happened."""
        if self.idle_evict_s <= 0:
            return False
        now = time.monotonic() if now is None else now
        with self._lock:
            if (self._weights is None or self._inflight
                    or now - self._last_score_at < self.idle_evict_s):
                return False
            if self._host_weights is None:
                self._host_weights = self._weights.to("cpu").numpy()
            self._weights = None
            self.evictions += 1
        return True

    def _ensure_resident_locked(self) -> None:
        if self._weights is None and self._host_weights is not None:
            self._weights = self._to_device(self._host_weights)

    # -- scoring ----------------------------------------------------------
    def _leaf_dtype(self, k: int, leaf: np.ndarray) -> torch.dtype:
        if k == 0 and self.cfg.model in ("binary_lr", "softmax"):
            return self.product_dtype
        return torch.from_numpy(leaf[:0]).dtype

    def _pad_rows(self, rows: tuple[np.ndarray, ...], bucket: int) -> tuple[torch.Tensor, ...]:
        """The bucket-sized device batch: zeros, with the real rows copied
        in (cast to the product dtype on the host first, so only those
        bytes cross to the card)."""
        n = rows[0].shape[0]
        out = []
        for k, leaf in enumerate(rows):
            dtype = self._leaf_dtype(k, leaf)
            buf = torch.zeros((bucket, *leaf.shape[1:]), dtype=dtype, device=self.device)
            buf[:n].copy_(torch.from_numpy(np.ascontiguousarray(leaf)).to(dtype))
            out.append(buf)
        return tuple(out)

    def _forward(self, w: torch.Tensor, batch: tuple[torch.Tensor, ...]):
        """Labels and scores from one ``logits`` call: P(y=1) for binary
        families, the max class probability for softmax ones."""
        z = self.model.logits(w, *batch)
        labels = self.model.predict_from_logits(z)
        p = self.model.proba_from_logits(z)
        return labels, (p if p.ndim == 1 else p.max(dim=-1).values)

    def _score_bucket(self, w: torch.Tensor, rows: tuple[np.ndarray, ...]):
        n = rows[0].shape[0]
        bucket = _next_bucket(n, self.buckets)
        self._bucket_hits[bucket] = self._bucket_hits.get(bucket, 0) + 1
        labels, scores = self._forward(w, self._pad_rows(rows, bucket))
        return labels[:n].cpu().numpy(), scores[:n].cpu().numpy()

    def score(self, rows: tuple[np.ndarray, ...]) -> tuple[np.ndarray, np.ndarray]:
        """Score a host batch -> ``(labels (B,) int32, scores (B,) f32)``.

        Batches larger than ``max_batch_size`` are chunked; smaller ones
        are padded up to the nearest bucket.  Sparse COO batches must
        already be at an engine NNZ width (``encode_lines`` makes them so).
        """
        if not self.has_weights:
            raise RuntimeError(
                "engine has no weights loaded yet (set_weights / a weight "
                "source must publish before scoring)")
        n = rows[0].shape[0]
        if n == 0:
            return np.empty(0, np.int32), np.empty(0, np.float32)
        # lazy reload of an evicted table, and an in-flight guard so the
        # evictor never drops the table under a running batch
        with self._lock:
            self._ensure_resident_locked()
            self._inflight += 1
            w = self._weights  # the swap point: this call's weights
        try:
            labels_out, scores_out = [], []
            for lo in range(0, n, self.max_batch_size):
                chunk = tuple(leaf[lo:lo + self.max_batch_size] for leaf in rows)
                lab, sc = self._score_bucket(w, chunk)
                labels_out.append(lab)
                scores_out.append(sc)
        finally:
            with self._lock:
                self._inflight -= 1
                self._last_score_at = time.monotonic()
        self.batches_scored += 1
        self.rows_scored += n
        return np.concatenate(labels_out), np.concatenate(scores_out)

    # -- request encoding --------------------------------------------------
    def _nnz_width(self, max_nnz: int) -> int:
        """NNZ pad width of a sparse batch: the next power of two (>= 8),
        capped at ``cfg.nnz_max`` when set, so the widths stay few."""
        width = max(_next_pow2(max_nnz), 8)
        if self.cfg.nnz_max:
            width = min(width, self.cfg.nnz_max)
        return width

    def encode_lines(self, lines: list[str]) -> tuple[np.ndarray, ...]:
        """Parse request lines into this family's feature-leaf tuple (host
        arrays, the JAX engine's bytes).

        Lines are libsvm feature lists; a leading label token is optional
        and ignored.  Blocked models read the raw-CTR line format (field
        number : raw categorical id), hashed with the config's seed and
        grouping, so serving buckets as training does and rejects what
        training rejects.
        """
        from distlr_tpu_torch.data.libsvm import parse_libsvm_lines  # noqa: PLC0415

        normalized = []
        for ln in lines:
            ln = ln.strip()
            first = ln.split(None, 1)[0] if ln else ""
            normalized.append(ln if first and ":" not in first else "0 " + ln)
        cfg = self.cfg
        if cfg.model == "blocked_lr":
            from distlr_tpu_torch.data.hashing import (  # noqa: PLC0415
                csr_to_raw_ids,
                encode_blocked,
                resolve_ctr_fields,
            )

            (row_ptr, cols, vals), _ = parse_libsvm_lines(normalized, None, dense=False)
            num_fields = (resolve_ctr_fields(cfg.data_dir, cfg.ctr_fields)
                          if (cfg.ctr_fields == 0 and cfg.data_dir) else cfg.ctr_fields)
            if not num_fields:
                raise ValueError("blocked_lr serving needs ctr_fields (or a data_dir "
                                 "with a ctr_meta.json manifest)")
            raw_ids = csr_to_raw_ids(row_ptr, cols, vals, num_fields, origin="request")
            return encode_blocked(raw_ids, cfg.num_feature_dim // cfg.block_size,
                                  cfg.block_size, seed=cfg.hash_seed,
                                  num_groups=cfg.block_groups)
        if cfg.model in ("sparse_lr", "sparse_softmax"):
            from distlr_tpu_torch.data.hashing import csr_to_padded_coo  # noqa: PLC0415

            (row_ptr, cols, vals), _ = parse_libsvm_lines(normalized, cfg.num_feature_dim,
                                                          dense=False)
            lengths = np.diff(row_ptr)
            nnz = self._nnz_width(int(lengths.max()) if len(lengths) else 1)
            return csr_to_padded_coo(row_ptr, cols, vals, nnz_max=nnz)
        X, _ = parse_libsvm_lines(normalized, cfg.num_feature_dim, dense=True)
        if cfg.feature_dtype in ("int8", "int8_dot"):
            # requests quantize onto the model's feature_scale grid
            X = np.clip(np.rint(X / self.model.feature_scale), -127, 127).astype(np.int8)
        return (X,)

    def row_keys(self, rows: tuple[np.ndarray, ...]) -> np.ndarray:
        """PS row keys a request batch touches: sparse COO column ids,
        blocked table row ids, or (dense) the feature columns any row of
        the batch exercises."""
        if self.cfg.model in ("sparse_lr", "sparse_softmax", "blocked_lr"):
            return np.unique(np.asarray(rows[0], dtype=np.int64)).astype(np.uint64)
        X = np.asarray(rows[0])
        return np.flatnonzero((X != 0).any(axis=0)).astype(np.uint64)

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        out = {
            "weights_version": self.weights_version,
            "batches_scored": self.batches_scored,
            "rows_scored": self.rows_scored,
            "bucket_hits": dict(sorted(self._bucket_hits.items())),
            "buckets": list(self.buckets),
        }
        if self.idle_evict_s > 0:
            out["resident"] = self.resident
            out["evictions"] = self.evictions
        return out
