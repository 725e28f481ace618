"""Typed configuration of the port.

Holds the fields of ``distlr_tpu/config.py::Config`` that the ported
sync dense-LR trainer reads, with the same names and defaults, and the
same resolution of the reference-quirk gates Q1, Q2, Q4 and Q5 from
``compat_mode``.  Options whose code is not ported yet raise
``NotImplementedError`` naming their ROADMAP item, so a run never
silently drops one.  ``device`` is the port's own knob.
"""

from __future__ import annotations

import dataclasses
from typing import Any


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to distlr_tpu_torch yet (ROADMAP {item})")


@dataclasses.dataclass
class Config:
    """Training configuration; ``Config()`` trains the reference launcher's
    default workload (``examples/local.sh``), on ``cuda``."""

    # ---- algorithm (reference env contract) ----
    sync_mode: bool = True            # SYNC_MODE ("1" = BSP, else async/PS)
    learning_rate: float = 0.2        # LEARNING_RATE (SGD eta)
    data_dir: str = "./a9a-data"      # DATA_DIR (train/ test/ models/ subdirs)
    num_feature_dim: int = 123        # NUM_FEATURE_DIM (D)
    num_iteration: int = 100          # NUM_ITERATION (outer epochs)
    batch_size: int = -1              # BATCH_SIZE (-1 = full shard)
    test_interval: int = 10           # TEST_INTERVAL (eval every k epochs)
    random_seed: int = 10             # RANDOM_SEED (uniform init seed)
    l2_c: float = 1.0                 # L2 coefficient C

    # ---- model ----
    model: str = "binary_lr"
    compute_dtype: str = "bfloat16"   # product dtype (sums are always f32)
    # Device-resident storage dtype of the dense feature matrix.
    feature_dtype: str = "float32"    # float32 | bfloat16

    # ---- parity / compat with reference quirks ----
    compat_mode: str = "correct"      # correct | reference
    l2_scale_by_batch: bool | None = None   # Q4: L2 term divided by batch size
    sync_last_gradient: bool | None = None  # Q1: apply last shard's grad / W
    reference_rng_init: bool | None = None  # Q2: glibc srand(0) rand() init
    wrap_final_batch: bool | None = None    # Q5: final batch wraps to head

    # ---- parallelism ----
    num_workers: int = 1              # data-parallel shards (DMLC_NUM_WORKER)
    mesh_shape: dict | None = None    # only {"data": W} is ported
    feature_shards: int = 1           # model-axis sharding (not ported)

    # ---- input pipeline ----
    # Host->device streaming depth in Trainer.fit: up to prefetch-1
    # batches are sliced, pinned and copied ahead of the running step.
    prefetch: int = 2

    # ---- checkpoint / obs (not ported: must stay unset) ----
    checkpoint_dir: str | None = None
    checkpoint_interval: int = 0
    profile_dir: str | None = None

    # ---- port only ----
    device: str = "cuda"              # "cuda", "cuda:N" or "cpu"

    def __post_init__(self):
        ref = self.compat_mode == "reference"
        if self.compat_mode not in ("correct", "reference"):
            raise ValueError(f"compat_mode must be correct|reference, got {self.compat_mode!r}")
        if self.l2_scale_by_batch is None:
            self.l2_scale_by_batch = ref
        if self.sync_last_gradient is None:
            self.sync_last_gradient = ref
        if self.reference_rng_init is None:
            self.reference_rng_init = ref
        if self.wrap_final_batch is None:
            self.wrap_final_batch = ref
        if self.model != "binary_lr":
            if self.model == "softmax":
                raise _not_ported(f"model={self.model!r}", "A.2")
            if self.model in ("sparse_lr", "sparse_softmax", "blocked_lr"):
                raise _not_ported(f"model={self.model!r}", "A.4")
            raise ValueError(f"unknown model {self.model!r}")
        if self.num_feature_dim <= 0:
            raise ValueError("num_feature_dim must be positive")
        if self.batch_size == 0 or self.batch_size < -1:
            raise ValueError("batch_size must be -1 (full shard) or positive")
        if self.feature_dtype in ("int8", "int8_dot"):
            raise _not_ported(f"feature_dtype={self.feature_dtype!r}", "A.3")
        if self.feature_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"feature_dtype must be float32|bfloat16, got {self.feature_dtype!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32|bfloat16, got {self.compute_dtype!r}")
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if self.feature_shards > 1 or (
            self.mesh_shape is not None and set(self.mesh_shape) - {"data"}
        ):
            raise _not_ported("feature sharding (a 'model' mesh axis)", "A.7")
        if self.mesh_shape is not None and self.mesh_shape.get("data", 1) != self.num_workers:
            raise ValueError(
                f"mesh_shape {self.mesh_shape} disagrees with num_workers={self.num_workers}; "
                "the port's data axis is num_workers row blocks on one card")
        if not self.sync_mode:
            raise _not_ported("async / parameter-server training (sync_mode=False)", "A.9")
        if self.checkpoint_dir or self.checkpoint_interval:
            raise _not_ported("checkpoint_dir / checkpoint_interval", "A.8")
        if self.profile_dir:
            raise _not_ported("profile_dir", "A.12")
        if self.prefetch < 1:
            raise ValueError("prefetch must be >= 1 (1 = no prefetch)")

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)
