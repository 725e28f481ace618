"""Typed configuration of the port.

Holds the fields of ``distlr_tpu/config.py::Config`` that the ported
sync trainer reads (all five model families, int8 feature storage,
checkpoints, the ``data x model`` mesh of the feature-sharded step) and
that the ported parameter-server worker loop reads
(``num_servers``, ``ps_compute_backend``, ``ps_pipeline``,
``ps_timeout_ms``, the ``ps_retry_*`` policy; sync BSP and async Hogwild for every family; the
servers' update rule ``ps_optimizer`` with the ``ftrl_*`` parameters,
the wire codec ``ps_compress``, the ``ps_accum_*`` accumulation, the
servers' durable store ``ps_store_*`` and the fault plan ``chaos_*``)
and the scoring tier reads (the ``serve_*`` fields of ``launch serve``,
hot-row reload and named engines among them, the ``feedback_*`` fields of
the feedback loop, and the ``route_*`` fields of ``launch route``),
and the observability fields (``profile_dir``, ``obs_metrics_port``,
``obs_metrics_host``, ``obs_trace_path``, ``obs_run_dir``,
``trace_sample``), with the same names, defaults
and validations, and the same resolution of the reference-quirk gates
Q1, Q2, Q4 and Q5 from ``compat_mode``.  :func:`_not_ported` builds the
``NotImplementedError`` that names the ROADMAP item of an option whose
code is not ported yet (the launcher's profiler, log and incident
flags), so a run never silently drops one.
``ps_host`` and ``ps_port``, the reference's
rendezvous address, are accepted and read by nothing, as in JAX;
:meth:`Config.from_env` reads the reference's environment variables.
``device`` is the port's own knob.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Mapping
from typing import Any


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to distlr_tpu_torch yet (ROADMAP {item})")


_SPARSE_MODELS = ("sparse_lr", "sparse_softmax", "blocked_lr")
_MODELS = ("binary_lr", "softmax") + _SPARSE_MODELS

def _env(env: Mapping[str, str], name: str, cast, default):
    raw = env.get(name)
    if raw is None or raw == "":
        return default
    try:
        return cast(raw)
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad value for env var {name}={raw!r}: {e}") from e


def _bool_from_int(raw: str) -> bool:
    # the reference's rule: SYNC_MODE is sync iff the string is exactly "1"
    # (strcmp in src/main.cc:26)
    return raw.strip() == "1"


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
    model: str = "binary_lr"          # binary_lr | softmax | sparse_lr
    #                                 | sparse_softmax | blocked_lr
    num_classes: int = 2              # softmax families only
    nnz_max: int | None = None        # sparse families: per-row nonzero cap (pad width)
    # blocked_lr: lanes per table row (rows = num_feature_dim / block_size);
    # 0 = auto, resolved from raw-CTR data before a model is built
    block_size: int = 8
    # blocked_lr: conjunction groups the raw fields hash into
    # (0 = ceil(ctr_fields / block_size) consecutive chunks)
    block_groups: int = 0
    # blocked_lr: raw categorical fields per row (0 = read ctr_meta.json)
    ctr_fields: int = 0
    hash_seed: int = 0                # seed of the load-time feature hash
    compute_dtype: str = "bfloat16"   # product dtype (sums are always f32)
    # Device-resident storage dtype of the dense feature matrix: int8 is
    # symmetric per-dataset quantization (the scale becomes the model's
    # feature_scale); int8_dot also quantizes w and the residual per step
    # and contracts int8 x int8 (binary_lr and softmax only).
    feature_dtype: str = "float32"    # float32 | bfloat16 | int8 | int8_dot

    # ---- parity / compat with reference quirks ----
    compat_mode: str = "correct"      # correct | reference
    l2_scale_by_batch: bool | None = None   # Q4: L2 term divided by batch size
    sync_last_gradient: bool | None = None  # Q1: apply last shard's grad / W
    reference_rng_init: bool | None = None  # Q2: glibc srand(0) rand() init
    wrap_final_batch: bool | None = None    # Q5: final batch wraps to head

    # ---- parallelism ----
    num_workers: int = 1              # data-parallel shards (DMLC_NUM_WORKER)
    num_servers: int = 1              # PS mode server count (DMLC_NUM_SERVER)
    # {"data": W} or {"data": W, "model": S}: W row blocks a process (the
    # data axis spans every process of a torch.distributed run), S column
    # blocks (the feature-sharded step); None = {"data": num_workers}
    mesh_shape: dict | None = None
    feature_shards: int = 1           # model-axis sharding of the feature dim

    # ---- PS / async mode ----
    # Where PS workers run their dense gradient and eval steps: "numpy"
    # (host numpy, f32) and "cpu" (torch on the CPU) on request; "auto"
    # and "default" take ``device``.
    ps_compute_backend: str = "auto"  # auto | numpy | cpu | default
    # Dense PS protocol: one fused push_pull a batch instead of the
    # reference's pull -> grad -> push (src/lr.cc:116-132); async also
    # computes batch k+1's gradient while batch k's round trip is in
    # flight.  Sync trajectories are bit-identical either way.
    ps_pipeline: bool = True
    # Per-op receive timeout (0 = block forever, the reference's
    # semantics: a dead peer then deadlocks the sync barrier).
    ps_timeout_ms: int = 600_000
    # Server-side update rule of gradient pushes: "sgd" (the reference's
    # w -= lr * g) or "ftrl" (per-coordinate FTRL-Proximal with z and n
    # accumulators; L1 sparsifies).  Incompatible with the Q1
    # sync_last_gradient quirk (an SGD parity artifact).
    ps_optimizer: str = "sgd"         # sgd | ftrl
    ftrl_alpha: float = 0.1           # per-coordinate learning-rate scale
    ftrl_beta: float = 1.0            # learning-rate smoothing
    ftrl_l1: float = 0.0              # L1 strength (sparsifies weights)
    ftrl_l2: float = 0.0              # L2 strength
    # Gradient wire codec of PS pushes, negotiated a connection (a group
    # that does not advertise it gets dense f32): "int8" block-quantized
    # values with f32 scales (sgd and ftrl), "signsgd" 1 bit a coordinate
    # and the servers' majority vote (the group runs --optimizer=signsgd;
    # needs ps_optimizer="sgd" and a signSGD-scale learning_rate).
    # Incompatible with Q1.
    ps_compress: str = "none"         # none | int8 | signsgd
    # AdaBatch accumulation: push the MEAN gradient every k batches, k
    # growing from ps_accum_start by x ps_accum_growth every
    # ps_accum_growth_every pushes, capped at ps_accum_max; (1, 1) = off.
    ps_accum_start: int = 1
    ps_accum_growth: float = 2.0
    ps_accum_growth_every: int = 32
    ps_accum_max: int = 1
    # In-place retry of transient KV transport faults (ps.RetryPolicy):
    # total tries an op (0 = off, fail fast), jittered exponential backoff
    # between them, a wall deadline an op.  Sync gradient pushes are never
    # retried.  ps_retry_adaptive scales the backoff base by the recent
    # fault rate (up to 8x, still capped by ps_retry_backoff_max_ms).
    ps_retry_attempts: int = 0
    ps_retry_backoff_ms: float = 50.0
    ps_retry_backoff_max_ms: float = 2000.0
    ps_retry_deadline_s: float = 60.0
    ps_retry_adaptive: bool = False
    # The reference's rendezvous address: accepted and read by nothing, as
    # in JAX (the servers bind port 0 and clients get their hosts, or a
    # coordinator's layout).
    ps_host: str = "127.0.0.1"        # DMLC_PS_ROOT_URI
    ps_port: int = 8001               # DMLC_PS_ROOT_PORT
    # Durable server store: each spawned rank snapshots its slice (weights,
    # FTRL z/n, epoch, push clock) under <ps_store_dir>/rank-<r>/ every
    # ps_store_interval_s seconds, CRC-checked, two generations kept, and
    # recovers from it at start.  None = RAM only.
    ps_store_dir: str | None = None
    ps_store_interval_s: float = 5.0
    # A log of every applied push on top of the snapshots, replayed over the
    # newest valid one at start (RPO ~0, bounded by the group-commit fsync
    # window).  Needs ps_store_dir and async mode.
    ps_store_wal: bool = False
    ps_store_wal_fsync_s: float = 0.1
    # A JSON fault plan: local PS runs put the fault-injection proxies
    # between every worker and the spawned group.  None = no faults.
    chaos_plan: str | None = None
    # Seed of the plan's jitter draws; None = the plan file's own "seed".
    chaos_seed: int | None = None

    # ---- input pipeline ----
    # Host->device streaming depth in Trainer.fit: up to prefetch-1
    # batches are sliced, pinned and copied ahead of the running step.
    prefetch: int = 2

    # ---- checkpoint / obs ----
    checkpoint_dir: str | None = None
    checkpoint_interval: int = 0      # epochs; 0 = only final save
    # torch.profiler (CPU and CUDA activities) around Trainer.fit and a
    # PS run's rank 0; the Chrome trace is exported into this directory.
    profile_dir: str | None = None
    # HTTP /metrics endpoint (distlr_tpu_torch.obs): None = off, 0 =
    # ephemeral OS-assigned port (announced as "METRICS host:port"), else
    # the fixed port to bind.  Serves Prometheus text at /metrics and a
    # JSON snapshot at /metrics.json for every subsystem in this process.
    obs_metrics_port: int | None = None
    obs_metrics_host: str = "127.0.0.1"
    # Write the run's phase spans as Chrome trace-event JSON here at the
    # end of the command (loadable in Perfetto / chrome://tracing).
    obs_trace_path: str | None = None
    # Fleet run dir shared by every process of one run (os.pathsep-joined
    # when several are given; a process writes into the first): each
    # launched process publishes its scrape endpoint as
    # <obs_run_dir>/endpoints/<role>-<rank>.json (a missing
    # obs_metrics_port then defaults to 0) and arms distributed tracing
    # (distlr_tpu_torch.obs.dtrace): sampled spans journal to
    # <obs_run_dir>/spans/ for `launch trace-agg`, and the flight
    # recorder dumps to <obs_run_dir>/flightrec/.  The JAX package's
    # profiles/ and logs/ are not written yet (ROADMAP A.21).
    obs_run_dir: str | None = None
    # Distributed-trace sampling rate: the fraction of minted traces whose
    # spans are journaled and propagated across the serve line protocol
    # and the KV wire.  Tracing arms only when obs_run_dir is set; 0
    # disables propagation and leaves the KV wire byte-identical.
    # Unsampled traces still feed the in-memory flight-recorder ring.
    trace_sample: float = 0.01

    # ---- serving (launch serve / distlr_tpu_torch.serve) ----
    # Port 0 = OS-assigned ephemeral (announced as "SERVING host:port").
    serve_port: int = 0
    serve_host: str = "127.0.0.1"
    # Upper bucket of the engine's padded batch ladder; also the
    # microbatcher's flush size.
    serve_max_batch_size: int = 1024
    # Microbatch window: a request waits at most this long for
    # co-batching company before flushing.
    serve_max_wait_ms: float = 2.0
    # Weight-source poll cadence for hot reload (checkpoint watch or
    # live-PS pull): the serving staleness bound.
    serve_reload_interval_s: float = 1.0
    # Idle-engine eviction: an engine that scored nothing for this many
    # seconds drops its device weight table (a host copy stays) and
    # reloads it on the next request.  0 = never evict.
    serve_engine_idle_evict_s: float = 0.0
    # Model id this serving process's primary engine answers as: the tenant
    # identity MODEL/@-addressed traffic selects.  "default" = one unnamed
    # engine (unaddressed traffic).
    serve_model_id: str = "default"
    # Hot-row keyed reload (live-PS serving only): capacity of the
    # request-fed HotSetTracker.  0 = off (every reload pulls the full
    # table); N > 0 = reload only the ~N-row working set through keyed
    # pulls, with a full refresh as the fallback below.
    serve_hot_rows: int = 0
    # Full refresh when the published hot set covers less than this
    # fraction of recently requested keys (a shifting distribution).
    serve_hot_min_coverage: float = 0.95
    # Also a full refresh every N polls (bounds cold rows' staleness to N
    # poll intervals); 0 = only coverage-driven ones.
    serve_hot_full_every: int = 10
    # The feedback loop (distlr_tpu_torch.feedback): a spool dir turns it
    # on (journal every scored request, accept LABEL lines, emit joined
    # shards); None = off.
    feedback_spool_dir: str | None = None
    # Joined-shard output dir (the online trainer's input).  None =
    # "<feedback_spool_dir>/shards".
    feedback_shard_dir: str | None = None
    # Delayed-label join window: a request unlabelled this long goes
    # through negative sampling.
    feedback_window_s: float = 60.0
    # Probability an expired, never-labelled request is emitted as a
    # label-0 example (0 = drop them all).
    feedback_negative_rate: float = 0.1
    # Joined examples a shard.
    feedback_shard_records: int = 1024
    # In-memory spool bound (importance-aware eviction past it).
    feedback_capacity: int = 100_000
    # Score-drift detector: served scores a PSI block, and the alert's
    # block-to-block PSI threshold.
    feedback_drift_block: int = 512
    feedback_drift_threshold: float = 0.25
    # Per-tenant token-bucket admission quotas of `launch route`:
    # "model=rate[:burst],..." (requests/s; burst defaults to 2*rate).  A
    # tenant over budget gets an explicit "ERR SHED tenant" reply, apart
    # from the capacity sheds.  None = no quotas.
    route_quota: str | None = None

    # ---- serving router (launch route / distlr_tpu_torch.serve.router) ----
    # Port 0 = OS-assigned ephemeral (announced as "ROUTING host:port").
    route_port: int = 0
    route_host: str = "127.0.0.1"
    # Admission control: in-flight request budget a replica; a request that
    # finds no replica with a free slot is shed with "ERR SHED".
    route_max_inflight: int = 64
    # Passive failure detection: consecutive transport failures before a
    # replica is ejected from rotation.
    route_eject_after: int = 3
    # Active health probes of in-rotation replicas with no recent traffic.
    route_health_interval_s: float = 1.0
    # Reinstatement probes of ejected replicas: exponential backoff from
    # base to max.
    route_probe_backoff_s: float = 0.5
    route_probe_backoff_max_s: float = 30.0
    # Per-exchange socket timeout toward replicas (connect + reply read).
    route_backend_timeout_s: float = 30.0

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
        if self.model not in _MODELS:
            raise ValueError(f"unknown model {self.model!r}")
        if self.block_size < 0 or (self.block_size == 0 and self.model != "blocked_lr"):
            raise ValueError(
                "block_size must be positive (0 = auto, blocked_lr only: "
                "resolved from raw-CTR data by suggest_block_size)")
        if self.block_groups < 0 or (self.block_groups > 0 and self.model != "blocked_lr"):
            raise ValueError(
                "block_groups is a blocked_lr option (0 = default "
                "ceil(fields/block_size) grouping; G = near-equal G-way "
                f"field split); got block_groups={self.block_groups} "
                f"with model={self.model!r}")
        if self.num_feature_dim <= 0:
            raise ValueError("num_feature_dim must be positive")
        if self.batch_size == 0 or self.batch_size < -1:
            raise ValueError("batch_size must be -1 (full shard) or positive")
        if self.feature_dtype not in ("float32", "bfloat16", "int8", "int8_dot"):
            raise ValueError(
                "feature_dtype must be float32|bfloat16|int8|int8_dot, "
                f"got {self.feature_dtype!r}")
        if self.feature_dtype == "int8_dot" and self.model not in ("binary_lr", "softmax"):
            raise ValueError(
                "feature_dtype='int8_dot' (native int8 contraction) "
                f"requires a dense model (binary_lr or softmax); "
                f"got model={self.model!r}")
        if self.model in _SPARSE_MODELS and self.feature_dtype != "float32":
            # sparse COO / blocked lane values stay float32 in every mode
            raise ValueError(
                "feature_dtype quantization applies to dense models only; "
                f"{self.model} stores feature values as float32 "
                "(set feature_dtype='float32')")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be float32|bfloat16, got {self.compute_dtype!r}")
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self._check_mesh()
        if self.num_servers < 1:
            raise ValueError("num_servers must be >= 1")
        if self.ps_compute_backend not in ("auto", "numpy", "cpu", "default"):
            raise ValueError("ps_compute_backend must be auto|numpy|cpu|default, "
                             f"got {self.ps_compute_backend!r}")
        if self.ps_timeout_ms < 0:
            raise ValueError(f"ps_timeout_ms must be >= 0 (0 = no timeout), got {self.ps_timeout_ms}")
        if self.obs_metrics_port is not None and not 0 <= self.obs_metrics_port < 1 << 16:
            raise ValueError("obs_metrics_port must be None (off) or in [0, 65536), "
                             f"got {self.obs_metrics_port}")
        if not 0.0 <= self.trace_sample <= 1.0:
            raise ValueError(
                f"trace_sample must be in [0, 1], got {self.trace_sample}")
        self._check_ps_wire()
        self._check_ps_store()
        if self.ps_retry_attempts < 0:
            raise ValueError(
                f"ps_retry_attempts must be >= 0 (0 = off), "
                f"got {self.ps_retry_attempts}"
            )
        if (self.ps_retry_backoff_ms < 0
                or self.ps_retry_backoff_max_ms < self.ps_retry_backoff_ms):
            raise ValueError(
                "need 0 <= ps_retry_backoff_ms <= ps_retry_backoff_max_ms, "
                f"got {self.ps_retry_backoff_ms}/{self.ps_retry_backoff_max_ms}"
            )
        if self.ps_retry_deadline_s <= 0:
            raise ValueError(
                f"ps_retry_deadline_s must be positive, "
                f"got {self.ps_retry_deadline_s}"
            )
        if self.checkpoint_interval < 0:
            raise ValueError(
                "checkpoint_interval must be >= 0 (epochs; 0 = only final save), "
                f"got {self.checkpoint_interval}")
        if self.prefetch < 1:
            raise ValueError("prefetch must be >= 1 (1 = no prefetch)")
        if self.ctr_fields < 0:
            raise ValueError("ctr_fields must be >= 0 (0 = read from manifest)")
        if not 0 <= self.hash_seed < 1 << 64:
            raise ValueError(f"hash_seed must be in [0, 2^64), got {self.hash_seed}")
        self._check_serve()

    def _check_ps_store(self) -> None:
        """The JAX package's checks of the durable store and the fault
        plan's seed, in its order and with its messages."""
        if self.ps_store_interval_s <= 0:
            raise ValueError(
                "ps_store_interval_s must be positive, "
                f"got {self.ps_store_interval_s}")
        if self.ps_store_wal_fsync_s <= 0:
            raise ValueError(
                "ps_store_wal_fsync_s must be positive, "
                f"got {self.ps_store_wal_fsync_s}")
        if self.ps_store_wal and not self.ps_store_dir:
            raise ValueError(
                "ps_store_wal requires ps_store_dir (the WAL lives in "
                "the same per-rank store directory)")
        if self.ps_store_wal and self.sync_mode:
            raise ValueError(
                "ps_store_wal requires async mode (sync_mode=False): "
                "sync-round merge state has no per-push replay semantics"
            )
        if self.chaos_seed is not None and not 0 <= self.chaos_seed < 1 << 64:
            raise ValueError(
                "chaos_seed must be None (use the plan's seed) or in "
                f"[0, 2^64), got {self.chaos_seed}")

    def _check_ps_wire(self) -> None:
        """The JAX package's checks of the servers' update rule, the wire
        codec and the accumulation, in its order and with its messages."""
        if self.ps_optimizer not in ("sgd", "ftrl"):
            raise ValueError(f"ps_optimizer must be sgd|ftrl, got {self.ps_optimizer!r}")
        if self.ps_optimizer == "ftrl" and self.sync_last_gradient:
            raise ValueError("ps_optimizer='ftrl' is incompatible with "
                             "sync_last_gradient (Q1 compat is an SGD parity quirk)")
        if self.ftrl_alpha <= 0:
            raise ValueError(f"ftrl_alpha must be positive, got {self.ftrl_alpha}")
        if self.ftrl_beta < 0 or self.ftrl_l1 < 0 or self.ftrl_l2 < 0:
            raise ValueError("ftrl_beta/ftrl_l1/ftrl_l2 must be >= 0, got "
                             f"{self.ftrl_beta}/{self.ftrl_l1}/{self.ftrl_l2}")
        if self.ps_compress not in ("none", "int8", "signsgd"):
            raise ValueError(f"ps_compress must be none|int8|signsgd, got {self.ps_compress!r}")
        if self.ps_compress != "none" and self.sync_last_gradient:
            raise ValueError("ps_compress is incompatible with sync_last_gradient "
                             "(Q1 compat pins the dense-SGD wire trajectory)")
        if self.ps_compress == "signsgd" and self.ps_optimizer != "sgd":
            raise ValueError("ps_compress='signsgd' replaces the server update rule "
                             "(the group runs --optimizer=signsgd); it is incompatible "
                             f"with ps_optimizer={self.ps_optimizer!r}")
        if self.ps_accum_start < 1 or self.ps_accum_max < self.ps_accum_start:
            raise ValueError("need 1 <= ps_accum_start <= ps_accum_max, got "
                             f"{self.ps_accum_start}/{self.ps_accum_max} "
                             "(raise --accum-max when setting --accum-start)")
        if self.ps_accum_growth < 1.0:
            raise ValueError(f"ps_accum_growth must be >= 1, got {self.ps_accum_growth}")
        if self.ps_accum_growth_every <= 0:
            raise ValueError("ps_accum_growth_every must be positive, "
                             f"got {self.ps_accum_growth_every}")

    def _check_mesh(self) -> None:
        if self.feature_shards < 1:
            raise ValueError(f"feature_shards must be >= 1, got {self.feature_shards}")
        if self.mesh_shape is None:
            s = self.feature_shards
        else:
            bad = set(self.mesh_shape) - {"data", "model"}
            if bad:
                raise ValueError(f"mesh_shape axes must be 'data' and 'model', got "
                                 f"{sorted(self.mesh_shape)}")
            if self.mesh_shape.get("data", 1) != self.num_workers:
                raise ValueError(
                    f"mesh_shape {self.mesh_shape} disagrees with num_workers="
                    f"{self.num_workers}; the port's data axis is num_workers row blocks a "
                    "process")
            s = int(self.mesh_shape.get("model", 1))
            if self.feature_shards not in (1, s):
                raise ValueError(f"feature_shards={self.feature_shards} disagrees with "
                                 f"mesh_shape {self.mesh_shape}")
        if s < 1:
            raise ValueError(f"the model axis must be >= 1, got {s}")
        if self.num_feature_dim % s:
            raise ValueError(
                f"num_features={self.num_feature_dim} must be divisible by the model-axis "
                f"size {s} (pad the feature dimension)")

    def _check_serve(self) -> None:
        if not 0 <= self.serve_port < 1 << 16:
            raise ValueError(f"serve_port must be in [0, 65536), got {self.serve_port}")
        if self.serve_max_batch_size <= 0:
            raise ValueError(
                f"serve_max_batch_size must be positive, got {self.serve_max_batch_size}")
        if self.serve_max_wait_ms < 0:
            raise ValueError(f"serve_max_wait_ms must be >= 0, got {self.serve_max_wait_ms}")
        if self.serve_reload_interval_s <= 0:
            raise ValueError(
                f"serve_reload_interval_s must be positive, got {self.serve_reload_interval_s}")
        if self.serve_engine_idle_evict_s < 0:
            raise ValueError("serve_engine_idle_evict_s must be >= 0 (0 = never evict), "
                             f"got {self.serve_engine_idle_evict_s}")
        if self.serve_hot_rows < 0:
            raise ValueError(f"serve_hot_rows must be >= 0 (0 = off), got {self.serve_hot_rows}")
        if not 0.0 < self.serve_hot_min_coverage <= 1.0:
            raise ValueError("serve_hot_min_coverage must be in (0, 1], "
                             f"got {self.serve_hot_min_coverage}")
        if self.serve_hot_full_every < 0:
            raise ValueError("serve_hot_full_every must be >= 0 (0 = coverage-driven "
                             f"only), got {self.serve_hot_full_every}")
        if not self.serve_model_id or any(c in self.serve_model_id for c in " \t@=,+"):
            raise ValueError("serve_model_id must be non-empty without any of "
                             f"' @=,+', got {self.serve_model_id!r}")
        self._check_feedback()
        self._check_route()

    def _check_feedback(self) -> None:
        """The JAX package's checks of the feedback options, with its
        messages."""
        if self.feedback_window_s <= 0:
            raise ValueError(f"feedback_window_s must be positive, got {self.feedback_window_s}")
        if not 0.0 <= self.feedback_negative_rate <= 1.0:
            raise ValueError("feedback_negative_rate must be in [0, 1], got "
                             f"{self.feedback_negative_rate}")
        if self.feedback_shard_records <= 0 or self.feedback_capacity <= 0:
            raise ValueError("feedback_shard_records and feedback_capacity must be positive, "
                             f"got {self.feedback_shard_records}/{self.feedback_capacity}")
        if self.feedback_drift_block <= 0 or self.feedback_drift_threshold <= 0:
            raise ValueError("feedback_drift_block and feedback_drift_threshold must be "
                             f"positive, got {self.feedback_drift_block}/"
                             f"{self.feedback_drift_threshold}")

    def _check_route(self) -> None:
        if not 0 <= self.route_port < 1 << 16:
            raise ValueError(f"route_port must be in [0, 65536), got {self.route_port}")
        if self.route_max_inflight <= 0:
            raise ValueError(
                f"route_max_inflight must be positive, got {self.route_max_inflight}")
        if self.route_eject_after < 1:
            raise ValueError(f"route_eject_after must be >= 1, got {self.route_eject_after}")
        if self.route_health_interval_s <= 0:
            raise ValueError("route_health_interval_s must be positive, "
                             f"got {self.route_health_interval_s}")
        if (self.route_probe_backoff_s <= 0
                or self.route_probe_backoff_max_s < self.route_probe_backoff_s):
            raise ValueError("need 0 < route_probe_backoff_s <= route_probe_backoff_max_s, "
                             f"got {self.route_probe_backoff_s}/{self.route_probe_backoff_max_s}")
        if self.route_backend_timeout_s <= 0:
            raise ValueError("route_backend_timeout_s must be positive, "
                             f"got {self.route_backend_timeout_s}")

    @classmethod
    def from_env(cls, env: Mapping[str, str] | None = None, **overrides: Any) -> "Config":
        """A Config from the reference's environment variables
        (``distlr_tpu/config.py`` ``from_env``); an absent one keeps the
        launcher default (the reference segfaults)."""
        env = os.environ if env is None else env
        kw: dict[str, Any] = dict(
            sync_mode=_env(env, "SYNC_MODE", _bool_from_int, True),
            learning_rate=_env(env, "LEARNING_RATE", float, 0.2),
            data_dir=_env(env, "DATA_DIR", str, "./a9a-data"),
            num_feature_dim=_env(env, "NUM_FEATURE_DIM", int, 123),
            num_iteration=_env(env, "NUM_ITERATION", int, 100),
            batch_size=_env(env, "BATCH_SIZE", int, -1),
            test_interval=_env(env, "TEST_INTERVAL", int, 10),
            random_seed=_env(env, "RANDOM_SEED", int, 10),
            l2_c=_env(env, "C", float, 1.0),
            num_workers=_env(env, "DMLC_NUM_WORKER", int, 1),
            num_servers=_env(env, "DMLC_NUM_SERVER", int, 1),
            ps_host=_env(env, "DMLC_PS_ROOT_URI", str, "127.0.0.1"),
            ps_port=_env(env, "DMLC_PS_ROOT_PORT", int, 8001),
        )
        kw.update(overrides)
        return cls(**kw)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
