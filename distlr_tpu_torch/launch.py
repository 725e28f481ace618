"""Command-line entry point of the port: ``gen-data``, ``sync``, ``eval``,
``ps``, ``ps-server``, ``ps-ctl``, ``chaos``, ``serve``, ``online``,
``route`` and ``rollout``.

Counterpart of ``distlr_tpu/launch.py``: every subcommand takes the
option strings its JAX twin takes, with the same dests, types and
defaults, plus ``--device`` (default ``cuda``; the CPU only when asked
for).  A flag whose use is not ported yet is accepted at its default and
raises ``NotImplementedError`` naming its ROADMAP item otherwise (the obs
flags A.12; the profiler, log and incident flags A.21), so a JAX command line never
fails at parse time and never drops a flag silently.  Run as ``python -m
distlr_tpu_torch.launch``::

    python -m distlr_tpu_torch.launch gen-data --data-dir D --num-feature-dim 123 \\
        --num-samples 2000 --num-parts 2
    python -m distlr_tpu_torch.launch sync --data-dir D --num-feature-dim 123 --num-workers 2
    python -m distlr_tpu_torch.launch eval --data-dir D --num-feature-dim 123 \\
        --model-file D/models/part-001

Every ``--model`` trains: ``binary_lr`` and ``softmax`` on dense libsvm
shards, ``sparse_lr`` / ``sparse_softmax`` on the same shards as padded
COO (``gen-data --ctr-fields F`` writes hashed CTR ones), ``blocked_lr``
on raw-CTR shards (``gen-data --ctr-fields F --ctr-raw``)::

    python -m distlr_tpu_torch.launch gen-data --data-dir C --num-feature-dim 4096 \\
        --ctr-fields 8 --ctr-raw --ctr-tuples 64 --num-samples 4000
    python -m distlr_tpu_torch.launch sync --data-dir C --num-feature-dim 4096 \\
        --model blocked_lr --block-size auto

``--feature-shards S`` cuts the features into S column blocks (the
feature-sharded step, the mesh ``{"data": num_workers, "model": S}``), for
``sync`` and ``eval``; ``--coordinator host:port --num-processes N
--process-id i`` runs one process of an N-process sync over
``torch.distributed`` (NCCL on the card, gloo with ``--device cpu``), whose
data axis spans the processes; each writes ``models/part-00{i+1}``::

    python -m distlr_tpu_torch.launch sync --data-dir D --num-feature-dim 124 \\
        --num-workers 2 --feature-shards 4
    python -m distlr_tpu_torch.launch sync --data-dir D --num-feature-dim 123 --device cpu \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0   # and 1

The dense models store their features as int8 with ``--feature-dtype
int8`` (or ``int8_dot``, which also quantizes w and the residuals), and
``sync`` saves checkpoints and resumes from the latest::

    python -m distlr_tpu_torch.launch sync --data-dir D --num-feature-dim 123 \\
        --feature-dtype int8 --checkpoint-dir K --checkpoint-interval 10 [--resume]

``ps`` trains every family on the parameter-server path: native KV server
processes on localhost and one worker thread per shard, sync BSP or
(``--async``) Hogwild; the keyed families (``sparse_lr``,
``sparse_softmax``, ``blocked_lr``) move only a batch's unique rows.
Each worker writes ``models/part-00{rank+1}``::

    python -m distlr_tpu_torch.launch ps --data-dir D --num-feature-dim 123 \\
        --num-workers 2 --num-servers 2 [--async] [--no-ps-pipeline]
    python -m distlr_tpu_torch.launch ps --data-dir C --num-feature-dim 4096 \\
        --model blocked_lr --block-size auto --num-workers 2 --num-servers 2

A PS run recovers from faults as the JAX package's does: rank 0
checkpoints (``--checkpoint-dir K --checkpoint-interval N``) and a crashed
job continues with ``--resume``; async workers retry transport faults in
place (``--ps-retry-attempts``) and restart (``--max-worker-restarts``),
and ``--supervise-servers`` respawns and re-seeds dead servers::

    python -m distlr_tpu_torch.launch ps --data-dir D --num-feature-dim 123 \\
        --num-workers 2 --num-servers 2 --checkpoint-dir K --checkpoint-interval 1 [--resume]
    python -m distlr_tpu_torch.launch ps --data-dir D --num-feature-dim 123 --async \\
        --supervise-servers --max-worker-restarts 2 --ps-retry-attempts 4

The servers' update rule is ``--ps-optimizer sgd|ftrl`` (``--ftrl-*``),
the gradients cross the wire as ``--ps-compress none|int8|signsgd``, and
``--accum-start/-growth/-growth-every/-max`` push the mean of a growing
span of batches.  ``ps-server`` hosts a group in the foreground (``HOSTS
h:p,...``; ``--namespaces v1:ftrl,v2`` hosts model namespaces, each with
its own optimizer) for workers that join it with ``ps --hosts``::

    python -m distlr_tpu_torch.launch ps-server --num-feature-dim 123 \\
        --num-servers 2 --num-workers 2 --ps-optimizer ftrl      # HOSTS h:p,h:p
    python -m distlr_tpu_torch.launch ps --data-dir D --num-feature-dim 123 \\
        --num-workers 2 --hosts h:p,h:p --ps-optimizer ftrl --ps-compress int8

``--store-dir S`` makes a group durable: each rank snapshots its slice
under ``S/rank-<r>/`` every ``--store-interval`` seconds and, with
``--store-wal`` (async only), logs every applied push; a rank started on
the directory recovers from it.  A durable or ``--elastic`` ``ps-server``
also prints ``PSCTL h:p``, the endpoint ``ps-ctl`` drives (``layout``,
``status``, ``store``, ``snapshot``, ``restore``, and ``resize N``, which
reshards an elastic async group live and which a durable group refuses);
``ps-ctl store --store-dir S`` reads a store offline.  ``serve --ps-ctl``
and ``online --ps-ctl`` follow the coordinator's layout through a
resize::

    python -m distlr_tpu_torch.launch ps-server --num-feature-dim 123 --async \\
        --store-dir S --store-wal                                # HOSTS ..., PSCTL h:p
    python -m distlr_tpu_torch.launch ps-ctl --ctl h:p snapshot
    python -m distlr_tpu_torch.launch ps-ctl store --store-dir S
    python -m distlr_tpu_torch.launch ps-server --num-feature-dim 123 --async \\
        --num-servers 2 --elastic                                # HOSTS ..., PSCTL h:p
    python -m distlr_tpu_torch.launch serve --num-feature-dim 123 --ps-ctl h:p
    python -m distlr_tpu_torch.launch ps-ctl --ctl h:p resize 4  # PSCTL {"ok": true, ...}

``chaos`` puts a JSON fault plan's proxies (delay, throttle, reset,
partition, kill) in front of a running group and prints their ``HOSTS``;
``ps --chaos-plan P`` does so for the group it spawns::

    python -m distlr_tpu_torch.launch chaos --upstreams h:p,h:p --plan P \\
        [--pids 123,124] [--events-path E]                       # HOSTS h:p,h:p

``serve`` scores libsvm lines over TCP with a trained model (every
family), reloading its weights from a watched checkpoint dir or a live KV
server group; it prints ``SERVING host:port`` when it listens and exits
143 on SIGTERM::

    python -m distlr_tpu_torch.launch serve --num-feature-dim 123 \
        --model-file D/models/part-001 [--checkpoint-dir K | --ps-hosts H] --port 0

``--model-file`` also takes a checkpoint directory (its latest step).
``--hot-rows N`` (with ``--ps-hosts``) refreshes only the requests' hot
rows between full refreshes.  One server hosts several model versions
with ``--model-id`` and ``--extra-model id=<model file>`` (or ``id=@ps``:
a live reloader over that id's namespace of the ``--ps-hosts`` group,
laid out by ``--ps-namespaces``)::

    python -m distlr_tpu_torch.launch serve --num-feature-dim 123 \\
        --model-file M1 --model-id v1 --extra-model v2=M2 --port 0

``--feedback-spool S`` closes the loop: the server journals every scored
request (``ID <rid> <features>`` lines carry the caller's id), joins
``LABEL <rid> <y>`` lines into shards under ``S/shards`` (or
``--feedback-shards``), and ``online`` trains on them into the live group
the server reloads from (FTRL from ``ps-server --async --ps-optimizer
ftrl``; it prints ``ONLINE ...`` and stops on SIGTERM)::

    python -m distlr_tpu_torch.launch online --num-feature-dim 123 --l2-c 0 \\
        --hosts H --shard-dir S/shards
    python -m distlr_tpu_torch.launch serve --num-feature-dim 123 --ps-hosts H \\
        --port 0 --feedback-spool S --feedback-window 1

``route`` load-balances the serving protocol over replicas (a model
registry ``v1=h:p+h:p,v2=h:p``, health checks, admission control, per
tenant quotas) and prints ``ROUTING host:port``; ``rollout`` ramps a
tenant's traffic onto a candidate through the router's ``SPLIT`` lines
and promotes it (exit 0), or rolls back when an alert fires (exit 3)::

    python -m distlr_tpu_torch.launch route --replicas v1=A+B,v2=A+B --quota v2=50
    python -m distlr_tpu_torch.launch rollout --router R --tenant v1 --candidate v2 \\
        --stages 0.5:10,1.0:10 --unwatched --journal-dir J
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from distlr_tpu_torch.config import Config, _not_ported
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_CONFIG_FIELDS = (
    "data_dir", "num_feature_dim", "num_iteration", "batch_size",
    "learning_rate", "l2_c", "test_interval", "model", "compat_mode",
    "random_seed", "prefetch", "feature_dtype", "num_workers", "device",
    "num_classes", "nnz_max", "block_size", "block_groups", "ctr_fields", "hash_seed",
    "checkpoint_dir", "checkpoint_interval", "profile_dir",
    "num_servers", "ps_compute_backend", "ps_timeout_ms", "ps_pipeline",
    "ps_optimizer", "ftrl_alpha", "ftrl_beta", "ftrl_l1", "ftrl_l2", "ps_compress",
    "ps_accum_start", "ps_accum_growth", "ps_accum_growth_every", "ps_accum_max",
    "ps_retry_attempts", "ps_retry_backoff_ms", "ps_retry_backoff_max_ms",
    "ps_retry_deadline_s", "ps_retry_adaptive",
    "ps_store_dir", "ps_store_interval_s", "ps_store_wal", "ps_store_wal_fsync_s",
    "chaos_plan", "chaos_seed", "sync_mode",
)

#: the JAX package's shared flags with no Config field in the port:
#: dest -> (flag, the JAX Config default, ROADMAP item).  Given with
#: another value, each one raises naming its item; the default is
#: accepted, so a JAX command line with defaults runs unchanged.
_GATED_SHARED_FLAGS = {
    "obs_metrics_port": ("--metrics-port", None, "A.12"),
    "obs_metrics_host": ("--metrics-host", "127.0.0.1", "A.12"),
    "obs_run_dir": ("--obs-run-dir", None, "A.12"),
    "obs_trace_path": ("--trace-path", None, "A.12"),
    "trace_sample": ("--trace-sample", 0.01, "A.12"),
    "prof_hz": ("--prof-hz", 19.0, "A.21"),
    "prof_window_s": ("--prof-window", 10.0, "A.21"),
    "log_level": ("--log-level", "info", "A.21"),
    "log_ring": ("--log-ring", 2048, "A.21"),
    "log_dedupe_s": ("--log-dedupe", 5.0, "A.21"),
    "incident_window_s": ("--incident-window", 120.0, "A.21"),
    "incident_settle_s": ("--incident-settle", 6.0, "A.21"),
    "incident_max": ("--incident-max", 32, "A.21"),
}


def _given(value, default) -> bool:
    """A flag was given with a value other than its default (None = not
    given; a switch that is off is not given)."""
    return value is not None and value is not False and value != default


def _refuse_gated(args: argparse.Namespace) -> None:
    """Raise naming the ROADMAP item of the first flag given whose use is
    not ported: the shared obs flags (A.12; on ``rollout``,
    ``--obs-run-dir`` is the aggregator's discovery, A.21) and the
    profiler, log and incident flags (A.21)."""
    cmd = getattr(args, "cmd", None)
    where = f"launch {cmd}" if cmd else "launch"
    for dest, (flag, default, item) in _GATED_SHARED_FLAGS.items():
        if _given(getattr(args, dest, None), default):
            if cmd == "rollout" and dest == "obs_run_dir":
                item = "A.21"
            raise _not_ported(f"{where} {flag}", item)


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    """The JAX package's shared flag set (``distlr_tpu/launch.py``
    ``_add_config_flags``) with its dests, types and defaults, less
    ``--feature-shards`` (:func:`_add_mesh_flags`) and the process flags
    (:func:`_add_process_flags`); plus ``--device``."""
    p.add_argument("--data-dir", dest="data_dir")
    p.add_argument("--num-feature-dim", dest="num_feature_dim", type=int)
    p.add_argument("--num-iteration", dest="num_iteration", type=int)
    p.add_argument("--batch-size", dest="batch_size", type=int)
    p.add_argument("--learning-rate", dest="learning_rate", type=float)
    p.add_argument("--l2-c", dest="l2_c", type=float)
    p.add_argument("--test-interval", dest="test_interval", type=int)
    p.add_argument("--model", choices=["binary_lr", "softmax", "sparse_lr",
                                       "sparse_softmax", "blocked_lr"],
                   help="model family (default binary_lr): dense binary_lr / "
                   "softmax, padded-COO sparse_lr / sparse_softmax, row-blocked "
                   "blocked_lr on raw-CTR shards")
    p.add_argument("--num-classes", dest="num_classes", type=int,
                   help="softmax families: number of classes (default 2)")
    p.add_argument("--nnz-max", dest="nnz_max", type=int,
                   help="sparse families: cap per-row nonzeros (pad width)")
    p.add_argument("--block-size", dest="block_size",
                   type=lambda s: 0 if s == "auto" else int(s),
                   help="blocked_lr: lanes per table row (table rows = "
                   "num-feature-dim / block-size); 'auto' samples the raw "
                   "shards and picks the cheapest layout whose groups recur "
                   "(honors a pinned --block-groups)")
    p.add_argument("--block-groups", dest="block_groups", type=int,
                   help="blocked_lr: hash the fields into this many conjunction "
                   "groups instead of ceil(fields/block-size) chunks")
    p.add_argument("--ctr-fields", dest="ctr_fields", type=int,
                   help="blocked_lr: raw categorical fields per row "
                   "(default: read from the data dir's ctr_meta.json)")
    p.add_argument("--hash-seed", dest="hash_seed", type=int,
                   help="seed of the load-time feature hash")
    p.add_argument("--compat-mode", dest="compat_mode", choices=["correct", "reference"])
    p.add_argument("--random-seed", dest="random_seed", type=int,
                   help="seed of the uniform weight init (default 10)")
    p.add_argument("--prefetch", dest="prefetch", type=int,
                   help="host->device streaming depth in Trainer.fit "
                   "(default 2 = double buffering; 1 = strictly serial)")
    p.add_argument("--ps-timeout", dest="ps_timeout_ms", type=int,
                   help="receive timeout of every KV op, ms (default 600000; 0 = none)")
    p.add_argument("--feature-dtype", dest="feature_dtype",
                   choices=["float32", "bfloat16", "int8", "int8_dot"],
                   help="device-resident storage dtype for dense features "
                   "(bfloat16 halves the bytes the step reads; int8: symmetric "
                   "per-dataset quantization, a quarter of float32's bytes; "
                   "int8_dot: int8 storage plus w and the residuals quantized "
                   "per step, int8 x int8 products; dense models only)")
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir",
                   help="sync and ps: save the weights and the epoch here (numpy .npz a "
                   "step; ps also writes the sidecar ps_latest.json); serve: watch this "
                   "checkpoint dir and serve each new step")
    p.add_argument("--checkpoint-interval", dest="checkpoint_interval", type=int,
                   help="epochs between checkpoints (default 0: only the final one)")
    p.add_argument("--profile-dir", dest="profile_dir",
                   help="trace the run into this directory (not ported yet: refused)")
    # the obs, profiler, log and incident flags: refused when given
    # (_GATED_SHARED_FLAGS)
    for flag, dest, typ in (("--metrics-port", "obs_metrics_port", int),
                            ("--metrics-host", "obs_metrics_host", None),
                            ("--trace-path", "obs_trace_path", None),
                            ("--trace-sample", "trace_sample", float),
                            ("--prof-hz", "prof_hz", float),
                            ("--prof-window", "prof_window_s", float),
                            ("--log-ring", "log_ring", int),
                            ("--log-dedupe", "log_dedupe_s", float),
                            ("--incident-window", "incident_window_s", float),
                            ("--incident-settle", "incident_settle_s", float),
                            ("--incident-max", "incident_max", int)):
        p.add_argument(flag, dest=dest, type=typ,
                       help=f"not ported yet (ROADMAP {_GATED_SHARED_FLAGS[dest][2]})")
    p.add_argument("--obs-run-dir", dest="obs_run_dir", action="append",
                   help="not ported yet (ROADMAP A.12; on rollout A.21)")
    p.add_argument("--log-level", dest="log_level", choices=["debug", "info", "warning", "error"],
                   help="not ported yet (ROADMAP A.21)")
    p.add_argument("--resume", action="store_true",
                   help="sync: restart from the latest checkpoint in --checkpoint-dir; "
                   "ps: from the step its sidecar names, against a surviving group or "
                   "a fresh one")
    p.add_argument("--num-workers", dest="num_workers", type=int,
                   help="data-parallel shards, as row blocks of one batch")
    p.add_argument("--num-servers", dest="num_servers", type=int,
                   help="KV server processes, one key range each (default 1)")
    p.add_argument("--ps-retry-attempts", dest="ps_retry_attempts", type=int,
                   help="in-place retry of transient KV transport faults: total tries an "
                   "op (default 0 = fail fast); async workers, the online trainer and "
                   "serving pulls reconnect and re-issue, sync BSP pushes never")
    p.add_argument("--ps-retry-backoff", dest="ps_retry_backoff_ms", type=float,
                   help="base backoff between retries, ms (default 50)")
    p.add_argument("--ps-retry-backoff-max", dest="ps_retry_backoff_max_ms", type=float,
                   help="backoff cap, ms (default 2000)")
    p.add_argument("--ps-retry-deadline", dest="ps_retry_deadline_s", type=float,
                   help="an op's wall deadline across its retries, seconds (default 60)")
    _add_ps_wire_flags(p)
    p.add_argument("--ps-retry-adaptive", dest="ps_retry_adaptive", action="store_true",
                   default=None, help="scale the retry backoff base by the recent "
                   "transport-fault rate (up to 8x, decaying when quiet)")
    p.add_argument("--store-dir", dest="ps_store_dir",
                   help="durable server store: each rank snapshots its slice under "
                   "<dir>/rank-<r>/ and recovers from it at start (a restart on the same "
                   "dir resumes the group)")
    p.add_argument("--store-interval", dest="ps_store_interval_s", type=float,
                   help="seconds between store snapshots (default 5)")
    p.add_argument("--store-wal", dest="ps_store_wal", action="store_true", default=None,
                   help="with --store-dir: log every applied push and replay it at start "
                   "(RPO ~0; async only)")
    p.add_argument("--store-wal-fsync", dest="ps_store_wal_fsync_s", type=float,
                   help="WAL group-commit window, seconds (default 0.1)")
    p.add_argument("--ps-compute-backend", dest="ps_compute_backend",
                   choices=["auto", "numpy", "cpu", "default"],
                   help="where PS workers run their gradient and eval steps: auto and "
                   "default take --device; numpy (host) and cpu (torch) on request")
    p.add_argument("--cpu-devices", dest="cpu_devices", type=int,
                   help="N > 0 runs on the CPU (env twin DISTLR_CPU_DEVICES).  The JAX "
                   "package simulates an N-device CPU mesh with it; here every row and "
                   "column block shares one device, so N only selects the CPU")
    p.add_argument("--device", dest="device",
                   help="cuda (default), cuda:N or cpu")


def _add_ps_wire_flags(p: argparse.ArgumentParser) -> None:
    """The servers' update rule, the gradient wire codec and the
    accumulation: JAX's names, types and defaults."""
    p.add_argument("--ps-optimizer", dest="ps_optimizer", choices=["sgd", "ftrl"],
                   help="server-side update rule of gradient pushes: sgd (the reference "
                   "w -= lr*g, default) or ftrl (per-coordinate FTRL-Proximal with z/n "
                   "accumulators and --ftrl-l1 sparsification)")
    p.add_argument("--ftrl-alpha", dest="ftrl_alpha", type=float,
                   help="FTRL per-coordinate learning-rate scale (default 0.1)")
    p.add_argument("--ftrl-beta", dest="ftrl_beta", type=float,
                   help="FTRL learning-rate smoothing (default 1.0)")
    p.add_argument("--ftrl-l1", dest="ftrl_l1", type=float,
                   help="FTRL L1 strength, sparsifies server weights (default 0)")
    p.add_argument("--ftrl-l2", dest="ftrl_l2", type=float, help="FTRL L2 strength (default 0)")
    p.add_argument("--ps-compress", dest="ps_compress", choices=["none", "int8", "signsgd"],
                   help="gradient wire codec of PS pushes, negotiated a connection (a group "
                   "that does not advertise it gets dense f32): int8 = block-quantized "
                   "values with f32 scales (sgd/ftrl), signsgd = 1 bit a coordinate and the "
                   "servers' majority vote (the group runs --optimizer=signsgd; use a "
                   "signSGD-scale --learning-rate).  Default none: the wire is unchanged")
    p.add_argument("--accum-start", dest="ps_accum_start", type=int,
                   help="AdaBatch local accumulation: initial batches a push (default 1)")
    p.add_argument("--accum-growth", dest="ps_accum_growth", type=float,
                   help="multiply the accumulation span by this every --accum-growth-every "
                   "pushes (default 2)")
    p.add_argument("--accum-growth-every", dest="ps_accum_growth_every", type=int,
                   help="pushes between accumulation-span growths (default 32)")
    p.add_argument("--accum-max", dest="ps_accum_max", type=int,
                   help="accumulation span cap (default 1 = accumulation off)")


def _add_mesh_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--feature-shards", dest="feature_shards", type=int,
                   help="model-axis size: >1 cuts the features into this many column "
                   "blocks (the 2D feature-sharded step; num-feature-dim must divide)")


def _add_process_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--coordinator", help="host:port of process 0: the tcp:// rendezvous of "
                   "torch.distributed (NCCL on the card, gloo with --device cpu)")
    p.add_argument("--num-processes", dest="num_processes", type=int,
                   help="processes of the run (with --coordinator)")
    p.add_argument("--process-id", dest="process_id", type=int,
                   help="this process's rank, 0 .. num-processes - 1 (with --coordinator)")


def _config_from_args(args: argparse.Namespace) -> Config:
    """The Config of the flags given, with ``--block-size auto`` resolved
    from the data dir's raw shards (blocked_lr).  A flag whose use is not
    ported raises naming its ROADMAP item first."""
    _refuse_gated(args)
    over = {k: v for k, v in vars(args).items() if v is not None and k in _CONFIG_FIELDS}
    if _cpu_devices(args):
        over["device"] = "cpu"
    cfg = Config(**over)
    if getattr(args, "feature_shards", None):
        cfg = cfg.replace(mesh_shape={"data": cfg.num_workers, "model": args.feature_shards},
                          feature_shards=args.feature_shards)
    if cfg.model != "blocked_lr" or cfg.block_size != 0:
        return cfg
    from distlr_tpu_torch.data.hashing import resolve_auto_block_size  # noqa: PLC0415

    r, g = resolve_auto_block_size(cfg.data_dir, cfg.ctr_fields, cfg.num_feature_dim,
                                   num_groups=cfg.block_groups)
    if r == 1:
        log.info("block_size auto: resolved to scalar-equivalent R=1 (no candidate "
                 "layout%s passed the recurrence/row-load gates on this data)",
                 f" at block_groups={cfg.block_groups}" if cfg.block_groups else "")
    else:
        log.info("block_size auto: resolved to R=%d, %s", r,
                 f"{g} conjunction groups" if g else "default field grouping")
    return cfg.replace(block_size=r, block_groups=g)


def _cpu_devices(args: argparse.Namespace) -> int:
    """``--cpu-devices``, else its env twin ``DISTLR_CPU_DEVICES`` (0 when
    neither is given); the flag, even an explicit 0, wins."""
    n = getattr(args, "cpu_devices", None)
    if n is not None:
        return n
    raw = os.environ.get("DISTLR_CPU_DEVICES", "")
    try:
        return int(raw) if raw else 0
    except ValueError:
        raise SystemExit(f"DISTLR_CPU_DEVICES must be an integer, got {raw!r}") from None


@contextlib.contextmanager
def _process_group(args: argparse.Namespace, cfg: Config):
    """Join the ``torch.distributed`` run of ``--coordinator`` (a no-op
    without it) for the command's length: NCCL on a card, gloo on the CPU,
    never the one in place of the other.  Yields the Config, whose device
    is this process's card (``cuda:<rank mod cards>`` for ``cuda``)."""
    if not args.coordinator:
        if args.num_processes is not None or args.process_id is not None:
            raise SystemExit("error: --num-processes/--process-id need --coordinator")
        yield cfg
        return
    if args.num_processes is None or args.process_id is None:
        raise SystemExit("error: --coordinator needs --num-processes and --process-id")
    if not 0 <= args.process_id < args.num_processes:
        raise SystemExit(f"error: --process-id {args.process_id} is not in "
                         f"[0, {args.num_processes})")
    import torch  # noqa: PLC0415
    import torch.distributed as dist  # noqa: PLC0415

    from distlr_tpu_torch.utils.device import resolve_device  # noqa: PLC0415

    if cfg.device == "cuda" and torch.cuda.is_available():
        cfg = cfg.replace(device=f"cuda:{args.process_id % torch.cuda.device_count()}")
    device = resolve_device(cfg.device)
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{args.coordinator}",
                            world_size=args.num_processes, rank=args.process_id, **kw)
    log.info("joined distributed run: process %s of %s (%s)", args.process_id,
             args.num_processes, dist.get_backend())
    try:
        yield cfg
    finally:
        dist.destroy_process_group()


def _ps_config(args: argparse.Namespace) -> Config:
    """``ps`` and ``ps-server``: ``--async`` is the Config's ``sync_mode``,
    folded in before the Config validates (``--store-wal`` needs it)."""
    if args.asynchronous:
        args.sync_mode = False
    return _config_from_args(args)


def _serve_config(args: argparse.Namespace) -> Config:
    """``serve``: the serving and feedback flags on top of the shared ones
    (``distlr_tpu/launch.py`` ``cmd_serve``'s ``serve_over``)."""
    serve_over = {
        "serve_port": args.port, "serve_host": args.bind,
        "serve_max_batch_size": args.serve_max_batch_size,
        "serve_max_wait_ms": args.max_wait_ms,
        "serve_reload_interval_s": args.reload_interval,
        "serve_engine_idle_evict_s": args.engine_idle_evict,
        "serve_hot_rows": args.hot_rows,
        "serve_hot_min_coverage": args.hot_min_coverage,
        "serve_hot_full_every": args.hot_full_every,
        "serve_model_id": args.model_id,
        "feedback_spool_dir": args.feedback_spool,
        "feedback_shard_dir": args.feedback_shards,
        "feedback_window_s": args.feedback_window,
        "feedback_negative_rate": args.feedback_negative_rate,
        "feedback_shard_records": args.feedback_shard_records,
        "feedback_capacity": args.feedback_capacity,
        "feedback_drift_block": args.drift_block,
        "feedback_drift_threshold": args.drift_threshold,
    }
    return _config_from_args(args).replace(
        **{k: v for k, v in serve_over.items() if v is not None})


def _route_config(args: argparse.Namespace) -> Config:
    route_over = {
        "route_port": args.port, "route_host": args.bind,
        "route_max_inflight": args.max_inflight,
        "route_eject_after": args.eject_after,
        "route_health_interval_s": args.health_interval,
        "route_probe_backoff_s": args.probe_backoff,
        "route_probe_backoff_max_s": args.probe_backoff_max,
        "route_backend_timeout_s": args.backend_timeout,
        "route_quota": args.quota,
    }
    return _config_from_args(args).replace(
        **{k: v for k, v in route_over.items() if v is not None})


def _online_config(args: argparse.Namespace) -> Config:
    """``online``: growing accumulation is on by default (``--accum-max``
    64, as the JAX package's ``cmd_online`` sets it; Config keeps 1)."""
    if args.ps_accum_max is None:
        args.ps_accum_max = 64
    return _config_from_args(args)


def command_config(args: argparse.Namespace) -> Config:
    """The Config the parsed subcommand ``args`` runs with, built as the
    command builds it, its gates applied (they raise naming a ROADMAP
    item)."""
    return {"ps": _ps_config, "ps-server": _ps_config, "serve": _serve_config,
            "route": _route_config, "online": _online_config}.get(
                args.cmd, _config_from_args)(args)


def _gen_data_error(args: argparse.Namespace) -> str | None:
    if args.ctr_raw and not args.ctr_fields:
        return "--ctr-raw requires --ctr-fields"
    if args.ctr_tuples < 0:
        return "--ctr-tuples must be non-negative (0 disables the tuple table)"
    if args.ctr_tuples and not args.ctr_raw:
        return ("--ctr-tuples requires --ctr-raw (the pre-hashed one-hot "
                "writer has no tuple-table mode)")
    if args.ctr_fields and (args.num_classes != 2 or args.sparsity != 0.5):
        return ("--num-classes/--sparsity do not apply to CTR shards "
                "(--ctr-fields writes binary-label CTR data)")
    return None


def cmd_gen_data(args: argparse.Namespace) -> int:
    from distlr_tpu_torch.data import hashing, synthetic  # noqa: PLC0415

    err = _gen_data_error(args)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    if args.ctr_raw:
        # raw categorical shards: the blocked_lr format, hashed at load time
        manifest = hashing.write_raw_ctr_shards(
            args.data_dir, args.num_samples, args.ctr_fields, args.ctr_vocab,
            args.num_parts, seed=args.seed, num_distinct_tuples=args.ctr_tuples or None)
    elif args.ctr_fields:
        # hashed one-hot CTR shards: num-feature-dim is the bucket count
        manifest = hashing.write_ctr_shards(
            args.data_dir, args.num_samples, args.ctr_fields, args.ctr_vocab,
            args.num_feature_dim, args.num_parts, seed=args.seed)
    else:
        manifest = synthetic.write_synthetic_shards(
            args.data_dir, args.num_samples, args.num_feature_dim, args.num_parts,
            seed=args.seed, num_classes=args.num_classes, sparsity=args.sparsity)
    log.info("wrote %d train shards + test to %s", len(manifest["train_parts"]), args.data_dir)
    return 0


def cmd_sync(args: argparse.Namespace) -> int:
    from distlr_tpu_torch.train import Trainer  # noqa: PLC0415

    with _process_group(args, _config_from_args(args)) as cfg:
        trainer = Trainer(cfg).load_data()
        trainer.fit(resume=args.resume)
        path = trainer.save_model()
        log.info(
            "final accuracy %.4f, %.0f samples/sec, model -> %s",
            trainer.evaluate(), trainer.timer.samples_per_sec, path,
        )
    return 0


def cmd_eval(args: argparse.Namespace) -> int:
    """Score a saved text model against a data dir's test split."""
    from distlr_tpu_torch.convert import params_from_jax  # noqa: PLC0415
    from distlr_tpu_torch.train import Trainer  # noqa: PLC0415
    from distlr_tpu_torch.train.export import load_model_text  # noqa: PLC0415

    cfg = _config_from_args(args)
    trainer = Trainer(cfg).load_data(test_only=cfg.feature_dtype == "float32")
    w = load_model_text(args.model_file, shape=trainer.model.param_shape)
    trainer.weights = params_from_jax(w, trainer.model, trainer.device)
    m = trainer.evaluate_metrics()
    print(f"accuracy: {m['accuracy']:.4f}  test_logloss: {m['logloss']:.5f}")
    return 0


def cmd_ps(args: argparse.Namespace) -> int:
    """Parameter-server training: spawn the servers here and run every
    worker rank, or (``--hosts``) join a running group with some ranks."""
    from distlr_tpu_torch.train.ps_trainer import run_ps_local, run_ps_workers  # noqa: PLC0415

    cfg = _ps_config(args)
    if args.hosts:
        if args.supervise_servers:
            print("error: --supervise-servers applies to local mode (the "
                  "server host owns its processes; supervise there)",
                  file=sys.stderr)
            return 2
        if cfg.chaos_plan:
            print("error: --chaos-plan applies to local mode (it wraps "
                  "the spawned server group); to fault-inject a remote "
                  "group, run `launch chaos --upstreams ...` and point "
                  "--hosts at the proxied ports", file=sys.stderr)
            return 2
        ranks = ([int(r) for r in args.worker_ranks.split(",")] if args.worker_ranks
                 else range(cfg.num_workers))
        run_ps_workers(cfg, args.hosts, ranks, save=True, resume=args.resume,
                       max_restarts=args.max_worker_restarts)
    elif args.worker_ranks:
        print("error: --worker-ranks requires --hosts (local mode runs every rank)",
              file=sys.stderr)
        return 2
    elif args.supervise_servers and cfg.sync_mode:
        print("error: --supervise-servers requires --async (sync BSP "
              "state cannot be reconstructed; use --checkpoint-dir + "
              "--resume)", file=sys.stderr)
        return 2
    else:
        run_ps_local(cfg, save=True, resume=args.resume,
                     max_restarts=args.max_worker_restarts,
                     supervise_servers=args.supervise_servers)
    return 0


def cmd_ps_server(args: argparse.Namespace) -> int:
    """Host a KV server group in the foreground (the reference's
    ``DMLC_ROLE=server`` processes, ``examples/local.sh:36-41``; the
    rendezvous is TCP, there is no scheduler): it prints ``HOSTS h:p,...``
    (and ``NAMESPACES id=base,... per_dim=D`` with ``--namespaces``; and
    ``PSCTL host:port``, the coordinator endpoint ``ps-ctl`` drives, with
    ``--elastic`` or ``--store-dir``), then waits until a worker retires
    the group, through any live resize.  SIGTERM stops every server and
    exits 143."""
    import signal  # noqa: PLC0415

    from distlr_tpu_torch.ps import (  # noqa: PLC0415
        ServerGroup,
        namespace_layout,
        parse_namespace_optimizers,
    )
    from distlr_tpu_torch.train.ps_trainer import ps_param_dim, server_optimizer  # noqa: PLC0415

    # a terminated foreground group must not orphan its servers: SIGTERM
    # becomes SystemExit, so the group's context manager stops them
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    cfg = _ps_config(args)
    ports = [int(s) for s in args.ports.split(",")] if args.ports else None
    if ports and len(ports) != cfg.num_servers:
        print(f"error: {len(ports)} ports for {cfg.num_servers} servers", file=sys.stderr)
        return 2
    # model namespaces: one group hosts N models as contiguous slices of an
    # N-times-larger key space; an entry's ":opt" gives its slice an update
    # rule of its own (the group spawns with --opt_segments)
    layout, opt_segments = None, None
    per_dim = total_dim = ps_param_dim(cfg)
    if args.namespaces:
        layout = namespace_layout(args.namespaces, per_dim)
        total_dim = per_dim * len(layout)
        try:
            ns_opts = parse_namespace_optimizers(args.namespaces)
        except ValueError as e:
            print(f"error: bad --namespaces: {e}", file=sys.stderr)
            return 2
        if ns_opts:
            default_opt = server_optimizer(cfg)
            if default_opt == "signsgd":
                print("error: per-namespace optimizers are incompatible with signsgd groups "
                      "(sign votes only mean majority-vote through a uniform group)",
                      file=sys.stderr)
                return 2
            opt_segments = [(base + d, ns_opts.get(m, default_opt))
                            for m, (base, d) in layout.items()]
    if args.elastic and cfg.sync_mode:
        print("error: --elastic requires --async (a sync BSP round "
              "cannot straddle a membership change)", file=sys.stderr)
        return 2
    group = ServerGroup(cfg.num_servers, cfg.num_workers, total_dim,
                        learning_rate=cfg.learning_rate, sync=cfg.sync_mode,
                        last_gradient=bool(cfg.sync_last_gradient), ports=ports, bind_any=True,
                        optimizer=server_optimizer(cfg), ftrl_alpha=cfg.ftrl_alpha,
                        ftrl_beta=cfg.ftrl_beta, ftrl_l1=cfg.ftrl_l1, ftrl_l2=cfg.ftrl_l2,
                        opt_segments=opt_segments, store_dir=cfg.ps_store_dir,
                        store_interval_s=cfg.ps_store_interval_s, store_wal=cfg.ps_store_wal,
                        store_wal_fsync_s=cfg.ps_store_wal_fsync_s)
    ctl = None
    try:
        with group:
            # workers pass this, with this host's address for 127.0.0.1, as --hosts
            print(f"HOSTS {group.hosts}", flush=True)
            if layout is not None:
                print("NAMESPACES " + ",".join(f"{m}={b}" for m, (b, _) in layout.items())
                      + f" per_dim={per_dim}", flush=True)
            if args.elastic or cfg.ps_store_dir:
                # the coordinator endpoint, driven by `launch ps-ctl` and
                # polled by clients' route providers: LAYOUT / STATUS /
                # RESIZE, and STORE / SNAPSHOT / RESTORE for a durable group
                # (which refuses RESIZE)
                from distlr_tpu_torch.ps.membership import (  # noqa: PLC0415
                    MembershipCoordinator,
                    MembershipServer,
                )

                ctl = MembershipServer(MembershipCoordinator(group), host="0.0.0.0",
                                       port=args.ctl_port or 0).start()
                print(f"PSCTL {ctl.host}:{ctl.port}", flush=True)
            group.wait()
    except KeyboardInterrupt:
        return 130  # interrupted, not a worker-driven shutdown
    finally:
        if ctl is not None:
            ctl.stop()
    return 0


def cmd_ps_ctl(args: argparse.Namespace) -> int:
    """The admin CLI of a group's coordinator (:mod:`distlr_tpu_torch.ps.
    membership`): ``layout``, ``status``, ``store``, ``snapshot``,
    ``restore`` and ``resize N [--no-wait]`` against the ``PSCTL
    host:port`` an elastic or durable ``ps-server`` announced, or ``store
    --store-dir S`` offline.  Prints
    ``PSCTL <json reply>``; exits 3 when the coordinator refused."""
    import json  # noqa: PLC0415

    from distlr_tpu_torch.ps.membership import ctl_request  # noqa: PLC0415

    if args.command == "store" and args.store_dir:
        # offline: the files themselves, when no coordinator is alive (a
        # torn or corrupt file is described, never raised)
        import time  # noqa: PLC0415

        from distlr_tpu_torch.ps import store  # noqa: PLC0415

        try:
            doc = store.inspect_store(args.store_dir, now=time.time())
        except store.StoreError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(f"PSCTL {json.dumps(doc)}", flush=True)
        return 0
    if not args.ctl:
        print("error: --ctl host:port required (or `store --store-dir "
              "<dir>` for offline inspection)", file=sys.stderr)
        return 2
    if args.command == "resize":
        if args.n is None or args.n < 1:
            print("error: resize needs a target server count "
                  "(ps-ctl --ctl host:port resize N)", file=sys.stderr)
            return 2
        line = f"RESIZE {args.n}" + (" wait=0" if args.no_wait else "")
    else:
        line = args.command.upper()
    try:
        doc = ctl_request(args.ctl, line)
    except (OSError, ValueError) as e:
        print(f"error: ps-ctl at {args.ctl}: {e}", file=sys.stderr)
        return 1
    print(f"PSCTL {json.dumps(doc)}", flush=True)
    return 0 if doc.get("ok", True) else 3


def cmd_chaos(args: argparse.Namespace) -> int:
    """A fault-injection proxy fabric (:mod:`distlr_tpu_torch.chaos`) in
    front of a running KV server group: one proxied port an upstream,
    announced as ``HOSTS <proxied>``; point workers, servers and watchers
    at those and the whole run rides the JSON fault plan.  ``--pids`` (the
    servers' pids in rank order) arms the plan's ``kill`` faults.  At exit
    the deterministic event log goes to ``--events-path``.  SIGTERM exits
    143."""
    import json  # noqa: PLC0415
    import signal  # noqa: PLC0415

    from distlr_tpu_torch.chaos import ChaosFabric, FaultPlanError, load_plan  # noqa: PLC0415

    _config_from_args(args)  # the shared flags' gates
    killer = None
    if args.pids:
        try:
            pids = [int(p) for p in args.pids.split(",") if p.strip()]
        except ValueError:
            print(f"error: --pids must be a comma-separated pid list, "
                  f"got {args.pids!r}", file=sys.stderr)
            return 2

        def killer(target: str) -> None:
            victims = pids if target == "group" else pids[int(target.split(":", 1)[1]):][:1]
            if not victims:
                log.warning("chaos kill target %r: no such pid", target)
            for pid in victims:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass  # already dead: a kill is idempotent

    try:
        plan = load_plan(args.plan, seed=args.seed)
        fabric = ChaosFabric(args.upstreams, plan, protocol=args.protocol, killer=killer)
    except (OSError, FaultPlanError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        with fabric:
            print(f"HOSTS {fabric.hosts}", flush=True)
            for lk in fabric.links:
                log.info("chaos link %d: 127.0.0.1:%d -> %s:%d", lk.link, lk.port,
                         *lk.upstream)
            while True:
                signal.pause()
    except KeyboardInterrupt:
        return 130
    finally:
        doc = fabric.events_doc()
        log.info("chaos: %d fault events injected", len(doc["events"]))
        if args.events_path:
            with open(args.events_path, "w") as f:
                json.dump(doc, f, indent=1)
            log.info("chaos event log -> %s (schema %d)", args.events_path, doc["schema"])


def _serve_row_width(cfg: Config) -> int:
    """Flat KV slots one engine row key owns in serving pulls; it must
    match the key space ``ScoringEngine.row_keys`` feeds the hot tracker:
    blocked rows own ``block_size`` lanes, and both softmax families
    (``ps_param_dim`` flattens the (D, K) matrix row-major) own
    ``num_classes`` slots a feature key."""
    if cfg.model == "blocked_lr":
        return cfg.block_size
    if cfg.model in ("softmax", "sparse_softmax"):
        return cfg.num_classes
    return 1


def cmd_serve(args: argparse.Namespace) -> int:
    """Scoring front-end over a trained model: batched scoring behind the
    TCP line protocol, with hot weight reload from a checkpoint dir or a
    live KV server group (a trainer and this server can share the group:
    ``launch ps --async`` + ``launch serve --ps-hosts ...``)."""
    import signal  # noqa: PLC0415

    from distlr_tpu_torch.serve import (  # noqa: PLC0415
        CheckpointWatcher,
        HotReloader,
        HotSetTracker,
        LivePSWatcher,
        ScoringEngine,
        ScoringServer,
    )
    from distlr_tpu_torch.ps import RetryPolicy  # noqa: PLC0415
    from distlr_tpu_torch.train.export import load_weights  # noqa: PLC0415
    from distlr_tpu_torch.train.ps_trainer import ps_param_dim  # noqa: PLC0415

    live_ps = bool(args.ps_hosts or args.ps_ctl)
    if not (args.model_file or args.checkpoint_dir or live_ps):
        print("error: serve needs a weight source: --model-file and/or --checkpoint-dir "
              "(watched) or --ps-hosts / --ps-ctl (live pull)", file=sys.stderr)
        return 2
    if args.model == "blocked_lr" and args.block_size == 0 and not os.path.isdir(
            args.data_dir or Config.data_dir):
        print("error: blocked_lr serving needs the trained (R, groups) pinned "
              "(--block-size/--block-groups), or a --data-dir to re-resolve 'auto' from",
              file=sys.stderr)
        return 2
    cfg = _serve_config(args)
    if cfg.serve_hot_rows and not live_ps:
        print("error: --hot-rows applies to live-PS reload only (--ps-hosts / --ps-ctl); "
              "checkpoint/model-file sources always load the full table", file=sys.stderr)
        return 2
    ps_route = None
    if args.ps_ctl:
        # an elastic group: the serving pulls follow the coordinator's
        # layout, so a live reshard costs the watcher one re-route in a poll
        from distlr_tpu_torch.ps.membership import layout_client  # noqa: PLC0415

        ps_route = layout_client(args.ps_ctl)
    # which slice of a shared PS group's key space each model id owns (the
    # order of the group's namespaces spec)
    ns_layout = None
    if args.ps_namespaces:
        if not live_ps:
            print("error: --ps-namespaces applies to live-PS reload only "
                  "(--ps-hosts / --ps-ctl)", file=sys.stderr)
            return 2
        from distlr_tpu_torch.ps import namespace_layout  # noqa: PLC0415

        ns_layout = namespace_layout(args.ps_namespaces, ps_param_dim(cfg))

    def _ns(model_id: str) -> tuple[int, int | None]:
        if ns_layout is None:
            return 0, None
        if model_id not in ns_layout:
            raise SystemExit(f"error: model {model_id!r} not in --ps-namespaces "
                             f"{sorted(ns_layout)}")
        return ns_layout[model_id][0], ps_param_dim(cfg) * len(ns_layout)

    hot_tracker = retry = None
    if live_ps:
        if cfg.serve_hot_rows:
            hot_tracker = HotSetTracker(cfg.serve_hot_rows)
        base, total = _ns(args.ps_namespace or cfg.serve_model_id)
        # serving pulls are idempotent, so the whole policy applies: a PS
        # blip mid-poll is retried inside the poll, and an exhausted policy
        # keeps the last good weights serving
        retry = RetryPolicy.from_config(cfg)
        source = LivePSWatcher(args.ps_hosts, ps_param_dim(cfg),
                               vals_per_key=_serve_row_width(cfg), hot_tracker=hot_tracker,
                               min_coverage=cfg.serve_hot_min_coverage,
                               full_refresh_every=cfg.serve_hot_full_every,
                               retry=retry, ns_base=base, ns_total_dim=total,
                               route=ps_route)
    elif cfg.checkpoint_dir:
        source = CheckpointWatcher(cfg.checkpoint_dir)
    else:
        source = None
    engine = ScoringEngine(cfg, max_batch_size=cfg.serve_max_batch_size,
                           idle_evict_s=cfg.serve_engine_idle_evict_s)
    if args.model_file:
        engine.set_weights(load_weights(args.model_file, shape=engine.model.param_shape))
    reloader = None
    if source is not None:
        reloader = HotReloader(engine, source, interval_s=cfg.serve_reload_interval_s).start()
        if not engine.has_weights:
            reloader.wait_for_weights()

    # more hosted versions: "id=<weights>" loads a static engine from a model
    # file; "id=@ps" reloads that id's namespace of the same group live
    engines = {cfg.serve_model_id: engine}
    extra_reloaders = []
    for spec in args.extra_models or []:
        mid, eq, src = spec.partition("=")
        mid, src = mid.strip(), src.strip()
        if not eq or not mid or not src:
            print(f"error: bad --extra-model {spec!r} (want id=weights or id=@ps)",
                  file=sys.stderr)
            return 2
        if mid in engines:
            print(f"error: duplicate model id {mid!r}", file=sys.stderr)
            return 2
        eng = ScoringEngine(cfg, max_batch_size=cfg.serve_max_batch_size,
                            idle_evict_s=cfg.serve_engine_idle_evict_s)
        if src == "@ps":
            if not live_ps:
                print("error: --extra-model id=@ps needs --ps-hosts or --ps-ctl",
                      file=sys.stderr)
                return 2
            base, total = _ns(mid)
            # a pull client of its own for each namespace watcher
            extra_src = LivePSWatcher(args.ps_hosts, ps_param_dim(cfg),
                                      vals_per_key=_serve_row_width(cfg),
                                      client_id=LivePSWatcher.SERVE_CLIENT_ID - len(engines),
                                      retry=retry, ns_base=base, ns_total_dim=total,
                                      route=ps_route)
            rl = HotReloader(eng, extra_src, interval_s=cfg.serve_reload_interval_s).start()
            rl.wait_for_weights()
            extra_reloaders.append(rl)
        else:
            eng.set_weights(load_weights(src, shape=eng.model.param_shape))
        engines[mid] = eng

    feedback = None
    if cfg.feedback_spool_dir:
        from distlr_tpu_torch.feedback import FeedbackSink  # noqa: PLC0415

        shard_dir = cfg.feedback_shard_dir or os.path.join(cfg.feedback_spool_dir, "shards")
        feedback = FeedbackSink(
            cfg.feedback_spool_dir, shard_dir, model=cfg.model, capacity=cfg.feedback_capacity,
            window_s=cfg.feedback_window_s, negative_rate=cfg.feedback_negative_rate,
            shard_records=cfg.feedback_shard_records, tracker=hot_tracker,
            drift_block=cfg.feedback_drift_block,
            drift_threshold=cfg.feedback_drift_threshold)
        log.info("feedback loop ON: spool=%s shards=%s window=%.0fs negative_rate=%.2f",
                 cfg.feedback_spool_dir, shard_dir, cfg.feedback_window_s,
                 cfg.feedback_negative_rate)

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    # one unnamed engine is the single-model server (flat feedback shards);
    # --model-id or extra models turn model identity on (shards a model)
    multi = bool(args.extra_models) or args.model_id is not None
    server = ScoringServer(None if multi else engine, engines=engines if multi else None,
                           host=cfg.serve_host, port=cfg.serve_port,
                           max_wait_ms=cfg.serve_max_wait_ms, reloader=reloader,
                           extra_reloaders=extra_reloaders, hot_tracker=hot_tracker,
                           feedback=feedback)
    # the scriptable readiness line
    print(f"SERVING {server.host}:{server.port}", flush=True)
    server.serve_forever()
    return 0


def cmd_online(args: argparse.Namespace) -> int:
    """Continuous trainer (:mod:`distlr_tpu_torch.feedback.online`): watch
    the feedback joiner's shard dir and push Hogwild updates into the live
    KV group the serving engines hot-reload from, the closed loop's
    training leg.  It computes on the host (numpy, as the JAX package's
    does) and needs no card.  It runs until SIGTERM (a final flush, exit
    0) unless ``--max-shards`` / ``--idle-exit`` bound it."""
    import signal  # noqa: PLC0415
    import threading  # noqa: PLC0415

    from distlr_tpu_torch.feedback import OnlineTrainer  # noqa: PLC0415

    cfg = _online_config(args)
    ns_base, ns_total = 0, None
    if args.ps_namespaces:
        # train only this tenant's namespace slice of a shared group
        from distlr_tpu_torch.ps import namespace_layout  # noqa: PLC0415
        from distlr_tpu_torch.train.ps_trainer import ps_param_dim  # noqa: PLC0415

        layout = namespace_layout(args.ps_namespaces, ps_param_dim(cfg))
        ns_id = args.ps_namespace or cfg.serve_model_id
        if ns_id not in layout:
            print(f"error: namespace {ns_id!r} not in --ps-namespaces {sorted(layout)}",
                  file=sys.stderr)
            return 2
        ns_base = layout[ns_id][0]
        ns_total = ps_param_dim(cfg) * len(layout)
    route = None
    if args.ps_ctl:
        # an elastic group: follow the coordinator's layout, so a live
        # reshard costs this trainer a re-route, not a restart
        from distlr_tpu_torch.ps.membership import layout_client  # noqa: PLC0415

        route = layout_client(args.ps_ctl)
    if not args.hosts and route is None:
        print("error: online needs --hosts or --ps-ctl", file=sys.stderr)
        return 2
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    trainer = OnlineTrainer(
        cfg, args.hosts, args.shard_dir, accum_start=cfg.ps_accum_start,
        accum_growth=cfg.ps_accum_growth, accum_growth_every=cfg.ps_accum_growth_every,
        accum_max=cfg.ps_accum_max, poll_interval_s=args.poll_interval,
        worker_id=args.worker_id, ns_base=ns_base, ns_total_dim=ns_total, route=route)
    # the scriptable readiness line
    print(f"ONLINE shard_dir={args.shard_dir} hosts={args.hosts} worker={args.worker_id}",
          flush=True)
    try:
        stats = trainer.run(stop=stop, max_shards=args.max_shards, idle_exit_s=args.idle_exit)
    except KeyboardInterrupt:
        trainer._flush_push()
        stats = trainer.stats()
    finally:
        trainer.close()
    log.info("online trainer done: %d shards, %d examples, %d pushes (k=%d); %.3f s consuming "
             "shards, %.3f s of it parsing, %.3f s in the gradients", stats["shards_consumed"],
             stats["examples"], stats["pushes"], stats["accum_k"], trainer.consume_s,
             trainer.parse_s, trainer.grad_s)
    return 0


def cmd_route(args: argparse.Namespace) -> int:
    """The serving tier's routing front-end (:mod:`distlr_tpu_torch.serve.
    router`): the serve protocol load-balanced over replicas, with health
    checks, ejection and reinstatement, an in-flight budget a replica
    (explicit ``ERR SHED``) and retry-once failover.  It needs no card."""
    import signal  # noqa: PLC0415

    from distlr_tpu_torch.serve.router import ScoringRouter  # noqa: PLC0415

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        cfg = _route_config(args)
        router = ScoringRouter(
            args.replicas, host=cfg.route_host, port=cfg.route_port,
            max_inflight=cfg.route_max_inflight, eject_after=cfg.route_eject_after,
            health_interval_s=cfg.route_health_interval_s,
            probe_backoff_s=cfg.route_probe_backoff_s,
            probe_backoff_max_s=cfg.route_probe_backoff_max_s,
            backend_timeout_s=cfg.route_backend_timeout_s, quotas=cfg.route_quota)
    except ValueError as e:
        # config and replica-list errors: the argparse-style exit, no traceback
        print(f"error: {e}", file=sys.stderr)
        return 2
    # the scriptable readiness line
    print(f"ROUTING {router.host}:{router.port}", flush=True)
    router.serve_forever()
    return 0


def cmd_rollout(args: argparse.Namespace) -> int:
    """A canary ramp with automatic rollback (:mod:`distlr_tpu_torch.serve.
    rollout`) against a running router.  Exit codes: 0 promoted, 3 rolled
    back, 4 aborted (alerts before the ramp, registry problems)."""
    import json  # noqa: PLC0415

    from distlr_tpu_torch.serve.rollout import (  # noqa: PLC0415
        RolloutController,
        RouterAdmin,
        fleet_alert_poller,
        parse_stages,
    )

    _config_from_args(args)  # the config flags validate as in every command
    host, _, port = args.router.rpartition(":")
    if not host or not port.isdigit():
        print(f"error: --router must be host:port, got {args.router!r}", file=sys.stderr)
        return 2
    try:
        stages = parse_stages(args.stages)
    except ValueError as e:
        print(f"error: bad --stages: {e}", file=sys.stderr)
        return 2
    poller = None
    if args.fleet:
        names = ([n.strip() for n in args.alerts.split(",") if n.strip()]
                 if args.alerts else None)
        # by default only alerts attributable to the candidate break the
        # ramp; --gate-all-alerts gates on every bound alert, --slo narrows
        # to one objective's burn-rate alerts
        poller = fleet_alert_poller(
            args.fleet, names=names,
            scope_model=None if args.gate_all_alerts else args.candidate, scope_slo=args.slo)
    elif not args.unwatched:
        print("error: no alert source — pass --fleet http://host:port, an "
              "--obs-run-dir with a running obs-agg, or --unwatched to "
              "ramp on the timer alone (rollback becomes manual)", file=sys.stderr)
        return 2
    ctrl = RolloutController(RouterAdmin(host, int(port)), args.tenant, args.candidate, stages,
                             alert_poll=poller, poll_interval_s=args.poll_interval,
                             shadow_fraction=args.shadow, settle_s=args.settle,
                             journal_dir=args.journal_dir)
    try:
        outcome = ctrl.run()
    except (OSError, RuntimeError) as e:
        print(f"error: ramp failed against the router: {e}", file=sys.stderr)
        return 1
    # the scriptable outcome line
    print(f"ROLLOUT {json.dumps(outcome)}", flush=True)
    return {"promoted": 0, "rolled_back": 3}.get(outcome["outcome"], 4)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="distlr_tpu_torch.launch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen-data", help="write seeded synthetic libsvm or CTR shards")
    g.add_argument("--data-dir", required=True)
    g.add_argument("--num-samples", type=int, default=10000)
    g.add_argument("--num-feature-dim", type=int, default=123)
    g.add_argument("--num-parts", type=int, default=4)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--num-classes", type=int, default=2)
    g.add_argument("--sparsity", type=float, default=0.5)
    g.add_argument("--ctr-fields", type=int, default=0,
                   help="if >0: write hashed one-hot CTR shards with this many "
                   "categorical fields (sparse workloads; --num-feature-dim "
                   "becomes the bucket count)")
    g.add_argument("--ctr-vocab", type=int, default=100_000,
                   help="raw categorical vocabulary size for --ctr-fields")
    g.add_argument("--ctr-raw", action="store_true",
                   help="with --ctr-fields: write RAW categorical shards (the "
                   "blocked_lr format) instead of pre-hashed one-hot rows")
    g.add_argument("--ctr-tuples", type=int, default=0,
                   help="with --ctr-raw: draw rows from this many distinct "
                   "field-value tuples (correlated fields) instead of i.i.d. fields")
    g.set_defaults(fn=cmd_gen_data)

    def config_parser(name: str, **kw) -> argparse.ArgumentParser:
        """A subcommand with the JAX package's shared flag set."""
        sp = sub.add_parser(name, **kw)
        _add_config_flags(sp)
        _add_mesh_flags(sp)
        _add_process_flags(sp)
        return sp

    s = config_parser("sync", help="synchronous data-parallel training (one card, or one "
                      "process of a torch.distributed run)")
    s.set_defaults(fn=cmd_sync)

    e = config_parser("eval", help="score a saved text model on the test split")
    e.add_argument("--model-file", dest="model_file", required=True,
                   help="text model file (the reference SaveModel format; "
                        "what sync runs write to models/part-001)")
    e.set_defaults(fn=cmd_eval)

    p = config_parser("ps", help="parameter-server training of every family (native KV "
                      "servers, worker threads on one card)")
    p.add_argument("--async", dest="asynchronous", action="store_true",
                   help="Hogwild mode (SYNC_MODE=0 equivalent)")
    p.add_argument("--hosts", help="join existing servers (comma-separated host:port, "
                   "rank order) instead of spawning local ones")
    p.add_argument("--worker-ranks", dest="worker_ranks",
                   help="with --hosts: this host's ranks, e.g. 0,1 (default: all)")
    p.add_argument("--max-worker-restarts", dest="max_worker_restarts", type=int, default=0,
                   help="async mode: restart a failed worker in place up to N times "
                   "(sync recovery is --checkpoint-dir + --resume)")
    p.add_argument("--supervise-servers", dest="supervise_servers", action="store_true",
                   help="async local mode: respawn dead server ranks and re-seed them "
                   "from a rolling snapshot (pair with --max-worker-restarts)")
    p.add_argument("--chaos-plan", dest="chaos_plan",
                   help="JSON fault plan: local mode puts its proxies between the workers "
                   "and the spawned servers (delay, throttle, reset, partition, kill)")
    p.add_argument("--chaos-seed", dest="chaos_seed", type=int,
                   help="seed of the plan's jitter draws (default: the plan's own)")
    p.add_argument("--no-ps-pipeline", dest="ps_pipeline", action="store_false", default=None,
                   help="the reference's serialized pull -> grad -> push a batch instead "
                   "of one fused push_pull (and, async, the overlapped next gradient)")
    p.set_defaults(fn=cmd_ps)

    v = config_parser("ps-server", help="host a KV server group in the foreground (workers "
                      "join it with `ps --hosts`)")
    v.add_argument("--async", dest="asynchronous", action="store_true",
                   help="Hogwild group (each push applied at once)")
    v.add_argument("--ports", help="fixed ports, comma-separated (default: ephemeral)")
    v.add_argument("--namespaces",
                   help="host N model namespaces in one group (comma-separated model ids, "
                   "the order defines the key-space slices): the group's dim becomes N x "
                   "the per-model dim, announced as 'NAMESPACES id=base,...'; clients "
                   "repeat the list as --ps-namespaces.  An id may carry an optimizer "
                   "suffix ('v1:ftrl,v2:sgd'): that slice's keys run it (sgd|ftrl)")
    v.add_argument("--elastic", action="store_true",
                   help="live-resizable group (needs --async): also serve the membership "
                   "coordinator, announced as 'PSCTL host:port' (`launch ps-ctl resize N`)")
    v.add_argument("--ctl-port", dest="ctl_port", type=int,
                   help="the coordinator's port (default: ephemeral)")
    v.set_defaults(fn=cmd_ps_server)

    pc = sub.add_parser("ps-ctl", help="admin CLI against a group's coordinator (`launch "
                        "ps-server --elastic` or `--store-dir` prints its PSCTL endpoint)")
    pc.add_argument("--ctl", help="the coordinator endpoint (what ps-server announced as "
                    "PSCTL host:port); optional only for `store --store-dir`")
    pc.add_argument("command", choices=["layout", "status", "resize", "store", "snapshot",
                                        "restore"],
                    help="layout = the routing contract clients follow; status = the "
                    "group's state; resize = reshard to N ranks live (an async group; "
                    "refused for a sync or durable one); store = the "
                    "durable store's snapshots and WAL per rank; snapshot = every rank "
                    "snapshots now (SIGUSR1); restore = every rank back to its on-disk "
                    "state (SIGKILL and a respawn that recovers from the store)")
    pc.add_argument("--store-dir", dest="store_dir",
                    help="store only: read this store directory itself, no coordinator")
    pc.add_argument("n", nargs="?", type=int, help="target server count (resize only)")
    pc.add_argument("--no-wait", dest="no_wait", action="store_true",
                    help="resize only: return once the coordinator accepts (RESIZE n wait=0)")
    pc.set_defaults(fn=cmd_ps_ctl)

    c = config_parser("chaos", help="fault-injection proxy in front of a running KV server "
                      "group (a JSON plan's delay / throttle / reset / partition / kill); "
                      "workers connect to the proxied HOSTS")
    c.add_argument("--upstreams", required=True,
                   help="the group's servers, comma-separated host:port in rank order "
                   "(what `launch ps-server` printed)")
    c.add_argument("--plan", required=True, help="JSON fault plan (the schema of "
                   "distlr_tpu_torch/chaos/plan.py; a malformed plan exits 2)")
    c.add_argument("--seed", type=int, default=None,
                   help="jitter seed (default: the plan's own, else 0)")
    c.add_argument("--events-path", dest="events_path",
                   help="write the deterministic fault-event log here as JSON at exit")
    c.add_argument("--pids", default=None,
                   help="the servers' pids in rank order: arms the plan's kill faults "
                   "(without it they only record their event)")
    c.add_argument("--protocol", choices=["kv", "serve"], default="kv",
                   help="the framing the proxy parses: kv (PS links) or serve (the "
                   "scoring tier's line protocol)")
    c.set_defaults(fn=cmd_chaos)

    r = config_parser("serve", help="online scoring server (batched scoring on the card, "
                      "hot weight reload)")
    r.add_argument("--model-file", dest="model_file",
                   help="initial weights: a text model file (models/part-00N) or a "
                   "checkpoint directory (its latest step)")
    r.add_argument("--ps-hosts", dest="ps_hosts",
                   help="pull live weights from this running KV server group "
                   "(comma-separated host:port, rank order), e.g. while `launch ps "
                   "--async --hosts` trains against it")
    r.add_argument("--ps-ctl", dest="ps_ctl",
                   help="elastic group: the membership coordinator's PSCTL host:port; "
                   "serving pulls follow its layout across live reshards (optional next "
                   "to --ps-hosts; alone, the layout comes from the coordinator)")
    r.add_argument("--port", type=int, help="listen port (default: ephemeral, announced "
                   "as 'SERVING host:port')")
    r.add_argument("--bind", help="listen address (default 127.0.0.1)")
    r.add_argument("--serve-max-batch-size", dest="serve_max_batch_size", type=int,
                   help="top batch bucket and microbatch flush size (default 1024)")
    r.add_argument("--max-wait-ms", dest="max_wait_ms", type=float,
                   help="microbatch window: max ms a request waits for company (default 2)")
    r.add_argument("--reload-interval", dest="reload_interval", type=float,
                   help="weight-source poll period, seconds (jittered ±20%%; default 1)")
    r.add_argument("--hot-rows", dest="hot_rows", type=int,
                   help="with --ps-hosts: track the requests' hot working set (capacity N "
                   "row keys) and reload only that slice through keyed pulls, with a full "
                   "refresh when coverage drops (default 0 = always full)")
    r.add_argument("--hot-min-coverage", dest="hot_min_coverage", type=float,
                   help="full-refresh fallback: least share of recent request keys the hot "
                   "set must cover (default 0.95)")
    r.add_argument("--hot-full-every", dest="hot_full_every", type=int,
                   help="also a full refresh every N polls, bounding cold rows' staleness "
                   "(default 10; 0 = coverage-driven only)")
    r.add_argument("--engine-idle-evict", dest="engine_idle_evict", type=float,
                   help="drop the device weight table after this many idle seconds (the "
                   "next request reloads it); default 0 = never")
    r.add_argument("--feedback-spool", dest="feedback_spool",
                   help="turn the feedback loop on: journal every scored request into this "
                   "bounded spool dir, accept LABEL lines, emit joined training shards and "
                   "run the score-drift detector")
    r.add_argument("--feedback-shards", dest="feedback_shards",
                   help="joined-shard output dir the online trainer watches "
                   "(default <feedback-spool>/shards)")
    r.add_argument("--feedback-window", dest="feedback_window", type=float,
                   help="delayed-label join window, seconds (default 60)")
    r.add_argument("--feedback-negative-rate", dest="feedback_negative_rate", type=float,
                   help="probability a never-labelled request becomes a label-0 example at "
                   "window expiry (default 0.1; 0 = drop them all)")
    r.add_argument("--feedback-shard-records", dest="feedback_shard_records", type=int,
                   help="joined examples a shard (default 1024)")
    r.add_argument("--feedback-capacity", dest="feedback_capacity", type=int,
                   help="in-memory spool bound; past it the least important of the oldest "
                   "requests go (default 100000)")
    r.add_argument("--drift-block", dest="drift_block", type=int,
                   help="served scores a drift-PSI block (default 512)")
    r.add_argument("--drift-threshold", dest="drift_threshold", type=float,
                   help="block-to-block PSI above which the drift alert fires "
                   "(default 0.25)")
    r.add_argument("--model-id", dest="model_id",
                   help="model id the primary engine answers as (MODEL/@-addressing; "
                   "feedback records carry it, so shards go a model); default 'default' = "
                   "unaddressed single-model behavior")
    r.add_argument("--extra-model", dest="extra_models", action="append",
                   metavar="ID=WEIGHTS|ID=@ps",
                   help="host another model version (repeatable): id=path loads a static "
                   "engine from a model file or checkpoint dir; id=@ps reloads that id's "
                   "namespace of the --ps-hosts group live (needs --ps-namespaces)")
    r.add_argument("--ps-namespaces", dest="ps_namespaces",
                   help="comma-separated model ids the PS group hosts as key-space "
                   "namespaces, in the group's order (the order defines the slices); "
                   "repeat `ps-server --namespaces` verbatim, ':opt' suffixes included")
    r.add_argument("--ps-namespace", dest="ps_namespace",
                   help="which namespace the primary engine serves (default: --model-id)")
    r.set_defaults(fn=cmd_serve)

    on = config_parser("online", help="continuous trainer: consume joined feedback shards "
                       "as they appear and push Hogwild updates into the live PS the "
                       "serving engines hot-reload from (the closed loop)")
    on.add_argument("--hosts", help="the live async KV server group (comma-separated "
                    "host:port, rank order): the group `launch serve --ps-hosts` pulls from")
    on.add_argument("--ps-ctl", dest="ps_ctl",
                    help="elastic group: the membership coordinator's PSCTL host:port; "
                    "this trainer follows its layout (a live reshard costs one re-route, "
                    "never a restart)")
    on.add_argument("--shard-dir", dest="shard_dir", required=True,
                    help="joined-shard dir the serving tier's feedback sink writes "
                    "(serve --feedback-shards)")
    on.add_argument("--worker-id", dest="worker_id", type=int, default=0,
                    help="this trainer's id among the online workers sharing one shard dir "
                    "(its own PS client id; shards are claimed by the .claim rename)")
    on.add_argument("--poll-interval", dest="poll_interval", type=float, default=0.5,
                    help="shard-dir scan period while idle, seconds (default 0.5)")
    on.add_argument("--max-shards", dest="max_shards", type=int, default=0,
                    help="exit after consuming N shards (0 = run until stopped)")
    on.add_argument("--idle-exit", dest="idle_exit", type=float,
                    help="exit after this many seconds with no new shards (default: wait)")
    on.add_argument("--ps-namespaces", dest="ps_namespaces",
                    help="comma-separated model ids the PS group hosts as key-space "
                    "namespaces (repeat `launch ps-server --namespaces`); this trainer "
                    "pushes only into its own namespace slice")
    on.add_argument("--ps-namespace", dest="ps_namespace",
                    help="which namespace this trainer trains (default: serve_model_id); "
                    "point --shard-dir at the same tenant's shard subdir")
    on.set_defaults(fn=cmd_online)

    rt = config_parser("route", help="serving-tier front-end: load-balance the serve "
                       "protocol over replicas with health checks, admission control "
                       "(explicit load shed) and retry-once failover")
    rt.add_argument("--replicas", required=True,
                    help="host:port of running `launch serve` replicas, comma-separated, "
                    "or a model registry v1=h:p+h:p,v2=h:p")
    rt.add_argument("--port", type=int, help="listen port (default: ephemeral, announced "
                    "as 'ROUTING host:port')")
    rt.add_argument("--bind", help="listen address (default 127.0.0.1)")
    rt.add_argument("--max-inflight", dest="max_inflight", type=int,
                    help="in-flight request budget a replica; past it requests shed with "
                    "'ERR SHED' (default 64)")
    rt.add_argument("--eject-after", dest="eject_after", type=int,
                    help="consecutive transport failures before a replica is ejected "
                    "(default 3)")
    rt.add_argument("--health-interval", dest="health_interval", type=float,
                    help="STATS probe period of idle in-rotation replicas, seconds "
                    "(default 1)")
    rt.add_argument("--probe-backoff", dest="probe_backoff", type=float,
                    help="base of the reinstatement probes' exponential backoff, seconds "
                    "(default 0.5)")
    rt.add_argument("--probe-backoff-max", dest="probe_backoff_max", type=float,
                    help="cap of the reinstatement probes' backoff, seconds (default 30)")
    rt.add_argument("--backend-timeout", dest="backend_timeout", type=float,
                    help="socket timeout of each exchange with a replica, seconds "
                    "(default 30)")
    rt.add_argument("--quota", dest="quota", metavar="MODEL=RATE[:BURST],..",
                    help="per-tenant token-bucket quotas (requests/s; burst defaults to "
                    "2*rate): a tenant over budget gets 'ERR SHED tenant'")
    rt.set_defaults(fn=cmd_route)

    ro = config_parser("rollout", help="canary ramp with automatic rollback: stage a "
                       "tenant's traffic onto a candidate version through the router's "
                       "SPLIT line, roll back when a bound alert fires, PROMOTE at the end")
    ro.add_argument("--router", required=True,
                    help="the router's host:port (what `launch route` printed as ROUTING)")
    ro.add_argument("--tenant", required=True, help="model id whose traffic is ramped")
    ro.add_argument("--candidate", required=True,
                    help="model id that takes the ramped traffic (registered in the router)")
    ro.add_argument("--stages", default="0.05:10,0.25:10,0.5:10,1.0:10",
                    help="comma-separated weight:hold_s stages, ascending to 1.0 "
                    "(default '0.05:10,0.25:10,0.5:10,1.0:10')")
    ro.add_argument("--shadow", type=float, default=0.0,
                    help="also mirror this fraction of the tenant's traffic to the "
                    "candidate during the ramp (default 0)")
    ro.add_argument("--settle", type=float, default=0.0,
                    help="with --shadow: watch the shadow this many seconds before the "
                    "first stage (default 0)")
    ro.add_argument("--fleet", help="aggregator URL (http://host:port) whose /fleet.json "
                    "alerts gate the ramp")
    ro.add_argument("--alerts", help="comma-separated alert names to bind (default: every "
                    "distlr_alert_*)")
    ro.add_argument("--gate-all-alerts", dest="gate_all_alerts", action="store_true",
                    help="roll back on any bound firing alert; default: only alerts "
                    "attributable to the candidate (an unreachable aggregator always gates)")
    ro.add_argument("--slo", help="gate on one SLO's burn-rate alerts only "
                    "(distlr_alert_slo_burn{slo=NAME})")
    ro.add_argument("--unwatched", action="store_true",
                    help="ramp on the stage timers alone, with no alert gate (rollback "
                    "becomes manual)")
    ro.add_argument("--poll-interval", dest="poll_interval", type=float, default=0.5,
                    help="alert poll period during holds, seconds (default 0.5)")
    ro.add_argument("--journal-dir", dest="journal_dir",
                    help="journal the transitions under DIR/rollout/")
    ro.set_defaults(fn=cmd_rollout)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
