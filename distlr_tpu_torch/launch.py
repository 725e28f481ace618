"""Command-line entry point of the port: ``gen-data``, ``sync``, ``eval``,
``ps``, ``ps-server``, ``ps-ctl``, ``chaos``, ``serve``, ``online``,
``route``, ``rollout``, ``autopilot``, ``obs-agg``, ``fleet-query``,
``trace-agg``, ``prof-agg``, ``profrec``, ``flightrec``, ``top``, ``logs``
and ``incident``.

Counterpart of ``distlr_tpu/launch.py``: every subcommand takes the
option strings its JAX twin takes, with the same dests, types and
defaults, plus ``--device`` (default ``cuda``; the CPU only when asked
for).  Run as ``python -m distlr_tpu_torch.launch``::

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

``--obs-run-dir RUN`` on every process of a fleet joins it to the fleet:
each process journals its sampled spans (``--trace-sample``, default 0.01)
to ``RUN/spans/<role>-<rank>.jsonl`` (a locally spawned KV server group to
``RUN/spans/kvserver-<rank>.jsonl``), samples its stacks at ``--prof-hz``
(default 19) into ``RUN/profiles/``, journals its structured logs to
``RUN/logs/``, keeps a flight-recorder ring, and publishes its metrics
endpoint as ``RUN/endpoints/<role>-<rank>.json``.  ``obs-agg`` federates
the endpoints (``/metrics``, ``/fleet.json``, ``/query``, derived alerts,
SLO burn rates with ``--slo-file``, incident bundles on alert edges);
``top`` renders it, ``fleet-query`` asks its time-series store,
``autopilot`` scales the fleet from it.  ``trace-agg`` and ``prof-agg``
merge the span and profile journals, ``logs`` queries the log journals,
``flightrec`` / ``profrec`` / ``incident --trigger`` make the processes
dump their rings, burst their samplers, or both into one bundle::

    python -m distlr_tpu_torch.launch ps --data-dir D --num-feature-dim 123 \\
        --obs-run-dir RUN --trace-sample 1.0
    python -m distlr_tpu_torch.launch obs-agg --obs-run-dir RUN --interval 0.5  # METRICS h:p
    python -m distlr_tpu_torch.launch top --obs-run-dir RUN --iterations 1 --no-color
    python -m distlr_tpu_torch.launch fleet-query 'rate(pushes)' --obs-run-dir RUN
    python -m distlr_tpu_torch.launch trace-agg --obs-run-dir RUN --out merged.json
    python -m distlr_tpu_torch.launch prof-agg --obs-run-dir RUN --out fleet_profile
    python -m distlr_tpu_torch.launch logs --obs-run-dir RUN --level warning
    python -m distlr_tpu_torch.launch incident --obs-run-dir RUN --trigger drill
    python -m distlr_tpu_torch.launch autopilot --obs-run-dir RUN --ps-ctl h:p
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from distlr_tpu_torch.config import Config
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_CONFIG_FIELDS = (
    "data_dir", "num_feature_dim", "num_iteration", "batch_size",
    "learning_rate", "l2_c", "test_interval", "model", "compat_mode",
    "random_seed", "prefetch", "feature_dtype", "num_workers", "device",
    "num_classes", "nnz_max", "block_size", "block_groups", "ctr_fields", "hash_seed",
    "checkpoint_dir", "checkpoint_interval", "profile_dir",
    "obs_metrics_port", "obs_metrics_host", "obs_trace_path", "obs_run_dir", "trace_sample",
    "num_servers", "ps_compute_backend", "ps_timeout_ms", "ps_pipeline",
    "ps_optimizer", "ftrl_alpha", "ftrl_beta", "ftrl_l1", "ftrl_l2", "ps_compress",
    "ps_accum_start", "ps_accum_growth", "ps_accum_growth_every", "ps_accum_max",
    "ps_retry_attempts", "ps_retry_backoff_ms", "ps_retry_backoff_max_ms",
    "ps_retry_deadline_s", "ps_retry_adaptive",
    "ps_store_dir", "ps_store_interval_s", "ps_store_wal", "ps_store_wal_fsync_s",
    "chaos_plan", "chaos_seed", "sync_mode",
    "prof_hz", "prof_window_s", "log_level", "log_ring", "log_dedupe_s",
    "incident_window_s", "incident_settle_s", "incident_max",
    "slo_file", "obs_tsdb_raw_points", "obs_tsdb_rollup_retention_s", "obs_tsdb_history_lines",
    "autopilot_interval_s", "autopilot_hysteresis_ticks", "autopilot_cooldown_s",
    "autopilot_rollback_window_s", "autopilot_ps_min", "autopilot_ps_max",
    "autopilot_engine_min", "autopilot_engine_max", "autopilot_worker_min",
    "autopilot_worker_max", "autopilot_staleness_high", "autopilot_push_rate_high",
    "autopilot_push_rate_low", "autopilot_shed_rate_high", "autopilot_route_p99_high_ms",
    "autopilot_req_rate_low", "autopilot_lag_high", "autopilot_lag_low",
    "autopilot_rate_window_s",
)

def _obs_rank(args: argparse.Namespace) -> int:
    """This process's fleet rank (the <rank> of its journal and endpoint
    files): the explicit process id when given, else the lowest worker
    rank this process runs, else 0."""
    pid = getattr(args, "process_id", None)
    if pid is not None:  # an explicit process id 0 counts too
        return pid
    ranks = getattr(args, "worker_ranks", None)
    if ranks:
        return min(int(s) for s in ranks.split(","))
    return 0


@contextlib.contextmanager
def _obs_scope(cfg: Config, role: str, rank: int):
    """Command-scoped observability (``distlr_tpu/launch.py``'s
    ``_obs_scope``): start the /metrics endpoint when ``--metrics-port``
    is set (announced as ``METRICS host:port``, the scriptable contract of
    ``SERVING`` / ``HOSTS``) and dump the phase spans as a Chrome trace at
    command exit when ``--trace-path`` is.

    With ``--obs-run-dir`` (its first directory) the process joins the
    fleet as ``<role>-<rank>``: distributed tracing arms
    (:mod:`distlr_tpu_torch.obs.dtrace` at ``--trace-sample``; spans to
    ``spans/``, the flight recorder's trigger watched in ``flightrec/``),
    the continuous profiler samples at ``--prof-hz`` into ``profiles/``
    (:mod:`distlr_tpu_torch.obs.profile`; 0 = off), the fleet log tees
    every ``distlr_tpu_torch*`` logger into ``logs/``
    (:mod:`distlr_tpu_torch.obs.log`; stderr is unchanged), and the
    endpoint (port 0 when no ``--metrics-port`` was given) is published as
    ``endpoints/<role>-<rank>.json`` and removed at a clean exit.  All of
    them flush and stop at exit."""
    server = None
    endpoint = None
    prof_armed = False
    run_dir = cfg.obs_run_dir.split(os.pathsep)[0] if cfg.obs_run_dir else None
    if run_dir:
        from distlr_tpu_torch.obs import dtrace  # noqa: PLC0415
        from distlr_tpu_torch.obs import log as fleetlog  # noqa: PLC0415

        dtrace.configure(run_dir, role, rank, sample=cfg.trace_sample)
        if cfg.prof_hz > 0:
            from distlr_tpu_torch.obs import profile  # noqa: PLC0415

            profile.configure(run_dir, role, rank, hz=cfg.prof_hz, window_s=cfg.prof_window_s)
            prof_armed = True
        fleetlog.configure(run_dir, role, rank, level=cfg.log_level, ring=cfg.log_ring,
                           dedupe_s=cfg.log_dedupe_s)
    port = cfg.obs_metrics_port
    if port is None and run_dir:
        port = 0  # joining a fleet implies a scrape endpoint
    if port is not None:
        from distlr_tpu_torch.obs import start_metrics_server  # noqa: PLC0415

        server = start_metrics_server(host=cfg.obs_metrics_host, port=port)
        print(f"METRICS {server.host}:{server.port}", flush=True)
        if run_dir:
            from distlr_tpu_torch.obs import write_endpoint  # noqa: PLC0415

            endpoint = write_endpoint(run_dir, role, rank, server.host, server.port)
    try:
        yield
    finally:
        if cfg.obs_trace_path:
            from distlr_tpu_torch.obs import get_tracer  # noqa: PLC0415

            path = get_tracer().dump_chrome_trace(cfg.obs_trace_path)
            log.info("phase trace -> %s (load in Perfetto)", path)
        if run_dir:
            from distlr_tpu_torch.obs import dtrace  # noqa: PLC0415
            from distlr_tpu_torch.obs import log as fleetlog  # noqa: PLC0415

            dtrace.flush()
            fleetlog.stop()  # flushes and detaches the journal tee
        if prof_armed:
            from distlr_tpu_torch.obs import profile  # noqa: PLC0415

            profile.stop()  # journals the last partial window
        if server is not None:
            server.stop()
        if endpoint is not None:
            # a clean exit leaves the fleet; a crash never gets here, and
            # the file left behind is what marks the rank down
            with contextlib.suppress(OSError):
                os.unlink(endpoint)


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
                   help="torch.profiler (CPU and CUDA activities) around training "
                   "(sync: Trainer.fit; ps: rank 0's loop); the Chrome trace lands here")
    p.add_argument("--metrics-port", dest="obs_metrics_port", type=int,
                   help="serve Prometheus /metrics (and /metrics.json) on this port "
                   "for the command's lifetime (0 = ephemeral; announced as "
                   "'METRICS host:port')")
    p.add_argument("--metrics-host", dest="obs_metrics_host",
                   help="bind address of the /metrics endpoint (default 127.0.0.1)")
    p.add_argument("--trace-path", dest="obs_trace_path",
                   help="write the run's phase spans as Chrome trace-event JSON here "
                   "at exit (loads in Perfetto)")
    p.add_argument("--obs-run-dir", dest="obs_run_dir", action="append",
                   help="fleet run dir (repeatable; a process writes into the first): "
                   "distributed-trace span journals under spans/, the flight recorder's "
                   "dumps under flightrec/, profile windows under profiles/, structured "
                   "logs under logs/, this process's metrics endpoint under endpoints/ "
                   "(an ephemeral --metrics-port when none is given)")
    p.add_argument("--trace-sample", dest="trace_sample", type=float,
                   help="distributed-trace sampling rate with --obs-run-dir (default 0.01; "
                   "0 = nothing propagates and the KV wire is unchanged)")
    p.add_argument("--prof-hz", dest="prof_hz", type=float,
                   help="continuous-profiling sampling rate (default 19; 0 = profiler off): "
                   "a daemon thread folds every thread's stack into <obs-run-dir>/profiles/ "
                   "windows, tagged by the innermost dtrace span, bursting to high Hz once "
                   "an incident (or `launch profrec`); armed only with --obs-run-dir")
    p.add_argument("--prof-window", dest="prof_window_s", type=float,
                   help="seconds of aggregation a journaled profile window (default 10)")
    p.add_argument("--log-level", dest="log_level", choices=["debug", "info", "warning", "error"],
                   help="minimum level of the structured log records journaled to "
                   "<obs-run-dir>/logs/<role>-<rank>.jsonl (default info; stderr is "
                   "unaffected), each stamped with the active trace and span ids")
    p.add_argument("--log-ring", dest="log_ring", type=int,
                   help="records kept in the structured logger's in-memory ring (default 2048)")
    p.add_argument("--log-dedupe", dest="log_dedupe_s", type=float,
                   help="seconds identical records collapse into one journaled record with a "
                   "suppressed count (default 5; 0 = journal every record)")
    p.add_argument("--incident-window", dest="incident_window_s", type=float,
                   help="obs-agg and incident: seconds of context (WARN+ logs, chaos events, "
                   "autopilot decisions, rollout transitions) collected around an alert edge "
                   "into the incidents/<seq>/ bundle (default 120)")
    p.add_argument("--incident-settle", dest="incident_settle_s", type=float,
                   help="obs-agg and incident: seconds after the edge before the bundle "
                   "assembles, letting flight dumps and the profiler burst land (default 6)")
    p.add_argument("--incident-max", dest="incident_max", type=int,
                   help="obs-agg: incident bundles kept before the oldest is pruned "
                   "(default 32)")
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
    from the data dir's raw shards (blocked_lr)."""
    over = {k: v for k, v in vars(args).items() if v is not None and k in _CONFIG_FIELDS}
    if isinstance(over.get("obs_run_dir"), list):
        # repeatable: the Config holds the os.pathsep-joined list
        over["obs_run_dir"] = os.pathsep.join(over["obs_run_dir"])
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
    command builds it."""
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

    with _process_group(args, _config_from_args(args)) as cfg, \
            _obs_scope(cfg, "sync", _obs_rank(args)):
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
    with _obs_scope(cfg, "eval", _obs_rank(args)):
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
        with _obs_scope(cfg, "ps", _obs_rank(args)):
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
        with _obs_scope(cfg, "ps", _obs_rank(args)):
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
    from distlr_tpu_torch.train.ps_trainer import (  # noqa: PLC0415
        prof_journal_dir,
        ps_param_dim,
        server_optimizer,
        trace_journal_dir,
    )

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
                        store_wal_fsync_s=cfg.ps_store_wal_fsync_s,
                        trace_journal_dir=trace_journal_dir(cfg),
                        prof_journal_dir=prof_journal_dir(cfg), prof_window_s=cfg.prof_window_s)
    ctl = None
    try:
        with _obs_scope(cfg, "ps-server", _obs_rank(args)), group:
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

    cfg = _config_from_args(args)  # the shared flags' gates
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
        with _obs_scope(cfg, "chaos", _obs_rank(args)), fabric:
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
    with _obs_scope(cfg, "serve", _obs_rank(args)):
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
    with _obs_scope(cfg, "online", _obs_rank(args)):
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
    with _obs_scope(cfg, "route", _obs_rank(args)):
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

    cfg = _config_from_args(args)  # the config flags validate as in every command
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
    fleet_url = args.fleet
    run_dir = cfg.obs_run_dir.split(os.pathsep)[0] if cfg.obs_run_dir else None
    if not fleet_url and run_dir:
        from distlr_tpu_torch.obs.federate import discover_endpoints  # noqa: PLC0415

        aggs = [e for e in discover_endpoints(run_dir) if e["role"] == "obs-agg"]
        if aggs:
            fleet_url = f"http://{aggs[-1]['host']}:{aggs[-1]['port']}"
    if fleet_url:
        names = ([n.strip() for n in args.alerts.split(",") if n.strip()]
                 if args.alerts else None)
        # by default only alerts attributable to the candidate break the
        # ramp; --gate-all-alerts gates on every bound alert, --slo narrows
        # to one objective's burn-rate alerts
        poller = fleet_alert_poller(
            fleet_url, names=names,
            scope_model=None if args.gate_all_alerts else args.candidate, scope_slo=args.slo)
    elif not args.unwatched:
        print("error: no alert source — pass --fleet http://host:port, an "
              "--obs-run-dir with a running obs-agg, or --unwatched to "
              "ramp on the timer alone (rollback becomes manual)", file=sys.stderr)
        return 2
    with _obs_scope(cfg, "rollout", _obs_rank(args)):
        ctrl = RolloutController(RouterAdmin(host, int(port)), args.tenant, args.candidate, stages,
                                 alert_poll=poller, poll_interval_s=args.poll_interval,
                                 shadow_fraction=args.shadow, settle_s=args.settle,
                                 journal_dir=args.journal_dir or run_dir)
        try:
            outcome = ctrl.run()
        except (OSError, RuntimeError) as e:
            print(f"error: ramp failed against the router: {e}", file=sys.stderr)
            return 1
        # the scriptable outcome line
        print(f"ROLLOUT {json.dumps(outcome)}", flush=True)
    return {"promoted": 0, "rolled_back": 3}.get(outcome["outcome"], 4)


def cmd_trace_agg(args: argparse.Namespace) -> int:
    """Merge every rank's span journal (``<run_dir>/spans/*.jsonl``: the
    Python processes' and the native KV servers', one schema) into one
    Chrome/Perfetto trace-event file, a process track a journal, the
    server journals shifted onto their clients' clocks by the kHello clock
    probes, and the chaos proxy's fault instants on their tracks.  Needs
    no card."""
    from distlr_tpu_torch.obs import dtrace  # noqa: PLC0415

    cfg = _config_from_args(args)
    if not cfg.obs_run_dir:
        print("error: trace-agg needs --obs-run-dir (the run dir whose "
              "spans/ journals to merge; repeatable)", file=sys.stderr)
        return 2
    run_dirs = cfg.obs_run_dir.split(os.pathsep)
    doc = dtrace.write_merged_trace(run_dirs, args.out)
    meta = doc["otherData"]
    if not meta["journals"]:
        print(f"error: no span journals under "
              f"{', '.join(os.path.join(d, 'spans') for d in run_dirs)} — "
              "did the fleet run with --obs-run-dir and a non-zero "
              "--trace-sample?", file=sys.stderr)
        return 1
    # the scriptable contract, as METRICS / SERVING / HOSTS
    print(f"TRACE {args.out} journals={len(meta['journals'])} "
          f"spans={meta['spans']} traces={len(meta['trace_ids'])}", flush=True)
    log.info("merged trace -> %s (load in Perfetto); journals: %s",
             args.out, ", ".join(meta["journals"]))
    return 0


def cmd_flightrec(args: argparse.Namespace) -> int:
    """Trigger a flight-recorder dump: every process configured on the run
    dir writes its ring of recent spans and events, sampled or not, to
    ``<run_dir>/flightrec/<role>-<rank>-<seq>.json`` within one watcher
    poll (~0.25 s)."""
    from distlr_tpu_torch.obs import dtrace  # noqa: PLC0415

    cfg = _config_from_args(args)
    if not cfg.obs_run_dir:
        print("error: flightrec needs --obs-run-dir", file=sys.stderr)
        return 2
    for d in cfg.obs_run_dir.split(os.pathsep):
        path = dtrace.trigger(d, alert=args.reason)
        print(f"FLIGHTREC {path}", flush=True)
    log.info("flight-recorder trigger dropped; processes dump within "
             "one watcher poll")
    return 0


def cmd_obs_agg(args: argparse.Namespace) -> int:
    """Fleet metrics aggregator (:mod:`distlr_tpu_torch.obs.federate`): poll
    every endpoint published under ``--obs-run-dir``, merge the per-rank
    registries (counters sum, histograms merge bucket-wise, gauges gain
    ``role``/``rank`` identity), derive the ``distlr_alert_*`` gauges,
    and re-serve the fleet as ``/metrics`` + ``/metrics.json`` +
    ``/fleet.json`` (and ``/query`` over the embedded tsdb).  Needs no
    card: it starts in well under a second and can watch a wedged run
    without competing for the device."""
    import signal  # noqa: PLC0415

    from distlr_tpu_torch.obs import MetricsServer, write_metrics_snapshot  # noqa: PLC0415
    from distlr_tpu_torch.obs.federate import (  # noqa: PLC0415
        AlertThresholds,
        FleetScraper,
        write_endpoint,
    )

    cfg = _config_from_args(args)
    if not cfg.obs_run_dir:
        print("error: obs-agg needs --obs-run-dir (the rendezvous dir the "
              "fleet's processes publish their endpoints into)",
              file=sys.stderr)
        return 2
    # Effective alert thresholds: dataclass defaults < --thresholds-file
    # JSON < explicit CLI flags.  The distlr_alert_* threshold labels are
    # rendered from this instance, so a scrape always names the values
    # that were actually in force.
    try:
        thresholds = AlertThresholds.resolve(
            args.thresholds_file,
            barrier_wait_ratio=args.alert_barrier_wait_ratio,
            barrier_min_count=args.alert_barrier_min_count,
            push_error_rate=args.alert_push_error_rate,
            weight_age_ratio=args.alert_weight_age_ratio,
            retry_rate=args.alert_retry_rate,
            scrape_stale_s=args.stale_after,
            shadow_psi=args.alert_shadow_psi,
        )
    except (OSError, ValueError) as e:
        print(f"error: bad alert thresholds: {e}", file=sys.stderr)
        return 2
    slo_spec, slo_rules = None, None
    if cfg.slo_file:
        from distlr_tpu_torch.obs.slo import SLOSpecError, load_slo_file  # noqa: PLC0415
        try:
            slo_spec, slo_rules = load_slo_file(cfg.slo_file)
        except SLOSpecError as e:
            print(f"error: bad --slo-file: {e}", file=sys.stderr)
            return 2
        log.info("SLO engine armed: %s",
                 ", ".join(s.name for s in slo_spec))
    scraper = FleetScraper(cfg.obs_run_dir, interval_s=args.interval,
                           stale_after_s=thresholds.scrape_stale_s,
                           thresholds=thresholds,
                           slo_spec=slo_spec, slo_rules=slo_rules,
                           history_max_lines=cfg.obs_tsdb_history_lines,
                           tsdb_raw_points=cfg.obs_tsdb_raw_points,
                           tsdb_rollup_retention_s=(
                               cfg.obs_tsdb_rollup_retention_s),
                           incident_window_s=cfg.incident_window_s,
                           incident_settle_s=cfg.incident_settle_s,
                           incident_max=cfg.incident_max)
    if args.once:
        # One-shot federation: merge whatever the run dir holds right
        # now (live endpoints AND banked snapshots/ files) and emit it,
        # how a capture script banks a fleet snapshot without a daemon.
        scraper.scrape_once()
        fleet = scraper.fleet_json()
        if args.snapshot_path:
            write_metrics_snapshot(args.snapshot_path, scraper.merged)
            log.info("fleet snapshot -> %s", args.snapshot_path)
        else:
            print(scraper.prometheus_text(), end="")
        t = fleet["totals"]
        print(f"FLEET ranks={t['ranks']} up={t['up']} stale={t['stale']} "
              f"down={t['down']}", file=sys.stderr)
        return 0

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    port = cfg.obs_metrics_port if cfg.obs_metrics_port is not None else 0
    server = MetricsServer(
        registry=scraper, host=cfg.obs_metrics_host, port=port,
        extra_json={"/fleet.json": scraper.fleet_json},
        extra_query={"/query": scraper.query_endpoint},
    ).start()
    print(f"METRICS {server.host}:{server.port}", flush=True)
    # Published under its own role so `launch top --obs-run-dir` can find
    # the aggregator; the scraper skips obs-agg endpoints when merging.
    # With several run dirs, the FIRST is the aggregator's home.
    endpoint = write_endpoint(cfg.obs_run_dir.split(os.pathsep)[0],
                              "obs-agg", 0, server.host, server.port)
    try:
        scraper.run_forever()
    except KeyboardInterrupt:
        return 130
    finally:
        scraper.stop()
        server.stop()
        with contextlib.suppress(OSError):
            # leave cleanly so `launch top` gets the "start obs-agg
            # first" error instead of polling a dead endpoint
            os.unlink(endpoint)
    return 0


def cmd_prof_agg(args: argparse.Namespace) -> int:
    """Merge every rank's continuous-profiling journal
    (``<run_dir>/profiles/*.jsonl`` — Python samplers AND native
    ``distlr_kv_server`` per-handler CPU windows, one schema) into a
    fleet-wide collapsed-stack file (``flamegraph.pl``/inferno input,
    track-prefixed) plus a speedscope-compatible JSON with one track
    per ``<role>-<rank>`` journal.  Needs no card."""
    from distlr_tpu_torch.obs import profile  # noqa: PLC0415

    cfg = _config_from_args(args)
    if not cfg.obs_run_dir:
        print("error: prof-agg needs --obs-run-dir (the run dir whose "
              "profiles/ journals to merge; repeatable)", file=sys.stderr)
        return 2
    run_dirs = cfg.obs_run_dir.split(os.pathsep)
    tracks = profile.merge_run_dirs(run_dirs)
    if not tracks:
        print(f"error: no profile journals under "
              f"{', '.join(os.path.join(d, 'profiles') for d in run_dirs)}"
              " — did the fleet run with --obs-run-dir and a non-zero "
              "--prof-hz?", file=sys.stderr)
        return 1
    collapsed = args.out + ".collapsed"
    speedscope = args.out + ".speedscope.json"
    n_lines = profile.write_collapsed(tracks, collapsed)
    profile.write_speedscope(tracks, speedscope)
    samples = sum(t["samples"] for t in tracks.values())
    # Scriptable contract, like METRICS/SERVING/HOSTS/TRACE.
    print(f"PROF {args.out} tracks={len(tracks)} stacks={n_lines} "
          f"samples={samples}", flush=True)
    log.info("fleet profile -> %s (flamegraph.pl/inferno) + %s "
             "(speedscope.app); tracks: %s",
             collapsed, speedscope, ", ".join(sorted(tracks)))
    return 0


def cmd_profrec(args: argparse.Namespace) -> int:
    """Trigger an on-demand profile burst: every sampler configured on
    the run dir switches to high-Hz capture once and journals exactly
    one burst window — the profiler-only twin of ``launch flightrec``
    (alert incidents trigger both automatically, under one incident
    sequence number)."""
    from distlr_tpu_torch.obs import profile  # noqa: PLC0415

    cfg = _config_from_args(args)
    if not cfg.obs_run_dir:
        print("error: profrec needs --obs-run-dir", file=sys.stderr)
        return 2
    for d in cfg.obs_run_dir.split(os.pathsep):
        path = profile.trigger(d, reason=args.reason)
        print(f"PROFREC {path}", flush=True)
    log.info("profile-burst trigger dropped; samplers burst within one "
             "watcher poll")
    return 0


def cmd_top(args: argparse.Namespace) -> int:
    """Live ANSI dashboard over the fleet scrape (`launch top`)."""
    from distlr_tpu_torch.obs.federate import discover_endpoints  # noqa: PLC0415
    from distlr_tpu_torch.obs.top import run_top, run_top_replay  # noqa: PLC0415

    if args.replay:
        # offline incident scrubbing: render the aggregator's banked
        # scrape history (<run_dir>/history.jsonl) frame by frame —
        # the metrics-timeline complement of the flight recorder
        color = False if args.no_color else None
        return run_top_replay(args.replay, interval=args.replay_interval,
                              color=color, rate_window=args.rate_window)
    url = args.fleet
    if not url:
        if not args.obs_run_dir:
            print("error: top needs --fleet http://host:port or "
                  "--obs-run-dir (to discover a running obs-agg)",
                  file=sys.stderr)
            return 2
        aggs = [e for e in discover_endpoints(args.obs_run_dir)
                if e["role"] == "obs-agg"]
        if not aggs:
            print(f"error: no obs-agg endpoint under {args.obs_run_dir} — "
                  "start `python -m distlr_tpu_torch.launch obs-agg --obs-run-dir "
                  f"{args.obs_run_dir}` first", file=sys.stderr)
            return 2
        url = f"http://{aggs[-1]['host']}:{aggs[-1]['port']}"
    color = False if args.no_color else None
    return run_top(url, interval=args.interval, iterations=args.iterations,
                   color=color, rate_window=args.rate_window)


def cmd_fleet_query(args: argparse.Namespace) -> int:
    """One tsdb expression against a running obs-agg (`launch
    fleet-query`): hits the aggregator's ``/query`` endpoint and prints
    the JSON result — ``rate()``, ``increase()``,
    ``histogram_quantile()``, ``avg_over_time()`` + label matchers and
    arithmetic over the embedded fleet time-series store.  Exit codes:
    0 value, 1 no data in the window, 2 bad query/unreachable."""
    import json  # noqa: PLC0415
    import urllib.error  # noqa: PLC0415
    import urllib.parse  # noqa: PLC0415
    import urllib.request  # noqa: PLC0415

    from distlr_tpu_torch.obs.federate import discover_endpoints  # noqa: PLC0415

    url = args.fleet
    if not url:
        if not args.obs_run_dir:
            print("error: fleet-query needs --fleet http://host:port or "
                  "--obs-run-dir (to discover a running obs-agg)",
                  file=sys.stderr)
            return 2
        run_dir = (args.obs_run_dir[0]
                   if isinstance(args.obs_run_dir, list) else args.obs_run_dir)
        aggs = [e for e in discover_endpoints(run_dir)
                if e["role"] == "obs-agg"]
        if not aggs:
            print(f"error: no obs-agg endpoint under {run_dir} — start "
                  "`python -m distlr_tpu_torch.launch obs-agg` first",
                  file=sys.stderr)
            return 2
        url = f"http://{aggs[-1]['host']}:{aggs[-1]['port']}"
    qs = urllib.parse.urlencode({"expr": args.expr, "window": args.window})
    try:
        with urllib.request.urlopen(f"{url.rstrip('/')}/query?{qs}",
                                    timeout=args.timeout) as r:
            doc = json.load(r)
    except urllib.error.HTTPError as e:
        try:
            doc = json.load(e)
        except ValueError:
            doc = {"error": str(e)}
        print(f"error: {doc.get('error', e)}", file=sys.stderr)
        return 2
    except (OSError, ValueError) as e:
        print(f"error: aggregator unreachable at {url}: {e}",
              file=sys.stderr)
        return 2
    print(json.dumps(doc))
    return 0 if doc.get("value") is not None else 1


def cmd_logs(args: argparse.Namespace) -> int:
    """Query the fleet's structured log journals (`launch logs`): merge
    ``<run_dir>/logs/*.jsonl`` across every rank into one time-ordered
    stream, filtered by level/substring/time, tailed, or — with
    ``--trace <id>`` — narrowed to one request's records, interleaved
    with that trace's spans from the span journals (the log+span story
    of a single request).  Exit 1 when nothing matched."""
    import json  # noqa: PLC0415
    import time  # noqa: PLC0415

    from distlr_tpu_torch.obs import dtrace  # noqa: PLC0415
    from distlr_tpu_torch.obs import log as fleetlog  # noqa: PLC0415

    cfg = _config_from_args(args)
    if not cfg.obs_run_dir:
        print("error: logs needs --obs-run-dir (where the fleet "
              "journals records)", file=sys.stderr)
        return 2
    dirs = cfg.obs_run_dir.split(os.pathsep)
    events: list[dict] = list(fleetlog.read_records(
        dirs, level=args.level, grep=args.grep, trace=args.trace))
    if args.trace:
        # interleave the trace's spans: records say WHAT was logged,
        # spans say WHERE in the request the process was
        want = args.trace.lower().lstrip("0")
        for d in dirs:
            spans_dir = os.path.join(d, "spans")
            if not os.path.isdir(spans_dir):
                continue
            for name in sorted(os.listdir(spans_dir)):
                if not name.endswith(".jsonl"):
                    continue
                for r in dtrace.read_journal(
                        os.path.join(spans_dir, name)):
                    if r.get("type") != "span" or \
                            str(r.get("trace", "")).lstrip("0") != want:
                        continue
                    events.append({
                        "ts": float(r.get("ts", 0.0)) / 1e6,
                        "kind": "span", "src": name[:-len(".jsonl")],
                        "name": r.get("name"),
                        "dur_ms": round(float(r.get("dur", 0.0)) / 1e3, 3),
                        "trace": r.get("trace"), "span": r.get("span"),
                    })
        events.sort(key=lambda e: e.get("ts", 0.0))
    if args.tail and len(events) > args.tail:
        events = events[-args.tail:]
    for ev in events:
        if args.json:
            print(json.dumps(ev))
            continue
        ts = time.strftime("%H:%M:%S", time.localtime(ev.get("ts", 0.0)))
        ts += f".{int((ev.get('ts', 0.0) % 1) * 1000):03d}"
        if ev.get("kind") == "span":
            print(f"{ts} SPAN {ev['src']}] {ev['name']} "
                  f"({ev['dur_ms']} ms)", flush=True)
        else:
            who = f"{ev.get('role', '?')}-{ev.get('rank', '?')}"
            sup = f" (x{ev['suppressed']} suppressed)" \
                if ev.get("suppressed") else ""
            tr = f" trace={ev['trace']}" if ev.get("trace") else ""
            print(f"{ts} {str(ev.get('level', '?')).upper():7s} {who} "
                  f"{ev.get('logger')}] {ev.get('msg')}{sup}{tr}",
                  flush=True)
    return 0 if events else 1


def cmd_incident(args: argparse.Namespace) -> int:
    """Incident bundles (`launch incident`): list the bundles under
    ``<run_dir>/incidents/``, show one's facts, re-render its
    POSTMORTEM.md, or, with ``--trigger``, fire the flight-recorder
    and profiler-burst machinery by hand and assemble a bundle for a
    drill."""
    import json  # noqa: PLC0415
    import time  # noqa: PLC0415

    from distlr_tpu_torch.obs import incident  # noqa: PLC0415

    cfg = _config_from_args(args)
    if not cfg.obs_run_dir:
        print("error: incident needs --obs-run-dir", file=sys.stderr)
        return 2
    dirs = cfg.obs_run_dir.split(os.pathsep)
    if args.trigger:
        log.info("manual incident trigger (%s): dumping rings, waiting "
                 "%.1fs settle for bursts", args.trigger,
                 cfg.incident_settle_s)
        path = incident.manual_trigger(
            dirs, args.trigger, window_s=cfg.incident_window_s,
            settle_s=cfg.incident_settle_s)
        if path is None:
            print("error: bundle for this trigger seq already exists",
                  file=sys.stderr)
            return 1
        print(f"INCIDENT {path}", flush=True)
        return 0
    if args.action == "list":
        incidents = incident.list_incidents(dirs[0])
        for doc in incidents:
            when = time.strftime(
                "%H:%M:%S", time.localtime(doc.get("detected_ts", 0)))
            n = sum((doc.get("events") or {}).values())
            print(f"{doc['seq']:04d}  {when}  {doc.get('reason', '?'):24s} "
                  f"events={n:<4d} {doc['path']}", flush=True)
        return 0 if incidents else 1
    seq = args.seq
    if seq is None:
        seq = incident.latest_seq(dirs[0])
    if seq is None:
        print(f"error: no incident bundles under {dirs[0]}/incidents",
              file=sys.stderr)
        return 1
    if args.action == "show":
        doc = incident.load(dirs[0], seq)
        if doc is None:
            print(f"error: no bundle for seq {seq}", file=sys.stderr)
            return 1
        print(json.dumps(doc, indent=1))
        return 0
    # render
    path = incident.render(dirs[0], seq)
    if path is None:
        print(f"error: no bundle for seq {seq}", file=sys.stderr)
        return 1
    print(f"INCIDENT {path}", flush=True)
    return 0


def cmd_autopilot(args: argparse.Namespace) -> int:
    """Fleet autopilot (:mod:`distlr_tpu_torch.autopilot`): the closed
    control loop over the elastic fleet.  Polls obs-agg's
    ``/fleet.json``, reduces it to signals (cumulative percentiles +
    windowed rates), and drives whichever actuators were bound:
    ``--ps-ctl`` scales the elastic server group, ``--router`` +
    ``--replica-pool`` promotes/demotes standby serving replicas,
    ``--worker-cmd`` spawns/retires online-worker subprocesses.  Every
    decision journals to ``<journal-dir>/autopilot/decisions.jsonl``;
    a bound ``distlr_alert_*`` firing inside the rollback window
    reverts the last action (the ``launch rollout`` fail-safe,
    repurposed).  Needs no card, like route, rollout and obs-agg."""
    import json  # noqa: PLC0415
    import signal  # noqa: PLC0415

    from distlr_tpu_torch.autopilot import (  # noqa: PLC0415
        Actuators,
        AutopilotDaemon,
        EngineActuator,
        PolicyConfig,
        PolicyEngine,
        PSActuator,
        WorkerActuator,
        fleet_fetcher,
    )
    from distlr_tpu_torch.obs.federate import discover_endpoints  # noqa: PLC0415
    from distlr_tpu_torch.serve.rollout import fleet_alert_poller  # noqa: PLC0415

    cfg = _config_from_args(args)
    run_dir = (cfg.obs_run_dir.split(os.pathsep)[0]
               if cfg.obs_run_dir else None)
    fleet_url = args.fleet
    if not fleet_url and run_dir:
        aggs = [e for e in discover_endpoints(run_dir)
                if e["role"] == "obs-agg"]
        if aggs:
            fleet_url = f"http://{aggs[-1]['host']}:{aggs[-1]['port']}"
    if not fleet_url:
        print("error: no fleet source — pass --fleet http://host:port or "
              "an --obs-run-dir with a running obs-agg (the autopilot is "
              "blind without /fleet.json)", file=sys.stderr)
        return 2
    if args.router and not args.replica_pool:
        print("error: --router needs --replica-pool (the standby "
              "replicas the autopilot may promote into rotation)",
              file=sys.stderr)
        return 2
    if not (args.ps_ctl or args.router or args.worker_cmd):
        print("error: nothing to actuate — bind at least one of "
              "--ps-ctl, --router (+--replica-pool), --worker-cmd",
              file=sys.stderr)
        return 2
    try:
        actuators = Actuators(
            ps=PSActuator(args.ps_ctl) if args.ps_ctl else None,
            engine=(EngineActuator(
                args.router,
                [a.strip() for a in args.replica_pool.split(",")
                 if a.strip()],
                model=args.engine_model)
                if args.router else None),
            worker=(WorkerActuator(args.worker_cmd)
                    if args.worker_cmd else None),
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    poller = None
    if not args.unwatched:
        names = ([n.strip() for n in args.alerts.split(",") if n.strip()]
                 if args.alerts else None)
        poller = fleet_alert_poller(fleet_url, names=names)
    journal_dir = args.journal_dir or run_dir
    with _obs_scope(cfg, "autopilot", _obs_rank(args)):
        daemon = AutopilotDaemon(
            PolicyEngine(PolicyConfig.from_config(cfg)),
            actuators,
            fetch=fleet_fetcher(fleet_url),
            alert_poll=poller,
            interval_s=cfg.autopilot_interval_s,
            journal_dir=journal_dir,
            rate_window_s=cfg.autopilot_rate_window_s,
        )
        if run_dir:
            seeded = daemon.seed_rates_from_history(run_dir)
            if seeded:
                log.info("autopilot: seeded rate window from %d "
                         "history rows", seeded)
        # Scriptable contract, like METRICS/ROLLOUT/HOSTS.
        print("AUTOPILOT " + json.dumps({
            "fleet": fleet_url,
            "actuators": [a for a, on in (
                ("ps", args.ps_ctl), ("engine", args.router),
                ("worker", args.worker_cmd)) if on],
            "journal": daemon.journal_path,
        }), flush=True)
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
        try:
            if args.iterations is not None:
                for _ in range(args.iterations):
                    daemon.tick_once()
                    daemon._stop.wait(daemon.interval_s)
                actuators.close()
            else:
                daemon.run_forever()
        except KeyboardInterrupt:
            return 130
        finally:
            print("AUTOPILOT-EXIT " + json.dumps(daemon.status()),
                  flush=True)
    return 0


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
                    "alerts gate the ramp; default: the obs-agg discovered under "
                    "--obs-run-dir")
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
                    help="journal the transitions under DIR/rollout/ (default: the first "
                    "--obs-run-dir)")
    ro.set_defaults(fn=cmd_rollout)

    ta = config_parser("trace-agg", help="merge every rank's distributed-trace span journal "
                       "(Python and native KV servers) into one Chrome/Perfetto trace with "
                       "clock-skew alignment and chaos-fault markers")
    ta.add_argument("--out", default="merged_trace.json",
                    help="output Chrome trace-event JSON path (default "
                    "merged_trace.json; open in Perfetto)")
    ta.set_defaults(fn=cmd_trace_agg)

    fr = config_parser("flightrec", help="trigger a flight-recorder dump: every process on "
                       "the run dir writes its ring of recent (even unsampled) spans to "
                       "<run_dir>/flightrec/")
    fr.add_argument("--reason", default="manual",
                    help="reason string recorded in the trigger and the dumps "
                    "(default 'manual')")
    fr.set_defaults(fn=cmd_flightrec)

    ap = config_parser(
        "autopilot",
        help="fleet autopilot: closed-loop scaling daemon — polls "
             "obs-agg's /fleet.json and drives ps-ctl RESIZE, router "
             "ADDREPLICA/DELREPLICA over a standby pool, and online-"
             "worker subprocesses through banded hysteresis with "
             "rollback-on-alert; every decision journals to "
             "<journal-dir>/autopilot/decisions.jsonl",
    )
    ap.add_argument("--fleet",
                    help="obs-agg URL (http://host:port) polled for "
                    "/fleet.json; default: discovered from "
                    "--obs-run-dir")
    ap.add_argument("--ps-ctl", dest="ps_ctl",
                    help="elastic group coordinator host:port (what "
                    "`launch ps-server --elastic` announced as PSCTL): "
                    "binds the ps actuator (non-blocking RESIZE wait=0)")
    ap.add_argument("--router",
                    help="routing front-end host:port (ROUTING): binds "
                    "the engine actuator; needs --replica-pool")
    ap.add_argument("--replica-pool", dest="replica_pool",
                    help="comma-separated host:port of PRE-STARTED "
                    "standby `launch serve` replicas the autopilot may "
                    "promote into rotation (idle standbys evict their "
                    "weights, so parked capacity is cheap)")
    ap.add_argument("--engine-model", dest="engine_model",
                    default="default",
                    help="router model id whose replica set is scaled "
                    "(default 'default')")
    ap.add_argument("--worker-cmd", dest="worker_cmd",
                    help="online-worker command template with a "
                    "{worker_id} placeholder, e.g. \"python -m "
                    "distlr_tpu_torch.launch online ... --worker-id "
                    "{worker_id}\": binds the worker actuator "
                    "(spawn/SIGTERM-retire; the .claim shard protocol "
                    "makes churn exactly-once)")
    ap.add_argument("--alerts",
                    help="comma-separated alert gauge names that gate "
                    "rollback (default: every distlr_alert_*; bind "
                    "explicit names when routine shed/latency alerts "
                    "are expected during scale-up)")
    ap.add_argument("--unwatched", action="store_true",
                    help="no alert gate: never roll an action back "
                    "(tests/dev only)")
    ap.add_argument("--journal-dir", dest="journal_dir",
                    help="journal decisions under DIR/autopilot/ "
                    "(default: the first --obs-run-dir)")
    ap.add_argument("--iterations", type=int,
                    help="run N ticks then exit cleanly (default: "
                    "until SIGTERM/Ctrl-C)")
    ap.add_argument("--interval", dest="autopilot_interval_s", type=float,
                    help="tick period, seconds (default 2)")
    ap.add_argument("--hysteresis-ticks", dest="autopilot_hysteresis_ticks",
                    type=int,
                    help="consecutive breached ticks before a band may "
                    "act (default 2)")
    ap.add_argument("--cooldown", dest="autopilot_cooldown_s", type=float,
                    help="per-actuator seconds after an action during "
                    "which that actuator holds (default 10)")
    ap.add_argument("--rollback-window", dest="autopilot_rollback_window_s",
                    type=float,
                    help="seconds after an action inside which a firing "
                    "bound alert reverts it (default 60)")
    ap.add_argument("--ps-min", dest="autopilot_ps_min", type=int,
                    help="server-count floor (default 1)")
    ap.add_argument("--ps-max", dest="autopilot_ps_max", type=int,
                    help="server-count ceiling (default 8)")
    ap.add_argument("--engine-min", dest="autopilot_engine_min", type=int,
                    help="in-rotation replica floor (default 1)")
    ap.add_argument("--engine-max", dest="autopilot_engine_max", type=int,
                    help="in-rotation replica ceiling (default 8)")
    ap.add_argument("--worker-min", dest="autopilot_worker_min", type=int,
                    help="online-worker floor (default 1)")
    ap.add_argument("--worker-max", dest="autopilot_worker_max", type=int,
                    help="online-worker ceiling (default 8)")
    ap.add_argument("--staleness-high", dest="autopilot_staleness_high",
                    type=float,
                    help="staleness_pushes_p99 above which the ps band "
                    "scales up (default 64)")
    ap.add_argument("--push-rate-high", dest="autopilot_push_rate_high",
                    type=float,
                    help="fleet pushes/s PER SERVER above which the ps "
                    "band scales up (default 200)")
    ap.add_argument("--push-rate-low", dest="autopilot_push_rate_low",
                    type=float,
                    help="fleet pushes/s per server below which the ps "
                    "band scales down (default 20)")
    ap.add_argument("--shed-rate-high", dest="autopilot_shed_rate_high",
                    type=float,
                    help="router sheds/s above which the engine band "
                    "scales up (default 0.5)")
    ap.add_argument("--route-p99-high", dest="autopilot_route_p99_high_ms",
                    type=float,
                    help="route p99 ms above which the engine band "
                    "scales up (default 250)")
    ap.add_argument("--req-rate-low", dest="autopilot_req_rate_low",
                    type=float,
                    help="requests/s PER REPLICA below which (with zero "
                    "shed) the engine band scales down (default 5)")
    ap.add_argument("--lag-high", dest="autopilot_lag_high", type=float,
                    help="pending feedback shards above which the "
                    "worker band scales up (default 4)")
    ap.add_argument("--lag-low", dest="autopilot_lag_low", type=float,
                    help="pending feedback shards below which the "
                    "worker band scales down (default 1)")
    ap.add_argument("--rate-window", dest="autopilot_rate_window_s",
                    type=float,
                    help="horizon of the windowed push/shed/req rates, "
                    "seconds (default 10)")
    ap.set_defaults(fn=cmd_autopilot)

    a = config_parser(
        "obs-agg",
        help="fleet metrics aggregator: merge every rank's /metrics into "
             "one scrape + /fleet.json (+ derived distlr_alert_* gauges)",
    )
    a.add_argument("--interval", type=float, default=2.0,
                   help="scrape period, seconds (default 2)")
    a.add_argument("--stale-after", dest="stale_after", type=float,
                   help="seconds without a successful scrape before a rank "
                   "counts stale->down and distlr_alert_scrape_stale fires "
                   "(default 10; overrides a thresholds-file value)")
    a.add_argument("--thresholds-file", dest="thresholds_file",
                   help="JSON object overriding AlertThresholds fields "
                   "(barrier_wait_ratio, barrier_min_count, "
                   "push_error_rate, scrape_stale_s, weight_age_ratio); "
                   "explicit CLI flags win over the file, and the "
                   "distlr_alert_* threshold labels reflect the effective "
                   "values")
    a.add_argument("--alert-barrier-wait-ratio",
                   dest="alert_barrier_wait_ratio", type=float,
                   help="barrier-wait p99 alert fires above this multiple "
                   "of the median step time (default 2)")
    a.add_argument("--alert-barrier-min-count",
                   dest="alert_barrier_min_count", type=int,
                   help="minimum barrier-wait observations before the "
                   "stall alert may fire (default 8)")
    a.add_argument("--alert-push-error-rate", dest="alert_push_error_rate",
                   type=float,
                   help="PS push error+timeout rate above which "
                   "distlr_alert_ps_push_errors fires (default 0.01)")
    a.add_argument("--alert-weight-age-ratio", dest="alert_weight_age_ratio",
                   type=float,
                   help="async weight age alert fires above this multiple "
                   "of the median step time (default 10)")
    a.add_argument("--alert-retry-rate", dest="alert_retry_rate", type=float,
                   help="distlr_alert_ps_retry_rate fires above this "
                   "fleet share of KV op attempts that are in-place "
                   "retry re-issues (default 0.05) — degradation the "
                   "resilience layer is absorbing, visible before errors")
    a.add_argument("--alert-shadow-psi", dest="alert_shadow_psi",
                   type=float,
                   help="distlr_alert_shadow_psi fires per (tenant, "
                   "candidate) when the shadow-scored candidate's score "
                   "distribution diverges from its primary's past this "
                   "PSI (default 0.25) — the candidate-attributed "
                   "evidence `launch rollout`'s scoped gate binds")
    a.add_argument("--once", action="store_true",
                   help="scrape+merge once and exit: print the fleet "
                   "Prometheus text (or write --snapshot-path) instead of "
                   "serving — how capture scripts bank a fleet snapshot")
    a.add_argument("--snapshot-path", dest="snapshot_path",
                   help="with --once: write the merged fleet registry here "
                   "(.json = JSON snapshot, else Prometheus text)")
    a.add_argument("--slo-file", dest="slo_file",
                   help="SLO spec JSON: objectives over tsdb SLI "
                   "expressions, compiled into error-budget gauges "
                   "(distlr_slo_*) and multi-window burn-rate alerts "
                   "(distlr_alert_slo_burn{slo,window}) evaluated every "
                   "scrape (distlr_tpu_torch/obs/slo.py documents the file)")
    a.add_argument("--obs-tsdb-raw-points", dest="obs_tsdb_raw_points",
                   type=int,
                   help="embedded tsdb raw-ring size per series, in "
                   "scrape frames (default 512)")
    a.add_argument("--obs-tsdb-rollup-retention-s",
                   dest="obs_tsdb_rollup_retention_s", type=float,
                   help="seconds of 10s/60s rollup history kept per "
                   "series (default 3600); evictions count into "
                   "distlr_tsdb_points_dropped_total")
    a.add_argument("--obs-tsdb-history-lines",
                   dest="obs_tsdb_history_lines", type=int,
                   help="lines per on-disk history.jsonl segment before "
                   "rotation (default 2000; one rotated segment kept)")
    a.set_defaults(fn=cmd_obs_agg)

    fq = sub.add_parser(
        "fleet-query",
        help="evaluate one time-series expression (rate / increase / "
             "histogram_quantile / *_over_time + label matchers and "
             "arithmetic) against a running obs-agg's embedded tsdb "
             "and print the JSON result",
    )
    fq.add_argument("expr",
                    help="the expression, e.g. "
                    "'rate(route_requests{role=route})' or "
                    "'histogram_quantile(0.99, "
                    "distlr_route_request_seconds)'")
    fq.add_argument("--obs-run-dir", dest="obs_run_dir",
                    help="fleet run dir: discovers the running obs-agg's "
                    "endpoint file")
    fq.add_argument("--fleet", help="aggregator URL (http://host:port) — "
                    "overrides --obs-run-dir discovery")
    fq.add_argument("--window", type=float, default=60.0,
                    help="trailing evaluation window, seconds (default "
                    "60)")
    fq.add_argument("--timeout", type=float, default=5.0,
                    help="HTTP timeout, seconds (default 5)")
    fq.set_defaults(fn=cmd_fleet_query)

    pa = config_parser(
        "prof-agg",
        help="merge every rank's continuous-profiling journal (Python "
             "samplers + native KV-server CPU windows) into a fleet "
             "collapsed-stack file and a speedscope JSON, one track per "
             "rank",
    )
    pa.add_argument("--out", default="fleet_profile",
                    help="output stem: writes <out>.collapsed "
                    "(flamegraph.pl/inferno) and <out>.speedscope.json "
                    "(speedscope.app); default fleet_profile")
    pa.set_defaults(fn=cmd_prof_agg)

    pr = config_parser(
        "profrec",
        help="trigger an on-demand profile burst: every sampler on the "
             "run dir captures at high Hz once and journals one burst "
             "window (the profiler-only twin of flightrec)",
    )
    pr.add_argument("--reason", default="manual",
                    help="reason string recorded in the trigger + burst "
                    "windows (default 'manual')")
    pr.set_defaults(fn=cmd_profrec)

    t = sub.add_parser(
        "top",
        help="live terminal dashboard over a fleet scrape (per-rank step "
             "rate, op latencies, staleness, firing alerts)",
    )
    t.add_argument("--obs-run-dir", dest="obs_run_dir",
                   help="fleet run dir: discovers the running obs-agg's "
                   "endpoint file")
    t.add_argument("--fleet", help="aggregator URL (http://host:port) — "
                   "overrides --obs-run-dir discovery")
    t.add_argument("--interval", type=float, default=1.0,
                   help="refresh period, seconds (default 1)")
    t.add_argument("--iterations", type=int,
                   help="render N frames then exit (default: until Ctrl-C)")
    t.add_argument("--no-color", dest="no_color", action="store_true",
                   help="plain text frames (no ANSI colors/clears)")
    t.add_argument("--rate-window", dest="rate_window", type=int, default=10,
                   help="frames of history behind the windowed req/s and "
                   "push/s columns (default 10 scrapes)")
    t.add_argument("--replay", dest="replay",
                   help="scrub a PAST incident offline: render this "
                   "banked scrape history (<run_dir>/history.jsonl, "
                   "written by the aggregator) frame by frame instead of "
                   "polling a live fleet")
    t.add_argument("--replay-interval", dest="replay_interval", type=float,
                   default=0.0,
                   help="seconds between replayed frames (default 0 = "
                   "as fast as the terminal draws)")
    t.set_defaults(fn=cmd_top)

    lg = config_parser(
        "logs",
        help="query the fleet's structured log journals: tail/grep/"
             "level-filter across every rank, or follow one request "
             "with --trace",
    )
    lg.add_argument("--level", choices=["debug", "info", "warning",
                                        "error"],
                    help="minimum record level (default: all journaled)")
    lg.add_argument("--grep", help="only records whose message contains "
                    "this substring")
    lg.add_argument("--trace", help="only this trace id's records, "
                    "interleaved with its spans (one request's story)")
    lg.add_argument("--tail", type=int, default=0,
                    help="print only the last N events (default 0 = all)")
    lg.add_argument("--json", action="store_true",
                    help="one JSON object per line instead of text")
    lg.set_defaults(fn=cmd_logs)

    inc = config_parser(
        "incident",
        help="incident bundles: list/show/render the postmortem bundles "
             "obs-agg assembles on alert edges, or --trigger a manual "
             "drill bundle",
    )
    inc.add_argument("action", nargs="?", default="list",
                     choices=["list", "show", "render"],
                     help="list bundles, show one's facts as JSON, or "
                     "(re-)render its POSTMORTEM.md (default: list)")
    inc.add_argument("--seq", type=int,
                     help="bundle sequence (default: the newest)")
    inc.add_argument("--trigger", metavar="REASON",
                     help="fire the flight-recorder/profiler dump "
                     "machinery now and assemble a manual bundle with "
                     "this reason")
    inc.set_defaults(fn=cmd_incident)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
