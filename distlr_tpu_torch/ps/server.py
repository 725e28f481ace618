"""Server-group lifecycle: S native KV server processes on localhost (the
port's ``ServerGroup``, from ``distlr_tpu/ps/server.py``).

Replaces the reference launcher's server-spawning half
(``examples/local.sh:36-41``: S ``distlr`` processes with
``DMLC_ROLE=server``) with a context-managed group of the port's own
``distlr_kv_server`` build, one per key range.  The update rule is the
servers' own: ``sgd`` (the reference's ``w -= lr * g``), ``ftrl``
(per-coordinate FTRL-Proximal with z and n accumulators) or ``signsgd``
(the majority vote of 1-bit pushes), group-wide or a namespace slice at a
time (``opt_segments``).

:meth:`ServerGroup.respawn` restarts a dead rank on its original port, and
:class:`ServerSupervisor` does so on its own for an async group, then
re-seeds the rank from a rolling snapshot (its FTRL ``z``/``n`` too).
With ``store_dir`` each rank persists crash-consistent snapshots of its
slice (and, with ``store_wal``, a log of every applied push) under
``<store_dir>/rank-<r>/`` and recovers from them when it starts, so a
group restarted on the same directory comes back where it stopped
(:mod:`distlr_tpu_torch.ps.store` reads those files).  ``via_chaos`` puts
a fault plan's proxies (:mod:`distlr_tpu_torch.chaos`) between the
clients and the servers.

An async group can be resized live: :func:`plan_reshard` computes which
ranks survive, which are spawned and which key sub-ranges move,
:meth:`ServerGroup.spawn_for_resize` stages the new ranks at the next
membership epoch and :meth:`ServerGroup.commit_resize` installs the new
layout; :class:`~distlr_tpu_torch.ps.membership.MembershipCoordinator`
runs them around its fence and drain.

The group and its supervisor record the JAX package's series: spawns and
liveness by rank (``distlr_ps_server_spawns_total``,
``distlr_ps_server_up``, also the attribute :attr:`ServerGroup.up`), the
layout's rank count (``distlr_membership_servers``, also
``membership_servers``), every health probe's kStats counters
(``distlr_ps_server_stat``, ``distlr_kv_server_cpu_seconds``), the
supervisor's events (``distlr_ps_supervisor_events_total``), its
snapshot cycles (``distlr_ps_supervisor_snapshot_seconds``) and a durable
group's store health (``distlr_ps_store_*``, also
:attr:`ServerSupervisor.store_health`).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from distlr_tpu_torch.obs.registry import get_registry
from distlr_tpu_torch.ps import wire
from distlr_tpu_torch.ps.build import native_variant, sanitizer_environ, server_binary
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_reg = get_registry()
_SPAWNS = _reg.counter(
    "distlr_ps_server_spawns_total",
    "native KV server processes spawned (incl. supervisor respawns)",
    labelnames=("rank",),
)
_UP = _reg.gauge(
    "distlr_ps_server_up",
    "1 while this server rank's process is managed and running",
    labelnames=("rank",),
)
#: kStats counters of the native servers, refreshed by every health()
#: probe (the native process cannot scrape itself — the Python side
#: mirrors its protocol counters into the registry).
_SERVER_STAT = _reg.gauge(
    "distlr_ps_server_stat",
    "latest health-probe value of each native server kStats counter",
    labelnames=("rank", "stat"),
)
#: Per-handler thread-CPU seconds of the native server ranks, mirrored
#: from the kStats CPU extension by every health() probe — the series a
#: fleet flamegraph's Python edge lines up against the C++ side with.
_SERVER_CPU = _reg.gauge(
    "distlr_kv_server_cpu_seconds",
    "cumulative per-handler thread CPU seconds inside the native KV "
    "server (CLOCK_THREAD_CPUTIME_ID around each dispatch: payload "
    "read + decode + apply, never socket wait), from the latest "
    "health probe",
    labelnames=("rank", "handler"),
)
_SUP_EVENTS = _reg.counter(
    "distlr_ps_supervisor_events_total",
    "supervisor audit-trail events (respawned/reseeded/seeded-zeros/"
    "gave-up/respawn-failed/reseeded-from-store/store-stale/"
    "store-corrupt-fallback)",
    labelnames=("event",),
)
#: Durable-store health, scanned from each rank's on-disk state
#: (ps/store.py) by the supervisor's snapshot cycles when the group
#: runs with a --store_dir.
_STORE_SNAPSHOT_AGE = _reg.gauge(
    "distlr_ps_store_snapshot_age_seconds",
    "age of this rank's newest VALID on-disk snapshot generation (the "
    "worst-case RPO window when the WAL is off)",
    labelnames=("rank",),
)
_STORE_BYTES = _reg.gauge(
    "distlr_ps_store_bytes",
    "on-disk durable-store footprint per rank",
    labelnames=("rank", "kind"),
)
_STORE_WAL_LAG = _reg.gauge(
    "distlr_ps_store_wal_lag_records",
    "intact WAL records past this rank's newest valid snapshot — the "
    "replay depth a cold restart pays (snapshot lag, not data loss)",
    labelnames=("rank",),
)
_STORE_CORRUPT = _reg.gauge(
    "distlr_ps_store_corrupt_generations",
    "snapshot generations on disk currently rejected as torn/corrupt "
    "(>0 means the store is one failure from losing its fallback)",
    labelnames=("rank",),
)
_SNAPSHOT_SECONDS = _reg.histogram(
    "distlr_ps_supervisor_snapshot_seconds",
    "wall seconds per supervisor rolling-snapshot cycle",
)
_MEMBERSHIP_SERVERS = _reg.gauge(
    "distlr_membership_servers",
    "server ranks in the group's CURRENT layout (moves on an elastic "
    "resize, not on crashes — crash visibility is distlr_ps_server_up)",
)


OPTIMIZERS = ("sgd", "ftrl", "signsgd")
#: the supervisor's events of a durable group's recovery
STORE_EVENTS = ("reseeded-from-store", "store-stale", "store-corrupt-fallback")


@dataclasses.dataclass(frozen=True)
class ResizePlan:
    """One membership change (``distlr_tpu/ps/server.py:101``): which old
    processes survive as which new ranks, which new ranks are spawned,
    which old ranks retire, and which global key sub-ranges move (pulled
    from their old owner, force-seeded into the new one)."""

    new_num_servers: int
    #: the global key slice of each new rank
    new_ranges: list[tuple[int, int]]
    #: new rank -> the old rank whose process survives as it (same range
    #: start, so the server's local keys stay valid; its resident slice
    #: never crosses the wire)
    reuse: dict[int, int]
    #: new ranks that need a fresh process
    spawn: list[int]
    #: old ranks with no new identity, retired after the drain
    retire: list[int]
    #: (old_rank, global_lo, global_hi, new_rank): the data that moves
    moves: list[tuple[int, int, int, int]]

    @property
    def moved_keys(self) -> int:
        return sum(hi - lo for _, lo, hi, _ in self.moves)


def plan_reshard(dim: int, old_ranges: list[tuple[int, int]], new_num_servers: int, *,
                 alive: list[bool], allow_reuse: bool = True) -> ResizePlan:
    """The planner's pure core (``distlr_tpu/ps/server.py:129``): the
    current layout -> equal ranges over ``new_num_servers``.  ``alive[r]``
    says whether old rank ``r``'s process survives (a dead one is never
    reused); ``allow_reuse=False`` is the full rebuild of FTRL and
    ``opt_segments`` groups.

    An alive old rank is reused as the new rank whose range starts where
    its own did: the server stores keys rebased by its range start, so a
    grown range extends and a shrunk one stops being addressed.  Every key
    of a new range is then resident or covered by exactly one move.
    """
    if new_num_servers < 1:
        raise ValueError(f"new_num_servers must be >= 1, got {new_num_servers}")
    if new_num_servers > dim:
        raise ValueError(f"cannot shard dim={dim} over {new_num_servers} servers (empty ranges)")
    if len(alive) != len(old_ranges):
        raise ValueError(f"alive has {len(alive)} entries for {len(old_ranges)} ranks")
    n = int(new_num_servers)
    new_ranges = [(dim * r // n, dim * (r + 1) // n) for r in range(n)]
    reuse: dict[int, int] = {}
    if allow_reuse:
        old_by_begin = {lo: r for r, (lo, _hi) in enumerate(old_ranges) if alive[r]}
        for nr, (lo, _hi) in enumerate(new_ranges):
            r = old_by_begin.get(lo)
            if r is not None and r not in reuse.values():
                reuse[nr] = r
    moves: list[tuple[int, int, int, int]] = []
    for nr, (lo, hi) in enumerate(new_ranges):
        res_hi = min(old_ranges[reuse[nr]][1], hi) if nr in reuse else lo
        for o, (olo, ohi) in enumerate(old_ranges):
            mlo, mhi = max(olo, res_hi), min(ohi, hi)
            if mlo < mhi:
                moves.append((o, mlo, mhi, nr))
    return ResizePlan(new_num_servers=n, new_ranges=new_ranges, reuse=reuse,
                      spawn=[nr for nr in range(n) if nr not in reuse],
                      retire=[r for r in range(len(old_ranges)) if r not in reuse.values()],
                      moves=moves)


def _reap(proc: subprocess.Popen, *, terminate: bool = False) -> None:
    """Wait out a server process (SIGKILL after 5 s) and close its pipe."""
    if terminate and proc.poll() is None:
        proc.terminate()
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    if proc.stdout:
        proc.stdout.close()


class ServerGroup:
    """Spawn and manage S native KV server processes on localhost.

    Server rank ``r`` owns global keys ``[r*D/S, (r+1)*D/S)``, the ps-lite
    range partition (reference ``src/main.cc:98-101``); the client slices
    requests to match.  Each server binds port 0 and announces the port
    the kernel chose as ``PORT <n>`` on stdout, so groups started side by
    side never collide; ``ports`` fixes them instead, and ``bind_any``
    listens on 0.0.0.0 for workers on other hosts.  ``sync=True`` is BSP
    (a push is answered when all ``num_workers`` pushed, then one update
    is applied), else Hogwild (each push applied at once);
    ``last_gradient`` is the reference's Q1 update (the highest-rank
    worker's gradient / W instead of the mean).  ``optimizer`` and the
    ``ftrl_*`` parameters pick the update rule; ``opt_segments``, global
    ``(end, "sgd"|"ftrl")`` pairs, give each namespace slice its own.

    ``store_dir`` arms the servers' durable store: a snapshot of each
    rank's slice every ``store_interval_s`` seconds (and on SIGUSR1), two
    generations kept, and with ``store_wal`` (async groups only) a log of
    every applied push, group-committed to disk every
    ``store_wal_fsync_s`` seconds.  A rank that starts on a non-empty
    directory restores the newest valid snapshot and replays the log past
    it.  ``via_chaos``, a :class:`~distlr_tpu_torch.chaos.FaultPlan`,
    starts a :class:`~distlr_tpu_torch.chaos.ChaosFabric` with the group:
    :attr:`hosts` then names its proxies and :attr:`direct_hosts` the
    servers, and the plan's ``kill`` faults SIGKILL this group's ranks.
    ``epoch`` is the membership epoch the servers start at (1, the
    static default, leaves their command lines as without it).
    ``trace_journal_dir`` makes each rank journal the handler spans of
    trace-stamped ops to ``<dir>/kvserver-<rank>.jsonl`` (the native half
    of the span journals ``launch trace-agg`` merges); respawns and resize
    spawns keep it, and None leaves the command line as without it.
    ``prof_journal_dir`` likewise makes each rank journal its per-handler
    thread-CPU windows (every ``prof_window_s`` seconds; None keeps the
    server's 10) to ``<dir>/kvserver-<rank>.jsonl``, the native half of
    the profile journals ``launch prof-agg`` merges.
    ``binary`` is the server executable of every spawn; by default the
    build of the sanitizer variant ``DISTLR_NATIVE_VARIANT`` names when
    the group is made (:mod:`distlr_tpu_torch.ps.build`), spawned with
    that variant's options.
    """

    def __init__(self, num_servers: int, num_workers: int, dim: int, *,
                 learning_rate: float = 0.2, sync: bool = True,
                 last_gradient: bool = False, ports: list[int] | None = None,
                 bind_any: bool = False, optimizer: str = "sgd",
                 ftrl_alpha: float = 0.1, ftrl_beta: float = 1.0,
                 ftrl_l1: float = 0.0, ftrl_l2: float = 0.0, compress: bool = True,
                 opt_segments: list[tuple[int, str]] | None = None, via_chaos=None,
                 store_dir: str | None = None, store_interval_s: float = 5.0,
                 store_wal: bool = False, store_wal_fsync_s: float = 0.1, epoch: int = 1,
                 binary=None, trace_journal_dir: str | None = None,
                 prof_journal_dir: str | None = None, prof_window_s: float | None = None):
        if not 1 <= epoch <= wire.AUX_MAX:
            # membership epochs ride the u16 MsgHeader::aux field
            raise ValueError(f"epoch must be in [1, {wire.AUX_MAX}], got {epoch}")
        if num_servers < 1 or num_servers > dim:
            raise ValueError(f"need 1 <= num_servers <= dim={dim}, got {num_servers}")
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer must be sgd|ftrl|signsgd, got {optimizer!r}")
        if opt_segments:
            # per-namespace optimizers: global (end, opt) pairs, ascending,
            # covering [0, dim); each rank gets its slice as local keys
            if optimizer == "signsgd" or last_gradient:
                raise ValueError(
                    "opt_segments is incompatible with optimizer='signsgd' "
                    "and last_gradient (uniform-group semantics)")
            prev = 0
            for end, opt in opt_segments:
                if opt not in ("sgd", "ftrl"):
                    raise ValueError(f"segment optimizer must be sgd|ftrl, got {opt!r}")
                if end <= prev:
                    raise ValueError(f"opt_segments ends must ascend, got {opt_segments}")
                prev = end
            if prev != dim:
                raise ValueError(f"opt_segments must cover [0, dim={dim}), got end {prev}")
        if store_wal and not store_dir:
            raise ValueError(
                "store_wal requires store_dir (the WAL lives in the "
                "same per-rank store directory)")
        if store_wal and sync:
            # the native server refuses it too: a sync round's merge buffer
            # has no per-push replay semantics
            raise ValueError(
                "store_wal requires an async (sync=False) group — "
                "sync-round merge state has no per-push replay semantics")
        if store_dir and store_interval_s <= 0:
            raise ValueError(
                f"store_interval_s must be positive, got {store_interval_s}")
        if store_wal and store_wal_fsync_s <= 0:
            raise ValueError(
                f"store_wal_fsync_s must be positive, got {store_wal_fsync_s}")
        if optimizer != "sgd" and last_gradient:
            # Q1 is a reference-SGD parity quirk: there is no "last
            # worker's FTRL step or vote / W" to mirror
            raise ValueError(
                f"optimizer={optimizer!r} is incompatible with "
                "last_gradient (Q1 compat is an SGD parity quirk)")
        #: the sanitizer variant of this group's spawns, read once here
        #: (``DISTLR_NATIVE_VARIANT``; a bogus value raises now): every
        #: spawn, a respawn and a resize's too, runs the same build with
        #: the same sanitizer environment
        self.variant = native_variant()
        self._binary = binary
        self.num_servers = num_servers
        self.num_workers = num_workers
        self.dim = dim
        self.learning_rate = learning_rate
        self.sync = sync
        self.last_gradient = last_gradient
        self.bind_any = bind_any
        self.optimizer = optimizer
        self.ftrl = (ftrl_alpha, ftrl_beta, ftrl_l1, ftrl_l2)
        #: False spawns --compress=0: the servers hide their codec
        #: capabilities and answer kHello as a binary without codecs
        self.compress = compress
        self._opt_segments = list(opt_segments or [])
        self.store_dir = store_dir
        self.store_interval_s = store_interval_s
        self.store_wal = store_wal
        self.store_wal_fsync_s = store_wal_fsync_s
        self.trace_journal_dir = trace_journal_dir
        self.prof_journal_dir = prof_journal_dir
        self.prof_window_s = prof_window_s
        #: the membership epoch new spawns (respawns too) carry; a resize
        #: bumps it
        self.epoch = int(epoch)
        #: the global key slice of each rank: the equal partition at spawn,
        #: rewritten by commit_resize
        self.ranges: list[tuple[int, int]] = [
            (dim * r // num_servers, dim * (r + 1) // num_servers) for r in range(num_servers)]
        self._chaos_plan = via_chaos
        #: the live ChaosFabric once start() ran with a plan
        self.chaos = None
        #: the chaos links in rank order (the fabric keeps creation order,
        #: which a resize leaves behind)
        self._chaos_links: list = []
        #: the JAX package's ``distlr_ps_server_up`` (rank -> 1 while its
        #: process is managed) and ``distlr_membership_servers`` gauges
        self.up: dict[int, int] = {}
        self.membership_servers = 0
        self.ports: list[int] = list(ports or [])
        self.procs: list[subprocess.Popen] = []
        # stop() runs from failing worker threads as well as on exit, and
        # respawn() from the supervisor's
        self._lock = threading.Lock()
        #: set by stop(): a torn-down group is never respawned
        self._stopped = False

    @property
    def binary(self) -> Path:
        """The server executable every spawn of this group runs: the one
        given as ``binary``, else the variant's build (made at first
        use)."""
        if self._binary is None:
            self._binary = server_binary(self.variant)
        return Path(self._binary)

    @property
    def hosts(self) -> str:
        """Client connection spec, server-rank order: the fault plan's
        proxies when the group rides one (``via_chaos``), so every client
        given it is behind the plan."""
        if self.chaos is not None:
            return ",".join(f"127.0.0.1:{lk.port}" for lk in self._chaos_links)
        return self.direct_hosts

    @property
    def direct_hosts(self) -> str:
        """The server processes' own ports, past any fault plan."""
        return ",".join(f"127.0.0.1:{p}" for p in self.ports)

    @property
    def has_ftrl(self) -> bool:
        """Whether any coordinate of the group runs FTRL (the group's
        optimizer or an ``opt_segments`` namespace): the groups whose z
        and n the opt-state ops move."""
        return self.optimizer == "ftrl" or any(opt == "ftrl" for _, opt in self._opt_segments)

    def key_range(self, rank: int) -> tuple[int, int]:
        """The global key slice ``[lo, hi)`` of ``rank`` in the current
        layout."""
        return self.ranges[rank]

    def store_rank_dir(self, rank: int) -> str:
        """Rank ``rank``'s durable-store directory, where its snapshot
        generations and WAL segments live (the group needs a
        ``store_dir``)."""
        if not self.store_dir:
            raise ValueError("group has no store_dir")
        return os.path.join(self.store_dir, f"rank-{rank}")

    def _local_opt_segments(self, lo: int, hi: int) -> str:
        """``--opt_segments`` of the rank owning global ``[lo, hi)``: the
        global map intersected with the range and rebased to local keys."""
        parts = []
        for end, opt in self._opt_segments:
            start = max(0, min(end, hi) - lo)
            if start > 0 and (not parts or start > int(parts[-1].split(":")[0])):
                parts.append(f"{start}:{opt}")
            if end >= hi:
                break
        return ",".join(parts)

    def _command(self, binary, rank: int, port: int = 0, *,
                 key_range: tuple[int, int] | None = None, epoch: int | None = None) -> list[str]:
        lo, hi = key_range if key_range is not None else self.key_range(rank)
        # the JAX package's spawn, flag for flag: only non-default
        # optimizers and codecs touch the command line, so an sgd group's
        # command stays that of a group without them
        cmd = [
            str(binary), f"--port={port}", f"--num_workers={self.num_workers}",
            f"--dim={hi - lo}", f"--lr={self.learning_rate}", f"--sync={int(self.sync)}",
            f"--last_gradient={int(self.last_gradient)}", f"--bind_any={int(self.bind_any)}",
        ]
        epoch = self.epoch if epoch is None else epoch
        if epoch != 1:
            cmd.append(f"--epoch={epoch}")
        if self._opt_segments:
            segs = self._local_opt_segments(lo, hi)
            if segs:
                cmd.append(f"--opt_segments={segs}")
        alpha, beta, l1, l2 = self.ftrl
        ftrl_flags = [f"--ftrl_alpha={alpha}", f"--ftrl_beta={beta}", f"--ftrl_l1={l1}",
                      f"--ftrl_l2={l2}"]
        if self.optimizer == "ftrl":
            cmd += [f"--optimizer={self.optimizer}", *ftrl_flags]
        elif self.optimizer != "sgd":
            cmd.append(f"--optimizer={self.optimizer}")
        elif self.has_ftrl:
            # an sgd group with FTRL namespaces: their coordinates run the
            # configured hyperparameters, not the server's defaults
            cmd += ftrl_flags
        if not self.compress:
            cmd.append("--compress=0")
        if self.trace_journal_dir:
            cmd.append("--trace_journal="
                       + os.path.join(self.trace_journal_dir, f"kvserver-{rank}.jsonl"))
        if self.prof_journal_dir:
            cmd.append("--prof_journal="
                       + os.path.join(self.prof_journal_dir, f"kvserver-{rank}.jsonl"))
            if self.prof_window_s is not None:
                cmd.append(f"--prof_window={self.prof_window_s}")
        if self.store_dir:
            # a directory a rank: the ranks own disjoint slices.  Only
            # values off the servers' defaults touch the command line
            cmd.append(f"--store_dir={self.store_rank_dir(rank)}")
            if self.store_interval_s != 5.0:
                cmd.append(f"--store_interval={self.store_interval_s}")
            if self.store_wal:
                cmd.append("--store_wal=1")
                if self.store_wal_fsync_s != 0.1:
                    cmd.append(f"--store_wal_fsync={self.store_wal_fsync_s}")
        return cmd

    def _spawn(self, rank: int, port: int, *, key_range: tuple[int, int] | None = None,
               epoch: int | None = None) -> tuple[subprocess.Popen, int]:
        """Start rank ``rank`` on ``port`` (0: the kernel's choice), over
        ``key_range`` and at ``epoch`` (default: the rank's own and the
        group's); returns the process and the port it bound.  A durable
        rank recovers from its store directory before it announces the
        port."""
        if self.store_dir:
            os.makedirs(self.store_rank_dir(rank), exist_ok=True)
        for d in (self.trace_journal_dir, self.prof_journal_dir):
            if d:
                os.makedirs(d, exist_ok=True)
        # a sanitizer variant's spawn carries its options (suppressions
        # forced, the caller's log_path kept); the standard build's gets
        # env=None and inherits this process's environment
        proc = subprocess.Popen(self._command(self.binary, rank, port, key_range=key_range,
                                              epoch=epoch),
                                stdout=subprocess.PIPE, text=True,
                                env=sanitizer_environ(variant=self.variant))
        # the server prints "PORT <n>" once listening: reading it is the
        # readiness wait
        line = proc.stdout.readline().strip()
        if not line.startswith("PORT "):
            _reap(proc, terminate=True)
            raise RuntimeError(f"KV server rank {rank} failed to start (got {line!r})")
        _SPAWNS.labels(rank=rank).inc()
        self._set_up(rank, 1)
        return proc, int(line.split()[1])

    def _set_up(self, rank: int, value: int) -> None:
        self.up[rank] = value
        _UP.labels(rank=rank).set(value)

    def _set_membership(self) -> None:
        self.membership_servers = self.num_servers
        _MEMBERSHIP_SERVERS.set(self.num_servers)

    def start(self) -> "ServerGroup":
        fixed_ports, self.ports = list(self.ports), []
        self._stopped = False
        try:
            for rank in range(self.num_servers):
                proc, port = self._spawn(rank, fixed_ports[rank] if fixed_ports else 0)
                self.procs.append(proc)
                self.ports.append(port)
            if self._chaos_plan is not None and self.chaos is None:
                from distlr_tpu_torch.chaos import ChaosFabric  # noqa: PLC0415

                # one link a rank, to the servers' own ports (a respawn
                # keeps its port, so a link outlives its server); the
                # group owns the pids, so it executes the kill faults
                self.chaos = ChaosFabric(self.direct_hosts, self._chaos_plan,
                                         killer=self._chaos_kill)
                self._chaos_links = list(self.chaos.links)
        except BaseException:
            self.stop()
            raise
        self._set_membership()
        return self

    def _chaos_kill(self, target: str) -> None:
        """The fabric's kill-fault executor: SIGKILL rank N's server
        (``"rank:N"``) or every rank's (``"group"``).  A supervised group
        respawns them, and a durable one recovers from its store."""
        with self._lock:
            if target == "group":
                victims = list(self.procs)
            else:
                rank = int(target.split(":", 1)[1])
                if rank >= len(self.procs):
                    log.warning("chaos kill target %r: no such rank", target)
                    return
                victims = [self.procs[rank]]
        for proc in victims:
            if proc.poll() is None:
                proc.kill()

    def respawn(self, rank: int) -> bool:
        """Restart a dead server on its original port, so the ``hosts``
        every client holds stays valid (``distlr_tpu/ps/server.py:566``).
        The new process starts uninitialized: the caller re-seeds its
        slice with a forced init push.  False when the group is being torn
        down or the rank is alive; raises if the port was taken while the
        rank was down."""
        with self._lock:
            if self._stopped:
                return False
            old = self.procs[rank]
            if old.poll() is None:
                return False
            if old.stdout:
                old.stdout.close()
            proc, port = self._spawn(rank, self.ports[rank])
            if port != self.ports[rank]:
                # clients hold the old hosts string: this process is
                # unreachable, so the respawn fails
                _reap(proc, terminate=True)
                raise RuntimeError(f"respawned server rank {rank} bound port {port}, "
                                   f"expected {self.ports[rank]} (port stolen while down)")
            self.procs[rank] = proc
            return True

    def plan_resize(self, new_num_servers: int) -> ResizePlan:
        """The membership change from the current layout to
        ``new_num_servers`` equal ranges, touching nothing
        (:func:`plan_reshard`).  A sync group and a durable one are
        refused as the JAX package refuses them.  A group with FTRL state
        (uniform or through ``opt_segments``) never reuses a process: the
        opt-state wire seeds whole ranges only, so it is rebuilt in full."""
        if self.sync:
            raise ValueError(
                "elastic resize supports async (Hogwild) groups only — "
                "a sync BSP round cannot straddle a membership change")
        if self.store_dir:
            raise ValueError(
                "elastic resize of a durable (store_dir) group is not "
                "supported: the per-rank on-disk slices would no longer "
                "match the new layout — stop the group, clear or migrate "
                "the store, and restart at the new size")
        return plan_reshard(self.dim, self.ranges, new_num_servers,
                            alive=[p.poll() is None for p in self.procs],
                            allow_reuse=not self.has_ftrl and not self._opt_segments)

    def spawn_for_resize(self, plan: ResizePlan, epoch: int) -> dict[int, tuple]:
        """Spawn the plan's fresh ranks at the new epoch on ephemeral
        ports: ``{new_rank: (proc, port)}``, staged outside the layout
        until :meth:`commit_resize` (or stopped by an aborted resize)."""
        staged: dict[int, tuple] = {}
        try:
            for nr in plan.spawn:
                staged[nr] = self._spawn(nr, 0, key_range=plan.new_ranges[nr], epoch=epoch)
        except Exception:
            for proc, _port in staged.values():
                _reap(proc, terminate=True)
            raise
        return staged

    def commit_resize(self, plan: ResizePlan, staged: dict[int, tuple], epoch: int) -> None:
        """Install the new layout: reused processes take their new ranks,
        staged spawns join, retiring processes are terminated, and under
        a fault plan each new rank gets a fresh link
        (``ChaosFabric.add_upstream``) while the retiring ranks' links
        stop."""
        with self._lock:
            old_count = self.num_servers
            procs, ports, links = [], [], []
            for nr in range(plan.new_num_servers):
                if nr in plan.reuse:
                    r = plan.reuse[nr]
                    procs.append(self.procs[r])
                    ports.append(self.ports[r])
                    if self.chaos is not None:
                        links.append(self._chaos_links[r])
                else:
                    proc, port = staged[nr]
                    procs.append(proc)
                    ports.append(port)
                    if self.chaos is not None:
                        links.append(self.chaos.add_upstream("127.0.0.1", port))
            retiring = [self.procs[r] for r in plan.retire]
            retiring_links = ([self._chaos_links[r] for r in plan.retire]
                              if self.chaos is not None else [])
            # new lists, not in-place edits: wait() tells a resize by them
            self.procs = procs
            self.ports = ports
            self.ranges = list(plan.new_ranges)
            self.num_servers = plan.new_num_servers
            self._chaos_links = links
            self.epoch = int(epoch)
        # the supervisor is paused through a resize, and nothing else
        # spawns: the retired ranks go down outside the lock
        for proc in retiring:
            if proc.poll() is None:
                proc.terminate()
        for proc in retiring:
            _reap(proc)
        for lk in retiring_links:
            lk.stop()
        for rank in range(max(old_count, plan.new_num_servers)):
            self._set_up(rank, int(rank < plan.new_num_servers))
        self._set_membership()

    def alive(self) -> list[bool]:
        """Process-level liveness, one flag per server rank."""
        return [p.poll() is None for p in self.procs]

    def health(self, *, timeout_ms: int = 2000) -> list[dict]:
        """Every rank's kStats counters over a short-lived connection to
        the servers' own ports (past any fault plan: a probe diagnoses a
        partition rather than time out inside it; stats replies are never
        deferred, so it answers through a wedged barrier)."""
        from distlr_tpu_torch.ps.client import KVWorker  # noqa: PLC0415  (cycle)

        with KVWorker(self.direct_hosts, self.dim, client_id=0xFFFF,
                      timeout_ms=timeout_ms) as probe:
            stats = [probe.stats(rank) for rank in range(self.num_servers)]
        # the native servers have no scrape surface: a health probe mirrors
        # their kStats counters into the registry
        for rank, st in enumerate(stats):
            for name, val in st.items():
                _SERVER_STAT.labels(rank=rank, stat=name).set(val)
                if name.startswith("cpu_") and name.endswith("_seconds"):
                    _SERVER_CPU.labels(rank=rank,
                                       handler=name[len("cpu_"):-len("_seconds")]).set(val)
        return stats

    def global_pushes(self, *, timeout_ms: int = 2000) -> float:
        """The group's push clock seen from the servers: the mean
        ``total_pushes`` over the ranks (:meth:`KVWorker.global_pushes`)."""
        stats = self.health(timeout_ms=timeout_ms)
        return sum(s["total_pushes"] for s in stats) / max(len(stats), 1)

    def wait(self) -> None:
        """Block until every server process of the current layout exits,
        as they do after a client's ``shutdown_servers``: the foreground
        of ``launch ps-server``.  A resize swaps the process list, so a
        retired rank's exit does not end the wait: the loop waits the new
        layout too.  A rank respawned in place is waited as well."""
        while True:
            procs = self.procs
            for p in list(procs):
                p.wait()
            if self.procs is not procs:
                continue  # resized while waiting
            with self._lock:
                if self._stopped or all(p.poll() is not None for p in self.procs):
                    return

    def stop(self) -> None:
        """Stop the fault plan's proxies and terminate every server (a
        no-op for those that already exited, as they do after a client's
        ``shutdown_servers``)."""
        with self._lock:
            self._stopped = True
        if self.chaos is not None:
            # outside the lock: a kill fault firing now takes it
            self.chaos.stop()
            self.chaos = None
        with self._lock:
            for p in self.procs:
                if p.poll() is None:
                    p.terminate()
            for p in self.procs:
                _reap(p)
            for rank in range(len(self.procs)):
                self._set_up(rank, 0)
            self.procs.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class ServerSupervisor:
    """Crash recovery of an async (Hogwild) group's servers
    (``distlr_tpu/ps/server.py:800``): a daemon thread snapshots the
    group's weights on an interval, polls the processes, respawns a dead
    rank on its original port (:meth:`ServerGroup.respawn`) and re-seeds
    its slice from the latest snapshot with a forced init push.

    The updates a dead rank absorbed after its last capture are lost
    (bounded by ``snapshot_interval``), the staleness class Hogwild
    already tolerates.  Sync groups are refused: a round's merge buffer
    and barrier votes cannot be rebuilt; their recovery is
    ``checkpoint_dir`` and ``resume``.  Workers see one failed op a
    server death; ``run_ps_workers(max_restarts>0)`` or a
    :class:`~distlr_tpu_torch.ps.RetryPolicy` carries them over it.

    ``events`` is the audit trail of ``(monotonic time, rank, event)``:
    ``respawned``, ``reseeded``, ``seeded-zeros``, ``gave-up`` and
    ``respawn-failed``; a durable group (``store_dir``) adds
    ``reseeded-from-store`` (the respawned rank recovered from its disk
    state, at least as new as the RAM snapshot: no re-seed),
    ``store-stale`` (the RAM snapshot was newer and re-seeded over the
    disk recovery) and ``store-corrupt-fallback`` (a snapshot generation
    was rejected; the recovery took the other one, or the WAL).
    ``store_health`` holds each rank's on-disk state by rank, scanned on
    the snapshot cadence: the newest valid snapshot's age, the snapshot
    and WAL bytes, the WAL records past that snapshot and the corrupt
    generations (the JAX package's ``distlr_ps_store_*`` gauges).

    A live resize pauses the loop (:meth:`pause`: a retiring rank's exit
    is no crash) and :meth:`reset_layout` re-binds it to the new ranks.
    """

    #: client_id of the per-rank probe connections
    PROBE_CLIENT_ID = 0xFFFE

    def __init__(self, group: ServerGroup, *, poll_interval: float = 0.2,
                 snapshot_interval: float = 1.0, max_respawns: int = 3,
                 timeout_ms: int = 5000):
        if group.sync:
            raise ValueError(
                "ServerSupervisor supports async groups only: a sync "
                "server's mid-round BSP merge state cannot be "
                "reconstructed — use checkpoint_dir + resume for sync runs"
            )
        self._group = group
        self._poll_interval = poll_interval
        self._snapshot_interval = snapshot_interval
        self._max_respawns = max_respawns
        self._timeout_ms = timeout_ms
        # the rolling snapshot: one full-dim buffer, tracked a key range at
        # a time (valid, the push count at capture, capture time); a range
        # whose total_pushes has not moved since its capture is skipped, so
        # the cost follows the write traffic, not the key space
        self._snapshot: np.ndarray | None = None
        self._snapshot_at = 0.0
        self._snap_valid = [False] * group.num_servers
        self._snap_pushes = [-1] * group.num_servers
        self._snap_at = [0.0] * group.num_servers
        # FTRL groups: z and n ride the same snapshot and are restored
        # with the weights, or a respawned rank would restart its
        # per-coordinate schedules and forget its L1 duals
        self._ftrl = group.has_ftrl
        self._opt_z: np.ndarray | None = None
        self._opt_n: np.ndarray | None = None
        self._respawns = [0] * group.num_servers
        self._needs_reseed: set[int] = set()
        self._stop = threading.Event()
        self._paused = threading.Event()
        # held through each poll cycle: pause() returns once none is in flight
        self._cycle = threading.Lock()
        self._thread: threading.Thread | None = None
        self.events: list[tuple[float, int, str]] = []
        self.store_health: dict[int, dict] = {}

    def _record_event(self, when: float, rank: int, event: str) -> None:
        self.events.append((when, rank, event))
        _SUP_EVENTS.labels(event=event).inc()

    def start(self) -> "ServerSupervisor":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ps-server-supervisor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def pause(self) -> None:
        """Idle the loop through a resize window, once the cycle in flight
        (if any) has finished: the retiring ranks' exits must not be
        respawned, and the swap of processes and ranges must not race a
        cycle."""
        self._paused.set()
        with self._cycle:
            pass

    def resume(self) -> None:
        self._paused.clear()

    def reset_layout(self) -> None:
        """Re-bind to the group's current layout after a resize: the rank
        state starts over (rank ids now mean other key slices, so every
        range is captured anew); the full-dim snapshot buffer stays."""
        n = self._group.num_servers
        self._snap_valid = [False] * n
        self._snap_pushes = [-1] * n
        self._snap_at = [0.0] * n
        self._respawns = [0] * n
        self._needs_reseed.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _probe_rank(self, rank: int):
        """A fresh connection to one rank alone: a server death poisons
        open streams, and a group-wide connection would let one dead rank
        freeze the healthy ranks' captures.  The server stores its range
        at local keys, so a one-host client of dim ``hi - lo`` addresses
        exactly that slice."""
        from distlr_tpu_torch.ps.client import KVWorker  # noqa: PLC0415  (cycle)

        lo, hi = self._group.key_range(rank)
        return KVWorker(f"127.0.0.1:{self._group.ports[rank]}", hi - lo,
                        client_id=self.PROBE_CLIENT_ID, timeout_ms=self._timeout_ms,
                        sync_group=False)

    def _try_snapshot(self) -> None:
        with _SNAPSHOT_SECONDS.time():
            self._try_snapshot_inner()

    def _try_snapshot_inner(self) -> None:
        from distlr_tpu_torch.ps.client import PSRejectedError  # noqa: PLC0415  (cycle)

        if self._snapshot is None:
            self._snapshot = np.zeros(self._group.dim, np.float32)
        if self._ftrl and self._opt_z is None:
            self._opt_z = np.zeros(self._group.dim, np.float32)
            self._opt_n = np.zeros(self._group.dim, np.float32)
        for r in range(self._group.num_servers):
            try:
                with self._probe_rank(r) as kv:
                    s = kv.stats(0)
                    # an uninitialized server answers zeros: capturing them
                    # would let a crash re-seed zeros over real weights
                    if not s["initialized"]:
                        continue
                    if self._snap_valid[r] and s["total_pushes"] == self._snap_pushes[r]:
                        # untouched since its capture: no bytes move
                        self._snap_at[r] = time.monotonic()
                        continue
                    vals = kv.pull()
                    lo, hi = self._group.key_range(r)
                    self._snapshot[lo:hi] = vals
                    if self._ftrl:
                        # not atomic with the weight pull: z/n may be a few
                        # updates newer than w, and FTRL re-derives w from z
                        # at each coordinate's next touch
                        try:
                            z, n = kv.pull_opt_state()
                        except PSRejectedError:
                            pass  # an opt_segments rank without an FTRL slice
                        else:
                            self._opt_z[lo:hi] = z
                            self._opt_n[lo:hi] = n
                    # the count was read before the pull: it may undercount
                    # the capture, which costs at most one redundant re-pull
                    self._snap_pushes[r] = s["total_pushes"]
                    self._snap_valid[r] = True
                    self._snap_at[r] = time.monotonic()
            except Exception:  # noqa: BLE001 — down or wedged: the respawn pass handles it
                continue
        self._snapshot_at = time.monotonic()
        self._refresh_store_health()

    def _refresh_store_health(self) -> None:
        """Scan each rank's store directory into :attr:`store_health`, on
        the snapshot cadence (a durable group only)."""
        if not self._group.store_dir:
            return
        from distlr_tpu_torch.ps import store  # noqa: PLC0415

        now = time.time()
        for r in range(self._group.num_servers):
            try:
                rs = store.scan_rank(self._group.store_rank_dir(r))
            except OSError:
                continue
            best = rs.best
            if best is not None:
                _STORE_SNAPSHOT_AGE.labels(rank=r).set(max(0.0, now - best.wall_time))
            _STORE_BYTES.labels(rank=r, kind="snapshot").set(rs.snapshot_bytes)
            _STORE_BYTES.labels(rank=r, kind="wal").set(rs.wal_bytes)
            _STORE_WAL_LAG.labels(rank=r).set(max(0, rs.recovered_clock - rs.snapshot_clock))
            _STORE_CORRUPT.labels(rank=r).set(rs.corrupt)
            self.store_health[r] = {
                "snapshot_age_s": max(0.0, now - best.wall_time) if best is not None else None,
                "snapshot_bytes": rs.snapshot_bytes, "wal_bytes": rs.wal_bytes,
                "wal_lag_records": max(0, rs.recovered_clock - rs.snapshot_clock),
                "corrupt_generations": rs.corrupt}

    def _reseed(self, rank: int) -> bool:
        from distlr_tpu_torch.ps.client import PSRejectedError  # noqa: PLC0415  (cycle)

        lo, hi = self._group.key_range(rank)
        if self._group.store_dir and self._recovered_from_store(rank):
            return True
        if self._snapshot is not None and self._snap_valid[rank]:
            vals, event = self._snapshot[lo:hi], "reseeded"
        else:
            # died before its first capture: zeros keep the server
            # initialized (pulls return a defined value), its progress lost
            vals, event = np.zeros(hi - lo, np.float32), "seeded-zeros"
        try:
            with self._probe_rank(rank) as kv:
                kv.push_init(vals, force=True)
                if self._ftrl and self._snap_valid[rank]:
                    try:
                        kv.push_init_opt_state(self._opt_z[lo:hi], self._opt_n[lo:hi],
                                               force=True)
                    except PSRejectedError:
                        pass  # an opt_segments rank without an FTRL slice
        except Exception as e:  # noqa: BLE001 — retried next poll (_needs_reseed)
            # an alive but unseeded server would install the first gradient
            # push as its weights
            log.warning("supervisor: re-seed of server %d failed: %s", rank, e)
            return False
        self._record_event(time.monotonic(), rank, event)
        # the new process counts pushes from 0: always re-pull this range
        self._snap_pushes[rank] = -1
        return True

    def _recovered_from_store(self, rank: int) -> bool:
        """Whether the respawned rank's own recovery from its store (run
        before it announced its port) stands: its disk clock is at least
        the RAM snapshot's, so pushing the snapshot over it would move
        the rank back.  Else the caller re-seeds from RAM."""
        from distlr_tpu_torch.ps import store  # noqa: PLC0415

        rs = store.scan_rank(self._group.store_rank_dir(rank))
        now = time.monotonic()
        if rs.corrupt:
            # the recovery took the other generation or the WAL: say so
            self._record_event(now, rank, "store-corrupt-fallback")
        disk_clock = rs.recovered_clock
        best = rs.best
        has_disk = disk_clock > 0 or (best is not None and best.initialized)
        ram_clock = self._snap_pushes[rank] if self._snap_valid[rank] else -1
        if has_disk and disk_clock >= ram_clock:
            self._record_event(now, rank, "reseeded-from-store")
            log.warning("supervisor: server %d recovered from its store (push_clock=%d >= "
                        "RAM snapshot %d); skipping re-seed", rank, disk_clock, ram_clock)
            # the next snapshot cycle re-pulls this range
            self._snap_pushes[rank] = -1
            return True
        if has_disk:
            # the disk is behind the RAM snapshot (a long store interval)
            self._record_event(now, rank, "store-stale")
        return False

    def _run(self) -> None:
        with self._cycle:
            self._try_snapshot()  # at once, so an early death has a capture
        while not self._stop.wait(self._poll_interval):
            with self._cycle:
                if not self._paused.is_set():
                    self._cycle_once()

    def _cycle_once(self) -> None:
        now = time.monotonic()
        if self._group._stopped:
            # a teardown's SIGTERMed ranks exit nonzero: not crashes
            return
        procs = list(self._group.procs)
        if not procs or all(p.poll() == 0 for p in procs):
            # every rank exited voluntarily (rank 0's shutdown_servers at
            # the end of a run): not a crash
            return
        dead = [r for r, p in enumerate(procs) if p.poll() is not None and p.returncode != 0]
        for r in dead:
            # down at detection: a gave-up or respawn-failed rank reads 0
            # (a successful respawn sets it back to 1)
            self._group._set_up(r, 0)
        for rank in list(self._needs_reseed):
            # respawned earlier, its re-seed failed: retry until seeded
            if rank not in dead and self._reseed(rank):
                self._needs_reseed.discard(rank)
        for rank in dead:
            if self._respawns[rank] >= self._max_respawns:
                if not any(r == rank and ev == "gave-up" for _, r, ev in self.events):
                    log.error("supervisor: server %d exceeded %d respawns; "
                              "leaving it down", rank, self._max_respawns)
                    self._record_event(now, rank, "gave-up")
                continue
            self._respawns[rank] += 1
            try:
                if not self._group.respawn(rank):
                    continue  # torn down, or raced a still-alive rank
            except RuntimeError as e:  # spawn failure, stolen port
                log.warning("supervisor: respawn of server %d failed: %s", rank, e)
                self._record_event(now, rank, "respawn-failed")
                continue
            log.warning("supervisor: server %d died; respawned (%d/%d)",
                        rank, self._respawns[rank], self._max_respawns)
            self._record_event(now, rank, "respawned")
            if not self._reseed(rank):
                self._needs_reseed.add(rank)
        if now - self._snapshot_at >= self._snapshot_interval:
            # per-rank captures: a dead or unseeded rank is skipped and the
            # healthy ranks' slices keep moving
            self._try_snapshot()
