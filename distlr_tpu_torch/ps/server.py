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
clients and the servers.  Resizing a live group waits for ROADMAP A.16.6.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time

import numpy as np

from distlr_tpu_torch.config import _not_ported
from distlr_tpu_torch.ps.build import server_binary
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

OPTIMIZERS = ("sgd", "ftrl", "signsgd")
#: the supervisor's events of a durable group's recovery
STORE_EVENTS = ("reseeded-from-store", "store-stale", "store-corrupt-fallback")


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
    """

    def __init__(self, num_servers: int, num_workers: int, dim: int, *,
                 learning_rate: float = 0.2, sync: bool = True,
                 last_gradient: bool = False, ports: list[int] | None = None,
                 bind_any: bool = False, optimizer: str = "sgd",
                 ftrl_alpha: float = 0.1, ftrl_beta: float = 1.0,
                 ftrl_l1: float = 0.0, ftrl_l2: float = 0.0, compress: bool = True,
                 opt_segments: list[tuple[int, str]] | None = None, via_chaos=None,
                 store_dir: str | None = None, store_interval_s: float = 5.0,
                 store_wal: bool = False, store_wal_fsync_s: float = 0.1):
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
        #: the membership epoch the servers run at: 1, the JAX package's
        #: static default (a live resize, ROADMAP A.16.6, would bump it)
        self.epoch = 1
        self._chaos_plan = via_chaos
        #: the live ChaosFabric once start() ran with a plan
        self.chaos = None
        self.ports: list[int] = list(ports or [])
        self.procs: list[subprocess.Popen] = []
        # stop() runs from failing worker threads as well as on exit, and
        # respawn() from the supervisor's
        self._lock = threading.Lock()
        #: set by stop(): a torn-down group is never respawned
        self._stopped = False

    @property
    def hosts(self) -> str:
        """Client connection spec, server-rank order: the fault plan's
        proxies when the group rides one (``via_chaos``), so every client
        given it is behind the plan."""
        if self.chaos is not None:
            return self.chaos.hosts
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
        return self.dim * rank // self.num_servers, self.dim * (rank + 1) // self.num_servers

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

    def _command(self, binary, rank: int, port: int = 0) -> list[str]:
        lo, hi = self.key_range(rank)
        # the JAX package's spawn, flag for flag: only non-default
        # optimizers and codecs touch the command line, so an sgd group's
        # command stays that of a group without them
        cmd = [
            str(binary), f"--port={port}", f"--num_workers={self.num_workers}",
            f"--dim={hi - lo}", f"--lr={self.learning_rate}", f"--sync={int(self.sync)}",
            f"--last_gradient={int(self.last_gradient)}", f"--bind_any={int(self.bind_any)}",
        ]
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

    def _spawn(self, rank: int, port: int) -> tuple[subprocess.Popen, int]:
        """Start rank ``rank`` on ``port`` (0: the kernel's choice);
        returns the process and the port it bound.  A durable rank
        recovers from its store directory before it announces the port."""
        if self.store_dir:
            os.makedirs(self.store_rank_dir(rank), exist_ok=True)
        proc = subprocess.Popen(self._command(server_binary(), rank, port),
                                stdout=subprocess.PIPE, text=True)
        # the server prints "PORT <n>" once listening: reading it is the
        # readiness wait
        line = proc.stdout.readline().strip()
        if not line.startswith("PORT "):
            proc.terminate()
            proc.wait()
            proc.stdout.close()
            raise RuntimeError(f"KV server rank {rank} failed to start (got {line!r})")
        return proc, int(line.split()[1])

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
        except BaseException:
            self.stop()
            raise
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
                proc.terminate()
                proc.wait()
                proc.stdout.close()
                raise RuntimeError(f"respawned server rank {rank} bound port {port}, "
                                   f"expected {self.ports[rank]} (port stolen while down)")
            self.procs[rank] = proc
            return True

    def plan_resize(self, new_num_servers: int):
        """A live resize of the group: refused as the JAX package refuses
        it for a sync group and for a durable one; the resize itself is
        not ported (ROADMAP A.16.6)."""
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
        raise _not_ported(f"elastic resize to {new_num_servers} servers", "A.16.6")

    def alive(self) -> list[bool]:
        """Process-level liveness, one flag per server rank."""
        return [p.poll() is None for p in self.procs]

    def wait(self) -> None:
        """Block until every server process exits, as they do after a
        client's ``shutdown_servers``: the foreground of ``launch
        ps-server``.  A rank respawned while it waited is waited too."""
        while True:
            for p in list(self.procs):
                p.wait()
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
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                if p.stdout:
                    p.stdout.close()
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
        self._thread: threading.Thread | None = None
        self.events: list[tuple[float, int, str]] = []
        self.store_health: dict[int, dict] = {}

    def _record_event(self, when: float, rank: int, event: str) -> None:
        self.events.append((when, rank, event))

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
        self._try_snapshot()  # at once, so an early death has a capture
        while not self._stop.wait(self._poll_interval):
            now = time.monotonic()
            if self._group._stopped:
                # a teardown's SIGTERMed ranks exit nonzero: not crashes
                continue
            procs = list(self._group.procs)
            if not procs or all(p.poll() == 0 for p in procs):
                # every rank exited voluntarily (rank 0's shutdown_servers
                # at the end of a run): not a crash
                continue
            dead = [r for r, p in enumerate(procs)
                    if p.poll() is not None and p.returncode != 0]
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
                # per-rank captures: a dead or unseeded rank is skipped and
                # the healthy ranks' slices keep moving
                self._try_snapshot()
