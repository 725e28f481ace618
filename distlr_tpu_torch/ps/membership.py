"""Membership coordination of a server group (``distlr_tpu/ps/
membership.py``): the layout's epoch, live resizing, and the ``PSCTL``
endpoint.

* **Epochs.** The layout (which rank owns which key range) is versioned by
  a u16 epoch in the frame header's ``aux`` field (kv_protocol.h kEpoch).
  Clients announce theirs a connection; a server whose epoch moved fences
  their ops with an error carrying the new one, and a client with a
  ``route`` provider re-fetches the layout from here and reconnects.
* **Live resizing.** :meth:`MembershipCoordinator.resize` grows or shrinks
  an async group mid-run: spawn the new ranks at the next epoch, fence
  the old ones, drain every moving sub-range (a keyed ``pull_chunked``
  from the old owner, a forced keyed ``push_init`` into the new one; an
  FTRL group's z and n through the opt-state ops), commit the layout and
  publish it as active.  A process whose range start survives keeps its
  resident slice: doubling moves half the table, halving drains the odd
  ranks.  A failed step rolls back to the old layout.
* **In flight.** A writer caught by the fence re-routes; a gradient push
  that straddled it is absorbed as of unknown outcome, never applied
  twice.  The coordinator's own connections announce no epoch, so the
  migration works through its fence.

``launch ps-server --elastic`` (or ``--store-dir``) embeds a
:class:`MembershipServer`, announced as ``PSCTL host:port``, and ``launch
ps-ctl`` speaks its line protocol: ``LAYOUT``, ``STATUS``, ``RESIZE n
[wait=0|wait=1]``, and the durable store's ``STORE`` (every rank's
snapshots and WAL, :mod:`distlr_tpu_torch.ps.store`), ``SNAPSHOT``
(SIGUSR1 to every rank) and ``RESTORE`` (SIGKILL, then a respawn that
recovers from the store).  Every reply is one JSON line, the JAX
package's.  :func:`layout_client` wraps the endpoint into a ``route=``
provider.  The coordinator records the JAX package's ``distlr_reshard_*``,
``distlr_membership_epoch`` and ``distlr_alert_reshard_failed`` series,
and the same numbers in its attributes (:attr:`MembershipCoordinator.
counters`, ``reshard_failed``, ``seed_pushes``); a resize is a
``reshard.resize`` span and each moved sub-range a ``reshard.migrate``
span under the caller's distributed trace.

Imports neither the workers nor the compute stack: the control plane has
to keep answering while the data plane fails.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import socketserver
import time

import numpy as np

from distlr_tpu_torch import sync
from distlr_tpu_torch.obs import dtrace
from distlr_tpu_torch.obs.registry import get_registry
from distlr_tpu_torch.ps import store, wire
from distlr_tpu_torch.ps.client import KVWorker, PSRejectedError
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_reg = get_registry()
_EPOCH = _reg.gauge(
    "distlr_membership_epoch",
    "the group layout's CURRENT membership epoch (bumps once per "
    "completed resize; clients at an older epoch are fenced and "
    "re-route)",
)
_RESHARDS = _reg.counter(
    "distlr_reshard_total",
    "completed live reshards of the server group, by direction",
    labelnames=("direction",),
)
_RESHARD_SECONDS = _reg.histogram(
    "distlr_reshard_seconds",
    "wall seconds per live reshard (fence -> drain -> commit -> "
    "activate; the client-visible unavailability upper bound)",
)
_KEYS_MOVED = _reg.counter(
    "distlr_reshard_keys_moved_total",
    "flat parameter slots migrated between ranks by live reshards",
)
_BYTES_MOVED = _reg.counter(
    "distlr_reshard_bytes_moved_total",
    "payload bytes (keys + f32 values, opt-state included) moved by "
    "live reshards",
)
_SEED_PUSHES = _reg.counter(
    "distlr_reshard_seed_pushes_total",
    "forced init-pushes issued by reshard drains (these tick the "
    "servers' push clocks; subtract them when auditing applied vs "
    "issued worker pushes across a migration)",
)
_RESHARD_FAILED = _reg.gauge(
    "distlr_alert_reshard_failed",
    "1 while the most recent live reshard failed and was rolled back "
    "(the group still serves the OLD layout); clears on the next "
    "successful resize",
    labelnames=("threshold",),
)



class MembershipError(RuntimeError):
    """A coordinator verb that could not run: a refused resize target, a
    migration already in flight, a drain failure that was rolled back, a
    group without a durable store."""


class MembershipCoordinator:
    """The scheduler role of one async server group
    (:class:`~distlr_tpu_torch.ps.server.ServerGroup`): owns the layout's
    epoch, runs live resizes over the group's plan, spawn and commit,
    publishes the layout (:meth:`layout`, the ``route=`` provider of
    in-process clients; :class:`MembershipServer` serves it over TCP) and
    runs the durable store's verbs.  A ``supervisor`` is paused through a
    resize and a restore, so that an intended exit is never respawned.

    ``events`` is the audit trail of ``(monotonic time, event, detail)``,
    newest last; ``last_resize`` the stats of the last resize, failed or
    not; ``seed_pushes`` the drains' forced init pushes, which tick the
    servers' push clocks (an audit of applied pushes subtracts them).
    """

    #: client_id of the coordinator's per-rank connections
    CTL_CLIENT_ID = 0xFFFD

    def __init__(self, group, *, supervisor=None, drain_timeout_ms: int = 10_000,
                 chunk_rows: int = 1 << 16):
        self.group = group
        self.supervisor = supervisor
        self.drain_timeout_ms = int(drain_timeout_ms)
        self.chunk_rows = int(chunk_rows)
        self._lock = sync.Lock()
        self._status = "active"
        self._epoch = int(group.epoch)
        self.events: list[tuple[float, str, dict]] = []
        self.last_resize: dict | None = None
        self.seed_pushes = 0
        #: the JAX package's reshard series: completed resizes by direction,
        #: their seconds, the keys and bytes moved
        self.counters: dict = {"reshards": {}, "reshard_seconds": [], "keys_moved": 0,
                               "bytes_moved": 0}
        #: 1 while the last resize failed and was rolled back (the group
        #: serves the old layout); 0 after the next success
        self.reshard_failed = 0
        _EPOCH.set(self._epoch)
        _RESHARD_FAILED.labels(threshold="0").set(0.0)

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def layout(self) -> dict:
        """The routing contract clients follow: the group's hosts (its
        fault plan's proxies when it rides one), with ``status:
        migrating`` telling them to poll, not connect."""
        with self._lock:
            return {"status": self._status, "epoch": self._epoch, "hosts": self.group.hosts,
                    "dim": self.group.dim, "num_servers": self.group.num_servers}

    def status(self) -> dict:
        with self._lock:
            return {"status": self._status, "epoch": self._epoch,
                    "num_servers": self.group.num_servers, "dim": self.group.dim,
                    "events": len(self.events), "seed_pushes": self.seed_pushes,
                    "last_resize": self.last_resize}

    def _record(self, event: str, **detail) -> None:
        self.events.append((sync.monotonic(), event, detail))
        log.info("membership: %s %s", event, detail or "")

    # -- the drain's plumbing ----------------------------------------------
    def _rank_conn(self, port: int, dim: int) -> KVWorker:
        """A control connection to one rank: its own port (the drain works
        through a fault plan, as the supervisor's probes do), and no epoch
        announced (the fence must not stop the migration that lifts it)."""
        return KVWorker(f"127.0.0.1:{port}", dim, client_id=self.CTL_CLIENT_ID,
                        timeout_ms=self.drain_timeout_ms, sync_group=False)

    def _set_epochs(self, epoch: int, *, best_effort: bool) -> None:
        for rank, port in enumerate(self.group.ports):
            lo, hi = self.group.key_range(rank)
            try:
                with self._rank_conn(port, hi - lo) as kv:
                    kv.set_epoch(epoch)
            except OSError:
                if not best_effort:
                    raise

    def _fence(self, epoch: int) -> None:
        """Flip every current rank to the new epoch: announced writers
        bounce and re-route from here, which is why the drain runs after
        it (un-announced writers keep landing on the old owners)."""
        self._set_epochs(epoch, best_effort=False)

    def _unfence(self, epoch: int) -> None:
        """Put the ranks back at ``epoch`` after an aborted migration,
        best-effort."""
        self._set_epochs(epoch, best_effort=True)

    def _drain(self, plan, staged: dict[int, tuple]) -> int:
        """Move every planned sub-range: a keyed pull from the old owner,
        a forced keyed init push into the new one, ``chunk_rows`` keys a
        frame.  An FTRL group (never reused by the plan) also moves z and
        n: every old rank's are captured and each new rank is seeded over
        its whole range (the opt-state wire seeds whole ranges only).
        Returns the payload bytes moved (8 B of key and 4 B a value)."""
        group = self.group
        moved = 0

        def dst_port(nr: int) -> int:
            return group.ports[plan.reuse[nr]] if nr in plan.reuse else staged[nr][1]

        for old_rank, lo, hi, nr in plan.moves:
            olo, ohi = group.key_range(old_rank)
            nlo, nhi = plan.new_ranges[nr]
            with dtrace.span("reshard.migrate", tags={"from": old_rank, "to": nr,
                                                      "keys": hi - lo}):
                with self._rank_conn(group.ports[old_rank], ohi - olo) as src:
                    vals = src.pull_chunked(np.arange(lo - olo, hi - olo, dtype=np.uint64),
                                            chunk_rows=self.chunk_rows)
                with self._rank_conn(dst_port(nr), nhi - nlo) as dst:
                    for clo in range(0, hi - lo, self.chunk_rows):
                        chi = min(clo + self.chunk_rows, hi - lo)
                        dst.push_init(vals[clo:chi], np.arange(lo - nlo + clo, lo - nlo + chi,
                                                               dtype=np.uint64), force=True)
                        self.seed_pushes += 1
                        _SEED_PUSHES.inc()
            moved += (hi - lo) * 12
            self.counters["keys_moved"] += hi - lo
            _KEYS_MOVED.inc(hi - lo)
        if group.has_ftrl:
            z = np.zeros(group.dim, np.float32)
            n = np.zeros(group.dim, np.float32)
            for rank, port in enumerate(group.ports):
                lo, hi = group.key_range(rank)
                with self._rank_conn(port, hi - lo) as kv:
                    try:
                        z[lo:hi], n[lo:hi] = kv.pull_opt_state()
                    except PSRejectedError:
                        continue  # an opt_segments rank without an FTRL slice
            for nr, (nlo, nhi) in enumerate(plan.new_ranges):
                with self._rank_conn(dst_port(nr), nhi - nlo) as kv:
                    try:
                        kv.push_init_opt_state(z[nlo:nhi], n[nlo:nhi], force=True)
                    except PSRejectedError:
                        continue  # the new rank hosts no FTRL coordinate
                    self.seed_pushes += 1
                    _SEED_PUSHES.inc()
                moved += (nhi - nlo) * 16
        self.counters["bytes_moved"] += moved
        _BYTES_MOVED.inc(moved)
        return moved

    # -- live resizing -------------------------------------------------------
    def _planned(self, new_num_servers: int):
        """The group's plan to ``new_num_servers``, with its refusals as
        :class:`MembershipError`."""
        try:
            return self.group.plan_resize(new_num_servers)
        except ValueError as e:
            raise MembershipError(str(e)) from e

    def resize(self, new_num_servers: int) -> dict:
        """Reshard the group live to ``new_num_servers`` ranks, with no
        client restarted: spawn, fence, drain, commit, activate.  Raises
        :class:`MembershipError` for a refused target or a failed step;
        the group is then rolled back to its old layout (the staged spawns
        killed and reaped, the fence lifted) and :attr:`reshard_failed`
        is 1 until the next success."""
        with self._lock:
            if self._status != "active":
                raise MembershipError(f"a migration is already in flight ({self._status})")
            if new_num_servers == self.group.num_servers:
                return {"epoch": self._epoch, "noop": True,
                        "num_servers": self.group.num_servers}
            if self._epoch >= wire.AUX_MAX:
                raise MembershipError(f"epoch space exhausted ({wire.AUX_MAX})")
            plan = self._planned(new_num_servers)
            self._status = "migrating"
            old_epoch = self._epoch
        direction = "grow" if new_num_servers > self.group.num_servers else "shrink"
        new_epoch = old_epoch + 1
        t0 = sync.monotonic()
        self._record("resize_start", direction=direction, old=self.group.num_servers,
                     new=new_num_servers, epoch=new_epoch, moves=len(plan.moves),
                     reuse=len(plan.reuse))
        if self.supervisor is not None:
            self.supervisor.pause()
        staged: dict[int, tuple] = {}
        try:
            with dtrace.span("reshard.resize", tags={"direction": direction,
                                                     "new": new_num_servers,
                                                     "epoch": new_epoch}):
                staged = self.group.spawn_for_resize(plan, new_epoch)
                self._fence(new_epoch)
                bytes_moved = self._drain(plan, staged)
                self.group.commit_resize(plan, staged, new_epoch)
        except Exception as e:
            from distlr_tpu_torch.ps.server import _reap  # noqa: PLC0415  (cycle)

            for proc, _port in staged.values():
                _reap(proc, terminate=True)
            self._unfence(old_epoch)
            with self._lock:
                self._status = "active"
            if self.supervisor is not None:
                self.supervisor.resume()
            self.reshard_failed = 1
            _RESHARD_FAILED.labels(threshold="0").set(1.0)
            self._record("resize_failed", error=str(e))
            self.last_resize = {"ok": False, "error": str(e), "direction": direction}
            raise MembershipError(f"resize failed (rolled back): {e}") from e
        wall = sync.monotonic() - t0
        with self._lock:
            self._epoch = new_epoch
            self._status = "active"
        if self.supervisor is not None:
            self.supervisor.reset_layout()
            self.supervisor.resume()
        self.reshard_failed = 0
        reshards = self.counters["reshards"]
        reshards[direction] = reshards.get(direction, 0) + 1
        self.counters["reshard_seconds"].append(wall)
        _EPOCH.set(new_epoch)
        _RESHARDS.labels(direction=direction).inc()
        _RESHARD_SECONDS.observe(wall)
        _RESHARD_FAILED.labels(threshold="0").set(0.0)
        stats = {"ok": True, "direction": direction, "epoch": new_epoch,
                 "num_servers": self.group.num_servers, "keys_moved": plan.moved_keys,
                 "bytes_moved": bytes_moved, "reused": len(plan.reuse),
                 "spawned": len(plan.spawn), "retired": len(plan.retire),
                 "seconds": round(wall, 4)}
        self.last_resize = stats
        self._record("resize_done", **stats)
        return stats

    def resize_async(self, new_num_servers: int) -> dict:
        """``RESIZE n wait=0``: validate and accept now, migrate on a
        background thread; STATUS polls read ``status: migrating`` until
        the drain is done, then ``last_resize``.  A migration in flight or
        a refused target raises :class:`MembershipError` at once; a failed
        drain lands in ``last_resize`` as in :meth:`resize`."""
        n = int(new_num_servers)
        with self._lock:
            if self._status != "active":
                raise MembershipError(f"a migration is already in flight ({self._status})")
            epoch = self._epoch
        if n == self.group.num_servers:
            return {"ok": True, "accepted": False, "noop": True, "epoch": epoch,
                    "num_servers": n}
        self._planned(n)

        def run() -> None:
            try:
                self.resize(n)
            except MembershipError as e:
                log.warning("async resize to %d failed: %s", n, e)

        sync.Thread(target=run, daemon=True, name="distlr-resize-async").start()
        return {"ok": True, "accepted": True, "target": n, "epoch": epoch}

    # -- the durable store's verbs ----------------------------------------
    def _require_store(self) -> str:
        if not self.group.store_dir:
            raise MembershipError("the group runs without a durable store "
                                  "(launch ps-server needs --store-dir)")
        return self.group.store_dir

    def store_inspect(self) -> dict:
        """``STORE``: every rank's snapshot generations and WAL segments
        as on disk, without touching the servers."""
        doc = store.inspect_store(self._require_store(), now=time.time())
        doc["ok"] = True
        return doc

    def store_snapshot(self) -> dict:
        """``SNAPSHOT``: every live rank writes a snapshot now (SIGUSR1;
        the servers' store thread writes it out of band, so serving never
        blocks).  A rank whose state has not moved since its last snapshot
        skips the write."""
        self._require_store()
        signalled = 0
        for proc in self.group.procs:
            if proc.poll() is None:
                os.kill(proc.pid, signal.SIGUSR1)
                signalled += 1
        self._record("store_snapshot", signalled=signalled)
        return {"ok": True, "signalled": signalled, "num_servers": self.group.num_servers}

    def store_restore(self) -> dict:
        """``RESTORE``: every rank back to its on-disk state: SIGKILL and
        a respawn on its port, which recovers from the newest valid
        snapshot and the WAL.  Clients see one broken connection a rank
        and retry; a supervisor is paused meanwhile, so that it never
        respawns an intended kill a second time."""
        self._require_store()
        with self._lock:
            if self._status != "active":
                raise MembershipError(f"a migration is in flight ({self._status})")
        if self.supervisor is not None:
            self.supervisor.pause()
        restored = []
        try:
            for rank, proc in enumerate(list(self.group.procs)):
                if proc.poll() is None:
                    os.kill(proc.pid, signal.SIGKILL)
                    proc.wait()
                self.group.respawn(rank)
                restored.append(rank)
        finally:
            if self.supervisor is not None:
                self.supervisor.resume()
        self._record("store_restore", ranks=restored)
        return {"ok": True, "restored": restored, "num_servers": self.group.num_servers}


class _CtlHandler(socketserver.StreamRequestHandler):
    def handle(self):
        server: MembershipServer = self.server.membership  # type: ignore[attr-defined]
        for raw in self.rfile:
            line = raw.decode("utf-8", errors="replace").strip()
            if not line:
                continue
            reply = server.handle_line(line)
            try:
                self.wfile.write((reply + "\n").encode())
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                return


class _CtlTCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class MembershipServer:
    """``launch ps-ctl``'s wire: ``LAYOUT`` / ``STATUS`` / ``RESIZE <n>
    [wait=0|wait=1]`` / ``STORE`` / ``SNAPSHOT`` / ``RESTORE`` over a
    newline-delimited TCP protocol, every reply one JSON line."""

    def __init__(self, coordinator: MembershipCoordinator, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.coordinator = coordinator
        self._tcp = _CtlTCPServer((host, port), _CtlHandler, bind_and_activate=True)
        self._tcp.membership = self  # type: ignore[attr-defined]
        self.host, self.port = self._tcp.server_address[:2]
        self._thread = sync.Thread(target=self._tcp.serve_forever, daemon=True,
                                   name="distlr-ps-ctl")
        self._started = False

    def handle_line(self, line: str) -> str:
        parts = line.split()
        verb = parts[0].upper()
        coord = self.coordinator
        try:
            if verb == "LAYOUT" and len(parts) == 1:
                return json.dumps(coord.layout())
            if verb == "STATUS" and len(parts) == 1:
                return json.dumps(coord.status())
            if verb == "RESIZE" and len(parts) == 2:
                return json.dumps(coord.resize(int(parts[1])))
            if verb == "RESIZE" and len(parts) == 3 and parts[2] in ("wait=0", "wait=1"):
                if parts[2] == "wait=1":
                    return json.dumps(coord.resize(int(parts[1])))
                return json.dumps(coord.resize_async(int(parts[1])))
            if verb == "STORE" and len(parts) == 1:
                return json.dumps(coord.store_inspect())
            if verb == "SNAPSHOT" and len(parts) == 1:
                return json.dumps(coord.store_snapshot())
            if verb == "RESTORE" and len(parts) == 1:
                return json.dumps(coord.store_restore())
            return json.dumps({"ok": False,
                               "error": f"unknown command {line!r} "
                                        "(LAYOUT | STATUS | "
                                        "RESIZE <n> [wait=0|wait=1] | "
                                        "STORE | SNAPSHOT | RESTORE)"})
        except (MembershipError, ValueError) as e:
            return json.dumps({"ok": False, "error": str(e)})

    def start(self) -> "MembershipServer":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._started:
            self._tcp.shutdown()
        self._tcp.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def ctl_request(addr: str, line: str, *, timeout_s: float = 30.0) -> dict:
    """One command against a :class:`MembershipServer` at ``host:port``
    (``launch ps-ctl``'s transport); returns the decoded JSON reply."""
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"ps-ctl address must be host:port, got {addr!r}")
    with socket.create_connection((host, int(port)), timeout=timeout_s) as s:
        f = s.makefile("rwb")
        f.write((line.strip() + "\n").encode())
        f.flush()
        reply = f.readline()
    if not reply:
        raise ConnectionError(f"ps-ctl at {addr} closed mid-exchange")
    return json.loads(reply.decode())


def layout_client(addr: str, *, timeout_s: float = 5.0):
    """Wrap a ``PSCTL host:port`` endpoint into the zero-argument
    ``route=`` provider a :class:`~distlr_tpu_torch.ps.client.KVWorker`
    follows: each call fetches the coordinator's current ``LAYOUT``."""

    def fetch() -> dict:
        return ctl_request(addr, "LAYOUT", timeout_s=timeout_s)

    return fetch


__all__ = [
    "MembershipCoordinator",
    "MembershipError",
    "MembershipServer",
    "ctl_request",
    "layout_client",
]
