"""The coordinator endpoint of a server group (the store-facing half of
``distlr_tpu/ps/membership.py``).

``launch ps-server --store-dir`` embeds a :class:`MembershipServer`,
announced as ``PSCTL host:port``, and ``launch ps-ctl`` speaks its line
protocol: ``LAYOUT`` and ``STATUS`` describe the group, ``STORE`` scans
every rank's snapshots and WAL (:mod:`distlr_tpu_torch.ps.store`),
``SNAPSHOT`` makes every rank write one now (SIGUSR1) and ``RESTORE``
puts every rank back to its on-disk state (SIGKILL, then a respawn on its
port that recovers from the store).  Every reply is one JSON line, the
JAX package's.

``RESIZE n`` answers as the JAX package does: a no-op when ``n`` is the
group's size, else the group's refusal (a sync group, a durable group).
Live resharding itself (the drain, fencing, epochs above 1, the client's
re-route) is not ported (ROADMAP A.16.6), nor is ``resize_async``.

Imports neither the workers nor the compute stack: the control plane has
to keep answering while the data plane fails.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import socketserver
import threading
import time

from distlr_tpu_torch.config import _not_ported
from distlr_tpu_torch.ps import store
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class MembershipError(RuntimeError):
    """A coordinator verb that could not run (a refused resize target, a
    group without a durable store)."""


class MembershipCoordinator:
    """The coordinator of one server group
    (:class:`~distlr_tpu_torch.ps.server.ServerGroup`): publishes its
    layout and status and runs the durable-store verbs.  The group's
    layout never changes here (a live resize is ROADMAP A.16.6), so its
    status stays ``active`` at epoch 1, with no resize and no drain's seed
    pushes to report.  ``events`` is the audit trail of ``(monotonic time,
    event, detail)``, newest last."""

    def __init__(self, group):
        self.group = group
        self.events: list[tuple[float, str, dict]] = []

    @property
    def epoch(self) -> int:
        return self.group.epoch

    def layout(self) -> dict:
        """The routing contract clients follow: the group's hosts (its
        fault plan's proxies when it rides one), dim and size."""
        return {"status": "active", "epoch": self.epoch, "hosts": self.group.hosts,
                "dim": self.group.dim, "num_servers": self.group.num_servers}

    def status(self) -> dict:
        return {"status": "active", "epoch": self.epoch, "num_servers": self.group.num_servers,
                "dim": self.group.dim, "events": len(self.events), "seed_pushes": 0,
                "last_resize": None}

    def _record(self, event: str, **detail) -> None:
        self.events.append((time.monotonic(), event, detail))
        log.info("membership: %s %s", event, detail or "")

    def _planned(self, new_num_servers: int) -> dict | None:
        """The JAX package's answers to a resize before any migration: the
        no-op reply when the size does not change, else the group's
        refusals (:meth:`ServerGroup.plan_resize`) as a
        :class:`MembershipError`."""
        if new_num_servers == self.group.num_servers:
            return {"epoch": self.epoch, "noop": True, "num_servers": new_num_servers}
        try:
            self.group.plan_resize(new_num_servers)
        except ValueError as e:
            raise MembershipError(str(e)) from e
        return None

    def resize(self, new_num_servers: int) -> dict:
        """``RESIZE n``: :meth:`_planned`'s answer; a resize past it is
        not ported (ROADMAP A.16.6)."""
        noop = self._planned(new_num_servers)
        if noop is not None:
            return noop
        raise _not_ported("live resizing", "A.16.6")

    def resize_async(self, new_num_servers: int) -> dict:
        """``RESIZE n wait=0``: :meth:`_planned`'s answer (the JAX
        package's no-op reply carries ``ok`` and ``accepted`` here); the
        background resize is not ported (ROADMAP A.16.6)."""
        noop = self._planned(new_num_servers)
        if noop is not None:
            return {"ok": True, "accepted": False, "noop": True, "epoch": noop["epoch"],
                    "num_servers": new_num_servers}
        raise _not_ported("the background resize (RESIZE n wait=0)", "A.16.6")

    def _fence(self, epoch: int) -> None:
        raise _not_ported("fencing the group at a new epoch", "A.16.6")

    def _drain(self, plan, staged) -> int:
        raise _not_ported("draining key ranges between ranks", "A.16.6")

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
        and retry.  ``launch ps-server`` attaches no supervisor, so
        nothing else respawns the ranks meanwhile."""
        self._require_store()
        restored = []
        for rank, proc in enumerate(list(self.group.procs)):
            if proc.poll() is None:
                os.kill(proc.pid, signal.SIGKILL)
                proc.wait()
            self.group.respawn(rank)
            restored.append(rank)
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
        self._thread = threading.Thread(target=self._tcp.serve_forever, daemon=True,
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
        except (MembershipError, ValueError, NotImplementedError) as e:
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
    """The ``route=`` provider of a client that follows a live resize
    (not ported: ROADMAP A.16.6)."""
    raise _not_ported("the client's layout route provider", "A.16.6")


__all__ = [
    "MembershipCoordinator",
    "MembershipError",
    "MembershipServer",
    "ctl_request",
    "layout_client",
]
