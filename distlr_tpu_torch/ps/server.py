"""Server-group lifecycle: S native KV server processes on localhost (the
port's ``ServerGroup``, from ``distlr_tpu/ps/server.py``).

Replaces the reference launcher's server-spawning half
(``examples/local.sh:36-41``: S ``distlr`` processes with
``DMLC_ROLE=server``) with a context-managed group of the port's own
``distlr_kv_server`` build, one per key range.  Supervision, resizing,
the durable store and chaos wait for ROADMAP A.16.
"""

from __future__ import annotations

import subprocess
import threading

from distlr_tpu_torch.ps.build import server_binary


class ServerGroup:
    """Spawn and manage S native KV server processes on localhost.

    Server rank ``r`` owns global keys ``[r*D/S, (r+1)*D/S)``, the ps-lite
    range partition (reference ``src/main.cc:98-101``); the client slices
    requests to match.  Each server binds port 0 and announces the port
    the kernel chose as ``PORT <n>`` on stdout, so groups started side by
    side never collide.  ``sync=True`` is BSP (a push is answered when
    all ``num_workers`` pushed, then one update is applied), else Hogwild
    (each push applied at once); ``last_gradient`` is the reference's Q1
    update (the highest-rank worker's gradient / W instead of the mean).
    """

    def __init__(self, num_servers: int, num_workers: int, dim: int, *,
                 learning_rate: float = 0.2, sync: bool = True,
                 last_gradient: bool = False):
        if num_servers < 1 or num_servers > dim:
            raise ValueError(f"need 1 <= num_servers <= dim={dim}, got {num_servers}")
        self.num_servers = num_servers
        self.num_workers = num_workers
        self.dim = dim
        self.learning_rate = learning_rate
        self.sync = sync
        self.last_gradient = last_gradient
        self.ports: list[int] = []
        self.procs: list[subprocess.Popen] = []
        # stop() runs from failing worker threads as well as on exit
        self._lock = threading.Lock()

    @property
    def hosts(self) -> str:
        """Client connection spec, server-rank order."""
        return ",".join(f"127.0.0.1:{p}" for p in self.ports)

    def key_range(self, rank: int) -> tuple[int, int]:
        return self.dim * rank // self.num_servers, self.dim * (rank + 1) // self.num_servers

    def _command(self, binary, rank: int) -> list[str]:
        lo, hi = self.key_range(rank)
        # the JAX package's standard spawn, flag for flag
        return [
            str(binary), "--port=0", f"--num_workers={self.num_workers}",
            f"--dim={hi - lo}", f"--lr={self.learning_rate}", f"--sync={int(self.sync)}",
            f"--last_gradient={int(self.last_gradient)}", "--bind_any=0",
        ]

    def start(self) -> "ServerGroup":
        binary = server_binary()
        self.ports = []
        try:
            for rank in range(self.num_servers):
                proc = subprocess.Popen(self._command(binary, rank), stdout=subprocess.PIPE,
                                        text=True)
                self.procs.append(proc)
                # the server prints "PORT <n>" once listening: reading it
                # is the readiness wait
                line = proc.stdout.readline().strip()
                if not line.startswith("PORT "):
                    raise RuntimeError(f"KV server rank {rank} failed to start (got {line!r})")
                self.ports.append(int(line.split()[1]))
        except BaseException:
            self.stop()
            raise
        return self

    def alive(self) -> list[bool]:
        """Process-level liveness, one flag per server rank."""
        return [p.poll() is None for p in self.procs]

    def stop(self) -> None:
        """Terminate every server (a no-op for those that already exited,
        as they do after a client's ``shutdown_servers``)."""
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
