"""Server-group lifecycle: S native KV server processes on localhost (the
port's ``ServerGroup``, from ``distlr_tpu/ps/server.py``).

Replaces the reference launcher's server-spawning half
(``examples/local.sh:36-41``: S ``distlr`` processes with
``DMLC_ROLE=server``) with a context-managed group of the port's own
``distlr_kv_server`` build, one per key range.  The update rule is the
servers' own: ``sgd`` (the reference's ``w -= lr * g``), ``ftrl``
(per-coordinate FTRL-Proximal with z and n accumulators) or ``signsgd``
(the majority vote of 1-bit pushes), group-wide or a namespace slice at a
time (``opt_segments``).  Supervision, resizing, the durable store and
chaos wait for ROADMAP A.16.
"""

from __future__ import annotations

import subprocess
import threading

from distlr_tpu_torch.ps.build import server_binary

OPTIMIZERS = ("sgd", "ftrl", "signsgd")


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
    """

    def __init__(self, num_servers: int, num_workers: int, dim: int, *,
                 learning_rate: float = 0.2, sync: bool = True,
                 last_gradient: bool = False, ports: list[int] | None = None,
                 bind_any: bool = False, optimizer: str = "sgd",
                 ftrl_alpha: float = 0.1, ftrl_beta: float = 1.0,
                 ftrl_l1: float = 0.0, ftrl_l2: float = 0.0, compress: bool = True,
                 opt_segments: list[tuple[int, str]] | None = None):
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
        self.ports: list[int] = list(ports or [])
        self.procs: list[subprocess.Popen] = []
        # stop() runs from failing worker threads as well as on exit
        self._lock = threading.Lock()

    @property
    def hosts(self) -> str:
        """Client connection spec, server-rank order."""
        return ",".join(f"127.0.0.1:{p}" for p in self.ports)

    @property
    def has_ftrl(self) -> bool:
        """Whether any coordinate of the group runs FTRL (the group's
        optimizer or an ``opt_segments`` namespace): the groups whose z
        and n the opt-state ops move."""
        return self.optimizer == "ftrl" or any(opt == "ftrl" for _, opt in self._opt_segments)

    def key_range(self, rank: int) -> tuple[int, int]:
        return self.dim * rank // self.num_servers, self.dim * (rank + 1) // self.num_servers

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
        return cmd

    def start(self) -> "ServerGroup":
        binary = server_binary()
        fixed_ports, self.ports = list(self.ports), []
        try:
            for rank in range(self.num_servers):
                port = fixed_ports[rank] if fixed_ports else 0
                proc = subprocess.Popen(self._command(binary, rank, port),
                                        stdout=subprocess.PIPE, text=True)
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

    def wait(self) -> None:
        """Block until every server process exits, as they do after a
        client's ``shutdown_servers``: the foreground of ``launch
        ps-server``."""
        for p in list(self.procs):
            p.wait()

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
