"""The autopilot's effectful half: every way a decision touches the
fleet, behind one narrow interface the daemon (and the tests) can
stub (the port's copy of ``distlr_tpu/autopilot/actuators.py``, over
the port's ``ps-ctl`` client and ``RouterAdmin``).

Three actuators, matching :data:`distlr_tpu_torch.autopilot.policy.ACTUATORS`:

* ``ps`` — the elastic PS group, over the ``ps-ctl`` line protocol
  (:mod:`distlr_tpu_torch.ps.membership`).  Scaling uses the non-blocking
  ``RESIZE <n> wait=0`` form: the daemon must never park a blocking
  admin socket across cooldown ticks while a drain migrates the table;
  STATUS polls report ``migrating`` until the reshard lands, and the
  policy treats a busy group as hold.
* ``engine`` — serving replicas, via the router's
  ADDREPLICA/DELREPLICA admin verbs against a PRE-STARTED standby pool
  (``--replica-pool``).  The autopilot promotes standby capacity into
  rotation and demotes it back out; it does not cold-start processes
  on the serving path (an idle standby engine evicts its weights, so
  parked capacity is cheap).
* ``worker`` — online trainers, by spawning/retiring real ``launch
  online`` subprocesses from a caller-supplied command template
  (``{worker_id}`` substituted).  Retire is SIGTERM: ``launch online``
  flushes its accumulated span and exits clean, and the ``.claim``
  shard protocol already makes worker churn exactly-once.

Every method raises on failure (the daemon journals the error and
ticks ``distlr_autopilot_errors_total``); none of them block longer
than one admin round trip.
"""

from __future__ import annotations

import shlex
import subprocess

from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class ActuatorError(RuntimeError):
    """An actuator refused or failed an action (journaled, counted,
    never fatal to the daemon)."""


class PSActuator:
    """Scale the elastic server group via ``ps-ctl``."""

    def __init__(self, ctl_addr: str, *, timeout_s: float = 5.0):
        self.ctl_addr = str(ctl_addr)
        self.timeout_s = float(timeout_s)

    def _request(self, line: str) -> dict:
        from distlr_tpu_torch.ps.membership import ctl_request  # noqa: PLC0415

        try:
            return ctl_request(self.ctl_addr, line,
                               timeout_s=self.timeout_s)
        except (OSError, ValueError) as e:
            raise ActuatorError(f"ps-ctl {line.split()[0]}: {e}") from e

    def current(self) -> tuple[int | None, bool]:
        """(num_servers, busy) — busy while a resize is migrating;
        (None, True) when the control endpoint is unreachable (the
        policy holds rather than acting on a stale count)."""
        try:
            st = self._request("STATUS")
        except ActuatorError:
            return None, True
        return int(st["num_servers"]), st.get("status") != "active"

    def scale(self, target: int) -> str:
        reply = self._request(f"RESIZE {int(target)} wait=0")
        if not reply.get("ok"):
            raise ActuatorError(
                f"resize to {target} refused: {reply.get('error')}")
        return f"resize accepted (epoch {reply.get('epoch')})"


class EngineActuator:
    """Promote/demote standby serving replicas through the router's
    admin verbs.  ``pool`` is the full ordered standby list; the router
    itself is the source of truth for which of them are in rotation."""

    def __init__(self, router_addr: str, pool: list[str], *,
                 model: str = "default", timeout_s: float = 5.0):
        host, _, port = str(router_addr).rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"router address must be host:port, got {router_addr!r}")
        from distlr_tpu_torch.serve.rollout import RouterAdmin  # noqa: PLC0415

        self.admin = RouterAdmin(host, int(port), timeout_s=timeout_s)
        self.pool = [str(a) for a in pool]
        self.model = str(model)

    def _in_rotation(self) -> list[str]:
        try:
            doc = self.admin.models()
        except (OSError, ValueError) as e:
            raise ActuatorError(f"router MODELS: {e}") from e
        info = doc.get("models", {}).get(self.model)
        if info is None:
            raise ActuatorError(f"router hosts no model {self.model!r}")
        return [r["addr"] if isinstance(r, dict) else str(r)
                for r in info.get("replicas", [])]

    def current(self) -> int | None:
        try:
            return len(self._in_rotation())
        except ActuatorError:
            return None

    def scale(self, target: int) -> str:
        live = self._in_rotation()
        if target > len(live):
            spare = [a for a in self.pool if a not in live]
            if not spare:
                raise ActuatorError(
                    f"no standby replica left in the pool "
                    f"({len(live)} in rotation, pool {len(self.pool)})")
            addr = spare[0]
            try:
                self.admin.expect_ok(f"ADDREPLICA {self.model} {addr}")
            except (OSError, RuntimeError) as e:
                raise ActuatorError(f"ADDREPLICA {addr}: {e}") from e
            return f"added {addr}"
        if target < len(live):
            # demote the youngest pool member in rotation: the
            # longest-serving replicas keep their residency
            pooled = [a for a in live if a in self.pool]
            addr = pooled[-1] if pooled else live[-1]
            try:
                self.admin.expect_ok(f"DELREPLICA {self.model} {addr}")
            except (OSError, RuntimeError) as e:
                raise ActuatorError(f"DELREPLICA {addr}: {e}") from e
            return f"removed {addr}"
        return "noop"


class WorkerActuator:
    """Spawn/retire ``launch online`` worker subprocesses.

    ``cmd_template`` is the full worker command with a ``{worker_id}``
    placeholder, e.g.::

        python -m distlr_tpu_torch.launch online --ps-ctl 127.0.0.1:7777 \\
            --feedback-shards /run/shards --worker-id {worker_id} ...

    Worker ids are never reused within one daemon lifetime (the
    ``.claim`` protocol keys claims by worker id).
    """

    def __init__(self, cmd_template: str, *, term_timeout_s: float = 15.0):
        if "{worker_id}" not in cmd_template:
            raise ValueError(
                "worker command template needs a {worker_id} placeholder")
        self.cmd_template = str(cmd_template)
        self.term_timeout_s = float(term_timeout_s)
        self._next_id = 0
        #: live (worker_id, Popen), oldest first
        self.procs: list[tuple[int, subprocess.Popen]] = []

    def _reap(self) -> None:
        live = []
        for wid, proc in self.procs:
            if proc.poll() is None:
                live.append((wid, proc))
            else:
                log.warning("autopilot: worker %d exited rc=%s on its own",
                            wid, proc.returncode)
        self.procs = live

    def current(self) -> int:
        self._reap()
        return len(self.procs)

    def scale(self, target: int) -> str:
        self._reap()
        if target > len(self.procs):
            wid = self._next_id
            self._next_id += 1
            argv = shlex.split(self.cmd_template.format(worker_id=wid))
            try:
                proc = subprocess.Popen(argv,
                                        stdout=subprocess.DEVNULL,
                                        stderr=subprocess.DEVNULL)
            except OSError as e:
                raise ActuatorError(f"spawn worker {wid}: {e}") from e
            self.procs.append((wid, proc))
            return f"spawned worker {wid} (pid {proc.pid})"
        if target < len(self.procs):
            wid, proc = self.procs.pop()  # retire the youngest
            proc.terminate()
            try:
                proc.wait(timeout=self.term_timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                raise ActuatorError(
                    f"worker {wid} ignored SIGTERM for "
                    f"{self.term_timeout_s:g}s (killed)") from None
            return f"retired worker {wid} (rc {proc.returncode})"
        return "noop"

    def stop_all(self) -> None:
        """Daemon shutdown: retire every spawned worker cleanly."""
        self._reap()
        for _wid, proc in self.procs:
            proc.terminate()
        for wid, proc in self.procs:
            try:
                proc.wait(timeout=self.term_timeout_s)
            except subprocess.TimeoutExpired:
                log.warning("autopilot: killing worker %d (SIGTERM "
                            "ignored at shutdown)", wid)
                proc.kill()
                proc.wait()
        self.procs = []


class Actuators:
    """The daemon-facing bundle: any member may be None (that actuator
    is unmanaged — its policy bands simply never act)."""

    def __init__(self, *, ps: PSActuator | None = None,
                 engine: EngineActuator | None = None,
                 worker: WorkerActuator | None = None):
        self.ps = ps
        self.engine = engine
        self.worker = worker

    def current(self) -> dict:
        """Live counts for the policy: actuator -> int | None, plus
        ``ps_busy``."""
        out: dict = {"ps": None, "engine": None, "worker": None,
                     "ps_busy": False}
        if self.ps is not None:
            out["ps"], out["ps_busy"] = self.ps.current()
        if self.engine is not None:
            out["engine"] = self.engine.current()
        if self.worker is not None:
            out["worker"] = self.worker.current()
        return out

    def apply(self, actuator: str, target: int) -> str:
        impl = getattr(self, actuator, None)
        if impl is None:
            raise ActuatorError(f"actuator {actuator!r} is unmanaged")
        return impl.scale(int(target))

    def close(self) -> None:
        if self.worker is not None:
            self.worker.stop_all()
