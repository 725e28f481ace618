"""Metrics exporters: Prometheus/JSON over a stdlib HTTP endpoint.

``MetricsServer`` is a tiny threaded ``http.server`` (no dependencies —
the container rule) exposing the process registry:

* ``GET /metrics``       -> Prometheus text exposition (0.0.4)
* ``GET /metrics.json``  -> JSON snapshot of every family
* ``GET /healthz``       -> ``ok`` (liveness for deployment probes)

plus any ``extra_json`` routes the owner registers (a fleet
aggregator serves its summary this way).  ``registry`` may be anything
exposing ``prometheus_text()``/``snapshot()``.

Port 0 binds an OS-assigned ephemeral port (announced by the launcher as
``METRICS host:port``, same contract as ``SERVING``/``HOSTS``).  The
``DISTLR_METRICS_SNAPSHOT=<path>`` env hook writes the registry to a
file at interpreter exit — how one-shot processes bank their metrics
without holding a port open.
Paths ending ``.json`` bank the machine-readable JSON snapshot (what the
fleet aggregator merges); anything else banks Prometheus text.  Several
``os.pathsep``-separated paths may be given to bank both forms at once.
"""

from __future__ import annotations

import http.server
import json
import os
import threading
import time
import urllib.parse

from distlr_tpu_torch.obs.registry import MetricsRegistry, get_registry
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class _Handler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (stdlib API name)
        registry: MetricsRegistry = self.server.registry  # type: ignore[attr-defined]
        path, _, query = self.path.partition("?")
        status = 200
        if path in ("/metrics", "/"):
            body = registry.prometheus_text().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/metrics.json":
            body = (json.dumps(registry.snapshot()) + "\n").encode()
            ctype = "application/json"
        elif path == "/healthz":
            body, ctype = b"ok\n", "text/plain"
        elif path in (getattr(self.server, "extra_json", None) or {}):
            body = (json.dumps(self.server.extra_json[path]()) + "\n").encode()  # type: ignore[attr-defined]
            ctype = "application/json"
        elif path in (getattr(self.server, "extra_query", None) or {}):
            # parameterized JSON routes: the callable receives the
            # parsed query params ({k: first-value}) and may reject bad
            # input with ValueError -> a 400 JSON error body
            params = {k: v[0] for k, v in
                      urllib.parse.parse_qs(query).items()}
            try:
                doc = self.server.extra_query[path](params)  # type: ignore[attr-defined]
            except ValueError as e:
                doc, status = {"error": str(e)}, 400
            body = (json.dumps(doc) + "\n").encode()
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # scrapes must not spam stderr
        pass


class _HTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class MetricsServer:
    """Background /metrics endpoint over one registry."""

    def __init__(self, registry: MetricsRegistry | None = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 extra_json: dict | None = None,
                 extra_query: dict | None = None):
        self.registry = registry or get_registry()
        self._http = _HTTPServer((host, port), _Handler)
        self._http.registry = self.registry  # type: ignore[attr-defined]
        self._http.extra_json = dict(extra_json or {})  # type: ignore[attr-defined]
        self._http.extra_query = dict(extra_query or {})  # type: ignore[attr-defined]
        self.host, self.port = self._http.server_address[:2]
        self._thread = threading.Thread(
            target=self._http.serve_forever, daemon=True,
            name="distlr-metrics-http",
        )
        self._started = False
        self._closed = False

    def start(self) -> "MetricsServer":
        if self._closed:
            raise RuntimeError("MetricsServer is stopped; build a new one")
        if not self._started:
            self._thread.start()
            # only set once the thread is really running: a failed
            # start() must leave stop() on the no-shutdown path below
            self._started = True
        return self

    def stop(self) -> None:
        """Idempotent teardown, safe in EVERY lifecycle state.  In
        particular it must not call ``HTTPServer.shutdown()`` unless
        ``serve_forever`` actually ran: ``shutdown()`` blocks on an
        event that only ``serve_forever`` ever sets, so stopping a
        never-started (or failed-to-start) server used to deadlock
        forever."""
        if self._closed:
            return
        self._closed = True
        if self._started:
            self._http.shutdown()
        self._http.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def start_metrics_server(*, host: str = "127.0.0.1", port: int = 0,
                         registry: MetricsRegistry | None = None) -> MetricsServer:
    return MetricsServer(registry, host=host, port=port).start()


def write_metrics_snapshot(path: str,
                           registry: MetricsRegistry | None = None) -> str:
    """Write the registry to ``path`` (atomic).  A ``.json`` path banks
    the JSON snapshot (the machine-readable twin a fleet aggregator
    merges); any other extension banks the
    Prometheus text exposition."""
    registry = registry or get_registry()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    if path.endswith(".json"):
        body = json.dumps(registry.snapshot()) + "\n"
    else:
        body = registry.prometheus_text()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(body)
    os.replace(tmp, path)
    return path


def endpoint_path(run_dir: str, role: str, rank: int | str) -> str:
    return os.path.join(run_dir, "endpoints", f"{role}-{rank}.json")


def write_endpoint(run_dir: str, role: str, rank: int | str, host: str,
                   port: int, *, pid: int | None = None) -> str:
    """Atomically publish this process's scrape endpoint into the run dir
    as ``<run_dir>/endpoints/<role>-<rank>.json``, the JAX package's
    discovery file (``distlr_tpu/obs/federate.py``), field for field.  A
    second process claiming the same (role, rank) overwrites it, loudly."""
    path = endpoint_path(run_dir, role, rank)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        with open(path) as f:
            prev = json.load(f)
        if (prev.get("host"), prev.get("port")) != (host, int(port)):
            log.warning(
                "fleet endpoint %s-%s already published by %s:%s "
                "(pid %s); overwriting with %s:%s — give each process a "
                "distinct rank (--process-id) or the hidden one will "
                "neither scrape nor alert",
                role, rank, prev.get("host"), prev.get("port"),
                prev.get("pid"), host, port)
    except (OSError, ValueError):
        pass  # absent or unreadable: the first publish
    doc = {
        "role": str(role),
        "rank": int(rank),
        "host": host,
        "port": int(port),
        "pid": os.getpid() if pid is None else int(pid),
        "started_at": time.time(),
    }
    # a tmp name a pid: two processes racing to publish one (role, rank)
    # land on the warning above, never on each other's tmp file
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


_snapshot_installed = False


def snapshot_env_paths(value: str | None = None) -> list[str]:
    """Parse ``DISTLR_METRICS_SNAPSHOT`` into its target paths: one
    file, or several ``os.pathsep``-separated ones (``a.prom:b.json``
    banks both the text AND the JSON form)."""
    if value is None:
        value = os.environ.get("DISTLR_METRICS_SNAPSHOT", "")
    return [p for p in value.split(os.pathsep) if p]


def install_snapshot_atexit() -> bool:
    """If ``DISTLR_METRICS_SNAPSHOT`` names file path(s), dump the
    registry there at interpreter exit (format per extension, see
    :func:`write_metrics_snapshot`).  Returns whether a hook was
    installed.  Idempotent per process."""
    global _snapshot_installed
    paths = snapshot_env_paths()
    if not paths or _snapshot_installed:
        return _snapshot_installed
    import atexit  # noqa: PLC0415

    def _dump():
        for path in paths:
            try:
                write_metrics_snapshot(path)
            except OSError:
                pass  # a failed snapshot must never fail the process exit

    atexit.register(_dump)
    _snapshot_installed = True
    return True
