"""Threaded TCP scoring front-end, stdlib only.

Counterpart of ``distlr_tpu/serve/server.py``, with the same line
protocol, one request per line and one reply line per request:

* **libsvm mode**: a libsvm feature line (a leading label token is
  optional and ignored); reply ``<label> <score>``, where the score is
  P(y=1) (binary families) or the winning class probability (softmax).
* **JSON mode**: a line starting with ``{``, ``{"rows": ["<libsvm line>",
  ...]}``; reply ``{"labels": [...], "scores": [...]}``.  The batch
  travels as ONE microbatcher request.
* **STATS**: one JSON line of request, latency, batcher, engine and
  reload counters, in the JAX server's schema.
* Malformed input answers ``ERR <Type>: <reason>`` for that line; the
  connection stays up.

Not ported, each answered with ``ERR`` naming its ROADMAP item: ``ID`` /
``LABEL`` lines and the JSON ``"ids"`` list (the feedback loop, A.11),
``MODEL <id>`` and ``@<id>`` addressing (several engines, A.17), and
``TRACE`` prefixes (distributed tracing, A.12).

One thread per connection (``ThreadingTCPServer``); every connection
funnels into one :class:`~distlr_tpu_torch.serve.batcher.MicroBatcher`,
so requests coalesce exactly when traffic is concurrent.  ``p50_ms`` /
``p99_ms`` come from a fixed-bucket latency histogram with the bucket
edges and the percentile estimate of ``distlr_tpu/obs/registry.py``, so
the two packages' values mean the same thing.
"""

from __future__ import annotations

import bisect
import json
import socket
import socketserver
import threading
import time

import numpy as np

from distlr_tpu_torch.config import _not_ported
from distlr_tpu_torch.serve.batcher import MicroBatcher
from distlr_tpu_torch.train.metrics import MetricsLogger
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: Latency bucket edges, seconds (the JAX registry's default ladder: 100 us
#: to 10 s).
LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def percentile_from_counts(bounds: tuple[float, ...], counts, q: float) -> float:
    """q-quantile (q in [0, 1]) by linear interpolation inside the owning
    bucket, over per-bucket counts (last slot = +Inf); observations past
    the top bucket clamp to the largest finite edge."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = sum(counts)
    if total == 0:
        return 0.0
    rank, cum = q * total, 0.0
    for i, c in enumerate(counts[:-1]):
        prev_cum = cum
        cum += c
        if cum >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (rank - prev_cum) / c if c else 0.0
            return lo + (hi - lo) * frac
    return bounds[-1]


class LatencyHistogram:
    """Fixed-bucket histogram of request seconds (no per-request storage)."""

    def __init__(self, bounds: tuple[float, ...] = LATENCY_BUCKETS):
        self.bounds = tuple(bounds)
        self._counts = [0] * (len(self.bounds) + 1)
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        i = bisect.bisect_left(self.bounds, seconds)
        with self._lock:
            self._counts[i] += 1

    def percentile(self, q: float) -> float:
        with self._lock:
            counts = list(self._counts)
        return percentile_from_counts(self.bounds, counts, q)


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        srv: ScoringServer = self.server.scoring_server  # type: ignore[attr-defined]
        srv._track(self.connection)
        try:
            for raw in self.rfile:
                line = raw.decode("utf-8", errors="replace").strip()
                if not line:
                    continue
                try:
                    self.wfile.write((srv.handle_line(line) + "\n").encode())
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    return
        except ConnectionResetError:
            pass  # the peer reset mid-read: not an error
        finally:
            srv._untrack(self.connection)


class _TCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class ScoringServer:
    """One engine and its microbatcher behind a line-protocol TCP listener.

    ``hot_tracker`` (a :class:`~distlr_tpu_torch.serve.hotset.HotSetTracker`)
    observes the row keys of every request (``engine.row_keys``), the
    working set a hot-row live-PS reload refreshes.  ``engines``,
    ``extra_reloaders`` and ``feedback`` stand in the signature as in the
    JAX server; given, they raise naming their ROADMAP items (A.17, A.11).
    """

    def __init__(self, engine=None, *, engines: dict | None = None, host: str = "127.0.0.1",
                 port: int = 0, max_wait_ms: float = 2.0, reloader=None, extra_reloaders=(),
                 metrics: MetricsLogger | None = None, hot_tracker=None, feedback=None):
        if engines is not None or extra_reloaders:
            raise _not_ported("a server hosting several engines", "A.17")
        if feedback is not None:
            raise _not_ported("the feedback sink", "A.11")
        if engine is None:
            raise ValueError("need an engine")
        self.engine = engine
        self.engines = {"default": engine}
        self.reloader = reloader
        #: fed from request traffic; None = full-table refresh, no tracking
        self.hot_tracker = hot_tracker
        self.batcher = MicroBatcher(engine.score, max_batch_size=engine.max_batch_size,
                                    max_wait_ms=max_wait_ms)
        self.metrics = metrics or MetricsLogger()
        self._latency = LatencyHistogram()
        self._count_lock = threading.Lock()
        self._requests = 0
        self._errors = 0
        self._t0 = time.monotonic()
        self._tcp = _TCPServer((host, port), _Handler, bind_and_activate=True)
        self._tcp.scoring_server = self  # type: ignore[attr-defined]
        self.host, self.port = self._tcp.server_address[:2]
        self._conn_lock = threading.Lock()
        self._active_conns: set = set()
        self._started = False
        self._thread = threading.Thread(target=self._tcp.serve_forever, daemon=True,
                                         name="distlr-serve-accept")

    # -- request handling --------------------------------------------------
    def _track(self, conn) -> None:
        with self._conn_lock:
            self._active_conns.add(conn)

    def _untrack(self, conn) -> None:
        with self._conn_lock:
            self._active_conns.discard(conn)

    def _score_lines(self, lines: list[str]):
        rows = self.engine.encode_lines(lines)
        if self.hot_tracker is not None:
            self.hot_tracker.observe(self.engine.row_keys(rows))
        labels, scores = self.batcher.submit(rows).result()
        return np.asarray(labels), np.asarray(scores)

    @staticmethod
    def _refuse_unported(line: str) -> None:
        word = line.split(None, 1)[0]
        if word in ("ID", "LABEL"):
            raise _not_ported(f"{word} lines (the feedback loop)", "A.11")
        if word == "MODEL" or line.startswith("@"):
            raise _not_ported("MODEL / @<id> addressing (several engines)", "A.17")
        if word == "TRACE":
            raise _not_ported("TRACE prefixes (distributed tracing)", "A.12")

    def handle_line(self, line: str) -> str:
        """One request line -> one reply line."""
        t0 = time.monotonic()
        try:
            if line == "STATS":
                return json.dumps(self.stats())
            self._refuse_unported(line)
            if line.startswith("{"):
                req = json.loads(line)
                batch = req.get("rows")
                if not isinstance(batch, list) or not batch:
                    raise ValueError('JSON request needs a non-empty "rows" list')
                if req.get("ids") is not None:
                    raise _not_ported('the JSON "ids" list (the feedback loop)', "A.11")
                labels, scores = self._score_lines([str(r) for r in batch])
                reply = json.dumps({
                    "labels": [int(v) for v in labels],
                    "scores": [round(float(v), 6) for v in scores],
                })
            else:
                labels, scores = self._score_lines([line])
                reply = f"{int(labels[0])} {float(scores[0]):.6g}"
        except Exception as e:
            with self._count_lock:
                self._errors += 1
            return f"ERR {type(e).__name__}: {e}"
        self._latency.observe(time.monotonic() - t0)
        with self._count_lock:
            self._requests += 1
        return reply

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        """The STATS reply: the JAX server's schema, key for key (a single
        engine never sheds or retries and is its own one-replica tier)."""
        with self._count_lock:
            n_req, n_err = self._requests, self._errors
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        rec = {
            "requests": n_req,
            "errors": n_err,
            "qps": round(n_req / elapsed, 2),
            "p50_ms": round(self._latency.percentile(0.50) * 1e3, 3),
            "p99_ms": round(self._latency.percentile(0.99) * 1e3, 3),
            "shed": 0,
            "retries": 0,
            "replica_count": 1,
            "models": 1,
            "per_model": {"default": {"requests": n_req, "shed": 0,
                                      "engine": self.engine.stats()}},
            "batcher": self.batcher.stats(),
            "engine": self.engine.stats(),
        }
        if self.reloader is not None:
            rec["reload"] = self.reloader.stats()
        # mirrored into the metrics records, unless stop() closed them
        if not self.metrics.closed:
            self.metrics.log(requests=rec["requests"], qps=rec["qps"], p50_ms=rec["p50_ms"],
                             p99_ms=rec["p99_ms"],
                             occupancy=rec["batcher"]["mean_occupancy"])
        return rec

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ScoringServer":
        self._started = True
        self._thread.start()
        log.info("serving %s on %s:%d (max_batch=%d, buckets=%s, device=%s)",
                 self.engine.cfg.model, self.host, self.port, self.engine.max_batch_size,
                 list(self.engine.buckets), self.engine.device)
        return self

    def serve_forever(self) -> None:
        """Foreground mode for the CLI: start, then block until stopped."""
        self.start()
        try:
            while self._thread.is_alive():
                self._thread.join(timeout=1.0)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        if self._started:
            # shutdown() blocks forever unless serve_forever ran
            self._tcp.shutdown()
            self._started = False
        self._tcp.server_close()
        self.batcher.close()
        if self.reloader is not None:
            self.reloader.stop()
        self.metrics.close()

    def abort(self) -> None:
        """Crash-like shutdown: stop accepting and sever every open
        connection mid-stream (clients see a transport error, as if the
        process were killed), then the orderly teardown of :meth:`stop`."""
        if self._started:
            self._tcp.shutdown()
            self._started = False
        self._tcp.server_close()
        with self._conn_lock:
            conns = list(self._active_conns)
        for c in conns:
            for close in (lambda: c.shutdown(socket.SHUT_RDWR), c.close):
                try:
                    close()
                except OSError:
                    pass
        self.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def score_lines_over_tcp(host: str, port: int, lines: list[str], *,
                         timeout_s: float = 30.0) -> list[str]:
    """Client helper: send ``lines`` over one connection and return the
    reply line of each."""
    replies = []
    with socket.create_connection((host, port), timeout=timeout_s) as s:
        f = s.makefile("rwb")
        for ln in lines:
            f.write((ln.strip() + "\n").encode())
            f.flush()
            reply = f.readline()
            if not reply:
                raise ConnectionError("server closed mid-stream")
            replies.append(reply.decode().rstrip("\n"))
    return replies
