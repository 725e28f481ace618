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
* **ID**: ``ID <request_id> <libsvm line>`` scores the line as libsvm
  mode does and journals it under the caller's request id, so that a
  later label can join it (without a feedback sink the id is ignored).
  JSON mode's twin is an optional ``"ids"`` list parallel to ``"rows"``
  (entries may be null).
* **LABEL**: ``LABEL <request_id> <0|1>``, a delayed label for a scored
  request (:mod:`distlr_tpu_torch.feedback`); reply ``OK <outcome>``
  (``joined`` / ``pending`` / ``duplicate``), or ``ERR`` when the server
  runs no feedback sink.
* **Model addressing**: one server can host several model versions, one
  :class:`~distlr_tpu_torch.serve.engine.ScoringEngine` each.  ``MODEL
  <id>`` scopes the connection to a hosted model (reply ``OK MODEL
  <id>``); a per-request ``@<id> `` prefix addresses one line (JSON and
  ID lines too).  Unaddressed lines score on the default (first) engine.
* Malformed input answers ``ERR <Type>: <reason>`` for that line; the
  connection stays up.

Not ported: ``TRACE`` prefixes (distributed tracing) answer ``ERR``
naming ROADMAP A.12.

One thread per connection (``ThreadingTCPServer``); every connection of a
model funnels into that engine's
:class:`~distlr_tpu_torch.serve.batcher.MicroBatcher`, so requests
coalesce exactly when traffic is concurrent, and two versions' rows never
share a padded batch.  ``p50_ms`` /
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
        scope: str | None = None  # MODEL <id> connection scoping
        try:
            for raw in self.rfile:
                line = raw.decode("utf-8", errors="replace").strip()
                if not line:
                    continue
                if line == "MODEL" or line.startswith("MODEL "):
                    reply, scope = srv.handle_model_line(line, scope)
                else:
                    reply = srv.handle_line(line, model=scope)
                try:
                    self.wfile.write((reply + "\n").encode())
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
    """Engines and their microbatchers behind a line-protocol TCP listener.

    One model: pass ``engine``.  Several: pass ``engines``, an ordered
    ``{model_id: ScoringEngine}`` mapping whose first entry is the default
    engine unaddressed lines score on; each engine gets its own
    microbatcher.  ``extra_reloaders`` are per-engine reloaders the server
    owns for their lifecycle only (stopped with it).  ``hot_tracker`` (a
    :class:`~distlr_tpu_torch.serve.hotset.HotSetTracker`) observes the row
    keys of the default engine's requests (``engine.row_keys``), the working
    set a hot-row live-PS reload refreshes: each version has its own
    namespace, and mixing their keys would poison the set.  ``feedback`` (a
    :class:`~distlr_tpu_torch.feedback.FeedbackSink`) journals the scored
    requests, joins ``LABEL`` lines and feeds the drift detector; with
    several engines its records carry the model id (shards a model), with
    one unnamed engine they carry none (flat shards).
    """

    def __init__(self, engine=None, *, engines: dict | None = None, host: str = "127.0.0.1",
                 port: int = 0, max_wait_ms: float = 2.0, reloader=None, extra_reloaders=(),
                 metrics: MetricsLogger | None = None, hot_tracker=None, feedback=None):
        if engines is None:
            if engine is None:
                raise ValueError("need an engine (or an engines mapping)")
            engines = {"default": engine}
            self._multi = False
        else:
            if engine is not None:
                raise ValueError("pass engine OR engines, not both")
            if not engines:
                raise ValueError("engines mapping must name >= 1 model")
            engines = dict(engines)
            self._multi = True
        self.engines = engines
        self._default_id = next(iter(engines))
        self.engine = engines[self._default_id]
        self.reloader = reloader
        self._extra_reloaders = list(extra_reloaders)
        #: fed from the default engine's traffic; None = full-table refresh
        self.hot_tracker = hot_tracker
        #: None = the loop is open (no journal, no LABEL lines)
        self.feedback = feedback
        self._batchers = {mid: MicroBatcher(eng.score, max_batch_size=eng.max_batch_size,
                                            max_wait_ms=max_wait_ms)
                          for mid, eng in engines.items()}
        self.batcher = self._batchers[self._default_id]
        self._model_requests = dict.fromkeys(engines, 0)
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

    def _score_lines(self, lines: list[str], ids: list | None = None,
                     model: str | None = None):
        mid = self._default_id if model is None else model
        engine = self.engines[mid]
        rows = engine.encode_lines(lines)
        if self.hot_tracker is not None and mid == self._default_id:
            self.hot_tracker.observe(engine.row_keys(rows))
        # the version is read before scoring: a swap racing the batch makes
        # the journal name at most one version early, never a later one
        version = engine.weights_version
        labels, scores = self._batchers[mid].submit(rows).result()
        labels, scores = np.asarray(labels), np.asarray(scores)
        with self._count_lock:
            self._model_requests[mid] += 1
        if self.feedback is not None:
            # ``rows`` are encode_lines' host arrays, not the device batch
            self.feedback.scored(lines, rows, scores, version=version, ids=ids,
                                 model=mid if self._multi else None)
        return labels, scores

    def _handle_label(self, line: str) -> str:
        if self.feedback is None:
            raise ValueError(
                "this server runs no feedback sink (start with "
                "--feedback-spool to close the loop)")
        parts = line.split()
        if len(parts) != 3:
            raise ValueError("LABEL needs exactly: LABEL <request_id> <0|1>")
        y = float(parts[2])
        if y not in (0.0, 1.0):
            raise ValueError(f"label must be 0 or 1, got {parts[2]!r}")
        return f"OK {self.feedback.label(parts[1], int(y))}"

    def _count_error(self) -> None:
        with self._count_lock:
            self._errors += 1

    def _unknown_model(self, model: str) -> str:
        return f"ERR MODEL: unknown model {model!r} (hosted: {','.join(self.engines)})"

    def handle_model_line(self, line: str, scope: str | None) -> tuple[str, str | None]:
        """``MODEL <id>`` connection scoping: later unaddressed lines of the
        connection score on ``<id>``.  Returns ``(reply, new_scope)``; an
        unknown id keeps the old scope."""
        parts = line.split()
        if len(parts) != 2:
            self._count_error()
            return "ERR MODEL: need MODEL <id>", scope
        if parts[1] not in self.engines:
            self._count_error()
            return self._unknown_model(parts[1]), scope
        return f"OK MODEL {parts[1]}", parts[1]

    def handle_line(self, line: str, model: str | None = None) -> str:
        """One request line -> one reply line.  ``model`` is the
        connection's ``MODEL`` scope; a per-request ``@<id>`` prefix
        overrides it."""
        t0 = time.monotonic()
        if line.startswith("@"):
            prefix, _, rest = line.partition(" ")
            model, line = prefix[1:], rest.strip()
            if not model or not line:
                self._count_error()
                return "ERR MODEL: need @<id> <request line>"
        if model is not None and model not in self.engines:
            self._count_error()
            return self._unknown_model(model)
        try:
            if line == "STATS":
                return json.dumps(self.stats())
            if line.startswith("TRACE ") or line == "TRACE":
                raise _not_ported("TRACE prefixes (distributed tracing)", "A.12")
            if line.startswith("LABEL ") or line == "LABEL":
                return self._handle_label(line)
            if line.startswith("{"):
                req = json.loads(line)
                batch = req.get("rows")
                if not isinstance(batch, list) or not batch:
                    raise ValueError('JSON request needs a non-empty "rows" list')
                ids = req.get("ids")
                if ids is not None and (not isinstance(ids, list) or len(ids) != len(batch)):
                    raise ValueError('"ids" must be a list parallel to "rows"')
                labels, scores = self._score_lines(
                    [str(r) for r in batch],
                    None if ids is None else [None if i is None else str(i) for i in ids],
                    model)
                reply = json.dumps({
                    "labels": [int(v) for v in labels],
                    "scores": [round(float(v), 6) for v in scores],
                })
            else:
                ids = None
                if line.startswith("ID "):
                    parts = line.split(None, 2)
                    if len(parts) != 3:
                        raise ValueError("ID mode needs: ID <request_id> <features>")
                    line, ids = parts[2], [parts[1]]
                labels, scores = self._score_lines([line], ids, model)
                reply = f"{int(labels[0])} {float(scores[0]):.6g}"
        except Exception as e:
            self._count_error()
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
            per_model = dict(self._model_requests)
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
            "models": len(self.engines),
            "per_model": {mid: {"requests": per_model[mid], "shed": 0, "engine": eng.stats()}
                          for mid, eng in self.engines.items()},
            "batcher": self.batcher.stats(),
            "engine": self.engine.stats(),
        }
        if self.reloader is not None:
            rec["reload"] = self.reloader.stats()
        if self.feedback is not None:
            rec["feedback"] = self.feedback.stats()
        # mirrored into the metrics records, unless stop() closed them
        if not self.metrics.closed:
            self.metrics.log(requests=rec["requests"], qps=rec["qps"], p50_ms=rec["p50_ms"],
                             p99_ms=rec["p99_ms"],
                             occupancy=rec["batcher"]["mean_occupancy"])
        return rec

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ScoringServer":
        self._started = True
        if self.feedback is not None:
            self.feedback.start()  # the window-expiry and idle-flush ticker
        self._thread.start()
        log.info("serving %s on %s:%d (max_batch=%d, buckets=%s, device=%s, models=%s)",
                 self.engine.cfg.model, self.host, self.port, self.engine.max_batch_size,
                 list(self.engine.buckets), self.engine.device, ",".join(self.engines))
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
        for batcher in self._batchers.values():
            batcher.close()
        if self.reloader is not None:
            self.reloader.stop()
        for rl in self._extra_reloaders:
            rl.stop()
        if self.feedback is not None:
            self.feedback.stop()  # flushes the partial shards
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
