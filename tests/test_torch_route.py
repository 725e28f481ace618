"""The port's serving control plane against the JAX package's, on the CPU:
``ScoringRouter``, the multi-engine ``ScoringServer``, PS namespaces and
``launch serve / route / rollout``.

* Protocol parity: the JAX router and the port's, each with ``seed=0``,
  in front of the same stub line servers (deterministic replies; each can
  be made to fail, hang, answer ``ERR`` or answer like a shedding or dead
  nested router), run one scripted client session.  Every reply, the
  order in which the stubs received the lines, the ``MODELS`` documents,
  and the ``STATS`` keys, types and counters are equal.
* Several engines in one server, and end to end (a router over two
  servers hosting ``v1`` and ``v2`` under a ``SPLIT``): the same lines
  give equal replies, scores at f32 rtol 1e-5, ``ERR MODEL`` texts equal.
* Namespaces: ``namespace_layout`` results and errors equal; the port's
  and JAX's namespace views of one port ``ServerGroup`` read the same
  bytes; a namespaced ``LivePSWatcher`` serves its slice only.
* CLI: ``serve --model-id / --extra-model / --ps-namespaces /
  --ps-namespace``, ``route`` and ``rollout`` through both packages'
  ``launch``, with equal results and error exits.
"""

import json
import os
import signal
import socket
import socketserver
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from distlr_tpu import launch as jax_launch
from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.ps import KVWorker as JaxKVWorker
from distlr_tpu.ps import namespace_layout as jax_namespace_layout
from distlr_tpu.serve import LivePSWatcher as JaxLivePSWatcher
from distlr_tpu.serve import ScoringEngine as JaxEngine
from distlr_tpu.serve import ScoringRouter as JaxRouter
from distlr_tpu.serve import ScoringServer as JaxServer
from distlr_tpu_torch import launch
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.ps import KVWorker, ServerGroup, namespace_layout
from distlr_tpu_torch.serve import (
    LivePSWatcher,
    ScoringEngine,
    ScoringRouter,
    ScoringServer,
    score_lines_over_tcp,
)
from distlr_tpu_torch.train.export import save_model_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 8
W1 = np.linspace(-1, 1, D).astype(np.float32)
W2 = (np.cos(np.arange(D)) * 0.8).astype(np.float32)


def _wait_for(predicate, timeout_s=20.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-np.asarray(z, np.float64)))


def _dense(line, dim=D):
    x = np.zeros(dim)
    for tok in line.split():
        if ":" in tok:
            k, v = tok.split(":")
            x[int(k) - 1] = float(v)
    return x


# --- stub replicas -------------------------------------------------------------
HANG_S = 1.0          # a hanging stub's sleep: past the routers' backend timeout


class _StubHandler(socketserver.StreamRequestHandler):
    def handle(self):
        srv = self.server
        try:
            for raw in self.rfile:
                line = raw.decode().strip()
                mode = srv.mode
                if mode == "fail":
                    return  # close without a reply, as a dead process would
                if line == "STATS":
                    reply = json.dumps({"requests": 0})
                else:
                    srv.log.append((srv.name, line))
                    if mode == "hang":
                        time.sleep(HANG_S)
                        return
                    if "LABEL" in line.split(" ")[:2]:
                        reply = ("ERR ValueError: no feedback sink" if srv.label == "err"
                                 else f"OK {srv.label}")
                    elif mode == "err":
                        reply = "ERR ValueError: bad row"
                    elif mode == "shed":
                        reply = "ERR SHED: no replica with free capacity (load shed)"
                    elif mode == "route":
                        reply = "ERR ROUTE: no healthy replica in rotation (all ejected)"
                    else:
                        score = zlib.crc32(f"{srv.name} {line}".encode()) % 997 / 1000
                        reply = f"1 {score:.3f}"
                self.wfile.write((reply + "\n").encode())
                self.wfile.flush()
        except (ConnectionError, OSError):
            pass


class _Stub(socketserver.ThreadingTCPServer):
    """A line server answering deterministically (its score a hash of its
    name and the line), logging every non-STATS line it receives."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, name, log):
        super().__init__(("127.0.0.1", 0), _StubHandler)
        self.name, self.log = name, log
        self.mode, self.label = "ok", "pending"
        self.addr = f"127.0.0.1:{self.server_address[1]}"
        threading.Thread(target=self.serve_forever, daemon=True).start()


class _Client:
    def __init__(self, host, port):
        self.sock = socket.create_connection((host, port), timeout=30)
        self.f = self.sock.makefile("rwb")

    def send(self, line):
        self.f.write((line + "\n").encode())
        self.f.flush()
        return self.f.readline().decode().rstrip("\n")

    def close(self):
        self.f.close()
        self.sock.close()


ROUTER_KW = dict(max_inflight=1, eject_after=2, health_interval_s=30.0, probe_backoff_s=0.05,
                 probe_backoff_max_s=0.1, backend_timeout_s=0.5, quotas="q=0.001:2", seed=0)


def _session(router, stubs, log):
    """The scripted client session; returns its replies (tagged by step)."""
    s0, s1, s2, s3 = stubs
    out = []
    # the health loop's first sweep probes every replica once; let it pass
    _wait_for(lambda: all(r.last_probe > 0 for r in router.replicas), what="first probes")
    c1, c2 = _Client(router.host, router.port), _Client(router.host, router.port)

    def say(c, *lines):
        for ln in lines:
            out.append((ln, c.send(ln)))

    def healthy_again(stub):
        stub.mode = "ok"
        _wait_for(lambda: all(r.healthy for r in router.replicas), what="reinstatement")

    say(c1, *["1:1"] * 4, *["@v2 2:1"] * 3)
    say(c2, "MODEL v2", "3:1", "3:1", "MODEL v9", "MODEL", "MODEL a b", "3:1")
    say(c1, "@v9 1:1", "@ 1:1", "@v1", "@v1  ", *["@q 4:1"] * 3)
    s2.mode = "err"
    say(c1, "@v2 5:1", "@v2 5:1")
    s2.mode = "ok"
    s1.mode = "route"
    say(c1, *["@v2 6:1"] * 3)
    s1.mode = "shed"
    s2.mode = "shed"
    say(c1, "@v2 7:1")
    s1.mode = s2.mode = "ok"
    s0.mode = "fail"
    say(c1, *["1:1 2:1"] * 5)
    healthy_again(s0)
    # capacity: a request hangs on the only v3 replica, so the next one sheds
    s2.mode = "hang"
    hung = {}
    t = threading.Thread(target=lambda: hung.setdefault(
        "reply", score_lines_over_tcp(router.host, router.port, ["@v3 8:1"])[0]))
    t.start()
    _wait_for(lambda: ("s2", "@v3 8:1") in log, what="the hanging request")
    say(c1, "@v3 9:1")
    t.join(10)
    assert not t.is_alive()
    out.append(("hung", hung["reply"]))
    s2.mode = "fail"
    say(c1, "@v2 10:1", "@v2 10:1", "@v2 10:1", "@v2 10:1")
    say(c2, "MODELS")
    say(c1, "@v3 11:1")         # its only replica is ejected: an outage
    healthy_again(s2)
    # label fan-out, by connection scope and by @-address
    s0.label, s1.label = "joined", "pending"
    say(c1, "LABEL r1 1")
    say(c2, "LABEL r2 0", "@v1 LABEL r3 1", "@v9 LABEL r4 1")
    for s in stubs:
        s.label = "err"
    say(c1, "LABEL r5 1")
    for s in stubs:
        s.label = "duplicate"
    say(c1, "@v2 LABEL r6 0")
    # the canary split: seeded draws
    say(c1, "SPLIT v1 v2 0.5", *["1:1 4:1"] * 8, "MODELS", "SPLIT v1 v2 0")
    say(c1, "SPLIT v1 v9 0.5", "SPLIT v1 v1 0.5", "SPLIT v1 v2 2", "SPLIT v1", "SPLIT v1 v2 x")
    # the shadow mirror, drained after each mirrored request
    say(c1, "SHADOW v1 v3 1")
    for _ in range(3):
        say(c1, "1:1 5:1")
        router._shadow_mirror.drain(10.0)
    say(c1, "SHADOW v1 v3 0", "SHADOW v1 v9 0.5")
    # elastic registry
    say(c1, f"ADDREPLICA v1 {s3.addr}", *["1:1 6:1"] * 3, f"ADDREPLICA v1 {s3.addr}",
        f"DELREPLICA v1 {s3.addr}", f"DELREPLICA v1 {s3.addr}", f"ADDREPLICA v4 {s3.addr}",
        "@v4 1:1", "ADDREPLICA v4", "DELREPLICA v1 nohost:1")
    say(c2, "MODELS", "PROMOTE v1 v2", "MODELS", "PROMOTE v1", "PROMOTE v1 v9")
    say(c1, *["1:1 7:1"] * 3, "MODEL v1", "1:1 7:1")
    c1.close()
    c2.close()
    return out


def _stats_shape(doc):
    if isinstance(doc, dict):
        return {k: _stats_shape(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_stats_shape(v) for v in doc]
    if isinstance(doc, bool) or doc is None:
        return doc
    return "number" if isinstance(doc, (int, float)) else type(doc).__name__


class TestRouterProtocolParity:
    def test_scripted_session_equal_to_jax(self):
        log: list = []
        stubs = [_Stub(f"s{i}", log) for i in range(4)]
        s0, s1, s2, _ = stubs
        spec = f"v1={s0.addr}+{s1.addr},v2={s1.addr}+{s2.addr},v3={s2.addr},q={s0.addr}"
        runs = []
        try:
            for cls in (ScoringRouter, JaxRouter):
                log.clear()
                for s in stubs:
                    s.mode, s.label = "ok", "pending"
                router = cls(spec, **ROUTER_KW).start()
                try:
                    replies = _session(router, stubs, log)
                    stats = router.stats()
                finally:
                    router.stop()
                runs.append((replies, list(log), stats))
        finally:
            for s in stubs:
                s.shutdown()
                s.server_close()
        (ours, our_log, our_stats), (theirs, their_log, their_stats) = runs
        for (line, a), (_, b) in zip(ours, theirs):
            assert a == b, line
        assert len(ours) == len(theirs)
        assert our_log == their_log
        # the shape of STATS, and every counter in it
        for doc in (our_stats, their_stats):
            doc.pop("qps")
            doc.pop("p50_ms")
            doc.pop("p99_ms")
        assert our_stats == their_stats
        # the session reached every branch it scripts
        replies = [r for _, r in ours]
        for want in ("ERR SHED tenant", "ERR SHED:", "ERR ROUTE: no healthy",
                     "ERR ROUTE: request failed", "ERR MODEL: unknown", "ERR LABEL",
                     "OK joined", "OK pending", "OK duplicate", "OK PROMOTE", "OK ADDREPLICA",
                     "ERR SPLIT", "ERR PROMOTE", "ERR ValueError"):
            assert any(r.startswith(want) for r in replies), want
        assert our_stats["retries"] >= 1 and our_stats["shed"] >= 2
        assert sum(r["ejections"] for r in our_stats["replicas"]) >= 2
        assert sum(r["reinstates"] for r in our_stats["replicas"]) >= 2
        assert our_stats["shadow"]["mirrored"] == 3

    def test_trace_prefix_is_forwarded_like_jax(self):
        """A ``TRACE <tid>/<sid>`` line: both routers answer the replica's
        reply and forward ``TRACE <tid>/<span> <line>`` under the caller's
        trace id (a new span id, the route.request span's); a malformed
        prefix answers JAX's ERR on both, counted as an error."""
        lines = ["TRACE 00000000000000ab/0000000000000001 1:1", "TRACE broken",
                 "TRACE nothex/zz 1:1", "1:1"]
        got = {}
        for name, cls in (("ours", ScoringRouter), ("jax", JaxRouter)):
            log: list = []
            stub = _Stub("s0", log)
            try:
                with cls(stub.addr) as router:
                    replies = score_lines_over_tcp(router.host, router.port, lines)
                    errors = router.stats()["errors"]
            finally:
                stub.shutdown()
                stub.server_close()
            got[name] = (replies, errors, log)
        (ours, our_errors, our_log), (theirs, their_errors, their_log) = got["ours"], got["jax"]
        assert ours[1:3] == theirs[1:3] and ours[1].startswith("ERR TRACE: need TRACE")
        assert ours[2] == "ERR TRACE: malformed trace token 'nothex/zz'"
        assert our_errors == their_errors == 2
        for log in (our_log, their_log):
            assert [line for _, line in log][1:] == ["1:1"]
            fwd = log[0][1].split(" ")
            assert fwd[0] == "TRACE" and fwd[2] == "1:1"
            assert fwd[1].startswith("00000000000000ab/") and fwd[1] != lines[0].split(" ")[1]
        # the stub's score hashes the forwarded line, whose span id is random
        assert not ours[0].startswith("ERR") and not theirs[0].startswith("ERR")
        assert ours[3] == theirs[3]

    @pytest.mark.parametrize("kw", [
        {"max_inflight": 0}, {"eject_after": 0}, {"health_interval_s": 0},
        {"probe_backoff_s": 0}, {"probe_backoff_s": 2.0, "probe_backoff_max_s": 1.0},
        {"retries": -1}, {"quotas": "v9=1"}, {"replicas": "h:x"}, {"replicas": "[::1]:5"},
        {"replicas": "v1=h:1,v1=h:2"},
    ])
    def test_constructor_validation_matches_jax(self, kw):
        kw = {"replicas": "v1=127.0.0.1:1", **kw}
        replicas = kw.pop("replicas")
        with pytest.raises(ValueError) as a:
            ScoringRouter(replicas, **kw)
        with pytest.raises(ValueError) as b:
            JaxRouter(replicas, **kw)
        assert str(a.value) == str(b.value)


# --- several engines in one server ---------------------------------------------
def _engines(package, weights):
    out = {}
    for mid, w in weights.items():
        if package == "ours":
            eng = ScoringEngine(Config(device="cpu", num_feature_dim=D, l2_c=0.0,
                                       compute_dtype="float32"), max_batch_size=64)
        else:
            eng = JaxEngine(JaxConfig(num_feature_dim=D, l2_c=0.0, compute_dtype="float32"),
                            max_batch_size=64)
        eng.set_weights(w)
        out[mid] = eng
    return out


def _assert_same_replies(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if a.startswith(("ERR", "OK")) or b.startswith(("ERR", "OK")):
            assert a == b
        elif a.startswith("{"):
            da, db = json.loads(a), json.loads(b)
            assert da["labels"] == db["labels"]
            np.testing.assert_allclose(da["scores"], db["scores"], rtol=1e-5)
        else:
            assert a.split()[0] == b.split()[0]
            np.testing.assert_allclose(float(a.split()[1]), float(b.split()[1]), rtol=1e-5)


SERVER_LINES = [
    "1:1 3:1", "@v2 1:1 3:1", "@v1 2:0.5 8:1", "@v3 1:1", "@ 1:1", "@v2", "MODEL v2", "1:1",
    '{"rows": ["1:1", "2:1 4:-1"]}', '@v1 {"rows": ["1:1", "5:1"]}', "MODEL v7", "MODEL",
    "MODEL a b", "4:1", "@v2 1:x", "MODEL v1", "6:1 7:1",
]


class TestMultiEngineServer:
    def test_lines_and_stats_equal_to_jax(self):
        got = []
        for pkg, cls in (("ours", ScoringServer), ("theirs", JaxServer)):
            with cls(engines=_engines(pkg, {"v1": W1, "v2": W2}), max_wait_ms=0.5) as srv:
                replies = score_lines_over_tcp(srv.host, srv.port, SERVER_LINES)
                stats = json.loads(score_lines_over_tcp(srv.host, srv.port, ["STATS"])[0])
            got.append((replies, stats))
        (ours, our_stats), (theirs, their_stats) = got
        _assert_same_replies(ours, theirs)
        assert _stats_shape(our_stats) == _stats_shape(their_stats)
        for k in ("requests", "errors", "models"):
            assert our_stats[k] == their_stats[k], k
        for mid in ("v1", "v2"):
            assert (our_stats["per_model"][mid]["requests"]
                    == their_stats["per_model"][mid]["requests"])
        # the addressed versions answered with their own weights
        assert float(ours[1].split()[1]) == pytest.approx(
            _sigmoid(_dense("1:1 3:1") @ W2), rel=1e-5)
        assert float(ours[0].split()[1]) == pytest.approx(
            _sigmoid(_dense("1:1 3:1") @ W1), rel=1e-5)

    @pytest.mark.parametrize("kw,match", [
        ({}, "need an engine"), ({"engines": {}}, "at least|>= 1"),
        ({"engine": "x", "engines": {"a": "y"}}, "not both"),
    ])
    def test_constructor_validation(self, kw, match):
        with pytest.raises(ValueError, match=match):
            ScoringServer(**kw)

    def test_hot_tracker_follows_the_default_engine_only(self):
        from distlr_tpu_torch.serve import HotSetTracker

        tracker = HotSetTracker(16)
        with ScoringServer(engines=_engines("ours", {"v1": W1, "v2": W2}),
                           hot_tracker=tracker) as srv:
            score_lines_over_tcp(srv.host, srv.port, ["1:1", "@v2 5:1", "@v1 3:1"])
        assert dict(tracker._counts) == {0: 1, 2: 1}

    def test_stop_stops_the_extra_reloaders(self):
        class Reloader:
            stopped = 0

            def stop(self):
                Reloader.stopped += 1

        srv = ScoringServer(engines=_engines("ours", {"v1": W1, "v2": W2}),
                            extra_reloaders=[Reloader(), Reloader()]).start()
        srv.stop()
        assert Reloader.stopped == 2


# --- namespaces ----------------------------------------------------------------
LAYOUT_SPECS = [
    ("v1,v2", 16), (" v1 , v2 ,v3 ", 4), ("v1:sgd,v2", 8), ("v1=8,v2=8", 8), ("v1=8,v2=8", 0),
    ({"a": 4, "b": 4}, 4), (["x", "y"], 5), ("", 4), ("v1,v1", 4), ("v1=8,v2=4", 8),
    ("v1=x", 8), ("v1", 0), ({"a": 4}, 8), ("v1:bad", 4),
]


class TestNamespaces:
    @pytest.mark.parametrize("spec,dim", LAYOUT_SPECS)
    def test_layout_matches_jax(self, spec, dim):
        def layout(fn):
            try:
                return "ok", fn(spec, dim)
            except ValueError as e:
                return "ValueError", str(e)

        assert layout(namespace_layout) == layout(jax_namespace_layout)

    def test_parse_namespace_optimizers_matches_jax_or_names_a16(self):
        from distlr_tpu.ps import parse_namespace_optimizers as jax_parse

        from distlr_tpu_torch.ps import parse_namespace_optimizers

        for spec in ("v1,v2", "v1:sgd, v2 : sgd ,v3", None, 5, "v1:ftrl,v2",
                     "v1:ftrl, v2:sgd ,v3:ftrl"):
            assert parse_namespace_optimizers(spec) == jax_parse(spec)
        for spec in ("v1:adam",):
            with pytest.raises(ValueError) as a:
                parse_namespace_optimizers(spec)
            with pytest.raises(ValueError) as b:
                jax_parse(spec)
            assert str(a.value) == str(b.value)
        # an FTRL namespace is accepted: the same optimizers and layout as JAX's
        assert parse_namespace_optimizers("v1:ftrl,v2") == {"v1": "ftrl"}
        for spec in ("v1:ftrl,v2", "v1:ftrl=4,v2=4", "a:sgd,b:ftrl,c"):
            assert namespace_layout(spec, 4) == jax_namespace_layout(spec, 4)

    def test_both_clients_read_the_same_bytes_of_each_slice(self):
        """Two namespaces of 16 on a port group of 2 servers (total 32):
        each seeded through the port's view with ``push_init(force=True)``,
        one pushed to, one row-pulled; JAX's views read the same bytes."""
        layout = namespace_layout("v1,v2", 16)
        rng = np.random.default_rng(3)
        w = {m: rng.standard_normal(16).astype(np.float32) for m in layout}
        with ServerGroup(2, 1, dim=32, learning_rate=1.0, sync=False) as sg, \
                KVWorker(sg.hosts, 32) as kv, JaxKVWorker(sg.hosts, 32, client_id=1) as jkv:
            kv.push_init(np.zeros(32, np.float32))
            views = {m: kv.namespace(*layout[m]) for m in layout}
            for m, v in views.items():
                v.push_init(w[m], force=True)
            grad = np.zeros(8, np.float32)
            grad[[1, 5]] = 1.0
            views["v2"].push(grad.reshape(4, 2)[[0, 2]].reshape(-1),
                             np.array([0, 2], np.uint64), vals_per_key=2)
            w["v2"][[1, 5]] -= 1.0
            for m, v in views.items():
                jv = jkv.namespace(*layout[m])
                for args, kw in (((), {}), ((np.array([1, 3], np.uint64),), {"vals_per_key": 4}),
                                 ((), {"vals_per_key": 2})):
                    np.testing.assert_array_equal(v.pull(*args, **kw), jv.pull(*args, **kw))
                np.testing.assert_array_equal(v.pull_chunked(chunk_rows=3),
                                              jv.pull_chunked(chunk_rows=3))
                np.testing.assert_array_equal(v.pull_chunked(), w[m])
                table = np.zeros(16, np.float32)
                assert v.pull_rows_into(table, np.array([1, 6], np.uint64), vals_per_key=2) == 2
                np.testing.assert_array_equal(table[[2, 3, 12, 13]], w[m][[2, 3, 12, 13]])
                assert v.supports_vals_per_key(4) == jv.supports_vals_per_key(4) is True
            # push_pull through the view: the post-update slice
            out = views["v1"].push_pull(np.ones(16, np.float32))
            np.testing.assert_array_equal(out, w["v1"] - 1.0)
            np.testing.assert_array_equal(kv.pull()[16:], w["v2"])  # v2 untouched
            for bad in ((np.array([16], np.uint64),), ):
                with pytest.raises(ValueError, match="outside namespace"):
                    views["v1"].pull(*bad)
            with pytest.raises(ValueError, match="outside the group"):
                kv.namespace(24, 16)

    @pytest.mark.parametrize("kw,slot", [
        ({"ns_base": 16, "ns_total_dim": 32}, 1), ({"ns_total_dim": 64}, 0),
    ])
    def test_namespace_watcher_options_accepted_like_jax(self, kw, slot):
        """A namespaced ``LivePSWatcher`` (JAX's ``ns_base`` / ``ns_total_dim``)
        serves its slice only, as JAX's does on the same group."""
        total = kw["ns_total_dim"]
        init = np.arange(total, dtype=np.float32)
        with ServerGroup(2, 1, dim=total, sync=False) as sg:
            with KVWorker(sg.hosts, total) as kv:
                kv.push_init(init)
            ours = LivePSWatcher(sg.hosts, 16, chunk_rows=5, **kw)
            theirs = JaxLivePSWatcher(sg.hosts, 16, chunk_rows=5, client_id=4000, **kw)
            try:
                (v1, w1), (v2, w2) = ours.poll(), theirs.poll()
            finally:
                ours.close()
                theirs.close()
        np.testing.assert_array_equal(w1, init[16 * slot:16 * slot + 16])
        np.testing.assert_array_equal(w1, w2)
        assert v1 == v2 == 1
        assert ours.stats() == theirs.stats()
        assert ours.stats()["namespace"] == [16 * slot, 16, total]

    def test_namespace_watcher_range_check_matches_jax(self):
        for kw in ({"ns_base": 20, "ns_total_dim": 32}, {"ns_base": -1, "ns_total_dim": 32}):
            with pytest.raises(ValueError) as a:
                LivePSWatcher("127.0.0.1:1", 16, **kw)
            with pytest.raises(ValueError) as b:
                JaxLivePSWatcher("127.0.0.1:1", 16, **kw)
            assert str(a.value) == str(b.value)


# --- end to end: a router over two servers ---------------------------------------
class TestRouterOverServers:
    def test_split_replies_equal_to_jax(self):
        rng = np.random.default_rng(2)
        lines = [" ".join(f"{c + 1}:{v:.3f}" for c, v in zip(
            np.sort(rng.choice(D, 3, replace=False)), rng.standard_normal(3)))
            for _ in range(24)]
        script = (["@v2 " + ln for ln in lines[:4]] + lines[:6] + ["SPLIT v1 v2 0.5"]
                  + lines + ['{"rows": ' + json.dumps(lines[:5]) + "}", "STATS"])
        got = []
        for pkg, srv_cls, router_cls in (("ours", ScoringServer, ScoringRouter),
                                         ("theirs", JaxServer, JaxRouter)):
            a = srv_cls(engines=_engines(pkg, {"v1": W1, "v2": W2}), max_wait_ms=0.5).start()
            b = srv_cls(engines=_engines(pkg, {"v1": W1, "v2": W2}), max_wait_ms=0.5).start()
            spec = f"v1={a.host}:{a.port}+{b.host}:{b.port},v2={a.host}:{a.port}+{b.host}:{b.port}"
            try:
                with router_cls(spec, seed=0) as router:
                    replies = score_lines_over_tcp(router.host, router.port, script)
            finally:
                a.stop()
                b.stop()
            got.append((replies[:-1], json.loads(replies[-1])))
        (ours, our_stats), (theirs, their_stats) = got
        _assert_same_replies(ours, theirs)
        for k in ("requests", "errors", "shed", "retries", "per_model"):
            assert our_stats[k] == their_stats[k], k
        # each reply is one version's score, and the split sent some to v2
        z1 = np.array([_dense(ln) @ W1 for ln in lines])
        z2 = np.array([_dense(ln) @ W2 for ln in lines])
        scores = np.array([float(r.split()[1]) for r in ours[11:11 + len(lines)]])
        is_v2 = np.abs(scores - _sigmoid(z2)) < 1e-5
        assert ((np.abs(scores - _sigmoid(z1)) < 1e-5) | is_v2).all()
        assert 0 < is_v2.sum() < len(lines)


# --- the CLI -------------------------------------------------------------------
def _model_files(tmp_path):
    paths = {}
    for name, w in (("v1", W1), ("v2", W2)):
        paths[name] = str(tmp_path / f"{name}.txt")
        save_model_text(paths[name], w)
    return paths


def _serve_both(monkeypatch, argv, lines):
    """``launch serve`` of both packages in process, ``serve_forever``
    replaced by a probe: the hosted ids, the replies, and the reload
    source's stats."""
    seen = {}
    for name, mod, srv_cls in (("ours", launch, ScoringServer),
                               ("theirs", jax_launch, JaxServer)):
        def probe(self, name=name):
            reload = self.reloader.stats()["source"] if self.reloader is not None else None
            seen[name] = (list(self.engines), [self.handle_line(ln) for ln in lines], reload)
            self.stop()

        monkeypatch.setattr(srv_cls, "serve_forever", probe)
        monkeypatch.setattr(signal, "signal", lambda *a: None)
        extra = ["--device", "cpu"] if mod is launch else []
        assert mod.main(["serve", "--num-feature-dim", str(D), "--l2-c", "0",
                         "--reload-interval", "30", *extra, *argv]) == 0
    return seen


class TestLaunchServeTenancy:
    @pytest.mark.parametrize("flag", ["--model-id", "--extra-model", "--ps-namespaces",
                                      "--ps-namespace"])
    def test_tenant_serve_flags_accepted_like_jax(self, flag, monkeypatch, tmp_path):
        files = _model_files(tmp_path)
        lines = ["1:1 3:1", "@v2 1:1 3:1", "@v1 2:1", "@default 2:1"]
        if flag in ("--model-id", "--extra-model"):
            argv = ["--model-file", files["v1"]]
            argv += (["--model-id", "v1"] if flag == "--model-id"
                     else ["--extra-model", f"v2={files['v2']}"])
            seen = _serve_both(monkeypatch, argv, lines)
        else:
            with ServerGroup(2, 1, dim=2 * D, sync=False) as sg:
                with KVWorker(sg.hosts, 2 * D) as kv:
                    kv.push_init(np.concatenate([W1, W2]))
                argv = ["--ps-hosts", sg.hosts, "--ps-namespaces", "v1,v2"]
                argv += (["--model-id", "v1", "--extra-model", "v2=@ps"]
                         if flag == "--ps-namespaces" else ["--ps-namespace", "v2"])
                seen = _serve_both(monkeypatch, argv, lines)
        (ids, ours, src), (jids, theirs, jsrc) = seen["ours"], seen["theirs"]
        assert ids == jids
        _assert_same_replies(ours, theirs)
        assert src == jsrc
        want = {"--model-id": ["v1"], "--extra-model": ["default", "v2"],
                "--ps-namespaces": ["v1", "v2"], "--ps-namespace": ["default"]}[flag]
        assert ids == want
        if flag == "--ps-namespace":
            # the primary engine serves v2's slice (bf16 products)
            assert src["namespace"] == [D, D, 2 * D]
            w2 = torch.from_numpy(W2).bfloat16().double().numpy()
            assert float(ours[0].split()[1]) == pytest.approx(
                _sigmoid(_dense("1:1 3:1") @ w2), abs=1e-5)

    @pytest.mark.parametrize("argv,match", [
        (["--extra-model", "v2"], "bad --extra-model"),
        (["--extra-model", "default=M"], "duplicate model id"),
        (["--extra-model", "v2=@ps"], "needs --ps-hosts"),
        (["--ps-namespaces", "v1,v2"], "live-PS reload only"),
    ])
    def test_serve_flag_errors_exit_2_like_jax(self, argv, match, tmp_path, capsys):
        files = _model_files(tmp_path)
        argv = [a.replace("M", files["v2"]) if a.endswith("=M") else a for a in argv]
        errs = []
        for mod, extra in ((launch, ["--device", "cpu"]), (jax_launch, [])):
            assert mod.main(["serve", "--num-feature-dim", str(D), "--model-file", files["v1"],
                             *extra, *argv]) == 2
            errs.append(capsys.readouterr().err.strip().splitlines()[-1])
        assert match in errs[0]
        assert errs[0] == errs[1]

    def test_route_and_rollout_through_both_clis(self, monkeypatch, tmp_path, capsys):
        """``launch route`` (``serve_forever`` replaced by a session that runs
        ``launch rollout`` against it) in front of two servers hosting v1
        and v2, through each package: the ROUTING line, the rollout's exit
        0 and journal, and replies that equal σ(x·w_v2) after the PROMOTE."""
        lines = ["1:1 3:1", "2:0.5 7:1", "@v1 1:1 3:1"]
        results = {}
        for name, mod, router_cls, srv_cls in (
                ("ours", launch, ScoringRouter, ScoringServer),
                ("theirs", jax_launch, JaxRouter, JaxServer)):
            pkg = "ours" if name == "ours" else "theirs"
            a = srv_cls(engines=_engines(pkg, {"v1": W1, "v2": W2}), max_wait_ms=0.5).start()
            b = srv_cls(engines=_engines(pkg, {"v1": W1, "v2": W2}), max_wait_ms=0.5).start()
            addrs = f"{a.host}:{a.port}+{b.host}:{b.port}"
            journal = str(tmp_path / name)

            def session(self, mod=mod, name=name, journal=journal):
                self.start()
                try:
                    rc = mod.main(["rollout", "--router", f"{self.host}:{self.port}",
                                   "--tenant", "v1", "--candidate", "v2", "--stages",
                                   "0.5:0.05,1.0:0.05", "--unwatched", "--journal-dir",
                                   journal, "--poll-interval", "0.01"])
                    results[name] = {"rc": rc, "replies": score_lines_over_tcp(
                        self.host, self.port, lines)}
                finally:
                    self.stop()

            monkeypatch.setattr(router_cls, "serve_forever", session)
            monkeypatch.setattr(signal, "signal", lambda *a: None)
            try:
                assert mod.main(["route", "--replicas", f"v1={addrs},v2={addrs}",
                                 "--quota", "v2=100"]) == 0
            finally:
                a.stop()
                b.stop()
            out = capsys.readouterr().out
            assert out.startswith("ROUTING 127.0.0.1:")
            doc = json.loads(out.split("ROLLOUT ", 1)[1].splitlines()[0])
            with open(os.path.join(journal, "rollout", "ramp-0000.jsonl")) as f:
                events = [json.loads(ln)["event"] for ln in f]
            results[name].update(outcome=doc["outcome"], events=events)
        assert results["ours"]["rc"] == results["theirs"]["rc"] == 0
        assert results["ours"]["events"] == results["theirs"]["events"] == [
            "start", "stage", "stage", "promote"]
        _assert_same_replies(results["ours"]["replies"], results["theirs"]["replies"])
        want = _sigmoid([_dense(ln.removeprefix("@v1 ")) @ W2 for ln in lines])
        got = [float(r.split()[1]) for r in results["ours"]["replies"]]
        np.testing.assert_allclose(got, want, rtol=1e-5)

    @pytest.mark.parametrize("cmd,argv", [
        ("route", ["--replicas", "v1="]),
        ("route", ["--replicas", "h:1", "--max-inflight", "0"]),
        ("route", ["--replicas", "v1=h:1", "--quota", "v9=1"]),
        ("rollout", ["--router", "h:1", "--tenant", "v1", "--candidate", "v2"]),
        ("rollout", ["--router", "nohost", "--tenant", "v1", "--candidate", "v2"]),
        ("rollout", ["--router", "h:1", "--tenant", "v1", "--candidate", "v2",
                     "--stages", "0.5,0.25", "--unwatched"]),
    ])
    def test_error_exits_match_jax(self, cmd, argv, monkeypatch, capsys):
        monkeypatch.setattr(signal, "signal", lambda *a: None)
        errs = []
        for mod in (launch, jax_launch):
            assert mod.main([cmd, *argv]) == 2
            errs.append(capsys.readouterr().err.strip())
        assert errs[0] == errs[1] and errs[0].startswith("error: ")

    def test_processes_serve_route_and_roll_out(self, tmp_path):
        """Two ``launch serve --model-id v1 --extra-model v2=...`` processes,
        ``launch route`` and ``launch rollout`` as subprocesses on the CPU:
        the rollout exits 0 with ``promoted`` last in its journal, replies
        through the router equal σ(x·w_v2) to 1e-5, and each process exits
        143 on SIGTERM."""
        files = _model_files(tmp_path)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs = []

        def start(*argv, ready):
            p = subprocess.Popen([sys.executable, "-m", "distlr_tpu_torch.launch", *argv],
                                 cwd=REPO, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
            procs.append(p)
            line = p.stdout.readline()
            assert line.startswith(ready), (line, p.stderr.read() if p.poll() else "")
            return line.split()[1]

        try:
            addrs = [start("serve", "--num-feature-dim", str(D), "--model-file", files["v1"],
                           "--model-id", "v1", "--extra-model", f"v2={files['v2']}",
                           "--device", "cpu", "--port", "0", ready="SERVING ")
                     for _ in range(2)]
            pool = "+".join(addrs)
            router = start("route", "--replicas", f"v1={pool},v2={pool}", "--health-interval",
                           "0.2", ready="ROUTING ")
            host, port = router.rsplit(":", 1)
            before = score_lines_over_tcp(host, int(port), ["1:1 3:1", "@v2 1:1 3:1"])
            ro = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", "rollout",
                                 "--router", router, "--tenant", "v1", "--candidate", "v2",
                                 "--stages", "0.5:0.2,1.0:0.2", "--unwatched",
                                 "--journal-dir", str(tmp_path)],
                                cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
            assert ro.returncode == 0, ro.stderr
            after = score_lines_over_tcp(host, int(port), ["1:1 3:1", "5:1 8:1"])
            for p in procs:
                p.send_signal(signal.SIGTERM)
            rcs = [p.wait(timeout=30) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                p.stdout.close()
                p.stderr.close()
        assert rcs == [143, 143, 143]
        with open(tmp_path / "rollout" / "ramp-0000.jsonl") as f:
            assert [json.loads(ln)["event"] for ln in f][-1] == "promote"
        assert "ROLLOUT " in ro.stdout and '"promoted"' in ro.stdout
        # the CLI's products are bf16: the weights rounded to bf16, the
        # one-hot rows exact
        w1, w2 = (torch.from_numpy(w).bfloat16().double().numpy() for w in (W1, W2))
        np.testing.assert_allclose([float(r.split()[1]) for r in before],
                                   _sigmoid([_dense("1:1 3:1") @ w1, _dense("1:1 3:1") @ w2]),
                                   atol=1e-5)
        np.testing.assert_allclose([float(r.split()[1]) for r in after],
                                   _sigmoid([_dense("1:1 3:1") @ w2, _dense("5:1 8:1") @ w2]),
                                   atol=1e-5)
