"""The port's distributed tracing (``distlr_tpu_torch/obs/dtrace.py`` and
its call sites) against the JAX package's (``distlr_tpu/obs/dtrace.py``),
on the CPU: the counterpart of ``tests/test_dtrace.py``.

* Core: tokens, the sampler (a pure hash: both packages decide alike on
  every id), spans and their journal, the ring.
* Merge: the same journals, written by either package, give equal
  ``merge_run_dirs`` documents from both (the ``producer`` names each
  package); ``launch trace-agg`` and ``launch flightrec`` through the CLI.
* Wire: with sampling off the dense push is ``24 + D*8 + D*4`` bytes in
  both packages; a sampled op carries the 16-byte trailer and the server
  journals its handler span under the client's; a group without the
  capability degrades to client-only spans.
* Serve: a scripted ``TRACE`` session answers JAX's replies byte for
  byte; each package's router forwards its context to the other's server.
* The PS trainer: a sampled run's weights equal an untraced run's bit for
  bit and JAX's at the PS parity tolerance; each step's span names equal
  JAX's.
* End to end: a routed request and its label share one merged trace,
  router to KV server, with JAX's span names.

* The fleet tools read the tracing tier's series: ``launch top``'s route
  latency column and the aggregator's route percentiles
  (``TestTopLatencyColumn``); the aggregator's alert case triggers the
  flight recorder with a direct ``dtrace.trigger``.
"""

import collections
import glob
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from distlr_tpu.config import Config as JaxConfig
from distlr_tpu.obs import dtrace as jax_dtrace
from distlr_tpu_torch.config import Config
from distlr_tpu_torch.obs import dtrace, family_total
from distlr_tpu_torch.ps import KVWorker, RetryPolicy, ServerGroup

D = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUSH_BYTES = 24 + D * 8 + D * 4

@pytest.fixture(autouse=True)
def _reset_tracers():
    yield
    dtrace.reset_for_tests()
    jax_dtrace.reset_for_tests()


def _read_journal(run_dir: str, stem: str) -> list[dict]:
    return dtrace.read_journal(os.path.join(run_dir, "spans", stem + ".jsonl"))


def _write_journal(run_dir, stem, recs):
    d = os.path.join(run_dir, "spans")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, stem + ".jsonl"), "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _same_doc(ours: dict, theirs: dict) -> None:
    """Equal merged documents but for the producer, which names the package."""
    assert ours["otherData"].pop("producer") == "distlr_tpu_torch.obs.dtrace"
    assert theirs["otherData"].pop("producer") == "distlr_tpu.obs.dtrace"
    assert ours == theirs


def _wait_for(pattern: str, timeout: float = 5.0) -> list[str]:
    deadline = time.monotonic() + timeout
    while True:
        found = glob.glob(pattern)
        if found or time.monotonic() > deadline:
            return found
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# core: context, sampler, spans, ring
# ---------------------------------------------------------------------------

class TestCore:
    def test_token_roundtrip_across_packages(self):
        ctx = dtrace.TraceContext(0xDEADBEEF, 0x1234, True)
        assert ctx.token() == jax_dtrace.TraceContext(0xDEADBEEF, 0x1234, True).token()
        for parse in (dtrace.parse_token, jax_dtrace.parse_token):
            back = parse(ctx.token())
            assert (back.trace_id, back.span_id, back.sampled) == (0xDEADBEEF, 0x1234, True)
        with pytest.raises(ValueError, match="malformed trace token"):
            dtrace.parse_token("not-a-token")

    @pytest.mark.parametrize("rate", [0.0, 0.01, 0.1, 0.5, 1.0])
    def test_sampler_equals_jax(self, rate):
        ids = np.random.default_rng(23).integers(1, 2**63, 1000, dtype=np.int64)
        ours = [dtrace.is_sampled(int(i), rate) for i in ids]
        assert ours == [jax_dtrace.is_sampled(int(i), rate) for i in ids]
        if 0.0 < rate < 1.0:
            assert abs(sum(ours) / len(ours) - rate) < max(0.05, rate)
        else:
            assert all(ours) == (rate == 1.0) and any(ours) == (rate == 1.0)

    def test_sampler_monotone(self):
        for i in range(1, 500):
            if dtrace.is_sampled(i, 0.1):
                assert dtrace.is_sampled(i, 0.7)

    def test_unconfigured_process_pays_nothing(self):
        assert not dtrace.is_configured() and dtrace.sample_rate() == 0.0
        assert dtrace.new_trace() is None and dtrace.token() is None
        assert dtrace.current_ids() is None
        with dtrace.span("noop") as sp:
            assert sp is None

    def test_span_nesting_and_journal_like_jax(self, tmp_path):
        """The same script through each package: the same journal records,
        field for field but the random ids and the times."""
        docs = {}
        for name, mod in (("ours", dtrace), ("jax", jax_dtrace)):
            run = str(tmp_path / name)
            mod.configure(run, "unit", 3, sample=1.0)
            ctx = mod.new_trace()
            assert ctx is not None and ctx.sampled
            with mod.use(ctx):
                with mod.span("outer", tags={"k": "v"}) as outer:
                    with mod.span("inner") as inner:
                        assert mod.current_ids() == (ctx.trace_id, inner.span_id)
            mod.flush()
            recs = mod.read_journal(os.path.join(run, "spans", "unit-3.jsonl"))
            spans = {r["name"]: r for r in recs if r["type"] == "span"}
            tid = f"{ctx.trace_id:016x}"
            assert spans["outer"]["trace"] == spans["inner"]["trace"] == tid
            assert spans["inner"]["parent"] == f"{outer.span_id:016x}"
            assert spans["outer"]["parent"] is None and spans["outer"]["args"] == {"k": "v"}
            docs[name] = [{k: v for k, v in r.items()
                           if k not in ("trace", "span", "parent", "ts", "dur", "tid", "pid")}
                          for r in recs]
        assert docs["ours"] == docs["jax"]
        assert docs["ours"][0] == {"type": "meta", "role": "unit", "rank": 3, "sample": 1.0}

    def test_unsampled_spans_ring_only(self, tmp_path):
        run = str(tmp_path)
        dtrace.configure(run, "unit", 0, sample=0.0)
        ctx = dtrace.new_trace()
        assert ctx is not None and not ctx.sampled
        before = family_total("distlr_trace_spans_total")
        with dtrace.use(ctx), dtrace.span("quiet"):
            assert dtrace.token() is None and dtrace.current_ids() is None
        dtrace.flush()
        assert family_total("distlr_trace_spans_total") - before == 1
        assert all(r["type"] != "span" for r in _read_journal(run, "unit-0"))
        dump = json.load(open(dtrace.flight_dump("unit-test")))
        quiet = [r for r in dump["spans"] if r.get("name") == "quiet"]
        assert quiet and quiet[0]["sampled"] is False

    def test_flight_ring_is_bounded(self, tmp_path):
        dtrace._TRACER.configure(str(tmp_path), "unit", 0, sample=0.0, flight_capacity=16)
        for i in range(100):
            dtrace.event("crumb", i=i)
        doc = json.load(open(dtrace.flight_dump("bound-test")))
        assert len(doc["spans"]) == 16
        assert doc["spans"][-1]["args"] == {"i": 99}

    def test_reset_undoes_the_configuration(self, tmp_path):
        """What a long-lived process (the chip smoke) relies on between
        phases: after reset no watcher runs, no journal is open, the
        sample is 0 and a new worker negotiates nothing."""
        dtrace.configure(str(tmp_path), "unit", 0, sample=1.0)
        watcher = dtrace._TRACER._watcher
        assert watcher is not None and watcher.is_alive()
        with dtrace.use(dtrace.new_trace()), dtrace.span("x"):
            dtrace.reset_for_tests()
        assert not watcher.is_alive() and not dtrace.is_configured()
        assert dtrace.sample_rate() == 0.0 and dtrace.current() is None
        assert dtrace._TRACER._journal_file is None and not dtrace._ACTIVE_NAMES


# ---------------------------------------------------------------------------
# trace-agg: merge, clock alignment, chaos instants, CLI
# ---------------------------------------------------------------------------

class TestTraceAgg:
    def test_merge_emits_valid_chrome_json_like_jax(self, tmp_path):
        run = str(tmp_path)
        _write_journal(run, "client-0", [
            {"type": "meta", "role": "client", "rank": 0},
            {"type": "span", "name": "ps.push", "trace": "ab", "span": "01",
             "parent": None, "ts": 1000.0, "dur": 50.0, "tid": 7, "args": {}},
            {"type": "instant", "name": "chaos.reset", "ts": 1010.0, "tid": 7,
             "args": {"link": 0, "trace": "ab"}},
        ])
        out = os.path.join(run, "merged.json")
        doc = dtrace.write_merged_trace([run], out)
        assert json.load(open(out))["traceEvents"] == doc["traceEvents"]
        assert {e["ph"] for e in doc["traceEvents"]} == {"M", "X", "i"}
        assert doc["otherData"]["spans"] == 1 and doc["otherData"]["trace_ids"] == ["ab"]
        _same_doc(doc, jax_dtrace.merge_run_dirs([run]))

    def test_clock_alignment_shifts_server_journal_like_jax(self, tmp_path):
        run = str(tmp_path)
        _write_journal(run, "worker-0", [
            {"type": "meta", "role": "worker", "rank": 0},
            {"type": "clock", "peer": "10.0.0.9:7001", "offset_s": 2.0},
            {"type": "span", "name": "ps.push", "trace": "ab", "span": "01",
             "parent": None, "ts": 1_000_000.0, "dur": 10.0, "tid": 1, "args": {}},
        ])
        _write_journal(run, "kvserver-0", [
            {"type": "meta", "role": "kvserver", "listen": "0.0.0.0:7001"},
            {"type": "span", "name": "kv.push", "trace": "ab", "span": "02",
             "parent": "01", "ts": 3_000_000.0, "dur": 5.0, "tid": 2, "args": {}},
        ])
        doc = dtrace.merge_run_dirs([run])
        by_name = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
        assert by_name["ps.push"]["ts"] == by_name["kv.push"]["ts"] == 1_000_000.0
        assert doc["otherData"]["clock_offsets"] == {"7001": 2.0}
        _same_doc(doc, jax_dtrace.merge_run_dirs([run]))

    def test_journals_of_both_packages_merge_alike(self, tmp_path):
        """One run dir holding a JAX-written and a port-written journal of
        the same script (spans, a chaos instant, a clock record), and a
        second run dir with the same role-rank: both packages' merges are
        the same document."""
        runs = [str(tmp_path / "a"), str(tmp_path / "b")]
        for run, name, mod in [(run, name, mod) for run in runs
                               for name, mod in (("ours", dtrace), ("jax", jax_dtrace))]:
            mod.configure(run, name, 0, sample=1.0)
            mod.record_clock("127.0.0.1:7001", 0.25)
            with mod.use(mod.new_trace()), mod.span("outer", tags={"n": 1}):
                with mod.span("inner"):
                    mod.instant("chaos.delay", tags={"link": 0, "delay_ms": 1})
            mod.flush()
            mod.reset_for_tests()
        _write_journal(runs[0], "kvserver-0", [
            {"type": "meta", "role": "kvserver", "listen": "0.0.0.0:7001"},
            {"type": "span", "name": "kv.push", "trace": "ab", "span": "02",
             "parent": "01", "ts": 3_000_000.0, "dur": 5.0, "tid": 2,
             "args": {"optimizer": "sgd"}}])
        ours = dtrace.merge_run_dirs(runs)
        assert ours["otherData"]["journals"] == ["jax-0", "kvserver-0", "ours-0",
                                                 "jax-0#2", "ours-0#2"]
        assert ours["otherData"]["spans"] == 9 and len(ours["otherData"]["trace_ids"]) == 5
        kv = [e for e in ours["traceEvents"] if e["name"] == "kv.push"]
        assert kv[0]["ts"] == 3_000_000.0 - 0.25e6
        _same_doc(ours, jax_dtrace.merge_run_dirs(runs))

    def test_trace_agg_cli(self, tmp_path):
        from distlr_tpu_torch.launch import main

        run = str(tmp_path / "run")
        _write_journal(run, "client-0", [
            {"type": "span", "name": "x", "trace": "01", "span": "02",
             "parent": None, "ts": 0.0, "dur": 1.0, "tid": 0, "args": {}}])
        out = str(tmp_path / "trace.json")
        assert main(["trace-agg", "--obs-run-dir", run, "--out", out]) == 0
        assert json.load(open(out))["otherData"]["spans"] == 1
        empty = str(tmp_path / "empty")
        os.makedirs(empty)
        assert main(["trace-agg", "--obs-run-dir", empty, "--out", out]) == 1
        assert main(["trace-agg", "--out", out]) == 2

    def test_trace_agg_line_like_jax(self, tmp_path):
        """The scriptable ``TRACE`` line and the exit codes of both CLIs."""
        run = str(tmp_path / "run")
        _write_journal(run, "client-0", [
            {"type": "span", "name": "x", "trace": "01", "span": "02",
             "parent": None, "ts": 0.0, "dur": 1.0, "tid": 0, "args": {}},
            {"type": "span", "name": "y", "trace": "03", "span": "04",
             "parent": None, "ts": 0.0, "dur": 1.0, "tid": 0, "args": {}}])
        lines = []
        for pkg, env in (("distlr_tpu_torch", {}), ("distlr_tpu", {"JAX_PLATFORMS": "cpu"})):
            out = str(tmp_path / f"{pkg}.json")
            proc = subprocess.run([sys.executable, "-m", f"{pkg}.launch", "trace-agg",
                                   "--obs-run-dir", run, "--out", out],
                                  cwd=REPO, capture_output=True, text=True, timeout=300,
                                  env={**os.environ, **env})
            assert proc.returncode == 0, proc.stderr
            lines.append(proc.stdout.strip().replace(out, "<out>"))
        assert lines[0] == lines[1] == "TRACE <out> journals=1 spans=2 traces=2"


# ---------------------------------------------------------------------------
# serve protocol: the TRACE prefix at the server and the router
# ---------------------------------------------------------------------------

def _engines():
    from distlr_tpu.serve import ScoringEngine as JaxEngine
    from distlr_tpu_torch.serve import ScoringEngine

    w = np.linspace(-1, 1, D).astype(np.float32)
    ours = ScoringEngine(Config(device="cpu", model="binary_lr", num_feature_dim=D, l2_c=0.0,
                                compute_dtype="float32"), max_batch_size=64)
    theirs = JaxEngine(JaxConfig(model="binary_lr", num_feature_dim=D, l2_c=0.0,
                                 compute_dtype="float32"), max_batch_size=64)
    ours.set_weights(w)
    theirs.set_weights(w)
    return ours, theirs


SESSION = ["3:1 5:1", "TRACE 00000000000000a1/00000000000000b2 3:1 5:1", "TRACE broken",
           "TRACE nothex/zz 3:1", 'TRACE 00000000000000a1/00000000000000b3 {"rows": ["3:1", "7:1"]}',
           "TRACE 00000000000000a1/00000000000000b4 ID r1 4:1", "LABEL r1 1", "TRACE", "1:1"]


class TestServeProtocol:
    def test_scripted_trace_session_answers_jax_replies(self, tmp_path):
        from distlr_tpu.serve import ScoringServer as JaxServer
        from distlr_tpu_torch.serve import ScoringServer

        ours_eng, jax_eng = _engines()
        replies = {}
        dtrace.configure(str(tmp_path / "ours"), "serve", 0, sample=1.0)
        jax_dtrace.configure(str(tmp_path / "jax"), "serve", 0, sample=1.0)
        for name, srv in (("ours", ScoringServer(ours_eng)), ("jax", JaxServer(jax_eng))):
            try:
                replies[name] = [srv.handle_line(line) for line in SESSION]
                replies[name].append(json.dumps({k: srv.stats()[k] for k in ("errors",)}))
            finally:
                srv.stop()
        assert replies["ours"] == replies["jax"]
        assert replies["ours"][1] == replies["ours"][0]  # the prefix never shows
        assert replies["ours"][2].startswith("ERR TRACE: need TRACE")
        dtrace.flush()
        jax_dtrace.flush()
        names = {}
        for name in ("ours", "jax"):
            recs = _read_journal(str(tmp_path / name), "serve-0")
            req = [r for r in recs
                   if r.get("name") == "serve.request" and r["trace"] == f"{0xA1:016x}"]
            assert [r["parent"] for r in req] == [f"{0xB2:016x}", f"{0xB3:016x}",
                                                  f"{0xB4:016x}"]
            names[name] = collections.Counter(r["name"] for r in recs if r["type"] == "span")
        assert names["ours"] == names["jax"]
        assert {"serve.encode", "serve.score", "serve.batch", "serve.infer"} <= set(names["ours"])

    def test_direct_request_mints_own_root(self, tmp_path):
        from distlr_tpu_torch.serve import ScoringServer

        dtrace.configure(str(tmp_path), "serve", 0, sample=1.0)
        srv = ScoringServer(_engines()[0])
        try:
            assert not srv.handle_line("3:1").startswith("ERR")
            assert srv.handle_line("STATS").startswith("{")
        finally:
            srv.stop()
        dtrace.flush()
        req = [r for r in _read_journal(str(tmp_path), "serve-0")
               if r.get("name") == "serve.request"]
        assert len(req) == 1 and req[0]["parent"] is None

    @pytest.mark.parametrize("router_pkg,server_pkg", [("ours", "ours"), ("ours", "jax"),
                                                      ("jax", "ours")])
    def test_router_propagates_trace_to_replica(self, tmp_path, router_pkg, server_pkg):
        """Each package's router forwards its token to a server of either
        package, which journals its request under that trace and span."""
        from distlr_tpu.serve import ScoringRouter as JaxRouter
        from distlr_tpu.serve import ScoringServer as JaxServer
        from distlr_tpu_torch.serve import ScoringRouter, ScoringServer

        mods = {"ours": dtrace, "jax": jax_dtrace}
        run = str(tmp_path)
        mods[router_pkg].configure(run, f"route{router_pkg}", 0, sample=1.0)
        if server_pkg != router_pkg:
            mods[server_pkg].configure(run, f"serve{server_pkg}", 0, sample=1.0)
        ours_eng, jax_eng = _engines()
        srv = (ScoringServer(ours_eng) if server_pkg == "ours" else JaxServer(jax_eng)).start()
        router_cls = ScoringRouter if router_pkg == "ours" else JaxRouter
        router = router_cls(f"{srv.host}:{srv.port}").start()
        try:
            reply = router.handle_line("3:1 5:1")
            assert not reply.startswith("ERR"), reply
        finally:
            router.stop()
            srv.stop()
        for mod in mods.values():
            mod.flush()
        recs = _read_journal(run, f"route{router_pkg}-0")
        if server_pkg != router_pkg:
            recs += _read_journal(run, f"serve{server_pkg}-0")
        spans = {r["name"]: r for r in recs if r.get("type") == "span"}
        route, serve = spans["route.request"], spans["serve.request"]
        assert route["parent"] is None
        assert serve["trace"] == route["trace"] and serve["parent"] == route["span"]


# ---------------------------------------------------------------------------
# KV wire: negotiation, byte-exact trailer accounting, fallbacks
# ---------------------------------------------------------------------------

def _wire_sent(w) -> int:
    return int(w._lib.kv_last_wire_sent(w._h))


class TestKVWire:
    def test_sample_zero_wire_byte_identical_in_both_packages(self, tmp_path):
        """With tracing unconfigured, or configured at sample 0, a dense
        push is the pre-trace frame: header 24 + 8 B a key + 4 B a value,
        in either package."""
        from distlr_tpu.ps import KVWorker as JaxKVWorker
        from distlr_tpu.ps import ServerGroup as JaxServerGroup

        for worker_cls, group_cls, mod in ((KVWorker, ServerGroup, dtrace),
                                           (JaxKVWorker, JaxServerGroup, jax_dtrace)):
            with group_cls(1, 1, D, sync=False) as group:
                for client_id, configure in ((1, False), (2, True)):
                    if configure:
                        mod.configure(str(tmp_path), "w", 0, sample=0.0)
                    w = worker_cls(group.hosts, D, client_id=client_id, timeout_ms=10_000,
                                   sync_group=False)
                    try:
                        assert not w.trace_active
                        w.push_init(np.zeros(D, np.float32))
                        with mod.use(mod.new_trace()):
                            w.wait(w.push(np.ones(D, np.float32)))
                        assert _wire_sent(w) == PUSH_BYTES
                    finally:
                        w.close()

    def test_sampled_op_carries_16_byte_trailer_and_server_logs_span(self, tmp_path):
        run = str(tmp_path)
        dtrace.configure(run, "w", 0, sample=1.0)
        with ServerGroup(1, 1, D, sync=False,
                         trace_journal_dir=os.path.join(run, "spans")) as group:
            w = KVWorker(group.hosts, D, client_id=1, timeout_ms=10_000, sync_group=False)
            try:
                assert w.trace_active
                w.push_init(np.zeros(D, np.float32))
                assert _wire_sent(w) == PUSH_BYTES  # no context: no trailer
                ctx = dtrace.new_trace()
                with dtrace.use(ctx):
                    w.wait(w.push(np.ones(D, np.float32)))
                    assert _wire_sent(w) == PUSH_BYTES + 16
                    assert w.pull().shape == (D,)
                    w.push_pull(np.ones(D, np.float32))
            finally:
                w.close()
            dtrace.flush()
            time.sleep(0.1)  # the server journals a span after its reply
        py = _read_journal(run, "w-0")
        srv = _read_journal(run, "kvserver-0")
        client = {r["name"]: r for r in py if r.get("type") == "span"}
        assert set(client) == {"ps.push", "ps.pull", "ps.push_pull"}
        srv_spans = [r for r in srv if r.get("type") == "span"]
        assert {r["name"] for r in srv_spans} == {"kv.push", "kv.pull", "kv.push_pull"}
        for r in srv_spans:
            assert r["trace"] == f"{ctx.trace_id:016x}" and r["args"]["optimizer"] == "sgd"
            assert r["parent"] == client["ps." + r["name"][3:]]["span"]
        assert any(r.get("type") == "clock" and r["peer"] == group.hosts for r in py)

    def test_pre_trace_server_degrades_to_client_only_spans(self, tmp_path):
        run = str(tmp_path)
        dtrace.configure(run, "w", 0, sample=1.0)
        # --compress=0 answers kHello as a binary without capabilities
        with ServerGroup(1, 1, D, sync=False, compress=False,
                         trace_journal_dir=os.path.join(run, "spans")) as group:
            w = KVWorker(group.hosts, D, client_id=1, timeout_ms=10_000, sync_group=False)
            try:
                assert not w.trace_active
                w.push_init(np.zeros(D, np.float32))
                with dtrace.use(dtrace.new_trace()):
                    w.wait(w.push(np.ones(D, np.float32)))
                assert _wire_sent(w) == PUSH_BYTES
            finally:
                w.close()
        dtrace.flush()
        assert any(r.get("name") == "ps.push" for r in _read_journal(run, "w-0"))

    def test_trace_off_by_argument_negotiates_nothing(self, tmp_path):
        dtrace.configure(str(tmp_path), "w", 0, sample=1.0)
        with ServerGroup(1, 1, D, sync=False) as group, \
                KVWorker(group.hosts, D, trace=False, sync_group=False) as w:
            w.push_init(np.zeros(D, np.float32))
            with dtrace.use(dtrace.new_trace()):
                w.wait(w.push(np.ones(D, np.float32)))
            assert not w.trace_active and _wire_sent(w) == PUSH_BYTES

    def test_trace_journal_spawn_equals_jax(self, tmp_path, monkeypatch):
        """``trace_journal_dir`` spawns JAX's ``--trace_journal`` flag, in
        JAX's place on the command line, and survives a respawn."""
        from distlr_tpu.ps import server as jax_server_mod

        seen = []

        class _Proc:
            def __init__(self, cmd, **_):
                self.cmd, self.stdout = cmd, self

            def readline(self):
                return "PORT 1\n"

            def poll(self):
                return 0

            def wait(self, timeout=None):
                return 0

            def close(self):
                pass

            kill = terminate = close

        def popen(cmd, **kw):
            seen.append(_Proc(cmd, **kw))
            return seen[-1]

        d = str(tmp_path / "spans")
        monkeypatch.setattr(jax_server_mod.subprocess, "Popen", popen)
        group = jax_server_mod.ServerGroup(2, 1, D, binary="BIN", compress=False,
                                           trace_journal_dir=d)
        group.start()
        group.stop()
        monkeypatch.undo()  # subprocess is one module: the real Popen again
        ours = ServerGroup(2, 1, D, compress=False, trace_journal_dir=d)
        assert [ours._command("BIN", r) for r in range(2)] == [p.cmd for p in seen]
        assert seen[1].cmd[-1] == f"--trace_journal={d}/kvserver-1.jsonl"
        with ServerGroup(1, 1, D, sync=False, trace_journal_dir=d) as group:
            group.procs[0].kill()
            group.procs[0].wait()
            group.respawn(0)
            assert any(a == f"--trace_journal={d}/kvserver-0.jsonl"
                       for a in _proc_args(group.procs[0].pid))


def _proc_args(pid: int) -> list[str]:
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return [a.decode() for a in f.read().split(b"\0") if a]


# ---------------------------------------------------------------------------
# chaos: fault events record the faulted op's trace id
# ---------------------------------------------------------------------------

class TestChaosTraceTag:
    def test_fault_event_carries_trace_id_and_journals_instants(self, tmp_path):
        from distlr_tpu_torch.chaos import parse_plan

        run = str(tmp_path)
        dtrace.configure(run, "w", 0, sample=1.0)
        plan = parse_plan({"seed": 5, "faults": [{"kind": "delay", "links": "*", "delay_ms": 1}]})
        with ServerGroup(1, 1, D, sync=False, via_chaos=plan) as group:
            w = KVWorker(group.hosts, D, client_id=1, timeout_ms=10_000, sync_group=False)
            try:
                assert w.trace_active
                w.push_init(np.zeros(D, np.float32))
                ctx = dtrace.new_trace()
                with dtrace.use(ctx):
                    w.wait(w.push(np.ones(D, np.float32)))
            finally:
                w.close()
            events = group.chaos.events()
        dtrace.flush()
        tid = f"{ctx.trace_id:016x}"
        assert [e for e in events if ("trace", tid) in e], events
        assert [e for e in events
                if not any(isinstance(kv, tuple) and kv[0] == "trace" for kv in e[2:])]
        instants = [r for r in _read_journal(run, "w-0") if r.get("type") == "instant"]
        assert {r["name"] for r in instants} == {"chaos.delay"}
        assert any(r["args"].get("trace") == tid for r in instants)
        assert len(instants) == len(events)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

class TestFlightRecorder:
    def test_manual_trigger_cli_dumps_ring(self, tmp_path):
        from distlr_tpu_torch.launch import main

        run = str(tmp_path / "run")
        dtrace.configure(run, "proc", 2, sample=0.0)
        with dtrace.use(dtrace.new_trace()), dtrace.span("before.trigger"):
            pass
        before = family_total("distlr_trace_flightrec_dumps_total")
        assert main(["flightrec", "--obs-run-dir", run]) == 0
        dumps = _wait_for(os.path.join(run, "flightrec", "proc-2-*.json"))
        assert dumps, "the watcher never dumped"
        doc = json.load(open(dumps[0]))
        assert doc["reason"] == "manual" and doc["role"] == "proc" and doc["rank"] == 2
        assert any(r.get("name") == "before.trigger" for r in doc["spans"])
        assert family_total("distlr_trace_flightrec_dumps_total") - before == 1
        assert main(["flightrec"]) == 2

    def test_ps_retry_trigger_dumps_pre_trigger_spans(self, tmp_path):
        """JAX's alert case with ``dtrace.trigger`` in the aggregator's
        place: a chaos reset makes a worker retry, the trigger names the
        retry alert, and the dump holds the unsampled spans recorded
        before it; one trigger, one dump."""
        from distlr_tpu_torch.chaos import parse_plan

        run = str(tmp_path / "run")
        dtrace.configure(run, "worker", 0, sample=0.0)
        with dtrace.use(dtrace.new_trace()), dtrace.span("pre.alert.step"):
            pass
        before = family_total("distlr_ps_retries_total")
        plan = parse_plan({"seed": 7, "faults": [{"kind": "reset", "links": [0],
                                                   "after_ops": 3}]})
        with ServerGroup(1, 1, D, sync=False, via_chaos=plan) as group:
            w = KVWorker(group.hosts, D, client_id=1, timeout_ms=5000, sync_group=False,
                         retry=RetryPolicy(attempts=4, backoff_ms=10.0, deadline_s=20.0))
            try:
                w.push_init(np.zeros(D, np.float32))
                for _ in range(8):  # op 3 takes the reset and is retried
                    w.pull()
            finally:
                w.close()
        assert family_total("distlr_ps_retries_total") > before
        dtrace.trigger(run, alert="distlr_alert_ps_retry_rate")
        dumps = _wait_for(os.path.join(run, "flightrec", "worker-0-*.json"))
        assert dumps, "triggered, but no flight-recorder dump appeared"
        doc = json.load(open(dumps[0]))
        assert doc["reason"] == "distlr_alert_ps_retry_rate"
        assert any(r.get("name") == "pre.alert.step" for r in doc["spans"])
        time.sleep(0.6)  # the same trigger seq dumps once
        assert len(glob.glob(os.path.join(run, "flightrec", "worker-*.json"))) == 1


# ---------------------------------------------------------------------------
# the PS trainer: bit-equal weights, JAX's spans a step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ps_data_dir(tmp_path_factory):
    from distlr_tpu_torch.data.synthetic import write_synthetic_shards

    d = tmp_path_factory.mktemp("dtrace_ps")
    write_synthetic_shards(str(d), 600, 16, num_parts=2, seed=4, sparsity=0.0)
    return str(d)


def _ps_common(data_dir):
    return dict(data_dir=data_dir, num_feature_dim=16, num_workers=2, num_servers=2,
                num_iteration=4, learning_rate=0.3, l2_c=0.5, batch_size=100,
                test_interval=0, sync_mode=True, ps_compute_backend="numpy",
                compat_mode="reference")


def _spans_by_step(run: str) -> list:
    """Each ``train.step`` trace's span names (the Python journals' and
    the servers'), as sorted lists, sorted."""
    by_trace = collections.defaultdict(list)
    for path in glob.glob(os.path.join(run, "spans", "*.jsonl")):
        for r in dtrace.read_journal(path):
            if r.get("type") == "span":
                by_trace[r["trace"]].append(r)
    steps = [recs for recs in by_trace.values() if any(r["name"] == "train.step" for r in recs)]
    for recs in steps:
        ids = {r["span"]: r for r in recs}
        for r in recs:  # every span but the root hangs off one of its trace
            assert r["name"] == "train.step" or r["parent"] in ids, r
    return sorted(sorted(r["name"] for r in recs) for recs in steps)


class TestPSTrainer:
    @pytest.mark.parametrize("pipeline,sync", [(True, True), (False, True), (True, False)],
                             ids=["fused_sync", "serialized_sync", "pipelined_async"])
    def test_sampled_run_equals_untraced_and_jax(self, ps_data_dir, tmp_path, pipeline, sync):
        from distlr_tpu.train.ps_trainer import run_ps_local as jax_run_ps_local
        from distlr_tpu_torch.train.ps_trainer import run_ps_local

        common = dict(_ps_common(ps_data_dir), ps_pipeline=pipeline, sync_mode=sync)
        if not sync:  # one Hogwild worker: deterministic
            common["num_workers"] = 1
        plain = run_ps_local(Config(device="cpu", **common))
        runs = {n: str(tmp_path / n) for n in ("ours", "jax")}
        dtrace.configure(runs["ours"], "ps", 0, sample=1.0)
        traced = run_ps_local(Config(device="cpu", obs_run_dir=runs["ours"], trace_sample=1.0,
                                     **common))
        jax_dtrace.configure(runs["jax"], "ps", 0, sample=1.0)
        ref = jax_run_ps_local(JaxConfig(obs_run_dir=runs["jax"], trace_sample=1.0, **common))
        dtrace.flush()
        jax_dtrace.flush()
        for a, b, c in zip(traced, plain, ref):
            assert np.array_equal(a, b)
            np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-7)
        ours, theirs = _spans_by_step(runs["ours"]), _spans_by_step(runs["jax"])
        assert len(ours) >= 4 * 3 and ours == theirs
        op = "ps.push_pull" if pipeline else "ps.push"
        assert all("train.step" in s and op in s for s in ours)

    def test_launch_ps_journals_steps_and_server_spans(self, tmp_path):
        """``launch ps --obs-run-dir --trace-sample 1.0``: the ps process's
        journal, one per server rank, and ``trace-agg``'s merged trace
        with each step's ``train.step -> ps.push_pull -> kv.push_pull``."""
        from distlr_tpu_torch.data.synthetic import write_synthetic_shards

        d, run = str(tmp_path / "d"), str(tmp_path / "run")
        write_synthetic_shards(d, 200, 8, num_parts=2, seed=1, sparsity=0.0)
        cmd = [sys.executable, "-m", "distlr_tpu_torch.launch"]
        proc = subprocess.run(cmd + ["ps", "--data-dir", d, "--num-feature-dim", "8",
                                     "--num-workers", "2", "--num-servers", "2",
                                     "--num-iteration", "2", "--test-interval", "0",
                                     "--device", "cpu", "--obs-run-dir", run,
                                     "--trace-sample", "1.0"],
                              cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert any(ln.startswith("METRICS ") for ln in proc.stdout.splitlines())
        # the profiler's windows, the servers' CPU windows beside them
        assert sorted(os.listdir(os.path.join(run, "profiles"))) == [
            "kvserver-0.jsonl", "kvserver-1.jsonl", "ps-0.jsonl"]
        assert sorted(os.listdir(os.path.join(run, "spans"))) == [
            "kvserver-0.jsonl", "kvserver-1.jsonl", "ps-0.jsonl"]
        assert os.listdir(os.path.join(run, "endpoints")) == []  # left at the clean exit
        out = str(tmp_path / "merged.json")
        agg = subprocess.run(cmd + ["trace-agg", "--obs-run-dir", run, "--out", out],
                             cwd=REPO, capture_output=True, text=True, timeout=300)
        assert agg.returncode == 0, agg.stderr
        assert agg.stdout.startswith(f"TRACE {out} journals=3 spans=")
        spans = [e for e in json.load(open(out))["traceEvents"] if e["ph"] == "X"]
        by_span = {e["args"]["span"]: e for e in spans}
        steps = [e for e in spans if e["name"] == "train.step"]
        assert len(steps) == 2 * 2
        for kv in (e for e in spans if e["name"] == "kv.push_pull"):
            client = by_span[kv["args"]["parent"]]
            assert client["name"] == "ps.push_pull"
            assert by_span[client["args"]["parent"]]["name"] == "train.step"
        assert sum(e["name"] == "kv.push_pull" for e in spans) == 2 * 2 * 2


# ---------------------------------------------------------------------------
# launch: what a run dir holds
# ---------------------------------------------------------------------------

def test_run_dir_layout_of_each_package(tmp_path):
    """``launch sync --obs-run-dir``: the subdirectories each package leaves
    in the run dir are the same: ``endpoints/`` (emptied at the clean
    exit), ``logs/``, ``profiles/`` and ``spans/``, each with the process's
    ``sync-0`` journal."""
    from distlr_tpu_torch.data.synthetic import write_synthetic_shards

    d = str(tmp_path / "d")
    write_synthetic_shards(d, 200, 8, num_parts=1, seed=1)
    layout = {}
    for pkg, extra in (("distlr_tpu_torch", ["--device", "cpu"]), ("distlr_tpu", [])):
        run = str(tmp_path / pkg)
        proc = subprocess.run([sys.executable, "-m", f"{pkg}.launch", "sync", "--data-dir", d,
                               "--num-feature-dim", "8", "--num-iteration", "2",
                               "--test-interval", "0", "--obs-run-dir", run,
                               "--trace-sample", "1.0", *extra],
                              cwd=REPO, capture_output=True, text=True, timeout=300,
                              env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert proc.returncode == 0, proc.stderr
        layout[pkg] = sorted(os.listdir(run))
        assert os.listdir(os.path.join(run, "endpoints")) == []
        meta = dtrace.read_journal(os.path.join(run, "spans", "sync-0.jsonl"))[0]
        assert (meta["type"], meta["role"], meta["rank"], meta["sample"]) == (
            "meta", "sync", 0, 1.0)
        for sub in ("logs", "profiles"):
            assert os.listdir(os.path.join(run, sub)) == ["sync-0.jsonl"], (pkg, sub)
    assert layout["distlr_tpu_torch"] == layout["distlr_tpu"] == [
        "endpoints", "logs", "profiles", "spans"]


# ---------------------------------------------------------------------------
# the fleet tools read the tracing tier's series
# ---------------------------------------------------------------------------

class TestTopLatencyColumn:
    def test_route_latency_rendered(self, monkeypatch):
        from distlr_tpu.obs.top import render_fleet as jax_render_fleet
        from distlr_tpu_torch.obs.top import render_fleet

        monkeypatch.setattr(time, "time", lambda: 5000.0)  # the header's "age" reads it
        fleet = {
            "updated": time.time(), "run_dir": "/tmp/x",
            "totals": {"ranks": 1, "up": 1, "stale": 0, "down": 0, "samples_per_s": 0.0},
            "alerts": [],
            "ranks": [{"role": "route", "rank": 0, "state": "up", "route_requests": 100,
                       "route_p50_ms": 1.25, "route_p99_ms": 9.5}],
        }
        frame = render_fleet(fleet, color=False)
        assert "e2e p50/p99" in frame
        assert "1.25/9.50" in frame
        assert frame == jax_render_fleet(fleet, color=False)

    def test_fleet_json_carries_route_percentiles(self, tmp_path):
        """The port's aggregator extracts route p50/p99 from the port's
        router's latency histogram, banked as a snapshot."""
        from distlr_tpu_torch.obs import get_registry, write_metrics_snapshot
        from distlr_tpu_torch.obs.federate import FleetScraper
        from distlr_tpu_torch.serve.router import _REQ_SECONDS, _REQUESTS

        _REQUESTS.labels(listener="t:1").inc()
        for v in (0.001, 0.002, 0.01):
            _REQ_SECONDS.labels(listener="t:1").observe(v)
        run = str(tmp_path)
        os.makedirs(os.path.join(run, "snapshots"))
        write_metrics_snapshot(os.path.join(run, "snapshots", "route-0.json"), get_registry())
        scraper = FleetScraper(run)
        scraper.scrape_once()
        row = [r for r in scraper.fleet_json()["ranks"] if r["role"] == "route"][0]
        assert row["route_p50_ms"] > 0
        assert row["route_p99_ms"] >= row["route_p50_ms"]


# ---------------------------------------------------------------------------
# acceptance, end to end: one request, one label, one merged trace
# ---------------------------------------------------------------------------

CHAIN = ["route.request", "serve.request", "feedback.spool", "feedback.join",
         "online.consume", "ps.push", "kv.push"]


def _closed_loop(tmp_path, pkg: str) -> dict:
    """A routed ``ID`` request and its ``LABEL`` through one package's
    router, server, feedback sink and online trainer into an FTRL group;
    returns the merged document of the run dir."""
    if pkg == "ours":
        from distlr_tpu_torch.feedback import FeedbackSink, OnlineTrainer
        from distlr_tpu_torch.launch import main
        from distlr_tpu_torch.serve import ScoringRouter, ScoringServer
        mod, group_cls, engine = dtrace, ServerGroup, _engines()[0]
        cfg = Config(device="cpu", model="binary_lr", num_feature_dim=D, batch_size=8,
                     l2_c=0.0, sync_mode=False, ps_timeout_ms=20_000)
    else:
        from distlr_tpu.feedback import FeedbackSink, OnlineTrainer
        from distlr_tpu.launch import main
        from distlr_tpu.ps import ServerGroup as group_cls
        from distlr_tpu.serve import ScoringServer
        from distlr_tpu.serve.router import ScoringRouter
        mod, engine = jax_dtrace, _engines()[1]
        cfg = JaxConfig(model="binary_lr", num_feature_dim=D, batch_size=8, l2_c=0.0,
                        sync_mode=False, ps_timeout_ms=20_000)
    base = tmp_path / pkg
    run = str(base / "run")
    mod.configure(run, "tier", 0, sample=1.0)
    group = group_cls(1, 1, D, sync=False, optimizer="ftrl", ftrl_alpha=1.0, ftrl_beta=1.0,
                      trace_journal_dir=os.path.join(run, "spans")).start()
    sink = FeedbackSink(str(base / "spool"), str(base / "shards"), model="binary_lr",
                        window_s=30.0, shard_records=1)
    srv = ScoringServer(engine, feedback=sink).start()
    router = ScoringRouter(f"{srv.host}:{srv.port}").start()
    trainer = None
    try:
        with socket.create_connection((router.host, router.port), timeout=20.0) as s:
            f = s.makefile("rwb")

            def ask(line):
                f.write((line + "\n").encode())
                f.flush()
                return f.readline().decode().rstrip("\n")

            assert not ask("ID e2e-1 3:1 5:1").startswith("ERR")
            assert ask("LABEL e2e-1 1") == "OK joined"
        shards = str(base / "shards")
        assert os.path.exists(os.path.join(shards, "shard-000000.libsvm.trace"))
        trainer = OnlineTrainer(cfg, group.hosts, shards, accum_start=1, poll_interval_s=0.05)
        stats = trainer.run(max_shards=1, idle_exit_s=10.0)
        assert stats["shards_consumed"] == 1 and stats["pushes"] >= 1
    finally:
        if trainer is not None:
            trainer.close()
        router.stop()
        srv.stop()
        sink.stop()
        mod.flush()
        time.sleep(0.2)
        group.stop()
    out = str(base / "merged.json")
    assert main(["trace-agg", "--obs-run-dir", run, "--out", out]) == 0
    return json.load(open(out))


class TestEndToEnd:
    def test_routed_request_and_label_share_one_merged_trace(self, tmp_path):
        names = {}
        for pkg in ("ours", "jax"):
            doc = _closed_loop(tmp_path, pkg)
            assert all(e["ph"] in ("M", "X", "i") for e in doc["traceEvents"])
            spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
            tid = next(e for e in spans if e["name"] == "route.request")["args"]["trace"]
            ours = [e for e in spans if e["args"].get("trace") == tid]
            by_name = {}
            for e in ours:
                by_name.setdefault(e["name"], e)
            for name in CHAIN + ["serve.encode", "serve.score", "serve.batch", "serve.infer"]:
                assert name in by_name, f"span {name!r} missing from trace {tid} ({pkg})"
            assert by_name["route.request"]["args"]["parent"] is None
            for child, parent in zip(CHAIN[1:], CHAIN):
                assert by_name[child]["args"]["parent"] == by_name[parent]["args"]["span"], (
                    pkg, child, parent)
            assert by_name["kv.push"]["args"]["optimizer"] == "ftrl"
            assert tid in doc["otherData"]["trace_ids"]
            names[pkg] = sorted(e["name"] for e in ours)
        assert names["ours"] == names["jax"]


def test_serve_score_equal_with_and_without_tracing(tmp_path):
    """Tracing never changes the arithmetic: the replies of a session at
    sample 1 equal those of the same session unconfigured and at 0."""
    from distlr_tpu_torch.serve import ScoringRouter, ScoringServer

    rng = np.random.default_rng(5)
    lines = [" ".join(f"{c + 1}:1" for c in sorted(rng.choice(D, 4, replace=False)))
             for _ in range(20)]
    replies = []
    for sample in (None, 0.0, 1.0):
        if sample is not None:
            dtrace.configure(str(tmp_path / str(sample)), "tier", 0, sample=sample)
        srv = ScoringServer(_engines()[0]).start()
        router = ScoringRouter(f"{srv.host}:{srv.port}").start()
        try:
            replies.append([router.handle_line(line) for line in lines])
        finally:
            router.stop()
            srv.stop()
        dtrace.reset_for_tests()
    assert replies[0] == replies[1] == replies[2]
    assert not any(r.startswith("ERR") for r in replies[0])
