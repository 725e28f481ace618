"""Trace conformance of the port's own runs, under the port's checker and
the JAX package's, on the CPU.

* the port's banked fixtures (its own ``chaos_witness``'s artifacts, not
  JAX's files) and JAX's replay clean under both checkers;
* the port's ``chaos_witness`` and ``resize_witness``, run on its own
  native servers, chaos proxy, ``KVWorker`` and coordinator, conform
  under both with ``require_parents``;
* every seeded bad journal and event log of JAX's suite (out of order,
  wrong parent class, non-numeric field, malformed reroute epoch,
  parentless handler, one-shot reset twice, a duplicate delay offset, no
  schema header, a future schema) gives both checkers the same
  violations, message and ``file:line``;
* the chaos log's schema pin, and the run-dir scan;
* a CPU rehearsal of the card's ``protocol`` phase: ``run_ps_local``
  async with the phase's fault plan (the witness's) at sample 1.0
  conforms with ``require_parents`` under both checkers (its pipelined
  ``train.step`` spans end once their round trip is in), and the phase's
  negative control, a copy of the worker journal with two records of one
  writer swapped, is caught citing the line.
"""

from __future__ import annotations

import json
import os
import socket

import pytest

from chip_smoke import PROTOCOL_PLAN, _protocol_swap
from distlr_tpu.analysis.protocol import conformance as jax_conformance
from distlr_tpu_torch.analysis.protocol import conformance, witness
from distlr_tpu_torch.chaos import EVENT_SCHEMA, ChaosFabric, load_events_doc, parse_plan
from distlr_tpu_torch.obs import dtrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURES = os.path.join(REPO, "distlr_tpu", "analysis", "protocol", "fixtures")


def _both(journals, events=None, **kw):
    """Both checkers' rendered violations on the same artifacts."""
    ours = [v.render() for v in conformance.check_run(journals, events, **kw)]
    theirs = [v.render() for v in jax_conformance.check_run(journals, events, **kw)]
    return ours, theirs


def _fixture_files(d):
    return (sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(".jsonl")),
            os.path.join(d, "chaos_events.json"))


# ---------------------------------------------------------------------------
# the banked fixtures
# ---------------------------------------------------------------------------


class TestFixtures:
    @pytest.mark.parametrize("which", ["port", "jax"])
    def test_fixtures_replay_clean_under_both(self, which):
        d = conformance.fixtures_dir() if which == "port" else JAX_FIXTURES
        journals, events = _fixture_files(d)
        assert len(journals) == 3
        assert _both(journals, events, require_parents=True) == ([], [])

    def test_port_fixtures_are_its_own_run(self):
        d = conformance.fixtures_dir()
        assert d == os.path.join(REPO, "distlr_tpu_torch", "analysis", "protocol", "fixtures")
        assert conformance.check_fixtures() == []
        for name in ("worker-0.jsonl", "kvserver-0.jsonl", "kvserver-1.jsonl"):
            with open(os.path.join(d, name), "rb") as f, \
                    open(os.path.join(JAX_FIXTURES, name), "rb") as g:
                assert f.read() != g.read(), name
        with open(os.path.join(d, "README.md")) as f:
            readme = f.read()
        assert "distlr_tpu_torch/analysis/protocol/witness.py::chaos_witness" in readme
        assert "python -m distlr_tpu_torch.analysis.protocol --regen-fixtures" in readme


# ---------------------------------------------------------------------------
# the witnesses on the port's stack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chaos_run(tmp_path_factory):
    return witness.chaos_witness(str(tmp_path_factory.mktemp("chaosrun")))


class TestWitnesses:
    def test_chaos_witness_conforms_under_both(self, chaos_run):
        assert _both(chaos_run["journals"], chaos_run["chaos_events"],
                     require_parents=True) == ([], [])
        names = set()
        for j in chaos_run["journals"]:
            recs, errs = conformance.load_span_journal(j)
            assert errs == []
            names |= {r.name for r in recs}
        assert {"ps.push", "kv.push", "kv.pull", "train.step"} <= names
        assert sorted(os.path.basename(j) for j in chaos_run["journals"]) == [
            "kvserver-0.jsonl", "kvserver-1.jsonl", "worker-0.jsonl"]
        events, _ = conformance.load_chaos_events(chaos_run["chaos_events"])
        assert {"delay", "reset"} <= {kind for _l, kind, _d in events}

    def test_resize_witness_conforms_under_both(self, tmp_path):
        arts = witness.resize_witness(str(tmp_path))
        assert _both(arts["journals"], require_parents=True) == ([], [])
        recs, _ = conformance.load_span_journal(arts["journals"][0])
        assert "reshard.resize" in {r.name for r in recs}


# ---------------------------------------------------------------------------
# seeded bad artifacts: both checkers, the same violations
# ---------------------------------------------------------------------------


class TestSeededViolations:
    def test_out_of_order_journal(self, chaos_run, tmp_path):
        lines = open(chaos_run["journals"][0]).readlines()
        spans = [i for i, ln in enumerate(lines) if '"type": "span"' in ln]
        assert len(spans) >= 2
        lines[spans[0]], lines[spans[-1]] = lines[spans[-1]], lines[spans[0]]
        bad = tmp_path / "out-of-order.jsonl"
        bad.write_text("".join(lines))
        ours, theirs = _both([str(bad)])
        assert ours == theirs and ours
        assert ours[0].startswith(f"{bad}:") and "out of order" in ours[0]

    def test_wrong_parent_class(self, chaos_run, tmp_path):
        client = [j for j in chaos_run["journals"] if "worker" in os.path.basename(j)][0]
        crecs, _ = conformance.load_span_journal(client)
        pull_span = next(r.doc["span"] for r in crecs if r.name == "ps.pull")
        src = next(j for j in chaos_run["journals"] if "kvserver" in os.path.basename(j)
                   and any(r.name == "kv.push" for r in conformance.load_span_journal(j)[0]))
        lines = []
        for ln in open(src):
            if '"name":"kv.push"' in ln and '"parent":' in ln:
                doc = json.loads(ln)
                doc["parent"] = pull_span
                ln = json.dumps(doc) + "\n"
            lines.append(ln)
        bad = tmp_path / "wrong-parent.jsonl"
        bad.write_text("".join(lines))
        ours, theirs = _both([str(bad), client], require_parents=True)
        assert ours == theirs
        assert any("parented under 'ps.pull'" in v for v in ours), ours

    @pytest.mark.parametrize("name,body,want,kw", [
        ("non_numeric",
         '{"type": "span", "name": "x", "trace": "a", "span": "b", "ts": 0, "dur": "oops", '
         '"tid": 1}\n{"type": "instant", "name": "y", "ts": "nan?", "tid": 1}\n',
         "not numeric", {}),
        ("reroute_epoch",
         '{"type": "instant", "name": "ps.reroute", "ts": 1.0, "tid": 1, '
         '"args": {"epoch": "abc"}}\n', "aux range", {}),
        ("parentless_handler",
         '{"type": "span", "name": "kv.push", "trace": "a1", "span": "b2", "ts": 1.0, '
         '"dur": 2.0, "tid": 1, "args": {"op": "kv.push"}}\n', "no parent at all",
         {"require_parents": True}),
        ("bad_op_tag",
         '{"type": "span", "name": "kv.push", "trace": "a1", "span": "b2", "ts": 1.0, '
         '"dur": 2.0, "tid": 1, "args": {"op": "kv.frobnicate"}}\n', "not a protocol op", {}),
    ])
    def test_bad_journal(self, tmp_path, name, body, want, kw):
        p = tmp_path / f"{name}.jsonl"
        p.write_text(body)
        ours, theirs = _both([str(p)], **kw)
        assert ours == theirs
        assert ours and all(v.startswith(f"{p}:") for v in ours)
        assert any(want in v for v in ours), ours

    def test_parentless_handler_is_lenient_by_default(self, tmp_path):
        p = tmp_path / "kv.jsonl"
        p.write_text('{"type": "span", "name": "kv.push", "trace": "a1", "span": "b2", '
                     '"ts": 1.0, "dur": 2.0, "tid": 1, "args": {"op": "kv.push"}}\n')
        assert _both([str(p)]) == ([], [])

    @pytest.mark.parametrize("name,doc,want", [
        ("double_reset", {"schema": 1, "seed": 1, "truncated": False,
                          "events": [[0, "reset", {"fault": 1, "op": 4}],
                                     [0, "reset", {"fault": 1, "op": 9}]]}, "one-shot"),
        ("duplicate_delay_offset", {"schema": 1, "seed": 1, "truncated": False,
                                    "events": [[0, "delay", {"fault": 0, "ms": 3.1, "op": 4}],
                                               [0, "delay", {"fault": 0, "ms": 7.2, "op": 4}]]},
         "appears twice"),
        ("headerless", [[0, "delay", {"op": 1}]], "no schema header"),
        ("future_schema", {"schema": 99, "events": []}, "refusing to misparse"),
    ])
    def test_bad_event_log(self, tmp_path, name, doc, want):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(doc))
        ours = [v.render() for v in conformance.check_chaos_events(str(p))]
        assert ours == [v.render() for v in jax_conformance.check_chaos_events(str(p))]
        assert any(want in v for v in ours), ours

    def test_jittered_delay_log_conforms_out_of_op_order(self, tmp_path):
        p = tmp_path / "events.json"
        p.write_text(json.dumps({
            "schema": 1, "seed": 1, "truncated": False,
            "events": [[0, "delay", {"fault": 0, "ms": 3.1, "op": 9}],
                       [0, "delay", {"fault": 0, "ms": 7.2, "op": 4}]]}))
        assert conformance.check_chaos_events(str(p)) == []
        assert jax_conformance.check_chaos_events(str(p)) == []


class TestChaosLogSchema:
    def test_event_schema_cross_pinned(self):
        assert EVENT_SCHEMA == conformance.CHAOS_SCHEMA == jax_conformance.CHAOS_SCHEMA
        assert conformance.FAULT_KINDS == jax_conformance.FAULT_KINDS
        assert conformance.HANDLER_PARENTS == jax_conformance.HANDLER_PARENTS
        assert conformance.DEFAULT_SLOP_US == jax_conformance.DEFAULT_SLOP_US == 5_000

    def test_events_doc_shape(self):
        lsock = socket.socket()
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(1)
        try:
            fab = ChaosFabric([("127.0.0.1", lsock.getsockname()[1])],
                              parse_plan({"seed": 3, "faults": []}))
            try:
                doc = fab.events_doc()
            finally:
                fab.stop()
        finally:
            lsock.close()
        assert doc == {"schema": EVENT_SCHEMA, "seed": 3, "truncated": False, "events": []}

    @pytest.mark.parametrize("doc,match", [([[0, "delay", {"op": 1}]], "no schema header"),
                                           ({"schema": 99, "events": []}, "schema 99")])
    def test_loader_rejects_what_the_checker_rejects(self, tmp_path, doc, match):
        p = tmp_path / "log.json"
        p.write_text(json.dumps(doc))
        with pytest.raises(ValueError, match=match):
            load_events_doc(str(p))
        _events, vs = conformance.load_chaos_events(str(p))
        assert len(vs) == 1

    def test_run_dir_scan_includes_native_journals(self, tmp_path):
        for sub, name in (("spans", "worker-0.jsonl"), ("native", "kvserver-0.jsonl")):
            (tmp_path / sub).mkdir()
            (tmp_path / sub / name).write_text("")
        paths = conformance.run_dir_journals(str(tmp_path))
        assert paths == jax_conformance.run_dir_journals(str(tmp_path))
        assert {os.path.basename(p) for p in paths} == {"worker-0.jsonl", "kvserver-0.jsonl"}


# ---------------------------------------------------------------------------
# the card phase's run, rehearsed on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ps_chaos_run(tmp_path_factory):
    from distlr_tpu_torch.config import Config
    from distlr_tpu_torch.data.synthetic import write_synthetic_shards
    from distlr_tpu_torch.train import ps_trainer

    tmp = tmp_path_factory.mktemp("ps_chaos")
    d, run, plan = str(tmp / "d"), str(tmp / "run"), tmp / "plan.json"
    write_synthetic_shards(d, 400, 16, num_parts=2, seed=5, sparsity=0.0)
    plan.write_text(json.dumps(PROTOCOL_PLAN))
    docs = []
    real = ps_trainer.ps_server_group

    def server_group(cfg):
        group = real(cfg)
        real_stop = group.stop

        def stop():
            if group.chaos is not None:
                docs.append(group.chaos.events_doc())
            return real_stop()

        group.stop = stop
        return group

    cfg = Config(device="cpu", data_dir=d, num_feature_dim=16, num_workers=2, num_servers=2,
                 num_iteration=2, batch_size=50, test_interval=0, learning_rate=0.3,
                 sync_mode=False, chaos_plan=str(plan), ps_retry_attempts=4,
                 obs_run_dir=run, trace_sample=1.0)
    dtrace.configure(run, "ps", 0, sample=1.0)
    ps_trainer.ps_server_group = server_group
    try:
        report = {}
        weights = ps_trainer.run_ps_local(cfg, report=report)
        dtrace.flush()
    finally:
        ps_trainer.ps_server_group = real
        dtrace.reset_for_tests()
    events = str(tmp / "chaos_events.json")
    with open(events, "w") as f:
        json.dump(docs[0], f)
    return {"run": run, "events": events, "report": report, "weights": weights, "tmp": tmp}


class TestPSChaosRehearsal:
    def test_async_chaos_run_conforms_with_parents(self, ps_chaos_run):
        journals = conformance.run_dir_journals(ps_chaos_run["run"])
        assert sorted(os.path.basename(j) for j in journals) == [
            "kvserver-0.jsonl", "kvserver-1.jsonl", "ps-0.jsonl"]
        assert _both(journals, ps_chaos_run["events"], require_parents=True) == ([], [])
        events, _ = conformance.load_chaos_events(ps_chaos_run["events"])
        kinds = [kind for _l, kind, _d in events]
        assert kinds.count("reset") == 1 and kinds.count("delay") >= 1
        assert ps_chaos_run["report"]["chaos_events"]["reset"] == 1
        handlers = set()
        for j in journals:
            if "kvserver" in j:
                recs, _ = conformance.load_span_journal(j)
                if any(r.name.startswith("kv.") for r in recs):
                    handlers.add(os.path.basename(j))
        assert handlers == {"kvserver-0.jsonl", "kvserver-1.jsonl"}

    def test_pipelined_steps_hold_their_round_trips(self, ps_chaos_run):
        """Every ``ps.push_pull`` lies inside its ``train.step``: the
        pipelined step's span ends once its reply is in."""
        recs = [r for r in dtrace.read_journal(os.path.join(ps_chaos_run["run"], "spans",
                                                            "ps-0.jsonl"))
                if r.get("type") == "span"]
        steps = {r["span"]: r for r in recs if r["name"] == "train.step"}
        ops = [r for r in recs if r["name"] == "ps.push_pull"]
        assert ops and len(ops) == len(steps)
        for op in ops:
            step = steps[op["parent"]]
            assert step["ts"] <= op["ts"]
            assert op["ts"] + op["dur"] <= step["ts"] + step["dur"]

    def test_swapped_writer_lines_are_caught_with_their_line(self, ps_chaos_run):
        src = os.path.join(ps_chaos_run["run"], "spans", "ps-0.jsonl")
        bad = str(ps_chaos_run["tmp"] / "ps-0-swapped.jsonl")
        line = _protocol_swap(src, bad, conformance.DEFAULT_SLOP_US)
        ours, theirs = _both([bad])
        assert ours == theirs
        assert any(v.startswith(f"{bad}:{line}:") and "journal out of order" in v
                   for v in ours), ours
