"""The port's serving policy pieces against the JAX package's, on the CPU:
``serve/balance.py``, ``serve/tenant.py`` and ``serve/rollout.py``.

The same seeded inputs go to both packages' functions and objects, and
every result is held equal: replica fields after every step of a seeded
note / eject / probe sequence, parsed specs and the texts of their
``ValueError`` s, quota admissions at injected clocks, extracted scores
and PSI bit for bit, the shadow mirror's PSI, stage and attribution
tables, the alert lists of both fleet pollers against one stub
``/fleet.json``, and the admin lines and journal events (timestamps
dropped) of both rollout controllers over one scripted router.
"""

import http.server
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from distlr_tpu.feedback.drift import psi as jax_psi
from distlr_tpu.serve import balance as jax_balance
from distlr_tpu.serve import rollout as jax_rollout
from distlr_tpu.serve import tenant as jax_tenant
from distlr_tpu_torch.serve import balance, rollout, tenant

FIELDS = dict(healthy=True, consecutive_errors=0, inflight=0, errors=0, requests=0,
              ejections=0, reinstates=0, backoff_s=0.0, next_probe_at=0.0, last_ok=0.0,
              last_probe=0.0)


def _replicas(n):
    return [SimpleNamespace(name=i, **FIELDS) for i in range(n)]


class TestBalance:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_seeded_sequence_keeps_every_field_equal(self, seed):
        """A seeded sequence of notes, ejects, probes and orderings applied
        to two replicas through each package's functions: every field and
        every return value equal after every step."""
        rng = np.random.default_rng(seed)
        reps = {balance: _replicas(2), jax_balance: _replicas(2)}
        rr = dict.fromkeys(reps, 0)
        now = 100.0
        kw = dict(probe_backoff_s=0.5, probe_backoff_max_s=4.0, eject_after=2)
        for _ in range(200):
            now += float(rng.uniform(0.0, 1.5))
            op, i = int(rng.integers(0, 5)), int(rng.integers(0, 2))
            ok, inflight = bool(rng.integers(0, 2)), int(rng.integers(0, 3))
            got = []
            for mod, pool in reps.items():
                rep = pool[i]
                pool[1 - i].inflight = inflight
                if op == 0:
                    got.append(mod.note_success(rep, now))
                elif op == 1:
                    mod.note_failure(rep)
                    verdict = mod.eject_verdict(rep, [pool], kw["eject_after"])
                    if verdict == "eject":
                        mod.eject(rep, now, kw["probe_backoff_s"])
                    got.append((verdict, mod.may_eject(rep, [pool])))
                elif op == 2:
                    got.append(mod.probe_result(rep, ok, now, pools=[pool], **kw))
                elif op == 3:
                    got.append(mod.probe_due(rep, now, 1.0, kw["probe_backoff_s"]))
                else:
                    ordered, rr[mod] = mod.order_candidates([r for r in pool if r.healthy],
                                                            rr[mod])
                    got.append([r.name for r in ordered])
            assert got[0] == got[1], (op, got)
            assert rr[balance] == rr[jax_balance]
            for a, b in zip(reps[balance], reps[jax_balance]):
                assert vars(a) == vars(b)

    def test_floor_keeps_the_last_healthy_replica(self):
        for mod in (balance, jax_balance):
            a, b = _replicas(2)
            b.healthy = False
            a.consecutive_errors = 5
            assert mod.eject_verdict(a, [[a, b]], 3) == "floor"
            assert mod.eject_verdict(a, [[a]], 3) == "eject"  # a pool of one is exempt


MODEL_SPECS = [
    "h:1,h:2", " h:1 , ,h:2 ", "v1=h:1+h:2,v2=h:3", "v1=h:1, v2 = h:2 + h:3 ,",
    {"a": ["h:1"], "b": ("h:2", "h:3")}, ["h:1", " h:2 "], ("h:1",),
    "v1=h:1,v1=h:2", "=h:1", "v1", "v1=", "v1=h:1+h:1", "bad id=h:1", "a@b=h:1", "",
    [], {"v1": []}, "h:1,h:1",
]
QUOTA_SPECS = [
    None, "", "v1=100", "v1=100:200,v2=0.5:1", " v1 = 3 : 4 ,", {"v1": (2.0, 3.0)},
    "v1", "=3", "v1=x", "v1=3:y", "v1=0", "v1=1:0.5", "v1=1,v1=2", "v1=-1",
]


def _outcome(fn, spec):
    try:
        return "ok", fn(spec)
    except ValueError as e:
        return "ValueError", str(e)


class TestTenant:
    @pytest.mark.parametrize("spec", MODEL_SPECS, ids=[repr(s) for s in MODEL_SPECS])
    def test_parse_model_spec_matches_jax(self, spec):
        assert _outcome(tenant.parse_model_spec, spec) == _outcome(
            jax_tenant.parse_model_spec, spec)

    @pytest.mark.parametrize("spec", QUOTA_SPECS, ids=[repr(s) for s in QUOTA_SPECS])
    def test_parse_quota_spec_matches_jax(self, spec):
        def quotas(mod):
            kind, out = _outcome(mod.parse_quota_spec, spec)
            return kind, out if kind != "ok" else {m: q.stats() for m, q in out.items()}

        assert quotas(tenant) == quotas(jax_tenant)

    def test_quota_admits_the_same_sequence(self):
        rng = np.random.default_rng(4)
        ours, theirs = tenant.TenantQuota(3.0, 5.0), jax_tenant.TenantQuota(3.0, 5.0)
        t = 1000.0
        for _ in range(300):
            # a clock that sometimes steps back: the bucket must never drain
            t += float(rng.choice([0.0, 0.05, 0.3, -0.2, 1.0]))
            n = float(rng.choice([1.0, 2.0]))
            assert ours.try_admit(n, now=t) == theirs.try_admit(n, now=t)
            assert ours.stats() == theirs.stats()
        assert ours.admitted > 0 and ours.shed > 0

    def test_quota_validation_matches_jax(self):
        for args in ((0.0,), (1.0, 0.5), (-2.0, 4.0)):
            with pytest.raises(ValueError) as a:
                tenant.TenantQuota(*args)
            with pytest.raises(ValueError) as b:
                jax_tenant.TenantQuota(*args)
            assert str(a.value) == str(b.value)

    @pytest.mark.parametrize("reply", [
        "1 0.731059", "0 1e-05", " 1 0.5 ", "ERR ValueError: x", "", "1", "1 2 3", "1 x",
        '{"labels": [1, 0], "scores": [0.7, 0.2]}', '{"scores": []}', '{"scores": ["a"]}',
        '{"labels": [1]}', "{bad json", '{"scores": null}',
    ])
    def test_extract_scores_matches_jax(self, reply):
        assert tenant.extract_scores(reply) == jax_tenant.extract_scores(reply)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_psi_same_bits(self, seed):
        rng = np.random.default_rng(seed)
        p, q = rng.integers(0, 50, 10), rng.integers(0, 50, 10)
        assert tenant.psi(p, q) == jax_psi(p, q)
        for bad in ((p, q[:5]), (np.zeros(10), q)):
            with pytest.raises(ValueError) as a:
                tenant.psi(*bad)
            with pytest.raises(ValueError) as b:
                jax_psi(*bad)
            assert str(a.value) == str(b.value)

    def test_shadow_mirror_gives_the_same_psi(self):
        """Both mirrors over one deterministic candidate (its score a
        function of the line): the same pairs, blocks, PSI and counters."""
        rng = np.random.default_rng(6)
        lines = [f"{i}:1" for i in range(1, 400)]
        primary = {ln: [float(s)] for ln, s in zip(lines, rng.uniform(0, 1, len(lines)))}

        def exchange(model, line):
            if line.endswith("7:1"):
                raise ConnectionError("candidate down")
            return f"1 {min(0.999, primary[line][0] * 0.6 + 0.3):.6g}"

        stats = []
        for mod in (tenant, jax_tenant):
            m = mod.ShadowMirror(exchange, queue_max=1024, block=64, bins=8)
            try:
                for ln in lines:
                    assert m.submit("v1", "v2", ln, primary[ln])
                m.drain(10.0)
            finally:
                m.stop()
            # read after stop(), which joins the mirror thread: the JAX
            # package's drain() counts a mirror before its pair observes it
            stats.append((m.stats(), m.psi("v1", "v2"), m.psi("v1", "v9")))
            assert not m.submit("v1", "v2", lines[0], [0.5])  # stopped: dropped
        assert stats[0] == stats[1]
        assert stats[0][1] is not None and stats[0][1] > 0
        assert stats[0][0]["errors"] == sum(ln.endswith("7:1") for ln in lines)

    def test_shadow_mirror_drain_waits_for_the_last_observe(self, monkeypatch):
        """With each pair's observe slowed, the port's stats() right
        after drain() already holds every pair: drain() returns only once
        the last mirror was observed, not only counted."""
        real = tenant._ShadowPair.observe

        def slow_observe(self, primary, cand):
            time.sleep(0.02)
            return real(self, primary, cand)

        monkeypatch.setattr(tenant._ShadowPair, "observe", slow_observe)
        m = tenant.ShadowMirror(lambda model, line: "1 0.5", queue_max=64, block=2, bins=4)
        try:
            for i in range(5):
                assert m.submit("v1", "v2", f"{i}:1", [0.25 + 0.1 * i])
            m.drain(10.0)
            after_drain = m.stats()
        finally:
            m.stop()
        assert after_drain == m.stats()
        assert after_drain["mirrored"] == 5
        assert after_drain["pairs"]["v1->v2"]["pairs"] + 2 * after_drain["pairs"]["v1->v2"][
            "blocks"] == 5

    def test_shadow_mirror_validation_matches_jax(self):
        for kw in ({"queue_max": 0}, {"block": 0}, {"bins": 1}):
            with pytest.raises(ValueError) as a:
                tenant.ShadowMirror(lambda m, ln: "", **kw)
            with pytest.raises(ValueError) as b:
                jax_tenant.ShadowMirror(lambda m, ln: "", **kw)
            assert str(a.value) == str(b.value)


STAGE_SPECS = [
    "0.05:10,0.25:10,1.0:30", "1.0", " 0.5 : 0 , 1.0:2 ", "0.5:1,1.0", "", ",", "0.5:1",
    "0.5,0.25,1.0", "0:1,1.0", "1.5", "0.5:x", "x:1", "0.5:-1,1.0", "0.5,0.5,1.0",
]
ALERTS = [
    {"name": "distlr_alert_x", "labels": {"candidate": "v2"}},
    {"name": "distlr_alert_x", "labels": {"model": "v1", "tenant": "v2"}},
    {"name": "distlr_alert_x", "labels": {"namespace": 2}},
    {"name": "distlr_alert_x", "labels": {"slo": "avail"}},
    {"name": "distlr_alert_x"},
    {"name": "distlr_alert_x", "labels": None},
]


class TestRolloutPieces:
    @pytest.mark.parametrize("spec", STAGE_SPECS)
    def test_parse_stages_matches_jax(self, spec):
        assert _outcome(rollout.parse_stages, spec) == _outcome(jax_rollout.parse_stages, spec)

    def test_attributable_matches_jax(self):
        assert rollout.ATTRIBUTION_KEYS == jax_rollout.ATTRIBUTION_KEYS
        for alert in ALERTS:
            for model in ("v1", "v2", "2", 2):
                assert (rollout.attributable(alert, model)
                        == jax_rollout.attributable(alert, model)), (alert, model)

    def test_fleet_pollers_fire_the_same_lists(self):
        """Both pollers against one stub ``/fleet.json`` (and, once it is
        gone, the unreachable alert), for each binding and scope."""
        doc = {"alerts": [
            {"name": "distlr_alert_drift", "firing": True,
             "labels": {"candidate": "v2", "threshold": 0.2}},
            {"name": "distlr_alert_drift", "firing": True, "labels": {"model": "v1"}},
            {"name": "distlr_alert_slo_burn", "firing": True,
             "labels": {"slo": "avail", "window": "fast", "candidate": "v2"}},
            {"name": "distlr_alert_latency", "firing": False, "labels": {"candidate": "v2"}},
            {"name": "other_gauge", "firing": True},
            {"name": "distlr_alert_fleet", "firing": True},
        ]}

        class Fleet(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = json.dumps(doc).encode() if self.path == "/fleet.json" else b"{"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Fleet)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        cases = [{}, {"names": ["distlr_alert_drift"]}, {"scope_model": "v2"},
                 {"scope_model": "v1"}, {"scope_slo": "avail"},
                 {"scope_model": "v2", "scope_slo": "avail"}, {"prefix": "other"}]
        try:
            for kw in cases:
                got = rollout.fleet_alert_poller(url + "/", **kw)()
                assert got == jax_rollout.fleet_alert_poller(url + "/", **kw)(), kw
            assert rollout.fleet_alert_poller(url)() != []
        finally:
            srv.shutdown()
            srv.server_close()
        for kw in cases[:2]:
            assert (rollout.fleet_alert_poller(url, timeout_s=0.5, **kw)()
                    == jax_rollout.fleet_alert_poller(url, timeout_s=0.5, **kw)()
                    == ["rollout_fleet_unreachable"])


class _ScriptedRouter:
    """A stand-in for ``RouterAdmin``: records every admin line and
    answers from a script (a refused verb answers ``ERR``)."""

    def __init__(self, hosted, refuse=()):
        self.hosted = hosted
        self.refuse = set(refuse)
        self.lines: list[str] = []

    def models(self):
        return {"models": self.hosted}

    def send(self, line):
        self.lines.append(line)
        return f"ERR {line.split()[0]}: refused" if line in self.refuse else f"OK {line}"

    def expect_ok(self, line):
        reply = self.send(line)
        if not reply.startswith("OK"):
            raise RuntimeError(f"router refused {line.split()[0]}: {reply}")
        return reply


class TestRolloutController:
    HOSTED = {"v1": {"replicas": ["h:1"], "up": 1}, "v2": {"replicas": ["h:2"], "up": 1}}

    @pytest.mark.parametrize("case", ["promoted", "rolled_back", "aborted", "shadow_promoted",
                                      "admin_failure", "no_candidate", "poller_raises"])
    def test_both_controllers_send_and_journal_the_same(self, case, tmp_path):
        hosted, refuse, fire_at, shadow = self.HOSTED, (), None, 0.0
        if case == "rolled_back":
            fire_at = 3      # the pre-ramp check, stage 0's hold, then stage 1's
        elif case == "aborted":
            fire_at = 1
        elif case == "shadow_promoted":
            shadow = 0.25
        elif case == "admin_failure":
            refuse = ("SPLIT v1 v2 1",)
        elif case == "no_candidate":
            hosted = {"v1": self.HOSTED["v1"], "v2": {"replicas": ["h:2"], "up": 0}}
        runs = []
        for mod, name in ((rollout, "ours"), (jax_rollout, "theirs")):
            admin = _ScriptedRouter(hosted, refuse)
            calls = {"n": 0}

            def poll():
                calls["n"] += 1
                if case == "poller_raises" and calls["n"] == 2:
                    raise KeyError("boom")
                return ["distlr_alert_x{candidate=v2}"] if fire_at and calls["n"] >= fire_at \
                    else []

            ctrl = mod.RolloutController(admin, "v1", "v2", "0.25:0,0.5:0,1.0:0",
                                         alert_poll=poll, poll_interval_s=0.0,
                                         shadow_fraction=shadow, settle_s=0.0,
                                         journal_dir=str(tmp_path / name))
            out = ctrl.run()
            with open(ctrl.journal_path) as f:
                events = [{k: v for k, v in json.loads(ln).items() if k != "t"} for ln in f]
            out = {k: v for k, v in out.items() if k not in ("journal", "transitions")}
            runs.append((out, admin.lines, events, calls["n"]))
        assert runs[0] == runs[1]
        want = {"promoted": "promoted", "shadow_promoted": "promoted", "aborted": "aborted",
                "no_candidate": "aborted"}.get(case, "rolled_back")
        assert runs[0][0]["outcome"] == want

    def test_unwatched_ramp_and_journal_numbering(self, tmp_path):
        admin = _ScriptedRouter(self.HOSTED)
        for seq in range(2):
            ctrl = rollout.RolloutController(admin, "v1", "v2", [(1.0, 0.0)],
                                             journal_dir=str(tmp_path))
            assert ctrl.run()["outcome"] == "promoted"
            assert ctrl.journal_path.endswith(f"ramp-{seq:04d}.jsonl")
        assert admin.lines == ["SPLIT v1 v2 1", "PROMOTE v1 v2"] * 2
        with pytest.raises(ValueError, match="at least one stage"):
            rollout.RolloutController(admin, "v1", "v2", [])
