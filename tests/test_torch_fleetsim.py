"""The port's fleetsim against the JAX package's, on the CPU.

Fleetsim drives the port's REAL control-plane classes (the autopilot
daemon and policy engine, ``serve.balance``, ``plan_reshard``, the TSDB
and SLO engine, the feedback spool and joiner) on a seeded event loop:

* the event loop: tie order, the immutable past, the fixed ``every``
  grid, a digest over the log that equals JAX's for the same lines;
* determinism and parity: every scenario's tape is line-equal to JAX's
  ``run_scenario`` at seeds 0, 1 and 7, twice over, and its seed-0 digest
  is JAX's pinned ``EXPECTED_DIGESTS`` entry; 1000 simulated workers go
  through the real joiner and spool in under 30 s;
* found bugs stay found: each of the three pre-fix bodies, patched onto
  the port's objects, rediscovers its bug at JAX's replay id with JAX's
  counterexample tape;
* integration: replay ids parse loudly, the CLI and ``launch fleetsim``
  round-trip them, the ``--history`` frames equal JAX's and scrub through
  the port's ``launch top --replay`` on the virtual clock, and the lint
  pass is registered;
* the property checks as a unit table, equal to JAX's on the same input.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time
import types

import pytest

from distlr_tpu.analysis.fleetsim import EventLoop as JaxEventLoop
from distlr_tpu.analysis.fleetsim import mutants as jax_mutants
from distlr_tpu.analysis.fleetsim import props as jax_props
from distlr_tpu.analysis.fleetsim.__main__ import main as jax_fleetsim_main
from distlr_tpu.analysis.fleetsim.scenarios import SCENARIOS as JAX_SCENARIOS
from distlr_tpu.analysis.fleetsim.scenarios import run_scenario as jax_run_scenario
from distlr_tpu_torch.analysis.fleetsim import EventLoop, props
from distlr_tpu_torch.analysis.fleetsim.__main__ import main as fleetsim_main
from distlr_tpu_torch.analysis.fleetsim.mutants import EXPECTED_DIGESTS, MUTANTS, verify_mutant
from distlr_tpu_torch.analysis.fleetsim.scenarios import (
    SCENARIOS,
    parse_replay_id,
    run_scenario,
)
from distlr_tpu_torch.ps.server import plan_reshard
from distlr_tpu_torch.traffic import ZipfSampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(autouse=True)
def _quiet():
    import logging

    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


# ---------------------------------------------------------------------------
# the event loop
# ---------------------------------------------------------------------------


class TestEventLoop:
    def test_ties_break_on_insertion_order(self):
        loop = EventLoop(0)
        seen: list[str] = []
        loop.at(1.0, lambda: seen.append("first"))
        loop.at(1.0, lambda: seen.append("second"))
        loop.at(0.5, lambda: seen.append("early"))
        loop.run(2.0)
        assert seen == ["early", "first", "second"]
        assert loop.now == 2.0

    def test_the_past_is_immutable(self):
        loop = EventLoop(0)
        loop.run(5.0)
        fired_at: list[float] = []
        loop.at(1.0, lambda: fired_at.append(loop.now))
        loop.run(10.0)
        assert fired_at == [5.0]

    def test_every_is_a_fixed_grid(self):
        loop = EventLoop(0)
        ticks: list[float] = []
        loop.every(2.0, lambda: ticks.append(loop.now), until=7.0)
        loop.run(7.0)
        assert ticks == [2.0, 4.0, 6.0]

    def test_digest_covers_the_log_as_jaxs(self):
        a, b, j = EventLoop(0), EventLoop(0), JaxEventLoop(0)
        for lp in (a, b, j):
            lp.log("x", v=1.5, who="r0", ok=True)
            lp.log("y", vals=[1, 2.25], nested={"k": None})
        assert a.digest() == b.digest() == j.digest()
        assert a.lines == j.lines
        b.log("x", v=1.6)
        assert a.digest() != b.digest()


# ---------------------------------------------------------------------------
# determinism, parity with JAX's tapes, scale
# ---------------------------------------------------------------------------


class TestScenarios:
    def test_registry_is_jaxs(self):
        assert list(SCENARIOS) == list(JAX_SCENARIOS)
        assert EXPECTED_DIGESTS == jax_mutants.EXPECTED_DIGESTS

    @pytest.mark.parametrize("name", sorted(SCENARIOS))
    def test_clean_deterministic_pinned_and_jaxs(self, name):
        a = run_scenario(name, 0)
        b = run_scenario(name, 0)
        assert a.violations == [], a.violations
        assert a.lines == b.lines and a.digest == b.digest
        assert a.digest == EXPECTED_DIGESTS[name], (
            f"{name}: digest {a.digest} != JAX's pinned digest")
        j = jax_run_scenario(name, 0)
        assert a.lines == j.lines
        assert (a.summary, a.replay_id, a.events) == (j.summary, j.replay_id, j.events)

    @pytest.mark.parametrize("seed", [1, 7])
    @pytest.mark.parametrize("name", sorted(SCENARIOS))
    def test_tape_is_jaxs_at_other_seeds(self, name, seed):
        ours, theirs = run_scenario(name, seed), jax_run_scenario(name, seed)
        assert ours.lines == theirs.lines
        assert ours.digest == theirs.digest and ours.violations == theirs.violations == []

    def test_seed_changes_the_tape(self):
        assert (run_scenario("partition_heal_1000", 0).digest
                != run_scenario("partition_heal_1000", 7).digest)

    def test_thousand_workers_in_seconds(self):
        t0 = time.monotonic()
        res = run_scenario("partition_heal_1000", 0)
        wall = time.monotonic() - t0
        assert res.summary["workers_joined"] == 1000
        assert res.summary["rejoin_events"] == 1000
        assert res.violations == []
        assert wall < 30.0, f"1000-worker scenario took {wall:.1f}s"

    def test_summary_and_verdict_are_inside_the_digest(self):
        res = run_scenario("cascade_eject_canary", 0)
        assert any(line.split(" ", 2)[1] == "summary" for line in res.lines)
        assert any(line.split(" ", 2)[1] == "verdict" for line in res.lines)


# ---------------------------------------------------------------------------
# the three found-by-fleetsim bugs, pinned as mutants
# ---------------------------------------------------------------------------


class TestMutants:
    @pytest.mark.parametrize("name", sorted(MUTANTS))
    def test_fix_reverted_is_rediscovered_as_jaxs(self, name):
        assert verify_mutant(name) == []
        m, jm = MUTANTS[name], jax_mutants.MUTANTS[name]
        assert (m.replay_id, m.expect_in_violation, m.historical) == (
            jm.replay_id, jm.expect_in_violation, jm.historical)
        cex, jcex = m.rediscover(), jm.rediscover()
        assert cex.lines == jcex.lines and cex.violations == jcex.violations

    def test_mutants_patch_the_ports_objects(self):
        from distlr_tpu_torch.autopilot.policy import PolicyEngine
        from distlr_tpu_torch.serve import balance

        targets = {name: m.target for name, m in MUTANTS.items()}
        assert targets == {"router_eject_unbounded": (balance, "may_eject"),
                           "autopilot_alert_freeze": (PolicyEngine, "_on_alert"),
                           "autopilot_no_flap_damping": (PolicyEngine, "_act")}
        orig = balance.may_eject
        with MUTANTS["router_eject_unbounded"].applied():
            assert balance.may_eject is not orig
        assert balance.may_eject is orig

    def test_mutants_cover_three_distinct_policies(self):
        seams = {m.target[0] if isinstance(m.target[0], types.ModuleType)
                 else m.target[1] for m in MUTANTS.values()}
        assert len(MUTANTS) >= 3
        assert len(seams) == len(MUTANTS)
        assert len({m.scenario for m in MUTANTS.values()}) == len(MUTANTS)


# ---------------------------------------------------------------------------
# replay ids, the CLI, launch fleetsim and top
# ---------------------------------------------------------------------------


class TestReplay:
    def test_replay_id_round_trip(self):
        res = run_scenario("autopilot_resonance", 3)
        assert res.replay_id == "fleetsim:autopilot_resonance:3"
        assert parse_replay_id(res.replay_id) == ("autopilot_resonance", 3)

    @pytest.mark.parametrize("bad", ["autopilot_resonance:0", "fleetsim:no_such_scenario:0",
                                     "fleetsim:autopilot_resonance:zero", "schedule:thing"])
    def test_bad_replay_ids_are_loud(self, bad):
        with pytest.raises(ValueError, match="replay id|fleetsim"):
            parse_replay_id(bad)

    def test_cli_replays_a_pinned_id(self, capsys):
        rc = fleetsim_main(["--replay", "fleetsim:cascade_eject_canary:0", "--json"])
        doc = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert doc["violations"] == []
        assert doc["digest"] == EXPECTED_DIGESTS["cascade_eject_canary"]

    def test_cli_rejects_garbage(self, capsys):
        assert fleetsim_main(["--replay", "fleetsim:nope:0"]) == 2
        assert fleetsim_main(["--scenario", "nope"]) == 2
        assert fleetsim_main(["--history", "/tmp/x.jsonl"]) == 2
        capsys.readouterr()

    def test_history_frames_are_jaxs_and_scrub_in_top(self, tmp_path, capsys):
        from distlr_tpu_torch.obs.top import run_top_replay

        ours, theirs = str(tmp_path / "ours.jsonl"), str(tmp_path / "jax.jsonl")
        assert fleetsim_main(["--scenario", "slow_burn_slo", "--history", ours]) == 0
        assert jax_fleetsim_main(["--scenario", "slow_burn_slo", "--history", theirs]) == 0
        capsys.readouterr()
        with open(ours) as f, open(theirs) as g:
            assert f.read() == g.read()
        out = io.StringIO()
        assert run_top_replay(ours, color=False, out=out) == 0
        text = out.getvalue()
        assert "(virtual clock)" in text
        assert "fleetsim:slow_burn_slo" in text
        assert "replayed" in text

    def test_launch_fleetsim_json_and_list(self):
        """``launch fleetsim`` in a fresh interpreter: one JSON document per
        scenario at JAX's digests, every mutant rediscovered, and
        ``--list`` naming the three mutants."""
        cmd = [sys.executable, "-m", "distlr_tpu_torch.launch", "fleetsim"]
        proc = subprocess.run(cmd + ["--json"], cwd=REPO, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        docs = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
        assert {d["scenario"]: d["digest"] for d in docs} == EXPECTED_DIGESTS
        assert all(d["violations"] == [] for d in docs)
        for name, m in MUTANTS.items():
            assert f"mutant:{name}: rediscovered and replayable at {m.replay_id}" in proc.stdout
        listed = subprocess.run(cmd + ["--list"], cwd=REPO, capture_output=True, text=True,
                                timeout=300)
        assert listed.returncode == 0
        assert sorted(line.split(":")[1] for line in listed.stdout.splitlines()
                      if line.startswith("mutant:")) == sorted(MUTANTS)

    def test_lint_pass_is_registered(self):
        from distlr_tpu_torch.analysis.__main__ import PASSES, run_pass

        assert "fleetsim" in PASSES
        assert run_pass("fleetsim") == []


# ---------------------------------------------------------------------------
# property checks as a unit table
# ---------------------------------------------------------------------------


def _stub_fleet(**kw):
    ns = types.SimpleNamespace(**kw)
    if hasattr(ns, "_actions"):
        ns.actions = lambda: ns._actions
    return ns


def _action(actuator, direction):
    return {"action": {"actuator": actuator, "direction": direction}}


class TestProps:
    def test_no_flapping_counts_reversals(self):
        fleet = _stub_fleet(_actions=[_action("engine", "up"), _action("engine", "down"),
                                      _action("engine", "up"), _action("ps", "down")])
        assert props.no_flapping(fleet, actuator="engine", max_reversals=2) == []
        out = props.no_flapping(fleet, actuator="engine", max_reversals=1)
        assert out and "reversed direction 2x" in out[0]
        assert out == jax_props.no_flapping(fleet, actuator="engine", max_reversals=1)

    def test_zero_failed_accepted_honors_the_fault_window(self):
        fleet = _stub_fleet(router=types.SimpleNamespace(error_ticks=[(10.0, 5.0),
                                                                      (20.0, 3.0)]))
        assert props.zero_failed_accepted(fleet, allowed_until=20.0) == []
        out = props.zero_failed_accepted(fleet, allowed_until=15.0)
        assert out and "3.0 requests failed" in out[0]
        assert out == jax_props.zero_failed_accepted(fleet, allowed_until=15.0)

    def test_reshard_converged_accepts_the_real_planner(self):
        dim = 1 << 12
        old = [(i * (dim // 64), (i + 1) * (dim // 64)) for i in range(64)]
        plan = plan_reshard(dim, old, 96, alive=[True] * 64)
        z = ZipfSampler(dim, 1.05)
        assert props.reshard_converged(plan, dim, old, sampler=z, max_hot_share=1.0) == []

    def test_reshard_converged_catches_a_corrupt_plan(self):
        dim = 1 << 12
        old = [(i * (dim // 64), (i + 1) * (dim // 64)) for i in range(64)]
        plan = plan_reshard(dim, old, 96, alive=[True] * 64)
        bad = types.SimpleNamespace(moves=list(plan.moves)[:-1], new_ranges=plan.new_ranges,
                                    reuse=plan.reuse)
        out = props.reshard_converged(bad, dim, old)
        assert out and any("covered to" in v or "gap" in v for v in out)
        assert out == jax_props.reshard_converged(bad, dim, old)

    def test_slo_budget_held_requires_summaries(self):
        assert props.slo_budget_held(_stub_fleet(slo_summaries=[]))
        assert props.slo_budget_held(_stub_fleet(slo_summaries=[
            {"name": "x", "budget_remaining": 0.4}])) == []
        fleet = _stub_fleet(slo_summaries=[{"name": "x", "budget_remaining": -0.2}])
        out = props.slo_budget_held(fleet)
        assert out and "exhausted" in out[0]
        assert out == jax_props.slo_budget_held(fleet)
