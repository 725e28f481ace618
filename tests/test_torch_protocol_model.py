"""The port's protocol model (executable spec, checker, mutants, CLI)
against the JAX package's, on the CPU.

* the spec's op, flag and capability identities come from the port's
  ``ps/wire.py``, and a frame it builds is real wire framing;
* every standard scenario closes clean, with JAX's ``(states,
  transitions, depth, complete, violation)``; the search is exhaustive
  and deterministic; the combined resize+fault space stays ``slow``, as
  in JAX;
* each reverted historical fix (the barrier double vote, the re-issued
  straddling push) is rediscovered in <= 12 steps as JAX's schedule,
  rendered the same, and the fixed spec closes the mutant scenarios with
  JAX's counts; the fence-ambiguity pin holds as in JAX;
* the runner wiring: the pass rides ``python -m distlr_tpu_torch.analysis``
  at JAX's budget, and the ``python -m distlr_tpu_torch.analysis.protocol``
  CLI (the port's counterpart of JAX's ``make verify-protocol`` target)
  prints the schedules and replays a run directory;
* ``namespace_layout``'s heterogeneous-dim rejection, with JAX's text.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from distlr_tpu.analysis.protocol import checker as jax_checker
from distlr_tpu.analysis.protocol import lint as jax_lint
from distlr_tpu.analysis.protocol import mutants as jax_mutants
from distlr_tpu.analysis.protocol import spec as jax_spec
from distlr_tpu.ps import namespace_layout as jax_namespace_layout
from distlr_tpu_torch.analysis.protocol import checker, conformance, mutants
from distlr_tpu_torch.analysis.protocol import spec as S
from distlr_tpu_torch.ps import namespace_layout, wire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _key(res):
    return (res.states, res.transitions, res.depth, res.complete, res.violation)


# ---------------------------------------------------------------------------
# the executable spec + checker
# ---------------------------------------------------------------------------


class TestSpecBasics:
    def test_wire_identities_come_from_the_mirror(self):
        assert S.wire is wire
        assert S.OP_NAMES[wire.OP_EPOCH] == "epoch"
        assert S.FENCE_OP == wire.OP_EPOCH
        assert S.classify_reply(wire.OP_EPOCH, wire.FLAG_RESPONSE | wire.FLAG_ERROR) == "fence"
        assert S.classify_reply(wire.OP_PUSH, wire.FLAG_RESPONSE | wire.FLAG_ERROR) == "reject"
        assert S.classify_reply(wire.OP_PUSH, wire.FLAG_RESPONSE) == "ok"
        assert S.OP_NAMES == jax_spec.OP_NAMES and S.CODEC_NAMES == jax_spec.CODEC_NAMES

    def test_frame_bytes_are_real_wire_framing(self):
        req = S.Req(wire.OP_PUSH, 0, 7, "p0.0", (1, 3), wire.CODEC_NONE)
        raw = S.frame_bytes(req)
        assert len(raw) == wire.HEADER_SIZE
        magic, op, _fl, _aux, cid, _ts, nk = wire.HEADER_STRUCT.unpack(raw)
        assert (magic, op, cid, nk) == (wire.MAGIC, wire.OP_PUSH, 7, 2)
        jreq = jax_spec.Req(wire.OP_PUSH, 0, 7, "p0.0", (1, 3), wire.CODEC_NONE)
        assert raw == jax_spec.frame_bytes(jreq)

    def test_split_ranges_cover_and_partition(self):
        for dim, n in ((4, 2), (7, 3), (5, 5)):
            rs = S.split_ranges(dim, n)
            assert rs[0][0] == 0 and rs[-1][1] == dim
            assert all(a[1] == b[0] for a, b in zip(rs, rs[1:]))
            assert rs == jax_spec.split_ranges(dim, n)


class TestInvariantsGreen:
    """Exhaustive closure of every standard scenario, zero violations,
    JAX's state counts."""

    @pytest.mark.parametrize("i", range(len(checker.STANDARD_SCENARIOS)),
                             ids=[f.__name__ for f in checker.STANDARD_SCENARIOS])
    def test_scenario_closes_clean_with_jax_counts(self, i):
        factory = checker.STANDARD_SCENARIOS[i]
        jfactory = jax_checker.STANDARD_SCENARIOS[i]
        assert factory.__name__ == jfactory.__name__
        res = checker.explore(factory(), max_states=200_000)
        assert res.violation is None, res.render()
        assert res.complete, res.render()
        assert res.states > 1000  # a trivial space would prove nothing
        assert _key(res) == _key(jax_checker.explore(jfactory(), max_states=200_000))

    def test_interleaving_search_is_exhaustive_not_sampled(self):
        a = checker.explore(checker.scenario_base(), max_states=50_000)
        b = checker.explore(checker.scenario_base(), max_states=50_000)
        assert (a.states, a.transitions, a.depth) == (b.states, b.transitions, b.depth)

    @pytest.mark.slow
    def test_full_combined_space_closes_clean(self):
        from distlr_tpu.analysis.protocol.__main__ import scenario_full as jax_scenario_full
        from distlr_tpu_torch.analysis.protocol.__main__ import scenario_full

        res = checker.explore(scenario_full(), max_states=2_000_000, max_depth=80)
        assert res.violation is None, res.render()
        assert res.complete and res.states > 100_000, res.render()
        assert _key(res) == _key(jax_checker.explore(jax_scenario_full(),
                                                     max_states=2_000_000, max_depth=80))


class TestMutants:
    """Both reverted historical fixes are rediscovered as JAX's
    counterexamples, in <= 12 steps."""

    def test_all_mutants_rediscovered(self):
        assert mutants.check_all() == []
        assert mutants.MAX_SCHEDULE_STEPS == jax_mutants.MAX_SCHEDULE_STEPS == 12
        assert [m.name for m in mutants.MUTANTS] == [m.name for m in jax_mutants.MUTANTS]

    @pytest.mark.parametrize("i", range(len(mutants.MUTANTS)),
                             ids=[m.name for m in mutants.MUTANTS])
    def test_counterexample_schedule_is_jaxs(self, i):
        mutant, jmutant = mutants.MUTANTS[i], jax_mutants.MUTANTS[i]
        res = mutants.rediscover(mutant)
        assert res.violation is not None, f"{mutant.name}: bug not rediscovered"
        msg, sched = res.violation
        assert mutant.expect == jmutant.expect and mutant.expect in msg
        assert len(sched) <= mutants.MAX_SCHEDULE_STEPS, sched
        assert any("s0: process" in step for step in sched)
        jres = jax_mutants.rediscover(jmutant)
        assert _key(res) == _key(jres)
        assert res.render() == jres.render()
        assert "counterexample" in res.render()

    def test_barrier_mutant_names_the_double_vote(self):
        msg, sched = mutants.rediscover(mutants.MUTANTS[0]).violation
        text = " | ".join(sched)
        assert "re-vote" in text and "reset" in text
        assert "unvoted" in msg

    def test_straddle_mutant_names_the_double_apply(self):
        msg, sched = mutants.rediscover(mutants.MUTANTS[1]).violation
        text = " | ".join(sched)
        assert "RE-ISSUE" in text and ("fence" in text.lower() or "retired" in text)
        assert "double-apply" in msg

    def test_fixed_spec_closes_mutant_scenarios_clean(self):
        for m, jm in zip(mutants.MUTANTS, jax_mutants.MUTANTS):
            res = checker.explore(m.scenario, S.Spec(), max_states=200_000)
            assert res.violation is None, (m.name, res.render())
            assert res.complete
            assert _key(res) == _key(jax_checker.explore(jm.scenario, jax_spec.Spec(),
                                                         max_states=200_000))


class TestFenceAmbiguityPin:
    def test_ambiguous_fence_shape_is_caught(self):
        res = checker.explore(mutants.MUTANTS[1].scenario, S.Spec(fence_uses_epoch_op=False),
                              max_states=200_000)
        assert res.violation is not None
        assert "I3" in res.violation[0]
        jres = jax_checker.explore(jax_mutants.MUTANTS[1].scenario,
                                   jax_spec.Spec(fence_uses_epoch_op=False),
                                   max_states=200_000)
        assert _key(res) == _key(jres)


# ---------------------------------------------------------------------------
# the runner and the CLI
# ---------------------------------------------------------------------------


class TestRunnerWiring:
    def test_protocol_pass_rides_the_default_runner(self):
        from distlr_tpu_torch.analysis.__main__ import PASSES, run

        assert "protocol" in PASSES
        assert run.__defaults__ == (PASSES,)

    def test_lint_budget_is_jaxs(self):
        from distlr_tpu_torch.analysis.protocol import lint

        assert lint.LINT_MAX_STATES == jax_lint.LINT_MAX_STATES == 80_000

    def test_cli_module_has_jaxs_flags(self):
        """The port's counterpart of JAX's ``make verify-protocol`` target:
        the module CLI, with every flag the target's recipe can pass."""
        proc = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.analysis.protocol",
                               "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "python -m distlr_tpu_torch.analysis.protocol" in proc.stdout
        for flag in ("--full", "--mutants", "--max-states", "--run-dir", "--chaos-events",
                     "--require-parents", "--regen-fixtures"):
            assert flag in proc.stdout

    def test_cli_replays_a_run_dir(self, tmp_path, capsys):
        """The port's counterpart of JAX's ``protocol-smoke`` target: a run
        directory's journals (``spans/`` and ``native/``) replay through
        ``--run-dir --chaos-events --require-parents``."""
        import shutil

        from distlr_tpu_torch.analysis.protocol.__main__ import main

        fixtures = conformance.fixtures_dir()
        for sub, names in (("spans", ["worker-0.jsonl"]),
                           ("native", ["kvserver-0.jsonl", "kvserver-1.jsonl"])):
            os.makedirs(tmp_path / sub)
            for name in names:
                shutil.copy(os.path.join(fixtures, name), tmp_path / sub / name)
        events = os.path.join(fixtures, "chaos_events.json")
        assert main(["--run-dir", str(tmp_path), "--chaos-events", events,
                     "--require-parents"]) == 0
        assert "conformance: clean" in capsys.readouterr().out

    def test_verify_protocol_cli_green(self, capsys):
        from distlr_tpu_torch.analysis.protocol.__main__ import main

        assert main(["--mutants"]) == 0
        out = capsys.readouterr().out
        assert "counterexample" in out
        assert "barrier-double-vote" in out and "reissue-straddling-push" in out
        assert "fixture conformance: clean" in out


# ---------------------------------------------------------------------------
# heterogeneous-dim namespace_layout rejection
# ---------------------------------------------------------------------------


class TestNamespaceLayoutHeterogeneousDims:
    def test_equal_width_still_works(self):
        assert namespace_layout("v1,v2", 16) == {"v1": (0, 16), "v2": (16, 16)}
        assert namespace_layout("v1:ftrl,v2:sgd", 8) == {"v1": (0, 8), "v2": (8, 8)}

    def test_equal_explicit_dims_accepted(self):
        assert namespace_layout("v1=16,v2=16", 16) == jax_namespace_layout("v1=16,v2=16", 16)

    @pytest.mark.parametrize("spec,dim,match", [
        ("v1=8192,v2=1024", 8192, "packed namespace_layout"),
        ({"v1": 8192, "v2": 1024}, 0, "ROADMAP"),
        ("v1=32,v2=32", 16, "heterogeneous-dim"),
        ("v1=abc", 16, "bad namespace dim"),
    ])
    def test_rejections_carry_jaxs_text(self, spec, dim, match):
        with pytest.raises(ValueError, match=match) as ours:
            namespace_layout(spec, dim)
        with pytest.raises(ValueError) as theirs:
            jax_namespace_layout(spec, dim)
        assert str(ours.value) == str(theirs.value)
