"""JAX's twelve schedcheck scenarios and two mutants on the port's real
classes, on the CPU.

* every scenario closes clean at the fast tier (bounded DFS plus the
  lint pass's fuzz seeds, exactly what the runner's ``sched`` pass runs)
  in well under its 60 s budget, with JAX's name and JAX's ``classes``
  re-prefixed, and every class it names is in the port's lint registry;
* each mutant (the joiner's check-then-insert race, the ChaosLink
  teardown race) is rediscovered on the port's method bodies within
  JAX's bounds, as the same schedule and the same counterexample text
  JAX's gives, ≤ 20 steps, naming its bug, replaying byte-identically;
* the shadow-mirror mid-batch shed regression against the port's
  pre-fix ``ShadowMirror._run``;
* the concurrency baseline's cross-reference to the scenario registry.
"""

from __future__ import annotations

import time

import pytest

from distlr_tpu.analysis.schedcheck import mutants as jax_mutants
from distlr_tpu.analysis.schedcheck import scenarios as jax_scenarios
from distlr_tpu_torch.analysis import baseline
from distlr_tpu_torch.analysis.schedcheck import explore, lint, mutants, scenarios

# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


class TestScenarios:
    @pytest.mark.parametrize("name", sorted(scenarios.SCENARIOS))
    def test_fast_tier_closes_clean(self, name):
        s = scenarios.SCENARIOS[name]
        t0 = time.monotonic()
        findings = lint.check_scenario(s)
        wall = time.monotonic() - t0
        assert findings == [], "\n".join(f.render() for f in findings)
        assert wall < 60.0, f"{name}: fast tier took {wall:.1f}s"

    def test_registry_is_jaxs_on_the_ports_classes(self):
        assert list(scenarios.SCENARIOS) == list(jax_scenarios.SCENARIOS)
        for name, s in scenarios.SCENARIOS.items():
            j = jax_scenarios.SCENARIOS[name]
            assert s.classes == tuple(c.replace("distlr_tpu/", "distlr_tpu_torch/")
                                      for c in j.classes)
            assert (s.dfs_bound, s.dfs_runs, s.deep_bound, s.deep_runs, s.fuzz_seeds,
                    s.max_steps) == (j.dfs_bound, j.dfs_runs, j.deep_bound, j.deep_runs,
                                     j.fuzz_seeds, j.max_steps)
        assert lint.LINT_FUZZ_SEEDS == 5

    def test_every_scenario_class_is_in_the_lint_registry(self):
        reg = scenarios._lint_registry()
        for s in scenarios.SCENARIOS.values():
            for label in s.classes:
                module, _, cls = label.partition(":")
                assert (module, cls) in reg, (s.name, label)
                assert reg[(module, cls)].lock_attrs, (s.name, label)


# ---------------------------------------------------------------------------
# mutants
# ---------------------------------------------------------------------------


class TestMutants:
    def test_bounds_are_jaxs(self):
        assert mutants.MAX_SCHEDULE_STEPS == jax_mutants.MAX_SCHEDULE_STEPS == 20
        assert list(mutants.MUTANTS) == list(jax_mutants.MUTANTS)
        for name, m in mutants.MUTANTS.items():
            j = jax_mutants.MUTANTS[name]
            assert m.target == j.target.replace("distlr_tpu.", "distlr_tpu_torch.")
            assert (m.dfs_runs, m.max_steps, m.expect_in_message) == \
                (j.dfs_runs, j.max_steps, j.expect_in_message)

    @pytest.mark.parametrize("name", sorted(mutants.MUTANTS))
    def test_mutant_rediscovers_bounded_and_replayable(self, name):
        with lint.quiet_logs():
            problems = mutants.verify_mutant(name)
        assert problems == [], "\n".join(problems)

    @pytest.mark.parametrize("name", sorted(mutants.MUTANTS))
    def test_counterexample_equals_jaxs_and_names_the_bug(self, name):
        m = mutants.MUTANTS[name]
        with lint.quiet_logs():
            cex = m.rediscover()
            jcex = jax_mutants.MUTANTS[name].rediscover()
        assert cex is not None, f"{name} not rediscovered"
        assert len(cex.decisions) <= mutants.MAX_SCHEDULE_STEPS
        assert m.expect_in_message in cex.failure.message
        assert cex.schedule_id == jcex.schedule_id
        assert cex.render_failure() == jcex.render_failure()
        choices = [d.chosen for d in cex.decisions]
        with lint.quiet_logs():
            r1, r2 = m.replay(choices), m.replay(choices)
        assert r1.render_failure() == r2.render_failure() == cex.render_failure()


# ---------------------------------------------------------------------------
# the shadow mirror's mid-batch shed
# ---------------------------------------------------------------------------


def _prefix_shadow_run(self) -> None:
    """The port's ``ShadowMirror._run`` with the shed accounting reverted:
    a stop() landing mid-batch abandons the dequeued mirrors uncounted."""
    from distlr_tpu_torch.serve.tenant import _SHADOW_TOTAL, _ShadowPair, extract_scores
    while not self._stop.is_set():
        with self._lock:
            batch, self._queue = self._queue, []
        if not batch:
            self._wake.wait(0.05)
            self._wake.clear()
            continue
        for tenant, candidate, line, primary in batch:
            if self._stop.is_set():
                return
            try:
                reply = self._exchange(candidate, line)
            except Exception:  # noqa: BLE001
                reply = None
            cand = extract_scores(reply) if reply is not None else None
            if cand is None:
                with self._lock:
                    self.errors += 1
                _SHADOW_TOTAL.labels(tenant=tenant, candidate=candidate, outcome="error").inc()
                continue
            with self._lock:
                pair = self._pairs.get((tenant, candidate))
                if pair is None:
                    pair = self._pairs[(tenant, candidate)] = _ShadowPair(
                        tenant, candidate, block=self.block, bins=self.bins)
            pair.observe(primary, cand)
            with self._lock:
                self.mirrored += 1
            _SHADOW_TOTAL.labels(tenant=tenant, candidate=candidate, outcome="scored").inc()


class TestShadowMirrorShedRegression:
    def _mutant(self):
        return mutants.Mutant(
            name="shadow_mid_batch_shed",
            historical="the shadow mirror's mid-batch shed accounting",
            target="distlr_tpu_torch.serve.tenant:ShadowMirror._run",
            scenario_fn=scenarios.SCENARIOS["shadow_mirror_stop"].fn,
            buggy_fn=_prefix_shadow_run,
            expect_in_message="mirror accounting broke",
            dfs_runs=2000, max_steps=6000,
        )

    def test_reverted_body_loses_mirrors_and_replays(self):
        m = self._mutant()
        with lint.quiet_logs():
            cex = m.rediscover()
        assert cex is not None, "pre-fix ShadowMirror._run no longer rediscovered"
        assert "mirror accounting broke" in cex.failure.message
        with lint.quiet_logs():
            rep = m.replay([d.chosen for d in cex.decisions])
        assert rep.render_failure() == cex.render_failure()


# ---------------------------------------------------------------------------
# the baseline's scenario cross-reference
# ---------------------------------------------------------------------------


class TestBaselineScenarioCrossref:
    def _load(self, tmp_path, body):
        p = tmp_path / "b.toml"
        p.write_text(body)
        return baseline.load_baseline(str(p))

    def test_entry_without_scenario_fails(self, tmp_path):
        _e, problems = self._load(tmp_path, (
            '[[suppress]]\nkey = "unlocked-read:x"\njustification = "why"\n'))
        assert any(f.key.startswith("baseline-no-scenario") for f in problems)

    def test_unknown_scenario_name_fails(self, tmp_path):
        entries, problems = self._load(tmp_path, (
            '[[suppress]]\n'
            'key = "unlocked-read:distlr_tpu_torch/serve/reload.py:HotReloader.*"\n'
            'justification = "why"\nschedcheck_scenario = "gone_scenario"\n'))
        assert problems == []
        assert any(f.key.startswith("baseline-stale-scenario")
                   for f in baseline.scenario_crossref(entries))

    def test_scenario_not_covering_the_class_fails(self, tmp_path):
        entries, _p = self._load(tmp_path, (
            '[[suppress]]\n'
            'key = "unlocked-read:distlr_tpu_torch/serve/engine.py:ScoringEngine.*"\n'
            'justification = "why"\nschedcheck_scenario = "joiner_label_race"\n'))
        assert any(f.key.startswith("baseline-scenario-mismatch")
                   for f in baseline.scenario_crossref(entries))

    def test_a_jax_key_is_not_the_ports_class(self, tmp_path):
        """An entry copied from JAX's baseline unchanged names JAX's
        module, which no port scenario covers."""
        entries, _p = self._load(tmp_path, (
            '[[suppress]]\n'
            'key = "unlocked-read:distlr_tpu/serve/reload.py:HotReloader.*"\n'
            'justification = "why"\nschedcheck_scenario = "reloader_poll_swap"\n'))
        assert any(f.key.startswith("baseline-scenario-mismatch")
                   for f in baseline.scenario_crossref(entries))

    def test_dash_is_the_audited_opt_out(self, tmp_path):
        entries, problems = self._load(tmp_path, (
            '[[suppress]]\nkey = "unlocked-read:x"\n'
            'justification = "card-holding class, cannot run here"\n'
            'schedcheck_scenario = "-"\n'))
        assert problems == []
        assert baseline.scenario_crossref(entries) == []

    def test_port_baseline_crossrefs_are_live(self):
        entries, problems = baseline.load_baseline()
        assert problems == []
        assert baseline.scenario_crossref(entries) == []
        named = {e.scenario for e in entries if e.scenario != "-"}
        assert named and named <= set(scenarios.SCENARIOS)
        engine = [e for e in entries if ":ScoringEngine." in e.key]
        assert [e.scenario for e in engine] == ["-"]


# ---------------------------------------------------------------------------
# deep tier (slow), as JAX's
# ---------------------------------------------------------------------------


@pytest.mark.slow
class TestDeepTier:
    @pytest.mark.parametrize("name", ["joiner_label_race", "chaoslink_stop_accept",
                                      "shadow_mirror_stop"])
    def test_deep_dfs_closes_clean(self, name):
        s = scenarios.SCENARIOS[name]
        with lint.quiet_logs():
            res = explore.dfs(s.name, s.fn, preemption_bound=s.deep_bound,
                              max_runs=s.deep_runs, max_steps=s.max_steps)
        assert res.failure is None, res.failure.render_failure()
        assert res.closed

    def test_wide_fuzz_stays_clean(self):
        for s in scenarios.SCENARIOS.values():
            with lint.quiet_logs():
                fz = explore.fuzz(s.name, s.fn, seeds=150, max_steps=s.max_steps)
            assert fz.failure is None, (s.name, fz.failure.render_failure())
