"""The port's schedcheck runtime and ``sync`` facade against the JAX
package's, on the CPU.

* the facade: passthrough names ARE the stdlib objects; a controlled run
  restores them; a second install is refused; the eleven routed modules
  make JAX's ``sync.*`` calls one for one (plus two port-only sites), and
  none binds a facade name at import; with the facade uninstalled the
  port's MicroBatcher gives JAX's batcher's results on stdlib primitives;
* the runtime: one toy program over bare ``sync`` primitives gives equal
  schedule ids and steps under both runtimes for the same seeds; the
  lock-inversion deadlock's counterexample text is equal across the
  packages and replays byte-identically twice; stale schedules diverge,
  timed waits fire on the virtual clock, the facade-drift detector
  fires, and schedule ids round-trip as JAX's do;
* the CLI: ``--list`` and replay of a mutant's counterexample by id.
"""

from __future__ import annotations

import collections
import queue as stdlib_queue
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from distlr_tpu import sync as jax_sync
from distlr_tpu.analysis.schedcheck import explore as jax_explore
from distlr_tpu.analysis.schedcheck import runtime as jax_runtime
from distlr_tpu_torch import sync
from distlr_tpu_torch.analysis.schedcheck import explore, lint, mutants, runtime, scenarios
from distlr_tpu_torch.analysis.schedcheck.runtime import (
    InvariantViolation,
    RandomStrategy,
    Strategy,
    parse_schedule_id,
    run_controlled,
)

REPO = Path(__file__).resolve().parents[1]

#: the port's modules whose locks, threads and clocks go through its sync
ROUTED = ("chaos/proxy.py", "serve/router.py", "serve/tenant.py", "serve/reload.py",
          "feedback/online.py", "ps/membership.py", "feedback/sink.py", "serve/batcher.py",
          "feedback/join.py", "feedback/spool.py", "feedback/drift.py")
#: facade calls the port makes where JAX has no site at all: the chaos
#: fabric's wall-clock timeline and the spool's drop-count lock
PORT_ONLY_SITES = {"chaos/proxy.py": {"wall": 1}, "feedback/spool.py": {"Lock": 1}}


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


def _sync_calls(path: Path) -> collections.Counter:
    return collections.Counter(re.findall(r"\bsync\.([A-Za-z_]+)", path.read_text()))


class TestSyncFacade:
    def test_passthrough_is_the_stdlib(self):
        assert sync.Lock is threading.Lock
        assert sync.RLock is threading.RLock
        assert sync.Condition is threading.Condition
        assert sync.Event is threading.Event
        assert sync.Semaphore is threading.Semaphore
        assert sync.BoundedSemaphore is threading.BoundedSemaphore
        assert sync.Thread is threading.Thread
        assert sync.Queue is stdlib_queue.Queue
        assert sync.Empty is stdlib_queue.Empty and sync.Full is stdlib_queue.Full
        assert sync.monotonic is time.monotonic
        assert sync.wall is time.time
        assert sync.sleep is time.sleep
        assert sync.SWAPPABLE == jax_sync.SWAPPABLE
        assert not sync.instrumented()

    def test_install_restores_passthrough_after_a_run(self):
        res = run_controlled("noop", lambda rt: None, Strategy())
        assert res.failure is None
        assert sync.Lock is threading.Lock and not sync.instrumented()
        assert not jax_sync.instrumented()

    def test_double_install_refused(self):
        def scn(rt):
            with pytest.raises(RuntimeError, match="already instrumented"):
                sync.install({}, owner=object())
        assert run_controlled("dbl", scn, Strategy()).failure is None

    @pytest.mark.parametrize("module", ROUTED)
    def test_routed_module_calls_the_facade_like_jax(self, module):
        port = REPO / "distlr_tpu_torch" / module
        got = _sync_calls(port)
        want = _sync_calls(REPO / "distlr_tpu" / module)
        want.update(PORT_ONLY_SITES.get(module, {}))
        assert got == want
        src = port.read_text()
        # a name bound at import escapes install(); a raw primitive is
        # invisible to it
        assert "from distlr_tpu_torch.sync import" not in src
        assert "from distlr_tpu_torch import sync\n" in src
        assert not re.search(
            r"\bthreading\.(Lock|RLock|Condition|Event|Semaphore|BoundedSemaphore|Thread)\b", src)
        assert not re.search(r"\btime\.(monotonic|sleep)\(", src)

    def test_uninstrumented_batcher_behaves_like_jax(self):
        """With the facade uninstalled the port's MicroBatcher runs on
        stdlib primitives and the real clock, and gives the JAX batcher's
        scores and accounting for the same requests."""
        from distlr_tpu.serve.batcher import MicroBatcher as JaxMicroBatcher
        from distlr_tpu_torch.serve.batcher import MicroBatcher

        def score(merged):
            n = merged[0].shape[0]
            return (np.zeros(n, np.int32),
                    merged[0].reshape(n, -1).sum(axis=1).astype(np.float32))

        got = {}
        for name, cls in (("port", MicroBatcher), ("jax", JaxMicroBatcher)):
            with cls(score, max_batch_size=8, max_wait_ms=2.0) as b:
                assert type(b._cv) is threading.Condition
                assert type(b._thread) is threading.Thread
                futs = [b.submit((np.full((1, 2), v, np.float32),)) for v in (1.0, 2.0, 3.0)]
                got[name] = ([float(f.result(timeout=5.0)[1][0]) for f in futs],
                             b.requests, b.rows)
        assert got["port"] == got["jax"] == ([2.0, 4.0, 6.0], 3, 3)


# ---------------------------------------------------------------------------
# the runtime, against JAX's
# ---------------------------------------------------------------------------


def _toy(mod):
    """A producer/consumer over every kind of bare facade primitive,
    written once for either package's ``sync``."""

    def scn(rt):
        lock, ev, q = mod.Lock(), mod.Event(), mod.Queue(maxsize=1)
        cv, box = mod.Condition(), []

        def producer(i):
            with lock:
                box.append(i)
            q.put(i)

        def consumer():
            got = [q.get(), q.get()]
            with cv:
                box.append(tuple(sorted(got)))
                cv.notify_all()
            ev.set()

        ts = [mod.Thread(target=producer, args=(i,), name=f"p{i}") for i in range(2)]
        ts.append(mod.Thread(target=consumer, name="consumer"))
        for t in ts:
            t.start()
        assert ev.wait(5.0)
        with cv:
            cv.wait_for(lambda: (0, 1) in box, timeout=1.0)
        for t in ts:
            t.join()
        mod.sleep(0.25)

    return scn


def _lock_inversion(mod):
    """The seeded AB/BA lock-order inversion: the deadlock fixture."""

    def scn(rt):
        a, b = mod.Lock(), mod.Lock()

        def t_ab():
            with a:
                with b:
                    pass

        def t_ba():
            with b:
                with a:
                    pass

        t1 = mod.Thread(target=t_ab, name="ab")
        t2 = mod.Thread(target=t_ba, name="ba")
        t1.start()
        t2.start()
        t1.join()
        t2.join()

    return scn


class TestRuntimeAgainstJax:
    @pytest.mark.parametrize("seed", range(6))
    def test_same_seed_same_schedule_under_both_runtimes(self, seed):
        port = run_controlled("toy", _toy(sync), RandomStrategy(seed))
        jax = jax_runtime.run_controlled("toy", _toy(jax_sync), jax_runtime.RandomStrategy(seed))
        assert port.failure is None and jax.failure is None
        assert port.schedule_id == jax.schedule_id
        assert [(s.decision, s.task, s.desc) for s in port.steps] == \
            [(s.decision, s.task, s.desc) for s in jax.steps]
        assert port.clock == jax.clock == 0.25

    def test_deadlock_counterexample_equals_jax_and_replays_twice(self):
        res = explore.dfs("inversion", _lock_inversion(sync), preemption_bound=2, max_runs=500)
        jres = jax_explore.dfs("inversion", _lock_inversion(jax_sync), preemption_bound=2,
                               max_runs=500)
        assert res.failure is not None and res.failure.failure.kind == "deadlock"
        text = res.failure.render_failure()
        assert text == jres.failure.render_failure()
        assert ("wait-for cycle: ab -> ba -> ab" in text
                or "wait-for cycle: ba -> ab -> ba" in text)
        assert "schedule (numbered lines" in text
        choices = [d.chosen for d in res.failure.decisions]
        r1 = explore.replay("inversion", _lock_inversion(sync), choices)
        r2 = explore.replay("inversion", _lock_inversion(sync), choices)
        assert r1.render_failure() == r2.render_failure() == text

    def test_stale_schedule_reports_divergence_like_jax(self):
        def scn(mod):
            def body(rt):
                with mod.Lock():
                    pass
            return body
        res = explore.replay("one-task", scn(sync), [7, 7, 7])
        jres = jax_explore.replay("one-task", scn(jax_sync), [7, 7, 7])
        assert res.failure is not None and res.failure.kind == "divergence"
        assert res.failure.message == jres.failure.message

    def test_virtual_clock_fires_timeouts_deterministically(self):
        out = {}

        def scn(rt):
            ev = sync.Event()
            out["flag"] = ev.wait(5.0)
            out["clock"] = sync.monotonic()
            out["wall"] = sync.wall()

        res = run_controlled("vclock", scn, Strategy())
        assert res.failure is None
        assert out == {"flag": False, "clock": 5.0, "wall": runtime.WALL_BASE + 5.0}
        assert res.clock == 5.0
        assert runtime.WALL_BASE == jax_runtime.WALL_BASE
        assert runtime.WATCHDOG_S == jax_runtime.WATCHDOG_S

    def test_negative_virtual_sleep_raises_like_the_stdlib(self):
        def scn(rt):
            with pytest.raises(ValueError, match="non-negative"):
                sync.sleep(-1.0)
        assert run_controlled("neg-sleep", scn, Strategy()).failure is None

    def test_facade_drift_detector_fires(self, tmp_path):
        """Outside an install the real joiner's lock is a plain stdlib
        lock: exactly the drifted shape the detector must refuse."""
        _spool, joiner = scenarios._mk_joiner(str(tmp_path))
        with pytest.raises(InvariantViolation, match="not an instrumented twin"):
            scenarios.assert_facade(joiner, "distlr_tpu_torch/feedback/join.py:LabelJoiner")
        with pytest.raises(InvariantViolation, match="not in the concurrency lint"):
            scenarios.assert_facade(joiner, "distlr_tpu/feedback/join.py:LabelJoiner")

    @pytest.mark.parametrize("sid", ["joiner_label_race:0.2.1", "mutant:joiner_check_then_insert:1.1.0",
                                     "x:", "noop:7"])
    def test_schedule_id_roundtrip_like_jax(self, sid):
        assert parse_schedule_id(sid) == jax_runtime.parse_schedule_id(sid)
        with pytest.raises(ValueError):
            parse_schedule_id("no-colon")

    def test_random_schedules_are_replayable(self):
        s = scenarios.SCENARIOS["joiner_label_race"]
        rnd = run_controlled(s.name, s.fn, RandomStrategy(7), max_steps=s.max_steps)
        assert rnd.failure is None
        rep = explore.replay(s.name, s.fn, [d.chosen for d in rnd.decisions],
                             max_steps=s.max_steps)
        assert rep.failure is None
        assert [st.desc for st in rep.steps] == [st.desc for st in rnd.steps]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


class TestSchedcheckCLI:
    def test_list_names_the_scenarios_and_mutants(self, capsys):
        from distlr_tpu_torch.analysis.schedcheck.__main__ import main as sc_main
        assert sc_main(["--list"]) == 0
        out = capsys.readouterr().out
        for name in scenarios.SCENARIOS:
            assert f"{name}: distlr_tpu_torch/" in out
        for name in mutants.MUTANTS:
            assert f"mutant:{name}: reverts distlr_tpu_torch." in out

    def test_unknown_replay_id_exits_one(self, capsys):
        from distlr_tpu_torch.analysis.schedcheck.__main__ import main as sc_main
        assert sc_main(["--replay", "no_such_scenario:0.1"]) == 1
        assert "unknown scenario" in capsys.readouterr().err

    def test_replay_of_a_mutant_counterexample_by_id(self):
        m = mutants.MUTANTS["joiner_check_then_insert"]
        with lint.quiet_logs():
            cex = m.rediscover()
        proc = subprocess.run(
            [sys.executable, "-m", "distlr_tpu_torch.analysis.schedcheck", "--replay",
             cex.schedule_id],
            capture_output=True, text=True, cwd=REPO, timeout=120)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert "the label stranded" in proc.stdout
        assert proc.stdout.strip() == cex.render_failure().strip()
