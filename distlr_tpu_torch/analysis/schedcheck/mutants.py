"""Mutant-verified race rediscovery, applied to the port's
IMPLEMENTATION.

A checker that has never caught anything proves nothing — so
schedcheck must REDISCOVER the fleet's named historical Python races
when their fixes are reverted.  Each mutant swaps ONE real method for its verbatim
pre-fix body (kept here as the historical record), runs the matching
scenario, and the explorer must produce a replayable counterexample
schedule of **at most 20 steps**; with the fix in place the same
scenario must stay clean.  Failing to rediscover means "schedcheck
stopped encoding the fix" and fails the lint.

The two pinned races:

* ``joiner_check_then_insert`` — the joiner's hardening: the joiner
  once released its lock between the pending-label check and the
  spool insert, so a label arriving in that window parked in the
  pending buffer while its request aged out through negative
  sampling (``LabelJoiner.scored``).
* ``chaoslink_stop_snapshot`` — the concurrency lint's first finding:
  ``ChaosLink.stop()`` snapshotted its connections and threads lock-free
  BEFORE joining the accept loop, so a connection accepted
  concurrently with stop leaked its sockets and pump threads past
  stop() (``chaos/proxy.py``).

Each body below is the port's method with its fix reverted, rebuilt
from the port's method rather than copied from JAX's record (the port's
``LabelJoiner.scored`` indexes the pending pair where JAX's unpacks it).
"""

from __future__ import annotations

import contextlib
import dataclasses

from distlr_tpu_torch import sync
from distlr_tpu_torch.analysis.schedcheck import explore, scenarios
from distlr_tpu_torch.analysis.schedcheck.runtime import RunResult

#: the acceptance bound: a rediscovered race must replay in this many
#: schedule steps or fewer
MAX_SCHEDULE_STEPS = 20


# ---------------------------------------------------------------------------
# the verbatim pre-fix bodies
# ---------------------------------------------------------------------------


def _prefix_joiner_scored(self, rec) -> None:
    """``LabelJoiner.scored`` BEFORE the check-then-insert hardening:
    the pending-label check and the spool insert run under separate
    lock acquisitions — the check-then-insert window."""
    with self._lock:
        pend = self._pending.pop(rec.rid, None)
    if pend is not None:
        with self._lock:
            self._join_locked(rec.rid, pend[0], rec, now=pend[1])
        return
    self.spool.add(rec)


def _prefix_chaoslink_stop(self) -> None:
    """``ChaosLink.stop`` BEFORE the teardown fix: the pump threads
    snapshotted lock-free, and only THEN the accept loop joined — a
    connection registered between the snapshot and the join escapes
    the teardown entirely.  (The pre-fix body also closed a snapshot of
    the sockets; the port's pumps close their own, so that step has no
    counterpart here and the schedule is unchanged.)"""
    self._stop.set()
    try:
        self._lsock.close()
    except OSError:
        pass
    threads = list(self._threads)
    for t in threads:
        t.join(timeout=2.0)
    self._accept_thread.join(timeout=6.0)


# ---------------------------------------------------------------------------
# lean race scenarios (shared by the fixed-code clean check and the
# mutant rediscovery — small on purpose: the counterexample schedule
# must stay human-readable and within MAX_SCHEDULE_STEPS)
# ---------------------------------------------------------------------------


def _scn_joiner_strand(rt) -> None:
    with scenarios._workdir() as wd:
        _spool, joiner = scenarios._mk_joiner(wd)
        base = sync.wall()

        def scorer():
            joiner.scored(scenarios._rec("r1", base))

        t = sync.Thread(target=scorer, name="scorer")
        t.start()
        out = joiner.label("r1", 1, ts=base + 1.0)   # main is the labeler
        t.join()
        joiner.tick(now=base + 1000.0)
        scenarios._check(
            joiner.joined == 1,
            f"label and request both in-window but joined="
            f"{joiner.joined} (outcome={out!r}, negatives="
            f"{joiner.negatives}, pending={len(joiner._pending)}) — "
            "the label stranded in the pending buffer")


def _scn_chaoslink_leak(rt) -> None:
    link, made = scenarios._scripted_link()
    down = scenarios._FakeSock()
    link._lsock.feed((down, ("127.0.0.1", 1)))
    link.stop()                                      # main is the stopper
    alive = sorted(task.name for task in rt.tasks
                   if task.name.startswith("chaos-")
                   and task.state not in (scenarios.NEW, scenarios.DONE))
    scenarios._check(
        not alive,
        f"pump/accept thread(s) {alive} still live after stop() "
        "returned — teardown lost a concurrently-accepted connection")
    unclosed = [i for i, s in enumerate([down] + made) if not s.closed]
    scenarios._check(
        not unclosed,
        f"socket(s) {unclosed} not closed after stop() — the snapshot "
        "missed a concurrently-registered connection")


# ---------------------------------------------------------------------------
# registry + verification
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mutant:
    name: str
    historical: str                 # which fix this reverts
    target: str                     # "module:Class.method"
    scenario_fn: object
    buggy_fn: object
    #: substring the counterexample's invariant message must carry —
    #: rediscovering a DIFFERENT bug is a failure too ("wrong bug")
    expect_in_message: str
    dfs_runs: int = 1500
    max_steps: int = 1500

    def _cls(self):
        module, _, rest = self.target.partition(":")
        clsname, _, meth = rest.partition(".")
        import importlib
        mod = importlib.import_module(module)
        return getattr(mod, clsname), meth

    @contextlib.contextmanager
    def applied(self):
        """Swap the real method for the historical pre-fix body."""
        cls, meth = self._cls()
        orig = getattr(cls, meth)
        setattr(cls, meth, self.buggy_fn)
        try:
            yield
        finally:
            setattr(cls, meth, orig)

    def clean_check(self) -> RunResult | None:
        """With the FIX in place the scenario must be schedule-proof;
        returns the offending RunResult if it is not."""
        res = explore.dfs(f"mutant:{self.name}", self.scenario_fn,
                          preemption_bound=2, max_runs=self.dfs_runs,
                          max_steps=self.max_steps)
        return res.failure

    def rediscover(self) -> RunResult | None:
        """With the fix REVERTED the explorer must find the historical
        race; returns the counterexample run (None = not found)."""
        with self.applied():
            res = explore.dfs(f"mutant:{self.name}", self.scenario_fn,
                              preemption_bound=2,
                              max_runs=self.dfs_runs,
                              max_steps=self.max_steps)
        return res.failure

    def replay(self, choices: list[int]) -> RunResult:
        """Re-run one pinned counterexample under the mutation."""
        with self.applied():
            return explore.replay(f"mutant:{self.name}",
                                  self.scenario_fn, choices,
                                  max_steps=self.max_steps)


MUTANTS: dict[str, Mutant] = {
    m.name: m for m in (
        Mutant(
            name="joiner_check_then_insert",
            historical="the joiner's check-then-insert hardening",
            target="distlr_tpu_torch.feedback.join:LabelJoiner.scored",
            scenario_fn=_scn_joiner_strand,
            buggy_fn=_prefix_joiner_scored,
            expect_in_message="the label stranded",
        ),
        Mutant(
            name="chaoslink_stop_snapshot",
            historical="the concurrency lint's ChaosLink.stop fix",
            target="distlr_tpu_torch.chaos.proxy:ChaosLink.stop",
            scenario_fn=_scn_chaoslink_leak,
            buggy_fn=_prefix_chaoslink_stop,
            expect_in_message="after stop()",
        ),
    )
}


def verify_mutant(name: str) -> list[str]:
    """Full acceptance for one mutant; returns problem strings (empty
    = the race is rediscovered, bounded, replayable, and the fixed
    code is clean)."""
    m = MUTANTS[name]
    problems: list[str] = []
    clean = m.clean_check()
    if clean is not None:
        problems.append(
            f"{name}: scenario fails WITH the fix in place "
            f"({clean.failure.kind}: {clean.failure.message.splitlines()[0]})")
        return problems
    cex = m.rediscover()
    if cex is None:
        problems.append(
            f"{name}: reverting the {m.historical} was NOT rediscovered "
            "— schedcheck stopped encoding the fix")
        return problems
    if m.expect_in_message not in cex.failure.message:
        problems.append(
            f"{name}: rediscovered a DIFFERENT failure "
            f"({cex.failure.message.splitlines()[0]!r}) — wrong bug")
    nsteps = len(cex.decisions)
    if nsteps > MAX_SCHEDULE_STEPS:
        problems.append(
            f"{name}: counterexample needs {nsteps} steps "
            f"(> {MAX_SCHEDULE_STEPS}) — schedule-length regression")
    rep = m.replay([d.chosen for d in cex.decisions])
    if rep.failure is None:
        problems.append(f"{name}: pinned counterexample did not replay")
    elif rep.render_failure() != cex.render_failure():
        problems.append(
            f"{name}: replay is not byte-identical to the original "
            "failure report")
    return problems
