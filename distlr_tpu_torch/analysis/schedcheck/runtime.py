"""The schedcheck runtime: a cooperative, deterministic scheduler for
REAL production classes.

Execution model (the CHESS one): every logical thread a scenario
spawns through the :mod:`distlr_tpu_torch.sync` facade becomes a *task*
parked on a baton — exactly ONE task executes at any instant, and the
baton changes hands only at instrumented yield points (lock acquires,
condition waits/notifies, event sets, queue ops, thread start/join,
virtual sleeps).  The OS scheduler never chooses an interleaving;
the strategy object does, so every run is a replayable sequence of
choices and the whole interleaving space is enumerable.

Time is VIRTUAL: ``sync.monotonic()``/``sync.wall()`` read a clock
that advances only at quiescence (every task blocked, at least one
with a deadline) — a ``cv.wait(timeout)`` or ``Event.wait(timeout)``
can therefore time out deterministically, never racily, and a
scenario with a 30 s join finishes in microseconds.

Deadlock detection falls out of the model: all live tasks blocked
with no pending timer is a deadlock by construction; the failure
report prints the minimal wait-for cycle and the numbered schedule
that drove there.

This module is the checked twin of :mod:`distlr_tpu_torch.sync` (see its
docstring): the facade's passthrough bindings are the production
build, the twins below are the verification build, and scenarios
assert via the concurrency lint's shared-state registry that the
classes under test actually created their primitives through the
facade.
"""

from __future__ import annotations

import dataclasses
import threading as _threading
import time as _time

from distlr_tpu_torch import sync

#: real-seconds watchdog on every baton wait — a harness bug must fail
#: loudly, not hang CI
WATCHDOG_S = 60.0
#: virtual wall-clock base (sync.wall() = base + virtual monotonic)
WALL_BASE = 1_600_000_000.0

NEW, RUNNABLE, BLOCKED, DONE = "new", "runnable", "blocked", "done"


class InvariantViolation(AssertionError):
    """A scenario invariant failed under the current schedule."""


class ScheduleDivergence(RuntimeError):
    """A replayed schedule no longer matches the code (stale pin)."""


class _TaskAbort(BaseException):
    """Internal: unwind a task after the run already failed.

    Derives from BaseException so production ``except Exception``
    blocks cannot swallow the teardown.
    """


@dataclasses.dataclass
class Failure:
    kind: str      # deadlock | invariant | exception | step-budget | divergence
    message: str

    def render(self) -> str:
        return f"{self.kind}: {self.message}"


@dataclasses.dataclass
class Decision:
    """One branching point: >1 task was runnable and the strategy chose."""

    index: int
    enabled: tuple[int, ...]
    chosen: int
    current: int | None        # tid running before the choice (None: it blocked)
    #: True when a runnable current task was preempted (the CHESS cost)
    preemptive: bool


@dataclasses.dataclass
class Step:
    """One executed scheduling event (decision or forced continuation)."""

    decision: int | None       # index into decisions, None = forced
    task: str
    desc: str


@dataclasses.dataclass
class RunResult:
    scenario: str
    failure: Failure | None
    steps: list[Step]
    decisions: list[Decision]
    clock: float
    tasks: list[str]

    @property
    def schedule_id(self) -> str:
        return (self.scenario + ":"
                + ".".join(str(d.chosen) for d in self.decisions))

    def render_schedule(self) -> str:
        """The numbered schedule: one line per DECISION (the replayable
        choices — forced continuations print indented, unnumbered)."""
        out = []
        for st in self.steps:
            if st.decision is not None:
                out.append(f"{st.decision + 1:3d}. {st.task}: {st.desc}")
            else:
                out.append(f"     · {st.task}: {st.desc}")
        return "\n".join(out)

    def render_failure(self) -> str:
        """Byte-stable failure report (replay determinism is pinned on
        this string: no wall times, no object ids, no paths)."""
        assert self.failure is not None
        return (
            f"schedcheck FAILURE scenario={self.scenario}\n"
            f"schedule={self.schedule_id} "
            f"steps={len(self.decisions)} vclock={self.clock:.3f}\n"
            f"{self.failure.render()}\n"
            "schedule (numbered lines are the replayable choices):\n"
            + self.render_schedule() + "\n"
        )


def parse_schedule_id(sid: str) -> tuple[str, list[int]]:
    # split at the LAST colon: scenario names may carry a namespace
    # prefix of their own ("mutant:<name>:<choices>")
    name, _, rest = sid.rpartition(":")
    if not name:
        raise ValueError(f"bad schedule id {sid!r}")
    choices = [int(c) for c in rest.split(".") if c != ""]
    return name, choices


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------


class Strategy:
    """Chooses the next task at each branching point.

    ``choose`` sees the sorted enabled tids, the tid that was running
    (None when it just blocked/finished) and whether it is still
    enabled.  The DEFAULT policy — run the current task while it can
    run, else the lowest tid — is the zero-preemption baseline every
    explorer perturbs.
    """

    def choose(self, index: int, enabled: list[int],
               current: int | None, current_enabled: bool) -> int:
        if current is not None and current_enabled:
            return current
        return enabled[0]


class ReplayStrategy(Strategy):
    """Follow a recorded choice list, default policy past its end."""

    def __init__(self, choices: list[int]):
        self.choices = list(choices)

    def choose(self, index, enabled, current, current_enabled):
        if index < len(self.choices):
            want = self.choices[index]
            if want not in enabled:
                raise ScheduleDivergence(
                    f"decision {index}: schedule pins task {want} but "
                    f"enabled tasks are {enabled} — the pinned schedule "
                    "no longer matches the code")
            return want
        return super().choose(index, enabled, current, current_enabled)


class RandomStrategy(Strategy):
    """Seeded uniform choice — the fuzzing layer.  Fully replayable:
    the resulting RunResult's schedule_id pins the explicit choices."""

    def __init__(self, seed: int):
        import random
        self._rng = random.Random(seed)

    def choose(self, index, enabled, current, current_enabled):
        return self._rng.choice(enabled)


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------


class Task:
    __slots__ = ("tid", "name", "state", "gate", "thread", "pending",
                 "block_kind", "block_res", "deadline", "timed_out",
                 "wake_pred", "abort", "exc", "daemon")

    def __init__(self, tid: int, name: str):
        self.tid = tid
        self.name = name
        self.state = NEW
        self.gate = _threading.Event()
        self.thread: _threading.Thread | None = None
        self.pending = "start"
        self.block_kind: str | None = None   # lock|cv|event|sem|queue|join|sleep|pred
        self.block_res = None                # twin / Task / None
        self.deadline: float | None = None
        self.timed_out = False
        self.wake_pred = None
        self.abort = False
        self.exc: BaseException | None = None
        self.daemon = True

    def __repr__(self):
        return f"<task {self.tid} {self.name} {self.state}>"


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------


class Runtime:
    """One controlled run.  Use :func:`run_controlled`, not this
    directly — the calling thread becomes task 0 ("main")."""

    def __init__(self, scenario: str, strategy: Strategy, *,
                 max_steps: int = 4000):
        self.scenario = scenario
        self.strategy = strategy
        self.max_steps = max_steps
        self.tasks: list[Task] = []
        self.steps: list[Step] = []
        self.decisions: list[Decision] = []
        self.failure: Failure | None = None
        self.clock = 0.0
        self.finished = False
        self._aborting = False
        self._cur: Task | None = None
        self._by_ident: dict[int, Task] = {}
        self._res_seq: dict[str, int] = {}

    # -- naming / identity -------------------------------------------------
    def _res_name(self, kind: str) -> str:
        n = self._res_seq.get(kind, 0) + 1
        self._res_seq[kind] = n
        return f"{kind}#{n}"

    def current_task(self) -> Task | None:
        return self._by_ident.get(_threading.get_ident())

    def _managed(self) -> bool:
        """True when the calling thread should go through the
        scheduler: the run is live, not unwinding, and the caller is a
        registered task."""
        return (not self.finished and not self._aborting
                and self.current_task() is not None)

    # -- virtual clock -----------------------------------------------------
    def vmonotonic(self) -> float:
        return self.clock

    def vwall(self) -> float:
        return WALL_BASE + self.clock

    # -- scheduling core ---------------------------------------------------
    def _record_step(self, task: Task, decision: int | None) -> None:
        self.steps.append(
            Step(decision, f"{task.name}({task.tid})", task.pending))
        if len(self.steps) > self.max_steps:
            self._fail(Failure(
                "step-budget",
                f"run exceeded {self.max_steps} scheduling events — "
                "livelock, or the scenario is too large for its budget"))

    def _refresh_preds(self) -> None:
        for t in self.tasks:
            if t.state != BLOCKED:
                continue
            if t.block_kind == "join":
                if t.block_res.state == DONE:
                    self._wake(t, timed_out=False)
            elif t.wake_pred is not None and t.wake_pred():
                self._wake(t, timed_out=False)

    def _wake(self, task: Task, *, timed_out: bool) -> None:
        task.state = RUNNABLE
        task.timed_out = timed_out
        task.wake_pred = None
        task.block_kind = None
        task.block_res = None
        task.deadline = None

    def _enabled(self) -> list[Task]:
        self._refresh_preds()
        return [t for t in self.tasks if t.state == RUNNABLE]

    def _advance_clock(self) -> bool:
        """At quiescence: fire the earliest deadline(s).  Returns True
        when at least one task woke."""
        due = [t for t in self.tasks
               if t.state == BLOCKED and t.deadline is not None]
        if not due:
            return False
        dmin = min(t.deadline for t in due)
        self.clock = max(self.clock, dmin)
        for t in due:
            if t.deadline <= self.clock:
                if t.block_kind == "cv":
                    # a timed-out cv waiter leaves the waiter list
                    t.block_res._waiters.remove(t)
                elif t.block_kind in ("lock", "sem", "queue"):
                    t.block_res._unwait(t)
                self._wake(t, timed_out=True)
                t.pending = f"{t.pending} [timeout @{self.clock:.3f}]"
        return True

    def _deadlock_failure(self) -> Failure:
        blocked = [t for t in self.tasks if t.state == BLOCKED]
        lines = []
        edges: dict[int, int] = {}
        for t in blocked:
            what = t.pending.removeprefix("blocked: ")
            if t.block_kind == "lock" and t.block_res._owner is not None:
                owner = t.block_res._owner
                edges[t.tid] = owner.tid
                lines.append(f"  {t.name} blocked: {what} "
                             f"(held by {owner.name})")
            elif t.block_kind == "join":
                edges[t.tid] = t.block_res.tid
                lines.append(f"  {t.name} blocked: {what}")
            else:
                lines.append(f"  {t.name} blocked: {what} "
                             "(no pending wakeup — lost notify?)")
        # minimal wait-for cycle: each task has <= 1 outgoing edge, so
        # a walk with a visited set finds the cycle if one exists
        cycle = None
        by_tid = {t.tid: t for t in self.tasks}
        for start in sorted(edges):
            seen: list[int] = []
            cur = start
            while cur in edges and cur not in seen:
                seen.append(cur)
                cur = edges[cur]
            if cur in seen:
                loop = seen[seen.index(cur):] + [cur]
                cycle = " -> ".join(by_tid[tid].name for tid in loop)
                break
        msg = "all live tasks blocked; no pending timer\n" + "\n".join(lines)
        if cycle:
            msg += f"\n  wait-for cycle: {cycle}"
        return Failure("deadlock", msg)

    def _pick_next(self, *, current_ok: bool) -> Task:
        """Choose who runs next.  Raises _TaskAbort via _fail when the
        system is deadlocked."""
        while True:
            enabled = self._enabled()
            if enabled:
                break
            if not self._advance_clock():
                self._fail(self._deadlock_failure())
        if len(enabled) == 1:
            chosen = enabled[0]
            self._record_step(chosen, None)
            return chosen
        cur = self._cur if current_ok else None
        cur_tid = cur.tid if cur is not None else None
        cur_enabled = cur is not None and cur.state == RUNNABLE
        tids = [t.tid for t in enabled]
        idx = len(self.decisions)
        try:
            tid = self.strategy.choose(idx, tids, cur_tid, cur_enabled)
        except ScheduleDivergence as e:
            self._fail(Failure("divergence", str(e)))
        if tid not in tids:
            self._fail(Failure(
                "divergence", f"strategy chose tid {tid} not in {tids}"))
        chosen = next(t for t in enabled if t.tid == tid)
        self.decisions.append(Decision(
            idx, tuple(tids), tid, cur_tid,
            preemptive=cur_enabled and tid != cur_tid))
        self._record_step(chosen, idx)
        return chosen

    def _handoff(self, cur: Task, nxt: Task) -> None:
        if nxt is cur:
            return
        self._cur = nxt
        cur.gate.clear()
        nxt.gate.set()
        self._wait_gate(cur)

    def _wait_gate(self, task: Task) -> None:
        if not task.gate.wait(WATCHDOG_S):
            # harness bug — fail loudly rather than hang the test run
            self.failure = self.failure or Failure(
                "step-budget", f"watchdog: {task.name} never rescheduled")
            raise _TaskAbort()
        if task.abort:
            raise _TaskAbort()

    def yield_point(self, desc: str) -> None:
        """The instrumented preemption point: the running task offers
        the scheduler a switch before performing ``desc``."""
        cur = self.current_task()
        if cur is None:
            return
        cur.pending = desc
        nxt = self._pick_next(current_ok=True)
        self._handoff(cur, nxt)

    def block(self, kind: str, res, desc: str, *,
              deadline: float | None = None, wake_pred=None) -> bool:
        """Park the current task.  Returns True when it was woken by a
        timeout (vs granted/notified)."""
        cur = self.current_task()
        assert cur is not None
        cur.state = BLOCKED
        cur.block_kind = kind
        cur.block_res = res
        cur.deadline = deadline
        cur.wake_pred = wake_pred
        cur.timed_out = False
        cur.pending = f"blocked: {desc}"
        nxt = self._pick_next(current_ok=False)
        self._handoff(cur, nxt)
        # if _pick_next woke US (timer/pred with no other runnable),
        # _handoff was a no-op and we continue directly
        return cur.timed_out

    def _fail(self, failure: Failure) -> None:
        if self.failure is None:
            self.failure = failure
        self._abort_all()
        raise _TaskAbort()

    def _abort_all(self) -> None:
        self._aborting = True
        for t in self.tasks:
            if t.state in (RUNNABLE, BLOCKED) and t is not self.current_task():
                t.abort = True
                t.gate.set()

    # -- task lifecycle ----------------------------------------------------
    def _register_main(self) -> Task:
        t = Task(0, "main")
        t.state = RUNNABLE
        t.thread = _threading.current_thread()
        t.gate.set()
        self.tasks.append(t)
        self._by_ident[_threading.get_ident()] = t
        self._cur = t
        return t

    def spawn_task(self, name: str, fn, args, kwargs) -> Task:
        task = Task(len(self.tasks), name)
        self.tasks.append(task)

        def body():
            self._by_ident[_threading.get_ident()] = task
            try:
                self._wait_gate(task)
                fn(*args, **kwargs)
            except _TaskAbort:
                pass
            except BaseException as e:  # noqa: BLE001 — a dying task IS the finding
                task.exc = e
                if self.failure is None and not self._aborting:
                    self.failure = Failure(
                        "exception",
                        f"task {name} died: {type(e).__name__}: {e}")
                    self._abort_all()
            finally:
                task.state = DONE
                task.pending = "done"
                if not self._aborting and not self.finished:
                    try:
                        nxt = self._pick_next(current_ok=False)
                        self._cur = nxt
                        nxt.gate.set()
                    except _TaskAbort:
                        pass

        task.thread = _threading.Thread(
            target=body, daemon=True, name=f"schedcheck-{name}")
        task.thread.start()
        return task

    def start_task(self, task: Task) -> None:
        cur = self.current_task()
        assert cur is not None
        # runnable FIRST: the spawn point itself is a branch where the
        # child may run before the spawner's next instruction
        task.state = RUNNABLE
        self.yield_point(f"thread.start {task.name}")

    # -- scenario helpers --------------------------------------------------
    def await_until(self, pred, desc: str = "condition",
                    timeout: float | None = None) -> bool:
        """Block the calling task until ``pred()`` holds (re-evaluated
        at every scheduling step; must be side-effect-free).  Returns
        False on (virtual) timeout."""
        self.yield_point(f"await {desc}")
        if pred():
            return True
        deadline = None if timeout is None else self.clock + timeout
        timed_out = self.block("pred", None, f"await {desc}",
                               deadline=deadline, wake_pred=pred)
        return not timed_out

    def fail_invariant(self, message: str) -> None:
        raise InvariantViolation(message)


# ---------------------------------------------------------------------------
# instrumented twins.  Three regimes per call:
#
# * LIVE — the run is active and the caller is a managed task: full
#   scheduler semantics.
# * UNWIND — the run failed and tasks are tearing down through
#   production ``finally`` blocks: permissive non-blocking no-ops, so
#   unwinding can never re-enter (or hang) the dead scheduler.
# * ESCAPED — the run is over but the twin leaked out (cached in a
#   global, returned from a scenario): degrade to REAL stdlib behavior
#   via a lazily-created fallback primitive — mutual exclusion and
#   blocking semantics are preserved for whatever outlives the run.
#
# Out of scope (documented, not supported): an UNMANAGED thread
# touching a twin while its run is still live — the scheduler cannot
# wake managed waiters from outside the baton, so scenarios must keep
# twins inside the managed task set (the factories already hand
# unmanaged callers real stdlib objects at creation time).
# ---------------------------------------------------------------------------


class _TwinBase:
    def __init__(self, rt: Runtime, kind: str):
        self._rt = rt
        self.name = rt._res_name(kind)
        self._fallback = None

    def _live(self) -> bool:
        return self._rt._managed()

    def _escaped(self) -> bool:
        return self._rt.finished

    def _real(self, ctor):
        if self._fallback is None:
            self._fallback = ctor()
        return self._fallback


class TLock(_TwinBase):
    _reentrant = False

    def __init__(self, rt: Runtime, kind: str | None = None):
        super().__init__(rt, kind or type(self).__name__.lstrip("T"))
        self._owner: Task | None = None
        self._count = 0
        self._waiters: list[Task] = []

    def _unwait(self, task: Task) -> None:
        if task in self._waiters:
            self._waiters.remove(task)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        rt = self._rt
        if not self._live():
            if not self._escaped():
                return True      # mid-run unwind: permissive
            real = self._real(_threading.RLock if self._reentrant
                              else _threading.Lock)
            if timeout is not None and timeout >= 0:
                return real.acquire(blocking, timeout)
            return real.acquire(blocking)
        cur = rt.current_task()
        rt.yield_point(f"acquire {self.name}")
        if self._owner is None or (self._reentrant and self._owner is cur):
            self._owner = cur
            self._count += 1
            return True
        if not blocking:
            return False
        deadline = (None if timeout is None or timeout < 0
                    else rt.clock + timeout)
        self._waiters.append(cur)
        timed_out = rt.block("lock", self, f"acquire {self.name}",
                             deadline=deadline)
        if timed_out:
            return False
        # granted by release(): ownership was transferred to us there
        assert self._owner is cur
        return True

    def release(self) -> None:
        rt = self._rt
        if not self._live():
            if self._escaped():
                try:
                    self._real(_threading.RLock if self._reentrant
                               else _threading.Lock).release()
                except RuntimeError:
                    pass
            return
        cur = rt.current_task()
        if self._owner is not cur:
            raise RuntimeError(f"release of un-acquired {self.name}")
        self._count -= 1
        if self._count:
            return
        self._owner = None
        if self._waiters:
            nxt = self._waiters.pop(0)   # deterministic FIFO handoff
            self._owner = nxt
            self._count = 1
            rt._wake(nxt, timed_out=False)
            nxt.pending = f"acquire {self.name} (granted)"

    def locked(self) -> bool:
        return self._owner is not None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class TRLock(TLock):
    _reentrant = True

    def __init__(self, rt: Runtime):
        super().__init__(rt, "RLock")


class TCondition(_TwinBase):
    def __init__(self, rt: Runtime, lock=None):
        super().__init__(rt, "Condition")
        self._lock = lock if lock is not None else TLock(rt, "Condition.Lock")
        self._waiters: list[Task] = []

    # escaped twins delegate the WHOLE interface to one real Condition
    # (lock included — pairing the twin lock's separate fallback with a
    # real condition's internal lock would never match ownership)
    def _esc(self):
        return self._real(_threading.Condition)

    # delegate the lock interface
    def acquire(self, *a, **k):
        if not self._live() and self._escaped():
            return self._esc().acquire(*a, **k)
        return self._lock.acquire(*a, **k)

    def release(self):
        if not self._live() and self._escaped():
            try:
                self._esc().release()
            except RuntimeError:
                pass
            return
        return self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def wait(self, timeout: float | None = None) -> bool:
        rt = self._rt
        if not self._live():
            if self._escaped():
                return self._esc().wait(timeout)
            return False         # mid-run unwind: spurious wakeup
        cur = rt.current_task()
        if self._lock._owner is not cur:
            raise RuntimeError(f"cv.wait on un-owned {self.name}")
        rt.yield_point(f"cv.wait {self.name}")
        # fully release (rlock-aware), remember the depth to restore
        saved, self._lock._count = self._lock._count, 1
        self._lock.release()
        self._waiters.append(cur)
        deadline = None if timeout is None else rt.clock + timeout
        timed_out = rt.block("cv", self, f"cv.wait {self.name}",
                             deadline=deadline)
        # re-acquire before returning, like the stdlib
        self._lock.acquire()
        self._lock._count = saved
        return not timed_out

    def wait_for(self, predicate, timeout: float | None = None):
        rt = self._rt
        endtime = None if timeout is None else rt.clock + timeout
        result = predicate()
        while not result:
            waittime = None
            if endtime is not None:
                waittime = endtime - rt.clock
                if waittime <= 0:
                    break
            self.wait(waittime)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        rt = self._rt
        if not self._live():
            if self._escaped():
                self._esc().notify(n)
            return
        if self._lock._owner is not rt.current_task():
            raise RuntimeError(f"cv.notify on un-owned {self.name}")
        rt.yield_point(f"cv.notify {self.name}")
        for _ in range(min(n, len(self._waiters))):
            t = self._waiters.pop(0)
            rt._wake(t, timed_out=False)
            t.pending = f"cv.wait {self.name} (notified)"

    def notify_all(self) -> None:
        if not self._live() and self._escaped():
            self._esc().notify_all()
            return
        self.notify(len(self._waiters) or 1)


class TEvent(_TwinBase):
    def __init__(self, rt: Runtime):
        super().__init__(rt, "Event")
        self._flag = False
        self._waiters: list[Task] = []

    def _esc(self):
        ev = self._real(_threading.Event)
        if self._flag and not ev.is_set():
            ev.set()             # carry the run-time flag over
        return ev

    def is_set(self) -> bool:
        return self._flag

    def set(self) -> None:
        rt = self._rt
        if not self._live():
            self._flag = True
            if self._escaped():
                self._esc().set()
            return
        rt.yield_point(f"event.set {self.name}")
        self._flag = True
        waiters, self._waiters = self._waiters, []
        for t in waiters:
            rt._wake(t, timed_out=False)
            t.pending = f"event.wait {self.name} (set)"

    def clear(self) -> None:
        self._flag = False
        if self._fallback is not None:
            self._fallback.clear()

    def wait(self, timeout: float | None = None) -> bool:
        rt = self._rt
        if not self._live():
            if self._escaped():
                return self._esc().wait(timeout)
            return self._flag    # mid-run unwind: never block
        cur = rt.current_task()
        rt.yield_point(f"event.wait {self.name}")
        if self._flag:
            return True
        deadline = None if timeout is None else rt.clock + timeout
        self._waiters.append(cur)
        rt.block("event", self, f"event.wait {self.name}",
                 deadline=deadline)
        if cur in self._waiters:
            self._waiters.remove(cur)
        return self._flag


class TSemaphore(_TwinBase):
    _bounded = False

    def __init__(self, rt: Runtime, value: int = 1):
        super().__init__(
            rt, "BoundedSemaphore" if self._bounded else "Semaphore")
        if value < 0:
            raise ValueError("semaphore initial value must be >= 0")
        self._value = value
        self._initial = value
        self._waiters: list[Task] = []

    def _unwait(self, task: Task) -> None:
        if task in self._waiters:
            self._waiters.remove(task)

    def acquire(self, blocking: bool = True, timeout: float | None = None):
        rt = self._rt
        if not self._live():
            if not self._escaped():
                return True      # mid-run unwind: permissive
            real = self._real(
                lambda: _threading.Semaphore(max(self._value, 0)))
            return real.acquire(blocking, timeout)
        cur = rt.current_task()
        rt.yield_point(f"sem.acquire {self.name}")
        if self._value > 0:
            self._value -= 1
            return True
        if not blocking:
            return False
        deadline = None if timeout is None else rt.clock + timeout
        self._waiters.append(cur)
        timed_out = rt.block("sem", self, f"sem.acquire {self.name}",
                             deadline=deadline)
        return not timed_out

    def release(self, n: int = 1) -> None:
        rt = self._rt
        if not self._live():
            if self._escaped():
                # the real fallback (seeded in acquire) takes over; the
                # bounded over-release guard does not survive escape
                self._real(
                    lambda: _threading.Semaphore(max(self._value, 0))
                ).release(n)
            else:
                self._value += n
            return
        if self._bounded and self._value + n > self._initial:
            raise ValueError("Semaphore released too many times")
        rt.yield_point(f"sem.release {self.name}")
        for _ in range(n):
            if self._waiters:
                t = self._waiters.pop(0)   # direct handoff, no +1
                rt._wake(t, timed_out=False)
                t.pending = f"sem.acquire {self.name} (granted)"
            else:
                self._value += 1

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class TBoundedSemaphore(TSemaphore):
    _bounded = True


class TQueue(_TwinBase):
    def __init__(self, rt: Runtime, maxsize: int = 0):
        super().__init__(rt, "Queue")
        self.maxsize = maxsize
        self._items: list = []
        self._getters: list[Task] = []
        self._putters: list[Task] = []

    def _unwait(self, task: Task) -> None:
        for lst in (self._getters, self._putters):
            if task in lst:
                lst.remove(task)

    def _esc(self):
        """Escaped queue: migrate run-time items into a real Queue once
        and delegate from then on (blocking get/put stay blocking)."""
        import queue as _q
        q = self._fallback
        if q is None:
            q = self._fallback = _q.Queue(self.maxsize)
            for item in self._items:
                q.put_nowait(item)
            self._items = []
        return q

    def qsize(self) -> int:
        if self._fallback is not None:
            return self._fallback.qsize()
        return len(self._items)

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        if self._fallback is not None:
            return self._fallback.full()
        return 0 < self.maxsize <= len(self._items)

    def put(self, item, block: bool = True, timeout: float | None = None):
        rt = self._rt
        if not self._live():
            if self._escaped():
                self._esc().put(item, block, timeout)
            else:
                self._items.append(item)
            return
        cur = rt.current_task()
        rt.yield_point(f"queue.put {self.name}")
        while self.full():
            if not block:
                raise sync.Full
            deadline = None if timeout is None else rt.clock + timeout
            self._putters.append(cur)
            if rt.block("queue", self, f"queue.put {self.name}",
                        deadline=deadline):
                raise sync.Full
        self._items.append(item)
        if self._getters:
            t = self._getters.pop(0)
            rt._wake(t, timed_out=False)
            t.pending = f"queue.get {self.name} (item ready)"

    def put_nowait(self, item):
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: float | None = None):
        rt = self._rt
        if not self._live():
            if self._escaped():
                return self._esc().get(block, timeout)
            if self._items:
                return self._items.pop(0)
            raise sync.Empty     # mid-run unwind: never block
        cur = rt.current_task()
        rt.yield_point(f"queue.get {self.name}")
        while not self._items:
            if not block:
                raise sync.Empty
            deadline = None if timeout is None else rt.clock + timeout
            self._getters.append(cur)
            if rt.block("queue", self, f"queue.get {self.name}",
                        deadline=deadline):
                raise sync.Empty
        item = self._items.pop(0)
        if self._putters:
            t = self._putters.pop(0)
            rt._wake(t, timed_out=False)
            t.pending = f"queue.put {self.name} (space ready)"
        return item

    def get_nowait(self):
        return self.get(block=False)


class TThread:
    """Twin of ``threading.Thread`` for scenario-spawned logical
    threads.  ``start`` registers a scheduler task; ``join`` blocks
    through the scheduler (virtual-time deadline)."""

    def __init__(self, rt: Runtime, group=None, target=None, name=None,
                 args=(), kwargs=None, *, daemon=None):
        self._rt = rt
        self._target = target
        self._args = args
        self._kwargs = kwargs or {}
        self.name = name or f"thread-{len(rt.tasks)}"
        self.daemon = bool(daemon)
        self._task: Task | None = None

    def start(self) -> None:
        rt = self._rt
        if self._task is not None:
            raise RuntimeError("threads can only be started once")
        if not rt._managed():
            # escape hatch: spawn a real thread (run over / unmanaged)
            t = _threading.Thread(target=self._target, name=self.name,
                                  args=self._args, kwargs=self._kwargs,
                                  daemon=self.daemon)
            self._task = t
            t.start()
            return
        task = rt.spawn_task(self.name, self._target, self._args,
                             self._kwargs)
        task.daemon = self.daemon
        self._task = task
        rt.start_task(task)

    def join(self, timeout: float | None = None) -> None:
        rt = self._rt
        task = self._task
        if task is None:
            raise RuntimeError("cannot join thread before it is started")
        if isinstance(task, _threading.Thread):
            task.join(timeout)
            return
        if not rt._managed():
            # escaped join: fall through to the underlying OS thread
            if rt.finished and task.thread is not None:
                task.thread.join(timeout)
            return
        rt.yield_point(f"join {task.name}")
        if task.state == DONE:
            return
        deadline = None if timeout is None else rt.clock + timeout
        rt.block("join", task, f"join {task.name}", deadline=deadline)

    def is_alive(self) -> bool:
        task = self._task
        if task is None:
            return False
        if isinstance(task, _threading.Thread):
            return task.is_alive()
        return task.state in (RUNNABLE, BLOCKED)

    @property
    def ident(self):
        return None if self._task is None else id(self._task)


# ---------------------------------------------------------------------------
# install / run
# ---------------------------------------------------------------------------


def _twin_factories(rt: Runtime) -> dict:
    """The sync.install map: managed callers get twins, everyone else
    keeps real stdlib objects (so an install is safe in a process with
    unrelated live threads)."""
    def gate(twin_ctor, real_ctor):
        def make(*a, **k):
            if rt._managed():
                return twin_ctor(rt, *a, **k)
            return real_ctor(*a, **k)
        return make

    import queue as _q

    def v_monotonic():
        return rt.vmonotonic() if rt._managed() else _time.monotonic()

    def v_wall():
        return rt.vwall() if rt._managed() else _time.time()

    def v_sleep(s):
        if float(s) < 0:
            # stdlib parity: time.sleep(negative) raises — the twin
            # must too, or schedcheck can never catch the
            # negative-sleep-kills-the-thread bug class
            raise ValueError("sleep length must be non-negative")
        if rt._managed():
            rt.yield_point(f"sleep {s:g}")
            rt.block("sleep", None, f"sleep {s:g}",
                     deadline=rt.clock + float(s))
        else:
            _time.sleep(s)

    def cond(lock=None):
        if rt._managed():
            if lock is None or isinstance(lock, TLock):
                return TCondition(rt, lock)
        return _threading.Condition(lock)

    return {
        "Lock": gate(TLock, _threading.Lock),
        "RLock": gate(TRLock, _threading.RLock),
        "Condition": cond,
        "Event": gate(TEvent, _threading.Event),
        "Semaphore": gate(TSemaphore, _threading.Semaphore),
        "BoundedSemaphore": gate(TBoundedSemaphore,
                                 _threading.BoundedSemaphore),
        "Thread": gate(TThread, _threading.Thread),
        "Queue": gate(TQueue, _q.Queue),
        "monotonic": v_monotonic,
        "wall": v_wall,
        "sleep": v_sleep,
    }


def run_controlled(scenario: str, scenario_fn, strategy: Strategy, *,
                   max_steps: int = 4000) -> RunResult:
    """Run ``scenario_fn(rt)`` as task 0 under ``strategy``; returns
    the RunResult (failure captured, never raised — explorers decide
    what a failure means)."""
    rt = Runtime(scenario, strategy, max_steps=max_steps)
    main = rt._register_main()
    sync.install(_twin_factories(rt), owner=rt)
    try:
        try:
            scenario_fn(rt)
            # drain any still-running started tasks so a run's side
            # effects are complete before invariants/teardown compare
            rt.await_until(
                lambda: all(t.state in (NEW, DONE)
                            for t in rt.tasks if t is not main),
                "all tasks done")
        except _TaskAbort:
            pass
        except InvariantViolation as e:
            if rt.failure is None:
                rt.failure = Failure("invariant", str(e))
        except ScheduleDivergence as e:
            if rt.failure is None:
                rt.failure = Failure("divergence", str(e))
        except Exception as e:  # noqa: BLE001 — scenario bug or real finding
            if rt.failure is None:
                rt.failure = Failure(
                    "exception", f"main died: {type(e).__name__}: {e}")
    finally:
        rt.finished = True
        rt._aborting = True
        for t in rt.tasks:
            if t is not main:
                t.abort = True
                t.gate.set()
        sync.uninstall(owner=rt)
        for t in rt.tasks:
            if t.thread is not None and t is not main:
                t.thread.join(timeout=5.0)
    return RunResult(scenario=scenario, failure=rt.failure,
                     steps=rt.steps, decisions=rt.decisions,
                     clock=rt.clock, tasks=[t.name for t in rt.tasks])
