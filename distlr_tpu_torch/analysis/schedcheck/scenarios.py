"""Schedcheck scenarios: the port's highest-risk REAL classes under
controlled interleavings (JAX's twelve scenarios, by the same names, on
the port's classes).

Each scenario builds real production objects (through the
:mod:`distlr_tpu_torch.sync` facade, so their locks/threads are the
instrumented twins), races a handful of logical threads over them,
and checks interleaving-independent invariants — anything the
invariants reject under SOME schedule is a real concurrency bug with
a replayable counterexample.

Scenario scope is honest about the runtime's limits: classes whose
concurrency lives in pure-Python state (locks, lists, dicts, queues,
events) run verbatim; where a class touches the OS mid-race (the
chaos proxy's sockets, the router's probe dial) the scenario
substitutes a *scripted endpoint* behind the class's seam methods
while every line that actually races — lock ordering, list
registration, teardown joins — stays the real code.  Classes that
cannot run here at all (the card-holding ``ScoringEngine``,
process-spawning ``ServerGroup``) are declared ``schedcheck_scenario
= "-"`` in the concurrency baseline instead — the cross-reference the
lint enforces.  (``chip_smoke.py``'s ``sched`` phase drives a
``MicroBatcher`` in front of the card engine under this runtime; that
is a card check, not a registered scenario.)

Every scenario also runs :func:`assert_facade`: the concurrency
lint's shared-state registry (``analysis/concurrency.py``) knows
which attributes of a class are its locks, and schedcheck asserts
those attributes resolved to instrumented twins — a module that
silently reverts from ``sync`` to raw ``threading`` fails its
scenario before it can un-instrument its own races.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import socket
import tempfile
import threading as _real_threading

from distlr_tpu_torch import sync
from distlr_tpu_torch.analysis.schedcheck.runtime import (
    DONE,
    NEW,
    InvariantViolation,
    Runtime,
    TCondition,
    TLock,
    TRLock,
)

# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    fn: object
    #: "path/module.py:Class" labels this scenario exercises — the
    #: concurrency baseline's ``schedcheck_scenario`` cross-reference
    #: is validated against these
    classes: tuple[str, ...]
    #: fast-tier exhaustive search (must close in seconds)
    dfs_bound: int = 1
    dfs_runs: int = 2500
    #: deep tier (`--full`): higher bound,
    #: bigger run budget, and this many fuzz seeds (the fast lint pass
    #: uses lint.LINT_FUZZ_SEEDS instead)
    deep_bound: int = 2
    deep_runs: int = 60_000
    fuzz_seeds: int = 25
    max_steps: int = 4000


SCENARIOS: dict[str, Scenario] = {}


def scenario(name: str, classes: tuple[str, ...], **kw):
    def deco(fn):
        SCENARIOS[name] = Scenario(name=name, fn=fn, classes=classes, **kw)
        return fn
    return deco


def names() -> tuple[str, ...]:
    return tuple(SCENARIOS)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

_LINT_CLASSES: dict[tuple[str, str], object] | None = None


def _lint_registry() -> dict[tuple[str, str], object]:
    global _LINT_CLASSES
    if _LINT_CLASSES is None:
        from distlr_tpu_torch.analysis import concurrency
        _LINT_CLASSES = {(c.module, c.name): c
                         for c in concurrency.collect_classes()}
    return _LINT_CLASSES


def assert_facade(obj, label: str) -> None:
    """``label`` is ``"path/module.py:Class"``.  Every lock attribute
    the concurrency lint's shared-state registry records for that
    class must be an instrumented twin on ``obj`` — the facade-drift
    detector."""
    module, _, cls = label.partition(":")
    info = _lint_registry().get((module, cls))
    if info is None:
        raise InvariantViolation(
            f"{label} is not in the concurrency lint's class registry — "
            "scenario and lint disagree about what exists")
    for attr in sorted(info.lock_attrs):
        val = getattr(obj, attr, None)
        if not isinstance(val, (TLock, TRLock, TCondition)):
            raise InvariantViolation(
                f"{label}.{attr} is {type(val).__name__}, not an "
                "instrumented twin — the class no longer creates this "
                "lock through distlr_tpu_torch.sync, so schedcheck cannot "
                "control (or verify) its interleavings")


@contextlib.contextmanager
def _workdir():
    d = tempfile.mkdtemp(prefix="schedcheck-")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise InvariantViolation(msg)


# ---------------------------------------------------------------------------
# 1 + 2. MicroBatcher — coalesce/flush and the close race
# ---------------------------------------------------------------------------


def _mk_batcher(max_batch_size=4, max_wait_ms=10.0):
    import numpy as np
    from distlr_tpu_torch.serve.batcher import MicroBatcher

    def score(merged):
        n = merged[0].shape[0]
        return (np.zeros(n, np.int32),
                merged[0].reshape(n, -1).sum(axis=1).astype(np.float32))

    return np, MicroBatcher(score, max_batch_size=max_batch_size,
                            max_wait_ms=max_wait_ms)


@scenario("batcher_coalesce",
          ("distlr_tpu_torch/serve/batcher.py:MicroBatcher",),
          dfs_runs=4000)
def scn_batcher_coalesce(rt: Runtime) -> None:
    """Two submitters race the flush thread: every future must resolve
    with exactly its own rows' scores, whatever the coalescing."""
    np, b = _mk_batcher()
    assert_facade(b, "distlr_tpu_torch/serve/batcher.py:MicroBatcher")
    futs: list[tuple[float, object]] = []

    def submit(v):
        futs.append((v, b.submit((np.full((1, 2), v, np.float32),))))

    t1 = sync.Thread(target=submit, args=(1.0,), name="submit-a")
    t2 = sync.Thread(target=submit, args=(2.0,), name="submit-b")
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    rt.await_until(lambda: all(f.done() for _, f in futs), "futures done")
    b.close()
    for v, f in futs:
        _labels, scores = f.result(timeout=0)
        _check(float(scores[0]) == 2 * v,
               f"request {v:g} got score {float(scores[0]):g}, "
               f"want {2 * v:g} — cross-request slice corruption")
    _check(b.requests == 2 and b.rows == 2,
           f"accounting drift: requests={b.requests} rows={b.rows}, "
           "want 2/2")


@scenario("batcher_close_flush",
          ("distlr_tpu_torch/serve/batcher.py:MicroBatcher",),
          dfs_runs=4000)
def scn_batcher_close_flush(rt: Runtime) -> None:
    """submit() racing close(): an ACCEPTED request must resolve (a
    closing batcher drains, it never strands a future); a request
    after close must be refused loudly."""
    np, b = _mk_batcher(max_batch_size=8, max_wait_ms=50.0)
    out: dict = {}

    def submit():
        try:
            out["fut"] = b.submit((np.ones((1, 2), np.float32),))
        except RuntimeError:
            out["refused"] = True

    t = sync.Thread(target=submit, name="submitter")
    t.start()
    b.close()
    t.join()
    if "fut" in out:
        rt.await_until(out["fut"].done, "accepted future done")
        _labels, scores = out["fut"].result(timeout=0)
        _check(float(scores[0]) == 2.0,
               "accepted-then-closed future resolved wrong")
    else:
        _check(out.get("refused", False),
               "submit neither accepted nor refused")
    _check(not b._thread.is_alive(), "flush thread alive after close()")


# ---------------------------------------------------------------------------
# 3. LabelJoiner — label vs request vs window expiry
# ---------------------------------------------------------------------------


def _mk_joiner(workdir, *, window_s=60.0, negative_rate=1.0):
    from distlr_tpu_torch.feedback.join import LabelJoiner
    from distlr_tpu_torch.feedback.spool import FeedbackSpool

    spool = FeedbackSpool(os.path.join(workdir, "spool"), capacity=16)
    joiner = LabelJoiner(spool, os.path.join(workdir, "shards"),
                         window_s=window_s, negative_rate=negative_rate,
                         shard_records=64, seed=0)
    return spool, joiner


def _rec(rid: str, ts: float):
    from distlr_tpu_torch.feedback.spool import SpoolRecord
    return SpoolRecord(rid=rid, ts=ts, line="1:1", score=0.5, version=1)


@scenario("joiner_label_race",
          ("distlr_tpu_torch/feedback/join.py:LabelJoiner",),
          dfs_runs=4000)
def scn_joiner_label_race(rt: Runtime) -> None:
    """The joiner's guarantee: a request and its label that BOTH arrive
    inside the window must join, under every interleaving of the
    scorer, the labeler and the expiry ticker — a label may never
    strand in the pending buffer while its request negative-samples
    away."""
    with _workdir() as wd:
        spool, joiner = _mk_joiner(wd)
        assert_facade(joiner, "distlr_tpu_torch/feedback/join.py:LabelJoiner")
        assert_facade(spool, "distlr_tpu_torch/feedback/spool.py:FeedbackSpool")
        base = sync.wall()

        def scorer():
            joiner.scored(_rec("r1", base))
            joiner.scored(_rec("r2", base))     # never labeled

        def labeler():
            out = joiner.label("r1", 1, ts=base + 1.0)
            _check(out in ("joined", "pending"),
                   f"label outcome {out!r} for a first in-window label")

        def ticker():
            joiner.tick(now=base + 20.0)        # inside window: no-op

        tasks = [sync.Thread(target=scorer, name="scorer"),
                 sync.Thread(target=labeler, name="labeler"),
                 sync.Thread(target=ticker, name="ticker")]
        for t in tasks:
            t.start()
        for t in tasks:
            t.join()
        joiner.tick(now=base + 1000.0)          # everything resolves
        _check(joiner.joined == 1,
               f"label and request both in-window but joined="
               f"{joiner.joined} (negatives={joiner.negatives}, "
               f"pending={len(joiner._pending)}) — the label stranded")
        _check(joiner.negatives == 1,
               f"never-labeled r2 must negative-sample: negatives="
               f"{joiner.negatives}")
        _check(len(joiner._pending) == 0,
               f"{len(joiner._pending)} label(s) still pending after "
               "full expiry")


# ---------------------------------------------------------------------------
# 4. FeedbackSpool — capacity eviction vs expiry vs pop vs rotation
# ---------------------------------------------------------------------------


@scenario("spool_evict_rotation",
          ("distlr_tpu_torch/feedback/spool.py:FeedbackSpool",),
          dfs_runs=4000)
def scn_spool_evict_rotation(rt: Runtime) -> None:
    """Record conservation under pressure: with capacity 2 and journal
    segments of 2, two adders race an expirer and a popper — every
    record must end up in exactly one of {evicted, expired, popped,
    resident}, and the on-disk segment count must hold its bound."""
    from distlr_tpu_torch.feedback.spool import FeedbackSpool

    with _workdir() as wd:
        spool = FeedbackSpool(wd, capacity=2, segment_records=2,
                              max_segments=2, evict_scan=2)
        assert_facade(spool, "distlr_tpu_torch/feedback/spool.py:FeedbackSpool")
        base = sync.wall()
        out = {"expired": 0, "popped": 0}

        def add_a():
            spool.add(_rec("r1", base + 1))
            spool.add(_rec("r2", base + 2))

        def add_b():
            spool.add(_rec("r3", base + 3))
            spool.add(_rec("r4", base + 4))

        def expirer():
            out["expired"] += len(spool.expire_before(base + 2.5))

        def popper():
            if spool.pop("r3") is not None:
                out["popped"] += 1

        tasks = [sync.Thread(target=add_a, name="add-a"),
                 sync.Thread(target=add_b, name="add-b"),
                 sync.Thread(target=expirer, name="expirer"),
                 sync.Thread(target=popper, name="popper")]
        for t in tasks:
            t.start()
        for t in tasks:
            t.join()
        left = len(spool)
        total = spool.evicted + out["expired"] + out["popped"] + left
        _check(spool.spooled == 4, f"spooled={spool.spooled}, want 4")
        _check(total == 4,
               f"conservation broke: evicted={spool.evicted} "
               f"expired={out['expired']} popped={out['popped']} "
               f"resident={left} (sum {total}, want 4)")
        _check(left <= 2, f"capacity bound broke: {left} resident > 2")
        segs = [n for n in os.listdir(wd) if n.startswith("spool-")]
        _check(len(segs) <= 2,
               f"journal rotation bound broke: {len(segs)} segments")
        spool.close()


# ---------------------------------------------------------------------------
# 5. ScoringRouter — eject / reinstate vs in-flight vs membership
# ---------------------------------------------------------------------------

_RESPONDER: tuple[str, object] | None = None


def _stats_responder() -> str:
    """One process-wide REAL (unmanaged) STATS responder the router's
    probe can dial.  It answers every line with ``{}`` — deterministic
    probe success.  Deliberately uses raw ``threading``: it must stay
    outside the scheduler (a managed task doing real socket IO against
    it completes without a baton handoff)."""
    global _RESPONDER
    if _RESPONDER is not None:
        return _RESPONDER[0]
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(32)

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            try:
                f = conn.makefile("rwb")
                if f.readline():
                    f.write(b"{}\n")
                    f.flush()
            except OSError:
                pass
            finally:
                conn.close()

    t = _real_threading.Thread(target=serve, daemon=True,
                               name="schedcheck-stats-responder")
    t.start()
    addr = "127.0.0.1:%d" % srv.getsockname()[1]
    _RESPONDER = (addr, srv)
    return addr


@scenario("router_eject_inflight",
          ("distlr_tpu_torch/serve/router.py:ScoringRouter",
           "distlr_tpu_torch/serve/router.py:_Replica"),
          dfs_runs=6000, max_steps=6000)
def scn_router_eject_inflight(rt: Runtime) -> None:
    """Ejection/reinstatement racing in-flight accounting and elastic
    ADDREPLICA/DELREPLICA: in-flight budgets must balance, removal
    must never break a request already holding the replica, and
    healthy must stay consistent with the eject/reinstate history."""
    from distlr_tpu_torch.serve.router import ScoringRouter

    live = _stats_responder()
    dead = "127.0.0.1:9"               # nothing listens: probe refused
    router = ScoringRouter([dead, live], max_inflight=1, eject_after=1,
                           seed=0)
    assert_facade(router, "distlr_tpu_torch/serve/router.py:ScoringRouter")
    reps = {r.addr: r for r in router.replicas}
    assert_facade(reps[dead], "distlr_tpu_torch/serve/router.py:_Replica")
    model = router.default_model

    def worker_fail():
        for _ in range(2):
            rep = router._acquire([])
            if rep is not None:
                router._note_failure(rep)
                router._release(rep)

    def worker_ok():
        rep = router._acquire([])
        if rep is not None:
            router._note_success(rep)
            router._release(rep)

    def admin():
        router.add_replica(model, "127.0.0.1:11")
        router.remove_replica(model, dead)

    def prober():
        router._probe(reps[live])

    tasks = [sync.Thread(target=worker_fail, name="worker-fail"),
             sync.Thread(target=worker_ok, name="worker-ok"),
             sync.Thread(target=admin, name="admin"),
             sync.Thread(target=prober, name="prober")]
    try:
        for t in tasks:
            t.start()
        for t in tasks:
            t.join()
        for rep in set(list(reps.values()) + router.replicas):
            _check(rep.inflight == 0,
                   f"replica {rep.addr}: inflight={rep.inflight} after "
                   "all requests released")
            _check(rep._sem._value == 1,
                   f"replica {rep.addr}: in-flight semaphore "
                   f"value={rep._sem._value}, want 1 — budget leak")
            _check(rep.healthy == (rep.ejections == rep.reinstates),
                   f"replica {rep.addr}: healthy={rep.healthy} but "
                   f"ejections={rep.ejections} reinstates="
                   f"{rep.reinstates} — eject/reinstate alternation "
                   "broke")
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# 6. HotReloader — poll loop vs wait_for_weights vs stop
# ---------------------------------------------------------------------------


class _FakeEngine:
    def __init__(self):
        self.versions: list[int] = []
        self.has_weights = False

    def set_weights(self, w) -> None:
        self.versions.append(int(w))
        self.has_weights = True


class _FakeSource:
    """poll() fails once (degraded path) then publishes versions."""

    def __init__(self):
        self.calls = 0
        self.closed = False

    def poll(self):
        self.calls += 1
        if self.calls == 1:
            raise RuntimeError("transient source blip")
        return self.calls, self.calls

    def close(self) -> None:
        self.closed = True


@scenario("reloader_poll_swap",
          ("distlr_tpu_torch/serve/reload.py:HotReloader",),
          dfs_runs=4000, max_steps=6000)
def scn_reloader_poll_swap(rt: Runtime) -> None:
    """The poll loop racing a foreground wait_for_weights and stop():
    versions swap monotonically, every swap is accounted, the one
    seeded source error lands in the degraded counter, and stop joins
    the loop."""
    from distlr_tpu_torch.serve.reload import HotReloader

    eng, src = _FakeEngine(), _FakeSource()
    r = HotReloader(eng, src, interval_s=1.0, jitter=0.0, _seed=0)
    assert_facade(r, "distlr_tpu_torch/serve/reload.py:HotReloader")
    out: dict = {}

    def waiter():
        try:
            r.wait_for_weights(timeout_s=30.0)
            out["waited"] = True
        except TimeoutError:
            out["waited"] = False

    r.start()
    t = sync.Thread(target=waiter, name="waiter")
    t.start()
    rt.await_until(lambda: r.reloads >= 2, "two reloads")
    t.join()
    r.stop()
    _check(out.get("waited") is True,
           "wait_for_weights timed out while the source was publishing")
    _check(eng.versions == sorted(eng.versions),
           f"weight versions went backwards: {eng.versions}")
    _check(len(eng.versions) == r.reloads,
           f"swap accounting drift: engine saw {len(eng.versions)} "
           f"swaps, reloader counted {r.reloads}")
    _check(r.errors == 1,
           f"seeded single source error counted {r.errors} times")
    _check(not r._thread.is_alive(), "poll loop alive after stop()")
    _check(src.closed, "source not closed by stop()")


# ---------------------------------------------------------------------------
# 7. MembershipCoordinator — resize vs client reroute reads
# ---------------------------------------------------------------------------


class _FakePlan:
    def __init__(self, new_n: int):
        self.new_n = new_n
        self.moves: list = []
        self.reuse: dict = {}
        self.spawn: list = []
        self.retire: list = []
        self.moved_keys = 0
        self.new_ranges: dict = {}


class _FakeGroup:
    """The ServerGroup surface resize() touches, minus processes and
    sockets (``ports`` empty, so fence/drain have nothing to dial) —
    the coordinator's own locking and publication order is what runs
    for real."""

    def __init__(self, num_servers=2, dim=8):
        self.num_servers = num_servers
        self.dim = dim
        self.epoch = 0
        self.has_ftrl = False
        self.ports: list[int] = []

    @property
    def hosts(self) -> str:
        return ",".join(f"127.0.0.1:{7000 + r}"
                        for r in range(self.num_servers))

    def plan_resize(self, n: int):
        if n <= 0:
            raise ValueError("bad target")
        return _FakePlan(n)

    def spawn_for_resize(self, plan, epoch) -> dict:
        return {}

    def commit_resize(self, plan, staged, epoch) -> None:
        self.num_servers = plan.new_n


@scenario("membership_resize_reroute",
          ("distlr_tpu_torch/ps/membership.py:MembershipCoordinator",),
          dfs_runs=6000, max_steps=6000)
def scn_membership_resize_reroute(rt: Runtime) -> None:
    """resize() racing layout()/epoch/status() readers (the client
    reroute path) and a second resize: epochs observed by any reader
    are non-decreasing, an 'active' layout snapshot is always a
    CONSISTENT (epoch, num_servers) pair, and overlapping resizes are
    either serialized or refused loudly."""
    from distlr_tpu_torch.ps.membership import (
        MembershipCoordinator,
        MembershipError,
    )

    group = _FakeGroup(num_servers=2)
    coord = MembershipCoordinator(group)
    assert_facade(coord,
                  "distlr_tpu_torch/ps/membership.py:MembershipCoordinator")
    results: list[dict] = []
    refused = {"n": 0}
    snaps: list[list[dict]] = [[], []]

    def resizer(n):
        try:
            results.append(coord.resize(n))
        except MembershipError:
            refused["n"] += 1

    def reader(i):
        for _ in range(2):
            snaps[i].append(coord.layout())

    tasks = [sync.Thread(target=resizer, args=(4,), name="resize-4"),
             sync.Thread(target=resizer, args=(8,), name="resize-8"),
             sync.Thread(target=reader, args=(0,), name="reader-a"),
             sync.Thread(target=reader, args=(1,), name="reader-b")]
    for t in tasks:
        t.start()
    for t in tasks:
        t.join()
    _check(len(results) + refused["n"] == 2,
           "a resize neither completed nor raised")
    allowed = {(0, 2)} | {(r["epoch"], r["num_servers"]) for r in results}
    for i, seen in enumerate(snaps):
        epochs = [s["epoch"] for s in seen]
        _check(epochs == sorted(epochs),
               f"reader {i} observed epochs going backwards: {epochs}")
        for s in seen:
            if s["status"] == "active":
                pair = (s["epoch"],
                        len(s["hosts"].split(",")) if s["hosts"] else 0)
                _check(pair in allowed,
                       f"reader {i} saw TORN active layout {pair}; "
                       f"consistent pairs: {sorted(allowed)}")
    _check(coord.epoch == len(results),
           f"final epoch {coord.epoch} != {len(results)} completed "
           "resizes")


# ---------------------------------------------------------------------------
# 8. ShadowMirror — submit vs worker vs stop
# ---------------------------------------------------------------------------


@scenario("shadow_mirror_stop",
          ("distlr_tpu_torch/serve/tenant.py:ShadowMirror",),
          dfs_runs=4000, max_steps=6000)
def scn_shadow_mirror_stop(rt: Runtime) -> None:
    """Two submitters race the mirror worker and stop(): every
    submitted mirror is processed, queued-at-stop, or was refused at
    submit — never silently lost twice-counted — and the worker thread
    never outlives stop()."""
    from distlr_tpu_torch.serve.tenant import ShadowMirror

    sm = ShadowMirror(lambda model, line: '{"scores": [0.5]}',
                      queue_max=2, block=8)
    assert_facade(sm, "distlr_tpu_torch/serve/tenant.py:ShadowMirror")
    accepted = {"n": 0, "refused": 0}

    def submitter():
        for _ in range(2):
            if sm.submit("v1", "v2", "1:1", [0.4]):
                accepted["n"] += 1
            else:
                accepted["refused"] += 1

    t1 = sync.Thread(target=submitter, name="submit-a")
    t2 = sync.Thread(target=submitter, name="submit-b")
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    sm.stop()
    leftover = len(sm._queue)
    attempts = accepted["n"] + accepted["refused"]
    _check(sm.submitted == accepted["n"],
           f"submit() True {accepted['n']} times but submitted="
           f"{sm.submitted}")
    # FULL conservation: every attempted mirror is mirrored, errored,
    # still queued, or counted dropped (refused at submit OR shed by a
    # stop() landing mid-batch — the silent-shed accounting hole was
    # schedcheck's first real finding, fixed in serve/tenant.py)
    _check(sm.mirrored + sm.errors + leftover + sm.dropped == attempts,
           f"mirror accounting broke: mirrored={sm.mirrored} "
           f"errors={sm.errors} queued={leftover} dropped={sm.dropped} "
           f"attempts={attempts}")
    _check(sm.errors == 0, f"deterministic exchange errored {sm.errors}x")
    _check(not sm._thread.is_alive(), "mirror worker alive after stop()")


# ---------------------------------------------------------------------------
# 9. ChaosLink — stop() vs a concurrently-accepted connection
# ---------------------------------------------------------------------------


class _ScriptClosed:
    pass


class _ScriptedListener:
    """Stands in for the link's listener socket: accept() pops scripted
    connections from an instrumented queue (so the accept loop blocks
    through the scheduler), close() delivers the OSError the real
    closed listener would."""

    def __init__(self):
        self._q = sync.Queue()

    def feed(self, pair) -> None:
        self._q.put(pair)

    def accept(self):
        item = self._q.get()
        if isinstance(item, _ScriptClosed):
            self._q.put(item)      # stay closed for later accepts
            raise OSError("listener closed")
        return item

    def close(self) -> None:
        # kernel semantics: closing a listener RSTs backlog connections
        # the app never accept()ed — they die with the listener and are
        # nobody's teardown responsibility.  Only connections DELIVERED
        # through accept() become the link's to close.
        while True:
            try:
                item = self._q.get_nowait()
            except sync.Empty:
                break
            if not isinstance(item, _ScriptClosed):
                item[0].close()
        self._q.put(_ScriptClosed())

    def getsockname(self):
        return ("127.0.0.1", 0)

    def settimeout(self, t) -> None:
        pass


class _FakeSock:
    """EOF-on-read socket twin: pump threads spawned over it run their
    real teardown path immediately; close() is observable."""

    def __init__(self):
        self.closed = False

    def settimeout(self, t) -> None:
        pass

    def setsockopt(self, *a) -> None:
        pass

    def fileno(self) -> int:
        return -1 if self.closed else 99

    def recv(self, n) -> bytes:
        if self.closed:
            raise OSError("closed")
        return b""

    def sendall(self, data) -> None:
        pass

    def shutdown(self, how) -> None:
        pass

    def close(self) -> None:
        self.closed = True


class _FakeFabric:
    def now(self) -> float:
        return sync.monotonic()

    def record(self, *a, **k) -> None:
        pass


def _scripted_link():
    from distlr_tpu_torch.chaos.plan import FaultPlan
    from distlr_tpu_torch.chaos.proxy import ChaosLink

    made: list[_FakeSock] = []

    class _ScriptedLink(ChaosLink):
        # only the two ENDPOINT seams are substituted; the accept
        # loop, registration, pumps and stop() are the real code
        def _listen(self):
            return _ScriptedListener()

        def _connect_upstream(self):
            s = _FakeSock()
            made.append(s)
            return s

    link = _ScriptedLink(0, ("127.0.0.1", 9), FaultPlan(), _FakeFabric())
    return link, made


@scenario("chaoslink_stop_accept",
          ("distlr_tpu_torch/chaos/proxy.py:ChaosLink",),
          dfs_runs=4000, max_steps=6000)
def scn_chaoslink_stop_accept(rt: Runtime) -> None:
    """stop() racing the accept loop mid-connection (the teardown fix):
    once stop() returns, no pump thread may still be live and every
    accepted socket pair must be closed — under EVERY interleaving of
    the accept processing and the teardown."""
    link, made = _scripted_link()
    assert_facade(link, "distlr_tpu_torch/chaos/proxy.py:ChaosLink")
    down = _FakeSock()
    link._lsock.feed((down, ("127.0.0.1", 1)))

    def stopper():
        link.stop()

    t = sync.Thread(target=stopper, name="stopper")
    t.start()
    t.join()
    # the instant stop() has returned: teardown must be COMPLETE
    alive = sorted(task.name for task in rt.tasks
                   if task.name.startswith("chaos-")
                   and task.state not in (NEW, DONE))
    _check(not alive,
           f"pump/accept thread(s) {alive} still live after stop() "
           "returned — the teardown lost a concurrently-accepted "
           "connection")
    unclosed = [i for i, s in enumerate([down] + made) if not s.closed]
    _check(not unclosed,
           f"socket(s) {unclosed} not closed after stop() — the "
           "snapshot missed a concurrently-registered connection")


# ---------------------------------------------------------------------------
# 10. FleetTSDB — scrape-tick writer vs /query reader vs rule evaluator
# ---------------------------------------------------------------------------


def _tsdb_frame(i: int) -> dict:
    return {"updated": 10.0 * (i + 1),
            "ranks": [{"role": "route", "rank": 0,
                       "route_requests": 100.0 * (i + 1),
                       "route_shed": 0.0}],
            "totals": {"samples_per_s": 5.0}}


@scenario("tsdb_write_query_rollup",
          ("distlr_tpu_torch/obs/tsdb.py:FleetTSDB",),
          dfs_runs=4000, max_steps=6000)
def scn_tsdb_write_query_rollup(rt: Runtime) -> None:
    """The scrape-tick writer racing a /query reader, the recording-
    rule evaluator, and lock-free stats() monitoring: ingest is atomic
    (a query sees a frame PREFIX, so every mid-race rate is a rate some
    serial history produces — here always 10/s once two frames exist),
    the rule's derived point lands under the store's lock, the
    monotonic stats counters never run backwards, and the final state
    is frame-count deterministic whatever the interleaving."""
    from distlr_tpu_torch.obs.tsdb import FleetTSDB, RecordingRule

    db = FleetTSDB(raw_points=4, rollup_retention_s=1000.0)
    assert_facade(db, "distlr_tpu_torch/obs/tsdb.py:FleetTSDB")
    rule = RecordingRule("fleet:req_rate", "rate(route_requests)", 100.0)
    queried: list = []

    def writer():
        for i in range(3):
            db.ingest(_tsdb_frame(i))

    def querier():
        for _ in range(2):
            queried.append(db.query("rate(route_requests)",
                                    window_s=100.0))

    def ruler():
        now = db.latest_time()
        if now is not None:
            rule.evaluate(db, now)

    def monitor():
        a = db.stats()
        b = db.stats()
        _check(b["points"] >= a["points"] and b["frames"] >= a["frames"],
               f"monotonic stats ran backwards: {a} -> {b}")

    tasks = [sync.Thread(target=writer, name="scrape-writer"),
             sync.Thread(target=querier, name="query-reader"),
             sync.Thread(target=ruler, name="rule-eval"),
             sync.Thread(target=monitor, name="monitor")]
    for t in tasks:
        t.start()
    for t in tasks:
        t.join()
    for q in queried:
        _check(q is None or q == 10.0,
               f"torn mid-race rate {q!r}: every frame prefix yields "
               "None (<2 frames) or exactly 10.0/s")
    _check(db.query("rate(route_requests)", window_s=100.0) == 10.0,
           "final rate drifted from the serial value")
    st = db.stats()
    # 3 frames x (2 rank fields + 1 total) + at most one rule point
    want = (9, 10)
    _check(st["frames"] == 3 and st["points"] in want,
           f"final accounting drifted: {st} (want frames=3, "
           f"points in {want})")
    _check(sum(st["dropped"].values()) == 0,
           f"bounded-tier eviction miscounted under no pressure: {st}")


# ---------------------------------------------------------------------------
# 12. AutopilotDaemon — tick loop vs stop() vs lock-free status reads
# ---------------------------------------------------------------------------


class _ScriptedFleet:
    """fetch() seam: fails once (the fail-safe hold path), then serves
    a fleet doc whose shard_lag keeps the worker band breached."""

    def __init__(self):
        self.calls = 0

    def __call__(self) -> dict:
        self.calls += 1
        if self.calls == 1:
            raise OSError("aggregator not up yet")
        return {"ranks": [{"role": "online", "rank": 0, "shard_lag": 10.0,
                           "pushes": 100.0 * self.calls,
                           "route_shed": 0.0, "route_requests": 0.0}]}


class _ScriptedWorkerActuator:
    """The worker actuator surface, minus subprocesses."""

    def __init__(self):
        self.n = 1
        self.scales: list[int] = []
        self.stopped = False

    def current(self) -> int:
        return self.n

    def scale(self, target: int) -> str:
        self.scales.append(int(target))
        self.n = int(target)
        return "ok"

    def stop_all(self) -> None:
        self.stopped = True


@scenario("autopilot_tick_stop",
          ("distlr_tpu_torch/autopilot/daemon.py:AutopilotDaemon",),
          dfs_runs=4000, max_steps=6000)
def scn_autopilot_tick_stop(rt: Runtime) -> None:
    """The autopilot's tick loop racing concurrent lock-free status()
    reads and a stop(): the loop survives the seeded fetch failure
    (fail-safe hold, not a crash), the tick/action counters stay
    consistent with the last decision, stop() joins the loop and
    closes the actuators under EVERY interleaving."""
    from distlr_tpu_torch.autopilot import (
        Actuators,
        AutopilotDaemon,
        PolicyConfig,
        PolicyEngine,
    )

    worker = _ScriptedWorkerActuator()
    policy = PolicyEngine(PolicyConfig(hysteresis_ticks=1, cooldown_s=0.0))
    d = AutopilotDaemon(policy, Actuators(worker=worker),
                        fetch=_ScriptedFleet(), interval_s=0.01)
    assert_facade(d, "distlr_tpu_torch/autopilot/daemon.py:AutopilotDaemon")
    snaps: list[dict] = []

    def monitor():
        snaps.append(d.status())
        snaps.append(d.status())

    d.start()
    t = sync.Thread(target=monitor, name="monitor")
    t.start()
    rt.await_until(lambda: d.ticks >= 3, "three ticks")
    t.join()
    d.stop()
    _check(d._thread is None, "loop thread not joined by stop()")
    alive = sorted(task.name for task in rt.tasks
                   if task.name == "distlr-autopilot"
                   and task.state not in (NEW, DONE))
    _check(not alive, "autopilot loop still live after stop() returned")
    _check(worker.stopped, "actuators not closed by stop()")
    _check(d.ticks >= 3, f"tick counter lost updates: {d.ticks}")
    # the seeded fetch failure must surface as a held tick, not a crash
    _check(d.errors == 0,
           f"fail-safe hold misaccounted as actuator error: {d.errors}")
    _check(worker.scales and worker.scales[0] == 2,
           f"breached worker band never acted: {worker.scales}")
    _check(d.actions == len(worker.scales),
           f"action accounting drift: daemon {d.actions}, "
           f"actuator saw {len(worker.scales)}")
    for s in snaps:
        _check(0 <= s["actions"] <= s["ticks"] + 1,
               f"torn status() snapshot: {s}")


# ---------------------------------------------------------------------------
# 13. FleetLogger — emit writers vs flush vs incident collector vs stats
# ---------------------------------------------------------------------------


@scenario("log_ring_incident_assemble",
          ("distlr_tpu_torch/obs/log.py:FleetLogger",),
          dfs_runs=5000, max_steps=6000)
def scn_log_ring_incident_assemble(rt: Runtime) -> None:
    """The structured-log sink's emit path (ring append +
    dedupe + journal) raced against an explicit flush, the incident
    engine's journal collector, and the deliberately lock-free stats()
    monitor.  Invariants: a WARN+ record is on disk the moment emit
    returns (the eager-flush contract the incident collector relies
    on), so every collector snapshot is a subset of the final record
    set with no torn or phantom records; the dedupe table collapses
    same-template duplicates to exactly one journaled record whatever
    the interleaving; the ring holds the newest records; and the
    monotonic stats counters never run backwards."""
    from distlr_tpu_torch.obs import log as fleetlog
    from distlr_tpu_torch.obs.log import FleetLogger

    with _workdir() as d:
        fl = FleetLogger(d, "serve", 0, level="info", ring=4,
                         dedupe_s=0.0)
        assert_facade(fl, "distlr_tpu_torch/obs/log.py:FleetLogger")
        collected: list[list[dict]] = []

        def writer():
            for i in range(2):
                fl.emit("error", f"boom {i}", logger="scn")

        def flusher():
            fl.flush()

        def collector():
            collected.append(fleetlog.read_records(d, level="warning"))

        def monitor():
            a = fl.stats()
            b = fl.stats()
            _check(b["records"] >= a["records"]
                   and b["suppressed"] >= a["suppressed"],
                   f"monotonic stats ran backwards: {a} -> {b}")

        tasks = [sync.Thread(target=writer, name="emit-writer"),
                 sync.Thread(target=flusher, name="flusher"),
                 sync.Thread(target=collector, name="incident-collector"),
                 sync.Thread(target=monitor, name="monitor")]
        for t in tasks:
            t.start()
        for t in tasks:
            t.join()
        final = {r["msg"] for r in fleetlog.read_records(d)}
        _check(final == {"boom 0", "boom 1"},
               f"journal lost or tore records: {sorted(final)}")
        for snap in collected:
            msgs = [r["msg"] for r in snap]
            _check(set(msgs) <= final and len(msgs) == len(set(msgs)),
                   f"collector saw torn/phantom records: {msgs}")
        _check([r["msg"] for r in fl.tail(4)] == ["boom 0", "boom 1"],
               "ring order drifted from emit order")
        st = fl.stats()
        _check(st["records"] == 2 and st["suppressed"] == 0,
               f"accounting drifted: {st}")
        fl.close()

        # second act: the dedupe table under two racing writers with
        # the SAME template — exactly one journaled record carries the
        # window, the other three emits fold into suppressed counts,
        # first-writer-wins being schedule-dependent but the TOTALS not
        f2 = FleetLogger(d, "router", 0, level="info", ring=4,
                         dedupe_s=1000.0)

        def dup_writer():
            for _ in range(2):
                f2.emit("warning", "link flap", logger="scn")

        tasks = [sync.Thread(target=dup_writer, name="dup-a"),
                 sync.Thread(target=dup_writer, name="dup-b")]
        for t in tasks:
            t.start()
        for t in tasks:
            t.join()
        st = f2.stats()
        _check(st["records"] == 1 and st["suppressed"] == 3,
               f"dedupe accounting drifted under race: {st}")
        f2.close()
