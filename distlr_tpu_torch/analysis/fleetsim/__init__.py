"""Fleetsim: a deterministic discrete-event fleet simulator.

Every control-plane policy the port ships — the autopilot band
controller, the membership resize planner, the router's
eject/reinstate/least-in-flight logic, reloader polling, the
joiner/spool window machinery, the SLO engine's burn-rate math — is
otherwise only exercised at the ≤4-process shapes the tests can
spawn.  The dynamics that actually break such policies
(staleness growth with worker count, cascading ejections, controller
resonance with the diurnal curve) appear two orders of magnitude
beyond that.  Fleetsim points schedcheck's determinism discipline
outward: a seeded heap-based event loop drives thousand-rank fleet
scenarios in simulated time, composing the REAL policy classes against
MODELED processes.

What is REAL (imported, not reimplemented):

* :class:`~distlr_tpu_torch.autopilot.daemon.AutopilotDaemon` +
  :class:`~distlr_tpu_torch.autopilot.policy.PolicyEngine` — the daemon's
  own sensor reduction, rate windows, journal, and band arithmetic,
  fed a simulated ``fleet.json`` and a virtual clock;
* :mod:`distlr_tpu_torch.serve.balance` — the router's selection/ejection/
  probe policy, applied to simulated replicas;
* :func:`distlr_tpu_torch.ps.server.plan_reshard` — the membership
  planner's arithmetic, applied to thousand-rank layouts;
* :class:`~distlr_tpu_torch.obs.tsdb.FleetTSDB` +
  :class:`~distlr_tpu_torch.obs.slo.SLOEngine` — ingestion, rate/increase
  queries, and multi-window burn-rate alerting on the virtual clock;
* :class:`~distlr_tpu_torch.feedback.spool.FeedbackSpool` +
  :class:`~distlr_tpu_torch.feedback.join.LabelJoiner` — the delayed-label
  window machinery, driven with virtual timestamps;
* :mod:`distlr_tpu_torch.traffic` — the same diurnal/Zipf/label-delay
  arithmetic ``benchmarks/loadgen.py`` drives real sockets with.

What is MODELED: engines (capacity/latency as fluid queues), workers
(join/leave/push rates), PS migration time, the standby pool.  Models
emit the same ``fleet.json`` field names obs-agg federates, so the
policy code cannot tell it is simulated.

Determinism contract: identical seed + scenario ⇒ byte-identical
event log (and therefore digest and property verdicts).  Replay ids
are ``fleetsim:<scenario>:<seed>``; counterexamples are pinned in
:mod:`~distlr_tpu_torch.analysis.fleetsim.mutants` exactly like the
schedcheck/protocol mutant suites.

Run ``python -m distlr_tpu_torch.analysis.fleetsim --list`` (or
``launch fleetsim``) to see scenarios.
"""

from distlr_tpu_torch.analysis.fleetsim.events import EventLoop
from distlr_tpu_torch.analysis.fleetsim.scenarios import (
    SCENARIOS,
    run_scenario,
)

__all__ = ["EventLoop", "SCENARIOS", "run_scenario"]
