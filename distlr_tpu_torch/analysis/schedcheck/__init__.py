"""schedcheck — deterministic-interleaving execution of the port's real
Python fleet (the ``sched`` pass of distlr-lint; the port's copy of
``distlr_tpu/analysis/schedcheck/``).

The concurrency lint finds lock-discipline smells *syntactically*; this
package verifies the *implementation*: the port's real ``MicroBatcher``/
``LabelJoiner``/``FeedbackSpool``/``ScoringRouter``/``HotReloader``/
``MembershipCoordinator``/``ShadowMirror``/``ChaosLink``/``FleetTSDB``/
``AutopilotDaemon``/``FleetLogger`` classes run
single-stream under a cooperative scheduler
(:mod:`~distlr_tpu_torch.analysis.schedcheck.runtime`), with every
interleaving choice made by an explorer
(:mod:`~distlr_tpu_torch.analysis.schedcheck.explore`) instead of the OS:

* bounded-exhaustive DFS with CHESS-style preemption bounding;
* seeded random-schedule fuzzing, every run replayable by id;
* a deadlock detector printing the minimal wait-for cycle;
* per-scenario invariants
  (:mod:`~distlr_tpu_torch.analysis.schedcheck.scenarios`), cross-checked
  against the concurrency lint's shared-state registry;
* mutant mode (:mod:`~distlr_tpu_torch.analysis.schedcheck.mutants`):
  reverting the joiner's check-then-insert fix and the
  ``ChaosLink.stop()`` snapshot fix must each be REDISCOVERED as a
  ≤ 20-step replayable counterexample schedule.

Production code opts in by creating its primitives through the
:mod:`distlr_tpu_torch.sync` facade (zero-overhead stdlib passthrough in
normal runs).  Entry points: ``python -m
distlr_tpu_torch.analysis.schedcheck`` (fast tier; ``--full`` for the
deep DFS), and the ``sched`` pass of ``python -m
distlr_tpu_torch.analysis``.  Nothing here needs the card.
"""

from distlr_tpu_torch.analysis.schedcheck.runtime import (  # noqa: F401
    InvariantViolation,
    RunResult,
    parse_schedule_id,
)
