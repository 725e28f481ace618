"""distlr-lint — the port's static-analysis subsystem (its copy of
``distlr_tpu/analysis/``).

One runner (``python -m distlr_tpu_torch.analysis``; ``--only <pass>``
runs one in isolation, ``--list-passes`` lists them), eight passes, each
held on the CPU by ``tests/test_torch_analysis.py``:

* **wire parity** (:mod:`distlr_tpu_torch.analysis.wire_parity`) —
  parse the port's ``ps/native/kv_protocol.h`` (op codes, flag bits,
  capability bits, stats counts, quant block, frame sizes, magic) and
  cross-check every Python mirror site against it.  A constant that
  exists on one side only, disagrees in value, or is re-inlined as a
  raw literal instead of a :mod:`distlr_tpu_torch.ps.wire` name fails
  with ``file:line`` on both sides.
* **concurrency** (:mod:`distlr_tpu_torch.analysis.concurrency`) — an
  AST pass building a per-class shared-state registry (attributes
  written under a ``with self.<lock>`` in one method but touched
  lock-free in another, on classes whose instances cross threads) plus
  a cross-module lock-acquisition-order graph with cycle detection.
  Intentional races are named and justified in
  ``analysis/concurrency_baseline.toml``; anything unsuppressed fails.
* **config/CLI/docs parity** (:mod:`distlr_tpu_torch.analysis.config_doc`)
  — every :class:`~distlr_tpu_torch.config.Config` field has a
  ``launch`` flag and a row in the generated
  ``distlr_tpu_torch/CONFIG.md`` and vice versa.
* **metrics doc** — :mod:`distlr_tpu_torch.obs.metrics_doc`'s drift
  lint, folded under this runner.
* **print ban** (:mod:`distlr_tpu_torch.analysis.printban`) — no bare
  ``print(`` or ``sys.stderr.write`` outside an audited allowlist.
* **schedcheck** (:mod:`distlr_tpu_torch.analysis.schedcheck`) — the
  real fleet classes (batcher, joiner, spool, router, reloader,
  membership coordinator, shadow mirror, chaos link, tsdb, autopilot,
  fleet log) execute under a cooperative deterministic scheduler via
  the :mod:`distlr_tpu_torch.sync` facade — preemption-bounded
  exhaustive DFS + seeded fuzzing per scenario, deadlock detection with
  wait-for cycles, and mutant rediscovery of the joiner and ChaosLink
  teardown races as replayable ≤ 20-step schedules.
* **protocol** (:mod:`distlr_tpu_torch.analysis.protocol`) — bounded
  exhaustive search of an executable spec of the KV protocol (its
  identities from :mod:`distlr_tpu_torch.ps.wire`), rediscovery of the
  two reverted historical fixes, and conformance replay of the port's
  banked chaos-run fixtures.
* **fleetsim** (:mod:`distlr_tpu_torch.analysis.fleetsim`) — seeded
  discrete-event fleet scenarios driving the real autopilot, balance,
  reshard and SLO policies: pinned digests and the three policy-bug
  mutants.

Nothing here imports torch (the protocol model's wire mirror brings
numpy): lint runs without the card and without building anything, and
only ``protocol.witness`` starts the live PS stack.
"""

from distlr_tpu_torch.analysis.report import Finding  # noqa: F401
