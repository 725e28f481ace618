"""Protocol model checking — the semantic half of distlr-lint.

The syntactic passes lint the port (wire-constant parity, lock
discipline, doc drift).  This package makes it verify itself
*semantically*: the two serious bugs in the protocol's history — the
barrier double-vote early release, and the re-issued straddling push
now absorbed as ``push_outcome_unknown`` — were protocol INTERLEAVING
bugs that chaos testing stumbled onto rather than analysis ruled out.
Three parts:

* **executable spec** (:mod:`~distlr_tpu_torch.analysis.protocol.spec`) — a
  small-step state machine of the KV protocol: client handles with
  per-connection negotiation (kHello capability intersection, epoch
  announce), server tables + barrier vote sets with
  generation/connection rollback, the retry ladder with
  ``kv_op_delivery_began`` semantics, and membership resize
  (spawn -> fence -> drain -> commit -> activate).  Written against
  :mod:`distlr_tpu_torch.ps.wire` — the ONE Python protocol mirror — so the
  wire-parity pass covers it for free.
* **explicit-state model checker**
  (:mod:`~distlr_tpu_torch.analysis.protocol.checker`) — exhaustive BFS over
  interleavings of small configurations (2 clients x 2 servers, one
  resize, one injected fault from the chaos fault alphabet) with state
  hashing and invariant checks.  Counterexamples pretty-print as
  step-by-step schedules.  Mutant mode
  (:mod:`~distlr_tpu_torch.analysis.protocol.mutants`) reverts the named
  historical fixes and must rediscover each as a counterexample — a
  spec that cannot find known bugs is not verifying anything.
* **trace conformance**
  (:mod:`~distlr_tpu_torch.analysis.protocol.conformance`) — replay a real
  run's artifacts (dtrace span journals, the chaos proxy's canonical
  event log, ``distlr_kv_server --trace_journal`` spans) through the
  model's observable rules, so every existing chaos/elastic e2e
  doubles as a conformance witness.  Violations cite ``file:line``.

Entry points: the ``protocol`` pass of ``python -m distlr_tpu_torch.analysis``
(bounded exploration + mutant rediscovery + fixture conformance, fast
enough for the CPU tests) and ``python -m
distlr_tpu_torch.analysis.protocol`` (full-depth, prints schedules).
Everything here but ``witness`` is torch-free and import-light, like
the rest of ``analysis/``.
"""

from distlr_tpu_torch.analysis.protocol.checker import CheckResult, explore  # noqa: F401
from distlr_tpu_torch.analysis.protocol.spec import Scenario, Spec  # noqa: F401
