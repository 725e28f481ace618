"""Pass 8 of distlr-lint: the fleetsim sweep.

Runs every registered fleet scenario at the pinned seed and the three
policy-bug mutants, converting anything unexpected into
:class:`~distlr_tpu_torch.analysis.report.Finding`s:

* a property violation — a REAL control-plane bug with its replay id
  (``fleetsim:<scenario>:<seed>``) in the message (fix the policy, or
  pin the counterexample as a mutant and fix in the same change; there is
  deliberately no suppression mechanism for violations);
* digest drift — a scenario no longer reproduces its pinned
  ``EXPECTED_DIGESTS`` entry, meaning the simulated fleet's dynamics
  changed; re-pin deliberately (a reviewable one-line diff) if the
  change is intended;
* nondeterminism — the same seed + scenario produced two different
  logs, which breaks replay, the mutant suite, and the tests at once;
* a mutant problem — a reverted policy fix that is no longer
  rediscovered, rediscovered as the wrong bug, or whose
  counterexample fails byte-identical replay.

The deep tier (a multi-seed fuzz sweep per scenario) lives behind
``python -m distlr_tpu_torch.analysis.fleetsim --fuzz N`` (``--full``).
"""

from __future__ import annotations

import contextlib
import logging

from distlr_tpu_torch.analysis.report import Finding
from distlr_tpu_torch.analysis.fleetsim import mutants, scenarios

#: fuzz seeds per scenario inside the DEEP lint tier (the CLI's
#: ``--fuzz`` runs arbitrary widths; this keeps ``--full`` bounded)
DEEP_FUZZ_SEEDS = 5


@contextlib.contextmanager
def quiet_logs():
    """The scenarios drive the REAL daemon/SLO classes, whose health
    logging (actuator outcomes, burn alerts) is meaningless noise
    across a sweep — silence it for the pass."""
    logging.disable(logging.WARNING)
    try:
        yield
    finally:
        logging.disable(logging.NOTSET)


def check_scenario(name: str, *, deep: bool = False) -> list[Finding]:
    with quiet_logs():
        return _check_scenario(name, deep=deep)


def _check_scenario(name: str, *, deep: bool) -> list[Finding]:
    out: list[Finding] = []
    res = scenarios.run_scenario(name, 0)
    for v in res.violations:
        out.append(Finding(
            "fleetsim", f"scenario-violation:{name}",
            f"{v} — replay with `python -m distlr_tpu_torch.analysis.fleetsim "
            f"--replay '{res.replay_id}'`"))
    if res.violations:
        return out
    again = scenarios.run_scenario(name, 0)
    if again.digest != res.digest:
        out.append(Finding(
            "fleetsim", f"scenario-nondeterministic:{name}",
            f"same seed produced digests {res.digest} then "
            f"{again.digest} — something leaked wall clock, set order, "
            "or unseeded randomness into the event log"))
        return out
    want = mutants.EXPECTED_DIGESTS.get(name)
    if want is not None and res.digest != want:
        out.append(Finding(
            "fleetsim", f"scenario-drift:{name}",
            f"digest {res.digest} != pinned {want} — the simulated "
            "fleet's dynamics changed; re-pin EXPECTED_DIGESTS "
            "deliberately if intended"))
    if deep:
        for seed in range(1, DEEP_FUZZ_SEEDS + 1):
            r = scenarios.run_scenario(name, seed)
            for v in r.violations:
                out.append(Finding(
                    "fleetsim", f"scenario-fuzz-violation:{name}",
                    f"{v} — replay with `python -m "
                    f"distlr_tpu_torch.analysis.fleetsim --replay "
                    f"'{r.replay_id}'`"))
    return out


def check(*, deep: bool = False) -> list[Finding]:
    findings: list[Finding] = []
    with quiet_logs():
        for name in scenarios.SCENARIOS:
            findings.extend(_check_scenario(name, deep=deep))
        for name in mutants.MUTANTS:
            for problem in mutants.verify_mutant(name):
                findings.append(
                    Finding("fleetsim", f"mutant:{name}", problem))
    return findings
