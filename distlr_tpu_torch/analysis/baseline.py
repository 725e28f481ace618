"""Audited suppression baseline for the port's concurrency lint (the
port's copy of ``distlr_tpu/analysis/baseline.py``).

``distlr_tpu_torch/analysis/concurrency_baseline.toml`` names every
finding the port accepts ON PURPOSE — the Hogwild-intentional races and the
swap-whole-object publication patterns — and each entry REQUIRES a
one-line justification.  Hygiene is enforced both ways: an entry with
no justification is itself a finding, and a STALE entry (matching no
current finding) is too, so a suppression can never outlive the race it
was written for.

The file is parsed by the tiny TOML-subset reader below (the same
grammar JAX's copy reads, with no ``tomllib`` dependency):
``[[suppress]]`` table arrays of ``key = "..."`` /
``justification = "..."`` / ``schedcheck_scenario = "..."`` string
triples (all three REQUIRED — the scenario names the
:mod:`distlr_tpu_torch.analysis.schedcheck` scenario exercising the race, or
``"-"`` for classes schedcheck cannot run), comments, and blank lines
— which is the entire grammar the baseline needs.  A trailing ``*`` in
a key glob-matches, so one entry can cover every method of one
attribute.
"""

from __future__ import annotations

import dataclasses
import os
import re

from distlr_tpu_torch.analysis.report import Finding, rel, repo_root


@dataclasses.dataclass(frozen=True)
class Entry:
    key: str
    justification: str
    line: int
    #: the cross-reference: the schedcheck scenario that exercises this
    #: intentional race under controlled interleavings, or ``"-"`` for
    #: classes schedcheck cannot run (card-holding, process-spawning) — an explicit, audited statement either way
    scenario: str | None = None
    scenario_line: int = 0

    def matches(self, finding_key: str) -> bool:
        if self.key.endswith("*"):
            return finding_key.startswith(self.key[:-1])
        return finding_key == self.key


def default_path() -> str:
    return os.path.join(repo_root(), "distlr_tpu_torch", "analysis",
                        "concurrency_baseline.toml")


def _parse_string(raw: str, path: str, line: int) -> str:
    raw = raw.strip()
    if len(raw) < 2 or raw[0] not in "\"'" or raw[-1] != raw[0]:
        raise ValueError(
            f"{path}:{line}: baseline values must be quoted strings, "
            f"got {raw!r}")
    return raw[1:-1]


def load_baseline(path: str | None = None
                  ) -> tuple[list[Entry], list[Finding]]:
    """Parse the baseline; returns ``(entries, hygiene_problems)``.
    A missing file is an empty baseline (the passes then accept zero
    findings — the state a fully clean tree earns)."""
    path = path or default_path()
    if not os.path.exists(path):
        return [], []
    prel = rel(path) if os.path.isabs(path) else path
    entries: list[Entry] = []
    problems: list[Finding] = []
    cur: dict[str, tuple[str, int]] | None = None

    def flush(at_line: int) -> None:
        nonlocal cur
        if cur is None:
            return
        key = cur.get("key")
        just = cur.get("justification")
        scen = cur.get("schedcheck_scenario")
        if key is None:
            problems.append(Finding(
                "concurrency", f"baseline-no-key:{at_line}",
                "[[suppress]] entry has no key", ((prel, at_line),)))
        elif just is None or not just[0].strip():
            problems.append(Finding(
                "concurrency", f"baseline-no-justification:{key[0]}",
                f"baseline entry {key[0]!r} carries no justification — "
                "every suppression must say WHY the race is intentional",
                ((prel, key[1]),)))
        elif scen is None or not scen[0].strip():
            # every intentional race names the schedcheck
            # scenario that exercises it (or "-" with the class's
            # reason schedcheck cannot run it) — suppressions must be
            # tied to the machinery that would catch them going wrong
            problems.append(Finding(
                "concurrency", f"baseline-no-scenario:{key[0]}",
                f"baseline entry {key[0]!r} names no "
                "schedcheck_scenario — point it at the scenario that "
                "exercises this class under controlled interleavings, "
                "or '-' if the class cannot run under schedcheck "
                "(say why in the justification)",
                ((prel, key[1]),)))
        else:
            entries.append(Entry(key[0], just[0], key[1],
                                 scenario=scen[0], scenario_line=scen[1]))
        cur = None

    i = 0
    with open(path) as f:
        for i, raw in enumerate(f, start=1):
            # FULL-LINE comments only: a '#' inside a quoted
            # justification ("see note #2") is content, and splitting
            # on it would truncate the string mid-quote
            line = "" if raw.strip().startswith("#") else raw.strip()
            if not line:
                continue
            if line == "[[suppress]]":
                flush(i)
                cur = {}
                continue
            if "=" in line and cur is not None:
                name, _, val = line.partition("=")
                try:
                    cur[name.strip()] = (_parse_string(val, prel, i), i)
                except ValueError as e:
                    problems.append(Finding(
                        "concurrency", f"baseline-parse:{i}", str(e),
                        ((prel, i),)))
                continue
            problems.append(Finding(
                "concurrency", f"baseline-parse:{i}",
                f"unparseable baseline line {line!r} (the subset "
                "grammar is [[suppress]] + quoted key/justification)",
                ((prel, i),)))
    flush(i + 1)
    return entries, problems


def apply_baseline(findings: list[Finding], entries: list[Entry]
                   ) -> tuple[list[Finding], list[Finding]]:
    """Split findings by the baseline: returns ``(unsuppressed,
    stale-entry findings)``."""
    used: set[int] = set()
    kept: list[Finding] = []
    for f in findings:
        # EVERY matching entry counts as used, not just the first: a
        # broad glob listed before a narrower overlapping entry must not
        # make the narrow one read as "stale" — that would fail a tree
        # whose races are all audited, with a message claiming a live
        # race is gone.
        hits = [idx for idx, e in enumerate(entries) if e.matches(f.key)]
        if not hits:
            kept.append(f)
        else:
            used.update(hits)
    prel = rel(default_path())
    stale = [
        Finding("concurrency", f"baseline-stale:{e.key}",
                f"baseline entry {e.key!r} matches no current finding — "
                "the race it suppressed is gone; delete the entry",
                ((prel, e.line),))
        for idx, e in enumerate(entries) if idx not in used
    ]
    return kept, stale


_CLASS_RE = re.compile(r"^[a-z-]+:(?P<mod>[\w/.]+\.py):(?P<cls>\w+)")


def _entry_class(key: str) -> str | None:
    """``unlocked-read:path/mod.py:Class.attr[:method]`` ->
    ``path/mod.py:Class`` (None for keys not in that shape)."""
    m = _CLASS_RE.match(key)
    return f"{m.group('mod')}:{m.group('cls')}" if m else None


def scenario_crossref(entries: list[Entry]) -> list[Finding]:
    """Validate each entry's ``schedcheck_scenario`` against the live
    scenario registry — the staleness rule applied to the
    cross-reference.  ``"-"`` is the audited opt-out; a named
    scenario must exist AND declare the entry's class among the
    classes it exercises (a renamed/deleted scenario, or one that
    stopped covering the class, fails loudly instead of silently
    un-verifying the race)."""
    from distlr_tpu_torch.analysis.schedcheck import scenarios as sched_scenarios

    prel = rel(default_path())
    out: list[Finding] = []
    for e in entries:
        if e.scenario is None or e.scenario == "-":
            continue
        s = sched_scenarios.SCENARIOS.get(e.scenario)
        if s is None:
            out.append(Finding(
                "concurrency", f"baseline-stale-scenario:{e.key}",
                f"baseline entry {e.key!r} names schedcheck scenario "
                f"{e.scenario!r}, which does not exist (have: "
                f"{', '.join(sched_scenarios.names())}) — the "
                "cross-reference went stale",
                ((prel, e.scenario_line or e.line),)))
            continue
        cls = _entry_class(e.key)
        if cls is not None and cls not in s.classes:
            out.append(Finding(
                "concurrency", f"baseline-scenario-mismatch:{e.key}",
                f"baseline entry {e.key!r} names scenario "
                f"{e.scenario!r}, but that scenario does not exercise "
                f"{cls} (it covers: {', '.join(s.classes)})",
                ((prel, e.scenario_line or e.line),)))
    return out
