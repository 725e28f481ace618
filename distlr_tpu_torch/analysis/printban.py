"""print-ban lint: structured-log coverage can't silently regress (the
port's copy of ``distlr_tpu/analysis/printban.py``).

Log records are a first-class fleet signal — journaled, trace-stamped,
deduped, federated into incident bundles.  That only stays true if
daemon code keeps logging through the
``utils/logging.get_logger`` path (which the journal tee shadows);
a bare ``print(`` or ``sys.stderr.write`` in a serving or training
module is a narrative line the incident engine can never collect.

This pass AST-scans every module under ``distlr_tpu_torch/`` for ``print(``
calls and ``sys.stderr.write`` calls and flags them.  Legitimate
terminal output — the launch CLI's scriptable stdout contracts
(``METRICS``/``SERVING``/...), the lint runners' own reports, the
reference-format eval line — lives in the audited baseline
``analysis/printban_baseline.toml``: same grammar and hygiene rules as
the concurrency baseline (a justification is REQUIRED; a stale entry is
itself a finding), with keys at function granularity
(``print:<module>:<function>``) and a trailing ``*`` glob so one entry
can cover a CLI module.
"""

from __future__ import annotations

import ast
import os

from distlr_tpu_torch.analysis.report import Finding, rel, repo_root


def baseline_path() -> str:
    return os.path.join(repo_root(), "distlr_tpu_torch", "analysis",
                        "printban_baseline.toml")


def _is_stderr_write(node: ast.Call) -> bool:
    # sys.stderr.write(...) — the attribute chain, not a variable that
    # happens to hold the stream (the lint is syntactic, like the
    # concurrency registry)
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr == "write"
            and isinstance(f.value, ast.Attribute)
            and f.value.attr == "stderr"
            and isinstance(f.value.value, ast.Name)
            and f.value.value.id == "sys")


def _scan_file(path: str) -> dict[str, list[tuple[str, int]]]:
    """``{finding key: [(file, line), ...]}`` for one module."""
    try:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return {}
    prel = rel(path)
    hits: dict[str, list[tuple[str, int]]] = {}

    def visit(node: ast.AST, func: str) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        if isinstance(node, ast.Call):
            kind = None
            if isinstance(node.func, ast.Name) and node.func.id == "print":
                kind = "print"
            elif _is_stderr_write(node):
                kind = "stderr-write"
            if kind is not None:
                key = f"{kind}:{prel}:{func}"
                hits.setdefault(key, []).append((prel, node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child, func)

    visit(tree, "<module>")
    return hits


def collect() -> dict[str, list[tuple[str, int]]]:
    root = os.path.join(repo_root(), "distlr_tpu_torch")
    hits: dict[str, list[tuple[str, int]]] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if name.endswith(".py"):
                hits.update(_scan_file(os.path.join(dirpath, name)))
    return hits


# -- the audited baseline (concurrency-baseline grammar, two fields) -------

def _load_baseline() -> tuple[list[tuple[str, str, int]], list[Finding]]:
    """``[(key, justification, line)]`` + hygiene findings.  Subset
    grammar shared with the concurrency baseline: ``[[suppress]]``
    blocks of quoted ``key``/``justification`` pairs, full-line
    comments, blank lines."""
    path = baseline_path()
    if not os.path.exists(path):
        return [], []
    prel = rel(path)
    entries: list[tuple[str, str, int]] = []
    problems: list[Finding] = []
    cur: dict[str, tuple[str, int]] | None = None

    def flush(at_line: int) -> None:
        nonlocal cur
        if cur is None:
            return
        key = cur.get("key")
        just = cur.get("justification")
        if key is None:
            problems.append(Finding(
                "printban", f"baseline-no-key:{at_line}",
                "[[suppress]] entry has no key", ((prel, at_line),)))
        elif just is None or not just[0].strip():
            problems.append(Finding(
                "printban", f"baseline-no-justification:{key[0]}",
                f"baseline entry {key[0]!r} carries no justification — "
                "every allowlisted print must say WHY it is terminal "
                "output and not a log record", ((prel, key[1]),)))
        else:
            entries.append((key[0], just[0], key[1]))
        cur = None

    i = 0
    with open(path) as f:
        for i, raw in enumerate(f, start=1):
            line = "" if raw.strip().startswith("#") else raw.strip()
            if not line:
                continue
            if line == "[[suppress]]":
                flush(i)
                cur = {}
                continue
            if "=" in line and cur is not None:
                name, _, val = line.partition("=")
                val = val.strip()
                if len(val) < 2 or val[0] not in "\"'" or val[-1] != val[0]:
                    problems.append(Finding(
                        "printban", f"baseline-parse:{i}",
                        f"baseline values must be quoted strings, got "
                        f"{val!r}", ((prel, i),)))
                else:
                    cur[name.strip()] = (val[1:-1], i)
                continue
            problems.append(Finding(
                "printban", f"baseline-parse:{i}",
                f"unparseable baseline line {line!r}", ((prel, i),)))
    flush(i + 1)
    return entries, problems


def _matches(entry_key: str, finding_key: str) -> bool:
    if entry_key.endswith("*"):
        return finding_key.startswith(entry_key[:-1])
    return finding_key == entry_key


def check() -> list[Finding]:
    hits = collect()
    entries, problems = _load_baseline()
    findings: list[Finding] = list(problems)
    used: set[int] = set()
    for key in sorted(hits):
        idxs = [i for i, (ek, _j, _ln) in enumerate(entries)
                if _matches(ek, key)]
        if idxs:
            used.update(idxs)
            continue
        kind = key.split(":", 1)[0]
        what = ("bare print(" if kind == "print"
                else "sys.stderr.write(")
        findings.append(Finding(
            "printban", key,
            f"{what}...) outside the CLI-output allowlist — daemon "
            "narrative must go through utils/logging.get_logger so the "
            "structured-log journal (and incident bundles) see it; if "
            "this IS terminal output, allowlist it in "
            "printban_baseline.toml with a justification",
            tuple(hits[key])))
    prel = rel(baseline_path())
    for i, (ek, _j, ln) in enumerate(entries):
        if i not in used:
            findings.append(Finding(
                "printban", f"baseline-stale:{ek}",
                f"baseline entry {ek!r} matches no current print site — "
                "the output it allowlisted is gone; delete the entry",
                ((prel, ln),)))
    return findings
