"""Config <-> CLI <-> docs parity lint + ``distlr_tpu_torch/CONFIG.md``
generator (the port's copy of ``distlr_tpu/analysis/config_doc.py``; the
JAX package's reference stays ``docs/CONFIG.md``).

The same bidirectional style as the metrics-doc lint, applied to the
configuration surface: every :class:`distlr_tpu_torch.config.Config`
field must be reachable from the port's ``launch`` CLI (an
``add_argument`` whose dest is the field, an audited alias, or an
audited NO_FLAG entry saying WHY not) and documented in the generated
``distlr_tpu_torch/CONFIG.md``; and
every doc row / audit entry must still correspond to a live field.
Everything is read statically (``ast`` — no torch, no argparse import).

Regenerate the doc after changing Config or the CLI::

    python -m distlr_tpu_torch.analysis --write-docs
"""

from __future__ import annotations

import ast
import os
import re

from distlr_tpu_torch.analysis.report import Finding, repo_root

#: Config field -> the launch flag DEST that carries it when they are
#: deliberately named differently (subcommand-scoped flags predating the
#: serve_*/route_* prefixes).  An alias naming a dead dest or a dead
#: field is itself a finding.
FLAG_ALIASES = {
    "serve_port": "port",
    "serve_host": "bind",
    "serve_max_wait_ms": "max_wait_ms",
    "serve_reload_interval_s": "reload_interval",
    "serve_hot_rows": "hot_rows",
    "serve_hot_min_coverage": "hot_min_coverage",
    "serve_hot_full_every": "hot_full_every",
    "serve_engine_idle_evict_s": "engine_idle_evict",
    "feedback_spool_dir": "feedback_spool",
    "feedback_shard_dir": "feedback_shards",
    "feedback_window_s": "feedback_window",
    "feedback_drift_block": "drift_block",
    "feedback_drift_threshold": "drift_threshold",
    "serve_model_id": "model_id",
    "route_quota": "quota",
    "route_port": "port",
    "route_host": "bind",
    "route_max_inflight": "max_inflight",
    "route_eject_after": "eject_after",
    "route_health_interval_s": "health_interval",
    "route_probe_backoff_s": "probe_backoff",
    "route_probe_backoff_max_s": "probe_backoff_max",
    "route_backend_timeout_s": "backend_timeout",
}

#: Config fields with deliberately NO CLI flag, each with the audit
#: reason (an entry for a field that gained a flag, or stopped
#: existing, is a finding).
NO_FLAG = {
    "sync_mode": "selected by the subcommand, not a flag: `launch sync` "
                 "is sync, `launch ps` is BSP, `launch ps --async` is "
                 "Hogwild",
    "l2_scale_by_batch": "per-quirk gate set via --compat-mode "
                         "(reference parity, SURVEY.md Q4); individual "
                         "flags would invite mixed quirk states the "
                         "parity suite never pins",
    "sync_last_gradient": "per-quirk gate set via --compat-mode (Q1)",
    "reference_rng_init": "per-quirk gate set via --compat-mode (Q2)",
    "wrap_final_batch": "per-quirk gate set via --compat-mode (Q5)",
    "compute_dtype": "the kernels' product dtype: model-internal tuning "
                     "set programmatically (the card checks run both), "
                     "not an operator knob; the operational knob the CLI "
                     "exposes is --feature-dtype",
    "mesh_shape": "derived from --num-workers x --feature-shards "
                  "(_config_from_args), never set directly",
    "ps_host": "reference env-var contract (DMLC_PS_ROOT_URI via "
               "Config.from_env); local launches use ephemeral ports "
               "and multi-host passes explicit --hosts",
    "ps_port": "reference env-var contract (DMLC_PS_ROOT_PORT), same "
               "as ps_host",
}


def config_path() -> str:
    return os.path.join(repo_root(), "distlr_tpu_torch", "config.py")


def launch_path() -> str:
    return os.path.join(repo_root(), "distlr_tpu_torch", "launch.py")


def doc_path() -> str:
    return os.path.join(repo_root(), "distlr_tpu_torch", "CONFIG.md")


# ---------------------------------------------------------------------------
# static extraction
# ---------------------------------------------------------------------------


def config_fields(path: str | None = None) -> dict[str, dict]:
    """Config dataclass fields -> {line, default, help} — the help text
    harvested from the comment block above (or inline with) the field,
    the way the dataclass is actually documented."""
    path = path or config_path()
    with open(path) as f:
        src = f.read()
    lines = src.splitlines()
    tree = ast.parse(src, filename=path)
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "Config")
    out: dict[str, dict] = {}
    for node in cls.body:
        if not isinstance(node, ast.AnnAssign) or not isinstance(
                node.target, ast.Name):
            continue
        name = node.target.id
        default = ast.unparse(node.value) if node.value is not None else ""
        # inline comment, else the contiguous # block immediately above
        text = lines[node.lineno - 1]
        m = re.search(r"#\s?(.*)$", text)
        help_parts: list[str] = []
        if m and not text.lstrip().startswith("#"):
            help_parts.append(m.group(1).strip())
        i = node.lineno - 2
        block: list[str] = []
        while i >= 0:
            stripped = lines[i].strip()
            if stripped.startswith("#") and not stripped.startswith("# --"):
                block.append(stripped.lstrip("#").strip())
                i -= 1
            else:
                break
        help_parts = list(reversed(block)) + help_parts
        out[name] = {
            "line": node.lineno,
            "default": default,
            "help": " ".join(p for p in help_parts if p),
        }
    return out


def launch_dests(path: str | None = None) -> dict[str, dict]:
    """Every ``add_argument`` in launch.py -> dest: {flag, line}.  When
    several subcommands reuse one dest, the first flag wins (they are
    the same knob by construction)."""
    path = path or launch_path()
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out: dict[str, dict] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            continue
        flags = [a.value for a in node.args
                 if isinstance(a, ast.Constant) and isinstance(a.value, str)
                 and a.value.startswith("--")]
        if not flags:
            continue
        dest = None
        for kw in node.keywords:
            if kw.arg == "dest" and isinstance(kw.value, ast.Constant):
                dest = kw.value.value
        if dest is None:
            dest = flags[0].lstrip("-").replace("-", "_")
        out.setdefault(dest, {"flag": flags[0], "line": node.lineno})
    return out


def documented_fields(text: str | None = None) -> dict[str, str]:
    """distlr_tpu_torch/CONFIG.md rows -> {field: flag-column-text}."""
    if text is None:
        try:
            with open(doc_path()) as f:
                text = f.read()
        except OSError:
            return {}
    rows = re.findall(r"^\| `([a-z0-9_]+)` \| ([^|]*) \|", text,
                      flags=re.MULTILINE)
    return {name: flag.strip() for name, flag in rows}


# ---------------------------------------------------------------------------
# doc generation
# ---------------------------------------------------------------------------


def _flag_for(field: str, dests: dict[str, dict]) -> str | None:
    if field in dests:
        return dests[field]["flag"]
    alias = FLAG_ALIASES.get(field)
    if alias is not None and alias in dests:
        return dests[alias]["flag"]
    return None


def generate() -> str:
    fields = config_fields()
    dests = launch_dests()
    lines = [
        "# Config reference (PyTorch/CUDA port)",
        "",
        "Every `distlr_tpu_torch.config.Config` field, its",
        "`python -m distlr_tpu_torch.launch` flag, default, and meaning.",
        "GENERATED — do not edit by hand:",
        "",
        "    python -m distlr_tpu_torch.analysis --write-docs",
        "",
        "regenerates this file from the dataclass + the launch parser;",
        "the config-parity lint (`python -m distlr_tpu_torch.analysis`,",
        "held by tests/test_torch_analysis.py) fails when field, flag,",
        "and doc drift in any direction.  Fields marked *(no flag)* are",
        "audited as CLI-less in `distlr_tpu_torch/analysis/config_doc.py`",
        "(NO_FLAG), each with its reason.  The JAX package's reference",
        "is `docs/CONFIG.md`.",
        "",
        "| field | flag | default | meaning |",
        "|---|---|---|---|",
    ]
    for name, meta in fields.items():
        flag = _flag_for(name, dests)
        if flag is None:
            flag_txt = "*(no flag)*"
        else:
            flag_txt = f"`{flag}`"
        help_txt = meta["help"].replace("|", "\\|")
        if name in NO_FLAG:
            help_txt = (help_txt + " — *no flag:* "
                        + NO_FLAG[name].replace("|", "\\|")).strip(" —")
        default = meta["default"].replace("|", "\\|")
        lines.append(
            f"| `{name}` | {flag_txt} | `{default}` | {help_txt} |")
    lines.append("")
    return "\n".join(lines)


def write_doc() -> str:
    path = doc_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    text = generate()
    with open(path, "w") as f:
        f.write(text)
    return path


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------


def check() -> list[Finding]:
    fields = config_fields()
    dests = launch_dests()
    crel = os.path.relpath(config_path(), repo_root())
    lrel = os.path.relpath(launch_path(), repo_root())
    drel = os.path.relpath(doc_path(), repo_root())
    findings: list[Finding] = []

    # every field reaches the CLI, or carries an audited reason not to
    for name, meta in fields.items():
        if _flag_for(name, dests) is None and name not in NO_FLAG:
            findings.append(Finding(
                "config", f"config-no-flag:{name}",
                f"Config.{name} has no launch flag (no dest matches, no "
                "FLAG_ALIASES entry, no audited NO_FLAG reason)",
                ((crel, meta["line"]),)))

    # audit hygiene: aliases and NO_FLAG entries must stay live
    for field, dest in FLAG_ALIASES.items():
        if field not in fields:
            findings.append(Finding(
                "config", f"alias-stale-field:{field}",
                f"FLAG_ALIASES maps dead Config field {field!r}",
                ((crel, 1),)))
        elif dest not in dests:
            findings.append(Finding(
                "config", f"alias-stale-dest:{field}",
                f"FLAG_ALIASES maps {field!r} to dest {dest!r}, which no "
                "launch add_argument defines",
                ((lrel, 1),)))
    for field in NO_FLAG:
        if field not in fields:
            findings.append(Finding(
                "config", f"noflag-stale:{field}",
                f"NO_FLAG audits dead Config field {field!r}",
                ((crel, 1),)))
        elif field in dests:
            findings.append(Finding(
                "config", f"noflag-has-flag:{field}",
                f"NO_FLAG audits {field!r} as CLI-less but launch now "
                f"defines {dests[field]['flag']} — delete the entry",
                ((lrel, dests[field]["line"]),)))

    # doc sync, both directions (regenerate to fix)
    doc = documented_fields()
    if not doc:
        findings.append(Finding(
            "config", "config-doc-missing",
            "distlr_tpu_torch/CONFIG.md missing — run "
            "`python -m distlr_tpu_torch.analysis --write-docs`",
            ((drel, 1),)))
        return findings
    for name, meta in fields.items():
        if name not in doc:
            findings.append(Finding(
                "config", f"undocumented-field:{name}",
                f"Config.{name} is missing from distlr_tpu_torch/CONFIG.md — "
                "regenerate it", ((crel, meta["line"]), (drel, 1))))
            continue
        flag = _flag_for(name, dests)
        want = f"`{flag}`" if flag else "*(no flag)*"
        if doc[name] != want:
            findings.append(Finding(
                "config", f"doc-flag-drift:{name}",
                f"distlr_tpu_torch/CONFIG.md lists {name} under {doc[name]!r} but "
                f"the CLI says {want!r} — regenerate",
                ((drel, 1),)))
    for name in doc:
        if name not in fields:
            findings.append(Finding(
                "config", f"stale-doc-row:{name}",
                f"distlr_tpu_torch/CONFIG.md documents {name} but Config has no such "
                "field — regenerate", ((drel, 1),)))
    return findings
