"""``distlr_tpu_torch/obs/METRICS.md`` generator and drift lint for the
port's ``distlr_*`` metric namespace (the port's copy of
``distlr_tpu/obs/metrics_doc.py``; the JAX package's reference stays
``docs/METRICS.md``).

* :func:`collect_registrations`: a static scan (``ast``, no imports, so
  the scan sees every series, even ones registered only on rare code
  paths) of every ``<registry>.counter/gauge/histogram("distlr_...",
  "help", ...)`` call under ``distlr_tpu_torch/``, keeping name, kind,
  label names, help text and the defining module.
* :func:`generate`: renders those into ``METRICS.md`` grouped by
  namespace prefix.

The lint (``tests/test_torch_fleet.py``) runs the same scan plus a raw
``distlr_[a-z0-9_]+`` string-literal grep over the sources and fails
when either direction drifts: a series emitted but missing from the
doc, or a doc entry whose series no longer exists.

Regenerate after adding or removing a series::

    python -m distlr_tpu_torch.obs.metrics_doc          # rewrites distlr_tpu_torch/obs/METRICS.md
    python -m distlr_tpu_torch.obs.metrics_doc --check  # lint only (exit 1 on drift)
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
import sys

#: registry factory method -> metric kind
_KINDS = {"counter": "counter", "gauge": "gauge", "histogram": "histogram"}

#: ``distlr_``-prefixed string literals that are NOT metric series
#: (binary/package names, doc prose); the literal grep skips these.
NON_METRIC_LITERALS = frozenset({
    "distlr_tpu_torch",
    "distlr_kv",          # native lib stem (libdistlr_kv.so)
    "distlr_kv_server",   # native server binary name
    "distlr_kv_server_tsan",
    "distlr_x_total",     # registry docstring example
    "distlr_torch_kv_server",  # the port's native server binary
    # entry points of the port's CUDA kernels (ops/)
    "distlr_lr_backward_plan", "distlr_lr_logits_int8dot",
    "distlr_roofline_const", "distlr_roofline_full", "distlr_roofline_fwd",
    "distlr_roofline_gen", "distlr_roofline_hash", "distlr_roofline_mxu",
})


@dataclasses.dataclass(frozen=True)
class Registration:
    name: str
    kind: str
    labels: tuple[str, ...]
    help: str
    module: str


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def _iter_py(pkg_dir: str):
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _const_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _tuple_strs(node) -> tuple[str, ...]:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for el in node.elts:
            s = _const_str(el)
            if s is None:
                return ()
            out.append(s)
        return tuple(out)
    return ()


def collect_registrations(pkg_dir: str | None = None) -> list[Registration]:
    """Every ``.counter/.gauge/.histogram("distlr_...", ...)`` call
    under the package, statically."""
    pkg_dir = pkg_dir or os.path.join(repo_root(), "distlr_tpu_torch")
    found: dict[str, Registration] = {}
    for path in _iter_py(pkg_dir):
        with open(path) as f:
            try:
                tree = ast.parse(f.read(), filename=path)
            except SyntaxError:
                continue
        module = os.path.relpath(path, repo_root())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _KINDS and node.args):
                continue
            name = _const_str(node.args[0])
            if name is None or not name.startswith("distlr_"):
                continue
            help_text = (_const_str(node.args[1])
                         if len(node.args) > 1 else None) or ""
            labels: tuple[str, ...] = ()
            if len(node.args) > 2:
                labels = _tuple_strs(node.args[2])
            for kw in node.keywords:
                if kw.arg == "labelnames":
                    labels = _tuple_strs(kw.value)
            prev = found.get(name)
            if prev is None or (not prev.help and help_text):
                found[name] = Registration(
                    name=name, kind=_KINDS[node.func.attr], labels=labels,
                    help=" ".join(help_text.split()), module=module)
    return sorted(found.values(), key=lambda r: r.name)


def collect_literals(pkg_dir: str | None = None) -> dict[str, list[str]]:
    """Every ``distlr_[a-z0-9_]+`` string literal in the package (the
    grep half of the lint) -> the modules mentioning it.  Catches a
    series emitted through a name the AST scan cannot see (f-strings,
    concatenation) — those should be rare and documented by hand."""
    pkg_dir = pkg_dir or os.path.join(repo_root(), "distlr_tpu_torch")
    pat = re.compile(r'"(distlr_[a-z0-9_]+)"')
    out: dict[str, list[str]] = {}
    for path in _iter_py(pkg_dir):
        module = os.path.relpath(path, repo_root())
        with open(path) as f:
            for name in pat.findall(f.read()):
                # a trailing underscore names a namespace PREFIX used in
                # prose/format strings ("distlr_alert_" + name), never a
                # series
                if name in NON_METRIC_LITERALS or name.endswith("_"):
                    continue
                out.setdefault(name, [])
                if module not in out[name]:
                    out[name].append(module)
    return out


#: namespace prefix -> section heading, in render order
_SECTIONS = (
    ("distlr_ps_", "Parameter server (client + server lifecycle)"),
    ("distlr_train_", "Training loops"),
    ("distlr_serve_", "Serving tier (engine / batcher / front-end)"),
    ("distlr_route_", "Routing front-end"),
    ("distlr_feedback_", "Feedback loop (spool / join / online trainer)"),
    ("distlr_chaos_", "Chaos fault injection"),
    ("distlr_fleet_", "Fleet federation meta-series"),
    ("distlr_tsdb_", "Embedded fleet time-series store"),
    ("distlr_slo_", "SLO engine (error budgets / burn rates)"),
    ("distlr_alert_", "Derived alert gauges"),
    ("distlr_autopilot_", "Fleet autopilot (closed-loop scaling)"),
    ("distlr_log_", "Structured fleet logging"),
    ("distlr_incident_", "Incident engine (bundles / postmortems)"),
    ("distlr_trace_", "Distributed tracing"),
    ("distlr_prof_", "Continuous profiling"),
    ("distlr_jax_", "Runtime introspection (the JAX package's series names)"),
    ("distlr_kv_server_", "Native KV-server runtime"),
    ("distlr_phase_", "Phase tracing"),
)


def generate(regs: list[Registration] | None = None) -> str:
    regs = collect_registrations() if regs is None else regs
    lines = [
        "# distlr_* metric reference",
        "",
        "Every Prometheus series the fleet emits, one row per family.",
        "GENERATED — do not edit by hand:",
        "",
        "    python -m distlr_tpu_torch.obs.metrics_doc",
        "",
        "regenerates this file from the registration sites of",
        "`distlr_tpu_torch/`; the lint (`tests/test_torch_fleet.py`) fails",
        "when code and doc drift in either direction.  Scrape endpoints: every launch",
        "subcommand serves `/metrics` (+ `/metrics.json`) with",
        "`--metrics-port`/`--obs-run-dir`; `launch obs-agg` federates the",
        "fleet (counters sum, histograms merge, gauges gain role/rank).",
        "",
    ]
    used: set[str] = set()
    for prefix, title in _SECTIONS:
        rows = [r for r in regs
                if r.name.startswith(prefix) and r.name not in used]
        if not rows:
            continue
        used.update(r.name for r in rows)
        lines += [f"## {title}", "",
                  "| series | kind | labels | meaning |",
                  "|---|---|---|---|"]
        for r in rows:
            labels = ", ".join(r.labels) if r.labels else "—"
            lines.append(
                f"| `{r.name}` | {r.kind} | {labels} | {r.help} |")
        lines.append("")
    rest = [r for r in regs if r.name not in used]
    if rest:
        lines += ["## Other", "",
                  "| series | kind | labels | meaning |",
                  "|---|---|---|---|"]
        for r in rest:
            labels = ", ".join(r.labels) if r.labels else "—"
            lines.append(
                f"| `{r.name}` | {r.kind} | {labels} | {r.help} |")
        lines.append("")
    return "\n".join(lines)


def doc_path() -> str:
    return os.path.join(repo_root(), "distlr_tpu_torch", "obs", "METRICS.md")


def documented_names(text: str | None = None) -> set[str]:
    if text is None:
        try:
            with open(doc_path()) as f:
                text = f.read()
        except OSError:
            return set()
    return set(re.findall(r"`(distlr_[a-z0-9_]+)`", text))


def check() -> list[str]:
    """Both lint directions; returns human-readable problems ([] = ok)."""
    regs = collect_registrations()
    reg_names = {r.name for r in regs}
    doc = documented_names()
    problems = []
    for r in regs:
        if r.name not in doc:
            problems.append(
                f"undocumented series {r.name} (registered in {r.module}) "
                "— regenerate distlr_tpu_torch/obs/METRICS.md")
    for name, modules in sorted(collect_literals().items()):
        # a literal that is neither a registered family nor a child/
        # documented name is either an emission the AST scan missed or
        # a typo'd reference — both are drift
        if name not in reg_names and name not in doc:
            problems.append(
                f"string literal {name!r} in {modules[0]} matches no "
                "registered or documented series (typo, or add it to "
                "NON_METRIC_LITERALS if it is not a metric)")
    for name in sorted(doc - reg_names):
        problems.append(
            f"distlr_tpu_torch/obs/METRICS.md documents {name} but no registration site "
            "exists — regenerate the doc")
    return problems


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--check" in argv:
        problems = check()
        for p in problems:
            print(f"METRICS LINT: {p}", file=sys.stderr)
        return 1 if problems else 0
    path = doc_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    text = generate()
    with open(path, "w") as f:
        f.write(text)
    print(f"wrote {path} ({len(documented_names(text))} series)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
