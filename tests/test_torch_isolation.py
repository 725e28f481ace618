"""The port stands alone: no module of ``distlr_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of the ``distlr_tpu`` package.

The import check runs in a fresh interpreter, because this test process
already holds JAX (``tests/conftest.py`` imports it).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "distlr_tpu", "ml_dtypes", "orbax", "flax")

_PROBE = """
import importlib, importlib.util, json, pkgutil, sys
import distlr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(distlr_tpu_torch.__path__, "distlr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the public names the JAX package exports beside its modules
from distlr_tpu_torch import Config, __version__
from distlr_tpu_torch.data import HashedFeatureEncoder
from distlr_tpu_torch.ps.build import native_variant, sanitizer_environ, suppressions_file
from distlr_tpu_torch.utils import CheckError, check, check_eq
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
forbidden = %r
leaked = sorted(m for m in sys.modules if m.split(".")[0] in forbidden)
print(json.dumps({"imported": names, "leaked": leaked}))
""" % (FORBIDDEN,)


def _roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_fresh_interpreter_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(REPO / "chip_smoke.py")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    for mod in ("distlr_tpu_torch.launch", "distlr_tpu_torch.train.trainer",
                "distlr_tpu_torch.parallel.mesh", "distlr_tpu_torch.parallel.feature_parallel",
                "distlr_tpu_torch.parallel.ring",
                "distlr_tpu_torch.ops.fused_lr", "distlr_tpu_torch.convert",
                "distlr_tpu_torch.ops.gen_roofline", "distlr_tpu_torch.benchmarks.exp_gen_roofline",
                "distlr_tpu_torch.benchmarks.exp_gen_roofline2", "distlr_tpu_torch.data.hashing",
                "distlr_tpu_torch.models.linear", "distlr_tpu_torch.train.ps_trainer",
                "distlr_tpu_torch.ps.client", "distlr_tpu_torch.data._native",
                "distlr_tpu_torch.serve.router", "distlr_tpu_torch.serve.balance",
                "distlr_tpu_torch.serve.tenant", "distlr_tpu_torch.serve.rollout",
                "distlr_tpu_torch.compress", "distlr_tpu_torch.compress.codecs",
                "distlr_tpu_torch.compress.accum", "distlr_tpu_torch.ps.server",
                "distlr_tpu_torch.benchmarks.wire_push",
                "distlr_tpu_torch.feedback", "distlr_tpu_torch.feedback.spool",
                "distlr_tpu_torch.feedback.join", "distlr_tpu_torch.feedback.drift",
                "distlr_tpu_torch.feedback.sink", "distlr_tpu_torch.feedback.online",
                "distlr_tpu_torch.ps.store",
                "distlr_tpu_torch.ps.membership", "distlr_tpu_torch.chaos",
                "distlr_tpu_torch.chaos.plan", "distlr_tpu_torch.chaos.proxy",
                "distlr_tpu_torch.ps.build", "distlr_tpu_torch.utils.logging",
                "distlr_tpu_torch.config", "distlr_tpu_torch.sync",
                "distlr_tpu_torch.obs.tsdb", "distlr_tpu_torch.obs.slo",
                "distlr_tpu_torch.obs.log", "distlr_tpu_torch.obs.profile",
                "distlr_tpu_torch.obs.incident", "distlr_tpu_torch.obs.federate",
                "distlr_tpu_torch.obs.top", "distlr_tpu_torch.obs.metrics_doc",
                "distlr_tpu_torch.autopilot", "distlr_tpu_torch.autopilot.policy",
                "distlr_tpu_torch.autopilot.actuators", "distlr_tpu_torch.autopilot.daemon",
                "distlr_tpu_torch.analysis", "distlr_tpu_torch.analysis.report",
                "distlr_tpu_torch.analysis.wire_parity", "distlr_tpu_torch.analysis.concurrency",
                "distlr_tpu_torch.analysis.baseline", "distlr_tpu_torch.analysis.config_doc",
                "distlr_tpu_torch.analysis.printban", "distlr_tpu_torch.analysis.__main__",
                "distlr_tpu_torch.analysis.schedcheck",
                "distlr_tpu_torch.analysis.schedcheck.runtime",
                "distlr_tpu_torch.analysis.schedcheck.explore",
                "distlr_tpu_torch.analysis.schedcheck.scenarios",
                "distlr_tpu_torch.analysis.schedcheck.mutants",
                "distlr_tpu_torch.analysis.schedcheck.lint",
                "distlr_tpu_torch.analysis.schedcheck.__main__",
                "distlr_tpu_torch.traffic",
                "distlr_tpu_torch.analysis.protocol",
                "distlr_tpu_torch.analysis.protocol.spec",
                "distlr_tpu_torch.analysis.protocol.checker",
                "distlr_tpu_torch.analysis.protocol.mutants",
                "distlr_tpu_torch.analysis.protocol.conformance",
                "distlr_tpu_torch.analysis.protocol.witness",
                "distlr_tpu_torch.analysis.protocol.lint",
                "distlr_tpu_torch.analysis.protocol.__main__",
                "distlr_tpu_torch.analysis.fleetsim",
                "distlr_tpu_torch.analysis.fleetsim.events",
                "distlr_tpu_torch.analysis.fleetsim.props",
                "distlr_tpu_torch.analysis.fleetsim.models",
                "distlr_tpu_torch.analysis.fleetsim.scenarios",
                "distlr_tpu_torch.analysis.fleetsim.mutants",
                "distlr_tpu_torch.analysis.fleetsim.lint",
                "distlr_tpu_torch.analysis.fleetsim.__main__"):
        assert mod in doc["imported"]
    assert doc["leaked"] == []


def test_analysis_and_traffic_load_no_torch():
    """The protocol model, fleetsim and the traffic model are host code
    that the lint runner and ``launch fleetsim`` load: a fresh
    interpreter that imports them holds no torch, as JAX's analysis tree
    holds no jax."""
    probe = ("import json, sys\n"
             "import distlr_tpu_torch.analysis.protocol, distlr_tpu_torch.analysis.fleetsim\n"
             "import distlr_tpu_torch.analysis.protocol.lint\n"
             "import distlr_tpu_torch.analysis.fleetsim.lint, distlr_tpu_torch.traffic\n"
             "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'distlr_tpu'))))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_no_forbidden_import_statement():
    files = sorted((REPO / "distlr_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(REPO)): sorted(_roots(f) & set(FORBIDDEN)) for f in files}
    assert {f: r for f, r in bad.items() if r} == {}
