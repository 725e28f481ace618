"""Find a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, model family or
per-layer metric is a file of its own under the benchmark's directory,
found by name, so a later change adds a cell by adding files:

- ``configs/<config>.json`` (the path the configuration's ``file`` gives),
- ``traffic/<traffic>.json``,
- ``limits/<workload>.json``: the limit of each number ``correct`` compares,
- ``reference/<reference>.py``: the plain reference a configuration names,
- ``work/<model>.py``: the least time a step and an eval of a model family
  could take on the card,
- ``metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from types import ModuleType


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    bench_dir: str
    config: dict    # the configuration file with the traffic's overrides applied
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    def module(self, kind: str, name: str) -> ModuleType:
        return load_module(os.path.join(self.bench_dir, kind, f"{name}.py"))

    @property
    def reference(self) -> ModuleType:
        return self.module("reference", self.config["reference"])

    @property
    def work(self) -> ModuleType:
        return self.module("work", self.config["model"])

    def readers(self) -> dict[str, ModuleType]:
        """The reader of each per-layer metric this cell reports."""
        return {m["name"]: self.module("metrics", m["name"]) for m in self.per_layer}


def load_module(path: str) -> ModuleType:
    """The module in the file ``path``, loaded once a process under a name
    made from the path (file names may hold dots)."""
    path = os.path.abspath(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    key = "bench_port_file_" + "".join(c if c.isalnum() else "_" for c in path)
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def run_seconds(root: str) -> int:
    """``root/BENCHMARK.json``'s window length."""
    return int(_json(os.path.join(root, "BENCHMARK.json"))["run_seconds"])


def load_cell(root: str, workload: str, bench: dict | None = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` (or of ``bench``,
    that file's contents)."""
    bench = bench or _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    bench_dir = os.path.join(root, bench["paths"][0])
    traffic = _json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    config = {**_json(os.path.join(root, conf_entry["file"])),
              **traffic.get("config_overrides", {})}

    def applies(metric: dict) -> bool:
        return workload in metric.get("workloads", [workload])

    return Cell(
        name=workload, chips=int(w["chips"]), bench_dir=bench_dir, config=config,
        traffic=traffic,
        limits=_json(os.path.join(bench_dir, "limits", f"{workload}.json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
    )
