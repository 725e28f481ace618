"""Shared fixtures of the benchmark's own tests (``python -m pytest
bench_port/tests`` from the root of the checkout; the card's tests:
``-m cuda``).  Every cell of ``BENCHMARK.json`` is rehearsed, and so are
the cells whose files are kept though ``BENCHMARK.json`` leaves them out
(``PERF.md``, Open questions)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from bench_port import spec

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
#: the listed cells and the left-out ones, ``<config>.<traffic>`` of their files
KEPT = WORKLOADS + ["avazu_sparse_1m.sync_b65536"]

#: a cell cut to a size the CPU runs in a second: the same files, layouts
#: and precisions, D = 4,096, three batches of 64 rows, 64 test rows
TINY = {"num_feature_dim": 4096, "train_rows": 192, "test_rows": 64}
TINY_BATCH = 64


def load_cell(workload: str, root: Path = ROOT) -> spec.Cell:
    """A cell of ``BENCHMARK.json``, or a left-out one on one chip from its
    files by name (no per-layer metric lists it)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if workload not in {w["name"] for w in bench["workloads"]}:
        config, traffic = workload.split(".", 1)
        bench["configs"].append({"name": config, "file": f"bench_port/configs/{config}.json"})
        bench["workloads"].append({"name": workload, "config": config, "traffic": traffic,
                                   "chips": 1})
    return spec.load_cell(str(root), workload, bench)


def tiny_cell(workload: str, root: Path = ROOT) -> spec.Cell:
    cell = load_cell(workload, root)
    cell.config.update(TINY)
    cell.traffic["batch_size"] = TINY_BATCH
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
