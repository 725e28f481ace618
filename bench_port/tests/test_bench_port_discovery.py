"""A cell is added by adding files: a configuration, a traffic mix, its
limits and a per-layer metric are found by the names in BENCHMARK.json,
and no file that is already there changes."""

from __future__ import annotations

import hashlib
import json
import shutil

from bench_port import run, spec
from bench_port.tests.conftest import ROOT, tiny_cell

NEW_METRIC = '''"""Test metric: the window's steps a second."""


def read(ctx):
    return ctx.steps / ctx.window_s if ctx.window_s > 0 else None
'''


def _digests(tree):
    return {p.relative_to(tree): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(tmp_path / "bench_port")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "bench_port"

    conf = json.loads((b / "configs" / "avazu_sparse_1m.json").read_text())
    conf.update(name="avazu_sparse_2m", num_feature_dim=2_000_000)
    (b / "configs" / "avazu_sparse_2m.json").write_text(json.dumps(conf))
    (b / "traffic" / "sync_b1024.json").write_text(json.dumps(
        {"batch_size": 1024, "prefetch": 2, "test_interval": 10}))
    name = "avazu_sparse_2m.sync_b1024"
    (b / "limits" / f"{name}.json").write_text(
        (b / "limits" / "avazu_sparse_1m.sync_b65536.json").read_text())
    (b / "metrics" / "steps_per_s.py").write_text(NEW_METRIC)

    bench["configs"].append({"name": "avazu_sparse_2m", "source": "https://example.org",
                             "file": "bench_port/configs/avazu_sparse_2m.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": "avazu_sparse_2m",
                               "traffic": "sync_b1024", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "whole step",
                               "moves": "train_samples_per_s", "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell(str(tmp_path), name)
    assert cell.config["num_feature_dim"] == 2_000_000
    assert cell.traffic["batch_size"] == 1024
    assert [m["name"] for m in cell.per_layer] == ["steps_per_s"]
    assert set(cell.readers()) == {"steps_per_s"}
    # the old cells still find only their own metrics
    old = spec.load_cell(str(tmp_path), "criteo_dense_1m.sync_b2048")
    assert "steps_per_s" not in {m["name"] for m in old.per_layer}

    # the new cell runs end to end on the CPU and reports the new metric
    small = tiny_cell(name, tmp_path)
    r = run.run_cell(small, seed=5, seconds=0.01, traced=True, device="cpu")
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["steps_per_s"]["value"] > 0

    after = _digests(b)
    assert {k: v for k, v in after.items() if k in before} == before
