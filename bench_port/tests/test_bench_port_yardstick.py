"""The yardstick's counts, generator and comparison."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench_port import gen, judge, roofline, spec
from bench_port.reference import lr
from bench_port.tests.conftest import ROOT


def test_dense_gradient_bounds_match_the_kernel_table():
    """PERF.md's table of kernels: bound_ms 1.225 at (2048, 1M) bf16 and
    0.614 for an int8 X."""
    assert roofline.dense_grad_bound_s(2048, 1_000_000, 2) * 1e3 == pytest.approx(1.225, abs=5e-4)
    assert roofline.dense_grad_bound_s(2048, 1_000_000, 1) * 1e3 == pytest.approx(0.614, abs=5e-4)
    # the logits' bound at the same shape (row 1', 1.224)
    assert roofline.dense_logits_bound_s(2048, 1_000_000, 2) * 1e3 == pytest.approx(1.224, abs=5e-4)


def test_sparse_bound_counts_entries_and_touched_weights():
    # 65,536 rows x 21 entries, 136,000 distinct weights: bytes bound it
    b = roofline.sparse_grad_bound_s(65536, 65536 * 21, 136_000)
    assert b == pytest.approx((65536 * 21 * 8 + 65536 * 8 + 2 * 136_000 * 4) / 3.35e12)


def test_work_of_each_family_is_a_step_bound():
    cell = spec.load_cell(str(ROOT), "criteo_dense_1m.sync_b2048")
    batch = {"rows": 2048, "nnz": 2048 * 39, "distinct": 18_000}
    assert cell.work.step_bound_s(cell, batch) == roofline.dense_grad_bound_s(2048, 1_000_000, 2)


@pytest.mark.parametrize("name", ["criteo_dense_1m", "avazu_sparse_1m"])
def test_generator_same_seed_same_bytes(name):
    conf = json.loads((ROOT / "bench_port" / "configs" / f"{name}.json").read_text())
    c = dict(conf, num_feature_dim=100_000)
    a = gen.libsvm_bytes(gen.make_rows(2**31 + 9, c, 500, 50)[0])
    b = gen.libsvm_bytes(gen.make_rows(2**31 + 9, c, 500, 50)[0])
    other = gen.make_rows(2**31 + 10, c, 500, 50)[0]
    assert a == b
    assert a != gen.libsvm_bytes(other)
    # every seed makes rows of one shape: the same work
    assert other.cols.shape == gen.make_rows(1, c, 500, 50)[0].cols.shape


def test_libsvm_round_trip(tmp_path):
    c = {"num_feature_dim": 1000, "fields": 21, "zipf_a": 1.3, "layout": "hashed",
         "vocab": 50, "label_weight_std": 0.5}
    rows = gen.make_rows(4, c, 300, 10)[0]
    assert (rows.vals == 2).any()  # a small vocabulary makes collisions
    path = gen.write_split(str(tmp_path), "train", rows)
    cols, vals, y = lr.read_libsvm(path)
    k = cols.shape[1]
    real = rows.cols[:, :k] >= 0
    assert (cols[real] == rows.cols[:, :k][real]).all()
    assert (vals[real] == rows.vals[:, :k][real]).all() and (vals[~real] == 0).all()
    assert (y == rows.y).all()
    from distlr_tpu_torch.data.libsvm import parse_libsvm_file

    (row_ptr, pcols, pvals), py = parse_libsvm_file(path, 1000, dense=False)
    assert (pcols == rows.cols[rows.cols >= 0]).all() and (py == rows.y).all()


def test_gaps_of_a_state_left_unchanged_read_one():
    w0 = torch.rand(100, dtype=torch.float64)
    ev = {"logloss": 0.5, "accuracy": 0.75}
    ref = {"losses": [1.0, 0.9], "w1": w0 - 0.1, "w3": w0 - 0.2, "w_final": w0 - 0.3, "eval": ev}
    side = {"losses": [1.0, 0.9], "w1": w0, "w3": w0, "w_final": w0, "eval": ev}
    nums = judge.numbers(side, ref, w0, lr=0.5)
    assert nums["grad_gap"] == 1.0 and nums["change_gap"] == 1.0 and nums["loss_gap"] == 0.0
    assert nums["final_w_gap"] == pytest.approx(1.0)
    assert judge.verdict({"a": 1e-9}, {"a": 1e-8})
    assert not judge.verdict({"a": float("nan")}, {"a": 1.0})
    assert not judge.verdict({}, {"a": 1.0})


def test_reference_step_matches_a_dense_computation():
    """The (column, value) formulation is the dense one's arithmetic."""
    rng = np.random.default_rng(0)
    D, n, k = 50, 8, 5
    cols = np.stack([rng.choice(D, k, replace=False) for _ in range(n)])
    vals = rng.random((n, k))
    y = rng.integers(0, 2, n)
    prec = {"features": None, "weights": None, "residual": None, "accumulate": "float64"}
    b = lr.Batch(cols, vals, y, prec, "cpu")
    w = torch.rand(D, dtype=torch.float64)
    loss, w1 = lr.step(w, b, lr=0.3, l2=0.01, prec=prec)
    X = torch.zeros(n, D, dtype=torch.float64)
    X[torch.arange(n)[:, None], torch.as_tensor(cols)] = torch.as_tensor(vals)
    yt = torch.as_tensor(y, dtype=torch.float64)
    z = X @ w
    g = X.T @ (torch.sigmoid(z) - yt) / n + 0.01 * w
    want = (torch.nn.functional.softplus(z) - yt * z).mean() + 0.005 * (w * w).sum()
    assert float(loss) == pytest.approx(float(want), rel=1e-12)
    assert torch.allclose(w1, w - 0.3 * g, rtol=1e-12, atol=1e-14)
