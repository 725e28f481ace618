"""Seeded synthetic dataset generation (copy of ``distlr_tpu/data/synthetic.py``).

The reference's only data source is the external a9a libsvm files, shuffled
*without a seed* (``examples/gen_data.py:9-16`` uses unseeded
``random.shuffle``) — its fixtures are not reproducible.  This generator is
fully deterministic: a ground-truth weight vector is drawn, labels are
Bernoulli draws from the true logistic model, so convergence tests can
assert recovery of a known signal.

Also generates multiclass (softmax) and sparse one-hot style datasets for
BASELINE.json configs 4-5.
"""

from __future__ import annotations

import os

import numpy as np


def make_synthetic_dataset(
    num_samples: int,
    num_features: int,
    *,
    seed: int = 0,
    num_classes: int = 2,
    sparsity: float = 0.0,
    noise: float = 0.0,
    dtype=np.float32,
):
    """Deterministic synthetic classification data.

    Returns ``(X, y, w_true)``.  ``sparsity`` zeroes that fraction of
    entries (keeps the dense layout; use for sparse-path testing).
    For ``num_classes == 2`` labels are {0,1} and ``w_true`` is ``(D,)``;
    otherwise labels are {0..K-1} and ``w_true`` is ``(D, K)``.
    """
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((num_samples, num_features)).astype(dtype)
    if sparsity > 0.0:
        X *= rng.random((num_samples, num_features)) >= sparsity
    if num_classes == 2:
        w_true = (rng.standard_normal(num_features) / np.sqrt(num_features)).astype(dtype)
        logits = X @ w_true * 3.0
        if noise > 0.0:
            logits += noise * rng.standard_normal(num_samples)
        p = 1.0 / (1.0 + np.exp(-logits))
        y = (rng.random(num_samples) < p).astype(np.int32)
    else:
        w_true = (rng.standard_normal((num_features, num_classes)) / np.sqrt(num_features)).astype(dtype)
        logits = X @ w_true * 3.0
        if noise > 0.0:
            logits += noise * rng.standard_normal((num_samples, num_classes))
        y = np.argmax(logits + rng.gumbel(size=logits.shape), axis=1).astype(np.int32)
    return X, y, w_true


def write_synthetic_shards(
    data_dir: str,
    num_samples: int,
    num_features: int,
    num_parts: int,
    *,
    seed: int = 0,
    test_fraction: float = 0.2,
    num_classes: int = 2,
    sparsity: float = 0.5,
) -> dict:
    """Create a reference-layout data directory from synthetic data.

    Layout matches ``examples/gen_data.py:29-45``:
    ``train/part-001..NNN``, ``test/part-001``, empty ``models/``.
    Returns a manifest dict (paths + ground truth weight file).
    """
    from distlr_tpu_torch.data.libsvm import write_libsvm  # noqa: PLC0415
    from distlr_tpu_torch.data.sharding import part_name  # noqa: PLC0415

    X, y, w_true = make_synthetic_dataset(
        num_samples, num_features, seed=seed, num_classes=num_classes, sparsity=sparsity
    )
    n_test = int(num_samples * test_fraction)
    Xtr, ytr, Xte, yte = X[n_test:], y[n_test:], X[:n_test], y[:n_test]

    train_dir = os.path.join(data_dir, "train")
    test_dir = os.path.join(data_dir, "test")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(test_dir, exist_ok=True)
    os.makedirs(os.path.join(data_dir, "models"), exist_ok=True)

    parts = []
    binary = num_classes == 2
    for i in range(num_parts):
        sl = slice(i * len(Xtr) // num_parts, (i + 1) * len(Xtr) // num_parts)
        path = os.path.join(train_dir, part_name(i))
        write_libsvm(path, Xtr[sl], ytr[sl], binary_pm1=binary)
        parts.append(path)
    test_path = os.path.join(test_dir, part_name(0))
    write_libsvm(test_path, Xte, yte, binary_pm1=binary)
    w_path = os.path.join(data_dir, "w_true.npy")
    np.save(w_path, w_true)
    return {"train_parts": parts, "test_path": test_path, "w_true_path": w_path}
