"""Shard preparation — the seeded replacement for ``examples/gen_data.py``
(copy of ``distlr_tpu/data/sharding.py``).

The reference script (``examples/gen_data.py:9-45``) shuffles the a9a train
file with an *unseeded* ``random.shuffle`` and splits it into
``num_part=4`` equal shards named ``part-001..004`` plus ``test/part-001``.
This module does the same with a mandatory seed, any part count, and no
dependence on a downloaded dataset (pair with
:func:`distlr_tpu_torch.data.synthetic.write_synthetic_shards`).
"""

from __future__ import annotations

import os
import random
import shutil


def part_name(i: int) -> str:
    """``part-001``-style shard name (reference gen_data.py:27,41)."""
    return f"part-{i + 1:03d}"


def shard_libsvm_file(
    src_path: str,
    out_dir: str,
    num_parts: int,
    *,
    seed: int = 0,
    shuffle: bool = True,
) -> list[str]:
    """Shuffle (seeded) and split a libsvm text file into equal shards."""
    with open(src_path) as f:
        # normalize endings: a missing final newline must not fuse two
        # samples into one line after shuffling
        lines = [ln.rstrip("\n") + "\n" for ln in f if ln.strip()]
    if shuffle:
        random.Random(seed).shuffle(lines)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    n = len(lines)
    for i in range(num_parts):
        chunk = lines[i * n // num_parts : (i + 1) * n // num_parts]
        path = os.path.join(out_dir, part_name(i))
        with open(path, "w") as f:
            f.writelines(chunk)
        paths.append(path)
    return paths


def prepare_data_dir(
    train_src: str,
    test_src: str,
    data_dir: str,
    num_parts: int = 4,
    *,
    seed: int = 0,
) -> dict:
    """Full gen_data.py equivalent: shard train, copy test, mk models/."""
    train_parts = shard_libsvm_file(train_src, os.path.join(data_dir, "train"), num_parts, seed=seed)
    test_dir = os.path.join(data_dir, "test")
    os.makedirs(test_dir, exist_ok=True)
    test_path = os.path.join(test_dir, part_name(0))
    shutil.copyfile(test_src, test_path)
    os.makedirs(os.path.join(data_dir, "models"), exist_ok=True)
    return {"train_parts": train_parts, "test_path": test_path}
