"""Reference-compatible text model export / import.

The reference's only persistence is ``LR::SaveModel`` (``src/lr.cc:73-82``):
line 1 = ``num_feature_dim``, line 2 = the weights space-separated (with a
trailing space), written once after training per worker to
``DATA_DIR/models/part-00{rank+1}`` (``src/main.cc:168-169``).  There is
**no load path in the reference at all** — this module adds one, plus the
same format for export so models can be cross-validated against reference
output files.  Copy of ``distlr_tpu/train/export.py``: the text file is the
interchange format between the JAX package and this port, in both
directions.
"""

from __future__ import annotations

import numpy as np


def save_model_text(path: str, weights) -> None:
    w = np.asarray(weights, dtype=np.float32).reshape(-1)
    with open(path, "w") as f:
        f.write(f"{w.shape[0]}\n")
        # %g matches the reference's default ostream float formatting.
        f.write(" ".join(f"{v:g}" for v in w) + " \n")


def load_model_text(path: str, shape=None) -> np.ndarray:
    with open(path) as f:
        d = int(f.readline().strip())
        vals = np.array(f.readline().split(), dtype=np.float32)
    if vals.shape[0] != d:
        raise ValueError(f"{path}: header says {d} weights, found {vals.shape[0]}")
    return vals.reshape(shape) if shape is not None else vals

