"""The benchmark's own CTR rows and their libsvm text, made from a seed.

Numpy only: nothing of the program is imported here, so the reference and
the program read the same bytes and neither made them.

A configuration names one of two layouts:

- ``per_field`` (Criteo-style): field f owns the bucket range
  ``[f * P, (f + 1) * P)`` with ``P = D // fields``, and its bucket is
  ``(zipf(a) - 1) mod P``: head buckets recur, as hashed ids do;
- ``hashed`` (Avazu-style): field f draws a raw id ``(zipf(a) - 1) mod
  vocab`` and hashes ``(f, id)`` to one of D buckets; two fields of a row
  that land in one bucket make one entry of value 2.

Labels come from a planted ``w_true ~ N(0, label_weight_std^2)`` over the
buckets: ``y ~ Bernoulli(sigmoid(sum of w_true over the row))``.  Every
value is 1 (a one-hot field), or 2 where two fields collide.

Rows for a seed always have the same count and the same padded width, so
every seed does the same amount of work.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

_MIX = np.uint64(0x9E3779B97F4A7C15)
#: widest 1-based column written (D <= 10**7)
_DIGITS = 8


def rng_for(seed: int) -> np.random.Generator:
    """The generator of a run's seed (any integer: negatives wrap)."""
    return np.random.default_rng(int(seed) % 2**64)


@dataclasses.dataclass(frozen=True)
class Rows:
    """Rows as padded, ascending 0-based columns (-1 pads), their values
    and labels."""

    cols: np.ndarray  # (n, K) int64
    vals: np.ndarray  # (n, K) float32, 0 at pads
    y: np.ndarray     # (n,) int32 in {0, 1}

    def __len__(self) -> int:
        return len(self.y)

    def take(self, start: int, stop: int) -> Rows:
        return Rows(self.cols[start:stop], self.vals[start:stop], self.y[start:stop])

    def nnz(self) -> int:
        return int((self.cols >= 0).sum())

    def distinct(self) -> int:
        """Distinct columns these rows touch."""
        c = self.cols[self.cols >= 0]
        return int(np.unique(c).size)


def _buckets(rng, n: int, cfg: dict) -> np.ndarray:
    """(n, fields) bucket of each field of each row."""
    D, F, a = cfg["num_feature_dim"], cfg["fields"], cfg["zipf_a"]
    draws = rng.zipf(a, size=(n, F)).astype(np.uint64) - np.uint64(1)
    if cfg["layout"] == "per_field":
        per_field = D // F
        return (draws % np.uint64(per_field)).astype(np.int64) + np.arange(F) * per_field
    if cfg["layout"] == "hashed":
        vocab = np.uint64(cfg["vocab"])
        key = draws % vocab + np.arange(F, dtype=np.uint64) * vocab
        h = key * _MIX
        h ^= h >> np.uint64(29)
        return (h % np.uint64(D)).astype(np.int64)
    raise ValueError(f"unknown layout {cfg['layout']!r}")


def _merge(buckets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sorted columns with repeats merged into one entry of value count,
    padded with -1 at the end of the row."""
    cols = np.sort(buckets, axis=1)
    vals = np.ones(cols.shape, dtype=np.float32)
    dup_rows = np.flatnonzero((cols[:, 1:] == cols[:, :-1]).any(axis=1))
    for i in dup_rows:
        u, counts = np.unique(cols[i], return_counts=True)
        cols[i] = -1
        vals[i] = 0.0
        cols[i, :u.size] = u
        vals[i, :u.size] = counts
    return cols, vals


def make_rows(seed: int, cfg: dict, n_train: int, n_test: int) -> tuple[Rows, Rows]:
    """(train, test) rows of configuration ``cfg`` from ``seed``."""
    rng = rng_for(seed)
    D = cfg["num_feature_dim"]
    w_true = (rng.standard_normal(D) * cfg["label_weight_std"]).astype(np.float32)
    out = []
    for n in (n_train, n_test):
        cols, vals = _merge(_buckets(rng, n, cfg))
        z = (w_true[np.maximum(cols, 0)] * vals).sum(axis=1)
        y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.int32)
        out.append(Rows(cols, vals, y))
    return out[0], out[1]


def libsvm_bytes(rows: Rows) -> bytes:
    """``rows`` as libsvm text: ``label col:val ...`` with 1-based columns,
    one line a row.  Built as one byte matrix and a mask of the bytes each
    line keeps, so half a million rows take well under a second."""
    n, k = rows.cols.shape
    vals = rows.vals.astype(np.int64)
    if n and (vals.max() > 9 or (rows.cols >= 0).sum() != (vals > 0).sum()):
        raise ValueError("values must be whole numbers 1..9")
    idx = rows.cols + 1                     # 0 at pads
    width = 1 + _DIGITS + 2                 # " " digits ":" value
    tok = np.zeros((n, k, width), dtype=np.uint8)
    keep = np.zeros((n, k, width), dtype=bool)
    tok[..., 0] = ord(" ")
    for d in range(_DIGITS):
        place = 10 ** (_DIGITS - 1 - d)
        tok[..., 1 + d] = ord("0") + (idx // place) % 10
        keep[..., 1 + d] = idx >= place
    tok[..., _DIGITS + 1] = ord(":")
    tok[..., _DIGITS + 2] = ord("0") + vals
    valid = (idx > 0)[..., None]
    keep[..., 0] = keep[..., _DIGITS + 1] = keep[..., _DIGITS + 2] = True
    keep &= valid
    line = np.zeros((n, 2 + k * width), dtype=np.uint8)
    line_keep = np.ones(line.shape, dtype=bool)
    line[:, 0] = ord("0") + rows.y
    line[:, 1:-1] = tok.reshape(n, -1)
    line_keep[:, 1:-1] = keep.reshape(n, -1)
    line[:, -1] = ord("\n")
    return line[line_keep].tobytes()


def write_split(data_dir: str, split: str, rows: Rows) -> str:
    """``data_dir/split/part-001``, the reference's shard layout."""
    d = os.path.join(data_dir, split)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "part-001")
    with open(path, "wb") as f:
        f.write(libsvm_bytes(rows))
    return path
