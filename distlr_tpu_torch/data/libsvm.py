"""libsvm text parsing (pure-Python path of ``distlr_tpu/data/libsvm.py``).

Replaces the reference's hand-rolled parser stack (``include/data_iter.h``
+ ``src/util.cc``), which densifies each sparse row eagerly and has several
parsing bugs (SURVEY.md §3.5 Q6-Q7: ``ToFloat`` cannot parse signs or
exponents; ``Split`` has a substr-length bug; any label != 1 silently
becomes 0).  This parser:

* handles signed / scientific-notation feature values correctly,
* maps labels configurably (default: the reference's ``label != 1 -> 0``
  rule, which is what a9a's ``-1/+1`` labels need),
* converts 1-based libsvm indices to 0-based (same as reference
  ``data_iter.h:30``),
* returns either a dense ``(N, D) float32`` matrix or CSR arrays.

The JAX package's native C tokenizer is not carried over: porting it is
ROADMAP A.5.  Every parse here takes the pure-Python tokenizer.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "parse_libsvm_lines",
    "parse_libsvm_file",
    "write_libsvm",
]


def _map_label(raw: float, multiclass: bool) -> int:
    if multiclass:
        return int(raw)
    # Reference rule (data_iter.h:27): label is 1 iff the text parses to 1.
    return 1 if raw == 1 else 0


def _parse_python(lines, multiclass: bool):
    """Pure-Python tokenizer: returns (labels, row_ptr, cols, vals)."""
    labels: list[int] = []
    row_ptr = [0]
    cols: list[int] = []
    vals: list[float] = []
    for line in lines:
        toks = line.split()
        if not toks:
            continue
        labels.append(_map_label(float(toks[0]), multiclass))
        for tok in toks[1:]:
            if tok.startswith("#"):  # trailing comments per libsvm convention
                break
            idx, _, val = tok.partition(":")
            cols.append(int(idx) - 1)  # 1-based -> 0-based
            vals.append(float(val))
        row_ptr.append(len(cols))
    return (
        np.asarray(labels, dtype=np.int32),
        np.asarray(row_ptr, dtype=np.int64),
        np.asarray(cols, dtype=np.int32),
        np.asarray(vals, dtype=np.float32),
    )


def _parse_csr(text_or_lines, multiclass: bool):
    if isinstance(text_or_lines, (bytes, str)):
        text = text_or_lines.decode() if isinstance(text_or_lines, bytes) else text_or_lines
        return _parse_python(text.splitlines(), multiclass)
    return _parse_python(text_or_lines, multiclass)


def _densify(labels, row_ptr, cols, vals, num_features: int):
    n = len(labels)
    X = np.zeros((n, num_features), dtype=np.float32)
    keep = (cols >= 0) & (cols < num_features)  # out-of-range features dropped, not UB
    rows = np.repeat(np.arange(n), np.diff(row_ptr))
    X[rows[keep], cols[keep]] = vals[keep]
    return X


def parse_libsvm_lines(
    text_or_lines,
    num_features: int | None = None,
    *,
    dense: bool = True,
    multiclass: bool = False,
):
    """Parse libsvm content.

    Args:
      text_or_lines: a str/bytes blob or an iterable of lines.
      num_features: D. Required for dense output; optional for CSR output
        (used only to filter out-of-range columns).
      dense: if True return ``(X: (N,D) f32, y: (N,) i32)``; else return
        CSR ``((row_ptr, cols, vals), y)`` with out-of-range columns
        dropped when ``num_features`` is given (same rule as dense).
      multiclass: if True keep integer labels verbatim (softmax models);
        if False apply the reference's binary rule (!=1 -> 0).
    """
    labels, row_ptr, cols, vals = _parse_csr(text_or_lines, multiclass)
    if dense:
        if num_features is None:
            raise ValueError("num_features is required for dense parsing")
        return _densify(labels, row_ptr, cols, vals, num_features), labels
    if num_features is not None:
        keep = (cols >= 0) & (cols < num_features)
        if not keep.all():
            # recompute row_ptr after dropping filtered entries
            rows = np.repeat(np.arange(len(labels)), np.diff(row_ptr))
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
            row_ptr = np.zeros(len(labels) + 1, dtype=np.int64)
            np.add.at(row_ptr, rows + 1, 1)
            row_ptr = np.cumsum(row_ptr)
    return (row_ptr, cols, vals), labels


def parse_libsvm_file(path, num_features: int | None = None, *, dense: bool = True, multiclass: bool = False):
    """Parse a libsvm file from disk (reads the whole file; shards are
    expected to fit in host RAM, same operating point as the reference's
    eager ``DataIter`` ctor, ``data_iter.h:16-35``)."""
    with open(path, "rb") as f:
        blob = f.read()
    return parse_libsvm_lines(blob, num_features, dense=dense, multiclass=multiclass)


def write_libsvm(path, X, y, *, binary_pm1: bool = False) -> None:
    """Write (X, y) as libsvm text (sparse: zero features omitted, 1-based)."""
    X = np.asarray(X)
    y = np.asarray(y)
    with open(path, "w") as f:
        for xi, yi in zip(X, y):
            label = int(yi)
            if binary_pm1:
                label = 1 if label == 1 else -1
            (nz,) = np.nonzero(xi)
            feats = " ".join(f"{j + 1}:{xi[j]:g}" for j in nz)
            f.write(f"{label} {feats}\n" if feats else f"{label}\n")
