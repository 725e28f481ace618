"""Plain logistic regression: the yardstick that ``correct`` holds the
program to.

Plain PyTorch and numpy.  It imports nothing of the program, and reads
nothing the program made: it parses the libsvm shards itself, works out
the initial weights, the features at their stated precision and every
SGD step again, and is handed the program's outputs only to judge them.

One formulation serves the dense and the sparse configurations: a row is
its (column, value) entries, so ``z = Σ w[c]·x`` over the entries, and the
gradient scatters ``r·x`` back onto the columns.  A dense row's zeros add
nothing to either, so this is the dense model's arithmetic too.

A precision names the dtype each operand of the products is rounded to
(``features``, ``weights``, ``residual``; ``null`` keeps it) and the dtype
every sum, the state and the update are held in (``accumulate``).  The
reference runs at the configuration's stated operand precision with float64
sums; the control runs the precision below it.
"""

from __future__ import annotations

import numpy as np
import torch


def read_libsvm(path: str, max_rows: int | None = None):
    """The first ``max_rows`` rows of a libsvm file as padded numpy
    ``(cols (n, K) int64, vals (n, K) float64, y (n,) int64)``: 0-based
    columns, pads at column 0 with value 0, label 1 iff the text reads 1."""
    with open(path, "rb") as f:
        lines = [line for line in f.read().split(b"\n") if line.strip()]
    if max_rows is not None:
        lines = lines[:max_rows]
    counts = np.fromiter((line.count(b":") for line in lines), np.int64, len(lines))
    toks = np.array(b" ".join(lines).replace(b":", b" ").split())
    starts = np.concatenate([[0], np.cumsum(1 + 2 * counts)[:-1]]).astype(np.int64)
    y = (toks[starts].astype(np.float64) == 1.0).astype(np.int64)
    is_feat = np.ones(len(toks), dtype=bool)
    is_feat[starts] = False
    feats = toks[is_feat]
    idx = feats[0::2].astype(np.int64) - 1
    val = feats[1::2].astype(np.float64)
    n, k = len(lines), int(counts.max(initial=1))
    cols = np.zeros((n, k), dtype=np.int64)
    vals = np.zeros((n, k), dtype=np.float64)
    slot = np.arange(k)[None, :] < counts[:, None]
    cols[slot] = idx
    vals[slot] = val
    return cols, vals, y


def init_weights(init: str, seed: int, D: int) -> torch.Tensor:
    """The configuration's initial weights, float64 on the CPU: ``uniform``
    is ``torch.rand`` of a CPU generator seeded with the run's seed,
    ``zeros`` is zeros."""
    if init == "uniform":
        gen = torch.Generator().manual_seed(int(seed) % 2**64)
        return torch.rand(D, generator=gen, dtype=torch.float32).to(torch.float64)
    if init == "zeros":
        return torch.zeros(D, dtype=torch.float64)
    raise ValueError(f"unknown init {init!r}")


def _round(t: torch.Tensor, dtype: str | None) -> torch.Tensor:
    """``t`` rounded to a float ``dtype`` and back (None keeps it)."""
    if dtype is None:
        return t
    return t.to(getattr(torch, dtype)).to(t.dtype)


class Batch:
    """Rows on a device, in the accumulate dtype of a precision."""

    def __init__(self, cols, vals, y, prec: dict, device):
        acc = getattr(torch, prec["accumulate"])
        self.cols = torch.as_tensor(cols, device=device)
        raw = torch.as_tensor(vals, device=device, dtype=torch.float64)
        self.x = _round(raw, prec["features"]).to(acc)
        self.y = torch.as_tensor(y, device=device).to(acc)
        self.rows = torch.ones(len(y), device=device, dtype=acc)

    def half(self) -> Batch:
        """The fault "half of the batch left out": the second half's rows
        drop out of the sums and the count."""
        out = object.__new__(Batch)
        out.__dict__.update(self.__dict__)
        out.rows = self.rows.clone()
        out.rows[len(out.rows) // 2:] = 0
        return out


def logits(w: torch.Tensor, b: Batch, prec: dict) -> torch.Tensor:
    return (_round(w, prec["weights"])[b.cols] * b.x).sum(dim=1)


def _softplus(z):
    return torch.logaddexp(z, torch.zeros_like(z))


def step(w: torch.Tensor, b: Batch, lr: float, l2: float, prec: dict, *, loss: bool = True):
    """One SGD step ``w − lr·(Σ r·x / n + l2·w)``: ``(loss, new w)``, the
    loss at the old w (mean logloss plus ``l2/2·|w|²``; None unless
    ``loss``)."""
    z = logits(w, b, prec)
    n = torch.clamp(b.rows.sum(), min=1.0)
    r = _round((torch.sigmoid(z) - b.y) * b.rows, prec.get("residual"))
    g = torch.zeros_like(w).index_add_(0, b.cols.reshape(-1), (r[:, None] * b.x).reshape(-1))
    value = (((_softplus(z) - b.y * z) * b.rows).sum() / n + 0.5 * l2 * (w * w).sum()
             if loss else None)
    return value, w - lr * (g / n + l2 * w)


def train(w0: torch.Tensor, batches: list[Batch], lr: float, l2: float, prec: dict,
          epochs: int, *, recorded: int = 3, half_batch: bool = False) -> dict:
    """Every step of ``epochs`` passes over ``batches`` in order from
    ``w0``: the first ``recorded`` steps' losses, the weights after the
    first step (``w1``), after step ``recorded`` (``w3``) and after the last
    (``w_final``), float64 on the CPU."""
    acc = getattr(torch, prec["accumulate"])
    w = w0.to(device=batches[0].cols.device, dtype=acc)
    if half_batch:
        batches = [b.half() for b in batches]
    losses, after, k = [], {}, 0
    for _ in range(epochs):
        for b in batches:
            k += 1
            loss, w = step(w, b, lr, l2, prec, loss=k <= recorded)
            if loss is not None:
                losses.append(float(loss))
            if k in (1, recorded):
                after[k] = w.to(device="cpu", dtype=torch.float64)
    return {"losses": losses, "w1": after[1], "w3": after[recorded],
            "w_final": w.to(device="cpu", dtype=torch.float64)}


def evaluate(w: torch.Tensor, b: Batch, prec: dict) -> dict:
    """Mean test logloss (no L2 term) and accuracy (z > 0 against y) of
    ``w`` over the rows of ``b``."""
    acc = getattr(torch, prec["accumulate"])
    z = logits(w.to(device=b.cols.device, dtype=acc), b, prec)
    n = b.rows.sum()
    ll = ((_softplus(z) - b.y * z) * b.rows).sum() / n
    right = (((z > 0).to(acc) == b.y).to(acc) * b.rows).sum() / n
    return {"logloss": float(ll), "accuracy": float(right)}
