"""The numbers ``correct`` compares, and the verdict against their limits.

A side is what one run of training produced: its first three steps'
losses, its weights after the first step (``w1``), after the third
(``w3``) and after the last step of the window (``w_final``), and the
window's last eval of those final weights.  The program is one side; the
reference at the configuration's precision is the side every other is
judged against, and its control and faults are sides too.  Both start at
the same ``w0`` and take the same batches in the same order.

The first steps:

- ``loss_gap``: the largest relative gap between a step's loss and the
  reference's;
- ``grad_gap``: the relative gap between the norm of the first gradient
  as the update applied it, ``(w0 − w1) / lr``, and the reference's;
- ``change_gap``: the relative gap between the norm of the weights'
  change over the three steps and the reference's.

The weights are one leaf, so a gap of norms is measured against the
reference's norm of that leaf.

The whole window:

- ``final_w_gap``: the norm of the gap between the side's final weights
  and the reference's own, over the norm of the reference's change from
  ``w0``;
- ``eval_logloss_gap``: relative gap of the last test logloss, each side's
  of its own final weights;
- ``eval_acc_gap``: absolute gap of its accuracy.
"""

from __future__ import annotations

import math

import torch

#: the first steps whose losses and weights are compared
RECORDED_STEPS = 3


def rel_gap(a: float, b: float) -> float:
    if b == 0:
        return 0.0 if a == 0 else math.inf
    return abs(a - b) / abs(b)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t))


def norm_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    return rel_gap(_norm(p), _norm(r))


def numbers(side: dict, ref: dict, w0: torch.Tensor, lr: float) -> dict:
    """The gaps of ``side`` from the reference side ``ref``."""
    ref_change = _norm(ref["w_final"] - w0)
    final = _norm(side["w_final"] - ref["w_final"])
    return {
        "loss_gap": max(rel_gap(a, b) for a, b in zip(side["losses"], ref["losses"],
                                                      strict=True)),
        "grad_gap": norm_gap((w0 - side["w1"]) / lr, (w0 - ref["w1"]) / lr),
        "change_gap": norm_gap(side["w3"] - w0, ref["w3"] - w0),
        "final_w_gap": final / ref_change if ref_change else (0.0 if final == 0 else math.inf),
        "eval_logloss_gap": rel_gap(side["eval"]["logloss"], ref["eval"]["logloss"]),
        "eval_acc_gap": abs(side["eval"]["accuracy"] - ref["eval"]["accuracy"]),
    }


def verdict(nums: dict, limits: dict) -> bool:
    """Every limited number is finite and within its limit."""
    return all(k in nums and math.isfinite(nums[k]) and nums[k] <= lim
               for k, lim in limits.items())


def checks(nums: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` of the numbers compared."""
    return {k: {"value": nums.get(k, math.nan), "limit": lim} for k, lim in limits.items()}
