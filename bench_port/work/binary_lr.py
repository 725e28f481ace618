"""Least time of dense logistic regression's work on one H100.

A step is the gradient over a (B, D) batch at the features' dtype, which
reads X, w, y and mask and writes the new weights once (the same bytes as
``chip_smoke.py::_grad_bound``); an eval is the forward over the test rows.
``batch`` and ``test`` are the harness's counts of a batch's or the test
set's rows, entries and distinct columns.
"""

from bench_port import roofline


def _x_bytes(cell) -> int:
    return roofline.X_BYTES[cell.config["feature_dtype"]]


def step_bound_s(cell, batch: dict) -> float:
    return roofline.dense_grad_bound_s(batch["rows"], cell.config["num_feature_dim"],
                                       _x_bytes(cell))


def eval_bound_s(cell, test: dict) -> float:
    return roofline.dense_logits_bound_s(test["rows"], cell.config["num_feature_dim"],
                                         _x_bytes(cell))
