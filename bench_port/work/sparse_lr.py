"""Least time of padded-COO logistic regression's work on one H100.

A step reads each real (column, value) entry, y and mask once, gathers
each weight the batch touches once and writes its new value once; an eval
is the forward over the test rows.  Padding is the program's layout and
counts for nothing.  ``batch`` and ``test`` are the harness's counts of
rows, entries and distinct columns.
"""

from bench_port import roofline


def step_bound_s(cell, batch: dict) -> float:
    return roofline.sparse_grad_bound_s(batch["rows"], batch["nnz"], batch["distinct"])


def eval_bound_s(cell, test: dict) -> float:
    return roofline.sparse_logits_bound_s(test["rows"], test["nnz"], test["distinct"])
