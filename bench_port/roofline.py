"""The yardstick's counts: the least time one H100 could take for the work
a step or an eval needs, from shapes and dtypes alone.

Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor
cores.  The linear models' products take bf16 or int8 operands with
float32 sums on the CUDA cores, so float32 is the rate they compute at.

A bound counts each input byte read once and each output byte written
once, whatever an implementation reads again, and takes the larger of the
bytes over the bandwidth and the operations over the rate.  The dense
gradient's count is ``chip_smoke.py::_grad_bound``'s, copied.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

X_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1, "int8_dot": 1}


def bound_s(n_bytes: float, n_flops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS_PER_S)


def dense_grad_bytes(B: int, D: int, x_bytes: int) -> int:
    """X, w, y and mask in, g out, once each."""
    return B * D * x_bytes + D * 4 + 2 * B * 4 + D * 4


def dense_grad_bound_s(B: int, D: int, x_bytes: int) -> float:
    """The gradient ``Xᵀ(σ(Xw) − y)`` at (B, D): a multiply-add each way
    per element of X."""
    return bound_s(dense_grad_bytes(B, D, x_bytes), 4 * B * D)


def dense_logits_bound_s(B: int, D: int, x_bytes: int) -> float:
    """The eval's forward ``Xw``: X and w in, z out."""
    return bound_s(B * D * x_bytes + D * 4 + B * 4, 2 * B * D)


def sparse_grad_bound_s(B: int, nnz: int, distinct: int) -> float:
    """A padded-COO step over B rows holding ``nnz`` real entries that
    touch ``distinct`` weights: each entry's column (int32) and value
    (f32) once, y and mask once, each touched weight gathered once and
    its updated value written once; a multiply-add each way per entry."""
    return bound_s(nnz * 8 + B * 8 + 2 * distinct * 4, 4 * nnz)


def sparse_logits_bound_s(B: int, nnz: int, distinct: int) -> float:
    """The sparse eval's forward: entries, the touched weights, z out."""
    return bound_s(nnz * 8 + distinct * 4 + B * 4, 2 * nnz)
