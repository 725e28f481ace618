"""int8 quantization and contraction, and products with an f32 result, on
PyTorch tensors (plain code).

Copies of the int8 primitives of ``distlr_tpu/models/linear.py``, with the
same names, bounds and arithmetic: the dense models' ``int8_dot`` mode and
the plain versions of the int8_dot kernels (:mod:`distlr_tpu_torch.ops.
fused_lr`) use them, and :mod:`distlr_tpu_torch.models.linear` exports them
under the JAX package's names.
"""

from __future__ import annotations

import torch

# Longest int8 x int8 contraction whose worst case (every product
# +/-127*127, same sign) still fits int32: floor((2^31-1) / 127^2).
_INT8_ACC_MAX = (2**31 - 1) // (127 * 127)

# Chunks below this are not worth a product of their own (every k divides
# by 1, so this floor is what sends awkward lengths to the convert route).
_INT8_MIN_CHUNK = 1024

# Each chunk is one product; past this many chunks the convert route wins.
_INT8_MAX_CHUNKS = 32

# torch._int_mm on the card takes m > 16 and k, n multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def _int8_chunk_len(k: int) -> int | None:
    """Largest divisor of ``k`` that keeps a worst-case int8 x int8
    contraction inside int32; ``None`` (take the convert route) when no
    divisor of useful size exists or the chunks would exceed
    ``_INT8_MAX_CHUNKS``."""
    if k <= _INT8_ACC_MAX:
        return k
    best = None
    for d in range(1, int(k**0.5) + 1):
        if k % d:
            continue
        for c in (d, k // d):
            if c <= _INT8_ACC_MAX and (best is None or c > best):
                best = c
    if best is None or best < _INT8_MIN_CHUNK or k // best > _INT8_MAX_CHUNKS:
        return None
    return best


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t.contiguous()
    return torch.nn.functional.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of int8 (m, k) and (k, n) matrices, int32: ``torch._int_mm``
    (on the card cuBLASLt's int8 GEMM), with zero rows and columns added
    to meet its shape rules on the card (exact for integers) and ``b``
    column-major, the layout cuBLASLt's int8 kernels take."""
    m, k = a.shape
    n = b.shape[1]
    if not a.is_cuda:
        return torch._int_mm(a.contiguous(), b.contiguous())
    up = lambda v: -(-v // _INT_MM_ALIGN) * _INT_MM_ALIGN  # noqa: E731
    mp, kp, np_ = up(max(_INT_MM_MIN_ROWS, m)), up(k), up(n)
    b_cols = _pad_to(b, kp, np_).t().contiguous().t()
    return torch._int_mm(_pad_to(a, mp, kp), b_cols)[:m, :n]


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 sums and an f32 result, from operands of one
    dtype.  For bf16 operands: on the card cuBLAS's bf16 GEMM with an f32
    output (``aten::mm.dtype``, no rounding of the result to bf16); on the
    CPU the f32 product of the same bf16 values."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def int8_contract(a: torch.Tensor, b: torch.Tensor, a_axis: int) -> torch.Tensor:
    """Overflow-safe ``a . b`` over ``a``'s axis ``a_axis`` and ``b``'s
    leading axis, both int8 -> f32 (unscaled): the JAX package's
    ``_int8_contract``.

    The contraction is split into the largest dividing chunks that cannot
    wrap int32 (:func:`_int8_chunk_len`): one int32 product per chunk of
    the contraction axis, the chunks summed in f32 in order.  An awkward
    length takes the bf16-convert route (f32 sums of exact products)."""
    k = a.shape[a_axis]
    a2 = a.movedim(a_axis, -1)
    lead, trail = a2.shape[:-1], b.shape[1:]
    A, Bm = a2.reshape(-1, k), b.reshape(k, -1)
    n_c = _int8_chunk_len(k)
    if n_c is None:  # no safe chunking: the correct but slower convert route
        out = mm_f32(A.to(torch.bfloat16), Bm.to(torch.bfloat16))
    else:
        out = None
        for i in range(k // n_c):
            p = int8_mm(A[:, i * n_c:(i + 1) * n_c], Bm[i * n_c:(i + 1) * n_c]).to(torch.float32)
            out = p if out is None else out + p
    return out.reshape(*lead, *trail)


def sym_scale(max_abs: torch.Tensor) -> torch.Tensor:
    """The int8 grid's step for values up to ``max_abs``, f32:
    ``max(max_abs, 1e-8) / 127`` as the JAX package computes it."""
    return torch.clamp(max_abs.to(torch.float32), min=1e-8) * (1.0 / 127.0)


def quantize_sym(x: torch.Tensor, max_abs: torch.Tensor):
    """Symmetric int8 quantization on the grid of ``max_abs``: ``(q int8,
    scale)`` with ``x ~ q * scale``; rounds halves to even, as
    ``jnp.round``."""
    scale = sym_scale(max_abs)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale
