"""Dense logistic-regression gradient and logits: Hopper kernels and their
plain PyTorch versions.

Counterpart of ``distlr_tpu/ops/pallas_lr.py::fused_lr_grad``.  The
kernels live in ``csrc/fused_lr_grad.cu`` (see its header for the design
and what bounds it); :mod:`distlr_tpu_torch.ops.build` compiles them on
first use.

A wrapper takes its plain version only when it is given CPU tensors.  A
CUDA tensor launches the kernel or raises: a missing compiler, a failed
build or a refused launch is an error, never a quiet fallback.  Each
wrapper counts its launches in a plain integer attribute
(``fused_lr_grad.launches``, ``lr_logits.launches``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distlr_tpu_torch.ops import build

COMPUTE_DTYPES = ("bfloat16", "float32")
_X_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIB_NAME = "fused_lr_grad"


def fused_lr_supported(batch: int, dim: int) -> bool:
    """Shapes the Hopper kernel takes: any ``B >= 1`` and ``D >= 1``.

    The TPU kernel's twin predicate (``pallas_lr.fused_lr_supported``)
    enforces tile divisibility and a 14 MB VMEM budget; the Hopper kernel
    keeps nothing of size D on chip and masks ragged edges itself, so it
    has no such limit."""
    return batch >= 1 and dim >= 1


def _round(t: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    if compute_dtype == "bfloat16":
        return t.to(torch.bfloat16).to(torch.float32)
    return t.to(torch.float32)


def lr_logits_reference(w, X, *, compute_dtype: str = "bfloat16"):
    """Plain version of :func:`lr_logits`: f32 ``X @ w`` with both operands
    rounded to ``compute_dtype``."""
    return _round(X, compute_dtype) @ _round(w, compute_dtype)


def _grad_reference(w, X, y, mask, compute_dtype):
    Xc = _round(X, compute_dtype)
    z = Xc @ _round(w, compute_dtype)
    r = (torch.sigmoid(z) - y.to(torch.float32)) * mask.to(torch.float32)
    return r @ Xc, z


def fused_lr_grad_reference(w, X, y, mask, *, compute_dtype: str = "bfloat16"):
    """Plain version of :func:`fused_lr_grad`:
    ``Xᵀ((σ(X·w) − y)·mask)`` in f32 after rounding X and w to
    ``compute_dtype``; the residual stays f32, as in the TPU kernel."""
    return _grad_reference(w, X, y, mask, compute_dtype)[0]


def _check_inputs(w, X, compute_dtype, y=None, mask=None) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype!r}")
    if X.dim() != 2:
        raise ValueError(f"X must be (B, D), got shape {tuple(X.shape)}")
    B, D = X.shape
    if B < 1 or D < 1:
        raise ValueError(f"X must have B >= 1 and D >= 1, got {tuple(X.shape)}")
    if X.dtype not in _X_DTYPE_CODES:
        raise TypeError(f"X must be float32 or bfloat16, got {X.dtype}")
    if w.shape != (D,):
        raise ValueError(f"w must be ({D},), got {tuple(w.shape)}")
    for name, v in (("y", y), ("mask", mask)):
        if v is not None and v.shape != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(v.shape)}")
    devices = {t.device for t in (w, X, y, mask) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs must share one device, got {sorted(map(str, devices))}")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"inputs must be cuda or cpu tensors, got {X.device}")
    if X.device.type == "cuda" and not X.is_contiguous():
        raise ValueError("X must be contiguous (row-major) for the CUDA kernel")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB_NAME)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.distlr_lr_forward.argtypes = [p, i, p, p, p, p, p, ll, ll, i, p]
    lib.distlr_lr_forward.restype = i
    lib.distlr_lr_backward.argtypes = [p, i, p, p, ll, ll, i, p]
    lib.distlr_lr_backward.restype = i
    lib.distlr_cuda_error_string.argtypes = [i]
    lib.distlr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.distlr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _launch_forward(w, X, y, mask, compute_dtype):
    """Launch the forward kernel; returns ``(z, r)`` (``r`` None without y)."""
    lib = _lib()
    B, D = X.shape
    w = w.to(torch.float32).contiguous()
    z = torch.empty(B, dtype=torch.float32, device=X.device)
    r = None
    if y is not None:
        y = y.to(torch.float32).contiguous()
        mask = mask.to(torch.float32).contiguous()
        r = torch.empty(B, dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = lib.distlr_lr_forward(
        X.data_ptr(), _X_DTYPE_CODES[X.dtype], w.data_ptr(),
        None if y is None else y.data_ptr(),
        None if y is None else mask.data_ptr(),
        z.data_ptr(), None if r is None else r.data_ptr(),
        B, D, int(compute_dtype == "bfloat16"), stream)
    _raise_on(lib, rc, "lr_forward")
    return z, r


def fused_lr_grad(w, X, y, mask, *, compute_dtype: str = "bfloat16",
                  with_logits: bool = False):
    """Unnormalized logistic gradient ``Xᵀ((σ(X·w) − y)·mask)``, (D,) f32.

    The caller divides by the batch count and adds the L2 term, as
    ``BinaryLR.grad`` does.  ``with_logits=True`` also returns the
    forward's (B,) f32 logits ``z`` — the same pass, no extra read of X.

    Args:
      w: (D,) weights.  X: (B, D) float32 or bfloat16 features.
      y: (B,) labels; mask: (B,) validity (both cast to f32).
      compute_dtype: "bfloat16" rounds X and w to bf16 before the
        products (the TPU kernel's casts); "float32" keeps full f32.
    """
    _check_inputs(w, X, compute_dtype, y, mask)
    if X.device.type == "cpu":
        g, z = _grad_reference(w, X, y, mask, compute_dtype)
        return (g, z) if with_logits else g
    with torch.cuda.device(X.device):
        z, r = _launch_forward(w, X, y, mask, compute_dtype)
        B, D = X.shape
        g = torch.empty(D, dtype=torch.float32, device=X.device)
        lib = _lib()
        rc = lib.distlr_lr_backward(
            X.data_ptr(), _X_DTYPE_CODES[X.dtype], r.data_ptr(), g.data_ptr(),
            B, D, int(compute_dtype == "bfloat16"),
            torch.cuda.current_stream(X.device).cuda_stream)
        _raise_on(lib, rc, "lr_backward")
    fused_lr_grad.launches += 1
    return (g, z) if with_logits else g


fused_lr_grad.launches = 0


def lr_logits(w, X, *, compute_dtype: str = "bfloat16"):
    """(B,) f32 logits ``X·w`` with X and w rounded to ``compute_dtype`` —
    the forward launch of :func:`fused_lr_grad` alone.  Keeps f32 logits
    for a bf16 X without an f32 copy of the (B, D) matrix."""
    _check_inputs(w, X, compute_dtype)
    if X.device.type == "cpu":
        return lr_logits_reference(w, X, compute_dtype=compute_dtype)
    with torch.cuda.device(X.device):
        z, _ = _launch_forward(w, X, None, None, compute_dtype)
    lr_logits.launches += 1
    return z


lr_logits.launches = 0

#: every kernel wrapper of this module, for launch accounting
KERNEL_WRAPPERS = (fused_lr_grad, lr_logits)
