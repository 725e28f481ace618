"""Dense logistic-regression gradient and logits: Hopper kernels and their
plain PyTorch versions.

Counterpart of ``distlr_tpu/ops/pallas_lr.py::fused_lr_grad``.  The
kernels live in ``csrc/fused_lr_grad.cu`` (see its header for the design
and what bounds it); :mod:`distlr_tpu_torch.ops.build` compiles them on
first use.

Two routes, chosen by shape (:func:`lr_launch_plan`):

* the single pass (``fused_lr_grad``, ``lr_logits``): one CTA per SM owns
  a column slice of D and reads X once through a shared-memory ring;
  it fits while w's slice plus two stages of one row's slice fit the
  227 KB of shared memory a block may use (:func:`fused_lr_supported`);
* above that, the two-launch path (``fused_lr_grad_two_launch``,
  ``lr_logits_row_blocks``): a forward launch of one block per 4 rows and
  a backward launch of one block per 2048 columns, reading X twice.  It
  is a dispatch on shape, as the JAX callers route to XLA above the TPU
  kernel's VMEM budget, never a fallback on failure.

A wrapper takes its plain version only when it is given CPU tensors.  A
CUDA tensor launches the kernel or raises: a missing compiler, a failed
build or a refused launch is an error, never a quiet fallback.  Each
wrapper counts the launches of its own kernel in a plain integer
attribute (``fused_lr_grad.launches`` and so on); a call that goes to the
two-launch path counts there.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from distlr_tpu_torch.ops import build

COMPUTE_DTYPES = ("bfloat16", "float32")
_X_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIB_NAME = "fused_lr_grad"


#: shared memory one block may use on Hopper (H100, H200): 227 KB
SMEM_LIMIT = 232_448
#: shared memory of one SM, and what the card keeps back for each block on it
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK_RESERVED = 1_024
#: the slice kernels' static shared memory (barriers, per-warp sums), rounded up
SMEM_STATIC = 3_072
#: SMs of an H100 SXM, the plan's default
H100_SMS = 132
COMPUTE_THREADS = 256   # a slice kernel's compute warps
GROUP = 8               # columns a thread reads at once (16 bytes of bf16)
#: groups of 8 columns one thread may hold as g registers (the kernel's
#: largest register tile)
MAX_GROUPS_PER_THREAD = 20
MAX_TILE_ROWS = 4
MAX_STAGES = 16
#: CTAs whose partials a resolver lane of the single pass holds (8 each)
MAX_SINGLE_PASS_CTAS = 256
#: bytes of X one CTA takes per tile: fewer tiles cost more synchronisation,
#: larger ones leave fewer stages in the ring (30 KB measured best on the H100)
TILE_BYTES = 30_720
#: stages of the streaming logits kernel, which holds nothing while waiting
LOGITS_STAGES = 2
KERNELS = ("grad", "logits")


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How a slice kernel cuts a (B, D) problem, or that it cannot.

    ``ctas`` blocks (``ctas_per_sm`` on each SM) each own ``slice_cols``
    columns (a multiple of 8; the last block owns the rest), walking X in
    tiles of ``rows`` rows through ``stages`` shared-memory stages;
    ``smem_bytes`` is what one block uses, static part included.
    ``single_pass`` is False above the shared-memory bound: the two-launch
    kernels take the shape then, and ``rows``, ``stages`` and
    ``smem_bytes`` are 0."""

    kernel: str
    batch: int
    dim: int
    ctas: int
    ctas_per_sm: int
    slice_cols: int
    rows: int
    stages: int
    groups_per_thread: int
    smem_bytes: int
    single_pass: bool

    @property
    def dynamic_smem_bytes(self) -> int:
        """The ring and w's slice: the launch's dynamic shared memory."""
        return self.smem_bytes - SMEM_STATIC if self.single_pass else 0

    def slices(self) -> list[tuple[int, int]]:
        """Each block's columns as ``[start, stop)``."""
        return [(k * self.slice_cols, min((k + 1) * self.slice_cols, self.dim))
                for k in range(self.ctas)]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _element_bytes(x_dtype) -> int:
    if x_dtype not in _X_DTYPE_CODES:
        raise TypeError(f"X must be float32 or bfloat16, got {x_dtype}")
    return 2 if x_dtype == torch.bfloat16 else 4


def _slice_plan(kernel, batch, dim, x_bytes, w_bytes, num_sms, per_sm,
                rows=None, stages=None):
    """The plan with ``per_sm`` blocks on each SM (and the given rows and
    stages, where given), or None if it does not fit."""
    slice_cols = -(-(-(-dim // (num_sms * per_sm))) // GROUP) * GROUP
    ctas = -(-dim // slice_cols)
    groups_per_thread = -(-(slice_cols // GROUP) // COMPUTE_THREADS)
    if groups_per_thread > MAX_GROUPS_PER_THREAD or (
            kernel == "grad" and ctas > MAX_SINGLE_PASS_CTAS):
        return None
    budget = min(SMEM_LIMIT, SMEM_PER_SM // per_sm - SMEM_PER_BLOCK_RESERVED)
    fixed = slice_cols * w_bytes + SMEM_STATIC
    row = slice_cols * x_bytes
    if rows is None:
        rows = max(1, min(MAX_TILE_ROWS, batch, TILE_BYTES // row))
        least = 2 if kernel == "grad" else LOGITS_STAGES
        while rows > 1 and fixed + least * rows * row > budget:
            rows //= 2
    if stages is None:
        # the single pass: as many stages as fit
        stages = (min(MAX_STAGES, (budget - fixed) // (rows * row)) if kernel == "grad"
                  else LOGITS_STAGES)
    smem = fixed + stages * rows * row
    if not (1 <= rows <= MAX_TILE_ROWS and 2 <= stages <= MAX_STAGES) or smem > budget:
        return None
    return LaunchPlan(kernel, batch, dim, ctas, per_sm, slice_cols, rows, stages,
                      groups_per_thread, smem, True)


def lr_launch_plan(batch: int, dim: int, *, x_dtype=torch.bfloat16,
                   compute_dtype: str = "bfloat16", num_sms: int = H100_SMS,
                   kernel: str = "grad", ctas_per_sm: int | None = None,
                   rows: int | None = None, stages: int | None = None) -> LaunchPlan:
    """The launch plan of a slice kernel (``"grad"``: the single pass;
    ``"logits"``: the streaming forward) for a (batch, dim) X.

    Blocks own ``ceil8(ceil(dim / (num_sms * per_sm)))`` columns each
    (fewer blocks when dim is small) and keep w's slice in shared memory
    (bf16 for bf16 products, else f32) beside a ring of tiles of X's slice,
    each about 30 KB (R <= 4 rows).  The single pass runs one block per SM
    and fills the rest of its shared memory with stages, which hold tiles
    while the grid agrees on their residuals; it needs at least 2 stages
    of one row.  The streaming forward takes 2 stages, with 2 blocks per
    SM where half an SM's shared memory holds them.  Both take the
    two-launch kernels above the single pass's bound, so one bound
    (:func:`fused_lr_supported`) covers them.

    ``ctas_per_sm``, ``rows`` and ``stages`` override the choice, for
    measuring other plans (``benchmarks/slice_kernels.py``); a plan that
    does not fit then comes back with ``single_pass`` False."""
    if batch < 1 or dim < 1:
        raise ValueError(f"need batch >= 1 and dim >= 1, got ({batch}, {dim})")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype!r}")
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    x_bytes = _element_bytes(x_dtype)
    w_bytes = 2 if compute_dtype == "bfloat16" else 4
    grad = _slice_plan("grad", batch, dim, x_bytes, w_bytes, num_sms, 1)
    if grad is not None and (ctas_per_sm, rows, stages) != (None, None, None):
        plan = _slice_plan(kernel, batch, dim, x_bytes, w_bytes, num_sms, ctas_per_sm or 1,
                           rows, stages)
    elif kernel == "grad" or grad is None:
        plan = grad
    else:
        plan = (_slice_plan("logits", batch, dim, x_bytes, w_bytes, num_sms, 2)
                or _slice_plan("logits", batch, dim, x_bytes, w_bytes, num_sms, 1))
    if plan is not None:
        return plan
    slice_cols = -(-(-(-dim // num_sms)) // GROUP) * GROUP
    return LaunchPlan(kernel, batch, dim, -(-dim // slice_cols), 1, slice_cols, 0, 0,
                      -(-(slice_cols // GROUP) // COMPUTE_THREADS), 0, False)


def fused_lr_supported(batch: int, dim: int, *, x_dtype=torch.bfloat16,
                       compute_dtype: str = "bfloat16", num_sms: int = H100_SMS) -> bool:
    """Whether the single-pass kernel takes a (batch, dim) X: w's slice
    plus two stages of one row's slice fit one block's shared memory.

    The twin of ``pallas_lr.fused_lr_supported``, which states the TPU
    kernel's VMEM budget.  On 132 SMs the bound is D <= 5,045,568 for a
    bf16 X with bf16 products, 3,784,704 with f32 products, and 3,027,552
    / 2,522,784 for an f32 X.  Above it :func:`fused_lr_grad` and
    :func:`lr_logits` take the two-launch kernels; any ``B >= 1`` and
    ``D >= 1`` is taken either way."""
    return lr_launch_plan(batch, dim, x_dtype=x_dtype, compute_dtype=compute_dtype,
                          num_sms=num_sms).single_pass


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
    return bind(build.load(_LIB_NAME))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a ``fused_lr_grad`` library."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.distlr_lr_forward.argtypes = [p, i, p, p, p, p, p, ll, ll, i, p]
    lib.distlr_lr_forward.restype = i
    lib.distlr_lr_backward.argtypes = [p, i, p, p, ll, ll, i, p]
    lib.distlr_lr_backward.restype = i
    lib.distlr_lr_grad_single_pass.argtypes = [p, i, p, p, p, p, p, p, ll, ll, i,
                                               i, i, i, i, i, i, p]
    lib.distlr_lr_grad_single_pass.restype = i
    lib.distlr_lr_logits_streaming.argtypes = [p, i, p, p, p, ll, ll, i, i, i, i, i, i, p]
    lib.distlr_lr_logits_streaming.restype = i
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


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_plan_for(X, compute_dtype: str = "bfloat16", kernel: str = "grad") -> LaunchPlan:
    """:func:`lr_launch_plan` for this X on its card."""
    B, D = X.shape
    return lr_launch_plan(B, D, x_dtype=X.dtype, compute_dtype=compute_dtype,
                          num_sms=_num_sms(X.device.index or 0), kernel=kernel)


def _plan_args(plan: LaunchPlan):
    return plan.ctas, plan.slice_cols, plan.rows, plan.stages


def run_single_pass(lib, plan: LaunchPlan, w, X, y, mask, compute_dtype: str,
                    with_logits: bool = False):
    """One launch of the single-pass kernel of ``lib`` with ``plan``;
    ``(g, z)`` (``z`` None without ``with_logits``).  Counts nothing:
    :func:`fused_lr_grad` is the counted entry point."""
    B, D = X.shape
    w = w.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    g = torch.empty(D, dtype=torch.float32, device=X.device)
    z = torch.empty(B, dtype=torch.float32, device=X.device) if with_logits else None
    # every word 0xffffffff, "not written yet": the CTAs poll for their
    # peers' partials in this buffer
    partials = torch.full((B * plan.ctas,), -1, dtype=torch.int32, device=X.device)
    rc = lib.distlr_lr_grad_single_pass(
        X.data_ptr(), _X_DTYPE_CODES[X.dtype], w.data_ptr(), y.data_ptr(),
        mask.data_ptr(), g.data_ptr(), None if z is None else z.data_ptr(),
        partials.data_ptr(), B, D,
        int(compute_dtype == "bfloat16"), *_plan_args(plan), plan.groups_per_thread,
        plan.dynamic_smem_bytes, torch.cuda.current_stream(X.device).cuda_stream)
    _raise_on(lib, rc, "lr_grad_single_pass")
    return g, z


def run_streaming(lib, plan: LaunchPlan, w, X, compute_dtype: str):
    """The streaming logits kernel of ``lib`` with ``plan`` (and its
    fixed-order second launch); (B,) f32.  Counts nothing."""
    B, D = X.shape
    w = w.to(torch.float32).contiguous()
    z = torch.empty(B, dtype=torch.float32, device=X.device)
    partials = torch.empty(B * plan.ctas, dtype=torch.float32, device=X.device)
    rc = lib.distlr_lr_logits_streaming(
        X.data_ptr(), _X_DTYPE_CODES[X.dtype], w.data_ptr(), z.data_ptr(),
        partials.data_ptr(), B, D,
        int(compute_dtype == "bfloat16"), *_plan_args(plan), plan.dynamic_smem_bytes,
        torch.cuda.current_stream(X.device).cuda_stream)
    _raise_on(lib, rc, "lr_logits_streaming")
    return z


def fused_lr_grad(w, X, y, mask, *, compute_dtype: str = "bfloat16",
                  with_logits: bool = False):
    """Unnormalized logistic gradient ``Xᵀ((σ(X·w) − y)·mask)``, (D,) f32.

    The caller divides by the batch count and adds the L2 term, as
    ``BinaryLR.grad`` does.  ``with_logits=True`` also returns the
    forward's (B,) f32 logits ``z`` — the same pass, no extra read of X.
    On the card this is the single-pass kernel, one launch; above its
    shape bound (:func:`fused_lr_supported`) the call goes to
    :func:`fused_lr_grad_two_launch`.

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
        plan = launch_plan_for(X, compute_dtype)
        if not plan.single_pass:
            return fused_lr_grad_two_launch(w, X, y, mask, compute_dtype=compute_dtype,
                                            with_logits=with_logits)
        g, z = run_single_pass(_lib(), plan, w, X, y, mask, compute_dtype, with_logits)
    fused_lr_grad.launches += 1
    return (g, z) if with_logits else g


fused_lr_grad.launches = 0


def fused_lr_grad_two_launch(w, X, y, mask, *, compute_dtype: str = "bfloat16",
                             with_logits: bool = False):
    """:func:`fused_lr_grad` through the two-launch kernels (forward row
    dots and residual, then backward column sums), which read X twice.
    :func:`fused_lr_grad` routes here above the single pass's shape bound;
    called directly, it takes any shape (the yardstick of the single pass)."""
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
    fused_lr_grad_two_launch.launches += 1
    return (g, z) if with_logits else g


fused_lr_grad_two_launch.launches = 0


def lr_logits(w, X, *, compute_dtype: str = "bfloat16"):
    """(B,) f32 logits ``X·w`` with X and w rounded to ``compute_dtype``.
    Keeps f32 logits for a bf16 X without an f32 copy of the (B, D)
    matrix.  On the card this is the streaming slice kernel, whose logits
    have the same bits as :func:`fused_lr_grad`'s ``with_logits``; above
    the shape bound the call goes to :func:`lr_logits_row_blocks`."""
    _check_inputs(w, X, compute_dtype)
    if X.device.type == "cpu":
        return lr_logits_reference(w, X, compute_dtype=compute_dtype)
    with torch.cuda.device(X.device):
        plan = launch_plan_for(X, compute_dtype, "logits")
        if not plan.single_pass:
            return lr_logits_row_blocks(w, X, compute_dtype=compute_dtype)
        z = run_streaming(_lib(), plan, w, X, compute_dtype)
    lr_logits.launches += 1
    return z


lr_logits.launches = 0


def lr_logits_row_blocks(w, X, *, compute_dtype: str = "bfloat16"):
    """:func:`lr_logits` through the two-launch path's forward kernel (one
    block per 4 rows, w re-read from L2 for every block).  :func:`lr_logits`
    routes here above the slice kernels' shape bound."""
    _check_inputs(w, X, compute_dtype)
    if X.device.type == "cpu":
        return lr_logits_reference(w, X, compute_dtype=compute_dtype)
    with torch.cuda.device(X.device):
        z, _ = _launch_forward(w, X, None, None, compute_dtype)
    lr_logits_row_blocks.launches += 1
    return z


lr_logits_row_blocks.launches = 0

#: every kernel wrapper of this module, for launch accounting
KERNEL_WRAPPERS = (fused_lr_grad, lr_logits, fused_lr_grad_two_launch, lr_logits_row_blocks)
