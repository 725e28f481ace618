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
* above that, the two-read path (``fused_lr_grad_two_launch``,
  ``lr_logits_row_blocks``): the streaming forward on narrower slices in
  several waves (:func:`lr_wide_plan`), an epilogue that sums each row's
  partials into z and the residual, and a backward launch on
  :func:`lr_backward_plan`'s grid (column tiles of 2,048 by row splits
  that meet in a thread-block cluster), reading X twice.  It is a
  dispatch on shape, as the JAX callers route to XLA above the TPU
  kernel's VMEM budget, never a fallback on failure.

The two-read path's backward launch is also a wrapper of its own,
:func:`lr_backward` (``g = rᵀX`` from residuals computed elsewhere): the
feature-sharded step of :mod:`distlr_tpu_torch.parallel.feature_parallel`
sums each row's logits over column blocks before any residual exists, so
it runs :func:`lr_logits` and :func:`lr_backward` on each block.

An int8 X (``feature_dtype="int8"``) takes the same four wrappers,
which launch the instances of the same kernels in
``csrc/fused_lr_int8.cu`` with the dequantization scale
``feature_scale`` (z times it into the sigmoid, g times it out);
``int8_dot`` quantizes w and the residual to int8 as well
(:func:`lr_logits_int8dot`, :func:`lr_backward_int8dot`, composed by
:func:`fused_lr_grad_int8dot`).

A wrapper takes its plain version only when it is given CPU tensors.  A
CUDA tensor launches the kernel or raises: a missing compiler, a failed
build or a refused launch is an error, never a quiet fallback.  Each
wrapper counts the launches of its own kernel in a plain integer
attribute (``fused_lr_grad.launches`` and so on; an int8 X's launches in
``fused_lr_grad.int8.launches``); a call that goes to the two-read path
counts there.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import torch

from distlr_tpu_torch.ops import build
from distlr_tpu_torch.ops.int8 import int8_contract, quantize_sym, sym_scale

COMPUTE_DTYPES = ("bfloat16", "float32")
_X_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_INT8_X = (torch.int8,)
#: bytes of w's slice in shared memory, by the products' type; "int8" is w
#: quantized to int8 (int8_dot, with an int8 X only)
_W_BYTES = {"bfloat16": 2, "float32": 4, "int8": 1}
#: the type of w in the kernels' C interface (the bf16 library takes 0 or 1)
_W_CODES = {"float32": 0, "bfloat16": 1, "int8": 2}
_LIB_NAME = "fused_lr_grad"
_INT8_LIB_NAME = "fused_lr_int8"


#: shared memory one block may use on Hopper (H100, H200): 227 KB
SMEM_LIMIT = 232_448
#: shared memory of one SM, and what the card keeps back for each block on it
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK_RESERVED = 1_024
#: the slice kernels' static shared memory (barriers, per-warp sums), rounded up
SMEM_STATIC = 3_072
#: SMs of an H100 SXM, the plan's default
H100_SMS = 132
COMPUTE_WARPS = 8       # a slice kernel's compute warps
#: the int8 single pass's wider instances: 4 compute warps a scheduler
WIDE_COMPUTE_WARPS = 16
GROUP = 8               # columns a thread reads at once (16 bytes of bf16)
#: bytes of X a bulk copy moves per unit: an int8 slice is a multiple of 16
#: columns, so that each of its rows is
BULK_UNIT = 16
#: groups of 8 columns one thread may hold as g registers (the kernel's
#: largest register tile), by compute warps: 640 threads of the 16-warp
#: instances leave at most 96 registers a thread
MAX_GROUPS_PER_THREAD = {COMPUTE_WARPS: 20, WIDE_COMPUTE_WARPS: 4}
MAX_TILE_ROWS = 4
#: the ring's depth with 8 compute warps; twice the warps hold half
#: (``max_stages`` in the source: the per-warp sums of each stage)
MAX_STAGES = 16
#: CTAs whose partials a resolver lane of the single pass holds (8 each)
MAX_SINGLE_PASS_CTAS = 256
#: bytes of X one CTA takes per tile: fewer tiles cost more synchronisation,
#: larger ones leave fewer stages in the ring (30 KB measured best on the H100)
TILE_BYTES = 30_720
#: stages of the streaming logits kernel, which holds nothing while waiting
LOGITS_STAGES = 2
#: blocks of the streaming forward an SM holds at once (its registers allow
#: 3: ``kLogitsCtasPerSm`` in the source), so the two-read path's plans cut
#: whole waves of this many blocks per SM; on the card the plan takes the
#: runtime's own figure (:func:`streaming_blocks_per_sm`)
WIDE_CTAS_PER_SM = 3
#: waves past the fewest that fit among which the two-read path's plan is
#: chosen
WIDE_EXTRA_WAVES = 4
KERNELS = ("grad", "logits")
#: the float backward's block (``kBwdThreads``), 8 adjacent columns a
#: thread: a column tile of 2,048
BACKWARD_THREADS = 256
BACKWARD_TILE_COLS = BACKWARD_THREADS * GROUP
#: the most row splits of a column tile: one cluster, of the portable size
MAX_BACKWARD_SPLITS = 8


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How a slice kernel cuts a (B, D) problem, or that it cannot.

    ``ctas`` blocks (``ctas_per_sm`` on each SM, in ``waves`` waves) each
    own ``slice_cols`` columns (a multiple of 8; the last block owns the
    rest), walking X in tiles of ``rows`` rows through ``stages``
    shared-memory stages with ``compute_warps`` compute warps, each thread
    of which owns ``groups_per_thread`` groups of 8 columns; ``smem_bytes``
    is what one block uses, static part included.  ``single_pass`` says
    whether the one-read route (single pass, streaming logits) takes the
    shape: an
    :func:`lr_launch_plan` plan above the shared-memory bound has it False,
    and so has every :func:`lr_wide_plan` plan, which feeds the two-read
    path.  A plan that does not fit has ``rows``, ``stages`` and
    ``smem_bytes`` 0."""

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
    waves: int = 1
    compute_warps: int = COMPUTE_WARPS

    @property
    def dynamic_smem_bytes(self) -> int:
        """The ring and w's slice: the launch's dynamic shared memory."""
        return self.smem_bytes - SMEM_STATIC if self.smem_bytes else 0

    def slices(self) -> list[tuple[int, int]]:
        """Each block's columns as ``[start, stop)``."""
        return [(k * self.slice_cols, min((k + 1) * self.slice_cols, self.dim))
                for k in range(self.ctas)]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """The float backward's grid (``distlr_lr_backward``): ``col_tiles``
    tiles of 2,048 columns by ``splits`` row splits on ``num_sms`` SMs.
    The splits of a tile form one thread-block cluster (``cluster``
    blocks; 1: no cluster) and are summed in split order."""

    batch: int
    dim: int
    num_sms: int
    col_tiles: int
    splits: int

    @property
    def blocks(self) -> int:
        return self.col_tiles * self.splits

    @property
    def cluster(self) -> int:
        return self.splits

    def row_ranges(self) -> list[tuple[int, int]]:
        """Each split's rows as ``[start, stop)``, in split order."""
        return [(k * self.batch // self.splits, (k + 1) * self.batch // self.splits)
                for k in range(self.splits)]

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self), "blocks": self.blocks, "cluster": self.cluster}


def lr_backward_plan(batch: int, dim: int, *, num_sms: int = H100_SMS) -> BackwardPlan:
    """The float backward's grid for a (batch, dim) X: column tiles of
    2,048 by row splits.  A function of its arguments alone, so two calls
    sum in the same order and give the same bits; ``csrc/fused_lr_grad.cu``
    (``backward_plan``) computes the same on the card from the runtime's
    SM count (:func:`backward_plan_for` checks that).

    A block of 256 threads reads its tile's rows in order, 16 rows'
    16-byte loads in flight a thread (64 KB a block).  The rows are split
    as far as every block keeps an SM of its own: ``num_sms // col_tiles``
    splits, at least 1, at most ``MAX_BACKWARD_SPLITS`` (8, a portable
    cluster) and at most ``batch`` (a split has a row at least).  At the
    feature-sharded block (1,024, 250,000), 123 tiles on 132 SMs, that is
    one split; from 66 tiles down (D <= 135,168) two or more.

    Why not more splits, to give the idle SMs work: an SM streams two
    blocks each slower than one, and the grid waits for its last block.
    Measured with each split count forced (``slice_kernels.py
    --backward``, bf16, on "NVIDIA H100 80GB HBM3, 700.00 W"): at (1,024,
    250,000), 123 tiles, 1 to 8 splits took 0.1702, 0.1697, 0.1780,
    0.1740, 0.1783, 0.1789, 0.1772, 0.1764 ms (``torch.mv`` 0.1760 /
    0.1710): one and two splits tie, more lose 2-5%; at (1,024, 125,000),
    62 tiles, 0.0915 / 0.0887 / 0.0911 for 1 / 2 / 3 splits; at (2,048,
    270,336), 132 tiles, 0.3518 / 0.3530 for 1 / 2.  With 8 rows in
    flight a thread (4 blocks an SM), a grid of a whole wave of resident
    blocks, 5 splits at (1,024, 250,000), was 11% slower than 2 (0.1939
    against 0.1734 ms; PERF.md)."""
    if batch < 1 or dim < 1 or num_sms < 1:
        raise ValueError(f"need batch, dim, num_sms >= 1, got {batch}, {dim}, {num_sms}")
    tiles = -(-dim // BACKWARD_TILE_COLS)
    splits = max(1, min(num_sms // tiles, MAX_BACKWARD_SPLITS, batch))
    return BackwardPlan(batch, dim, num_sms, tiles, splits)


def _element_bytes(x_dtype) -> int:
    if x_dtype not in _X_DTYPE_CODES:
        raise TypeError(f"X must be float32, bfloat16 or int8, got {x_dtype}")
    return {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[x_dtype]


def _col_align(x_bytes: int) -> int:
    """Columns a slice is a multiple of: whole groups of 8, and whole
    16-byte units of an int8 row (the bulk copies' and w's alignment)."""
    return max(GROUP, BULK_UNIT // x_bytes)


def _slice_cols(dim: int, target_ctas: int, x_bytes: int) -> int:
    align = _col_align(x_bytes)
    return -(-(-(-dim // target_ctas)) // align) * align


def _budget(per_sm: int) -> int:
    """Shared memory one of ``per_sm`` blocks on an SM may use."""
    return min(SMEM_LIMIT, SMEM_PER_SM // per_sm - SMEM_PER_BLOCK_RESERVED)


def _groups_per_thread(slice_cols: int, warps: int) -> int:
    return -(-(slice_cols // GROUP) // (warps * 32))


def _warps_to_try(kernel, x_bytes, w_bytes, compute_warps):
    """Compute warps a plan may take, in order of preference: the int8
    single pass with bf16 products takes 16 where their register tile
    holds its slice, else 8 (every other kernel 8; with f32 products 16
    warps measured slower, 1.28 against 1.25 ms at (2048, 1M))."""
    wide = kernel == "grad" and x_bytes == 1 and w_bytes == 2
    options = [WIDE_COMPUTE_WARPS, COMPUTE_WARPS] if wide else [COMPUTE_WARPS]
    return options if compute_warps is None else [w for w in options if w == compute_warps]


def _slice_plan(kernel, batch, dim, x_bytes, w_bytes, per_sm, target_ctas,
                rows=None, stages=None, waves=1, compute_warps=None):
    """The plan of about ``target_ctas`` blocks, ``per_sm`` on each SM (and
    the given rows, stages and compute warps, where given), or None if it
    does not fit."""
    for warps in _warps_to_try(kernel, x_bytes, w_bytes, compute_warps):
        plan = _slice_plan_for(kernel, batch, dim, x_bytes, w_bytes, per_sm, target_ctas,
                               rows, stages, waves, warps)
        if plan is not None:
            return plan
    return None


def _slice_plan_for(kernel, batch, dim, x_bytes, w_bytes, per_sm, target_ctas, rows, stages,
                    waves, warps):
    slice_cols = _slice_cols(dim, target_ctas, x_bytes)
    ctas = -(-dim // slice_cols)
    groups_per_thread = _groups_per_thread(slice_cols, warps)
    if groups_per_thread > MAX_GROUPS_PER_THREAD[warps] or (
            kernel == "grad" and ctas > MAX_SINGLE_PASS_CTAS):
        return None
    max_stages = MAX_STAGES * COMPUTE_WARPS // warps
    budget = _budget(per_sm)
    fixed = slice_cols * w_bytes + SMEM_STATIC
    row = slice_cols * x_bytes
    if rows is None:
        rows = max(1, min(MAX_TILE_ROWS, batch, TILE_BYTES // row))
        least = 2 if kernel == "grad" else LOGITS_STAGES
        while rows > 1 and fixed + least * rows * row > budget:
            rows //= 2
    if stages is None:
        # the single pass: as many stages as fit
        stages = (min(max_stages, (budget - fixed) // (rows * row)) if kernel == "grad"
                  else LOGITS_STAGES)
    smem = fixed + stages * rows * row
    if not (1 <= rows <= MAX_TILE_ROWS and 2 <= stages <= max_stages) or smem > budget:
        return None
    return LaunchPlan(kernel, batch, dim, ctas, per_sm, slice_cols, rows, stages,
                      groups_per_thread, smem, True, waves, warps)


def _check_plan_args(batch, dim, x_dtype, compute_dtype):
    """(x_bytes, w_bytes) of a plan's arguments, or raise on bad ones.
    ``compute_dtype="int8"`` (an int8 w: int8_dot) goes with an int8 X."""
    if batch < 1 or dim < 1:
        raise ValueError(f"need batch >= 1 and dim >= 1, got ({batch}, {dim})")
    if compute_dtype not in COMPUTE_DTYPES and not (
            compute_dtype == "int8" and x_dtype == torch.int8):
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype!r}")
    return _element_bytes(x_dtype), _W_BYTES[compute_dtype]


def lr_launch_plan(batch: int, dim: int, *, x_dtype=torch.bfloat16,
                   compute_dtype: str = "bfloat16", num_sms: int = H100_SMS,
                   kernel: str = "grad", ctas_per_sm: int | None = None,
                   rows: int | None = None, stages: int | None = None,
                   compute_warps: int | None = None) -> LaunchPlan:
    """The launch plan of a slice kernel (``"grad"``: the single pass;
    ``"logits"``: the streaming forward) for a (batch, dim) X.

    Blocks own ``ceil8(ceil(dim / (num_sms * per_sm)))`` columns each
    (fewer blocks when dim is small) and keep w's slice in shared memory
    (bf16 for bf16 products, else f32) beside a ring of tiles of X's slice,
    each about 30 KB (R <= 4 rows).  The single pass runs one block per SM
    and fills the rest of its shared memory with stages, which hold tiles
    while the grid agrees on their residuals; it needs at least 2 stages
    of one row.  Its compute warps are 8, but for an int8 X with bf16
    products, whose tiles hold twice a bf16 tile's elements: 16 where a
    register tile of at most 4 groups a thread holds the slice (D <=
    2,162,688 on 132 SMs), with at most 8 stages.  The streaming forward
    takes 2 stages, with 2 blocks per SM where half an SM's shared memory
    holds them.  Both take the two-read path above the single pass's
    bound, so one bound (:func:`fused_lr_supported`) covers them.

    ``ctas_per_sm``, ``rows``, ``stages`` and ``compute_warps`` override
    the choice, for measuring other plans (``benchmarks/slice_kernels.py``);
    a plan that does not fit then comes back with ``single_pass`` False."""
    x_bytes, w_bytes = _check_plan_args(batch, dim, x_dtype, compute_dtype)
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    grad = _slice_plan("grad", batch, dim, x_bytes, w_bytes, 1, num_sms)
    if grad is not None and (ctas_per_sm, rows, stages, compute_warps) != (None,) * 4:
        per_sm = ctas_per_sm or 1
        plan = _slice_plan(kernel, batch, dim, x_bytes, w_bytes, per_sm, num_sms * per_sm,
                           rows, stages, compute_warps=compute_warps)
    elif kernel == "grad" or grad is None:
        plan = grad
    else:
        plan = (_slice_plan("logits", batch, dim, x_bytes, w_bytes, 2, num_sms * 2)
                or _slice_plan("logits", batch, dim, x_bytes, w_bytes, 1, num_sms))
    if plan is not None:
        return plan
    return _no_fit(kernel, batch, dim, 1, num_sms, 1, x_bytes)


def _no_fit(kernel, batch, dim, per_sm, target_ctas, waves, x_bytes) -> LaunchPlan:
    """A plan that does not fit: its cut of D, with no rows, stages or
    shared memory."""
    slice_cols = _slice_cols(dim, target_ctas, x_bytes)
    return LaunchPlan(kernel, batch, dim, -(-dim // slice_cols), per_sm, slice_cols, 0, 0,
                      _groups_per_thread(slice_cols, COMPUTE_WARPS), 0, False, waves)


@functools.lru_cache(maxsize=256)  # the wrappers ask on every call
def lr_wide_plan(batch: int, dim: int, *, x_dtype=torch.bfloat16,
                 compute_dtype: str = "bfloat16", num_sms: int = H100_SMS,
                 ctas_per_sm: int | None = None, waves: int | None = None) -> LaunchPlan:
    """The streaming forward's plan on the two-read path, for any (batch,
    dim): ``waves * ctas_per_sm * num_sms`` blocks of narrower slices.

    The streaming forward waits on no other block, so its grid need not be
    resident at once: where w's slice plus two stages of one wave's slices
    do not fit an SM's shared memory (above :func:`fused_lr_supported`'s
    bound), more blocks of fewer columns run in several waves.  Each block
    keeps its slice of w in shared memory beside a ring of 2 tiles of
    ``rows`` <= 4 rows, about 30 KB each.  A wave is the ``ctas_per_sm``
    blocks (default ``WIDE_CTAS_PER_SM``; :func:`wide_plan_for` asks the
    runtime) that an SM holds at once, so the plan's waves are the card's:
    no ragged last wave (:func:`whole_waves`).  ``waves`` defaults to the
    count, among the fewest that fit and the next ``WIDE_EXTRA_WAVES``,
    whose blocks fill whole waves and hold the most bytes of X in flight
    (ring bytes; fewer waves on a tie): narrower slices leave more of a
    block's shared memory to the ring, up to 4-row tiles.  A dim under one
    wave of 8-column slices takes fewer blocks, in one wave.

    At (64, 6M) bf16 on 132 SMs: 3 waves of 3 blocks per SM, 1,187 blocks
    of 5,056 columns, 3-row tiles, about 72 KB of shared memory a block.

    ``waves``, and a ``ctas_per_sm`` other than the card's, override the
    choice, for measuring other plans (``benchmarks/slice_kernels.py
    --wide``); a plan that does not fit then comes back with ``rows``,
    ``stages`` and ``smem_bytes`` 0.  ``single_pass`` is always False:
    this plan is never given to the cooperative single pass."""
    x_bytes, w_bytes = _check_plan_args(batch, dim, x_dtype, compute_dtype)
    per_sm = WIDE_CTAS_PER_SM if ctas_per_sm is None else ctas_per_sm
    if per_sm < 1 or (waves is not None and waves < 1):
        raise ValueError(f"need ctas_per_sm >= 1 and waves >= 1, got {per_sm}, {waves}")
    wave = per_sm * num_sms
    if waves is None:
        # from the fewest waves whose slices fit with 1-row tiles
        align = _col_align(x_bytes)
        most_cols = ((_budget(per_sm) - SMEM_STATIC) // (w_bytes + LOGITS_STAGES * x_bytes)
                     // align * align)
        if most_cols < align:
            raise ValueError(f"{per_sm} blocks per SM leave too little shared memory")
        first = max(1, -(-dim // (wave * most_cols)))
        candidates = range(first, first + 1 + WIDE_EXTRA_WAVES)
    else:
        candidates = [waves]
    plans = [p for n in candidates
             if (p := _slice_plan("logits", batch, dim, x_bytes, w_bytes, per_sm, n * wave,
                                  waves=n)) is not None]
    if waves is None:
        # the first wave count with a partial wave ends the list: more
        # waves would only add blocks with no columns
        whole = [p for p in plans if whole_waves(p, num_sms)]
        whole = whole[:next((i + 1 for i, p in enumerate(whole) if p.ctas < wave), None)]
        plans = [max(whole, key=lambda p: (_ring_bytes(p, x_bytes), -p.waves))] if whole \
            else plans[:1]
    if not plans:
        return _no_fit("logits", batch, dim, per_sm, waves * wave, waves, x_bytes)
    return dataclasses.replace(plans[0], single_pass=False)


def whole_waves(plan: LaunchPlan, num_sms: int) -> bool:
    """Whether ``plan``'s blocks fill its waves: a single partial wave, or
    ``waves`` full ones but for fewer blocks than one per 8 SMs (slices
    rounded up to 8 columns can leave the last few blocks no columns to
    own, so they are not launched)."""
    wave = plan.ctas_per_sm * num_sms
    if plan.waves == 1:
        return plan.ctas <= wave
    return 0 <= plan.waves * wave - plan.ctas < max(1, num_sms // 8)


def _ring_bytes(plan: LaunchPlan, x_bytes: int) -> int:
    return plan.stages * plan.rows * plan.slice_cols * x_bytes


def fused_lr_supported(batch: int, dim: int, *, x_dtype=torch.bfloat16,
                       compute_dtype: str = "bfloat16", num_sms: int = H100_SMS) -> bool:
    """Whether the single-pass kernel takes a (batch, dim) X: w's slice
    plus two stages of one row's slice fit one block's shared memory.

    The twin of ``pallas_lr.fused_lr_supported``, which states the TPU
    kernel's VMEM budget.  On 132 SMs the bound is D <= 5,045,568 for a
    bf16 X with bf16 products, 3,784,704 with f32 products, and 3,027,552
    / 2,522,784 for an f32 X.  For an int8 X (slices of 16-column
    multiples) it is 5,406,720 with bf16 products, where the register
    tile (20 groups of 8 columns a thread) binds before shared memory,
    and 5,045,568 with f32 products; the int8_dot forward (int8 w) shares
    the first.  Above it :func:`fused_lr_grad` and
    :func:`lr_logits` take the two-read path; any ``B >= 1`` and
    ``D >= 1`` is taken either way."""
    return lr_launch_plan(batch, dim, x_dtype=x_dtype, compute_dtype=compute_dtype,
                          num_sms=num_sms).single_pass


def _round(t: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    if compute_dtype == "bfloat16":
        return t.to(torch.bfloat16).to(torch.float32)
    return t.to(torch.float32)


def _scaled(v: torch.Tensor, scale: float) -> torch.Tensor:
    return v if scale == 1.0 else v * scale


def lr_logits_reference(w, X, *, compute_dtype: str = "bfloat16", feature_scale: float = 1.0):
    """Plain version of :func:`lr_logits` (for an int8 X too, given its
    ``feature_scale``): f32 ``X @ w`` with both
    operands rounded to ``compute_dtype``, times the scale."""
    return _scaled(_round(X, compute_dtype) @ _round(w, compute_dtype), feature_scale)


def lr_backward_reference(X, r, *, compute_dtype: str = "bfloat16", feature_scale: float = 1.0):
    """Plain version of :func:`lr_backward`: f32 ``rᵀX`` with X rounded to
    ``compute_dtype`` and r kept f32 (the two-read path's backward keeps
    the residual f32, as the TPU kernel does), times the scale."""
    return _scaled(r.to(torch.float32) @ _round(X, compute_dtype), feature_scale)


def _residual(z, y, mask):
    return (torch.sigmoid(z) - y.to(torch.float32)) * mask.to(torch.float32)


def _grad_reference(w, X, y, mask, compute_dtype, feature_scale=1.0):
    Xc = _round(X, compute_dtype)
    z = _scaled(Xc @ _round(w, compute_dtype), feature_scale)
    return _scaled(_residual(z, y, mask) @ Xc, feature_scale), z


def fused_lr_grad_reference(w, X, y, mask, *, compute_dtype: str = "bfloat16",
                            feature_scale: float = 1.0):
    """Plain version of :func:`fused_lr_grad`:
    ``Xᵀ((σ(X·w) − y)·mask)`` in f32 after rounding X and w to
    ``compute_dtype``; the residual stays f32, as in the TPU kernel.  With
    an int8 X, X dequantized by
    ``feature_scale`` (z times it, g times it)."""
    return _grad_reference(w, X, y, mask, compute_dtype, feature_scale)[0]


def int8dot_weight_grid(w, w_amax=None):
    """``(wq, s_w)``: w quantized on the symmetric int8 grid of ``w_amax``
    (default ``max|w|``, w's own grid).  A feature-sharded step passes the
    maximum over every shard of w, as the JAX step's ``lax.pmax`` gives it,
    so that each shard lands on the global grid."""
    w = w.to(torch.float32)
    return quantize_sym(w, torch.amax(w.abs()) if w_amax is None else w_amax)


def lr_logits_int8dot_reference(w, X, *, feature_scale: float = 1.0, w_amax=None):
    """Plain version of :func:`lr_logits_int8dot`, the JAX model's int8_dot
    logits: w quantized on its own grid (or on the grid of ``w_amax``),
    ``int8_contract(X, wq) * (s_w · feature_scale)``."""
    wq, s_w = int8dot_weight_grid(w, w_amax)
    return int8_contract(X, wq, 1) * (s_w * feature_scale)


def lr_backward_int8dot_reference(X, r, *, feature_scale: float = 1.0):
    """Plain version of :func:`lr_backward_int8dot`: the residuals quantized
    on their own grid, ``int8_contract(rq, X) * (s_r · feature_scale)``."""
    rq, s_r = quantize_sym(r, r.abs().max())
    return int8_contract(rq, X, 0) * (s_r * feature_scale)


def fused_lr_grad_int8dot_reference(w, X, y, mask, *, feature_scale: float = 1.0):
    """Plain version of :func:`fused_lr_grad_int8dot` (unnormalized, like
    :func:`fused_lr_grad`)."""
    z = lr_logits_int8dot_reference(w, X, feature_scale=feature_scale)
    return lr_backward_int8dot_reference(X, _residual(z, y, mask), feature_scale=feature_scale)


def _check_inputs(w, X, compute_dtype, y=None, mask=None, *, x_dtypes=tuple(_X_DTYPE_CODES),
                  feature_scale: float = 1.0) -> None:
    """Shapes, dtypes, devices and the scale; ``w`` may be None (a
    backward alone), ``compute_dtype`` None (int8_dot: products are int8)."""
    if compute_dtype is not None and compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype!r}")
    if X.dim() != 2:
        raise ValueError(f"X must be (B, D), got shape {tuple(X.shape)}")
    B, D = X.shape
    if B < 1 or D < 1:
        raise ValueError(f"X must have B >= 1 and D >= 1, got {tuple(X.shape)}")
    if X.dtype not in x_dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in x_dtypes)
        raise TypeError(f"X must be {names}, got {X.dtype}")
    if feature_scale != 1.0 and X.dtype != torch.int8:
        raise ValueError(f"feature_scale={feature_scale} dequantizes an int8 X; got {X.dtype}")
    if w is not None and w.shape != (D,):
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


@functools.cache
def _int8_lib() -> ctypes.CDLL:
    return bind(build.load(_INT8_LIB_NAME))


def _lib_for(x_dtype) -> ctypes.CDLL:
    """The library holding the instances for this X dtype."""
    return _int8_lib() if x_dtype == torch.int8 else _lib()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a ``fused_lr_grad`` or
    ``fused_lr_int8`` library (the latter also has the int8_dot pair)."""
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.distlr_lr_backward.argtypes = [p, i, p, p, ll, ll, i, f, p]
    lib.distlr_lr_backward.restype = i
    lib.distlr_lr_grad_single_pass.argtypes = [p, i, p, p, p, p, p, p, ll, ll, i, f,
                                               i, i, i, i, i, i, i, p]
    lib.distlr_lr_grad_single_pass.restype = i
    lib.distlr_lr_logits_streaming.argtypes = [p, i, p, p, p, p, p, p, ll, ll, i, f,
                                               i, i, i, i, i, p]
    lib.distlr_lr_logits_streaming.restype = i
    lib.distlr_lr_logits_blocks_per_sm.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.distlr_lr_logits_blocks_per_sm.restype = i
    lib.distlr_cuda_error_string.argtypes = [i]
    lib.distlr_cuda_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "distlr_lr_backward_plan"):
        lib.distlr_lr_backward_splits.argtypes = [p, i, p, p, ll, ll, i, i, p]
        lib.distlr_lr_backward_splits.restype = i
        lib.distlr_lr_backward_plan.argtypes = [i, i, ll, ll, ctypes.POINTER(ll)]
        lib.distlr_lr_backward_plan.restype = i
    if hasattr(lib, "distlr_lr_logits_int8dot"):
        lib.distlr_lr_logits_int8dot.argtypes = [p, p, p, p, p, p, p, p, ll, ll, f,
                                                 i, i, i, i, i, p]
        lib.distlr_lr_logits_int8dot.restype = i
        lib.distlr_lr_backward_int8dot.argtypes = [p, p, p, p, ll, ll, f, p]
        lib.distlr_lr_backward_int8dot.restype = i
        lib.distlr_lr_backward_grid.argtypes = [ll, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.distlr_lr_backward_grid.restype = i
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.distlr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_plan_for(X, compute_dtype: str = "bfloat16", kernel: str = "grad") -> LaunchPlan:
    """:func:`lr_launch_plan` for this X on its card."""
    B, D = X.shape
    return lr_launch_plan(B, D, x_dtype=X.dtype, compute_dtype=compute_dtype,
                          num_sms=_num_sms(X.device.index or 0), kernel=kernel)


def streaming_blocks_per_sm(lib, x_dtype, compute_dtype: str, smem_bytes: int = 0) -> int:
    """Blocks of the streaming forward (its instance for ``x_dtype`` and
    ``compute_dtype``; ``"int8"``: the int8_dot forward) that an SM of the
    current card holds at once with ``smem_bytes`` of dynamic shared
    memory, as the runtime's occupancy calculator reports it; with 0, what
    its registers and threads allow."""
    blocks = ctypes.c_int(0)
    rc = lib.distlr_lr_logits_blocks_per_sm(_X_DTYPE_CODES[x_dtype], _W_CODES[compute_dtype],
                                            smem_bytes, ctypes.byref(blocks))
    if rc != 0:
        msg = lib.distlr_cuda_error_string(rc).decode()
        raise RuntimeError(f"lr_logits_streaming occupancy query failed: CUDA error {rc} ({msg})")
    return blocks.value


@functools.cache
def _wide_ctas_per_sm(index: int, x_dtype, compute_dtype: str) -> int:
    with torch.cuda.device(index):
        return streaming_blocks_per_sm(_lib_for(x_dtype), x_dtype, compute_dtype)


def wide_plan_for(X, compute_dtype: str = "bfloat16") -> LaunchPlan:
    """:func:`lr_wide_plan` for this X on its card, in waves of the blocks
    the runtime says an SM holds."""
    B, D = X.shape
    index = X.device.index or 0
    return lr_wide_plan(B, D, x_dtype=X.dtype, compute_dtype=compute_dtype,
                        num_sms=_num_sms(index),
                        ctas_per_sm=_wide_ctas_per_sm(index, X.dtype, compute_dtype))


def int8_backward_grid(X) -> dict:
    """The launch of the two-read path's backward for this int8 X on its
    card (``csrc/fused_lr_int8.cu``): a grid of the blocks an SM holds at
    once (the runtime's occupancy figure) times the SMs, each thread owning
    8 columns, fewer blocks where D has fewer 2,048-column blocks."""
    blocks, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(X.device):
        lib = _int8_lib()
        rc = lib.distlr_lr_backward_grid(X.shape[1], ctypes.byref(blocks), ctypes.byref(per_sm))
    _raise_on(lib, rc, "lr_backward grid query")
    return {"blocks": blocks.value, "blocks_per_sm": per_sm.value}


def backward_plan_for(X, compute_dtype: str = "bfloat16") -> dict:
    """The float backward's launch for this X on its card: the plan the
    kernel library computes (``distlr_lr_backward_plan``), held to
    :func:`lr_backward_plan` on the runtime's SM count, with the blocks an
    SM holds and the clusters of the plan's size the card holds at once
    (0 with one split), as the runtime reports them.  Raises where the two
    plans disagree or the card cannot hold one cluster of the plan."""
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the float backward's plan needs a float32 or bfloat16 X, got {X.dtype}")
    B, D = X.shape
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(X.device):
        lib = _lib()
        rc = lib.distlr_lr_backward_plan(_X_DTYPE_CODES[X.dtype], int(compute_dtype == "bfloat16"),
                                         B, D, out)
    _raise_on(lib, rc, "lr_backward plan query")
    plan = lr_backward_plan(B, D, num_sms=_num_sms(X.device.index or 0))
    if (int(out[0]), int(out[1])) != (plan.col_tiles, plan.splits):
        raise RuntimeError(f"the kernel's backward plan (tiles, splits) {tuple(out[:2])} is not "
                           f"lr_backward_plan's {(plan.col_tiles, plan.splits)}")
    return {**plan.as_dict(), "blocks_per_sm": int(out[2]), "clusters_resident": int(out[3])}


def _plan_args(plan: LaunchPlan):
    return plan.ctas, plan.slice_cols, plan.rows, plan.stages


def _stream(X) -> int:
    return torch.cuda.current_stream(X.device).cuda_stream


def run_single_pass(lib, plan: LaunchPlan, w, X, y, mask, compute_dtype: str,
                    with_logits: bool = False, feature_scale: float = 1.0):
    """One launch of the single-pass kernel of ``lib`` with ``plan``;
    ``(g, z)`` (``z`` None without ``with_logits``).  ``feature_scale`` is
    an int8 X's.  Counts nothing: :func:`fused_lr_grad` is the counted
    entry point."""
    if plan.kernel != "grad" or not plan.single_pass:
        raise ValueError(f"not a plan of the single pass: {plan}")
    B, D = X.shape
    w = w.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    g = torch.empty(D, dtype=torch.float32, device=X.device)
    z = torch.empty(B, dtype=torch.float32, device=X.device) if with_logits else None
    # every word 0xffffffff, "not written yet": the CTAs poll for their
    # peers' partials in this buffer, or count them in its last B words
    partials = torch.full((B * plan.ctas + B,), -1, dtype=torch.int32, device=X.device)
    rc = lib.distlr_lr_grad_single_pass(
        X.data_ptr(), _X_DTYPE_CODES[X.dtype], w.data_ptr(), y.data_ptr(),
        mask.data_ptr(), g.data_ptr(), None if z is None else z.data_ptr(),
        partials.data_ptr(), B, D,
        int(compute_dtype == "bfloat16"), feature_scale, *_plan_args(plan),
        plan.groups_per_thread, plan.compute_warps, plan.dynamic_smem_bytes, _stream(X))
    _raise_on(lib, rc, "lr_grad_single_pass")
    return g, z


def _streaming_outputs(X, plan: LaunchPlan, y, mask):
    """(z, r, partials, y, mask) for a streaming launch: r, y and mask
    None without labels."""
    if plan.kernel != "logits" or not plan.smem_bytes:
        raise ValueError(f"not a fitting plan of the streaming forward: {plan}")
    B = X.shape[0]
    z = torch.empty(B, dtype=torch.float32, device=X.device)
    r = None
    if y is not None:
        y = y.to(torch.float32).contiguous()
        mask = mask.to(torch.float32).contiguous()
        r = torch.empty(B, dtype=torch.float32, device=X.device)
    # per call: B * ctas words, 9.7 MB at (2048, 6M) on the wide plan
    partials = torch.empty(B * plan.ctas, dtype=torch.float32, device=X.device)
    return z, r, partials, y, mask


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def run_streaming(lib, plan: LaunchPlan, w, X, compute_dtype: str, y=None, mask=None,
                  feature_scale: float = 1.0):
    """The streaming forward of ``lib`` with ``plan`` (any fitting
    ``"logits"`` plan: :func:`lr_launch_plan`'s or :func:`lr_wide_plan`'s),
    then the fixed-order epilogue; (B,) f32 z, or ``(z, r)`` given y and
    mask, with the residuals ``r = (σ(z) − y)·mask``.  ``feature_scale`` is
    an int8 X's.  Counts nothing."""
    z, r, partials, y, mask = _streaming_outputs(X, plan, y, mask)
    B, D = X.shape
    w = w.to(torch.float32).contiguous()
    rc = lib.distlr_lr_logits_streaming(
        X.data_ptr(), _X_DTYPE_CODES[X.dtype], w.data_ptr(), _ptr(y), _ptr(mask),
        z.data_ptr(), _ptr(r), partials.data_ptr(), B, D,
        int(compute_dtype == "bfloat16"), feature_scale, *_plan_args(plan),
        plan.dynamic_smem_bytes, _stream(X))
    _raise_on(lib, rc, "lr_logits_streaming")
    return z if r is None else (z, r)


def run_two_read(lib, plan: LaunchPlan, w, X, y, mask, compute_dtype: str,
                 feature_scale: float = 1.0):
    """The two-read gradient of ``lib``: the streaming forward with
    ``plan`` and the residual epilogue, then the backward column sums;
    ``(g, z)``.  Counts nothing."""
    z, r = run_streaming(lib, plan, w, X, compute_dtype, y, mask, feature_scale)
    return run_backward(lib, X, r, compute_dtype, feature_scale), z


def run_backward(lib, X, r, compute_dtype: str, feature_scale: float = 1.0):
    """The two-read path's backward of ``lib``: ``g = (rᵀX) · feature_scale``
    (D,) f32 from the (B,) f32 residuals ``r``; a float X on the grid of
    :func:`lr_backward_plan`.  Counts nothing."""
    B, D = X.shape
    r = r.to(torch.float32).contiguous()
    g = torch.empty(D, dtype=torch.float32, device=X.device)
    rc = lib.distlr_lr_backward(X.data_ptr(), _X_DTYPE_CODES[X.dtype], r.data_ptr(),
                                g.data_ptr(), B, D, int(compute_dtype == "bfloat16"),
                                feature_scale, _stream(X))
    _raise_on(lib, rc, "lr_backward")
    return g


def run_int8dot_forward(lib, plan: LaunchPlan, wq, w_scale, X, feature_scale: float,
                        y=None, mask=None):
    """The int8_dot forward of ``lib`` with ``plan`` (a fitting
    ``"logits"`` plan for compute_dtype ``"int8"``): ``z = (X·wq) · (s_w ·
    feature_scale)``, and ``(z, r)`` given y and mask; ``w_scale`` is the
    (0-dim, on the card) scale of wq's grid.  Counts nothing."""
    z, r, partials, y, mask = _streaming_outputs(X, plan, y, mask)
    B, D = X.shape
    rc = lib.distlr_lr_logits_int8dot(
        X.data_ptr(), wq.contiguous().data_ptr(), w_scale.data_ptr(), _ptr(y), _ptr(mask),
        z.data_ptr(), _ptr(r), partials.data_ptr(), B, D, feature_scale, *_plan_args(plan),
        plan.dynamic_smem_bytes, _stream(X))
    _raise_on(lib, rc, "lr_logits_int8dot")
    return z if r is None else (z, r)


def run_int8dot_backward(lib, X, r, r_scale, feature_scale: float):
    """The int8_dot backward of ``lib``: ``g = (rqᵀX) · (s_r ·
    feature_scale)``, rq the residuals quantized on the grid of
    ``r_scale`` (0-dim, on the card) as the kernel stages them.  Counts
    nothing."""
    B, D = X.shape
    r = r.to(torch.float32).contiguous()
    g = torch.empty(D, dtype=torch.float32, device=X.device)
    rc = lib.distlr_lr_backward_int8dot(X.data_ptr(), r.data_ptr(), r_scale.data_ptr(),
                                        g.data_ptr(), B, D, feature_scale, _stream(X))
    _raise_on(lib, rc, "lr_backward_int8dot")
    return g


class Int8Instance:
    """The launch count of a wrapper's int8-X instance (``csrc/fused_lr_int8.cu``),
    kept apart from the wrapper's own count of its float instances:
    ``fused_lr_grad.int8.launches`` and so on.  It carries a wrapper's
    ``__name__`` (the wrapper's with ``_int8``) so that it stands beside the
    wrappers in :data:`KERNEL_WRAPPERS`."""

    def __init__(self, wrapper) -> None:
        self.__name__ = f"{wrapper.__name__}_int8"
        self.launches = 0


_count_lock = threading.Lock()


def _count(wrapper, X) -> None:
    """One launch of ``wrapper``'s kernel: its int8 instance's for an int8 X.
    Locked: PS worker threads launch side by side."""
    with _count_lock:
        (wrapper.int8 if X.dtype == torch.int8 else wrapper).launches += 1


def fused_lr_grad(w, X, y, mask, *, compute_dtype: str = "bfloat16",
                  feature_scale: float = 1.0, with_logits: bool = False):
    """Unnormalized logistic gradient ``Xᵀ((σ(X·w) − y)·mask)``, (D,) f32.

    The caller divides by the batch count and adds the L2 term, as
    ``BinaryLR.grad`` does.  ``with_logits=True`` also returns the
    forward's (B,) f32 logits ``z`` — the same pass, no extra read of X.
    On the card this is the single-pass kernel, one launch; above its
    shape bound (:func:`fused_lr_supported`) the call goes to
    :func:`fused_lr_grad_two_launch`.

    Args:
      w: (D,) weights.  X: (B, D) float32, bfloat16 or int8 features.
      y: (B,) labels; mask: (B,) validity (both cast to f32).
      compute_dtype: "bfloat16" rounds X and w to bf16 before the
        products (the TPU kernel's casts); "float32" keeps full f32.
      feature_scale: an int8 X's dequantization scale ``s`` (X holds
        ``round(X_real / s)``): ``s · Xᵀ((σ(s · X·w) − y)·mask)`` and
        ``z = s · X·w``, on the kernels' int8 instances, X read at one byte
        an element.  A float X takes only 1.0.
    """
    _check_inputs(w, X, compute_dtype, y, mask, feature_scale=feature_scale)
    if X.device.type == "cpu":
        g, z = _grad_reference(w, X, y, mask, compute_dtype, feature_scale)
        return (g, z) if with_logits else g
    with torch.cuda.device(X.device):
        plan = launch_plan_for(X, compute_dtype)
        if not plan.single_pass:
            return fused_lr_grad_two_launch(w, X, y, mask, compute_dtype=compute_dtype,
                                            feature_scale=feature_scale,
                                            with_logits=with_logits)
        g, z = run_single_pass(_lib_for(X.dtype), plan, w, X, y, mask, compute_dtype,
                               with_logits, feature_scale)
    _count(fused_lr_grad, X)
    return (g, z) if with_logits else g


def fused_lr_grad_two_launch(w, X, y, mask, *, compute_dtype: str = "bfloat16",
                             feature_scale: float = 1.0, with_logits: bool = False):
    """:func:`fused_lr_grad` through the two-read path: three launches,
    the streaming forward on :func:`lr_wide_plan`'s multi-wave plan, the
    epilogue that sums each row's partials into z and the residual, then
    the backward column sums.  X is read twice.  ``with_logits`` returns
    the epilogue's z, the same bits as :func:`lr_logits_row_blocks`.
    :func:`fused_lr_grad` routes here above the single pass's shape bound;
    called directly, it takes any shape (the yardstick of the single pass)."""
    _check_inputs(w, X, compute_dtype, y, mask, feature_scale=feature_scale)
    if X.device.type == "cpu":
        g, z = _grad_reference(w, X, y, mask, compute_dtype, feature_scale)
        return (g, z) if with_logits else g
    with torch.cuda.device(X.device):
        g, z = run_two_read(_lib_for(X.dtype), wide_plan_for(X, compute_dtype), w, X, y, mask,
                            compute_dtype, feature_scale)
    _count(fused_lr_grad_two_launch, X)
    return (g, z) if with_logits else g


def lr_logits(w, X, *, compute_dtype: str = "bfloat16", feature_scale: float = 1.0):
    """(B,) f32 logits ``X·w`` with X and w rounded to ``compute_dtype``
    (times an int8 X's ``feature_scale``, as in :func:`fused_lr_grad`).
    Keeps f32 logits for a bf16 X without an f32 copy of the (B, D)
    matrix.  On the card this is the streaming slice kernel, whose logits
    have the same bits as :func:`fused_lr_grad`'s ``with_logits``; above
    the shape bound the call goes to :func:`lr_logits_row_blocks`."""
    _check_inputs(w, X, compute_dtype, feature_scale=feature_scale)
    if X.device.type == "cpu":
        return lr_logits_reference(w, X, compute_dtype=compute_dtype,
                                   feature_scale=feature_scale)
    with torch.cuda.device(X.device):
        plan = launch_plan_for(X, compute_dtype, "logits")
        if not plan.single_pass:
            return lr_logits_row_blocks(w, X, compute_dtype=compute_dtype,
                                        feature_scale=feature_scale)
        z = run_streaming(_lib_for(X.dtype), plan, w, X, compute_dtype,
                          feature_scale=feature_scale)
    _count(lr_logits, X)
    return z


def lr_logits_row_blocks(w, X, *, compute_dtype: str = "bfloat16", feature_scale: float = 1.0):
    """:func:`lr_logits` through the two-read path's forward: the streaming
    kernel on :func:`lr_wide_plan`'s multi-wave plan, then the fixed-order
    sum of each row's partials (two launches, one read of X, each column
    of w read once).  :func:`lr_logits` routes here above the slice
    kernels' shape bound."""
    _check_inputs(w, X, compute_dtype, feature_scale=feature_scale)
    if X.device.type == "cpu":
        return lr_logits_reference(w, X, compute_dtype=compute_dtype,
                                   feature_scale=feature_scale)
    with torch.cuda.device(X.device):
        z = run_streaming(_lib_for(X.dtype), wide_plan_for(X, compute_dtype), w, X,
                          compute_dtype, feature_scale=feature_scale)
    _count(lr_logits_row_blocks, X)
    return z


def lr_backward(X, r, *, compute_dtype: str = "bfloat16", feature_scale: float = 1.0):
    """The backward alone: ``g = (rᵀX) · feature_scale``, (D,) f32, from a
    (B, D) f32, bf16 or int8 X and (B,) residuals r, kept f32 (X rounded to
    ``compute_dtype``).  Unnormalized, like :func:`fused_lr_grad`.  On the
    card this is the two-read path's backward launch (the int8 instance's
    for an int8 X, counted as ``lr_backward_int8``): the gradient of a
    residual computed elsewhere, as the feature-sharded step computes it
    from the logits summed over every column block."""
    _check_inputs(None, X, compute_dtype, feature_scale=feature_scale)
    if r.shape != X.shape[:1] or r.device != X.device:
        raise ValueError(f"r must be ({X.shape[0]},) on {X.device}, got {tuple(r.shape)} "
                         f"on {r.device}")
    if X.device.type == "cpu":
        return lr_backward_reference(X, r, compute_dtype=compute_dtype,
                                     feature_scale=feature_scale)
    with torch.cuda.device(X.device):
        g = run_backward(_lib_for(X.dtype), X, r, compute_dtype, feature_scale)
    _count(lr_backward, X)
    return g


#: the wrappers of a float or an int8 X, each with its int8 instance's count
_DENSE_WRAPPERS = (fused_lr_grad, lr_logits, fused_lr_grad_two_launch, lr_logits_row_blocks,
                   lr_backward)
for _wrapper in _DENSE_WRAPPERS:
    _wrapper.launches = 0
    _wrapper.int8 = Int8Instance(_wrapper)


# --- int8_dot: w and the residual quantized too --------------------------------


def int8dot_plan_for(X) -> LaunchPlan:
    """The int8_dot forward's plan for this X on its card: one wave where
    wq's slice and two stages fit, else :func:`lr_wide_plan`'s waves."""
    plan = launch_plan_for(X, "int8", "logits")
    return plan if plan.single_pass else wide_plan_for(X, "int8")


def lr_logits_int8dot(w, X, y=None, mask=None, *, feature_scale: float = 1.0, w_amax=None):
    """The JAX model's ``int8_dot`` logits for an int8 X: w quantized on
    its own symmetric grid (``s_w = max|w| / 127``), ``z = (X·wq) · (s_w ·
    feature_scale)`` with int32 sums that cannot wrap; given y and mask,
    ``(z, r)`` with the residuals ``r = (σ(z) − y)·mask``.  ``w_amax`` (a
    0-dim tensor on X's device) puts w on the grid of that maximum
    instead: a column block of the feature-sharded step quantizes on the
    maximum over every block (:func:`int8dot_weight_grid`).  On the card
    the dp4a streaming forward and its epilogue (wq from ``torch.amax``
    and :func:`quantize_sym` first)."""
    _check_inputs(w, X, None, y, mask, x_dtypes=_INT8_X)
    if X.device.type == "cpu":
        z = lr_logits_int8dot_reference(w, X, feature_scale=feature_scale, w_amax=w_amax)
        return z if y is None else (z, _residual(z, y, mask))
    with torch.cuda.device(X.device):
        wq, s_w = int8dot_weight_grid(w, w_amax)
        out = run_int8dot_forward(_int8_lib(), int8dot_plan_for(X), wq, s_w, X,
                                  feature_scale, y, mask)
    lr_logits_int8dot.launches += 1
    return out


lr_logits_int8dot.launches = 0


def lr_backward_int8dot(X, r, *, feature_scale: float = 1.0):
    """The JAX model's ``int8_dot`` backward, unnormalized: the residuals r
    quantized on their own grid (``s_r = max|r| / 127``), ``g = (rqᵀX) ·
    (s_r · feature_scale)``, int32 over at most 133,120 rows at a time.
    On the card one kernel that quantizes r as it stages it."""
    _check_inputs(None, X, None, x_dtypes=_INT8_X)
    if r.shape != X.shape[:1] or r.device != X.device:
        raise ValueError(f"r must be ({X.shape[0]},) on {X.device}, got {tuple(r.shape)} "
                         f"on {r.device}")
    if X.device.type == "cpu":
        return lr_backward_int8dot_reference(X, r, feature_scale=feature_scale)
    with torch.cuda.device(X.device):
        g = run_int8dot_backward(_int8_lib(), X, r, sym_scale(torch.amax(r.abs())),
                                 feature_scale)
    lr_backward_int8dot.launches += 1
    return g


lr_backward_int8dot.launches = 0


def fused_lr_grad_int8dot(w, X, y, mask, *, feature_scale: float = 1.0,
                          with_logits: bool = False):
    """The ``int8_dot`` gradient ``(rqᵀX) · (s_r · feature_scale)``,
    unnormalized like :func:`fused_lr_grad`: :func:`lr_logits_int8dot`
    with the residuals, then :func:`lr_backward_int8dot`.  s_r is the
    maximum over every residual of the batch, so the backward waits for
    the whole forward: X is read twice."""
    z, r = lr_logits_int8dot(w, X, y, mask, feature_scale=feature_scale)
    g = lr_backward_int8dot(X, r, feature_scale=feature_scale)
    return (g, z) if with_logits else g


#: every kernel wrapper of this module (and the int8 instances' counts), for
#: launch accounting
KERNEL_WRAPPERS = (*_DENSE_WRAPPERS, *(fn.int8 for fn in _DENSE_WRAPPERS),
                   lr_logits_int8dot, lr_backward_int8dot)
