"""On-device generation roofline probes: Hopper kernels and their plain
PyTorch versions.

Counterparts of the six Pallas kernels of the TPU roofline experiments:
``benchmarks/exp_gen_roofline.py`` (``_kern_gen``, ``_kern_fwd``,
``_kern_full``) and ``benchmarks/exp_gen_roofline2.py`` (``_kern_hash``,
``_kern_const``, ``_kern_mxu``).  The kernels live in
``csrc/gen_roofline.cu`` (see its header for the design and what bounds
each); :mod:`distlr_tpu_torch.ops.build` compiles them on first use.

The TPU's hardware generator becomes Philox4x32-10 under key
``(seed, t)`` (``csrc/philox.cuh``); :func:`philox_bits_reference` gives
the same bits in plain PyTorch, so a kernel and its plain version see the
same numbers.  As on the TPU, ``x = f32(bits) * 2**-31 - 1`` of int32
bits lies in [-2, 0).

Inputs and outputs keep the TPU kernels' shapes: ``seed`` (1,) int32,
``w`` (1, DT), ``y`` (BT, 1), ``x`` (BT, DT), float32.  A wrapper takes its
plain version only when it is given CPU tensors.  A CUDA tensor launches
the kernel or raises.  Each wrapper counts its launches in a plain integer
attribute (``roofline_gen.launches``, ...).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distlr_tpu_torch.ops import build

# the TPU experiments' tile: batch rows, feature columns, grid steps
BT, DT, REPS = 256, 8192, 64
HEAD_COLS = 128      # columns of the tile that _kern_gen sums
MXU_N = 128          # columns of _kern_mxu's w and output
_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_HASH_ROW, _HASH_COL, _HASH_MUL = 0x9E3779B9, 0x85EBCA77, 0x2C1B676D
_LIB_NAME = "gen_roofline"
_KIND = {"gen": 0, "fwd": 1, "full": 2, "hash": 3, "const": 4, "mxu": 5}


# --- plain versions -----------------------------------------------------------
def philox4x32_10(counter: torch.Tensor, k0: int, k1: int,
                  c1: int = 0, c2: int = 0, c3: int = 0) -> list[torch.Tensor]:
    """The four words of Philox4x32-10 at counters ``(counter, c1, c2, c3)``
    under key ``(k0, k1)``, as int64 tensors holding uint32 values.  The
    probes use ``c1 = c2 = c3 = 0``.

    32x32-bit products wrap past 2**63 in int64, but their low 64 bits stay
    exact, so ``(p >> 32) & 0xFFFFFFFF`` is the high word."""
    c0 = counter.to(torch.int64) & _M32
    c1, c2, c3 = (torch.full_like(c0, c & _M32) for c in (c1, c2, c3))
    k0, k1 = k0 & _M32, k1 & _M32
    for i in range(10):
        if i:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        p0, p1 = c0 * _PHILOX_M[0], c2 * _PHILOX_M[1]
        c0, c1, c2, c3 = (((p1 >> 32) & _M32) ^ c1 ^ k0, p1 & _M32,
                          ((p0 >> 32) & _M32) ^ c3 ^ k1, p0 & _M32)
    return [c0, c1, c2, c3]


def _as_int32(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def philox_bits_reference(seed: int, t: int, bt: int = BT, dt: int = DT,
                          device=None) -> torch.Tensor:
    """(bt, dt) int32: the random bits of step ``t``.  Element (r, c) is
    word ``(r*dt + c) & 3`` of the Philox block at counter
    ``(r*dt + c) >> 2`` under key ``(seed, t)``; ``dt`` is a multiple of 4."""
    counter = torch.arange(bt * dt // 4, dtype=torch.int64, device=device)
    words = torch.stack(philox4x32_10(counter, seed, t), dim=1)
    return _as_int32(words.reshape(bt, dt))


def _bits_to_x(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.float32) * 2.0**-31 - 1.0


def _seed(seed: torch.Tensor) -> int:
    return int(seed[0])


def _philox_steps(seed, bt: int, dt: int):
    """``t -> (bt, dt)`` int32 bits of step t under ``seed``."""
    s = _seed(seed)
    return lambda t: philox_bits_reference(s, t, bt, dt, seed.device)


def roofline_gen_reference(seed, *, bt: int = BT, dt: int = DT, reps: int = REPS):
    """Plain version of :func:`roofline_gen`: (bt, 128) f32, the f32 sum
    over ascending t of the first 128 columns of each step's bits."""
    bits_of = _philox_steps(seed, bt, dt)
    acc = torch.zeros(bt, HEAD_COLS, dtype=torch.float32, device=seed.device)
    for t in range(reps):
        acc += bits_of(t).to(torch.float32)[:, :HEAD_COLS]
    return acc


def _logits_from_bits(bits_of, w, bt: int, reps: int) -> torch.Tensor:
    z = torch.zeros(bt, 1, dtype=torch.float32, device=w.device)
    for t in range(reps):
        z += (_bits_to_x(bits_of(t)) * w).sum(dim=1, keepdim=True)
    return z


def _full_from_bits(bits_of, w, y, reps: int) -> torch.Tensor:
    bt, dt = y.shape[0], w.shape[1]
    res = torch.sigmoid(_logits_from_bits(bits_of, w, bt, reps)) - y
    g = torch.empty(1, reps * dt, dtype=torch.float32, device=w.device)
    for t in range(reps):
        g[:, t * dt:(t + 1) * dt] = (_bits_to_x(bits_of(t)) * res).sum(dim=0, keepdim=True)
    return g


def roofline_fwd_reference(seed, w, *, bt: int = BT, reps: int = REPS):
    """Plain version of :func:`roofline_fwd`: (bt, 1) f32,
    ``z = sum_t rowsum(x_t * w)`` with ``x_t`` the Philox x of step t."""
    return _logits_from_bits(_philox_steps(seed, bt, w.shape[1]), w, bt, reps)


def roofline_full_reference(seed, w, y, *, reps: int = REPS):
    """Plain version of :func:`roofline_full`: (1, reps*dt) f32.  Phase 0
    is :func:`roofline_fwd_reference`; phase 1 regenerates each step's x
    and writes ``g[t*dt + c] = sum_r x_t[r, c] * (sigmoid(z[r]) - y[r])``."""
    return _full_from_bits(_philox_steps(seed, y.shape[0], w.shape[1]), w, y, reps)


def hash_x_reference(t: int, bt: int, dt: int, device=None) -> torch.Tensor:
    """(bt, dt) f32: _kern_hash's x of step ``t``, from a hash of (r, c, t)
    in wrapping 32-bit arithmetic with logical shifts."""
    row = torch.arange(bt, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(dt, dtype=torch.int64, device=device)[None, :]
    h = (row * _HASH_ROW + col * _HASH_COL + t) & _M32
    h ^= h >> 15
    h = (h * _HASH_MUL) & _M32
    h ^= h >> 12
    return _as_int32(h).to(torch.float32) * 2.0**-31


def roofline_hash_reference(w, *, bt: int = BT, reps: int = REPS):
    """Plain version of :func:`roofline_hash`: (bt, 1) f32,
    ``z = sum_t rowsum(x_t * w)`` with the iota-hash ``x_t``."""
    z = torch.zeros(bt, 1, dtype=torch.float32, device=w.device)
    for t in range(reps):
        z += (hash_x_reference(t, bt, w.shape[1], w.device) * w).sum(dim=1, keepdim=True)
    return z


def roofline_const_reference(x, w, *, reps: int = REPS):
    """Plain version of :func:`roofline_const`: (bt, 1) f32, ``reps``
    accumulations of ``rowsum(x * w)``."""
    z = torch.zeros(x.shape[0], 1, dtype=torch.float32, device=x.device)
    for _ in range(reps):
        z += (x * w).sum(dim=1, keepdim=True)
    return z


def roofline_mxu_reference(x, w, *, reps: int = REPS):
    """Plain version of :func:`roofline_mxu`: (bt, 128) f32, ``reps``
    accumulations of ``bf16(x) @ bf16(w)`` taken in f32 (a product of two
    bf16 values is exact in f32)."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    wb = w.to(torch.bfloat16).to(torch.float32)
    z = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32, device=x.device)
    for _ in range(reps):
        z += xb @ wb
    return z


# --- work counts --------------------------------------------------------------
# Integer instructions, at their fewest: a Philox round is two
# IMAD.WIDE.U32 (both halves of a 32x32 product) and two three-way XORs
# (LOP3).  Counter words 1-3 are zero, which leaves 17 products and 19
# XORs that depend on t (csrc/philox.cuh); the key schedule depends on
# (seed, t) alone and is not counted.
PHILOX_INT_OPS = 17 + 19         # per 4-word block
# _kern_hash per element: one add (the row and column terms are constants
# of a thread), two shifts, two XORs, one multiply
HASH_INT_OPS = 6


def roofline_work(name: str, bt: int = BT, dt: int = DT, reps: int = REPS) -> dict:
    """What the kernel ``name`` must do on a (bt, dt) tile over ``reps``
    steps: ``bytes`` (each input read once, each output written once),
    ``int_ops`` (32-bit integer instructions), ``conversions`` (int32 or
    f32 to another type), ``f32_flops`` (an FMA is 2) and ``bf16_flops``
    (tensor-core products).  The lower bounds in ``chip_smoke.py`` divide
    each by the card's rate for it."""
    words = reps * bt * dt
    blocks = words // 4
    work = dict(bytes=0, int_ops=0, conversions=0, f32_flops=0, bf16_flops=0)
    if name == "gen":
        fold_words = (bt * dt // 4 + 255) // 256 * 8     # one per warp of 32 blocks
        work.update(bytes=4 + bt * HEAD_COLS * 4 + fold_words * 4,
                    int_ops=blocks * (PHILOX_INT_OPS + 2),     # + XOR fold
                    conversions=reps * bt * HEAD_COLS, f32_flops=reps * bt * HEAD_COLS)
    elif name in ("fwd", "full"):
        phases = 1 if name == "fwd" else 2
        out = bt * 4 if name == "fwd" else reps * dt * 4 + bt * 4   # g out, y in
        work.update(bytes=4 + dt * 4 + out, int_ops=phases * blocks * PHILOX_INT_OPS,
                    conversions=phases * words, f32_flops=phases * 4 * words)
    elif name == "hash":
        work.update(bytes=dt * 4 + bt * 4, int_ops=words * HASH_INT_OPS,
                    conversions=words, f32_flops=3 * words)
    elif name == "const":
        work.update(bytes=bt * dt * 4 + dt * 4 + bt * 4, f32_flops=2 * words)
    elif name == "mxu":
        work.update(bytes=bt * dt * 4 + dt * MXU_N * 4 + bt * MXU_N * 4,
                    conversions=bt * dt + dt * MXU_N, bf16_flops=2 * words * MXU_N)
    else:
        raise ValueError(f"unknown roofline kernel {name!r}")
    return work


# --- launch plans ---------------------------------------------------------------
_THREADS = 256           # threads of a gen, fwd, full or hash block
_GEN_SLICE = 4 * _THREADS  # columns a fwd/hash block covers
_CONST_ROWS = 2          # rows of x a const block owns
_CONST_THREADS = 512
_MXU_BM, _MXU_BK = 64, 256  # rows and depth of x an mxu block holds
_MXU_THREADS = 256       # a consumer and a producer warpgroup


def probe_plan(name: str, bt: int = BT, dt: int = DT) -> dict:
    """How the CUDA kernel ``name`` runs a (bt, dt) tile, as
    ``csrc/gen_roofline.cu`` launches it: ``kernels``, the CUDA kernels one
    call launches, in order; ``blocks`` and ``threads`` of the first;
    ``scratch``, the length of the scratch buffer the call takes (what
    ``distlr_roofline_scratch_len`` gives)."""
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    if name == "gen":
        blocks = cdiv(bt * dt // 4, _THREADS)
        return dict(kernels=("gen_kernel",), blocks=blocks, threads=_THREADS,
                    scratch=blocks * _THREADS // 32)
    if name in ("fwd", "hash", "full"):
        blocks = cdiv(dt, _GEN_SLICE) * bt
        kernels = ("gen_fwd_partial_kernel", "sum_partials_kernel")
        if name == "full":
            kernels += ("full_bwd_kernel",)
        return dict(kernels=kernels, blocks=blocks, threads=_THREADS, scratch=blocks)
    if name == "const":
        return dict(kernels=("const_rows_kernel",), blocks=cdiv(bt, _CONST_ROWS),
                    threads=_CONST_THREADS, scratch=0)
    if name == "mxu":
        slices = dt // _MXU_BK
        return dict(kernels=("mxu_wgmma_kernel", "sum_partials_kernel"),
                    blocks=slices * (bt // _MXU_BM), threads=_MXU_THREADS,
                    scratch=slices * bt * MXU_N)
    raise ValueError(f"unknown roofline kernel {name!r}")


# --- wrappers -----------------------------------------------------------------
@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(_LIB_NAME)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, args in (
        ("distlr_roofline_gen", [p, i, i, i, p, p, p]),
        ("distlr_roofline_fwd", [p, p, i, i, i, p, p, p]),
        ("distlr_roofline_full", [p, p, p, i, i, i, p, p, p, p]),
        ("distlr_roofline_hash", [p, i, i, i, p, p, p]),
        ("distlr_roofline_const", [p, p, i, i, i, p, p]),
        ("distlr_roofline_mxu", [p, p, i, i, i, p, p, p]),
    ):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = i
    lib.distlr_roofline_scratch_len.argtypes = [i, i, i]
    lib.distlr_roofline_scratch_len.restype = ctypes.c_longlong
    lib.distlr_roofline_error_string.argtypes = [i]
    lib.distlr_roofline_error_string.restype = ctypes.c_char_p
    return lib


def _check(kind: str, tensors: dict, shapes: dict, bt: int, dt: int, reps: int) -> bool:
    """Validate the inputs of kernel ``kind``; True when they lie on the
    card (launch the kernel), False on the CPU (take the plain version)."""
    if min(bt, dt, reps) < 1:
        raise ValueError(f"bt, dt and reps must be >= 1, got {(bt, dt, reps)}")
    for name, t in tensors.items():
        want = torch.int32 if name == "seed" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got {tuple(t.shape)}")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"inputs must share one device, got {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"inputs must be cuda or cpu tensors, got {device}")
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned for the CUDA kernel")
    if dt % 128:
        raise ValueError(f"the CUDA kernel takes dt a multiple of 128, got {dt}")
    if kind == "mxu" and (bt % 64 or dt % 256):
        raise ValueError(f"the mxu kernel takes bt a multiple of 64 and dt of 256, got {(bt, dt)}")
    if bt > 65535 or bt * dt // 4 >= 2**31 or reps * dt // 4 >= 2**31:
        raise ValueError(f"tile ({bt}, {dt}) x {reps} steps is too large for the CUDA kernel")
    if kind == "full" and bt > 8192:
        raise ValueError(f"the full kernel keeps bt <= 8192 residuals in shared memory, got {bt}")
    return True


def _tile(x) -> tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"x must be (BT, DT), got shape {tuple(x.shape)}")
    return x.shape


def _launch(kind: str, device: torch.device, fill) -> None:
    """Run ``fill(lib, stream)`` (one C entry point) on ``device`` and raise
    on a nonzero CUDA error."""
    lib = _lib()
    with torch.cuda.device(device):
        rc = fill(lib, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = lib.distlr_roofline_error_string(rc).decode()
        raise RuntimeError(f"roofline {kind} launch failed: CUDA error {rc} ({msg})")


def _scratch(kind: str, bt: int, dt: int, device, dtype=torch.float32) -> torch.Tensor:
    n = _lib().distlr_roofline_scratch_len(_KIND[kind], bt, dt)
    return torch.empty(n, dtype=dtype, device=device)


def roofline_gen(seed, *, bt: int = BT, dt: int = DT, reps: int = REPS):
    """Philox generation alone (``_kern_gen``): (bt, 128) f32, the f32 sum
    over ascending t of the first 128 columns of each step's (bt, dt)
    int32 bits.  The kernel generates every word of the tile."""
    if not _check("gen", {"seed": seed}, {"seed": (1,)}, bt, dt, reps):
        return roofline_gen_reference(seed, bt=bt, dt=dt, reps=reps)
    out = torch.empty(bt, HEAD_COLS, dtype=torch.float32, device=seed.device)
    fold = _scratch("gen", bt, dt, seed.device, torch.int32)
    _launch("gen", seed.device, lambda lib, s: lib.distlr_roofline_gen(
        seed.data_ptr(), bt, dt, reps, out.data_ptr(), fold.data_ptr(), s))
    roofline_gen.launches += 1
    return out


def roofline_fwd(seed, w, *, bt: int = BT, reps: int = REPS):
    """Philox generation plus the forward row dot (``_kern_fwd``): (bt, 1)
    f32 ``z = sum_t rowsum(x_t * w)``, ``x_t = f32(bits_t) * 2**-31 - 1``."""
    dt = w.shape[-1]
    if not _check("fwd", {"seed": seed, "w": w}, {"seed": (1,), "w": (1, dt)}, bt, dt, reps):
        return roofline_fwd_reference(seed, w, bt=bt, reps=reps)
    partial = _scratch("fwd", bt, dt, w.device)
    z = torch.empty(bt, 1, dtype=torch.float32, device=w.device)
    _launch("fwd", w.device, lambda lib, s: lib.distlr_roofline_fwd(
        seed.data_ptr(), w.data_ptr(), bt, dt, reps, partial.data_ptr(), z.data_ptr(), s))
    roofline_fwd.launches += 1
    return z


def roofline_full(seed, w, y, *, reps: int = REPS):
    """Forward, regenerate, backward (``_kern_full``): (1, reps*dt) f32
    ``g[t*dt + c] = sum_r x_t[r, c] * (sigmoid(z[r]) - y[r])`` with ``z``
    as in :func:`roofline_fwd`; x is generated twice, never stored."""
    bt, dt = y.shape[0], w.shape[-1]
    if not _check("full", {"seed": seed, "w": w, "y": y},
                  {"seed": (1,), "w": (1, dt), "y": (bt, 1)}, bt, dt, reps):
        return roofline_full_reference(seed, w, y, reps=reps)
    partial = _scratch("full", bt, dt, w.device)
    z = torch.empty(bt, dtype=torch.float32, device=w.device)
    g = torch.empty(1, reps * dt, dtype=torch.float32, device=w.device)
    _launch("full", w.device, lambda lib, s: lib.distlr_roofline_full(
        seed.data_ptr(), w.data_ptr(), y.data_ptr(), bt, dt, reps, partial.data_ptr(),
        z.data_ptr(), g.data_ptr(), s))
    roofline_full.launches += 1
    return g


def roofline_hash(w, *, bt: int = BT, reps: int = REPS):
    """Iota-hash generation plus the forward row dot (``_kern_hash``):
    (bt, 1) f32 ``z = sum_t rowsum(x_t * w)``."""
    dt = w.shape[-1]
    if not _check("hash", {"w": w}, {"w": (1, dt)}, bt, dt, reps):
        return roofline_hash_reference(w, bt=bt, reps=reps)
    partial = _scratch("hash", bt, dt, w.device)
    z = torch.empty(bt, 1, dtype=torch.float32, device=w.device)
    _launch("hash", w.device, lambda lib, s: lib.distlr_roofline_hash(
        w.data_ptr(), bt, dt, reps, partial.data_ptr(), z.data_ptr(), s))
    roofline_hash.launches += 1
    return z


def roofline_const(x, w, *, reps: int = REPS):
    """A resident tile on the CUDA cores (``_kern_const``): (bt, 1) f32,
    ``reps`` passes of ``rowsum(x * w)``."""
    bt, dt = _tile(x)
    if not _check("const", {"x": x, "w": w}, {"x": (bt, dt), "w": (1, dt)}, bt, dt, reps):
        return roofline_const_reference(x, w, reps=reps)
    z = torch.empty(bt, 1, dtype=torch.float32, device=x.device)
    _launch("const", x.device, lambda lib, s: lib.distlr_roofline_const(
        x.data_ptr(), w.data_ptr(), bt, dt, reps, z.data_ptr(), s))
    roofline_const.launches += 1
    return z


def roofline_mxu(x, w, *, reps: int = REPS):
    """A resident tile on the tensor cores (``_kern_mxu``): (bt, 128) f32,
    ``reps`` passes of ``bf16(x) @ bf16(w)`` with f32 sums."""
    bt, dt = _tile(x)
    if not _check("mxu", {"x": x, "w": w}, {"x": (bt, dt), "w": (dt, MXU_N)}, bt, dt, reps):
        return roofline_mxu_reference(x, w, reps=reps)
    partial = _scratch("mxu", bt, dt, x.device)
    out = torch.empty(bt, MXU_N, dtype=torch.float32, device=x.device)
    _launch("mxu", x.device, lambda lib, s: lib.distlr_roofline_mxu(
        x.data_ptr(), w.data_ptr(), bt, dt, reps, partial.data_ptr(), out.data_ptr(), s))
    roofline_mxu.launches += 1
    return out


#: every kernel wrapper of this module, for launch accounting
KERNEL_WRAPPERS = (roofline_gen, roofline_fwd, roofline_full, roofline_hash,
                   roofline_const, roofline_mxu)
for _wrapper in KERNEL_WRAPPERS:
    _wrapper.launches = 0
del _wrapper
