"""Roofline experiment 2: isolate the slow part of on-device generation,
on the card.

Counterpart of ``benchmarks/exp_gen_roofline2.py`` for the H100.
Variants of the same (BT, DT)-tile kernel, none streaming x from memory
after its first read:

  D. iota-hash generation (mul/xor/shift of the row and column index) +
     fwd shape (``ops.roofline_hash``)
  E. no generation at all: reuse a constant on-chip tile + fwd shape
     (the CUDA-core mul+reduce ceiling, ``ops.roofline_const``)
  F. same as E but on the tensor cores: x_tile @ w_rep matmul
     accumulation (degenerate-N ceiling, ``ops.roofline_mxu``)

Timing, seeds, ``--device`` and the first line as in
:mod:`distlr_tpu_torch.benchmarks.exp_gen_roofline`::

    python -m distlr_tpu_torch.benchmarks.exp_gen_roofline2 [--device cpu] [--seed 0]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from distlr_tpu_torch import ops
from distlr_tpu_torch.benchmarks.exp_gen_roofline import _normal, _time, header, parse_args
from distlr_tpu_torch.ops.gen_roofline import BT, DT, MXU_N, REPS


def _report(name, elems, dt):
    print(f"{name}: {elems/dt/1e9:10.2f} G elem/s")
    return elems / dt


# --- D: iota-hash generator + fwd ------------------------------------------
def bench_hash(device: torch.device, seed: int) -> float:
    w = _normal(np.random.default_rng(seed), (1, DT), device, DT ** -0.5)
    dt = _time(lambda: ops.roofline_hash(w, bt=BT, reps=REPS), device)
    return _report("D iota-hash + fwd ", REPS * BT * DT, dt)


# --- E: constant tile + fwd (CUDA-core ceiling) -----------------------------
def bench_const(device: torch.device, seed: int) -> float:
    rng = np.random.default_rng(seed)
    x = _normal(rng, (BT, DT), device)
    w = _normal(rng, (1, DT), device, DT ** -0.5)
    dt = _time(lambda: ops.roofline_const(x, w, reps=REPS), device)
    return _report("E const tile + fwd", REPS * BT * DT, dt)


# --- F: constant tile, tensor-core matmul path ------------------------------
def bench_mxu(device: torch.device, seed: int) -> float:
    rng = np.random.default_rng(seed)
    x = _normal(rng, (BT, DT), device)
    w = _normal(rng, (DT, MXU_N), device, DT ** -0.5)
    dt = _time(lambda: ops.roofline_mxu(x, w, reps=REPS), device)
    return _report("F const tile + MXU", REPS * BT * DT, dt)


def main(argv=None) -> int:
    args = parse_args(argv, __doc__)
    print(header(args.device), flush=True)
    bench_hash(args.device, args.seed)
    bench_const(args.device, args.seed)
    bench_mxu(args.device, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
