"""Roofline experiment: on-device generation throughput ceiling, on the card.

Counterpart of ``benchmarks/exp_gen_roofline.py`` for the H100.  It
measures the ceiling of generating the features on the device instead of
streaming them from memory, with the same (BT, DT) tile and REPS steps:

  A. Philox generation alone (``ops.roofline_gen``)
  B. generation + convert to f32 + multiply-by-w + row-reduce (the
     forward matvec shape, ``ops.roofline_fwd``)
  C. full fwd+bwd shape: phase-0 z accumulation, phase-1 regeneration +
     column sums (what the real kernel must do, ``ops.roofline_full``)

Prints elements/sec for each; samples/sec = elem_rate / (2*D) for C.  A
rate is the tile's elements over the mean time of one launch: CUDA events
around 200 back-to-back launches (one CUDA graph) after a warm-up.
w and y are drawn from ``--seed``.  The first line is the card's name and
power limit.  ``--device cpu`` runs the plain PyTorch versions on the host
clock and says so in its first line::

    python -m distlr_tpu_torch.benchmarks.exp_gen_roofline [--device cpu] [--seed 0]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from distlr_tpu_torch import ops
from distlr_tpu_torch.benchmarks.timing import mean_ms, nvidia_smi_line
from distlr_tpu_torch.ops.gen_roofline import BT, DT, REPS
from distlr_tpu_torch.utils.device import resolve_device


CUDA_ITERS = 200   # launches timed per kernel on the card; the CPU times one


def _time(fn, device: torch.device) -> float:
    """Seconds per launch."""
    return mean_ms(fn, CUDA_ITERS if device.type == "cuda" else 1, device=device) / 1e3


def _seed(seed: int, device) -> torch.Tensor:
    return torch.tensor([seed], dtype=torch.int32, device=device)


def _normal(rng, shape, device, scale: float = 1.0) -> torch.Tensor:
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(device)


# --- A: generation only -----------------------------------------------------
def bench_gen(device: torch.device, seed: int) -> float:
    s = _seed(seed, device)
    dt = _time(lambda: ops.roofline_gen(s, bt=BT, dt=DT, reps=REPS), device)
    return REPS * BT * DT / dt


# --- B: generation + fwd matvec shape --------------------------------------
def bench_fwd(device: torch.device, seed: int) -> float:
    s = _seed(seed, device)
    w = _normal(np.random.default_rng(seed), (1, DT), device, DT ** -0.5)
    dt = _time(lambda: ops.roofline_fwd(s, w, bt=BT, reps=REPS), device)
    return REPS * BT * DT / dt


# --- C: full fwd + regen + bwd shape ---------------------------------------
def bench_full(device: torch.device, seed: int) -> float:
    s = _seed(seed, device)
    rng = np.random.default_rng(seed)
    w = _normal(rng, (1, DT), device, DT ** -0.5)
    y = torch.from_numpy((rng.random((BT, 1)) < 0.5).astype(np.float32)).to(device)
    dt = _time(lambda: ops.roofline_full(s, w, y, reps=REPS), device)
    elems = 2 * REPS * BT * DT  # generated twice
    return elems / dt


def header(device: torch.device) -> str:
    """The first line of an experiment's output: the card's name and power
    limit, or a statement that the numbers are the CPU's."""
    if device.type == "cuda":
        return nvidia_smi_line()
    return "cpu: plain PyTorch versions on the host clock, not a device measurement"


def parse_args(argv, doc: str) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of w, y and the generator")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    return args


def main(argv=None) -> int:
    args = parse_args(argv, __doc__)
    print(header(args.device), flush=True)
    ra = bench_gen(args.device, args.seed)
    print(f"A gen-only:        {ra/1e9:10.2f} G elem/s")
    rb = bench_fwd(args.device, args.seed)
    print(f"B gen+fwd:         {rb/1e9:10.2f} G elem/s")
    rc = bench_full(args.device, args.seed)
    # rc counts generated elems: each logical element is generated twice
    # (fwd + regenerated bwd), and one sample is D = REPS*DT logical elems.
    logical_rate = rc / 2
    print(f"C full fwd+bwd:    {rc/1e9:10.2f} G gen-elem/s")
    print(f"   implied samples/sec at D=1M: {logical_rate / 1_000_000:,.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
