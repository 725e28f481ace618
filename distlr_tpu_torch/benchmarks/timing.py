"""Timing of the port's kernels on the card, shared by the experiment
scripts and ``chip_smoke.py``."""

from __future__ import annotations

import subprocess
import time

import torch


def nvidia_smi_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def mean_ms(fn, iters: int, *, device: torch.device, graph: bool = True) -> float:
    """Mean time of one call of ``fn`` over ``iters`` back-to-back calls,
    after one warm-up call.

    On the card the time runs between two CUDA events.  With ``graph`` the
    ``iters`` calls are captured once into a CUDA graph and replayed, so
    the host's cost of issuing a call does not hide a kernel of a few
    microseconds; without it they are issued eagerly (for callables that
    synchronise with the host, or allocate too much to capture ``iters``
    times).  On the CPU the time is the host clock's."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()  # the first replay uploads the graph

        def run():
            g.replay()
    else:
        def run():
            for _ in range(iters):
                fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
