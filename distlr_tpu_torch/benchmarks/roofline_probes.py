"""Times of the probe kernels at the published tile, on the card.

    python distlr_tpu_torch/benchmarks/roofline_probes.py [--kernels const,mxu] [--empty]
        [--reps 1,16,64] [--clocks SECONDS] [--trace]

Prints one JSON line: the ``nvidia-smi`` name and power limit, the
checkout whose kernels ran (the directory ``distlr_tpu_torch`` was
imported from), and for each kernel the mean time of one call over 200
calls captured in one CUDA graph (``timing.mean_ms``, as the experiment
drivers and ``chip_smoke.py`` time them).  ``--empty`` also times, the
same way, a kernel that does next to nothing (a one-element fill), which
is what one launch costs under graph replay.  ``--reps`` times each kernel
at several pass counts on the same tile: the slope over the passes is the
cost of a pass, the intercept what a call pays besides (launches, the
tile's first read, partial sums).  ``--clocks`` keeps the card busy with
each kernel for that many seconds and samples the SM clock and power
draw beside it with ``nvidia-smi``.  ``--trace`` records one call of
each kernel with ``torch.profiler`` and lists the CUDA kernels it ran,
each with its device time and its start after the call's first kernel.

The script imports nothing from the package but ``ops`` and ``timing``,
so it can time another checkout's kernels: run it by path with that
checkout first on ``PYTHONPATH``, and compare two checkouts only within
one machine's run (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ITERS = 200
NAMES = ("gen", "fwd", "full", "hash", "const", "mxu")


def probe_calls(seed: int = 0, reps: int | None = None) -> dict:
    """name -> a call of ``ops.roofline_<name>`` at the published tile,
    ``reps`` passes (the published 64 by default), on inputs made from
    ``seed`` as ``chip_smoke.py`` makes them."""
    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.ops import gen_roofline as gr  # noqa: PLC0415

    bt, dt, reps = gr.BT, gr.DT, reps or gr.REPS
    rng = np.random.default_rng(seed)

    def normal(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).cuda()

    s = torch.tensor([seed], dtype=torch.int32, device="cuda")
    w = normal((1, dt), dt ** -0.5)
    y = torch.from_numpy((rng.random((bt, 1)) < 0.5).astype(np.float32)).cuda()
    x = normal((bt, dt))
    wm = normal((dt, gr.MXU_N), dt ** -0.5)
    return {
        "gen": lambda: ops.roofline_gen(s, bt=bt, dt=dt, reps=reps),
        "fwd": lambda: ops.roofline_fwd(s, w, bt=bt, reps=reps),
        "full": lambda: ops.roofline_full(s, w, y, reps=reps),
        "hash": lambda: ops.roofline_hash(w, bt=bt, reps=reps),
        "const": lambda: ops.roofline_const(x, w, reps=reps),
        "mxu": lambda: ops.roofline_mxu(x, wm, reps=reps),
    }


def busy_clocks(fn, seconds: float) -> dict:
    """The card's SM clock (MHz) and power draw (W), sampled by
    ``nvidia-smi`` every ~100 ms while ``fn`` runs back to back for
    ``seconds`` (200 calls to a CUDA graph, replayed): median and range."""
    g = torch.cuda.CUDAGraph()
    fn()
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        for _ in range(ITERS):
            fn()
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30).stdout.split(",")
            samples.append((float(out[0]), float(out[1])))
            time.sleep(0.1)

    t = threading.Thread(target=sample)
    end = time.perf_counter() + seconds
    t.start()
    while time.perf_counter() < end:
        g.replay()
        torch.cuda.synchronize()
    stop.set()
    t.join()
    busy = samples[1:-1] or samples  # the first and last may straddle idle time
    clk = sorted(c for c, _ in busy)
    watts = sorted(p for _, p in busy)
    return {"samples": len(busy), "sm_mhz_median": clk[len(clk) // 2],
            "sm_mhz_range": [clk[0], clk[-1]], "power_w_median": watts[len(watts) // 2]}


def trace_call(fn) -> list:
    """[name, device us, start us after the first kernel] of each CUDA
    kernel one call of ``fn`` runs, from ``torch.profiler``."""
    from torch.autograd import DeviceType  # noqa: PLC0415
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    t0 = kernels[0].time_range.start if kernels else 0
    return [[re.sub(r"^\(anonymous namespace\)::", "", e.name).split("(")[0],
             e.time_range.elapsed_us(), e.time_range.start - t0]
            for e in kernels]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default=",".join(NAMES),
                    help="comma-separated probe names (default: all six)")
    ap.add_argument("--empty", action="store_true",
                    help="also time a one-element fill, the cost of one launch")
    ap.add_argument("--reps", default="",
                    help="comma-separated pass counts (default: the published 64 alone)")
    ap.add_argument("--clocks", type=float, default=0.0,
                    help="seconds to run each kernel while sampling the SM clock")
    ap.add_argument("--trace", action="store_true",
                    help="list the CUDA kernels of one call of each, with device times")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("roofline_probes: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 2
    import distlr_tpu_torch  # noqa: PLC0415
    from distlr_tpu_torch.benchmarks.timing import mean_ms, nvidia_smi_line  # noqa: PLC0415

    dev = torch.device("cuda")
    names = args.kernels.split(",")
    calls = probe_calls(args.seed)
    ms = {name: mean_ms(calls[name], ITERS, device=dev) for name in names}
    by_reps = {}
    for reps in filter(None, args.reps.split(",")):
        calls = probe_calls(args.seed, int(reps))
        by_reps[reps] = {name: mean_ms(calls[name], ITERS, device=dev) for name in names}
    clocks = {}
    if args.clocks > 0:
        calls = probe_calls(args.seed)
        clocks = {name: busy_clocks(calls[name], args.clocks) for name in names}
    traces = {}
    if args.trace:
        calls = probe_calls(args.seed)
        traces = {name: trace_call(calls[name]) for name in names}
    if args.empty:
        one = torch.empty(1, device=dev)
        ms["empty"] = mean_ms(lambda: one.fill_(1.0), ITERS, device=dev)
    print(json.dumps({
        "nvidia_smi": nvidia_smi_line(),
        "checkout": os.path.dirname(os.path.dirname(os.path.abspath(distlr_tpu_torch.__file__))),
        "iters": ITERS, "ms": ms, "ms_by_reps": by_reps, "busy_clocks": clocks,
        "kernels_us": traces}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
