"""The slice kernels of ``ops/csrc/fused_lr_grad.cu`` on the card, at the
main path's shape ((2048, 1M) bf16 features, bf16 products).

    python -m distlr_tpu_torch.benchmarks.slice_kernels [--sweep] [--trace] [--seed 0]

``--sweep`` times the single-pass gradient and the streaming logits over a
grid of launch plans (blocks per SM, rows a tile, stages), each checked
against its plain version, with the yardsticks of the same run beside
them: the two-launch kernels and the library calls (``torch.mv``; ``mv``,
sigmoid, ``mv`` of Xᵀ), timed before and after the grid.

``--trace`` builds the single pass with ``-DDISTLR_SLICE_TRACE``, runs it
once with its default plan and summarises when each hand-off of a tile
happened, over every CTA and 32 tiles from the middle of the batch: the
time from the producer's issue of a tile to each later event, how far the
last CTA's publish of a tile trails the median CTA's, and how long after
the last publish the resolvers see the tile complete.

Prints the ``nvidia-smi`` name and power line first, then one JSON object
per line.  Needs the card: without CUDA it exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

from distlr_tpu_torch.benchmarks.timing import mean_ms, nvidia_smi_line
from distlr_tpu_torch.ops import build, fused_lr

B, D = 2048, 1_000_000
TRACE_DEFINE = "DISTLR_SLICE_TRACE"
# kTraceTiles x kTraceEvents x 256 CTAs in the traced build
TRACE_TILES, TRACE_CTAS = 32, 256
TRACE_EVENTS = ("issued", "forward_start", "forwarded", "published", "resolved", "residuals_out",
                "backward_start", "stage_free")
GRAD_PLANS = [(1, 4, 3), (1, 2, 4), (1, 2, 6), (1, 2, 7), (1, 1, 7), (1, 1, 14)]
LOGITS_PLANS = [(1, 4, 3), (1, 2, 7), (2, 2, 3), (2, 4, 2), (2, 2, 4), (2, 1, 6)]
ITERS = 20


def _inputs(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(B, D, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(D, device="cuda", generator=gen) / D ** 0.5
    y = (torch.rand(B, device="cuda", generator=gen) < 0.5).to(torch.float32)
    mask = torch.ones(B, device="cuda")
    mask[-48:] = 0
    return w, X, y, mask


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _ms(fn) -> float:
    return mean_ms(fn, ITERS, device=torch.device("cuda"), graph=False)


def sweep(seed: int) -> None:
    w, X, y, mask = _inputs(seed)
    lib = fused_lr._lib()
    wb = w.to(torch.bfloat16)
    g_ref = fused_lr.fused_lr_grad_reference(w, X, y, mask)
    z_ref = fused_lr.lr_logits_reference(w, X)

    def library_grad():
        r = (torch.sigmoid(torch.mv(X, wb).float()) - y) * mask
        return torch.mv(X.t(), r.to(torch.bfloat16))

    yardsticks = {
        "two_launch_ms": lambda: fused_lr.fused_lr_grad_two_launch(w, X, y, mask),
        "library_grad_ms": library_grad,
        "row_blocks_ms": lambda: fused_lr.lr_logits_row_blocks(w, X),
        "mv_ms": lambda: torch.mv(X, wb),
    }
    print(json.dumps({"yardsticks": "before", **{k: _ms(f) for k, f in yardsticks.items()}}),
          flush=True)
    for kernel, plans in (("grad", GRAD_PLANS), ("logits", LOGITS_PLANS)):
        for per_sm, rows, stages in plans:
            plan = fused_lr.lr_launch_plan(B, D, kernel=kernel, ctas_per_sm=per_sm, rows=rows,
                                           stages=stages)
            line = {"kernel": kernel, "ctas_per_sm": per_sm, "rows": rows, "stages": stages}
            if not plan.single_pass:
                print(json.dumps({**line, "fits": False}), flush=True)
                continue
            if kernel == "grad":
                def run():
                    return fused_lr.run_single_pass(lib, plan, w, X, y, mask, "bfloat16")[0]
                ref = g_ref
            else:
                def run():
                    return fused_lr.run_streaming(lib, plan, w, X, "bfloat16")
                ref = z_ref
            err = _rel(run(), ref)
            print(json.dumps({**line, "ctas": plan.ctas, "smem_bytes": plan.smem_bytes,
                              "rel_err": err, "ms": _ms(run)}), flush=True)
    print(json.dumps({"yardsticks": "after", **{k: _ms(f) for k, f in yardsticks.items()}}),
          flush=True)


def _quantiles(values) -> dict:
    v = sorted(values)
    if not v:
        return {}
    return {"median": v[len(v) // 2], "p90": v[(9 * len(v)) // 10], "max": v[-1], "n": len(v)}


def trace(seed: int) -> None:
    w, X, y, mask = _inputs(seed)
    lib = fused_lr.bind(ctypes.CDLL(str(build.build("fused_lr_grad", defines=(TRACE_DEFINE,)))))
    lib.distlr_slice_trace.argtypes = [ctypes.c_void_p]
    lib.distlr_slice_trace.restype = ctypes.c_int
    plan = fused_lr.launch_plan_for(X)
    fused_lr.run_single_pass(lib, plan, w, X, y, mask, "bfloat16")  # warm-up
    g, _ = fused_lr.run_single_pass(lib, plan, w, X, y, mask, "bfloat16")
    torch.cuda.synchronize()
    err = _rel(g, fused_lr.fused_lr_grad_reference(w, X, y, mask))
    n = TRACE_CTAS * TRACE_TILES * len(TRACE_EVENTS)
    buf = (ctypes.c_ulonglong * n)()
    if lib.distlr_slice_trace(buf) != 0:
        raise RuntimeError("could not read the trace back")
    t = torch.tensor(list(buf), dtype=torch.float64).view(TRACE_CTAS, TRACE_TILES, -1)
    t = t[:plan.ctas]
    if bool((t == 0).any()):
        raise RuntimeError("the trace has unrecorded events: is B large enough for its tiles?")
    since_issue = {ev: _quantiles((t[:, :, i] - t[:, :, 0]).flatten().tolist())
                   for i, ev in enumerate(TRACE_EVENTS) if i}
    pub = t[:, :, TRACE_EVENTS.index("published")]
    last_pub = pub.max(dim=0).values
    lag_of_last = (last_pub - pub.median(dim=0).values).tolist()
    seen_after_last = (t[:, :, TRACE_EVENTS.index("resolved")] - last_pub).flatten().tolist()
    # issue -> compute warp 0 starts the tile's forward (the tile has landed)
    landed = (t[:, :, 1] - t[:, :, 0]).mean(dim=1)
    period = torch.diff(t[0, :, TRACE_EVENTS.index("backward_start")]).tolist()
    print(json.dumps({
        "trace": "single_pass", "plan": fused_lr.launch_plan_for(X).as_dict(), "rel_err": err,
        "ns_after_issue": since_issue,
        "last_publish_after_median_publish_ns": _quantiles(lag_of_last),
        "resolved_after_last_publish_ns": _quantiles(seen_after_last),
        "tile_period_ns_cta0": _quantiles(period),
        "slowest_landing_ctas": [[int(c), float(landed[c])] for c in landed.argsort()[-5:]],
    }), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="time the launch-plan grid")
    ap.add_argument("--trace", action="store_true", help="trace the single pass's hand-offs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("slice_kernels: needs the card (CUDA is not available)", file=sys.stderr)
        return 2
    print(nvidia_smi_line(), flush=True)
    if args.sweep or not args.trace:
        sweep(args.seed)
    if args.trace:
        trace(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
