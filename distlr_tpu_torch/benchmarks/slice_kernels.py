"""The slice kernels of ``ops/csrc/fused_lr_grad.cu`` on the card, at the
main path's shape ((2048, 1M) bf16 features, bf16 products), and their
int8 instances in ``ops/csrc/fused_lr_int8.cu`` (``--x-dtype int8``: X
uniform in [-127, 127] with the dequantization scale 3/127).

    python -m distlr_tpu_torch.benchmarks.slice_kernels [--sweep] [--trace] [--wide]
        [--backward] [--times] [--x-dtype bfloat16|int8] [--batch 64] [--seed 0]

``--sweep`` times the single-pass gradient and the streaming logits over a
grid of launch plans (blocks per SM, rows a tile, stages), each checked
against its plain version, with the yardsticks of the same run beside
them: the two-read path's wrappers and the library calls (``torch.mv``; ``mv``,
sigmoid, ``mv`` of Xᵀ), timed before and after the grid.

``--wide`` times the two-read path above the single pass's bound, at
(``--batch``, 6M) bf16 features and bf16 products, over a grid of
:func:`~distlr_tpu_torch.ops.fused_lr.lr_wide_plan` plans (blocks per SM,
waves), the default plan first: the streaming forward with its epilogue
(``lr_logits_row_blocks``' launches) and the whole gradient (forward,
residual epilogue, backward), each checked against its plain version,
with ``torch.mv`` and the library gradient timed before and after.

``--trace`` builds the single pass with ``-DDISTLR_SLICE_TRACE``, runs it
once with its default plan and summarises when each hand-off of a tile
happened, over every CTA and 32 tiles from the middle of the batch: the
time from the producer's issue of a tile to each later event, how far the
last CTA's publish of a tile trails the median CTA's, and how long after
the last publish the resolvers see the tile complete.

``--backward`` times the float backward (``distlr_lr_backward_splits``,
bf16 X and products) at the feature-sharded block (1,024, 250,000) and
its half (1,024, 125,000), the two-read path's shapes (2,048, 1M) and
(64, 6M), and at 1/4 to 4 column tiles an SM, with each row-split count
from 1 to 8 forced, beside the
plan's own count and ``torch.mv(X.t(), r)``; each result is checked
against the plain version.  It also times the host's plan query.

``--times`` times, on one set of inputs, the int8 single pass at (2048,
1M) with both product types, the bf16 single pass at (2048, 1M), the int8
two-read gradient at (64, 6M) and that gradient's backward alone (the
C entry point ``distlr_lr_backward`` on the forward's residuals), the
bf16 backward (the same entry point) at (1,024, 250,000) and (2,048, 1M)
and the bf16 two-read gradient at (64, 6M), each with its library call
(``torch.mv`` of Xᵀ; for the gradient also ``mv``, sigmoid, ``mv`` of
Xᵀ) beside it, each checked against its plain version, and prints them on
one line with the
checkout whose kernels ran (the directory ``distlr_tpu_torch`` was
imported from).  It uses only entry points that every checkout since the
int8 kernels has, so it can time another checkout's kernels: run the
script by path with that checkout first on ``PYTHONPATH``, and compare
two checkouts only within one machine's run (parent, change, change,
parent).

Prints the ``nvidia-smi`` name and power line first, then one JSON object
per line.  Needs the card: without CUDA it exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

from distlr_tpu_torch.benchmarks.timing import mean_ms, nvidia_smi_line
from distlr_tpu_torch.ops import build, fused_lr

B, D = 2048, 1_000_000
WIDE_B, WIDE_D = 64, 6_000_000
TRACE_DEFINE = "DISTLR_SLICE_TRACE"
# kTraceTiles x kTraceEvents x 256 CTAs in the traced build
TRACE_TILES, TRACE_CTAS = 32, 256
TRACE_EVENTS = ("issued", "forward_start", "forwarded", "published", "resolved", "residuals_out",
                "backward_start", "stage_free", "resolve_start", "arrived", "poll_rounds")
# the events of a tile's chain, in order (a resolver starts waiting on a
# tile whenever it is done with its previous one; "arrived": its poll saw
# every CTA's partial; "poll_rounds" is a count of the poll's rounds)
CHAIN = TRACE_EVENTS[:8]
# (blocks per SM, rows a tile, stages, compute warps) of the single pass
# and the streaming logits, by X's type: an int8 row of a slice is half a
# bf16 one's bytes, and the int8 single pass takes 8 or 16 compute warps
GRAD_PLANS = {
    "bfloat16": [(1, 4, 3, 8), (1, 2, 4, 8), (1, 2, 6, 8), (1, 2, 7, 8), (1, 1, 7, 8),
                 (1, 1, 14, 8)],
    "int8": [(1, 4, 7, 16), (1, 4, 6, 16), (1, 4, 5, 16), (1, 2, 8, 16), (1, 1, 8, 16),
             (1, 4, 7, 8), (1, 4, 6, 8), (1, 2, 14, 8)],
}
LOGITS_PLANS = {
    "bfloat16": [(1, 4, 3, 8), (1, 2, 7, 8), (2, 2, 3, 8), (2, 4, 2, 8), (2, 2, 4, 8),
                 (2, 1, 6, 8)],
    "int8": [(1, 4, 7, 8), (2, 4, 2, 8), (2, 4, 3, 8), (2, 2, 6, 8), (3, 4, 2, 8)],
}
# (blocks per SM, waves) of the two-read path's streaming forward
WIDE_PLANS = [(3, 2), (3, 3), (3, 4), (3, 5), (3, 6), (3, 8), (2, 2), (2, 3), (1, 3)]
X_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}
# an int8 X's dequantization scale (z = s * X.w ~ 1), as chip_smoke.py's
INT8_SCALE = 3.0 / 127.0
ITERS = 20
TIMES_REPS = 25
# the float backward's shapes in --times: the feature-sharded block and
# the two-read path's full width
BACKWARD_SHAPES = ((1024, 250_000), (2048, 1_000_000))
# --backward: those, (64, 6M), the feature-sharded block at 8 column
# blocks of 1M, and D at 1/4, 1, 2, 3, 4 column tiles of 2,048 per SM of
# 132 (a literal: --times imports other checkouts' fused_lr)
BACKWARD_SWEEP = BACKWARD_SHAPES + ((WIDE_B, WIDE_D), (1024, 125_000)) + tuple(
    (2048, k * 132 * 2048 // 4) for k in (1, 4, 8, 12, 16))
HBM_BYTES_PER_S = 3.35e12


def _inputs(seed: int, b: int = B, d: int = D, masked: int = 48, x_dtype=torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if x_dtype == torch.int8:
        X = torch.randint(-127, 128, (b, d), device="cuda", generator=gen, dtype=torch.int8)
    else:
        X = torch.randn(b, d, device="cuda", generator=gen).to(x_dtype)
    w = torch.randn(d, device="cuda", generator=gen) / d ** 0.5
    y = (torch.rand(b, device="cuda", generator=gen) < 0.5).to(torch.float32)
    mask = torch.ones(b, device="cuda")
    if masked:
        mask[-masked:] = 0
    return w, X, y, mask


def _scale(X) -> float:
    return INT8_SCALE if X.dtype == torch.int8 else 1.0


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _ms(fn, iters: int = ITERS) -> float:
    return mean_ms(fn, iters, device=torch.device("cuda"), graph=False)


def _library_calls(w, X, y, mask) -> dict:
    """The library's gradient (``mv``, sigmoid, ``mv`` of Xᵀ) and logits
    (``mv``); for an int8 X the composite that converts X to bf16 first
    (no single call takes an int8 X into float products)."""
    s = _scale(X)
    wb = w.to(torch.bfloat16)

    def xb():
        return X.to(torch.bfloat16) if X.dtype == torch.int8 else X

    def grad():
        Xb = xb()
        r = (torch.sigmoid(torch.mv(Xb, wb).float() * s) - y) * mask
        return torch.mv(Xb.t(), r.to(torch.bfloat16)) * s

    return {"library_grad_ms": grad, "mv_ms": lambda: torch.mv(xb(), wb) * s}


def sweep(seed: int, x_dtype) -> None:
    w, X, y, mask = _inputs(seed, x_dtype=x_dtype)
    s = _scale(X)
    lib = fused_lr._lib_for(x_dtype)
    g_ref = fused_lr.fused_lr_grad_reference(w, X, y, mask, feature_scale=s)
    z_ref = fused_lr.lr_logits_reference(w, X, feature_scale=s)
    name = "int8" if x_dtype == torch.int8 else "bfloat16"
    yardsticks = {
        "two_launch_ms": lambda: fused_lr.fused_lr_grad_two_launch(w, X, y, mask,
                                                                   feature_scale=s),
        "row_blocks_ms": lambda: fused_lr.lr_logits_row_blocks(w, X, feature_scale=s),
        **_library_calls(w, X, y, mask),
    }
    print(json.dumps({"yardsticks": "before", "x_dtype": name,
                      **{k: _ms(f) for k, f in yardsticks.items()}}), flush=True)
    for kernel, plans in (("grad", GRAD_PLANS[name]), ("logits", LOGITS_PLANS[name])):
        for per_sm, rows, stages, warps in plans:
            plan = fused_lr.lr_launch_plan(B, D, x_dtype=x_dtype, kernel=kernel,
                                           ctas_per_sm=per_sm, rows=rows, stages=stages,
                                           compute_warps=warps)
            line = {"kernel": kernel, "x_dtype": name, "ctas_per_sm": per_sm, "rows": rows,
                    "stages": stages, "compute_warps": warps}
            if not plan.single_pass:
                print(json.dumps({**line, "fits": False}), flush=True)
                continue
            if kernel == "grad":
                def run():
                    return fused_lr.run_single_pass(lib, plan, w, X, y, mask, "bfloat16",
                                                    feature_scale=s)[0]
                ref = g_ref
            else:
                def run():
                    return fused_lr.run_streaming(lib, plan, w, X, "bfloat16", feature_scale=s)
                ref = z_ref
            err = _rel(run(), ref)
            print(json.dumps({**line, "ctas": plan.ctas, "smem_bytes": plan.smem_bytes,
                              "rel_err": err, "ms": _ms(run)}), flush=True)
    print(json.dumps({"yardsticks": "after", "x_dtype": name,
                      **{k: _ms(f) for k, f in yardsticks.items()}}), flush=True)


def wide_sweep(seed: int, batch: int, x_dtype) -> None:
    w, X, y, mask = _inputs(seed, batch, WIDE_D, batch // 5, x_dtype)
    s = _scale(X)
    lib = fused_lr._lib_for(x_dtype)
    g_ref = fused_lr.fused_lr_grad_reference(w, X, y, mask, feature_scale=s)
    z_ref = fused_lr.lr_logits_reference(w, X, feature_scale=s)
    name = "int8" if x_dtype == torch.int8 else "bfloat16"
    yardsticks = _library_calls(w, X, y, mask)
    print(json.dumps({"yardsticks": "before", "x_dtype": name, "B": batch, "D": WIDE_D,
                      **{k: _ms(f) for k, f in yardsticks.items()}}), flush=True)
    default = fused_lr.wide_plan_for(X)
    plans = [default] + [fused_lr.lr_wide_plan(batch, WIDE_D, x_dtype=x_dtype,
                                               ctas_per_sm=per_sm, waves=waves)
                         for per_sm, waves in WIDE_PLANS]
    for plan in plans:
        line = {"wide": True, "x_dtype": name, "default": plan is default,
                "ctas_per_sm": plan.ctas_per_sm, "waves": plan.waves, "stages": plan.stages}
        if not plan.smem_bytes:
            print(json.dumps({**line, "fits": False}), flush=True)
            continue

        def logits(plan=plan):
            return fused_lr.run_streaming(lib, plan, w, X, "bfloat16", feature_scale=s)

        def grad(plan=plan):
            return fused_lr.run_two_read(lib, plan, w, X, y, mask, "bfloat16",
                                         feature_scale=s)[0]

        print(json.dumps({**line, "ctas": plan.ctas, "slice_cols": plan.slice_cols,
                          "rows": plan.rows, "smem_bytes": plan.smem_bytes,
                          "logits_rel_err": _rel(logits(), z_ref), "logits_ms": _ms(logits),
                          "grad_rel_err": _rel(grad(), g_ref), "grad_ms": _ms(grad)}),
              flush=True)
    print(json.dumps({"yardsticks": "after", "x_dtype": name, "B": batch, "D": WIDE_D,
                      **{k: _ms(f) for k, f in yardsticks.items()}}), flush=True)


def _quantiles(values) -> dict:
    v = sorted(values)
    if not v:
        return {}
    return {"median": v[len(v) // 2], "p90": v[(9 * len(v)) // 10], "max": v[-1], "n": len(v)}


def trace(seed: int, x_dtype, compute_warps: int | None = None) -> None:
    w, X, y, mask = _inputs(seed, x_dtype=x_dtype)
    s = _scale(X)
    source = "fused_lr_int8" if x_dtype == torch.int8 else "fused_lr_grad"
    lib = fused_lr.bind(ctypes.CDLL(str(build.build(source, defines=(TRACE_DEFINE,)))))
    lib.distlr_slice_trace.argtypes = [ctypes.c_void_p]
    lib.distlr_slice_trace.restype = ctypes.c_int
    plan = fused_lr.launch_plan_for(X)
    if compute_warps is not None:
        plan = fused_lr.lr_launch_plan(B, D, x_dtype=x_dtype, compute_warps=compute_warps,
                                       num_sms=fused_lr._num_sms(X.device.index or 0))
        if not plan.single_pass:
            raise ValueError(f"no single-pass plan with {compute_warps} compute warps")
    fused_lr.run_single_pass(lib, plan, w, X, y, mask, "bfloat16", feature_scale=s)  # warm-up
    g, _ = fused_lr.run_single_pass(lib, plan, w, X, y, mask, "bfloat16", feature_scale=s)
    torch.cuda.synchronize()
    err = _rel(g, fused_lr.fused_lr_grad_reference(w, X, y, mask, feature_scale=s))
    n = TRACE_CTAS * TRACE_TILES * len(TRACE_EVENTS)
    buf = (ctypes.c_ulonglong * n)()
    if lib.distlr_slice_trace(buf) != 0:
        raise RuntimeError("could not read the trace back")
    t = torch.tensor(list(buf), dtype=torch.float64).view(TRACE_CTAS, TRACE_TILES, -1)
    t = t[:plan.ctas]
    if bool((t == 0).any()):
        raise RuntimeError("the trace has unrecorded events: is B large enough for its tiles?")
    since_issue = {ev: _quantiles((t[:, :, i] - t[:, :, 0]).flatten().tolist())
                   for i, ev in enumerate(TRACE_EVENTS[:-1]) if i}
    # each hand-off's own share: the time from one event to the next
    segments = {f"{a}->{b}": _quantiles((t[:, :, i + 1] - t[:, :, i]).flatten().tolist())
                for i, (a, b) in enumerate(zip(CHAIN, CHAIN[1:]))}
    pub = t[:, :, TRACE_EVENTS.index("published")]
    last_pub = pub.max(dim=0).values
    lag_of_last = (last_pub - pub.median(dim=0).values).tolist()
    resolved = t[:, :, TRACE_EVENTS.index("resolved")]
    seen_after_last = (resolved - last_pub).flatten().tolist()
    wait_start = t[:, :, TRACE_EVENTS.index("resolve_start")]
    # issue -> compute warp 0 starts the tile's forward (the tile has landed)
    landed = (t[:, :, 1] - t[:, :, 0]).mean(dim=1)
    period = torch.diff(t[0, :, TRACE_EVENTS.index("backward_start")]).tolist()
    print(json.dumps({
        "trace": "single_pass", "x_dtype": str(x_dtype).replace("torch.", ""),
        "plan": plan.as_dict(), "rel_err": err,
        "ns_after_issue": since_issue, "segment_ns": segments,
        "last_publish_after_median_publish_ns": _quantiles(lag_of_last),
        "resolved_after_last_publish_ns": _quantiles(seen_after_last),
        # when the resolver began waiting on the tile, against its last publish
        "resolve_start_after_last_publish_ns": _quantiles(
            (wait_start - last_pub).flatten().tolist()),
        "resolve_start_to_resolved_ns": _quantiles((resolved - wait_start).flatten().tolist()),
        "arrived_after_last_publish_ns": _quantiles(
            (t[:, :, TRACE_EVENTS.index("arrived")] - last_pub).flatten().tolist()),
        "arrived_to_resolved_ns": _quantiles(
            (resolved - t[:, :, TRACE_EVENTS.index("arrived")]).flatten().tolist()),
        "poll_rounds": _quantiles(t[:, :, TRACE_EVENTS.index("poll_rounds")].flatten().tolist()),
        "tile_period_ns_cta0": _quantiles(period),
        "slowest_landing_ctas": [[int(c), float(landed[c])] for c in landed.argsort()[-5:]],
    }), flush=True)


def _bf16_backward_inputs(seed: int, b: int, d: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(b, d, device="cuda", generator=gen).to(torch.bfloat16)
    return X, torch.randn(b, device="cuda", generator=gen)


def _backward_call(lib, X, r, splits=None):
    """``g = rᵀX`` through ``distlr_lr_backward`` (the entry point every
    checkout has) or, given ``splits``, ``distlr_lr_backward_splits``."""
    b, d = X.shape
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        g = torch.empty(d, dtype=torch.float32, device="cuda")
        if splits is None:
            rc = lib.distlr_lr_backward(X.data_ptr(), 1, r.data_ptr(), g.data_ptr(), b, d, 1,
                                        1.0, stream)
        else:
            rc = lib.distlr_lr_backward_splits(X.data_ptr(), 1, r.data_ptr(), g.data_ptr(), b,
                                               d, 1, splits, stream)
        if rc != 0:
            raise RuntimeError(f"lr_backward launch failed: CUDA error {rc}")
        return g
    return call


def backward_sweep(seed: int) -> None:
    """The float backward at each forced split count, one line a shape."""
    import time  # noqa: PLC0415

    lib = fused_lr._lib()
    for b, d in BACKWARD_SWEEP:
        X, r = _bf16_backward_inputs(seed, b, d)
        ref = r @ X.to(torch.float32)
        rb = r.to(torch.bfloat16)
        plan = fused_lr.backward_plan_for(X)
        line = {"backward": True, "shape": [b, d], "plan": plan,
                "bound_ms": 1e3 * (b * d * 2 + b * 4 + d * 4) / HBM_BYTES_PER_S,
                "mv_ms_before": _ms(lambda: torch.mv(X.t(), rb), TIMES_REPS)}
        ms, errs = {}, {}
        for splits in range(1, min(fused_lr.MAX_BACKWARD_SPLITS, b) + 1):
            call = _backward_call(lib, X, r, splits)
            errs[splits] = _rel(call(), ref)
            ms[splits] = _ms(call, TIMES_REPS)
        call = _backward_call(lib, X, r)
        line.update(ms_by_splits=ms, rel_err_by_splits=errs, plan_ms=_ms(call, TIMES_REPS),
                    same_bits=bool(torch.equal(call(), call())),
                    mv_ms_after=_ms(lambda: torch.mv(X.t(), rb), TIMES_REPS))
        print(json.dumps(line), flush=True)
        del X, ref
        torch.cuda.empty_cache()
    out = (ctypes.c_longlong * 4)()
    t0 = time.perf_counter()
    for _ in range(1000):
        lib.distlr_lr_backward_plan(1, 1, 1024, 250_000, out)
    print(json.dumps({"backward_plan_query_host_us": 1e3 * (time.perf_counter() - t0)}),
          flush=True)


def times(seed: int) -> None:
    """K1 (both product types), the bf16 single pass, K3 and K3's backward
    alone, each against its plain version, on one line."""
    import distlr_tpu_torch  # noqa: PLC0415

    out = {"times": True,
           "checkout": os.path.dirname(os.path.dirname(os.path.abspath(
               distlr_tpu_torch.__file__))),
           "reps": TIMES_REPS}
    w, X, y, mask = _inputs(seed, x_dtype=torch.int8)
    s = _scale(X)
    for cd in ("bfloat16", "float32"):
        def k1(cd=cd):
            return fused_lr.fused_lr_grad(w, X, y, mask, compute_dtype=cd, feature_scale=s)
        ref = fused_lr.fused_lr_grad_reference(w, X, y, mask, compute_dtype=cd, feature_scale=s)
        out[f"int8_single_pass_{cd}"] = {"rel_err": _rel(k1(), ref),
                                          "ms": _ms(k1, TIMES_REPS),
                                          "plan": fused_lr.launch_plan_for(X, cd).as_dict()}
    del X, ref
    torch.cuda.empty_cache()
    w, X, y, mask = _inputs(seed)

    def bf16():
        return fused_lr.fused_lr_grad(w, X, y, mask)
    out["bf16_single_pass"] = {"rel_err": _rel(bf16(), fused_lr.fused_lr_grad_reference(
        w, X, y, mask)), "ms": _ms(bf16, TIMES_REPS)}
    del X
    torch.cuda.empty_cache()

    w, X, y, mask = _inputs(seed, WIDE_B, WIDE_D, WIDE_B // 5, torch.int8)
    lib = fused_lr._int8_lib()

    def k3():
        return fused_lr.fused_lr_grad_two_launch(w, X, y, mask, feature_scale=s)
    g_ref = fused_lr.fused_lr_grad_reference(w, X, y, mask, feature_scale=s)
    z = fused_lr.lr_logits_reference(w, X, feature_scale=s)
    r = ((torch.sigmoid(z) - y) * mask).contiguous()
    stream = torch.cuda.current_stream().cuda_stream

    def backward():
        g = torch.empty(WIDE_D, dtype=torch.float32, device="cuda")
        rc = lib.distlr_lr_backward(X.data_ptr(), 2, r.data_ptr(), g.data_ptr(), WIDE_B,
                                    WIDE_D, 1, s, stream)
        if rc != 0:
            raise RuntimeError(f"lr_backward launch failed: CUDA error {rc}")
        return g
    bwd_ref = (r @ X.to(torch.float32)) * s
    out["int8_two_read"] = {"rel_err": _rel(k3(), g_ref), "ms": _ms(k3, TIMES_REPS),
                            "shape": [WIDE_B, WIDE_D]}
    out["int8_backward"] = {"rel_err": _rel(backward(), bwd_ref), "ms": _ms(backward, TIMES_REPS),
                            "shape": [WIDE_B, WIDE_D]}
    del X, g_ref, bwd_ref
    torch.cuda.empty_cache()

    lib = fused_lr._lib()
    for b, d in BACKWARD_SHAPES:
        X, r = _bf16_backward_inputs(seed, b, d)
        call, rb = _backward_call(lib, X, r), r.to(torch.bfloat16)
        out[f"bf16_backward_{b}x{d}"] = {"rel_err": _rel(call(), r @ X.to(torch.float32)),
                                         "ms": _ms(call, TIMES_REPS),
                                         "mv_ms": _ms(lambda: torch.mv(X.t(), rb), TIMES_REPS)}
        del X
        torch.cuda.empty_cache()
    w, X, y, mask = _inputs(seed, WIDE_B, WIDE_D, WIDE_B // 5)

    def two_read():
        return fused_lr.fused_lr_grad_two_launch(w, X, y, mask)
    rb = torch.randn(WIDE_B, device="cuda").to(torch.bfloat16)
    out["bf16_two_read"] = {
        "rel_err": _rel(two_read(), fused_lr.fused_lr_grad_reference(w, X, y, mask)),
        "ms": _ms(two_read, TIMES_REPS),
        "library_grad_ms": _ms(_library_calls(w, X, y, mask)["library_grad_ms"], TIMES_REPS),
        "backward_mv_ms": _ms(lambda: torch.mv(X.t(), rb), TIMES_REPS),
        "shape": [WIDE_B, WIDE_D]}
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="time the launch-plan grid")
    ap.add_argument("--trace", action="store_true", help="trace the single pass's hand-offs")
    ap.add_argument("--wide", action="store_true",
                    help="time the two-read path's plans above the single pass's bound")
    ap.add_argument("--backward", action="store_true",
                    help="time the float backward at each forced row-split count")
    ap.add_argument("--times", action="store_true",
                    help="time the int8 single pass and two-read gradient, its backward alone, "
                         "the bf16 single pass, backward and two-read gradient (for comparing "
                         "checkouts)")
    ap.add_argument("--x-dtype", choices=sorted(X_DTYPES), default="bfloat16",
                    help="X's type for --sweep, --trace and --wide")
    ap.add_argument("--compute-warps", type=int, default=None,
                    help="compute warps of the traced single pass (default: its plan's)")
    ap.add_argument("--batch", type=int, default=WIDE_B, help="rows of X for --wide")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("slice_kernels: needs the card (CUDA is not available)", file=sys.stderr)
        return 2
    print(nvidia_smi_line(), flush=True)
    x_dtype = X_DTYPES[args.x_dtype]
    if args.sweep or not (args.trace or args.wide or args.times or args.backward):
        sweep(args.seed, x_dtype)
    if args.backward:
        backward_sweep(args.seed)
    if args.wide:
        wide_sweep(args.seed, args.batch, x_dtype)
    if args.trace:
        trace(args.seed, x_dtype, args.compute_warps)
    if args.times:
        times(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
