#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``distlr_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py [--seed 0]

It builds the port's CUDA kernels from the sources in the checkout,
holds each against its plain PyTorch version on the card, drives the
port's main path — the sync dense-LR trainer at the repo's full width
(D = 1,000,000 features, 2048 rows a step, bfloat16 features) — through
``Trainer.load_data / fit / evaluate_metrics / save_model``, then the same
trainer at a width above the single-pass kernel's shared-memory bound (D =
6,000,000, where the two-read path takes over: the streaming forward in
several waves, a residual epilogue, the backward), then the four other
model families through ``Trainer.fit`` at the repo's published shapes
(``sparse_lr``, ``sparse_softmax`` and ``blocked_lr`` at the Avazu-style
D = 1M buckets, 21 fields, 65,536 rows a step; ``softmax`` at the
MNIST-shaped D = 784, K = 10, 60,000 rows, and its step alone at D = 1M,
2048 rows), then the ``gen-data -> sync -> eval`` CLI in subprocesses for
every family, and last the path of the
on-device generation probes: both roofline experiments
(``distlr_tpu_torch.benchmarks.exp_gen_roofline*``) at the published
(256, 8192) x 64 tile, in this process and as ``python -m``.  Each phase
prints JSON lines; any failure exits non-zero before the last line, which is
``{"ok": true, "device": {...}}`` only when every phase passed.  Without
CUDA, or without the rest of the repository beside it, it exits non-zero
and prints no result.  Imports nothing of JAX or of ``distlr_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import resource
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth and
# the f32 rate of the CUDA cores, which is what the kernels' products use.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12
# Per SM and clock, from NVIDIA's arithmetic-instruction throughput table
# for compute capability 9.0 (CUDA C++ documentation): 32-bit integer add, multiply, shift and
# logic operations; conversions to and from 32-bit types.  Times the SM
# count and the card's maximum SM clock (nvidia-smi clocks.max.sm).
INT32_OPS_PER_SM_CLOCK = 64
CONVERSIONS_PER_SM_CLOCK = 16
# Relative bound of a kernel against its plain version: both sum in f32,
# in different orders.
REL_TOL = 1e-3
FULL_D, FULL_B, FULL_TEST = 1_000_000, 2048, 256
# above the single pass's bound (5,045,568 for bf16 on 132 SMs)
WIDE_D, WIDE_B, WIDE_TEST = 6_000_000, 64, 16
CTR_FIELDS = 39
# the other families' shapes: benchmarks/bench_configs.py config 4 (Avazu-
# style sparse_lr: D = 1M buckets, 21 fields, 65,536 rows a step, vocab
# 1e7) and bench.py's blocked R = 8/16/32 sub-rows at that shape; config 5
# (MNIST-shaped softmax: D = 784, K = 10, 60,000 rows, 12,000 test rows)
# and its large-D row (D = 1M, K = 10, 2048 rows)
SPARSE_D, SPARSE_B, SPARSE_FIELDS, SPARSE_VOCAB, SPARSE_TEST = 1_000_000, 65_536, 21, 10**7, 8192
SPARSE_K = 10
SOFTMAX_D, SOFTMAX_K, SOFTMAX_N, SOFTMAX_TEST = 784, 10, 60_000, 12_000
SOFTMAX_WIDE_B, SOFTMAX_WIDE_D = 2048, 1_000_000
FAMILY_STEPS = 3
# trained weights on the card against the same code on the CPU: the
# sparse gradients add atomically in any order; softmax rounds to bf16
FAMILY_TOL = {"sparse_lr": 1e-4, "sparse_softmax": 1e-4, "blocked_lr": 1e-4, "softmax": 1e-3}
FUSED_SOURCE = "distlr_tpu_torch/ops/csrc/fused_lr_grad.cu"
# wrapper -> the Pallas kernel it replaces
FUSED_REPLACES = {
    "fused_lr_grad": "distlr_tpu/ops/pallas_lr.py:86",
    "lr_logits": "distlr_tpu/ops/pallas_lr.py:75",
    "fused_lr_grad_two_launch": "distlr_tpu/ops/pallas_lr.py:86",
    "lr_logits_row_blocks": "distlr_tpu/ops/pallas_lr.py:75",
}


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` back-to-back
    calls after a warm-up, between two CUDA events: the host issues ahead
    of the card, so its per-call cost (allocations, ctypes, launches) does
    not stretch the time unless it exceeds the device's."""
    import torch  # noqa: PLC0415

    from distlr_tpu_torch.benchmarks.timing import mean_ms  # noqa: PLC0415

    return mean_ms(fn, reps, device=torch.device("cuda"), graph=False)


def phase_env(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    env = {
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "python": sys.version.split()[0],
    }
    emit("env", **env)
    return env


def phase_build() -> None:
    """Both kernel sources, one nvcc each, started together."""
    from distlr_tpu_torch.ops import build, fused_lr, gen_roofline  # noqa: PLC0415

    t0 = time.perf_counter()
    names = ("fused_lr_grad", "gen_roofline")
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(build.build, names))
    fused_lr._lib()
    gen_roofline._lib()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[os.path.relpath(p, ROOT) for p in paths])


def _inputs(torch, gen, B, D, x_dtype, masked_tail=0):
    X = torch.randn(B, D, device="cuda", generator=gen).to(x_dtype)
    w = torch.randn(D, device="cuda", generator=gen) / math.sqrt(D)
    y = (torch.rand(B, device="cuda", generator=gen) < 0.5).to(torch.int32)
    mask = torch.ones(B, device="cuda")
    if masked_tail:
        mask[-masked_tail:] = 0
    return w, X, y, mask


def _launches(ops) -> dict:
    return {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}


def _grad_bound(B: int, D: int, x_bytes: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of the gradient: X, w, y, mask in and g out
    once; a multiply-add each way per element of X."""
    t_bytes = (B * D * x_bytes + D * 4 + 2 * B * 4 + D * 4) / HBM_BYTES_PER_S
    t_ops = 4 * B * D / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _logits_bound(B: int, D: int, x_bytes: int) -> tuple[float, str]:
    t_bytes = (B * D * x_bytes + D * 4 + B * 4) / HBM_BYTES_PER_S
    t_ops = 2 * B * D / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _library_grad(torch, w, X, y, mask):
    """One cuBLAS ``mv``, the sigmoid, one ``mv`` of Xᵀ: the same function
    in library calls (a yardstick only; the port never calls it)."""
    wb, yf = w.to(X.dtype), y.to(torch.float32)

    def run():
        r = (torch.sigmoid(torch.mv(X, wb).float()) - yf) * mask
        return torch.mv(X.t(), r.to(X.dtype))
    return run


def _plan_fields(plan) -> dict:
    return {k: plan.as_dict()[k] for k in
            ("ctas", "ctas_per_sm", "waves", "slice_cols", "rows", "stages", "smem_bytes",
             "single_pass")}


def _two_read_floor_ms(B: int, D: int, x_bytes: int) -> float:
    """Two reads of X at the HBM rate: the least time of any gradient that
    reads X once for the forward and once for the backward."""
    return 1e3 * (2 * B * D * x_bytes) / HBM_BYTES_PER_S


def _ncu_dram_bytes(timeout_s: int = 180) -> dict:
    """``dram__bytes_read.sum`` of one single-pass call at the full width,
    where Nsight Compute is installed (a one-read kernel reads ~4.1 GB)."""
    ncu = shutil.which("ncu") or next(
        (c for c in ("/usr/local/cuda/bin/ncu",) if os.path.exists(c)), None)
    if ncu is None:
        return {"ncu": None, "note": "ncu is not on this machine: DRAM bytes not measured"}
    script = ("import sys, torch; sys.path.insert(0, %r)\n"
              "from distlr_tpu_torch import ops\n"
              "X = torch.randn(%d, %d, device='cuda').to(torch.bfloat16)\n"
              "w = torch.randn(%d, device='cuda') * 1e-3\n"
              "y = torch.ones(%d, device='cuda'); m = torch.ones(%d, device='cuda')\n"
              "ops.fused_lr_grad(w, X, y, m); torch.cuda.synchronize()\n"
              % (ROOT, FULL_B, FULL_D, FULL_D, FULL_B, FULL_B))
    cmd = [ncu, "--metrics", "dram__bytes_read.sum", "-k", "regex:single_pass", "-c", "1",
           sys.executable, "-c", script]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        return {"ncu": ncu, "error": f"no result in {timeout_s} s"}
    m = re.search(r"dram__bytes_read\.sum\s+(\S+)\s+([\d.,]+)", out)
    if proc.returncode != 0 or m is None:
        return {"ncu": ncu, "error": f"exit {proc.returncode}", "tail": out[-600:]}
    unit, value = m.group(1), float(m.group(2).replace(",", ""))
    scale = {"byte": 1, "Kbyte": 1e3, "Mbyte": 1e6, "Gbyte": 1e9, "Tbyte": 1e12}.get(unit)
    return {"ncu": ncu, "dram_bytes_read": None if scale is None else value * scale,
            "raw": m.group(0)}


def phase_kernels(torch, seed: int) -> dict:
    """Each kernel against its plain version; timings at the full width."""
    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.ops import fused_lr  # noqa: PLC0415

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = dict.fromkeys(FUSED_REPLACES, 0.0)
    cases = [(64, 256, 10), (100, 1000, 7), (1, 1, 0), (4096, 16384, 0)]
    for B, D, tail in cases:
        for x_dtype in (torch.float32, torch.bfloat16):
            for cd in ("bfloat16", "float32"):
                w, X, y, mask = _inputs(torch, gen, B, D, x_dtype, tail)
                before = _launches(ops)
                g = ops.fused_lr_grad(w, X, y, mask, compute_dtype=cd)
                z = ops.lr_logits(w, X, compute_dtype=cd)
                torch.cuda.synchronize()
                after = _launches(ops)
                if (after["fused_lr_grad"], after["lr_logits"]) != (
                        before["fused_lr_grad"] + 1, before["lr_logits"] + 1):
                    raise AssertionError("a kernel wrapper did not count its launch")
                eg = rel_err(g, ops.fused_lr_grad_reference(w, X, y, mask, compute_dtype=cd))
                ez = rel_err(z, ops.lr_logits_reference(w, X, compute_dtype=cd))
                emit("kernel_check", B=B, D=D, x_dtype=str(x_dtype), compute_dtype=cd,
                     grad_rel_err=eg, logits_rel_err=ez,
                     plan=_plan_fields(fused_lr.launch_plan_for(X, cd)))
                if not (eg <= REL_TOL and ez <= REL_TOL):
                    raise AssertionError(f"kernel disagrees with its plain version at {(B, D, x_dtype, cd)}")
                worst["fused_lr_grad"] = max(worst["fused_lr_grad"], eg)
                worst["lr_logits"] = max(worst["lr_logits"], ez)

    # an all-masked batch has no residual: the gradient is exactly zero
    w, X, y, _ = _inputs(torch, gen, 64, 256, torch.bfloat16)
    g0 = ops.fused_lr_grad(w, X, y, torch.zeros(64, device="cuda"))
    if float(g0.abs().max()) != 0.0:
        raise AssertionError("all-masked batch gave a non-zero gradient")
    emit("kernel_check", case="all_masked", max_abs=0.0)

    # above the single pass's shared-memory bound: the two-read path
    B, D = 8, WIDE_D
    w, X, y, mask = _inputs(torch, gen, B, D, torch.bfloat16, masked_tail=2)
    if fused_lr.launch_plan_for(X).single_pass:
        raise AssertionError(f"({B}, {D}) bf16 should be above the single pass's bound")
    for cd in ("bfloat16", "float32"):
        before = _launches(ops)
        g = ops.fused_lr_grad(w, X, y, mask, compute_dtype=cd)
        z = ops.lr_logits(w, X, compute_dtype=cd)
        torch.cuda.synchronize()
        after = _launches(ops)
        moved = {k: after[k] - before[k] for k in FUSED_REPLACES}
        if moved != {"fused_lr_grad": 0, "lr_logits": 0, "fused_lr_grad_two_launch": 1,
                     "lr_logits_row_blocks": 1}:
            raise AssertionError(f"above the bound the calls did not take the two-read path: {moved}")
        eg = rel_err(g, ops.fused_lr_grad_reference(w, X, y, mask, compute_dtype=cd))
        ez = rel_err(z, ops.lr_logits_reference(w, X, compute_dtype=cd))
        emit("kernel_check", B=B, D=D, x_dtype="torch.bfloat16", compute_dtype=cd,
             path="two_read", grad_rel_err=eg, logits_rel_err=ez,
             plan=_plan_fields(fused_lr.wide_plan_for(X, cd)))
        if not (eg <= REL_TOL and ez <= REL_TOL):
            raise AssertionError(f"the two-read path disagrees with the plain version above the bound ({cd})")
        worst["fused_lr_grad_two_launch"] = max(worst["fused_lr_grad_two_launch"], eg)
        worst["lr_logits_row_blocks"] = max(worst["lr_logits_row_blocks"], ez)
    # the same bits on a second call; with_logits' z is the row blocks' z
    g1, z1 = ops.fused_lr_grad_two_launch(w, X, y, mask, with_logits=True)
    g2, z2 = ops.fused_lr_grad_two_launch(w, X, y, mask, with_logits=True)
    zr1, zr2 = ops.lr_logits_row_blocks(w, X), ops.lr_logits_row_blocks(w, X)
    same_wide = {"fused_lr_grad_two_launch": bool(torch.equal(g1, g2) and torch.equal(z1, z2)),
                 "lr_logits_row_blocks": bool(torch.equal(zr1, zr2)),
                 "with_logits_is_row_blocks": bool(torch.equal(z1, zr1))}
    del X, w, y, mask, g1, g2

    # the main path's shape: (2048, 1M) bf16 features, bf16 products
    B, D = FULL_B, FULL_D
    w, X, y, mask = _inputs(torch, gen, B, D, torch.bfloat16, masked_tail=48)
    results = {}
    for cd in ("bfloat16", "float32"):
        g, zg = ops.fused_lr_grad(w, X, y, mask, compute_dtype=cd, with_logits=True)
        g_ref = ops.fused_lr_grad_reference(w, X, y, mask, compute_dtype=cd)
        z = ops.lr_logits(w, X, compute_dtype=cd)
        z_ref = ops.lr_logits_reference(w, X, compute_dtype=cd)
        g2 = ops.fused_lr_grad_two_launch(w, X, y, mask, compute_dtype=cd)
        z2 = ops.lr_logits_row_blocks(w, X, compute_dtype=cd)
        errs = {"fused_lr_grad": (g, g_ref), "lr_logits": (z, z_ref),
                "fused_lr_grad_two_launch": (g2, g_ref), "lr_logits_row_blocks": (z2, z_ref)}
        rel = {k: rel_err(a, b) for k, (a, b) in errs.items()}
        rel["with_logits"] = rel_err(zg, z_ref)
        emit("kernel_check", B=B, D=D, x_dtype="torch.bfloat16", compute_dtype=cd,
             rel_err=rel, max_abs_err={k: float((a - b).abs().max()) for k, (a, b) in errs.items()})
        if max(rel.values()) > REL_TOL:
            raise AssertionError(f"a kernel disagrees with its plain version at full width ({cd}): {rel}")
        for k in FUSED_REPLACES:
            worst[k] = max(worst[k], rel[k])
        if cd == "bfloat16":
            for k, (a, b) in errs.items():
                results[k] = {"max_abs_err": float((a - b).abs().max())}
        del g_ref, z_ref

    # the same bits on a second call
    same = {"fused_lr_grad": bool(torch.equal(ops.fused_lr_grad(w, X, y, mask),
                                              ops.fused_lr_grad(w, X, y, mask))),
            "lr_logits": bool(torch.equal(ops.lr_logits(w, X), ops.lr_logits(w, X)))}
    emit("kernel_check", B=B, D=D, case="deterministic", same_bits=same)
    emit("kernel_check", B=8, D=WIDE_D, case="deterministic", same_bits=same_wide)
    if not all(same.values()) or not all(same_wide.values()):
        raise AssertionError(f"a kernel gave other bits on a second call: {same} {same_wide}")

    # timings at the main path's shape and types: the redesigned kernel
    # between two runs of the two-read path (old, new, new, old)
    reps = 25
    grad_old = lambda: ops.fused_lr_grad_two_launch(w, X, y, mask)  # noqa: E731
    grad_new = lambda: ops.fused_lr_grad(w, X, y, mask)  # noqa: E731
    order = [time_ms(f, reps) for f in (grad_old, grad_new, grad_new, grad_old)]
    bound_ms, bound_by = _grad_bound(B, D, X.element_size())
    results["fused_lr_grad"].update(
        ms=(order[1] + order[2]) / 2, two_pass_ms=(order[0] + order[3]) / 2,
        order_old_new_new_old_ms=order,
        plain_ms=time_ms(lambda: ops.fused_lr_grad_reference(w, X, y, mask), reps),
        library_ms=time_ms(_library_grad(torch, w, X, y, mask), reps),
        bound_ms=bound_ms, bound_by=bound_by,
        two_read_floor_ms=_two_read_floor_ms(B, D, X.element_size()),
        plan=_plan_fields(fused_lr.launch_plan_for(X)),
    )
    logits_old = lambda: ops.lr_logits_row_blocks(w, X)  # noqa: E731
    logits_new = lambda: ops.lr_logits(w, X)  # noqa: E731
    order = [time_ms(f, reps) for f in (logits_old, logits_new, logits_new, logits_old)]
    wb = w.to(torch.bfloat16)
    bound_ms, bound_by = _logits_bound(B, D, X.element_size())
    results["lr_logits"].update(
        ms=(order[1] + order[2]) / 2, row_blocks_ms=(order[0] + order[3]) / 2,
        order_old_new_new_old_ms=order,
        plain_ms=time_ms(lambda: ops.lr_logits_reference(w, X), reps),
        library_ms=time_ms(lambda: torch.mv(X, wb), reps),
        bound_ms=bound_ms, bound_by=bound_by,
        plan=_plan_fields(fused_lr.launch_plan_for(X, kernel="logits")),
    )
    for name in ("fused_lr_grad", "lr_logits"):
        r = results[name]
        r["rel_err"] = worst[name]
        emit("kernel_timing", kernel=name, B=B, D=D, x_dtype="bfloat16", reps=reps, **r)
    del X
    torch.cuda.empty_cache()
    emit("dram_bytes", kernel="fused_lr_grad", B=B, D=D,
         one_read_bytes=B * D * 2, **_ncu_dram_bytes())
    for name in ("fused_lr_grad_two_launch", "lr_logits_row_blocks"):
        results[name]["rel_err"] = worst[name]
    return results


def time_two_launch(torch, seed: int, results: dict) -> None:
    """The two-read path at the above-bound trainer's shape, (64, 6M) bf16,
    the shape its path gives it; then at (8, 6M), the smoke's smallest
    batch above the bound, where each block has only 8 tiles, and at
    (512, 6M), where X is 6.1 GB and the library calls run near the HBM
    rate.  The two-read floor (two reads of X) is the gradient's alone:
    the logits read X once."""
    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.ops import fused_lr  # noqa: PLC0415

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    D, reps = WIDE_D, 25
    for B in (WIDE_B, 8, 512):
        w, X, y, mask = _inputs(torch, gen, B, D, torch.bfloat16)
        wb = w.to(torch.bfloat16)
        g_ref = ops.fused_lr_grad_reference(w, X, y, mask)
        z_ref = ops.lr_logits_reference(w, X)
        plan = _plan_fields(fused_lr.wide_plan_for(X))
        bound_ms, bound_by = _grad_bound(B, D, X.element_size())
        grad = dict(
            max_abs_err=float((ops.fused_lr_grad_two_launch(w, X, y, mask) - g_ref).abs().max()),
            ms=time_ms(lambda: ops.fused_lr_grad_two_launch(w, X, y, mask), reps),
            plain_ms=time_ms(lambda: ops.fused_lr_grad_reference(w, X, y, mask), reps),
            library_ms=time_ms(_library_grad(torch, w, X, y, mask), reps),
            bound_ms=bound_ms, bound_by=bound_by, plan=plan,
            two_read_floor_ms=_two_read_floor_ms(B, D, X.element_size()))
        bound_ms, bound_by = _logits_bound(B, D, X.element_size())
        logits = dict(
            max_abs_err=float((ops.lr_logits_row_blocks(w, X) - z_ref).abs().max()),
            ms=time_ms(lambda: ops.lr_logits_row_blocks(w, X), reps),
            plain_ms=time_ms(lambda: ops.lr_logits_reference(w, X), reps),
            library_ms=time_ms(lambda: torch.mv(X, wb), reps),
            bound_ms=bound_ms, bound_by=bound_by, plan=plan)
        for name, r in (("fused_lr_grad_two_launch", grad), ("lr_logits_row_blocks", logits)):
            emit("kernel_timing", kernel=name, B=B, D=D, x_dtype="bfloat16", reps=reps, **r)
            if B == WIDE_B:
                results[name].update(shape=[B, D], **r)
            else:
                # measured times only: the bounds stay on the kernel_timing line
                results[name][f"at_{B}_rows"] = {k: r[k] for k in ("ms", "library_ms")}
        del X, g_ref, z_ref
        torch.cuda.empty_cache()


def _ctr_rows(rng, n: int, w_true, D: int):
    """``n`` dense rows in the config-3 CTR style: each of CTR_FIELDS
    fields one-hot into its own hashed bucket range (Zipf-skewed, so head
    buckets recur), labels drawn from the planted ``w_true``."""
    import numpy as np  # noqa: PLC0415

    per_field = D // CTR_FIELDS
    buckets = np.minimum(rng.zipf(1.3, size=(n, CTR_FIELDS)) - 1, per_field - 1)
    cols = buckets + np.arange(CTR_FIELDS) * per_field
    X = np.zeros((n, D), dtype=np.float32)
    X[np.arange(n)[:, None], cols] = 1.0
    z = w_true[cols].sum(axis=1)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.int32)
    return X, y


def phase_trainer(torch, seed: int, *, D: int = FULL_D, B: int = FULL_B,
                  test_rows: int = FULL_TEST, phase: str = "trainer") -> dict:
    """The main path at width D: load_data -> fit -> evaluate -> save, with
    the launch counts zeroed just before fit and read just after.  At the
    full width the slice kernels run; above their bound the two-read
    path's wrappers."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.ops import fused_lr  # noqa: PLC0415
    from distlr_tpu_torch.train import GlobalShardedData, Trainer  # noqa: PLC0415

    steps = 3
    rng = np.random.default_rng(seed)
    w_true = (rng.standard_normal(D) * 0.5).astype(np.float32)
    t0 = time.perf_counter()
    train = GlobalShardedData([_ctr_rows(rng, B, w_true, D)])
    test = GlobalShardedData([_ctr_rows(rng, test_rows, w_true, D)])
    data_s = time.perf_counter() - t0
    single = fused_lr.fused_lr_supported(
        B, D, num_sms=torch.cuda.get_device_properties(0).multi_processor_count)
    grad_fn, logits_fn = (("fused_lr_grad", "lr_logits") if single
                          else ("fused_lr_grad_two_launch", "lr_logits_row_blocks"))

    with tempfile.TemporaryDirectory(prefix="distlr-smoke-") as tmp:
        cfg = Config(num_feature_dim=D, feature_dtype="bfloat16",
                     compute_dtype="bfloat16", batch_size=-1, learning_rate=0.2,
                     l2_c=0.01, num_iteration=steps, test_interval=1, data_dir=tmp)
        t0 = time.perf_counter()
        trainer = Trainer(cfg).load_data(train=train, test=test)
        load_s = time.perf_counter() - t0
        w0 = trainer.init_weights().clone()

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.fit()
        metrics = trainer.evaluate_metrics()
        path = trainer.save_model()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _launches(ops)
        saved_ok = os.path.getsize(path) > D and open(path).readline().strip() == str(D)

    others = {k: v for k, v in launches.items() if k not in (grad_fn, logits_fn)}
    if launches[grad_fn] != steps or launches[logits_fn] < 1 or any(others.values()):
        raise AssertionError(f"the path did not run {grad_fn} once a step and {logits_fn}: {launches}")
    loss = trainer.metrics.latest("loss")
    if not (math.isfinite(loss) and math.isfinite(metrics["logloss"])):
        raise AssertionError(f"non-finite loss {loss} / logloss {metrics['logloss']}")
    if not saved_ok:
        raise AssertionError("the saved text model is malformed")

    # the same steps as the plain recurrence on the card
    X, y, mask = trainer._put(train.full_batch())
    w = w0
    n = mask.sum().clamp_min(1.0)
    for _ in range(steps):
        g = ops.fused_lr_grad_reference(w, X, y, mask, compute_dtype="bfloat16") / n
        w = w - cfg.learning_rate * (g + cfg.l2_c * w)
    w_rel = rel_err(trainer.weights, w)
    if w_rel > REL_TOL:
        raise AssertionError(f"trained weights differ from the plain recurrence: rel {w_rel}")
    # the step's device time on a resident batch, apart from the trainer's
    # step_ms, which also waits for the batch's host->device copy
    w_tmp = trainer.weights.clone()
    step_device_ms = time_ms(lambda: trainer.train_step(w_tmp, (X, y, mask)), 10)
    del X

    out = {
        "D": D, "B": B, "test_rows": test_rows, "steps": steps, "kernels": [grad_fn, logits_fn],
        "launches": launches, "loss": loss, "test_accuracy": metrics["accuracy"],
        "test_logloss": metrics["logloss"], "step_ms": 1e3 * trainer.timer.sec_per_step,
        "step_device_ms": step_device_ms,
        "weights_rel_err_vs_plain": w_rel, "data_build_s": data_s, "load_s": load_s,
        "fit_eval_save_s": fit_s,
        "host_peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "device_peak_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(phase, **out)
    return out


def _step_kernels(torch, fn, reps: int = 5) -> dict:
    """The CUDA kernels of ``fn`` from ``torch.profiler`` over ``reps``
    calls after a warm-up call, per call: their count, their summed
    device time and the largest by name.  Memsets and copies are counted
    apart.  Over one call a trace can miss a kernel; over several, a miss
    moves the means by a fraction."""
    from torch.autograd import DeviceType  # noqa: PLC0415
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in events if not e.name.startswith(("Memset", "Memcpy"))]
    by_name: dict[str, float] = {}
    for e in kernels:
        name = re.sub(r"^\(anonymous namespace\)::", "", e.name)[:90]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / reps
    return {"profiled_calls": reps, "kernels_per_step": len(kernels) / reps,
            "memsets_copies_per_step": (len(events) - len(kernels)) / reps,
            "kernel_us_per_step": sum(by_name.values()),
            "top_kernels_us": sorted(by_name.items(), key=lambda kv: -kv[1])[:6]}


def _family_data(family: str, seed: int):
    """(train, test) ``GlobalShardedData`` of one family at its published
    shape, made from ``seed`` by the port's own generators."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.data.hashing import encode_blocked, make_ctr_dataset  # noqa: PLC0415
    from distlr_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: PLC0415
    from distlr_tpu_torch.train import GlobalShardedData  # noqa: PLC0415

    if family == "softmax":
        X, y, _ = make_synthetic_dataset(SOFTMAX_N + SOFTMAX_TEST, SOFTMAX_D, seed=seed,
                                         num_classes=SOFTMAX_K)
        leaves, n_test = (X, y), SOFTMAX_TEST
    else:
        raw, cols, vals, y, _ = make_ctr_dataset(SPARSE_B + SPARSE_TEST, SPARSE_FIELDS,
                                                 SPARSE_VOCAB, SPARSE_D, seed=seed)
        n_test = SPARSE_TEST
        if family == "sparse_softmax":
            # K classes from a planted (D, K) table over the same hashed rows
            rng = np.random.default_rng(seed + 1)
            w_true = rng.standard_normal((SPARSE_D, SPARSE_K)).astype(np.float32)
            z = w_true[cols].sum(axis=1)
            y = np.argmax(z + rng.gumbel(size=z.shape), axis=1).astype(np.int32)
        if family == "blocked_lr":
            leaves = (*encode_blocked(raw, SPARSE_D // 8, 8, seed=seed), y)
        else:
            leaves = (cols, vals, y)
    return (GlobalShardedData([tuple(a[n_test:] for a in leaves)]),
            GlobalShardedData([tuple(a[:n_test] for a in leaves)]))


def _family_bytes(batch, params) -> int:
    """Least bytes of one step: each leaf of the batch read once, the
    parameters read once and written once."""
    return sum(a.numel() * a.element_size() for a in batch) + 2 * params.numel() * 4


def phase_family(torch, seed: int, family: str) -> dict:
    """One model family through the user's entry points at its published
    shape: load_data -> fit (3 full-batch steps) -> evaluate -> save, the
    launch counts zeroed just before fit and read just after (no kernel of
    ``ops`` is on these paths: they run library GEMMs, gathers and
    ``index_add_``); then the same steps with the same code on the CPU from
    the same data and initial weights."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.train import Trainer  # noqa: PLC0415
    from distlr_tpu_torch.train.export import load_model_text  # noqa: PLC0415

    t0 = time.perf_counter()
    train, test = _family_data(family, seed)
    data_s = time.perf_counter() - t0
    # the configs' step settings: lr 0.3 from zeros (config 5), lr 0.5 (config 4)
    if family == "softmax":
        kw = dict(num_feature_dim=SOFTMAX_D, num_classes=SOFTMAX_K, learning_rate=0.3)
    else:
        kw = dict(num_feature_dim=SPARSE_D, num_classes=SPARSE_K, learning_rate=0.5)
    kw.update(model=family, batch_size=-1, l2_c=0.0, num_iteration=FAMILY_STEPS,
              test_interval=1)
    with tempfile.TemporaryDirectory(prefix="distlr-smoke-") as tmp:
        cfg = Config(data_dir=tmp, **kw)
        trainer = Trainer(cfg).load_data(train=train, test=test)
        w0 = trainer.init_weights().clone()
        if family == "softmax":
            w0.zero_()
            trainer.weights = w0.clone()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        step_ms = []
        for _ in range(FAMILY_STEPS):  # one full-batch step an epoch
            before = trainer.timer.elapsed
            trainer.fit(epochs=1, eval_fn=lambda e, a: None)
            step_ms.append(1e3 * (trainer.timer.elapsed - before))
        metrics = trainer.evaluate_metrics()
        path = trainer.save_model()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _launches(ops)
        saved = load_model_text(path, shape=trainer.model.param_shape)
    if any(launches.values()):
        raise AssertionError(f"{family}'s path launched a kernel of ops: {launches}")
    loss = trainer.metrics.latest("loss")
    if not (math.isfinite(loss) and math.isfinite(metrics["logloss"])):
        raise AssertionError(f"{family}: non-finite loss {loss} / logloss {metrics['logloss']}")
    if not np.allclose(saved, trainer.weights.cpu().numpy(), rtol=1e-5, atol=1e-6):
        raise AssertionError(f"{family}: the saved text model does not load back")

    on_cpu = Trainer(cfg.replace(device="cpu")).load_data(train=train, test=test)
    on_cpu.weights = w0.cpu()
    t0 = time.perf_counter()
    w_cpu = on_cpu.fit(eval_fn=lambda e, a: None)
    cpu_s = time.perf_counter() - t0
    w_rel = rel_err(trainer.weights.cpu(), w_cpu)
    if not w_rel <= FAMILY_TOL[family]:
        raise AssertionError(f"{family}: card weights differ from the CPU's: rel {w_rel}")

    batch = trainer._put(train.full_batch())
    w_tmp = trainer.weights.clone()
    bound_ms = 1e3 * _family_bytes(batch, w_tmp) / HBM_BYTES_PER_S
    out = {
        "family": family, "shape": list(trainer.model.param_shape), "rows": train.num_samples,
        "test_rows": test.num_samples, "steps": FAMILY_STEPS, "launches": launches,
        "loss": loss, "test_accuracy": metrics["accuracy"], "test_logloss": metrics["logloss"],
        "step_ms": step_ms,
        "step_device_ms": time_ms(lambda: trainer.train_step(w_tmp, batch), 10),
        **_step_kernels(torch, lambda: trainer.train_step(w_tmp, batch)),
        "bound_ms": bound_ms, "bound_by": "bytes",
        "weights_rel_err_vs_cpu": w_rel, "tolerance": FAMILY_TOL[family],
        "data_build_s": data_s, "fit_eval_save_s": fit_s, "cpu_fit_s": cpu_s,
    }
    out["device_busy_share"] = out["kernel_us_per_step"] / (1e3 * out["step_device_ms"])
    if family == "blocked_lr":
        out["step_alone_by_block_size"] = _blocked_step_alone(torch, seed, cfg, batch[-2:])
    del batch
    emit(f"trainer_{family}", **out)
    torch.cuda.empty_cache()
    return out


def _blocked_step_alone(torch, seed: int, cfg, y_mask) -> dict:
    """blocked_lr's step on a resident batch at R = 16 and 32 (bench.py's
    blocked sub-rows), from the same raw rows hashed at each width."""
    from distlr_tpu_torch.data.hashing import encode_blocked, make_ctr_dataset  # noqa: PLC0415
    from distlr_tpu_torch.models import get_model  # noqa: PLC0415
    from distlr_tpu_torch.parallel import make_sync_train_step  # noqa: PLC0415

    raw = make_ctr_dataset(SPARSE_B + SPARSE_TEST, SPARSE_FIELDS, SPARSE_VOCAB, SPARSE_D,
                           seed=seed)[0][SPARSE_TEST:]
    out = {}
    for r in (16, 32):
        c = cfg.replace(block_size=r)
        model = get_model(c)
        step = make_sync_train_step(model, c, 1)
        batch = tuple(torch.from_numpy(a).cuda() for a in encode_blocked(raw, SPARSE_D // r, r,
                                                                           seed=seed)) + y_mask
        t = model.init(c, "cuda")
        out[f"R{r}"] = {"step_device_ms": time_ms(lambda: step(t, batch), 10),
                        **_step_kernels(torch, lambda: step(t, batch)),
                        "bound_ms": 1e3 * _family_bytes(batch, t) / HBM_BYTES_PER_S}
    return out


def time_softmax_wide(torch, seed: int) -> dict:
    """Dense softmax's step alone at config 5's large-D row (2048, 1M,
    K = 10), bf16 X resident on the card: the step, the forward alone, the
    kernels of one step, and one and two reads of X at the HBM rate.  The
    forward and the backward are each held against the f32 product of the
    same bf16 operands on a slice."""
    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.models import get_model  # noqa: PLC0415
    from distlr_tpu_torch.parallel import make_sync_train_step  # noqa: PLC0415

    B, D, K = SOFTMAX_WIDE_B, SOFTMAX_WIDE_D, SOFTMAX_K
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(B, D, device="cuda", generator=gen).to(torch.bfloat16)
    y = torch.randint(0, K, (B,), device="cuda", generator=gen).to(torch.int32)
    mask = torch.ones(B, device="cuda")
    W = torch.randn(D, K, device="cuda", generator=gen) * 1e-3
    cfg = Config(model="softmax", num_feature_dim=D, num_classes=K, learning_rate=0.1,
                 l2_c=0.0, feature_dtype="bfloat16")
    model = get_model(cfg)
    step = make_sync_train_step(model, cfg, 1)
    Wb = W.to(torch.bfloat16).float()
    z = model.logits(W, X)
    fwd_rel = rel_err(z[:256], X[:256].float() @ Wb)
    R = torch.randn(B, K, device="cuda", generator=gen)
    cols = slice(0, 65_536)
    bwd_rel = rel_err(model._backward(W, (X,), R)[cols],
                      X[:, cols].float().t() @ R.to(torch.bfloat16).float())
    if not (z.dtype == torch.float32 and max(fwd_rel, bwd_rel) <= REL_TOL):
        raise AssertionError(f"softmax GEMMs disagree with the f32 product: {fwd_rel} {bwd_rel}")
    one_read = 1e3 * B * D * 2 / HBM_BYTES_PER_S
    out = {
        "B": B, "D": D, "K": K, "x_dtype": "bfloat16",
        "step_device_ms": time_ms(lambda: step(W, (X, y, mask)), 10),
        "logits_ms": time_ms(lambda: model.logits(W, X), 10),
        **_step_kernels(torch, lambda: step(W, (X, y, mask))),
        "bound_ms": 1e3 * _family_bytes((X, y, mask), W) / HBM_BYTES_PER_S, "bound_by": "bytes",
        "one_read_of_x_ms": one_read, "two_reads_of_x_ms": 2 * one_read,
        "logits_rel_err": fwd_rel, "grad_product_rel_err": bwd_rel,
        "route": "cuBLAS bf16 GEMM with an f32 result (torch.mm out_dtype), forward and backward",
    }
    out["device_busy_share"] = out["kernel_us_per_step"] / (1e3 * out["step_device_ms"])
    emit("step_softmax_wide", **out)
    del X, W, Wb, z
    torch.cuda.empty_cache()
    return out


# model family -> (gen-data flags, sync / eval flags, the saved params'
# shape, sync's iterations and test interval)
CLI_FAMILIES = {
    "binary_lr": (["--num-feature-dim", "123"], ["--num-feature-dim", "123"], (123,), 30, 10),
    "softmax": (["--num-feature-dim", "32", "--num-classes", "3"],
                ["--num-feature-dim", "32", "--model", "softmax", "--num-classes", "3"], (32, 3),
                10, 5),
    "sparse_lr": (["--num-feature-dim", "4096", "--ctr-fields", "8", "--ctr-vocab", "100"],
                  ["--num-feature-dim", "4096", "--model", "sparse_lr"], (4096,), 10, 5),
    "sparse_softmax": (["--num-feature-dim", "64", "--num-classes", "4"],
                       ["--num-feature-dim", "64", "--model", "sparse_softmax",
                        "--num-classes", "4"], (64, 4), 10, 5),
    "blocked_lr": (["--num-feature-dim", "4096", "--ctr-fields", "8", "--ctr-raw",
                    "--ctr-tuples", "64", "--ctr-vocab", "1000"],
                   ["--num-feature-dim", "4096", "--model", "blocked_lr", "--block-size", "8"],
                   (512, 8), 10, 5),
}
EVAL_LINE = r"^\d\d:\d\d:\d\d Iteration (\d+), accuracy: (\S+)$"


def _launch(*argv) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"launch {' '.join(argv[:3])} exited {proc.returncode}:\n"
                             f"{proc.stderr[-2000:]}")
    return proc.stdout


def _cli_family(tmp: str, family: str) -> dict:
    """gen-data -> sync (2 workers, on the card) -> eval of one family at a
    small size: the eval lines come at the test interval, the saved model
    has the params' size, and eval scores what the last line reported."""
    gen_flags, flags, shape, iters, interval = CLI_FAMILIES[family]
    d = os.path.join(tmp, family)
    _launch("gen-data", "--data-dir", d, "--num-samples", "2000", "--num-parts", "2", *gen_flags)
    out = _launch("sync", "--data-dir", d, *flags, "--num-workers", "2", "--num-iteration",
                  str(iters), "--test-interval", str(interval), "--learning-rate", "0.5",
                  "--l2-c", "0")
    lines = re.findall(EVAL_LINE, out, re.M)
    if [int(n) for n, _ in lines] != list(range(interval, iters + 1, interval)):
        raise AssertionError(f"unexpected eval lines from {family} sync:\n{out}")
    model_file = os.path.join(d, "models", "part-001")
    with open(model_file) as f:
        if int(f.readline()) != math.prod(shape) or len(f.readline().split()) != math.prod(shape):
            raise AssertionError(f"{family} sync wrote a malformed model file")
    ev = _launch("eval", "--data-dir", d, *flags, "--model-file", model_file)
    m = re.search(r"accuracy: (\S+)\s+test_logloss: (\S+)", ev)
    if m is None or abs(float(m.group(1)) - float(lines[-1][1])) > 1e-4:
        raise AssertionError(f"{family} eval disagrees with its last sync line: {ev}")
    return {"sync_accuracy": [float(a) for _, a in lines], "eval_accuracy": float(m.group(1)),
            "eval_logloss": float(m.group(2))}


def phase_cli() -> None:
    """gen-data -> sync -> eval through ``python -m distlr_tpu_torch.launch``
    for every model family, the families' chains side by side."""
    with tempfile.TemporaryDirectory(prefix="distlr-smoke-cli-") as tmp:
        with ThreadPoolExecutor(len(CLI_FAMILIES)) as pool:
            futures = {f: pool.submit(_cli_family, tmp, f) for f in CLI_FAMILIES}
            results = {f: fut.result() for f, fut in futures.items()}
    emit("cli", **results.pop("binary_lr"), families=results)


# --- the on-device generation probes ----------------------------------------
# wrapper -> the Pallas kernel it replaces
ROOFLINE_REPLACES = {
    "roofline_gen": "benchmarks/exp_gen_roofline.py:44",
    "roofline_fwd": "benchmarks/exp_gen_roofline.py:76",
    "roofline_full": "benchmarks/exp_gen_roofline.py:112",
    "roofline_hash": "benchmarks/exp_gen_roofline2.py:40",
    "roofline_const": "benchmarks/exp_gen_roofline2.py:76",
    "roofline_mxu": "benchmarks/exp_gen_roofline2.py:109",
}
ROOFLINE_NO_LIBRARY = {
    "roofline_full": "none: no PyTorch call regenerates x between the forward and "
                     "the backward; storing x is a different function",
    "roofline_hash": "none: PyTorch has no call for this integer hash",
}
ROOFLINE_SOURCE = "distlr_tpu_torch/ops/csrc/gen_roofline.cu"
ROOFLINE_ITERS = 200        # back-to-back launches timed per kernel
ROOFLINE_PLAIN_ITERS = 3    # the plain versions take milliseconds each
EXPERIMENT_LINES = {
    "distlr_tpu_torch.benchmarks.exp_gen_roofline": (
        ("A", r"^A gen-only:\s+([\d.]+) G elem/s$"),
        ("B", r"^B gen\+fwd:\s+([\d.]+) G elem/s$"),
        ("C", r"^C full fwd\+bwd:\s+([\d.]+) G gen-elem/s$"),
        ("samples_per_s_at_1M", r"^   implied samples/sec at D=1M: ([\d,]+)$"),
    ),
    "distlr_tpu_torch.benchmarks.exp_gen_roofline2": (
        ("D", r"^D iota-hash \+ fwd : +([\d.]+) G elem/s$"),
        ("E", r"^E const tile \+ fwd: +([\d.]+) G elem/s$"),
        ("F", r"^F const tile \+ MXU: +([\d.]+) G elem/s$"),
    ),
}


def _max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def roofline_bound(work: dict, sms: int, clock_hz: float) -> tuple[float, str, str]:
    """(bound_ms, bound_by, limiting term) of ``gen_roofline.roofline_work``
    counts: the largest of bytes over the HBM rate and each kind of
    operation over the card's rate for it."""
    terms = {
        "bytes": work["bytes"] / HBM_BYTES_PER_S,
        "int_ops": work["int_ops"] / (INT32_OPS_PER_SM_CLOCK * sms * clock_hz),
        "conversions": work["conversions"] / (CONVERSIONS_PER_SM_CLOCK * sms * clock_hz),
        "f32_flops": work["f32_flops"] / F32_FLOPS_PER_S,
        "bf16_flops": work["bf16_flops"] / BF16_TENSOR_FLOPS_PER_S,
    }
    limit = max(terms, key=terms.get)
    return 1e3 * terms[limit], "bytes" if limit == "bytes" else "operations", limit


def _roofline_calls(torch, seed: int, bt: int, dt: int, reps: int):
    """wrapper name -> (kernel call, plain call, library call or None,
    whether the library call may be captured in a CUDA graph)."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.ops import gen_roofline as gr  # noqa: PLC0415

    rng = np.random.default_rng(seed)

    def normal(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).cuda()

    s = torch.tensor([seed], dtype=torch.int32, device="cuda")
    w = normal((1, dt), dt ** -0.5)
    y = torch.from_numpy((rng.random((bt, 1)) < 0.5).astype(np.float32)).cuda()
    x = normal((bt, dt))
    wm = normal((dt, gr.MXU_N), dt ** -0.5)
    xb, wmb = x.to(torch.bfloat16), wm.to(torch.bfloat16)
    n = reps * bt * dt

    def randint():
        return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device="cuda")

    def library_fwd():
        return torch.mv(randint().view(reps * bt, dt).float() * 2.0**-31 - 1.0, w[0])

    def library_const():
        return [torch.mv(x, w[0]) for _ in range(reps)]

    def library_mxu():
        return [torch.matmul(xb, wmb) for _ in range(reps)]

    return {
        "roofline_gen": (lambda: ops.roofline_gen(s, bt=bt, dt=dt, reps=reps),
                         lambda: gr.roofline_gen_reference(s, bt=bt, dt=dt, reps=reps),
                         randint, False),
        "roofline_fwd": (lambda: ops.roofline_fwd(s, w, bt=bt, reps=reps),
                         lambda: gr.roofline_fwd_reference(s, w, bt=bt, reps=reps),
                         library_fwd, False),
        "roofline_full": (lambda: ops.roofline_full(s, w, y, reps=reps),
                          lambda: gr.roofline_full_reference(s, w, y, reps=reps), None, False),
        "roofline_hash": (lambda: ops.roofline_hash(w, bt=bt, reps=reps),
                          lambda: gr.roofline_hash_reference(w, bt=bt, reps=reps), None, False),
        "roofline_const": (lambda: ops.roofline_const(x, w, reps=reps),
                           lambda: gr.roofline_const_reference(x, w, reps=reps),
                           library_const, True),
        "roofline_mxu": (lambda: ops.roofline_mxu(x, wm, reps=reps),
                         lambda: gr.roofline_mxu_reference(x, wm, reps=reps),
                         library_mxu, True),
    }


def phase_roofline(torch, seed: int) -> dict:
    """Each probe kernel against its plain version on the same inputs, at a
    small tile and the published one (row 2 exactly, the others within
    REL_TOL); then times at the published tile."""
    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.benchmarks.timing import mean_ms  # noqa: PLC0415
    from distlr_tpu_torch.ops import gen_roofline as gr  # noqa: PLC0415

    published = (gr.BT, gr.DT, gr.REPS)
    results = {}
    worst = dict.fromkeys(ROOFLINE_REPLACES, 0.0)
    # (128, 2048, 3): two row strips and eight depth slices of mxu
    for bt, dt, reps in ((64, 1024, 8), (128, 2048, 3), published):
        for name, (kern, plain, _, _) in _roofline_calls(torch, seed, bt, dt, reps).items():
            wrapper = getattr(ops, name)
            before = wrapper.launches
            got = kern()
            torch.cuda.synchronize()
            if wrapper.launches != before + 1:
                raise AssertionError(f"{name} did not count its launch")
            ref = plain()
            max_abs = float((got - ref).abs().max())
            rel = rel_err(got, ref)
            emit("roofline_check", kernel=name, bt=bt, dt=dt, reps=reps,
                 max_abs_err=max_abs, rel_err=rel)
            ok = max_abs == 0.0 if name == "roofline_gen" else rel <= REL_TOL
            if not (ok and math.isfinite(max_abs)):
                raise AssertionError(f"{name} disagrees with its plain version at {(bt, dt, reps)}")
            worst[name] = max(worst[name], rel)
            if (bt, dt, reps) == published:
                results[name] = {"max_abs_err": max_abs, "rel_err": worst[name]}

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = _max_sm_clock_hz()
    dev = torch.device("cuda")
    for name, (kern, plain, library, graph) in _roofline_calls(torch, seed, *published).items():
        bound_ms, bound_by, limit = roofline_bound(gr.roofline_work(name[len("roofline_"):]),
                                                   sms, clock_hz)
        r = results[name]
        r.update(
            ms=mean_ms(kern, ROOFLINE_ITERS, device=dev),
            plain_ms=mean_ms(plain, ROOFLINE_PLAIN_ITERS, device=dev, graph=False),
            library_ms=None if library is None else mean_ms(
                library, ROOFLINE_ITERS if graph else 20, device=dev, graph=graph),
            bound_ms=bound_ms, bound_by=bound_by, bound_term=limit,
            plan=gr.probe_plan(name[len("roofline_"):]),
        )
        if library is None:
            r["library_note"] = ROOFLINE_NO_LIBRARY[name]
        emit("kernel_timing", kernel=name, bt=published[0], dt=published[1],
             reps=published[2], iters=ROOFLINE_ITERS, sms=sms, max_sm_clock_hz=clock_hz, **r)
    torch.cuda.empty_cache()
    return results


def _experiment_rates(module: str, out: str, smi: str) -> dict:
    lines = out.splitlines()
    if not lines or lines[0] != smi:
        raise AssertionError(f"{module} did not print the nvidia-smi line first:\n{out}")
    rates = {}
    for key, pattern in EXPERIMENT_LINES[module]:
        m = re.search(pattern, out, re.M)
        if m is None:
            raise AssertionError(f"{module} printed no {key!r} line:\n{out}")
        rates[key] = float(m.group(1).replace(",", ""))
        if not rates[key] > 0:
            raise AssertionError(f"{module}: {key} rate is not positive:\n{out}")
    return rates


def phase_roofline_experiments(torch, smi: str) -> dict:
    """The probes' path: both experiments' ``main()`` as a user runs
    them, launch counts zeroed just before and read just after; then each
    once more as ``python -m`` in a subprocess."""
    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.benchmarks import exp_gen_roofline, exp_gen_roofline2  # noqa: PLC0415
    from distlr_tpu_torch.ops import gen_roofline  # noqa: PLC0415

    experiments = {"distlr_tpu_torch.benchmarks.exp_gen_roofline": exp_gen_roofline,
               "distlr_tpu_torch.benchmarks.exp_gen_roofline2": exp_gen_roofline2}
    outs = {}
    ops.reset_launch_counts()
    for module, experiment in experiments.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = experiment.main([])
        if rc != 0:
            raise AssertionError(f"{module}.main exited {rc}")
        outs[module] = buf.getvalue()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in gen_roofline.KERNEL_WRAPPERS}
    if min(launches.values()) < 1:
        raise AssertionError(f"the experiments did not launch every probe kernel: {launches}")
    rates = {}
    for module, out in outs.items():
        rates.update(_experiment_rates(module, out, smi))

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cli_rates = {}
    for module in experiments:
        proc = subprocess.run([sys.executable, "-m", module], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"python -m {module} exited {proc.returncode}:\n{proc.stderr[-2000:]}")
        cli_rates.update(_experiment_rates(module, proc.stdout, smi))
    emit("roofline_experiments", launches=launches, g_elem_per_s=rates, cli_g_elem_per_s=cli_rates)
    return launches


# function (a substring of its mangled name) -> (opcode prefixes, least
# count of them inside one loop of its SASS, what that shows, opcode
# prefixes that no loop of it may hold)
SASS_FACTS = {
    "gen_kernel": (("IMAD.WIDE", "IMAD.HI"), 17,
                   "every product of a Philox block that depends on t, each pass of t", ()),
    "const_rows_kernel": (("FFMA",), 8,
                          "a pass's 8 FMAs (2 rows x 4 columns) stay in the pass loop", ()),
    "mxu_wgmma_kernel": (("HGMMA",), 4,
                         "a pass's 4 wgmma k-steps of a 64-deep chunk in the pass loop, "
                         "and no mma.sync (HMMA)", ("HMMA",)),
}


def _sass_loops(text: str) -> dict:
    """Mangled function name -> opcode counts of each loop of its SASS (the
    instructions from a backward branch's target up to the branch)."""
    funcs = {}
    for block in re.split(r"^\s*Function : ", text, flags=re.M)[1:]:
        name = block.split(None, 1)[0]
        insts, labels = [], {}
        pending = []
        for line in block.splitlines():
            m = re.match(r"^\s*(\.L_x_\d+):", line)
            if m:
                pending.append(m.group(1))
                continue
            m = re.match(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                addr = int(m.group(1), 16)
                for lab in pending:
                    labels[lab] = addr
                pending = []
                insts.append((addr, m.group(2).strip()))
        loops = []
        for addr, ins in insts:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)", ins)
            if not m:
                continue
            tgt = m.group(1)
            tgt = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt, addr + 1)
            if tgt <= addr:
                ops = {}
                for a, i in insts:
                    if tgt <= a <= addr:
                        op = i.split()[1] if i.startswith("@") else i.split()[0]
                        ops[op] = ops.get(op, 0) + 1
                loops.append(ops)
        funcs[name] = loops
    return funcs


def phase_sass() -> dict:
    """What the probe kernels compiled to: wgmma (HGMMA) and no mma.sync
    (HMMA) in mxu's pass loop, the FMAs inside const's pass loop, a whole
    Philox block in gen's loop."""
    from distlr_tpu_torch.ops import build  # noqa: PLC0415

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(build.library_path("gen_roofline"))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    loops = _sass_loops(text)
    facts = {}
    for fn, (prefixes, least, what, absent) in SASS_FACTS.items():
        names = [n for n in loops if fn in n]
        counts = [sum(c for op, c in loop.items() if op.startswith(prefixes))
                  for n in names for loop in loops[n]]
        best = max(counts, default=0)
        found = sorted({op for n in names for loop in loops[n] for op in loop
                        if absent and op.startswith(absent)})
        facts[fn] = {"most_in_one_loop": best, "opcodes": prefixes, "shows": what,
                     "absent": absent, "found_absent": found}
        if best < least:
            raise AssertionError(f"SASS of {fn}: {best} of {prefixes} in its loops, "
                                 f"expected >= {least} ({what}); functions {names}")
        if found:
            raise AssertionError(f"SASS of {fn} holds {found}, which it must not ({what})")
    emit("sass", library=os.path.relpath(build.library_path("gen_roofline"), ROOT), facts=facts)
    return facts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of every random input")
    args = ap.parse_args(argv)

    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "distlr_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(distlr_tpu_torch/ is missing beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # plain f32 matmuls stay full f32 on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from distlr_tpu_torch import ops  # noqa: PLC0415

    phase = "env"
    try:
        env = phase_env(torch)
        phase = "build"
        phase_build()
        phase = "sass"
        phase_sass()
        phase = "kernels"
        timing = phase_kernels(torch, args.seed)
        phase = "roofline"
        timing.update(phase_roofline(torch, args.seed))
        phase = "trainer"
        trainer = phase_trainer(torch, args.seed)
        phase = "trainer_wide"
        wide = phase_trainer(torch, args.seed, D=WIDE_D, B=WIDE_B, test_rows=WIDE_TEST,
                             phase="trainer_wide")
        time_two_launch(torch, args.seed, timing)
        for family in ("sparse_lr", "sparse_softmax", "blocked_lr", "softmax"):
            phase = f"trainer_{family}"
            phase_family(torch, args.seed, family)
        phase = "step_softmax_wide"
        time_softmax_wide(torch, args.seed)
        phase = "cli"
        phase_cli()
        phase = "roofline_experiments"
        launches = {**trainer["launches"], **phase_roofline_experiments(torch, env["nvidia_smi"])}
        for name in ("fused_lr_grad_two_launch", "lr_logits_row_blocks"):
            launches[name] = wide["launches"][name]
    except Exception as e:  # report which phase failed, then fail the run
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        raise
    replaces = {**FUSED_REPLACES, **ROOFLINE_REPLACES}
    kernels = []
    for fn in ops.KERNEL_WRAPPERS:
        name = fn.__name__
        t = timing[name]
        entry = {
            "name": name, "route": "cuda",
            "source": ROOFLINE_SOURCE if name in ROOFLINE_REPLACES else FUSED_SOURCE,
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "worst_rel_err": t["rel_err"],
        }
        for extra in ("library_note", "two_pass_ms", "row_blocks_ms", "plan", "shape",
                      "at_8_rows", "at_512_rows"):
            if extra in t:
                entry[extra] = t[extra]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                             "count": env["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
