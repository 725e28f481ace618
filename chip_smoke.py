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
6,000,000, where the two-launch kernels take over), then the
``gen-data -> sync -> eval`` CLI in a subprocess, and last the path of the
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
            ("ctas", "ctas_per_sm", "slice_cols", "rows", "stages", "smem_bytes", "single_pass")}


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

    # above the single pass's shared-memory bound: the two-launch kernels
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
            raise AssertionError(f"above the bound the calls did not take the two-launch path: {moved}")
        eg = rel_err(g, ops.fused_lr_grad_reference(w, X, y, mask, compute_dtype=cd))
        ez = rel_err(z, ops.lr_logits_reference(w, X, compute_dtype=cd))
        emit("kernel_check", B=B, D=D, x_dtype="torch.bfloat16", compute_dtype=cd,
             path="two_launch", grad_rel_err=eg, logits_rel_err=ez)
        if not (eg <= REL_TOL and ez <= REL_TOL):
            raise AssertionError(f"two-launch kernels disagree with the plain version above the bound ({cd})")
        worst["fused_lr_grad_two_launch"] = max(worst["fused_lr_grad_two_launch"], eg)
        worst["lr_logits_row_blocks"] = max(worst["lr_logits_row_blocks"], ez)
    del X, w, y, mask

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
    if not all(same.values()):
        raise AssertionError(f"a slice kernel gave other bits on a second call: {same}")

    # timings at the main path's shape and types: the redesigned kernel
    # between two runs of the two-launch one (old, new, new, old)
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
        two_read_floor_ms=1e3 * (2 * B * D * X.element_size()) / HBM_BYTES_PER_S,
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
    """The two-launch kernels at the above-bound trainer's shape, (64, 6M)
    bf16: the shape their path gives them."""
    from distlr_tpu_torch import ops  # noqa: PLC0415

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    B, D = WIDE_B, WIDE_D
    w, X, y, mask = _inputs(torch, gen, B, D, torch.bfloat16)
    reps = 25
    wb = w.to(torch.bfloat16)
    g_ref = ops.fused_lr_grad_reference(w, X, y, mask)
    z_ref = ops.lr_logits_reference(w, X)
    bound_ms, bound_by = _grad_bound(B, D, X.element_size())
    results["fused_lr_grad_two_launch"].update(
        shape=[B, D], max_abs_err=float((ops.fused_lr_grad_two_launch(w, X, y, mask) - g_ref).abs().max()),
        ms=time_ms(lambda: ops.fused_lr_grad_two_launch(w, X, y, mask), reps),
        plain_ms=time_ms(lambda: ops.fused_lr_grad_reference(w, X, y, mask), reps),
        library_ms=time_ms(_library_grad(torch, w, X, y, mask), reps),
        bound_ms=bound_ms, bound_by=bound_by)
    bound_ms, bound_by = _logits_bound(B, D, X.element_size())
    results["lr_logits_row_blocks"].update(
        shape=[B, D], max_abs_err=float((ops.lr_logits_row_blocks(w, X) - z_ref).abs().max()),
        ms=time_ms(lambda: ops.lr_logits_row_blocks(w, X), reps),
        plain_ms=time_ms(lambda: ops.lr_logits_reference(w, X), reps),
        library_ms=time_ms(lambda: torch.mv(X, wb), reps),
        bound_ms=bound_ms, bound_by=bound_by)
    for name in ("fused_lr_grad_two_launch", "lr_logits_row_blocks"):
        emit("kernel_timing", kernel=name, B=B, D=D, x_dtype="bfloat16", reps=reps,
             **results[name])
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
    full width the slice kernels run; above their bound the two-launch
    kernels."""
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


def phase_cli() -> None:
    """gen-data -> sync -> eval through ``python -m distlr_tpu_torch.launch``."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))

    def run(*argv):
        proc = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", *argv],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"launch {argv[0]} exited {proc.returncode}:\n{proc.stderr[-2000:]}")
        return proc.stdout

    with tempfile.TemporaryDirectory(prefix="distlr-smoke-cli-") as tmp:
        d = os.path.join(tmp, "d")
        common = ["--data-dir", d, "--num-feature-dim", "123"]
        run("gen-data", *common, "--num-samples", "2000", "--num-parts", "2")
        out = run("sync", *common, "--num-workers", "2", "--num-iteration", "30",
                  "--test-interval", "10", "--learning-rate", "0.5", "--l2-c", "0")
        lines = re.findall(r"^\d\d:\d\d:\d\d Iteration (\d+), accuracy: (\S+)$", out, re.M)
        if [int(n) for n, _ in lines] != [10, 20, 30]:
            raise AssertionError(f"unexpected eval lines from sync:\n{out}")
        model_file = os.path.join(d, "models", "part-001")
        with open(model_file) as f:
            if f.readline().strip() != "123" or len(f.readline().split()) != 123:
                raise AssertionError("sync wrote a malformed model file")
        ev = run("eval", *common, "--model-file", model_file)
        m = re.search(r"accuracy: (\S+)\s+test_logloss: (\S+)", ev)
        if m is None:
            raise AssertionError(f"unexpected eval output: {ev}")
        emit("cli", sync_accuracy=[float(a) for _, a in lines],
             eval_accuracy=float(m.group(1)), eval_logloss=float(m.group(2)))


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
    for bt, dt, reps in ((64, 1024, 8), published):
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
# count of them inside one loop of its SASS, what that shows)
SASS_FACTS = {
    "gen_kernel": (("IMAD.WIDE", "IMAD.HI"), 17,
                   "every product of a Philox block that depends on t, each pass of t"),
    "const_partial_kernel": (("FFMA",), 16, "the 16 FMAs of the held tile stay in the REPS loop"),
    "mxu_partial_kernel": (("HMMA",), 1, "tensor-core products in the REPS loop"),
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
    """What the probe kernels compiled to: tensor-core products in mxu, the
    FMAs inside const's REPS loop, a whole Philox block in gen's loop."""
    from distlr_tpu_torch.ops import build  # noqa: PLC0415

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(build.library_path("gen_roofline"))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    loops = _sass_loops(text)
    facts = {}
    for fn, (prefixes, least, what) in SASS_FACTS.items():
        names = [n for n in loops if fn in n]
        counts = [sum(c for op, c in loop.items() if op.startswith(prefixes))
                  for n in names for loop in loops[n]]
        best = max(counts, default=0)
        facts[fn] = {"most_in_one_loop": best, "opcodes": prefixes, "shows": what}
        if best < least:
            raise AssertionError(f"SASS of {fn}: {best} of {prefixes} in its loops, "
                                 f"expected >= {least} ({what}); functions {names}")
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
        for extra in ("library_note", "two_pass_ms", "row_blocks_ms", "plan", "shape"):
            if extra in t:
                entry[extra] = t[extra]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                             "count": env["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
