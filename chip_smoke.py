#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``distlr_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py [--seed 0]

It builds the port's CUDA kernels from the sources in the checkout,
holds each against its plain PyTorch version on the card, drives the
port's main path — the sync dense-LR trainer at the repo's full width
(D = 1,000,000 features, 2048 rows a step, bfloat16 features, then the
same rows stored as int8 and as int8_dot, and the same bf16 rows on the
feature-sharded path, 2 row blocks x 4 column blocks of ``lr_logits`` and
``lr_backward`` a step, held to the unsharded run) — through
``Trainer.load_data / fit / evaluate_metrics / save_model``, then the
feature-sharded step at 256 rows (int8, int8_dot, the ring step, and a
column block of unaligned 24-byte rows), then the same
trainer at a width above the single-pass kernel's shared-memory bound (D =
6,000,000, where the two-read path takes over: the streaming forward in
several waves, a residual epilogue, the backward; bfloat16 and int8
features), then the four other
model families through ``Trainer.fit`` at the repo's published shapes
(``sparse_lr``, ``sparse_softmax`` and ``blocked_lr`` at the Avazu-style
D = 1M buckets, 21 fields, 65,536 rows a step; ``softmax`` at the
MNIST-shaped D = 784, K = 10, 60,000 rows, and its step alone at D = 1M,
2048 rows), then the ``gen-data -> sync -> eval`` CLI in subprocesses for
every family, an int8_dot sync that checkpoints and resumes,
``gen-data -> ps -> eval``, ``gen-data -> sync -> serve`` (a text model,
then a checkpoint directory), ``sync`` and ``eval --feature-shards 4``,
``sync`` as a one-rank NCCL group, ``serve`` x2 -> ``route`` ->
``rollout`` and ``ps-server`` -> ``online`` -> ``serve --feedback-spool``,
then the parameter-server path at the full
width through ``run_ps_local`` (native libsvm shards of config-3 CTR rows
at D = 1M, 2 native KV servers, 2 worker threads on the card: sync BSP
and async Hogwild, each gradient the ``fused_lr_grad`` single pass; then
the path's kernels checked and timed at the shapes those runs gave
them), then the scoring tier at the full width (``ScoringEngine`` behind
an in-process ``ScoringServer``: dense binary_lr at D = 1M on the
``lr_logits`` kernels, concurrent clients and JSON batches over TCP, int8,
int8_dot and D = 6M engines, checkpoint and live-PS hot reload, idle
eviction; then the kernels at the serving buckets), then the keyed
parameter-server path (``sparse_lr``, ``sparse_softmax`` and ``blocked_lr``
at config 4's D = 1M buckets and 21 fields through ``run_ps_local``, sync
and async, 2 servers and 2 worker threads on the card, each keyed gradient
a gather and an ``index_add_`` there, held to the numpy backend) and
hot-row serving (a ``blocked_lr`` engine refreshed from a live PS through
a ``HotSetTracker``'s keyed pulls while an async keyed worker pushes) and
the PS update rules and gradient wire at D = 1M (sync FTRL, int8 and
signSGD pushes and async accumulation through ``run_ps_local``, each held
to its oracle on the ``fused_lr_grad`` kernel's own gradients; keyed
FTRL; ``launch ps-server --namespaces v1:ftrl,v2`` with ``launch serve``
and ``launch ps --hosts`` against it) and PS fault recovery at D = 1M
(a sync crash after a checkpoint resumed against the surviving group and
held to an uninterrupted run, an async worker restart, a server SIGKILLed
under the ``ServerSupervisor`` and re-seeded from its snapshot, and
``launch ps`` with the recovery flags) and the durable store at D = 1M
(the WAL's recovery of every acknowledged push after a SIGKILL of the
group, snapshot-only recovery within an interval, a whole-group power
loss by a chaos ``kill`` fault under ``run_ps_local``, ``launch ps-server
--store-dir`` with ``launch ps-ctl``, and ``launch chaos`` throttling the
links of f32, int8 and signSGD pushes) and live membership resizing at D =
1M (a 2 -> 4 -> 2 reshard with the bits at rest kept, an FTRL reshard on
the card's gradients equal to a static group's, the JAX package's "double
then halve under chaos" with a Hogwild pusher on the card, an online
trainer and a served engine following the coordinator, and ``launch
ps-server --elastic`` with ``serve`` / ``online --ps-ctl`` and ``launch
ps-ctl resize``), then
the serving control plane (a ``ScoringRouter`` in front of two
``ScoringServer`` replicas, each hosting the binary_lr versions v1 and v2
at D = 1M: one reloads both from two namespaces of one PS group, the other
serves text models; mixed traffic, a tenant quota, SPLIT, SHADOW, a replica
killed and restarted under load, canary ramps that roll back and promote,
and a keyed push into one namespace), then the closed online-learning
loop at D = 1M (``ID`` requests and their ``LABEL`` lines through a
``ScoringRouter`` to a ``ScoringServer`` with a ``FeedbackSink``, ``python
-m distlr_tpu_torch.launch online`` training an async FTRL group the
server hot-reloads from; the probes separate from cold, follow a label
flip, the drift alert fires and clears, and the joined shards replay to a
numpy oracle), and last the path of the on-device generation probes: both roofline experiments
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
import threading
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
INT8_SOURCE = "distlr_tpu_torch/ops/csrc/fused_lr_int8.cu"
# wrapper -> the Pallas kernel it replaces
FUSED_REPLACES = {
    "fused_lr_grad": "distlr_tpu/ops/pallas_lr.py:86",
    "lr_logits": "distlr_tpu/ops/pallas_lr.py:75",
    "fused_lr_grad_two_launch": "distlr_tpu/ops/pallas_lr.py:86",
    "lr_logits_row_blocks": "distlr_tpu/ops/pallas_lr.py:75",
}
# the int8 instances of the same kernels (K1-K3; the same wrappers launch
# them for an int8 X and count them apart) and the int8_dot pair (K4)
INT8_REPLACES = {
    "fused_lr_grad_int8": "distlr_tpu/ops/pallas_lr.py:86",
    "lr_logits_int8": "distlr_tpu/ops/pallas_lr.py:75",
    "fused_lr_grad_two_launch_int8": "distlr_tpu/ops/pallas_lr.py:86",
    "lr_logits_row_blocks_int8": "distlr_tpu/ops/pallas_lr.py:75",
    "lr_logits_int8dot": "distlr_tpu/ops/pallas_lr.py:75",
    "lr_backward_int8dot": "distlr_tpu/ops/pallas_lr.py:86",
}
# the backward launch of row 1's two-read path under its own wrapper, the
# feature-sharded step's gradient of each column block, and
# its int8 instance
BACKWARD_REPLACES = {"lr_backward": "distlr_tpu/ops/pallas_lr.py:86"}
BACKWARD_INT8_REPLACES = {"lr_backward_int8": "distlr_tpu/ops/pallas_lr.py:86"}
BACKWARD_NOTE = ("the backward half of row 1 (rᵀX) alone; the JAX feature-sharded step runs "
                 "an XLA dot there (distlr_tpu/parallel/feature_parallel.py:85-106)")
# the feature-sharded step at the main path's width: 2 row blocks x 4
# column blocks (D / 4 = 250,000 columns a block)
SHARDED_MESH = {"data": 2, "model": 4}
SHARDED_SMALL_B = 256
# a column block whose rows break 16-byte alignment: 12 bf16 columns
UNALIGNED_D, UNALIGNED_B = 24, 64
INT8_NOTE = ("int8_dot instance of row 1: the JAX model contracts int8 x int8 with XLA dots "
             "here (distlr_tpu/models/linear.py:184-187, :211-218)")
# an int8 X's dequantization scale in the kernel checks (z = s * X.w ~ 1)
INT8_SCALE = 3.0 / 127.0


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
    """Every kernel source, one nvcc each, started together."""
    from distlr_tpu_torch.ops import build, fused_lr, gen_roofline  # noqa: PLC0415

    t0 = time.perf_counter()
    names = ("fused_lr_grad", "fused_lr_int8", "gen_roofline")
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(build.build, names))
    fused_lr._lib()
    fused_lr._int8_lib()
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
            ("ctas", "ctas_per_sm", "waves", "slice_cols", "rows", "stages", "compute_warps",
             "groups_per_thread", "smem_bytes", "single_pass")}


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


def _int8_inputs(torch, gen, B, D, masked_tail=0):
    """An int8 X of uniform values in [-127, 127], w ~ N(0, 1/D), labels
    and a mask with ``masked_tail`` padded rows."""
    X = torch.randint(-127, 128, (B, D), device="cuda", generator=gen, dtype=torch.int8)
    w = torch.randn(D, device="cuda", generator=gen) / math.sqrt(D)
    y = (torch.rand(B, device="cuda", generator=gen) < 0.5).to(torch.int32)
    mask = torch.ones(B, device="cuda")
    if masked_tail:
        mask[-masked_tail:] = 0
    return w, X, y, mask


def _int8_check(torch, ops, fused_lr, gen, B, D, tail, cd) -> dict:
    """K1-K4 at (B, D) against their plain versions, with the launches each
    call counted; the int8_dot backward is given the forward's residuals
    (the plain version quantizes the same r)."""
    s = INT8_SCALE
    w, X, y, mask = _int8_inputs(torch, gen, B, D, tail)
    single = fused_lr.launch_plan_for(X, cd).single_pass
    single_logits = fused_lr.launch_plan_for(X, cd, "logits").single_pass
    before = _launches(ops)
    kw = dict(compute_dtype=cd, feature_scale=s)
    g1, z1 = ops.fused_lr_grad(w, X, y, mask, with_logits=True, **kw)
    z2 = ops.lr_logits(w, X, **kw)
    g3 = ops.fused_lr_grad_two_launch(w, X, y, mask, **kw)
    z3 = ops.lr_logits_row_blocks(w, X, **kw)
    z4, r4 = ops.lr_logits_int8dot(w, X, y, mask, feature_scale=s)
    g4 = ops.lr_backward_int8dot(X, r4, feature_scale=s)
    torch.cuda.synchronize()
    after = _launches(ops)
    moved = {k: after[k] - before[k] for k in INT8_REPLACES}
    want = {"fused_lr_grad_int8": int(single), "lr_logits_int8": int(single_logits),
            "fused_lr_grad_two_launch_int8": 1 + (not single),
            "lr_logits_row_blocks_int8": 1 + (not single_logits), "lr_logits_int8dot": 1,
            "lr_backward_int8dot": 1}
    if moved != want or any(after[k] != before[k] for k in FUSED_REPLACES):
        raise AssertionError(f"int8 wrappers did not count their launches at {(B, D)}: {moved}")
    g_ref = ops.fused_lr_grad_reference(w, X, y, mask, compute_dtype=cd, feature_scale=s)
    z_ref = ops.lr_logits_reference(w, X, compute_dtype=cd, feature_scale=s)
    pairs = {"fused_lr_grad_int8": (g1, g_ref), "lr_logits_int8": (z2, z_ref),
             "fused_lr_grad_two_launch_int8": (g3, g_ref),
             "lr_logits_row_blocks_int8": (z3, z_ref),
             "lr_logits_int8dot": (z4, ops.lr_logits_int8dot_reference(w, X, feature_scale=s)),
             "lr_backward_int8dot": (g4, ops.lr_backward_int8dot_reference(X, r4,
                                                                          feature_scale=s))}
    rel = {k: rel_err(a, b) for k, (a, b) in pairs.items()}
    rel["with_logits"] = rel_err(z1, z_ref)
    out = {"B": B, "D": D, "masked_tail": tail, "compute_dtype": cd, "single_pass": single,
           "rel_err": rel, "max_abs_err": {k: float((a - b).abs().max())
                                           for k, (a, b) in pairs.items()}}
    emit("kernel_check", x_dtype="torch.int8", feature_scale=s, **out)
    if not max(rel.values()) <= REL_TOL:
        raise AssertionError(f"an int8 kernel disagrees with its plain version at "
                             f"{(B, D, cd)}: {rel}")
    return out


def _int8_wrap_checks(torch, ops) -> dict:
    """The int8_dot pair where one int32 sum would wrap, against the closed
    form: the backward over 140,000 rows of 4,096 all-127 columns with
    every residual 1 (rq all 127: 127^2 * 140,000 = 2.26e9 > 2^31), and the
    forward at (8, 1M) all 127 with w all 1 (127^2 * 1M)."""
    from distlr_tpu_torch.ops.int8 import sym_scale  # noqa: PLC0415

    one = torch.ones((), device="cuda")
    s_unit = float(sym_scale(one))  # the grid step of max |v| = 1
    out = {}
    X = torch.full((140_000, 4096), 127, dtype=torch.int8, device="cuda")
    r = torch.ones(140_000, device="cuda")
    g = ops.lr_backward_int8dot(X, r)
    closed = 127.0 * 127.0 * 140_000 * s_unit
    out["backward_140000x4096"] = {
        "rel_err_vs_closed_form": float((g.double() - closed).abs().max() / closed),
        "rel_err_vs_plain": rel_err(g, ops.lr_backward_int8dot_reference(X, r)),
        "int32_would_wrap": 127 * 127 * 140_000 > 2**31 - 1}
    del X, g
    X = torch.full((8, FULL_D), 127, dtype=torch.int8, device="cuda")
    z = ops.lr_logits_int8dot(torch.ones(FULL_D, device="cuda"), X)
    closed = 127.0 * 127.0 * FULL_D * s_unit
    out["forward_8x1M"] = {
        "rel_err_vs_closed_form": float((z.double() - closed).abs().max() / closed),
        "rel_err_vs_plain": rel_err(z, ops.lr_logits_int8dot_reference(
            torch.ones(FULL_D, device="cuda"), X)),
        "int32_would_wrap": 127 * 127 * FULL_D > 2**31 - 1}
    del X, z
    emit("kernel_check", case="int8_dot_wrap", **out)
    if max(max(v["rel_err_vs_closed_form"], v["rel_err_vs_plain"]) for v in out.values()) > 1e-6:
        raise AssertionError(f"an int8_dot kernel wrapped or drifted: {out}")
    return out


def _int8_mm_check(torch) -> None:
    """The int8 GEMM under the plain int8_dot versions (``torch._int_mm``
    padded to its shape rules) against f64 products, which are exact for
    these integer sums."""
    from distlr_tpu_torch.ops.int8 import int8_mm  # noqa: PLC0415

    gen = torch.Generator(device="cuda").manual_seed(5)
    exact = {}
    for m, k, n in ((1, 2048, 1000), (37, 1003, 10), (2048, 125_000, 1)):
        a = torch.randint(-127, 128, (m, k), device="cuda", generator=gen, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), device="cuda", generator=gen, dtype=torch.int8)
        got = int8_mm(a, b)
        exact[f"{m}x{k}x{n}"] = bool(got.dtype == torch.int32 and torch.equal(
            got.double(), a.double() @ b.double()))
    emit("kernel_check", case="int8_mm", exact=exact)
    if not all(exact.values()):
        raise AssertionError(f"torch._int_mm under the plain int8 versions is not exact: {exact}")


def phase_int8_kernels(torch, seed: int) -> dict:
    """K1-K4 against their plain versions at the main path's shape with
    both product types, the two-read instances at (64, 6M), an odd shape
    with a masked tail and small ones, the wrap checks, the same bits on a
    second call; then each one's times at the shape its path gives it."""
    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.ops import fused_lr  # noqa: PLC0415
    from distlr_tpu_torch.ops.int8 import quantize_sym  # noqa: PLC0415

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    results = {k: {"rel_err": 0.0} for k in INT8_REPLACES}
    cases = [(64, 256, 10), (5, 13, 1), (1, 333, 0), (37, 1_000_003, 5),
             (FULL_B, FULL_D, 48), (WIDE_B, WIDE_D, 6)]
    for B, D, tail in cases:
        for cd in ("bfloat16", "float32"):
            chk = _int8_check(torch, ops, fused_lr, gen, B, D, tail, cd)
            for k, v in chk["rel_err"].items():
                if k in results:
                    results[k]["rel_err"] = max(results[k]["rel_err"], v)
            if (B, D, cd) == (FULL_B, FULL_D, "bfloat16"):
                for k in ("fused_lr_grad_int8", "lr_logits_int8", "lr_logits_int8dot",
                          "lr_backward_int8dot"):
                    results[k]["max_abs_err"] = chk["max_abs_err"][k]
            if (B, D, cd) == (WIDE_B, WIDE_D, "bfloat16"):
                for k in ("fused_lr_grad_two_launch_int8", "lr_logits_row_blocks_int8"):
                    results[k]["max_abs_err"] = chk["max_abs_err"][k]
            torch.cuda.empty_cache()
    wrap = _int8_wrap_checks(torch, ops)
    _int8_mm_check(torch)

    s, reps = INT8_SCALE, 25
    B, D = FULL_B, FULL_D
    w, X, y, mask = _int8_inputs(torch, gen, B, D, 48)
    same = {
        "fused_lr_grad_int8": bool(torch.equal(
            ops.fused_lr_grad(w, X, y, mask, feature_scale=s),
            ops.fused_lr_grad(w, X, y, mask, feature_scale=s))),
        "lr_logits_int8": bool(torch.equal(ops.lr_logits(w, X, feature_scale=s),
                                           ops.lr_logits(w, X, feature_scale=s))),
        "fused_lr_grad_int8dot": bool(torch.equal(
            ops.fused_lr_grad_int8dot(w, X, y, mask, feature_scale=s),
            ops.fused_lr_grad_int8dot(w, X, y, mask, feature_scale=s)))}
    emit("kernel_check", B=B, D=D, x_dtype="torch.int8", case="deterministic", same_bits=same)
    if not all(same.values()):
        raise AssertionError(f"an int8 kernel gave other bits on a second call: {same}")

    wb, yf = w.to(torch.bfloat16), y.to(torch.float32)
    wq = quantize_sym(w, torch.amax(w.abs()))[0]
    z, r = ops.lr_logits_int8dot(w, X, y, mask, feature_scale=s)
    rq = quantize_sym(r, torch.amax(r.abs()))[0]
    # column-major, the layout cuBLASLt's int8 GEMM takes for its second operand
    wq8 = torch.zeros(8, D, dtype=torch.int8, device="cuda")
    wq8[0] = wq
    wq8 = wq8.t()
    rq24 = torch.zeros(24, B, dtype=torch.int8, device="cuda")
    rq24[0] = rq

    def convert_grad():
        Xb = X.to(torch.bfloat16)
        res = (torch.sigmoid(torch.mv(Xb, wb).float() * s) - yf) * mask
        return torch.mv(Xb.t(), res.to(torch.bfloat16)) * s

    composite = ("no single call reads int8 X into float products: the composite "
                 "X.to(bf16) + mv + sigmoid + mv of X^T")
    grad_bound, grad_by = _grad_bound(B, D, 1)
    logits_bound, logits_by = _logits_bound(B, D, 1)
    t_bwd = (B * D + B * 4 + D * 4) / HBM_BYTES_PER_S
    timing = {
        "fused_lr_grad_int8": dict(
            ms=time_ms(lambda: ops.fused_lr_grad(w, X, y, mask, feature_scale=s), reps),
            plain_ms=time_ms(lambda: ops.fused_lr_grad_reference(w, X, y, mask,
                                                                 feature_scale=s), reps),
            library_ms=time_ms(convert_grad, reps), library_note=composite,
            bound_ms=grad_bound, bound_by=grad_by,
            plan=_plan_fields(fused_lr.launch_plan_for(X))),
        "lr_logits_int8": dict(
            ms=time_ms(lambda: ops.lr_logits(w, X, feature_scale=s), reps),
            plain_ms=time_ms(lambda: ops.lr_logits_reference(w, X, feature_scale=s), reps),
            library_ms=time_ms(lambda: torch.mv(X.to(torch.bfloat16), wb) * s, reps),
            library_note="no single call: the composite X.to(bf16) + mv",
            bound_ms=logits_bound, bound_by=logits_by,
            plan=_plan_fields(fused_lr.launch_plan_for(X, kernel="logits"))),
        "lr_logits_int8dot": dict(
            ms=time_ms(lambda: ops.lr_logits_int8dot(w, X, feature_scale=s), reps),
            plain_ms=time_ms(lambda: ops.lr_logits_int8dot_reference(w, X, feature_scale=s),
                             reps),
            library_ms=time_ms(lambda: torch._int_mm(X, wq8), reps),
            library_note="torch._int_mm(X, wq) with wq padded to 8 columns, column-major "
                         "(no wrap guard)",
            bound_ms=logits_bound, bound_by=logits_by,
            plan=_plan_fields(fused_lr.int8dot_plan_for(X))),
        "lr_backward_int8dot": dict(
            ms=time_ms(lambda: ops.lr_backward_int8dot(X, r, feature_scale=s), reps),
            plain_ms=time_ms(lambda: ops.lr_backward_int8dot_reference(X, r, feature_scale=s),
                             reps),
            library_ms=time_ms(lambda: torch._int_mm(rq24, X), reps),
            library_note="torch._int_mm(rq, X) with rq padded to 24 rows (no wrap guard)",
            bound_ms=1e3 * t_bwd, bound_by="bytes"),
    }
    timing["lr_backward_int8dot"]["pair_ms"] = time_ms(
        lambda: ops.fused_lr_grad_int8dot(w, X, y, mask, feature_scale=s), reps)
    timing["lr_backward_int8dot"]["pair_bound_ms"] = 1e3 * (2 * B * D) / HBM_BYTES_PER_S
    for name, t in timing.items():
        results[name].update(t)
        emit("kernel_timing", kernel=name, B=B, D=D, x_dtype="int8", reps=reps, **results[name])
    del X, w, y, mask, z, r, rq, wq8, rq24
    torch.cuda.empty_cache()

    # the two-read path's int8 instances at the shape its trainer gives them,
    # and the gradient's backward alone on the forward's residuals
    B, D = WIDE_B, WIDE_D
    w, X, y, mask = _int8_inputs(torch, gen, B, D)
    wb, yf = w.to(torch.bfloat16), y.to(torch.float32)
    bound_ms, bound_by = _grad_bound(B, D, 1)
    wide = fused_lr.wide_plan_for(X)
    plan = _plan_fields(wide)
    lib = fused_lr._int8_lib()
    r = fused_lr.run_streaming(lib, wide, w, X, "bfloat16", y, mask, feature_scale=s)[1]
    same_wide = {
        "fused_lr_grad_two_launch_int8": bool(torch.equal(
            ops.fused_lr_grad_two_launch(w, X, y, mask, feature_scale=s),
            ops.fused_lr_grad_two_launch(w, X, y, mask, feature_scale=s))),
        "lr_backward": bool(torch.equal(fused_lr.run_backward(lib, X, r, "bfloat16", s),
                                        fused_lr.run_backward(lib, X, r, "bfloat16", s)))}
    emit("kernel_check", B=B, D=D, x_dtype="torch.int8", case="deterministic",
         same_bits=same_wide)
    if not all(same_wide.values()):
        raise AssertionError(f"an int8 two-read kernel gave other bits on a second call: "
                             f"{same_wide}")
    results["fused_lr_grad_two_launch_int8"].update(
        backward_ms=time_ms(lambda: fused_lr.run_backward(lib, X, r, "bfloat16", s), reps),
        backward_bound_ms=1e3 * (B * D + B * 4 + D * 4) / HBM_BYTES_PER_S,
        backward_grid=fused_lr.int8_backward_grid(X))
    results["fused_lr_grad_two_launch_int8"].update(
        ms=time_ms(lambda: ops.fused_lr_grad_two_launch(w, X, y, mask, feature_scale=s),
                   reps),
        plain_ms=time_ms(lambda: ops.fused_lr_grad_reference(w, X, y, mask, feature_scale=s),
                         reps),
        library_ms=time_ms(convert_grad, reps), library_note=composite,
        bound_ms=bound_ms, bound_by=bound_by, shape=[B, D],
        two_read_floor_ms=_two_read_floor_ms(B, D, 1), plan=plan)
    bound_ms, bound_by = _logits_bound(B, D, 1)
    results["lr_logits_row_blocks_int8"].update(
        ms=time_ms(lambda: ops.lr_logits_row_blocks(w, X, feature_scale=s), reps),
        plain_ms=time_ms(lambda: ops.lr_logits_reference(w, X, feature_scale=s), reps),
        library_ms=time_ms(lambda: torch.mv(X.to(torch.bfloat16), wb) * s, reps),
        library_note="no single call: the composite X.to(bf16) + mv",
        bound_ms=bound_ms, bound_by=bound_by, shape=[B, D], plan=plan)
    for name in ("fused_lr_grad_two_launch_int8", "lr_logits_row_blocks_int8"):
        emit("kernel_timing", kernel=name, B=B, D=D, x_dtype="int8", reps=reps,
             **results[name])
    results["lr_logits_int8dot"]["wrap"] = wrap["forward_8x1M"]
    results["lr_backward_int8dot"]["wrap"] = wrap["backward_140000x4096"]
    del X, w, y, mask
    torch.cuda.empty_cache()
    return results


def _ctr_cols(rng, n: int, w_true, D: int):
    """``n`` rows in the config-3 CTR style as their (n, CTR_FIELDS)
    ascending one-hot columns and labels: each field one-hot into its own
    hashed bucket range (Zipf-skewed, so head buckets recur), labels
    drawn from the planted ``w_true``."""
    import numpy as np  # noqa: PLC0415

    per_field = D // CTR_FIELDS
    buckets = np.minimum(rng.zipf(1.3, size=(n, CTR_FIELDS)) - 1, per_field - 1)
    cols = buckets + np.arange(CTR_FIELDS) * per_field
    z = w_true[cols].sum(axis=1)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(np.int32)
    return cols, y


def _ctr_rows(rng, n: int, w_true, D: int):
    """:func:`_ctr_cols`'s rows as a dense (n, D) f32 matrix."""
    import numpy as np  # noqa: PLC0415

    cols, y = _ctr_cols(rng, n, w_true, D)
    X = np.zeros((n, D), dtype=np.float32)
    X[np.arange(n)[:, None], cols] = 1.0
    return X, y


def trainer_rows(seed: int, D: int, B: int, test_rows: int):
    """(train shard, test shard, seconds) of CTR-style f32 rows at width D,
    made once and shared by the trainer phases of that width (each copies
    them into its own datasets, which its trainer then quantizes)."""
    import numpy as np  # noqa: PLC0415

    rng = np.random.default_rng(seed)
    w_true = (rng.standard_normal(D) * 0.5).astype(np.float32)
    t0 = time.perf_counter()
    train = _ctr_rows(rng, B, w_true, D)
    test = _ctr_rows(rng, test_rows, w_true, D)
    return train, test, time.perf_counter() - t0


# feature dtype -> (gradient wrapper, logits wrapper) of the path at and
# below the single pass's bound, then above it
TRAINER_WRAPPERS = {
    "bfloat16": (("fused_lr_grad", "lr_logits"),
                 ("fused_lr_grad_two_launch", "lr_logits_row_blocks")),
    "int8": (("fused_lr_grad_int8", "lr_logits_int8"),
             ("fused_lr_grad_two_launch_int8", "lr_logits_row_blocks_int8")),
    "int8_dot": (("lr_backward_int8dot", "lr_logits_int8dot"),) * 2,
}


def phase_trainer(torch, rows, *, feature_dtype: str = "bfloat16",
                  phase: str = "trainer") -> dict:
    """The main path on ``rows`` (:func:`trainer_rows`): load_data (which
    quantizes int8 features) -> fit -> evaluate -> save, with the launch
    counts zeroed just before fit and read just after.  At the full width
    the slice kernels run (their int8 instances for int8 features; the
    int8_dot pair for int8_dot); above their bound the two-read path's
    wrappers.  The weights are then held against the plain recurrence."""
    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.train import GlobalShardedData, Trainer  # noqa: PLC0415

    steps = 3
    train_rows, test_rows, data_s = rows
    B, D = train_rows[0].shape
    train = GlobalShardedData([train_rows])
    test = GlobalShardedData([test_rows])
    x_dtype = torch.bfloat16 if feature_dtype == "bfloat16" else torch.int8
    single = ops.fused_lr_supported(
        B, D, x_dtype=x_dtype, num_sms=torch.cuda.get_device_properties(0).multi_processor_count)
    grad_fn, logits_fn = TRAINER_WRAPPERS[feature_dtype][0 if single else 1]

    with tempfile.TemporaryDirectory(prefix="distlr-smoke-") as tmp:
        cfg = Config(num_feature_dim=D, feature_dtype=feature_dtype,
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
    # int8_dot's forward runs in each step and each of the steps + 1 evals
    logits_ok = (launches[logits_fn] == 2 * steps + 1 if feature_dtype == "int8_dot"
                 else launches[logits_fn] >= 1)
    if launches[grad_fn] != steps or not logits_ok or any(others.values()):
        raise AssertionError(f"the path did not run {grad_fn} once a step and {logits_fn}: {launches}")
    loss = trainer.metrics.latest("loss")
    if not (math.isfinite(loss) and math.isfinite(metrics["logloss"])):
        raise AssertionError(f"non-finite loss {loss} / logloss {metrics['logloss']}")
    if not saved_ok:
        raise AssertionError("the saved text model is malformed")

    # the same steps as the plain recurrence on the card
    X, y, mask = trainer._put(train.full_batch())
    scale = trainer.model.feature_scale

    def plain_grad(w):
        if feature_dtype == "int8_dot":
            return ops.fused_lr_grad_int8dot_reference(w, X, y, mask, feature_scale=scale)
        return ops.fused_lr_grad_reference(w, X, y, mask, compute_dtype="bfloat16",
                                           feature_scale=scale)

    w = w0
    n = mask.sum().clamp_min(1.0)
    for _ in range(steps):
        w = w - cfg.learning_rate * (plain_grad(w) / n + cfg.l2_c * w)
    w_rel = rel_err(trainer.weights, w)
    if w_rel > REL_TOL:
        raise AssertionError(f"trained weights differ from the plain recurrence: rel {w_rel}")
    # the step's device time on a resident batch, apart from the trainer's
    # step_ms, which also waits for the batch's host->device copy
    w_tmp = trainer.weights.clone()
    step_device_ms = time_ms(lambda: trainer.train_step(w_tmp, (X, y, mask)), 10)
    # its kernels from the profiler: the share of the step the card is busy
    trace = _step_kernels(torch, lambda: trainer.train_step(w_tmp, (X, y, mask)))
    del X

    out = {
        "D": D, "B": B, "test_rows": test_rows[0].shape[0], "steps": steps,
        "feature_dtype": feature_dtype, "feature_scale": scale,
        "kernels": [grad_fn, logits_fn],
        "launches": launches, "loss": loss, "test_accuracy": metrics["accuracy"],
        "test_logloss": metrics["logloss"], "step_ms": 1e3 * trainer.timer.sec_per_step,
        "step_device_ms": step_device_ms, **trace,
        "device_busy_share": trace["kernel_us_per_step"] / (1e3 * step_device_ms),
        "weights_rel_err_vs_plain": w_rel, "data_build_s": data_s, "load_s": load_s,
        "fit_eval_save_s": fit_s,
        "host_peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "device_peak_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(phase, **out)
    # the unsharded path's result, which the feature-sharded phase is held to
    out["final_weights"] = trainer.weights.cpu()
    del trainer, train, test
    torch.cuda.empty_cache()
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


# --- the feature-sharded step ----------------------------------------------
def _backward_bound(B: int, D: int, x_bytes: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of ``rᵀX``: X, r in and g out once; a
    multiply-add per element of X."""
    t_bytes = (B * D * x_bytes + B * 4 + D * 4) / HBM_BYTES_PER_S
    t_ops = 2 * B * D / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _backward_plan(torch, X, cd: str) -> dict:
    """The launch of ``lr_backward`` on X: the float backward's plan
    (column tiles x row splits, its cluster, the runtime's blocks per SM
    and the clusters resident at once), or the int8 backward's grid."""
    from distlr_tpu_torch.ops import fused_lr  # noqa: PLC0415

    if X.dtype == torch.int8:
        return fused_lr.int8_backward_grid(X)
    return fused_lr.backward_plan_for(X, cd)


def phase_lr_backward(torch, seed: int) -> dict:
    """``ops.lr_backward`` (bf16 X) and its int8 instance against their
    plain versions at small, odd and unaligned shapes (a view at an odd
    offset, rows of 24 bytes; the step's block at 8 column blocks (two
    row splits), few rows there, B under the row splits), then at the
    feature-sharded step's block (1024, 250,000), the same at 8 column
    blocks (1024, 125,000; bf16 only) and the full width (2048, 1M), timed
    with the plain version and one library call beside them;
    each line with the launch's plan.  Between the two, the step's other
    wrappers at its blocks (:func:`_check_sharded_blocks`)."""
    from distlr_tpu_torch import ops  # noqa: PLC0415

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    s, reps = INT8_SCALE, 25
    results = {"lr_backward": {"rel_err": 0.0}, "lr_backward_int8": {"rel_err": 0.0}}

    def inputs(B, D, int8, offset=0):
        n = B * D + offset
        flat = (torch.randint(-127, 128, (n,), device="cuda", generator=gen, dtype=torch.int8)
                if int8 else torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16))
        return flat[offset:].view(B, D), torch.randn(B, device="cuda", generator=gen)

    for B, D, offset in ((64, 256, 0), (7, 1003, 0), (UNALIGNED_B // 2, UNALIGNED_D // 2, 0),
                         (33, 12, 3), (1, 1, 0), (1, 250_000, 0), (5, 125_000, 0),
                         (3, 4096, 0), (1024, 125_000, 0), (1024, 250_000, 0)):
        for int8 in (False, True):
            name = "lr_backward_int8" if int8 else "lr_backward"
            X, r = inputs(B, D, int8, offset)
            kw = {"feature_scale": s} if int8 else {}
            for cd in ("bfloat16", "float32"):
                before = _launches(ops)
                g = ops.lr_backward(X, r, compute_dtype=cd, **kw)
                torch.cuda.synchronize()
                after = _launches(ops)
                moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
                if moved != {name: 1}:
                    raise AssertionError(f"lr_backward did not count its launch: {moved}")
                e = rel_err(g, ops.lr_backward_reference(X, r, compute_dtype=cd, **kw))
                same = bool(torch.equal(g, ops.lr_backward(X, r, compute_dtype=cd, **kw)))
                emit("kernel_check", kernel=name, B=B, D=D, offset=offset, compute_dtype=cd,
                     rel_err=e, same_bits=same,
                     x_aligned_16=X.data_ptr() % 16 == 0 and (D * X.element_size()) % 16 == 0,
                     plan=_backward_plan(torch, X, cd))
                if not (e <= REL_TOL and same):
                    raise AssertionError(f"{name} disagrees with its plain version at "
                                         f"{(B, D, offset, cd)}: {e}, same bits {same}")
                results[name]["rel_err"] = max(results[name]["rel_err"], e)

    _check_sharded_blocks(torch, gen)

    # the step's block, the same at 8 column blocks (the float backward's
    # rows split in a cluster), the full width
    for B, D, x_kinds in ((1024, 250_000, (False, True)), (1024, 125_000, (False,)),
                          (FULL_B, FULL_D, (False, True))):
        for int8 in x_kinds:
            name = "lr_backward_int8" if int8 else "lr_backward"
            X, r = inputs(B, D, int8)
            kw = {"feature_scale": s} if int8 else {}
            rb = r.to(torch.bfloat16)
            if int8:
                library = (lambda: torch.mv(X.to(torch.bfloat16).t(), rb) * s)  # noqa: E731
                note = "no single call reads int8 X: the composite X.to(bf16) + mv of X^T"
            else:
                library = (lambda: torch.mv(X.t(), rb))  # noqa: E731
                note = "torch.mv(X.t(), r.to(bf16)): cuBLAS, the residual rounded to bf16"
            bound_ms, bound_by = _backward_bound(B, D, X.element_size())
            t = dict(
                max_abs_err=float((ops.lr_backward(X, r, **kw)
                                   - ops.lr_backward_reference(X, r, **kw)).abs().max()),
                ms=time_ms(lambda: ops.lr_backward(X, r, **kw), reps),
                plain_ms=time_ms(lambda: ops.lr_backward_reference(X, r, **kw), reps),
                library_ms=time_ms(library, reps), library_note=note,
                bound_ms=bound_ms, bound_by=bound_by, shape=[B, D],
                plan=_backward_plan(torch, X, "bfloat16"))
            emit("kernel_timing", kernel=name, B=B, D=D, reps=reps, **t)
            if (B, D) == (1024, 250_000):  # the block the feature-sharded step gives it
                results[name].update(t)
            else:
                at = "at_8_column_blocks" if D == 125_000 else "at_2048_rows_1M"
                results[name][at] = {k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                                       "bound_ms", "plan")}
            del X
            torch.cuda.empty_cache()
    return results


def _check_sharded_blocks(torch, gen) -> None:
    """The feature-sharded path's other wrappers against their plain
    versions at the blocks it gives them: a quarter of D = 1M by the rows
    of a train block (1,024 on the main path, 128 at 256 rows) and of an
    eval (256 and 64 rows); ``lr_logits_int8dot`` on the global grid of the
    whole w (``w_amax``), as each column block quantizes its shard."""
    from distlr_tpu_torch import ops  # noqa: PLC0415

    s, d = INT8_SCALE, FULL_D // SHARDED_MESH["model"]
    w_full = torch.randn(FULL_D, device="cuda", generator=gen) / math.sqrt(FULL_D)
    w, w_amax = w_full[d:2 * d], w_full.abs().amax()
    for B in (1024, 256, 128, 64):
        Xb = torch.randn(B, d, device="cuda", generator=gen).to(torch.bfloat16)
        Xq = torch.randint(-127, 128, (B, d), device="cuda", generator=gen, dtype=torch.int8)
        r = torch.randn(B, device="cuda", generator=gen)
        checks = (
            ("lr_logits", "lr_logits", lambda: ops.lr_logits(w, Xb),
             lambda: ops.lr_logits_reference(w, Xb)),
            ("lr_logits", "lr_logits_int8", lambda: ops.lr_logits(w, Xq, feature_scale=s),
             lambda: ops.lr_logits_reference(w, Xq, feature_scale=s)),
            ("lr_logits_int8dot", "lr_logits_int8dot",
             lambda: ops.lr_logits_int8dot(w, Xq, feature_scale=s, w_amax=w_amax),
             lambda: ops.lr_logits_int8dot_reference(w, Xq, feature_scale=s, w_amax=w_amax)),
            ("lr_backward_int8dot", "lr_backward_int8dot",
             lambda: ops.lr_backward_int8dot(Xq, r, feature_scale=s),
             lambda: ops.lr_backward_int8dot_reference(Xq, r, feature_scale=s)),
        )
        for wrapper, counted, run, plain in checks:
            before = _launches(ops)
            out = run()
            torch.cuda.synchronize()
            after = _launches(ops)
            moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            if moved != {counted: 1}:
                raise AssertionError(f"{wrapper} did not count its launch: {moved}")
            e = rel_err(out, plain())
            emit("kernel_check", kernel=counted, wrapper=wrapper, B=B, D=d,
                 at="feature_sharded_block", rel_err=e)
            if not e <= REL_TOL:
                raise AssertionError(f"{counted} disagrees with its plain version at the "
                                     f"block {(B, d)}: {e}")
        del Xb, Xq
    torch.cuda.empty_cache()


def _blocks_of(fn, X, y, mask, w, num_blocks: int, cfg):
    """The plain recurrence's gradient over ``num_blocks`` row blocks:
    the mean of each block's ``fn(w, X_i, y_i, mask_i) / n_i + L2``."""
    b = X.shape[0] // num_blocks
    g = None
    for i in range(num_blocks):
        rows = slice(i * b, (i + 1) * b)
        n = mask[rows].sum().clamp_min(1.0)
        gi = fn(w, X[rows], y[rows], mask[rows]) / n + cfg.l2_c * w
        g = gi if g is None else g + gi
    return g / num_blocks


def _sharded_trainer(torch, rows, cfg, *, phase: str, steps: int, kernels, ref=None,
                     plain=None, timing: bool = True) -> dict:
    """A feature-sharded ``Trainer`` through load_data -> fit -> evaluate ->
    save on ``rows``, with the launch counts zeroed just before fit and
    read just after; one step's launches; the weights against the plain
    recurrence (``plain(model, w, X, y, mask)``: a row block's
    unnormalized gradient) and, given ``ref`` (weights, eval metrics), against the
    unsharded path; with ``timing``, the step's device time and busy share
    on a resident batch."""
    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.parallel import make_eval_step  # noqa: PLC0415
    from distlr_tpu_torch.train import GlobalShardedData, Trainer  # noqa: PLC0415

    train_rows, test_rows = rows[0], rows[1]
    B, D = train_rows[0].shape
    train, test = GlobalShardedData([train_rows]), GlobalShardedData([test_rows])
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
    s = cfg.mesh_shape["model"]
    W = cfg.mesh_shape["data"]
    grad_fn, logits_fn = kernels
    evals = cfg.num_iteration + 1  # an eval each epoch, then evaluate_metrics
    want = {grad_fn: steps * W * s, logits_fn: steps * W * s + evals * s}
    others = {k: v for k, v in launches.items() if k not in want and v}
    if {k: launches[k] for k in want} != want or others or not saved_ok:
        raise AssertionError(f"{phase}: launches {launches}, want {want}; saved ok {saved_ok}")

    # one step on a resident, column-blocked batch: its launches
    Xb, yb, mb = trainer._put(train.full_batch(column_blocks=s))
    w_tmp = trainer.weights.clone()
    ops.reset_launch_counts()
    trainer.train_step(w_tmp, (Xb, yb, mb))
    torch.cuda.synchronize()
    step_launches = {k: v for k, v in _launches(ops).items() if v}
    if step_launches != {grad_fn: W * s, logits_fn: W * s}:
        raise AssertionError(f"{phase}: one step launched {step_launches}")

    # the plain recurrence on the unblocked rows, block by block
    X, y, mask = trainer._put(train.full_batch())
    w = w0
    for _ in range(steps):
        w = w - cfg.learning_rate * _blocks_of(
            lambda *a: plain(trainer.model, *a), X, y, mask, w, W, cfg)
    out = {"D": D, "B": B, "mesh": cfg.mesh_shape, "steps": steps,
           "feature_dtype": cfg.feature_dtype, "feature_scale": trainer.model.feature_scale,
           "kernels": list(kernels), "launches": launches, "launches_per_step": step_launches,
           "loss": trainer.metrics.latest("loss"), "test_accuracy": metrics["accuracy"],
           "test_logloss": metrics["logloss"],
           "weights_rel_err_vs_plain": rel_err(trainer.weights, w), "load_s": load_s,
           "fit_eval_save_s": fit_s}
    if not (math.isfinite(out["loss"]) and math.isfinite(metrics["logloss"])):
        raise AssertionError(f"{phase}: non-finite loss {out['loss']} / {metrics}")
    if out["weights_rel_err_vs_plain"] > REL_TOL:
        raise AssertionError(f"{phase}: weights differ from the plain recurrence: "
                             f"{out['weights_rel_err_vs_plain']}")
    if ref is not None:
        ref_w, ref_metrics = ref
        out["weights_rel_err_vs_unsharded"] = rel_err(trainer.weights.cpu(), ref_w)
        # the sharded weights through the unsharded eval, on the same test rows
        Xt, yt, mt = trainer._put(test.full_batch())
        unsharded = {k: float(v) for k, v in
                     make_eval_step(trainer.model)(trainer.weights, (Xt, yt, mt)).items()}
        out["unsharded_eval_of_these_weights"] = unsharded
        out["unsharded_path_eval"] = ref_metrics
        n_test = int(mt.sum())
        if (out["weights_rel_err_vs_unsharded"] > REL_TOL
                or abs(unsharded["accuracy"] - metrics["accuracy"]) > 1.0 / n_test
                or abs(unsharded["logloss"] - metrics["logloss"])
                > 1e-4 * abs(unsharded["logloss"])):
            raise AssertionError(f"{phase}: the sharded path disagrees with the unsharded one: "
                                 f"{out}")
    if timing:
        out["step_device_ms"] = time_ms(lambda: trainer.train_step(w_tmp, (Xb, yb, mb)), 10)
        trace = _step_kernels(torch, lambda: trainer.train_step(w_tmp, (Xb, yb, mb)))
        out.update(trace)
        out["device_busy_share"] = trace["kernel_us_per_step"] / (1e3 * out["step_device_ms"])
        out["step_ms"] = 1e3 * trainer.timer.sec_per_step
        out["two_read_floor_ms"] = _two_read_floor_ms(B, D, Xb.element_size())
        out["host_peak_rss_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        out["device_peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    emit(phase, **out)
    del trainer, train, test, X, Xb
    torch.cuda.empty_cache()
    return out


def phase_trainer_feature_sharded(torch, rows, ref) -> dict:
    """The main path's rows (D = 1M, 2,048 a step, bf16) through the
    feature-sharded trainer on the mesh {"data": 2, "model": 4}: each step
    8 ``lr_logits`` and 8 ``lr_backward`` launches on (1024, 250,000)
    blocks; held against the unsharded ``trainer`` phase's weights and
    eval, and against the plain recurrence."""
    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.config import Config  # noqa: PLC0415

    D = rows[0][0].shape[1]
    steps = 3
    with tempfile.TemporaryDirectory(prefix="distlr-smoke-") as tmp:
        cfg = Config(num_feature_dim=D, feature_dtype="bfloat16", compute_dtype="bfloat16",
                     batch_size=-1, learning_rate=0.2, l2_c=0.01, num_iteration=steps,
                     test_interval=1, data_dir=tmp, num_workers=SHARDED_MESH["data"],
                     mesh_shape=SHARDED_MESH)
        return _sharded_trainer(
            torch, rows, cfg, phase="trainer_feature_sharded", steps=steps,
            kernels=("lr_backward", "lr_logits"), ref=ref,
            plain=lambda model, w, X, y, m: ops.fused_lr_grad_reference(w, X, y, m))


def phase_feature_sharded_small(torch, seed: int) -> dict:
    """At 256 rows of D = 1M: the feature-sharded trainer on int8 and
    int8_dot features, ``make_ring_train_step`` against the psum step and
    the plain recurrence; then a column block whose rows break 16-byte
    alignment (D = 24 over 2 blocks, bf16) through the trainer, against
    the same trainer on the CPU.  Returns each path's line."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.models import BinaryLR  # noqa: PLC0415
    from distlr_tpu_torch.parallel.feature_parallel import (  # noqa: PLC0415
        make_feature_sharded_train_step,
        shard_batch_2d,
    )
    from distlr_tpu_torch.parallel.mesh import make_mesh  # noqa: PLC0415
    from distlr_tpu_torch.parallel.ring import make_ring_train_step  # noqa: PLC0415
    from distlr_tpu_torch.train import GlobalShardedData, Trainer  # noqa: PLC0415

    rows = trainer_rows(seed + 5, FULL_D, SHARDED_SMALL_B, 64)
    paths = {}
    steps = 3
    with tempfile.TemporaryDirectory(prefix="distlr-smoke-") as tmp:
        base = dict(num_feature_dim=FULL_D, compute_dtype="bfloat16", batch_size=-1,
                    learning_rate=0.2, l2_c=0.01, num_iteration=steps, test_interval=1,
                    data_dir=tmp, num_workers=SHARDED_MESH["data"], mesh_shape=SHARDED_MESH)
        for fd, kernels in (("int8", ("lr_backward_int8", "lr_logits_int8")),
                            ("int8_dot", ("lr_backward_int8dot", "lr_logits_int8dot"))):
            cfg = Config(feature_dtype=fd, **base)

            def plain(model, w, X, y, m, fd=fd):
                fs = model.feature_scale
                if fd == "int8_dot":
                    return ops.fused_lr_grad_int8dot_reference(w, X, y, m, feature_scale=fs)
                return ops.fused_lr_grad_reference(w, X, y, m, feature_scale=fs)

            name = f"trainer_feature_sharded_{fd}"
            paths[name] = _sharded_trainer(torch, rows, cfg, phase=name, steps=steps,
                                           kernels=kernels, plain=plain, timing=False)

    # the ring step against the psum step, on one resident batch
    train_rows = rows[0]
    mesh = make_mesh(SHARDED_MESH)
    cfg = Config(num_feature_dim=FULL_D, learning_rate=0.2, l2_c=0.01,
                 num_workers=SHARDED_MESH["data"], mesh_shape=SHARDED_MESH)
    model = BinaryLR(FULL_D)
    X, y, mask = train_rows[0], train_rows[1], torch.ones(SHARDED_SMALL_B)
    Xb = torch.from_numpy(X).to(torch.bfloat16)
    batch = shard_batch_2d((Xb, torch.from_numpy(y), mask), mesh, "cuda")
    w0 = torch.randn(FULL_D, device="cuda", generator=torch.Generator(device="cuda")
                     .manual_seed(seed)) / math.sqrt(FULL_D)
    ops.reset_launch_counts()
    w_ring, m_ring = w0.clone(), None
    ring = make_ring_train_step(model, cfg, mesh)
    for _ in range(steps):
        w_ring, m_ring = ring(w_ring, batch)
    torch.cuda.synchronize()
    launches = _launches(ops)
    want = {"lr_backward": steps * 8, "lr_logits": steps * 8}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"the ring step launched {launches}, want {want}")
    w_psum = w0.clone()
    psum = make_feature_sharded_train_step(model, cfg, mesh)
    for _ in range(steps):
        w_psum, m_psum = psum(w_psum, batch)
    Xd = Xb.to("cuda")
    yd, md = batch[1], batch[2]
    w = w0
    for _ in range(steps):
        w = w - cfg.learning_rate * _blocks_of(ops.fused_lr_grad_reference, Xd, yd, md, w,
                                               SHARDED_MESH["data"], cfg)
    ring_out = {"D": FULL_D, "B": SHARDED_SMALL_B, "mesh": SHARDED_MESH, "steps": steps,
                "kernels": ["lr_backward", "lr_logits"], "launches": launches,
                "loss": float(m_ring["loss"]), "psum_loss": float(m_psum["loss"]),
                "weights_rel_err_vs_psum_step": rel_err(w_ring, w_psum),
                "weights_rel_err_vs_plain": rel_err(w_ring, w),
                "step_device_ms": time_ms(lambda: ring(w_ring.clone(), batch), 5),
                "psum_step_device_ms": time_ms(lambda: psum(w_psum.clone(), batch), 5)}
    emit("ring_step", **ring_out)
    if max(ring_out["weights_rel_err_vs_psum_step"], ring_out["weights_rel_err_vs_plain"]) \
            > REL_TOL:
        raise AssertionError(f"the ring step disagrees: {ring_out}")
    paths["ring_step"] = ring_out
    del batch, Xd, Xb

    # a column block of 12 bf16 columns: rows of 24 bytes, no bulk copies
    rng = np.random.default_rng(seed)
    Xs = rng.standard_normal((UNALIGNED_B, UNALIGNED_D)).astype(np.float32)
    ys = (rng.random(UNALIGNED_B) < 0.5).astype(np.int32)
    data = lambda: GlobalShardedData([(Xs, ys)])  # noqa: E731
    kw = dict(num_feature_dim=UNALIGNED_D, feature_dtype="bfloat16", num_iteration=steps,
              batch_size=-1, test_interval=0, num_workers=2,
              mesh_shape={"data": 2, "model": 2}, learning_rate=0.5, l2_c=0.0)
    card = Trainer(Config(**kw)).load_data(train=data(), test=data())
    cpu = Trainer(Config(device="cpu", **kw)).load_data(train=data(), test=data())
    ops.reset_launch_counts()
    w_card = card.fit().cpu()
    launches = _launches(ops)
    unaligned = {"D": UNALIGNED_D, "B": UNALIGNED_B, "block_cols": UNALIGNED_D // 2,
                 "block_row_bytes": UNALIGNED_D // 2 * 2, "kernels": ["lr_backward", "lr_logits"],
                 "launches": launches, "weights_rel_err_vs_cpu": rel_err(w_card, cpu.fit())}
    emit("feature_sharded_unaligned", **unaligned)
    if unaligned["weights_rel_err_vs_cpu"] > REL_TOL or launches["lr_backward"] != steps * 4:
        raise AssertionError(f"the unaligned column blocks disagree: {unaligned}")
    paths["feature_sharded_unaligned"] = unaligned
    return paths


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


# --- the parameter-server path ----------------------------------------------
PS_WORKERS, PS_SERVERS, PS_SHARD_ROWS, PS_TEST_ROWS, PS_EPOCHS = 2, 2, 1024, 256, 3
PS_ASYNC_BATCH = 512
# a KV op that waits longer fails the run (a hung worker or card); the
# phase as a whole has a wall-clock limit on top
PS_TIMEOUT_MS, PS_WALL_S = 120_000, 600


def _write_libsvm_cols(path: str, cols, y) -> None:
    """Rows of ascending one-hot columns as libsvm text (1-based, value 1),
    the lines ``write_libsvm`` writes for the same dense rows."""
    with open(path, "w") as f:
        f.writelines(f"{int(label)} " + " ".join(f"{c + 1}:1" for c in row) + "\n"
                     for row, label in zip(cols.tolist(), y))


def _ps_data(tmp: str, seed: int, shard_rows: int = PS_SHARD_ROWS,
             test_rows: int = PS_TEST_ROWS) -> float:
    """The ps phase's data dir: two train shards of PS_SHARD_ROWS config-3
    CTR rows and PS_TEST_ROWS test rows at D = FULL_D, as libsvm text."""
    import numpy as np  # noqa: PLC0415

    rng = np.random.default_rng(seed)
    w_true = (rng.standard_normal(FULL_D) * 0.5).astype(np.float32)
    t0 = time.perf_counter()
    for split, part, n in (("train", 1, shard_rows), ("train", 2, shard_rows),
                           ("test", 1, test_rows)):
        os.makedirs(os.path.join(tmp, split), exist_ok=True)
        _write_libsvm_cols(os.path.join(tmp, split, f"part-{part:03d}"),
                           *_ctr_cols(rng, n, w_true, FULL_D))
    return time.perf_counter() - t0


@contextlib.contextmanager
def _sampled_peak_rss(out: dict, period_s: float = 0.05):
    """This process's resident set at the start of the block and its peak
    over the block, sampled from ``/proc/self/status`` every ``period_s``,
    into ``out`` (the kernel's own peak, ``VmHWM``, covers the whole
    process; earlier phases leave pinned host blocks cached)."""
    def rss_kb() -> int:
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))

    stop = threading.Event()
    start = peak = rss_kb()

    def sample():
        nonlocal peak
        while not stop.wait(period_s):
            peak = max(peak, rss_kb())

    t = threading.Thread(target=sample, daemon=True, name="smoke-rss")
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join()
        out["host_rss_at_start_gb"] = start / 2**20
        out["host_peak_rss_gb"] = max(peak, rss_kb()) / 2**20


def _bounded(torch, fn) -> tuple[object, dict, float]:
    """``fn()`` (a PS run) with the launch counts zeroed just before and
    read just after, under a wall-clock limit; ``(result, launches,
    seconds)``.  Raises if the run hangs or fails."""
    from distlr_tpu_torch import ops  # noqa: PLC0415

    out = {}

    def run():
        try:
            out["result"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below, in the main thread
            out["error"] = e

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    worker = threading.Thread(target=run, daemon=True, name="smoke-ps")
    worker.start()
    worker.join(PS_WALL_S)
    if worker.is_alive():
        # stop the KV servers this process started, then fail the phase
        subprocess.run(["pkill", "-TERM", "-P", str(os.getpid())], check=False)
        raise AssertionError(f"the ps run did not end within {PS_WALL_S} s")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if "error" in out:
        raise out["error"]
    return out["result"], _launches(ops), seconds


def _run_ps(torch, cfg, *, save: bool = True, **kw) -> tuple[list, dict, dict, float]:
    """``run_ps_local(cfg, **kw)`` under :func:`_bounded`; ``(weights,
    report, launches, seconds)``."""
    from distlr_tpu_torch.train.ps_trainer import run_ps_local  # noqa: PLC0415

    report = {}
    weights, launches, seconds = _bounded(
        torch, lambda: run_ps_local(cfg, save=save, report=report, **kw))
    return weights, report, launches, seconds


def _test_logloss(torch, ops, w, Xt, yt) -> float:
    """Mean test logloss of ``w`` by the plain forward on the card."""
    z = ops.lr_logits_reference(torch.as_tensor(w, device="cuda"), Xt, compute_dtype="bfloat16")
    return float((torch.logaddexp(z, torch.zeros_like(z)) - yt * z).mean())


def _ps_kernel_shapes(torch, ops, w_run, shards, Xt) -> dict:
    """The path's kernels at the shapes the ps runs gave them, against
    their plain versions (REL_TOL), and their times: ``fused_lr_grad`` on
    each worker's whole shard (a sync step) and on each 512-row half (an
    async step), ``lr_logits`` on the test rows (rank 0's eval).  The
    runs' weights saturate every residual (±1 or 0), which would hide the
    kernels' rounding, so the check takes the sync run's final weights
    centred and scaled to logits of standard deviation 1.5 on the first
    shard, and reports the share of residuals off ±1 and 0.  Launches
    made here come after the runs' counts were read."""
    X0 = shards[0][0]
    wc = w_run - w_run.mean()
    wc = wc * (1.5 / float(ops.lr_logits_reference(wc, X0).std()))
    cases = [(f"shard{r}", X, y) for r, (X, y) in enumerate(shards)]
    cases += [(f"shard{r}_rows{a}_{a + PS_ASYNC_BATCH}", X[a:a + PS_ASYNC_BATCH].contiguous(),
               y[a:a + PS_ASYNC_BATCH]) for r, (X, y) in enumerate(shards)
              for a in range(0, PS_SHARD_ROWS, PS_ASYNC_BATCH)]
    reps, checks, worst, unsaturated = 25, {}, {"fused_lr_grad": 0.0, "lr_logits": 0.0}, []
    for name, X, y in cases:
        mask = torch.ones(X.shape[0], device="cuda")
        g = ops.fused_lr_grad(wc, X, y, mask)
        g_ref = ops.fused_lr_grad_reference(wc, X, y, mask)
        resid = torch.sigmoid(ops.lr_logits_reference(wc, X)) - y.float()
        unsaturated.append(float(((resid.abs() > 1e-3) & (resid.abs() < 1 - 1e-3)).float().mean()))
        checks[name] = {"B": X.shape[0], "rel_err": rel_err(g, g_ref),
                        "max_abs_err": float((g - g_ref).abs().max())}
        worst["fused_lr_grad"] = max(worst["fused_lr_grad"], checks[name]["rel_err"])
    z, z_ref = ops.lr_logits(wc, Xt), ops.lr_logits_reference(wc, Xt)
    checks["test"] = {"B": Xt.shape[0], "rel_err": rel_err(z, z_ref),
                      "max_abs_err": float((z - z_ref).abs().max())}
    worst["lr_logits"] = checks["test"]["rel_err"]
    out = {"checks": checks, "worst_rel_err": worst, "tolerance": REL_TOL,
           "residuals_unsaturated_share": min(unsaturated)}
    if max(worst.values()) > REL_TOL or min(unsaturated) < 0.5:
        raise AssertionError(f"ps: a kernel disagrees with its plain version at the ps "
                             f"shapes, or the check's residuals saturate: {out}")
    # device times at those shapes (back-to-back calls between two events)
    timing = {}
    for B in (PS_SHARD_ROWS, PS_ASYNC_BATCH):
        X, y = shards[0][0][:B].contiguous(), shards[0][1][:B]
        mask = torch.ones(B, device="cuda")
        bound_ms, bound_by = _grad_bound(B, FULL_D, X.element_size())
        timing[f"fused_lr_grad_B{B}"] = {
            "ms": time_ms(lambda: ops.fused_lr_grad(wc, X, y, mask), reps),
            "plain_ms": time_ms(lambda: ops.fused_lr_grad_reference(wc, X, y, mask), reps),
            "library_ms": time_ms(_library_grad(torch, wc, X, y, mask), reps),
            "bound_ms": bound_ms, "bound_by": bound_by}
    bound_ms, bound_by = _logits_bound(Xt.shape[0], FULL_D, Xt.element_size())
    wb = wc.to(torch.bfloat16)
    timing[f"lr_logits_B{Xt.shape[0]}"] = {
        "ms": time_ms(lambda: ops.lr_logits(wc, Xt), reps),
        "plain_ms": time_ms(lambda: ops.lr_logits_reference(wc, Xt), reps),
        "library_ms": time_ms(lambda: torch.mv(Xt, wb), reps),
        "bound_ms": bound_ms, "bound_by": bound_by}
    out["timing"] = timing
    return out


def phase_ps(torch, seed: int, smi: str) -> dict:
    """The parameter-server path at the full width (D = 1M), through
    ``run_ps_local``: PS_SERVERS native KV servers and PS_WORKERS worker
    threads sharing the card, each gradient the ``fused_lr_grad`` single
    pass and rank 0's eval ``lr_logits``.  Sync (BSP, reference compat:
    Q1, Q2, Q4), full shards a step: both workers end with the same
    weights, within REL_TOL of the plain recurrence (each shard's plain
    gradient on the card and the server's Q1 update), ``fused_lr_grad``
    launched once a worker and step, and rank 0's reported test logloss
    within REL_TOL of the plain forward's on the final weights; then the
    same with the reference's serialized pull -> gradient -> push a batch
    (``ps_pipeline=False``), whose weights must equal the fused run's bit
    for bit.  Async (Hogwild), PS_ASYNC_BATCH rows a step: the servers
    count one push a worker and step (plus the seeding push), the weights
    are finite and the test logloss falls below the init's.  Last, the
    kernels at the shapes the runs gave them, against their plain
    versions on unsaturated residuals, and timed
    (:func:`_ps_kernel_shapes`)."""
    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.data import native_available, parse_libsvm_file  # noqa: PLC0415
    from distlr_tpu_torch.models import get_model  # noqa: PLC0415

    lines, rss = {}, {}
    with _sampled_peak_rss(rss), tempfile.TemporaryDirectory(prefix="distlr-smoke-ps-") as tmp:
        data_s = _ps_data(tmp, seed)
        t0 = time.perf_counter()
        X1, y1 = parse_libsvm_file(os.path.join(tmp, "train", "part-001"), FULL_D)
        parse_s = time.perf_counter() - t0
        if not native_available():
            raise AssertionError("the native libsvm parser did not run")
        del X1, y1
        cfg = Config(data_dir=tmp, num_feature_dim=FULL_D, num_workers=PS_WORKERS,
                     num_servers=PS_SERVERS, batch_size=PS_SHARD_ROWS, num_iteration=PS_EPOCHS,
                     test_interval=1, learning_rate=0.2, l2_c=0.01, compat_mode="reference",
                     compute_dtype="bfloat16", ps_timeout_ms=PS_TIMEOUT_MS)
        w0 = get_model(cfg).init(cfg).to("cuda")
        Xt, yt = parse_libsvm_file(os.path.join(tmp, "test", "part-001"), FULL_D)
        Xt = torch.from_numpy(Xt).to(torch.bfloat16).cuda()
        yt = torch.from_numpy(yt).float().cuda()
        init_ll = _test_logloss(torch, ops, w0, Xt, yt)
        # each worker's shard on the card, as its steps copy it there
        shards = []
        for part in range(1, PS_WORKERS + 1):
            X, y = parse_libsvm_file(os.path.join(tmp, "train", f"part-{part:03d}"), FULL_D)
            shards.append((torch.from_numpy(X).to(torch.bfloat16).cuda(),
                           torch.from_numpy(y).cuda()))
            del X

        for mode, run_cfg in (("sync", cfg), ("sync_serialized", cfg.replace(ps_pipeline=False)),
                              ("async", cfg.replace(sync_mode=False, batch_size=PS_ASYNC_BATCH))):
            weights, report, launches, seconds = _run_ps(torch, run_cfg)
            steps = PS_EPOCHS * -(-PS_SHARD_ROWS // run_cfg.batch_size)
            others = {k: v for k, v in launches.items()
                      if v and k not in ("fused_lr_grad", "lr_logits")}
            if (launches["fused_lr_grad"] != PS_WORKERS * steps
                    or launches["lr_logits"] != PS_EPOCHS or others):
                raise AssertionError(f"ps {mode}: not one fused_lr_grad a worker and step and "
                                     f"one lr_logits an eval: {launches}")
            if not all(r["steps"] == steps for r in report.values()):
                raise AssertionError(f"ps {mode}: steps {report}")
            for rank in range(PS_WORKERS):
                path = os.path.join(tmp, "models", f"part-{rank + 1:03d}")
                with open(path) as f:
                    if f.readline().strip() != str(FULL_D) or len(f.readline().split()) != FULL_D:
                        raise AssertionError(f"ps {mode}: {path} is malformed")
            w = [torch.from_numpy(x).cuda() for x in weights]
            line = {"mode": mode, "seconds": seconds, "steps_per_worker": steps,
                    "batch_rows": run_cfg.batch_size,
                    "launches": {k: v for k, v in launches.items() if v},
                    "workers": [report[r] for r in range(PS_WORKERS)]}
            if mode == "sync_serialized":
                # the reference's pull -> gradient -> push a batch: the same
                # BSP rounds, so the same weights bit for bit
                line["equals_fused_sync"] = all(torch.equal(a, b) for a, b in zip(w, sync_w))
                if not line["equals_fused_sync"]:
                    raise AssertionError("ps: serialized sync weights differ from the fused run's")
            elif mode == "sync":
                sync_w = w
                line["workers_max_abs_diff"] = float((w[0] - w[1]).abs().max())
                if line["workers_max_abs_diff"] > 1e-5:
                    raise AssertionError(f"ps sync: the workers' weights differ by "
                                         f"{line['workers_max_abs_diff']}")
                # rank 0's eval: its last test logloss is that of the
                # final weights (the BSP round has ended when it pulls)
                line["test_logloss_reported"] = report[0]["test_logloss"]
                line["test_logloss_plain"] = _test_logloss(torch, ops, w[0], Xt, yt)
                if not (abs(line["test_logloss_reported"] - line["test_logloss_plain"])
                        <= REL_TOL * abs(line["test_logloss_plain"])):
                    raise AssertionError(f"ps sync: rank 0 reported test logloss "
                                         f"{line['test_logloss_reported']}, the plain forward "
                                         f"gives {line['test_logloss_plain']}")
                # the plain recurrence: Q1 applies the highest rank's gradient
                # / W, Q4 divides the L2 term by the batch count
                X, y = shards[-1]
                mask = torch.ones(X.shape[0], device="cuda")
                n = mask.sum()
                wp = w0
                for _ in range(steps):
                    g = (ops.fused_lr_grad_reference(wp, X, y, mask, compute_dtype="bfloat16")
                         / n + cfg.l2_c * wp / n)
                    wp = wp - cfg.learning_rate * g / PS_WORKERS
                del X
                # the weights, and what training moved them by (most of w is
                # its init, untouched by rare buckets' small updates)
                line["weights_rel_err_vs_plain"] = rel_err(w[0], wp)
                line["update_rel_err_vs_plain"] = rel_err(w[0] - w0, wp - w0)
                if max(line["weights_rel_err_vs_plain"], line["update_rel_err_vs_plain"]) > REL_TOL:
                    raise AssertionError(f"ps sync: weights differ from the plain recurrence: "
                                         f"rel {line['weights_rel_err_vs_plain']}, of the update "
                                         f"{line['update_rel_err_vs_plain']}")
            else:
                line["gradient_pushes"] = report[0]["group_pushes"] - 1  # less the seeding push
                line["test_logloss_init"] = init_ll
                line["test_logloss_final"] = [_test_logloss(torch, ops, x, Xt, yt) for x in w]
                if line["gradient_pushes"] != PS_WORKERS * steps:
                    raise AssertionError(f"ps async: the servers counted "
                                         f"{line['gradient_pushes']} gradient pushes, not "
                                         f"{PS_WORKERS * steps}")
                if not all(bool(torch.isfinite(x).all()) for x in w) or not all(
                        ll < init_ll for ll in line["test_logloss_final"]):
                    raise AssertionError(f"ps async: weights not finite or test logloss "
                                         f"{line['test_logloss_final']} not below the "
                                         f"init's {init_ll}")
            lines[mode] = line
        kernels = _ps_kernel_shapes(torch, ops, sync_w[0], shards, Xt)
        del Xt, w0, shards
    torch.cuda.empty_cache()
    out = {
        "nvidia_smi": smi, "D": FULL_D, "workers": PS_WORKERS, "servers": PS_SERVERS,
        "shard_rows": PS_SHARD_ROWS, "test_rows": PS_TEST_ROWS, "epochs": PS_EPOCHS,
        "reduced": {"epochs": f"{PS_EPOCHS} (cut in depth)",
                    "shard_rows": f"{PS_SHARD_ROWS} a worker (cut; the sync round is the "
                                  f"headline's global batch of {PS_WORKERS * PS_SHARD_ROWS})"},
        "data_write_s": data_s, "parse_s_per_shard": parse_s, "native_parser": True,
        **rss, **lines, "kernels_at_ps_shapes": kernels,
    }
    emit("ps", **out)
    return out


# --- the scoring tier -------------------------------------------------------
SERVE_BUCKETS, SERVE_WAIT_MS = (64, 256, 1024), 2.0
SERVE_CLIENTS, SERVE_SINGLES = 8, 16
SERVE_JSON_ROWS = (37, 200, 1024, 1500)   # the last splits into 1,024 + 476
SERVE_SCORE_TOL, SERVE_LABEL_MARGIN = 1e-5, 1e-3
SERVE_SIDE_ROWS, SERVE_WIDE_ROWS = 256, 64
# int8 features quantized on the grid of the one-hot rows: max|x| / 127
SERVE_INT8_SCALE = 1.0 / 127.0
# the JAX server's STATS schema (distlr_tpu/serve/server.py:572-625, pinned
# by tests/test_serve.py:477-569), written out: this machine has no JAX
SERVE_STATS_KEYS = {"requests", "errors", "qps", "p50_ms", "p99_ms", "shed", "retries",
                    "replica_count", "models", "per_model", "batcher", "engine"}
SERVE_BATCHER_KEYS = {"batches", "requests", "rows", "mean_occupancy",
                      "mean_requests_per_batch", "max_batch_size", "max_wait_ms"}
SERVE_ENGINE_KEYS = {"weights_version", "batches_scored", "rows_scored", "bucket_hits",
                     "buckets"}
# the serving path's kernels: each must launch in the serve phase's run
SERVE_KERNELS = ("lr_logits", "lr_logits_int8", "lr_logits_int8dot", "lr_logits_row_blocks")


def _libsvm_lines(cols, y) -> list[str]:
    """Rows of one-hot columns as libsvm request lines (1-based, value 1)."""
    return [f"{int(label)} " + " ".join(f"{c + 1}:1" for c in row)
            for row, label in zip(cols.tolist(), y)]


def _device_rows(torch, cols, D: int, dtype, value: float = 1.0):
    """The one-hot rows of ``cols`` as an (n, D) tensor on the card."""
    X = torch.zeros((cols.shape[0], D), dtype=dtype, device="cuda")
    X.scatter_(1, torch.from_numpy(cols).cuda(), value)
    return X


def _serve_weights(rng, D: int, cols):
    """Seeded weights, centred and scaled so that the logits of the rows of
    ``cols`` have a deviation of 1.5: no score saturates."""
    import numpy as np  # noqa: PLC0415

    w = rng.standard_normal(D).astype(np.float32)
    w -= w.mean()
    return (w * (1.5 / float(w[cols].sum(axis=1).std()))).astype(np.float32)


def _plain_logits(torch, ops, w, cols, D: int, kind: str = "bfloat16"):
    """The plain forward on the card for the rows of ``cols``, 1,024 rows at
    a time: bf16 rows, or their int8 quantization for ``int8`` /
    ``int8_dot`` engines (f32 on the host)."""
    zs = []
    for lo in range(0, cols.shape[0], 1024):
        c = cols[lo:lo + 1024]
        if kind == "bfloat16":
            z = ops.lr_logits_reference(w, _device_rows(torch, c, D, torch.bfloat16))
        else:
            Xq = _device_rows(torch, c, D, torch.int8, round(1.0 / SERVE_INT8_SCALE))
            z = (ops.lr_logits_int8dot_reference(w, Xq, feature_scale=SERVE_INT8_SCALE)
                 if kind == "int8_dot"
                 else ops.lr_logits_reference(w, Xq, feature_scale=SERVE_INT8_SCALE))
        zs.append(z.cpu())
    return torch.cat(zs)


def _check_replies(torch, what: str, labels, scores, z) -> dict:
    """Replies against the plain logits: scores within SERVE_SCORE_TOL of
    σ(z), labels equal wherever |z| > SERVE_LABEL_MARGIN."""
    labels, scores = torch.as_tensor(labels), torch.as_tensor(scores, dtype=torch.float64)
    err = float((scores - torch.sigmoid(z.double())).abs().max())
    clear = z.abs() > SERVE_LABEL_MARGIN
    flips = int((labels[clear] != (z[clear] > 0).to(labels.dtype)).sum())
    if err > SERVE_SCORE_TOL or flips:
        raise AssertionError(f"serve {what}: replies disagree with the plain forward: "
                             f"max |score - σ(z)| {err}, {flips} labels differ")
    return {"rows": int(z.shape[0]), "max_abs_score_err": err,
            "labels_checked": int(clear.sum())}


def _parse_libsvm_replies(replies):
    if any(r.startswith("ERR") for r in replies):
        raise AssertionError(f"serve: ERR replies: {[r for r in replies if r.startswith('ERR')]}")
    return [int(r.split()[0]) for r in replies], [float(r.split()[1]) for r in replies]


def _json_request(host, port, lines):
    """One JSON batch request; (labels, scores, client seconds)."""
    from distlr_tpu_torch.serve import score_lines_over_tcp  # noqa: PLC0415

    t0 = time.perf_counter()
    (reply,) = score_lines_over_tcp(host, port, [json.dumps({"rows": lines})], timeout_s=300)
    seconds = time.perf_counter() - t0
    if reply.startswith("ERR"):
        raise AssertionError(f"serve: a JSON request of {len(lines)} rows answered {reply}")
    doc = json.loads(reply)
    return doc["labels"], doc["scores"], seconds


def _serve_engine(torch, D: int, feature_dtype: str = "bfloat16", **kw):
    import dataclasses  # noqa: PLC0415

    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.serve import ScoringEngine  # noqa: PLC0415

    cfg = Config(num_feature_dim=D, feature_dtype=feature_dtype, compute_dtype="bfloat16",
                 l2_c=0.0, serve_max_batch_size=SERVE_BUCKETS[-1], serve_max_wait_ms=SERVE_WAIT_MS)
    eng = ScoringEngine(cfg, max_batch_size=cfg.serve_max_batch_size, buckets=SERVE_BUCKETS, **kw)
    if feature_dtype != "bfloat16":
        eng.model = dataclasses.replace(eng.model, feature_scale=SERVE_INT8_SCALE)
    return eng


def _serve_traffic(torch, ops, srv, w_dev, cols, y) -> dict:
    """The full-width engine's traffic through its server over TCP:
    SERVE_CLIENTS concurrent clients of SERVE_SINGLES single-line requests,
    then JSON batches of SERVE_JSON_ROWS rows, then one malformed line on a
    connection that keeps serving, then STATS; every reply held against
    the plain forward."""
    from distlr_tpu_torch.serve import score_lines_over_tcp  # noqa: PLC0415

    singles = SERVE_CLIENTS * SERVE_SINGLES
    lines = _libsvm_lines(cols, y)
    start = threading.Barrier(SERVE_CLIENTS)
    replies: dict[int, list] = {}

    def client(k):
        start.wait()
        replies[k] = score_lines_over_tcp(
            srv.host, srv.port, lines[k * SERVE_SINGLES:(k + 1) * SERVE_SINGLES])

    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
        list(pool.map(client, range(SERVE_CLIENTS)))
    singles_s = time.perf_counter() - t0
    coalesce = srv.batcher.stats()
    single_flushes = coalesce["batches"]
    if coalesce["mean_requests_per_batch"] <= 1:
        raise AssertionError(f"serve: {SERVE_CLIENTS} concurrent clients did not coalesce: "
                             f"{coalesce}")
    labels, scores = _parse_libsvm_replies([r for k in range(SERVE_CLIENTS) for r in replies[k]])
    requests = {}
    lo = singles
    for n in SERVE_JSON_ROWS:
        lab, sc, seconds = _json_request(srv.host, srv.port, lines[lo:lo + n])
        labels += lab
        scores += sc
        requests[f"json_{n}"] = {"rows": n, "client_ms": 1e3 * seconds}
        lo += n
    bad, good = score_lines_over_tcp(srv.host, srv.port, ["1:x 2:1", lines[0]])
    if not bad.startswith("ERR ") or good.startswith("ERR") or good != replies[0][0]:
        raise AssertionError(f"serve: a malformed line answered {bad!r}, then {good!r}")
    z = _plain_logits(torch, ops, w_dev, cols[:lo], w_dev.shape[0])
    check = _check_replies(torch, "full width", labels, scores, z)
    (raw,) = score_lines_over_tcp(srv.host, srv.port, ["STATS"])
    stats = json.loads(raw)
    # a 1,500-row request is one batch of two chunks: 1,024 and 476 rows
    want = {64: single_flushes + 2, 256: 1, 1024: 3}  # + 37 rows, + the malformed line's good one
    got = {int(k): v for k, v in stats["engine"]["bucket_hits"].items()}
    if got != want:
        raise AssertionError(f"serve: bucket_hits {got}, the requests imply {want}")
    if (set(stats) != SERVE_STATS_KEYS or set(stats["batcher"]) != SERVE_BATCHER_KEYS
            or set(stats["engine"]) != SERVE_ENGINE_KEYS or stats["errors"] != 1
            or stats["per_model"]["default"]["requests"] != stats["requests"]):
        raise AssertionError(f"serve: STATS departs from the JAX schema: {stats}")
    return {"singles": {"clients": SERVE_CLIENTS, "requests_per_client": SERVE_SINGLES,
                        "seconds": singles_s, "flushes": single_flushes,
                        "mean_requests_per_batch": coalesce["mean_requests_per_batch"]},
            "json": requests, "replies_vs_plain": check, "bucket_hits": got,
            "malformed_reply": bad, "stats": stats}


def _serve_side_engines(torch, ops, rng, w, cols_side, cols_wide, y) -> dict:
    """One 256-row JSON request each to an int8 and an int8_dot engine at
    D = 1M, one 64-row request to a bf16 engine at WIDE_D (above the slice
    kernels' width bound: lr_logits_row_blocks), each over its own server
    and against its plain forward."""
    from distlr_tpu_torch.serve import ScoringServer  # noqa: PLC0415

    out = {}
    cases = [("int8", FULL_D, w, cols_side), ("int8_dot", FULL_D, w, cols_side),
             ("bfloat16", WIDE_D, _serve_weights(rng, WIDE_D, cols_wide), cols_wide)]
    for fd, D, wk, cols in cases:
        eng = _serve_engine(torch, D, feature_dtype=fd)
        eng.set_weights(wk)
        with ScoringServer(eng, max_wait_ms=SERVE_WAIT_MS) as srv:
            labels, scores, seconds = _json_request(srv.host, srv.port,
                                                    _libsvm_lines(cols, y[:len(cols)]))
        z = _plain_logits(torch, ops, torch.from_numpy(wk).cuda(), cols, D, fd)
        name = "wide" if D == WIDE_D else fd
        out[name] = {"D": D, "feature_dtype": fd, "client_ms": 1e3 * seconds,
                     "bucket_hits": eng.stats()["bucket_hits"],
                     **_check_replies(torch, name, labels, scores, z)}
        del eng
    torch.cuda.empty_cache()
    return out


def _serve_checkpoint_swap(torch, rng, tmp: str, cols, y) -> dict:
    """Two checkpoints of the port's Checkpointer at D = 1M, the second
    written while a client streams a probe line: every reply is version
    1's or version 2's, none of version 1's after the first of version 2's,
    and no ERR."""
    from distlr_tpu_torch.serve import CheckpointWatcher, HotReloader, ScoringServer  # noqa: PLC0415
    from distlr_tpu_torch.train.checkpoint import Checkpointer  # noqa: PLC0415

    probe = _libsvm_lines(cols[:1], y[:1])[0]
    ws = [_serve_weights(rng, FULL_D, cols) for _ in range(2)]
    eng = _serve_engine(torch, FULL_D)
    want = []
    for w in ws:  # the reply each version gives the probe
        eng.set_weights(w)
        lab, sc = eng.score(eng.encode_lines([probe]))
        want.append(f"{int(lab[0])} {float(sc[0]):.6g}")
    if want[0] == want[1]:
        raise AssertionError(f"serve: the two checkpoints score the probe alike: {want}")
    eng = _serve_engine(torch, FULL_D)
    ck_dir = os.path.join(tmp, "ck")
    ck = Checkpointer(ck_dir)
    ck.save(1, ws[0])
    reloader = HotReloader(eng, CheckpointWatcher(ck_dir), interval_s=0.05)
    reloader.wait_for_weights(60)
    reloader.start()
    with ScoringServer(eng, max_wait_ms=SERVE_WAIT_MS, reloader=reloader) as srv:
        client = _StreamingProbe(srv.host, srv.port, probe)
        client.wait_for(20)
        t0 = time.perf_counter()
        ck.save(2, ws[1])
        while reloader.last_version != 2 and time.perf_counter() - t0 < 60:
            time.sleep(0.005)
        swap_s = time.perf_counter() - t0
        client.wait_for(len(client.replies) + 20)
        client.stop()
    got = client.replies
    first_v2 = got.index(want[1]) if want[1] in got else None
    if (client.errors or first_v2 is None or any(r not in want for r in got)
            or want[0] in got[first_v2:] or reloader.last_version != 2):
        raise AssertionError(f"serve checkpoint swap: {client.errors} {sorted(set(got))} "
                             f"(want {want}), version {reloader.last_version}")
    return {"replies": len(got), "version_1_replies": first_v2,
            "save_to_swap_s": swap_s, "reloads": reloader.reloads}


class _StreamingProbe:
    """A client streaming one line in a loop on one connection, keeping
    every reply (the witness of requests in flight across weight swaps)."""

    def __init__(self, host, port, line):
        self.replies: list[str] = []
        self.errors: list[str] = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, args=(host, port, line), daemon=True)
        self._t.start()

    def _run(self, host, port, line):
        import socket  # noqa: PLC0415

        try:
            with socket.create_connection((host, port), timeout=60) as s:
                f = s.makefile("rwb")
                while not self._stop.is_set():
                    f.write((line + "\n").encode())
                    f.flush()
                    reply = f.readline()
                    if not reply:
                        raise ConnectionError("server closed mid-stream")
                    self.replies.append(reply.decode().strip())
        except Exception as e:  # noqa: BLE001 — checked by the phase
            self.errors.append(f"{type(e).__name__}: {e}")

    def wait_for(self, n: int, timeout_s: float = 60.0) -> None:
        t0 = time.perf_counter()
        while len(self.replies) < n and not self.errors and time.perf_counter() - t0 < timeout_s:
            time.sleep(0.005)

    def stop(self) -> None:
        self._stop.set()
        self._t.join(timeout=60)


def _serve_live_ps(torch, rng, tmp: str, seed: int) -> dict:
    """A ServerGroup of 2 servers at D = 1M seeded with centred weights,
    one async ``run_ps_workers`` worker on the card pushing
    PS_ASYNC_BATCH-row gradients, and a client streaming a probe line
    through a live-PS hot-reloading server meanwhile: at least 2 reloads,
    at least 2 distinct served scores, no ERR (the worker's exit retires
    the servers; the polls that fail after it are counted, and the engine
    keeps its last weights).  Also the time of a full ``pull_chunked`` of
    the 1M weights."""
    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.ps import KVWorker, ServerGroup  # noqa: PLC0415
    from distlr_tpu_torch.serve import HotReloader, LivePSWatcher, ScoringServer  # noqa: PLC0415
    from distlr_tpu_torch.train.ps_trainer import run_ps_workers  # noqa: PLC0415

    import numpy as np  # noqa: PLC0415

    d = os.path.join(tmp, "psdata")
    _ps_data(d, seed)
    with open(os.path.join(d, "train", "part-001")) as f:
        shard = [ln.split() for ln in f if ln.strip()]
    probe = " ".join(shard[0])
    cols = np.array([[int(t.split(":")[0]) - 1 for t in row[1:]] for row in shard])
    w0 = _serve_weights(rng, FULL_D, cols)
    epochs = 8
    cfg = Config(data_dir=d, num_feature_dim=FULL_D, sync_mode=False, num_workers=1,
                 num_servers=PS_SERVERS, batch_size=PS_ASYNC_BATCH, num_iteration=epochs,
                 learning_rate=0.5, l2_c=0.0, test_interval=0, ps_timeout_ms=PS_TIMEOUT_MS)
    with ServerGroup(PS_SERVERS, 1, FULL_D, learning_rate=cfg.learning_rate, sync=False) as sg:
        with KVWorker(sg.hosts, FULL_D, client_id=1) as kv:
            kv.push_init(w0)  # the worker's own seeding push is then a no-op
        eng = _serve_engine(torch, FULL_D)
        watcher = LivePSWatcher(sg.hosts, FULL_D)
        pull_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            watcher.kv.pull_chunked(chunk_rows=watcher.chunk_rows)
            pull_ms.append(1e3 * (time.perf_counter() - t0))
        reloader = HotReloader(eng, watcher, interval_s=0.05)
        reloader.wait_for_weights(60)
        reloader.start()
        errors = []

        def train():
            try:
                run_ps_workers(cfg, sg.hosts, [0])
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        with ScoringServer(eng, max_wait_ms=SERVE_WAIT_MS, reloader=reloader) as srv:
            client = _StreamingProbe(srv.host, srv.port, probe)
            client.wait_for(5)
            t0 = time.perf_counter()
            trainer = threading.Thread(target=train, daemon=True, name="smoke-serve-ps")
            trainer.start()
            trainer.join(PS_WALL_S)
            train_s = time.perf_counter() - t0
            # rank 0's exit retires the servers: the reloader then keeps
            # the last weights it pulled, and the probe goes on scoring
            client.wait_for(len(client.replies) + 5, timeout_s=10)
            client.stop()
        if trainer.is_alive():
            raise AssertionError(f"serve live PS: the worker did not end within {PS_WALL_S} s")
    if errors:
        raise errors[0]
    scores = {r.split()[1] for r in client.replies if not r.startswith("ERR")}
    if (client.errors or any(r.startswith("ERR") for r in client.replies)
            or reloader.reloads < 2 or len(scores) < 2):
        raise AssertionError(f"serve live PS: {client.errors}, {len(client.replies)} replies, "
                             f"{len(scores)} distinct scores, {reloader.reloads} reloads")
    return {"servers": PS_SERVERS, "worker_steps": epochs * -(-PS_SHARD_ROWS // PS_ASYNC_BATCH),
            "train_s": train_s, "replies": len(client.replies),
            "distinct_scores": len(scores), "reloads": reloader.reloads,
            "reload_errors": reloader.errors, "pull_chunked_1M_ms": pull_ms,
            "chunk_rows": watcher.chunk_rows}


def _serve_eviction(torch, w, cols) -> dict:
    """``maybe_evict`` on an idle engine: not resident, the device table's
    bytes freed, and the next request reloads it and scores the same bits."""
    import numpy as np  # noqa: PLC0415

    eng = _serve_engine(torch, FULL_D, idle_evict_s=3600.0)
    eng.set_weights(w)
    rows = eng.encode_lines(_libsvm_lines(cols, np.zeros(len(cols))))
    before = eng.score(rows)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    if not eng.maybe_evict(now=time.monotonic() + 1e4) or eng.resident:
        raise AssertionError("serve: an idle engine did not evict its table")
    freed = held - torch.cuda.memory_allocated()
    after = eng.score(rows)
    if (freed < FULL_D * 4 or not eng.resident or not np.array_equal(before[0], after[0])
            or not np.array_equal(before[1], after[1])):
        raise AssertionError(f"serve eviction: freed {freed} bytes, resident {eng.resident}, "
                             "or the reloaded table scores other bits")
    return {"freed_bytes": freed, "evictions": eng.evictions, "same_bits_after_reload": True}


def _serve_breakdown(torch, srv, eng, cols, y) -> dict:
    """Where a request's time goes, per bucket (a request of the bucket's
    size): ``encode_ms`` (host parse and densify), ``cast_ms`` (host f32 ->
    bf16), ``h2d_ms`` (the zeroed bucket on the card and the copy),
    ``forward_span_ms`` (CUDA events around the engine's forward: the
    ``lr_logits`` launch with its host-side plan and call, σ and the
    labels), ``reply_ms`` (read-back and the JSON reply), and
    ``request_ms``, the client's wall time of the same JSON request."""
    out = {}
    w = eng._weights
    lo = 0
    for b in SERVE_BUCKETS:
        lines = _libsvm_lines(cols[lo:lo + b], y[lo:lo + b])
        lo += b
        t0 = time.perf_counter()
        (X,) = eng.encode_lines(lines)
        t1 = time.perf_counter()
        src = torch.from_numpy(X).to(torch.bfloat16)
        t2 = time.perf_counter()
        buf = torch.zeros((b, X.shape[1]), dtype=torch.bfloat16, device="cuda")
        buf[:b].copy_(src)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        labels, scores = eng._forward(w, (buf,))
        end.record()
        end.synchronize()
        t4 = time.perf_counter()
        json.dumps({"labels": [int(v) for v in labels.cpu().numpy()],
                    "scores": [round(float(v), 6) for v in scores.cpu().numpy()]})
        t5 = time.perf_counter()
        _, _, seconds = _json_request(srv.host, srv.port, lines)
        out[f"B{b}"] = {"encode_ms": 1e3 * (t1 - t0), "cast_ms": 1e3 * (t2 - t1),
                        "h2d_ms": 1e3 * (t3 - t2), "forward_span_ms": start.elapsed_time(end),
                        "forward_host_ms": 1e3 * (t4 - t3), "reply_ms": 1e3 * (t5 - t4),
                        "request_ms": 1e3 * seconds}
        del X, src, buf
    return out


def _serve_kernel_shapes(torch, ops, w, cols) -> dict:
    """``lr_logits`` at the serving buckets (64, 256, 1,024 rows x 1M, bf16),
    its int8 instance and ``lr_logits_int8dot`` at 1,024 rows, against
    their plain versions (REL_TOL) and timed: ``ms`` (25 back-to-back
    calls between CUDA events), ``plain_ms``, ``library_ms`` (``torch.mv``;
    for int8 X the composite of earlier phases) and ``bound_ms``; the
    bf16 kernel and ``torch.mv`` are timed twice, alternating, the second
    pair under ``repeat``."""
    from distlr_tpu_torch.ops import fused_lr  # noqa: PLC0415

    reps, out = 25, {}
    wd = torch.from_numpy(w).cuda()
    wb = wd.to(torch.bfloat16)
    s = SERVE_INT8_SCALE
    for b in SERVE_BUCKETS:
        X = _device_rows(torch, cols[:b], FULL_D, torch.bfloat16)
        z, z_ref = ops.lr_logits(wd, X), ops.lr_logits_reference(wd, X)
        bound_ms, bound_by = _logits_bound(b, FULL_D, 2)
        out[f"lr_logits_B{b}"] = {
            "rel_err": rel_err(z, z_ref), "max_abs_err": float((z - z_ref).abs().max()),
            "ms": time_ms(lambda: ops.lr_logits(wd, X), reps),
            "library_ms": time_ms(lambda: torch.mv(X, wb), reps),
            "repeat": {"ms": time_ms(lambda: ops.lr_logits(wd, X), reps),
                       "library_ms": time_ms(lambda: torch.mv(X, wb), reps)},
            "plain_ms": time_ms(lambda: ops.lr_logits_reference(wd, X), reps),
            "plan": _plan_fields(fused_lr.launch_plan_for(X, kernel="logits")),
            "bound_ms": bound_ms, "bound_by": bound_by}
        del X
    b = SERVE_BUCKETS[-1]
    Xq = _device_rows(torch, cols[:b], FULL_D, torch.int8, round(1.0 / s))
    bound_ms, bound_by = _logits_bound(b, FULL_D, 1)
    for name, fn, ref in (
            ("lr_logits_int8", lambda: ops.lr_logits(wd, Xq, feature_scale=s),
             lambda: ops.lr_logits_reference(wd, Xq, feature_scale=s)),
            ("lr_logits_int8dot", lambda: ops.lr_logits_int8dot(wd, Xq, feature_scale=s),
             lambda: ops.lr_logits_int8dot_reference(wd, Xq, feature_scale=s))):
        z, z_ref = fn(), ref()
        out[f"{name}_B{b}"] = {
            "rel_err": rel_err(z, z_ref), "max_abs_err": float((z - z_ref).abs().max()),
            "ms": time_ms(fn, reps), "plain_ms": time_ms(ref, reps),
            "library_ms": time_ms(lambda: torch.mv(Xq.to(torch.bfloat16), wb) * s, reps),
            "library_note": "no single call: the composite X.to(bf16) + mv",
            "bound_ms": bound_ms, "bound_by": bound_by}
    del Xq
    torch.cuda.empty_cache()
    bad = {k: v["rel_err"] for k, v in out.items() if v["rel_err"] > REL_TOL}
    if bad:
        raise AssertionError(f"serve: kernels disagree with their plain versions at the "
                             f"serving shapes: {bad}")
    return out


def phase_serve(torch, seed: int, smi: str) -> dict:
    """The scoring tier at the full width, through the entry points a user
    calls: ``ScoringEngine`` (dense binary_lr, D = 1M, bf16 products,
    buckets 64 / 256 / 1,024) behind an in-process ``ScoringServer``,
    with the launch counts zeroed just before its traffic and read just
    after the int8, int8_dot and wide engines' requests, the checkpoint and
    live-PS hot reloads and the eviction; then the kernels at the serving
    shapes and the per-bucket time breakdown (launches made there come
    after the counts were read)."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.serve import ScoringServer  # noqa: PLC0415

    rng = np.random.default_rng(seed + 10)
    w_true = (rng.standard_normal(FULL_D) * 0.5).astype(np.float32)
    n_main = SERVE_CLIENTS * SERVE_SINGLES + sum(SERVE_JSON_ROWS)
    cols, y = _ctr_cols(rng, n_main, w_true, FULL_D)
    cols_wide, _ = _ctr_cols(rng, SERVE_WIDE_ROWS, np.zeros(WIDE_D, np.float32), WIDE_D)
    w = _serve_weights(rng, FULL_D, cols)
    out, rss = {"nvidia_smi": smi, "D": FULL_D, "wide_D": WIDE_D,
                "buckets": list(SERVE_BUCKETS), "max_wait_ms": SERVE_WAIT_MS}, {}
    t_phase = time.perf_counter()
    with _sampled_peak_rss(rss), tempfile.TemporaryDirectory(prefix="distlr-smoke-serve-") as tmp:
        t0 = time.perf_counter()
        eng = _serve_engine(torch, FULL_D)
        eng.set_weights(w)
        out["engine_start_s"] = time.perf_counter() - t0
        ops.reset_launch_counts()
        with ScoringServer(eng, max_wait_ms=SERVE_WAIT_MS) as srv:
            traffic = _serve_traffic(torch, ops, srv, torch.from_numpy(w).cuda(), cols, y)
            out["side_engines"] = _serve_side_engines(
                torch, ops, rng, w, cols[:SERVE_SIDE_ROWS], cols_wide, y)
            out["checkpoint_swap"] = _serve_checkpoint_swap(torch, rng, tmp, cols, y)
            out["eviction"] = _serve_eviction(torch, w, cols[:64])
            torch.cuda.synchronize()
            launches = {k: v for k, v in _launches(ops).items() if v}
            missing = [k for k in SERVE_KERNELS if not launches.get(k)]
            others = sorted(set(launches) - set(SERVE_KERNELS))
            if missing or others:
                raise AssertionError(f"serve: the path launched {launches}: missing "
                                     f"{missing}, unexpected {others}")
            # the live-PS reload counts apart: its worker trains on the card
            ops.reset_launch_counts()
            live = _serve_live_ps(torch, rng, tmp, seed)
            torch.cuda.synchronize()
            live["launches"] = {k: v for k, v in _launches(ops).items() if v}
            if (live["launches"].get("fused_lr_grad") != live["worker_steps"]
                    or not live["launches"].get("lr_logits")
                    or set(live["launches"]) != {"fused_lr_grad", "lr_logits"}):
                raise AssertionError(f"serve live PS: not one fused_lr_grad a worker step and "
                                     f"lr_logits for the probe: {live['launches']}")
            out["live_ps"] = live
            out["breakdown"] = _serve_breakdown(torch, srv, eng, cols, y)
        stats = traffic.pop("stats")
        out.update(traffic)
        out["kernels_at_serve_shapes"] = _serve_kernel_shapes(torch, ops, w, cols)
    out.update({"p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"], "qps": stats["qps"],
                "requests": stats["requests"], "errors": stats["errors"],
                "mean_occupancy": stats["batcher"]["mean_occupancy"],
                "mean_requests_per_batch": stats["batcher"]["mean_requests_per_batch"],
                "launches": launches, **rss, "phase_s": time.perf_counter() - t_phase,
                "reduced": {"traffic": "a few thousand requests (a smoke test, not a load "
                                       "test); the weights are random, made from the seed"}})
    del eng
    torch.cuda.empty_cache()
    emit("serve", **out)
    return out


# --- the keyed parameter-server path -----------------------------------------
# config 4's shape (SPARSE_*: D = 1M buckets, 21 fields, vocab 1e7) on the
# PS path: 2 servers, 2 worker threads on the card, 1,024-row batches
KEYED_FAMILIES = ("sparse_lr", "sparse_softmax", "blocked_lr")
KEYED_SHARD_ROWS, KEYED_BATCH, KEYED_EPOCHS, KEYED_TEST_ROWS = 16_384, 1024, 3, 8192
KEYED_BLOCK = 16
# rows drawn from this many distinct field tuples: features recur across
# 41k rows, as a day of real CTR logs' do (i.i.d. ids over a vocab of 1e7
# would almost never repeat, and no held-out row could be scored better
# than the init)
KEYED_TUPLES = 8192
# the card's keyed eval against the numpy one on the same final weights
KEYED_EVAL_TOL = 1e-5


def _keyed_data(tmp: str, family: str, seed: int) -> str:
    """A family's data dir: two train shards of KEYED_SHARD_ROWS rows and
    KEYED_TEST_ROWS test rows at config 4's shape, hashed one-hot libsvm
    (binary labels, or SPARSE_K classes from a planted (D, K) table) or
    raw CTR rows (blocked_lr)."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.data import hashing  # noqa: PLC0415

    d = os.path.join(tmp, family)
    n = 2 * KEYED_SHARD_ROWS + KEYED_TEST_ROWS
    if family == "blocked_lr":
        hashing.write_raw_ctr_shards(d, n, SPARSE_FIELDS, SPARSE_VOCAB, 2, seed=seed,
                                     test_fraction=KEYED_TEST_ROWS / n,
                                     num_distinct_tuples=KEYED_TUPLES)
        return d
    _, cols, _, y, _ = hashing.make_ctr_dataset(n, SPARSE_FIELDS, SPARSE_VOCAB, SPARSE_D,
                                                seed=seed, num_distinct_tuples=KEYED_TUPLES)
    if family == "sparse_softmax":
        rng = np.random.default_rng(seed + 1)
        w_true = rng.standard_normal((SPARSE_D, SPARSE_K)).astype(np.float32)
        y = np.argmax(w_true[cols].sum(axis=1) + rng.gumbel(size=(n, SPARSE_K)), axis=1)
    for split, part, sl in (("test", 1, slice(0, KEYED_TEST_ROWS)),
                            ("train", 1, slice(KEYED_TEST_ROWS,
                                               KEYED_TEST_ROWS + KEYED_SHARD_ROWS)),
                            ("train", 2, slice(KEYED_TEST_ROWS + KEYED_SHARD_ROWS, n))):
        os.makedirs(os.path.join(d, split), exist_ok=True)
        with open(os.path.join(d, split, f"part-{part:03d}"), "w") as f:
            for row, label in zip(cols[sl].tolist(), y[sl].tolist()):
                c, k = np.unique(row, return_counts=True)  # collisions add
                f.write(f"{label} " + " ".join(f"{a + 1}:{b}" for a, b in zip(c, k)) + "\n")
    return d


def _keyed_cfg(data_dir: str, family: str):
    from distlr_tpu_torch.config import Config  # noqa: PLC0415

    return Config(data_dir=data_dir, model=family, num_feature_dim=SPARSE_D,
                  num_classes=SPARSE_K, block_size=KEYED_BLOCK, ctr_fields=SPARSE_FIELDS,
                  num_workers=PS_WORKERS, num_servers=PS_SERVERS, batch_size=KEYED_BATCH,
                  num_iteration=KEYED_EPOCHS, test_interval=1, learning_rate=0.5, l2_c=0.0,
                  ps_timeout_ms=PS_TIMEOUT_MS)


def _keyed_slice(cfg, split: str, batch_size: int, w_flat) -> tuple:
    """The first batch of a split's first shard as a keyed round hands it
    to the gradient: ``(w_u, pos, *leaves, y, mask)``, ``w_u`` the batch's
    unique rows gathered from the flat weights ``w_flat``."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.train import ps_trainer  # noqa: PLC0415

    path = os.path.join(cfg.data_dir, split, "part-001")
    ids, *rest = ps_trainer.load_ps_iter(cfg, path, batch_size).next_batch()
    ub, pos = np.unique(ids, return_inverse=True)
    table = (w_flat if cfg.model == "sparse_lr"
             else w_flat.reshape(-1, ps_trainer.keyed_row_width(cfg)))
    return (np.ascontiguousarray(table[ub]), pos.reshape(ids.shape), *rest)


def _keyed_numpy_eval(cfg, w_flat) -> tuple[float, float]:
    """``(accuracy, logloss)`` of flat PS weights on the test split, by
    host numpy: the test rows' unique keys gathered from the weights."""
    from distlr_tpu_torch.train import ps_trainer  # noqa: PLC0415

    w_u, pos, vals, y, mask = _keyed_slice(cfg, "test", -1, w_flat)
    return ps_trainer._dense_eval_from_logits(
        ps_trainer._keyed_logits(w_u, pos, vals, cfg.model), y, mask,
        SPARSE_K if cfg.model == "sparse_softmax" else None)


def _keyed_grad_inputs(torch, cfg, w_flat):
    """Worker 0's first batch as its keyed round gives it to the gradient:
    ``(numpy args, the same on the card, numpy fn, torch fn, l2 args)``."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.train import ps_trainer  # noqa: PLC0415

    args = _keyed_slice(cfg, "train", KEYED_BATCH, w_flat)
    dev = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in args]
    return (args, dev, *ps_trainer._KEYED_GRADS[cfg.model],
            (cfg.l2_c, bool(cfg.l2_scale_by_batch)))


def _keyed_grad_probe(torch, cfg, w_flat) -> dict:
    """One keyed gradient at the path's shape (worker 0's first batch, its
    unique rows gathered from ``w_flat``): the CUDA kernels of one call,
    its device time, the copies' host round trip, and the numpy
    function's host time on the same batch."""
    import numpy as np  # noqa: PLC0415

    args, dev, np_fn, torch_fn, l2 = _keyed_grad_inputs(torch, cfg, w_flat)
    ub = args[0]
    g_card = torch_fn(*dev, *l2).cpu().numpy()
    g_np = np_fn(*args, *l2)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        np_fn(*args, *l2)
    numpy_ms = 1e3 * (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        torch_fn(*(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in args),
                 *l2).cpu()
    host_ms = 1e3 * (time.perf_counter() - t0) / reps
    return {"unique_rows": int(ub.shape[0]), "batch_rows": KEYED_BATCH,
            "rel_err_vs_numpy": float(np.abs(g_card - g_np).max()
                                      / max(np.abs(g_np).max(), 1e-30)),
            "device_ms": time_ms(lambda: torch_fn(*dev, *l2), reps),
            "copy_call_readback_ms": host_ms, "numpy_grad_ms": numpy_ms,
            **_step_kernels(torch, lambda: torch_fn(*dev, *l2))}


def _keyed_round_fields(report: dict) -> dict:
    keys = ("steps", "round_ms", "prep_ms", "pull_ms", "grad_ms", "push_ms", "grad_span_ms",
            "vals_per_key", "keyed_rows_per_round", "wire_bytes_per_round")
    return {k: report.get(k) for k in keys}


def phase_ps_keyed(torch, seed: int, smi: str) -> dict:
    """The keyed PS families at config 4's width through ``run_ps_local``:
    PS_SERVERS native servers, PS_WORKERS worker threads on the card,
    KEYED_BATCH-row batches, KEYED_EPOCHS epochs, for ``sparse_lr``,
    ``sparse_softmax`` (K = SPARSE_K: 10M keys) and ``blocked_lr`` (R =
    KEYED_BLOCK over raw CTR shards).  Sync: the workers' final weights
    agree within 1e-5 and within FAMILY_TOL of the same run on the numpy
    backend, the servers count one push a worker and step, rank 0's
    reported test logloss is the numpy keyed eval's on the final weights,
    and it falls below the init's.  Async: the push count, finite weights,
    the logloss below the init's.  The wide families take vals_per_key
    rows.  Each run's launch counts are zeroed just before and read just
    after: no kernel of ``ops`` is on this path (gathers, σ and
    ``index_add_``)."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.models import get_model  # noqa: PLC0415
    from distlr_tpu_torch.train.ps_trainer import keyed_row_width  # noqa: PLC0415

    out = {"nvidia_smi": smi, "D": SPARSE_D, "fields": SPARSE_FIELDS, "vocab": SPARSE_VOCAB,
           "workers": PS_WORKERS, "servers": PS_SERVERS, "shard_rows": KEYED_SHARD_ROWS,
           "batch_rows": KEYED_BATCH, "epochs": KEYED_EPOCHS, "test_rows": KEYED_TEST_ROWS,
           "distinct_tuples": KEYED_TUPLES,
           "reduced": {"epochs": f"{KEYED_EPOCHS} (cut in depth)",
                       "shard_rows": f"{KEYED_SHARD_ROWS} a worker (cut: a few minutes of a "
                                     "CTR stream, not a day)",
                       "rows": f"drawn from {KEYED_TUPLES} distinct field tuples, so "
                               "features recur; the weights start from zeros"}}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="distlr-smoke-keyed-") as tmp:
        for family in KEYED_FAMILIES:
            t0 = time.perf_counter()
            d = _keyed_data(tmp, family, seed)
            cfg = _keyed_cfg(d, family)
            line = {"data_write_s": time.perf_counter() - t0}
            w0 = get_model(cfg).init(cfg).numpy().reshape(-1)
            _, init_ll = _keyed_numpy_eval(cfg, w0)
            line["test_logloss_init"] = init_ll
            # load this gradient's kernels before the timed runs: the first
            # call of each costs ~1 s, which a mean of 48 rounds would carry
            _, dev, _, torch_fn, l2 = _keyed_grad_inputs(torch, cfg, w0)
            torch_fn(*dev, *l2).cpu()
            del dev
            steps = KEYED_EPOCHS * -(-KEYED_SHARD_ROWS // KEYED_BATCH)
            for mode, run_cfg in (("sync", cfg), ("async", cfg.replace(sync_mode=False)),
                                  ("sync_numpy", cfg.replace(ps_compute_backend="numpy"))):
                weights, report, launches, seconds = _run_ps(torch, run_cfg, save=False)
                if any(launches.values()):
                    raise AssertionError(f"ps_keyed {family} {mode}: launched a kernel of "
                                         f"ops: {launches}")
                r0 = report[0]
                if not all(r["steps"] == steps for r in report.values()):
                    raise AssertionError(f"ps_keyed {family} {mode}: steps {report}")
                pushes = r0["group_pushes"] - 1  # less the seeding push
                if pushes != PS_WORKERS * steps:
                    raise AssertionError(f"ps_keyed {family} {mode}: the servers counted "
                                         f"{pushes} gradient pushes, not {PS_WORKERS * steps}")
                if r0["vals_per_key"] != keyed_row_width(cfg):
                    raise AssertionError(f"ps_keyed {family}: the wire took vals_per_key="
                                         f"{r0['vals_per_key']}, not {keyed_row_width(cfg)}")
                run = {"seconds": seconds, "gradient_pushes": pushes,
                       "workers": [_keyed_round_fields(report[r]) for r in range(PS_WORKERS)],
                       "test_logloss_reported": r0["test_logloss"]}
                if not all(np.isfinite(w).all() for w in weights):
                    raise AssertionError(f"ps_keyed {family} {mode}: weights not finite")
                _, run["test_logloss_final_numpy"] = _keyed_numpy_eval(run_cfg, weights[0])
                if not run["test_logloss_final_numpy"] < init_ll:
                    raise AssertionError(f"ps_keyed {family} {mode}: test logloss "
                                         f"{run['test_logloss_final_numpy']} not below the "
                                         f"init's {init_ll}")
                if mode != "async":
                    run["workers_max_abs_diff"] = float(np.abs(weights[0] - weights[1]).max())
                    if run["workers_max_abs_diff"] > 1e-5:
                        raise AssertionError(f"ps_keyed {family} {mode}: the workers' weights "
                                             f"differ by {run['workers_max_abs_diff']}")
                    # rank 0's last eval ran on the final weights (the round ended)
                    ll = run["test_logloss_final_numpy"]
                    if abs(run["test_logloss_reported"] - ll) > KEYED_EVAL_TOL * abs(ll):
                        raise AssertionError(f"ps_keyed {family} {mode}: rank 0 reported "
                                             f"{run['test_logloss_reported']}, numpy's eval "
                                             f"gives {ll}")
                if mode == "sync":
                    sync_w = weights[0]
                elif mode == "sync_numpy":
                    run["weights_rel_err_vs_numpy"] = rel_err(torch.from_numpy(sync_w),
                                                              torch.from_numpy(weights[0]))
                    if run["weights_rel_err_vs_numpy"] > FAMILY_TOL[family]:
                        raise AssertionError(f"ps_keyed {family}: card weights differ from the "
                                             f"numpy backend's: rel "
                                             f"{run['weights_rel_err_vs_numpy']}")
                line[mode] = run
            line["gradient_at_path_shape"] = _keyed_grad_probe(torch, cfg, sync_w)
            line["tolerance"] = FAMILY_TOL[family]
            out[family] = line
            del weights, sync_w
    out["phase_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    emit("ps_keyed", **out)
    return out


# --- the PS update rules and the gradient wire ---------------------------------
# FTRL as tests/test_ftrl.py runs it; signSGD at a signSGD-scale rate; an
# accumulation span that grows within the async run's 6 batches a worker
WIRE_FTRL = {"ftrl_alpha": 0.5, "ftrl_beta": 1.0, "ftrl_l1": 0.01, "ftrl_l2": 0.1}
# epochs of the sync runs (dense f32, int8, signSGD) and of the FTRL and
# async runs: cut in depth from 2 and 3 to make room for ps_elastic
WIRE_SIGN_LR, WIRE_EPOCHS, WIRE_LONG_EPOCHS = 0.02, 1, 2
WIRE_ACCUM = {"ps_accum_start": 1, "ps_accum_max": 4, "ps_accum_growth_every": 2}
# keyed FTRL without L1: at a keyed row's gradient (~1e-3 a batch) an L1
# of 0.01 would hold nearly every weight at zero, and the card-vs-numpy
# comparison with it
WIRE_KEYED_FTRL = {**WIRE_FTRL, "ftrl_l1": 0.0}
WIRE_FTRL_TOL, WIRE_PLAIN_TOL, WIRE_INT8_TOL, WIRE_KEYED_TOL = 1e-5, 1e-3, 1e-5, 1e-4
WIRE_INT8_MIN_RATIO, WIRE_SIGN_MIN_RATIO = 8.0, 32.0
# namespace pushes into the `launch ps-server` group, a namespace
WIRE_NS_PUSHES, WIRE_NS_LR = 3, 0.2
WIRE_PUSH_REPS = 10


class _FtrlOracle:
    """float32 FTRL-Proximal, ``tests/test_ftrl.py``'s oracle with its z and n
    kept between steps: a zero gradient leaves its coordinate untouched."""

    def __init__(self, w0, alpha, beta, l1, l2):
        import numpy as np  # noqa: PLC0415

        self.w = np.array(w0, np.float32).copy()
        self.z, self.n = np.zeros_like(self.w), np.zeros_like(self.w)
        self.a, self.b, self.l1, self.l2 = (np.float32(v) for v in (alpha, beta, l1, l2))

    def step(self, g):
        import numpy as np  # noqa: PLC0415

        g = np.asarray(g, np.float32)
        touched = g != 0
        n_new = (self.n + g * g).astype(np.float32)
        sigma = ((np.sqrt(n_new) - np.sqrt(self.n)) / self.a).astype(np.float32)
        self.z = np.where(touched, (self.z + g - sigma * self.w).astype(np.float32), self.z)
        self.n = np.where(touched, n_new, self.n)
        w_new = np.where(np.abs(self.z) <= self.l1, np.float32(0.0),
                         (-(self.z - np.sign(self.z) * self.l1)
                          / ((self.b + np.sqrt(self.n)) / self.a + self.l2)).astype(np.float32))
        self.w = np.where(touched, w_new, self.w).astype(np.float32)
        return self.w


@contextlib.contextmanager
def _spawned_commands():
    """The command lines of the KV servers spawned in the block."""
    from distlr_tpu_torch.ps.server import ServerGroup  # noqa: PLC0415

    seen, orig = [], ServerGroup._command

    def spy(self, *a, **kw):
        seen.append(orig(self, *a, **kw))
        return seen[-1]

    ServerGroup._command = spy
    try:
        yield seen
    finally:
        ServerGroup._command = orig


def _wire_grads(torch, ops, model, cfg, w, shards, *, plain: bool):
    """Each worker's gradient at ``w`` on its full shard, as numpy: the
    model's own (one ``fused_lr_grad`` launch, what the workers ran) or the
    plain version's sum / n + the L2 term."""
    wd = torch.from_numpy(w).cuda()
    out = []
    for X, y in shards:
        mask = torch.ones(X.shape[0], device="cuda")
        if plain:
            g = (ops.fused_lr_grad_reference(wd, X, y, mask, compute_dtype="bfloat16")
                 / mask.sum() + cfg.l2_c * wd)
        else:
            g = model.grad(wd, (X, y, mask), cfg)
        out.append(g.cpu().numpy())
    return out


def _replay(torch, ops, model, cfg, w0, shards, steps, update, *, plain: bool):
    """The BSP trajectory of ``steps`` rounds on full shards: the workers'
    gradients at the oracle's weights, then ``update(w, grads)``."""
    w, all_grads = w0, []
    for _ in range(steps):
        grads = _wire_grads(torch, ops, model, cfg, w, shards, plain=plain)
        all_grads.append(grads)
        w = update(w, grads)
    return w, all_grads


def _slices(g, servers: int):
    """``g`` cut at the group's range boundaries: one coded frame a server."""
    n = g.shape[0]
    return [g[n * r // servers:n * (r + 1) // servers] for r in range(servers)]


def _wire_round_fields(report: dict) -> dict:
    keys = ("steps", "round_ms", "grad_ms", "pull_ms", "push_pull_ms", "push_ms",
            "grad_span_ms", "compress_active", "push_bytes_raw", "push_bytes_wire",
            "compress_ratio", "accum_flushes", "accum_k")
    return {k: report.get(k) for k in keys}


def _wire_dense_runs(torch, ops, tmp: str, smi: str) -> tuple[dict, dict]:
    """The dense runs of the phase on the ps phase's data: sync FTRL, sync
    SGD dense f32 and int8, sync signSGD, async int8 with accumulation;
    ``(lines, launches)``."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.compress import GradientAccumulator, int8_roundtrip  # noqa: PLC0415
    from distlr_tpu_torch.compress import sign_roundtrip  # noqa: PLC0415
    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.data import parse_libsvm_file  # noqa: PLC0415
    from distlr_tpu_torch.models import get_model  # noqa: PLC0415

    base = Config(data_dir=tmp, num_feature_dim=FULL_D, num_workers=PS_WORKERS,
                  num_servers=PS_SERVERS, batch_size=PS_SHARD_ROWS, num_iteration=WIRE_EPOCHS,
                  test_interval=1, learning_rate=0.2, l2_c=0.01, compat_mode="correct",
                  compute_dtype="bfloat16", ps_timeout_ms=PS_TIMEOUT_MS)
    model = get_model(base)
    w0 = model.init(base).numpy()
    shards = []
    for part in range(1, PS_WORKERS + 1):
        X, y = parse_libsvm_file(os.path.join(tmp, "train", f"part-{part:03d}"), FULL_D)
        shards.append((torch.from_numpy(X).to(torch.bfloat16).cuda(), torch.from_numpy(y).cuda()))
        del X
    Xt, yt = parse_libsvm_file(os.path.join(tmp, "test", "part-001"), FULL_D)
    Xt = torch.from_numpy(Xt).to(torch.bfloat16).cuda()
    yt = torch.from_numpy(yt).float().cuda()
    init_ll = _test_logloss(torch, ops, torch.from_numpy(w0).cuda(), Xt, yt)
    lr, two = np.float32(base.learning_rate), np.float32(PS_WORKERS)

    def sgd_int8(w, grads):
        dec = [np.concatenate([int8_roundtrip(s) for s in _slices(g, PS_SERVERS)]) for g in grads]
        return (w - lr * sum(dec[1:], dec[0]) / two).astype(np.float32)

    def sign_vote(w, grads):
        votes = sum((sign_roundtrip(g) for g in grads[1:]), sign_roundtrip(grads[0]))
        step = np.float32(WIRE_SIGN_LR)
        return np.where(votes > 0, w - step, np.where(votes < 0, w + step, w)).astype(np.float32)

    def ftrl_oracle():
        orc = _FtrlOracle(w0, *(WIRE_FTRL[k] for k in ("ftrl_alpha", "ftrl_beta", "ftrl_l1",
                                                       "ftrl_l2")))
        return lambda w, grads: orc.step(sum(grads[1:], grads[0]) / two)

    runs = {
        "ftrl_sync": (base.replace(ps_optimizer="ftrl", num_iteration=WIRE_LONG_EPOCHS,
                                   **WIRE_FTRL),
                      None),
        "none_sync": (base, None),
        "int8_sync": (base.replace(ps_compress="int8"), sgd_int8),
        "signsgd_sync": (base.replace(ps_compress="signsgd", learning_rate=WIRE_SIGN_LR),
                         sign_vote),
        "int8_accum_async": (base.replace(ps_compress="int8", sync_mode=False,
                                          batch_size=PS_ASYNC_BATCH,
                                          num_iteration=WIRE_LONG_EPOCHS, **WIRE_ACCUM), None),
    }
    lines, launches = {}, {"fused_lr_grad": 0, "lr_logits": 0}
    for mode, (cfg, update) in runs.items():
        with _spawned_commands() as cmds:
            weights, report, counts, seconds = _run_ps(torch, cfg, save=False)
        steps = cfg.num_iteration * -(-PS_SHARD_ROWS // cfg.batch_size)
        others = {k: v for k, v in counts.items() if v and k not in launches}
        if (counts["fused_lr_grad"] != PS_WORKERS * steps
                or counts["lr_logits"] != cfg.num_iteration or others):
            raise AssertionError(f"ps_wire {mode}: not one fused_lr_grad a worker and batch "
                                 f"and one lr_logits an eval: {counts}")
        for k in launches:
            launches[k] += counts[k]
        want_codec = cfg.ps_compress
        if any(r["compress_active"] != want_codec for r in report.values()):
            raise AssertionError(f"ps_wire {mode}: the workers pushed "
                                 f"{[r['compress_active'] for r in report.values()]}, "
                                 f"not {want_codec!r}")
        line = {"seconds": seconds, "epochs": cfg.num_iteration, "batch_rows": cfg.batch_size,
                "server_optimizer_flags": sorted({a for c in cmds for a in c
                                                  if a.startswith("--optimizer")}),
                "launches": {k: v for k, v in counts.items() if v},
                "workers": [_wire_round_fields(report[r]) for r in range(PS_WORKERS)]}
        ratio = report[0]["compress_ratio"]
        if not all(np.isfinite(w).all() for w in weights):
            raise AssertionError(f"ps_wire {mode}: weights not finite")
        if cfg.sync_mode:
            line["workers_max_abs_diff"] = float(np.abs(weights[0] - weights[1]).max())
            if line["workers_max_abs_diff"] != 0.0:
                raise AssertionError(f"ps_wire {mode}: the workers' weights differ by "
                                     f"{line['workers_max_abs_diff']}")
        w = torch.from_numpy(weights[0])
        if mode == "ftrl_sync":
            w_k, grads_k = _replay(torch, ops, model, cfg, w0, shards, steps, ftrl_oracle(),
                                   plain=False)
            w_p, _ = _replay(torch, ops, model, cfg, w0, shards, steps, ftrl_oracle(),
                             plain=True)
            line["weights_rel_err_vs_oracle_kernel_grads"] = rel_err(w, torch.from_numpy(w_k))
            line["weights_rel_err_vs_oracle_plain_grads"] = rel_err(w, torch.from_numpy(w_p))
            if (line["weights_rel_err_vs_oracle_kernel_grads"] > WIRE_FTRL_TOL
                    or line["weights_rel_err_vs_oracle_plain_grads"] > WIRE_PLAIN_TOL):
                raise AssertionError(f"ps_wire ftrl: weights differ from the FTRL oracle: {line}")
            if line["server_optimizer_flags"] != ["--optimizer=ftrl"]:
                raise AssertionError(f"ps_wire ftrl: the group ran {cmds}")
            line["zero_weights_share"] = float((weights[0] == 0).mean())
        elif mode == "int8_sync":
            w_k, _ = _replay(torch, ops, model, cfg, w0, shards, steps, update, plain=False)
            line["weights_rel_err_vs_oracle"] = rel_err(w, torch.from_numpy(w_k))
            if line["weights_rel_err_vs_oracle"] > WIRE_INT8_TOL or ratio < WIRE_INT8_MIN_RATIO:
                raise AssertionError(f"ps_wire int8: rel {line['weights_rel_err_vs_oracle']} "
                                     f"vs the decoded-mean oracle, byte ratio {ratio}")
        elif mode == "signsgd_sync":
            w_k, grads_k = _replay(torch, ops, model, cfg, w0, shards, steps, update,
                                   plain=False)
            line["equals_vote_oracle"] = bool(np.array_equal(weights[0], w_k))
            # the sign the kernel's gradient and the plain one give each
            # coordinate, at the same weights (the oracle's, round by round)
            flips, w_r = [], w0
            for grads in grads_k:
                plain = _wire_grads(torch, ops, model, cfg, w_r, shards, plain=True)
                flips += [float(((a > 0) != (b > 0)).mean()) for a, b in zip(grads, plain)]
                w_r = update(w_r, grads)
            line["sign_differs_kernel_vs_plain_share"] = {"max": max(flips),
                                                          "mean": float(np.mean(flips))}
            if not line["equals_vote_oracle"] or ratio < WIRE_SIGN_MIN_RATIO:
                raise AssertionError(f"ps_wire signsgd: weights equal the vote oracle: "
                                     f"{line['equals_vote_oracle']}, byte ratio {ratio}")
            if line["server_optimizer_flags"] != ["--optimizer=signsgd"]:
                raise AssertionError(f"ps_wire signsgd: the group ran {cmds}")
        elif mode == "int8_accum_async":
            flushes = []
            for _ in range(PS_WORKERS):
                acc = GradientAccumulator(1, start=cfg.ps_accum_start,
                                          growth=cfg.ps_accum_growth,
                                          growth_every=cfg.ps_accum_growth_every,
                                          max_k=cfg.ps_accum_max)
                for _ in range(cfg.num_iteration):
                    for _ in range(-(-PS_SHARD_ROWS // cfg.batch_size)):
                        acc.add(np.ones(1, np.float32))
                        if acc.ready:
                            acc.flush_dense()
                    acc.flush_dense()
                flushes.append(acc.flushes)
            line["schedule_pushes"] = flushes
            line["gradient_pushes"] = report[0]["group_pushes"] - 1  # less the seeding push
            line["test_logloss_init"] = init_ll
            line["test_logloss_final"] = [_test_logloss(torch, ops, torch.from_numpy(x).cuda(),
                                                        Xt, yt) for x in weights]
            if (line["gradient_pushes"] != sum(flushes)
                    or [report[r]["accum_flushes"] for r in range(PS_WORKERS)] != flushes):
                raise AssertionError(f"ps_wire accum: the servers counted "
                                     f"{line['gradient_pushes']} pushes, the schedule gives "
                                     f"{flushes}")
            if not all(ll < init_ll for ll in line["test_logloss_final"]):
                raise AssertionError(f"ps_wire accum: test logloss {line['test_logloss_final']} "
                                     f"not below the init's {init_ll}")
        line["test_logloss_reported"] = report[0]["test_logloss"]
        lines[mode] = line
    del shards, Xt
    return lines, launches


def _wire_keyed_runs(torch, tmp: str, seed: int) -> dict:
    """Keyed FTRL: ``sparse_lr`` at config 4's keyed shape, sync, on the
    card and on the numpy backend, and on the card with int8 pushes."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.models import get_model  # noqa: PLC0415

    d = _keyed_data(tmp, "sparse_lr", seed)
    cfg = _keyed_cfg(d, "sparse_lr").replace(ps_optimizer="ftrl", **WIRE_KEYED_FTRL)
    w0 = get_model(cfg).init(cfg).numpy().reshape(-1)
    _, init_ll = _keyed_numpy_eval(cfg, w0)
    _, dev, _, torch_fn, l2 = _keyed_grad_inputs(torch, cfg, w0)
    torch_fn(*dev, *l2).cpu()  # load the gather and scatter kernels first
    del dev
    out = {"ftrl_params": WIRE_KEYED_FTRL, "test_logloss_init": init_ll}
    for mode, run_cfg in (("ftrl", cfg), ("ftrl_numpy", cfg.replace(ps_compute_backend="numpy")),
                          ("ftrl_int8", cfg.replace(ps_compress="int8"))):
        weights, report, launches, seconds = _run_ps(torch, run_cfg, save=False)
        if any(launches.values()):
            raise AssertionError(f"ps_wire keyed {mode}: launched a kernel of ops: {launches}")
        if not all(np.isfinite(w).all() for w in weights):
            raise AssertionError(f"ps_wire keyed {mode}: weights not finite")
        run = {"seconds": seconds,
               "workers": [_wire_round_fields(report[r]) for r in range(PS_WORKERS)],
               "test_logloss_final_numpy": _keyed_numpy_eval(run_cfg, weights[0])[1]}
        if report[0]["compress_active"] != run_cfg.ps_compress:
            raise AssertionError(f"ps_wire keyed {mode}: pushed {report[0]['compress_active']}")
        out[mode] = run
        out.setdefault("weights", {})[mode] = weights[0]
    ws = out.pop("weights")
    out["weights_rel_err_card_vs_numpy"] = rel_err(torch.from_numpy(ws["ftrl"]),
                                                   torch.from_numpy(ws["ftrl_numpy"]))
    out["nonzero_weights"] = int(np.count_nonzero(ws["ftrl"]))
    out["int8_byte_ratio"] = out["ftrl_int8"]["workers"][0]["compress_ratio"]
    out["int8_test_logloss_gap"] = (out["ftrl_int8"]["test_logloss_final_numpy"]
                                    - out["ftrl"]["test_logloss_final_numpy"])
    out["tolerance"] = WIRE_KEYED_TOL
    if out["weights_rel_err_card_vs_numpy"] > WIRE_KEYED_TOL:
        raise AssertionError(f"ps_wire keyed ftrl: card weights differ from the numpy "
                             f"backend's: rel {out['weights_rel_err_card_vs_numpy']}")
    if not out["ftrl"]["test_logloss_final_numpy"] < init_ll:
        raise AssertionError(f"ps_wire keyed ftrl: test logloss did not fall: {out}")
    return out


def _proc_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _child_pids(pid: int) -> list[int]:
    kids = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        kids.append(int(entry))
            except OSError:
                continue
    return kids


def _wire_ps_server(torch, ops, tmp: str) -> dict:
    """``launch ps-server --namespaces v1:ftrl,v2`` at 2 x D keys in a
    subprocess: WIRE_NS_PUSHES kernel gradients pushed into each namespace
    through ``KVNamespace`` (v1 held to the FTRL oracle, v2 to SGD), then
    ``launch serve ... --ps-namespaces v1:ftrl,v2 --ps-namespace v1`` on the
    card answering the test rows within SERVE_SCORE_TOL of σ(plain logits)
    of v1's weights, then ``launch ps --hosts`` (v1's server, int8 pushes)
    training on the card, then SIGTERM: exit 143, no server left."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.data import parse_libsvm_file  # noqa: PLC0415
    from distlr_tpu_torch.models import get_model  # noqa: PLC0415
    from distlr_tpu_torch.ps import KVWorker, namespace_layout  # noqa: PLC0415
    from distlr_tpu_torch.serve import score_lines_over_tcp  # noqa: PLC0415

    spec = "v1:ftrl,v2"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ftrl_flags = [f"--ftrl-{k[5:]}={v}" for k, v in WIRE_FTRL.items()]
    t0 = time.perf_counter()
    server = subprocess.Popen(
        [sys.executable, "-m", "distlr_tpu_torch.launch", "ps-server", "--num-feature-dim",
         str(FULL_D), "--num-servers", str(PS_SERVERS), "--num-workers", str(PS_WORKERS),
         "--async", "--namespaces", spec, "--learning-rate", str(WIRE_NS_LR), *ftrl_flags],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {"namespaces": spec, "group_dim": 2 * FULL_D}
    serve = None
    try:
        hosts = server.stdout.readline().split()
        ns_line = server.stdout.readline().strip()
        if not hosts or hosts[0] != "HOSTS":
            raise AssertionError(f"launch ps-server printed {hosts!r}: {server.stderr.read()}")
        hosts = hosts[1]
        servers = _child_pids(server.pid)
        out.update(hosts_line=True, namespaces_line=ns_line, server_processes=len(servers),
                   start_s=time.perf_counter() - t0)
        if ns_line != f"NAMESPACES v1=0,v2={FULL_D} per_dim={FULL_D}" or len(servers) != 2:
            raise AssertionError(f"launch ps-server: {ns_line!r}, {len(servers)} servers")
        layout = namespace_layout(spec, FULL_D)
        cfg = Config(num_feature_dim=FULL_D, l2_c=0.01)
        model = get_model(cfg)
        rng = np.random.default_rng(7)
        w_init = {m: (rng.standard_normal(FULL_D) * 0.05).astype(np.float32) for m in layout}
        shards = {}
        for m, part in (("v1", 1), ("v2", 2)):
            X, y = parse_libsvm_file(os.path.join(tmp, "train", f"part-{part:03d}"), FULL_D)
            shards[m] = (torch.from_numpy(X).to(torch.bfloat16).cuda(),
                         torch.from_numpy(y).cuda())
            del X
        pushed = {m: [] for m in layout}
        with KVWorker(hosts, 2 * FULL_D, sync_group=False, timeout_ms=PS_TIMEOUT_MS) as kv:
            views = {m: kv.namespace(*layout[m]) for m in layout}
            views["v1"].push_init(w_init["v1"])
            views["v2"].push_init(w_init["v2"], force=True)
            for _ in range(WIRE_NS_PUSHES):
                for m, view in views.items():
                    (g,) = _wire_grads(torch, ops, model, cfg, view.pull(), [shards[m]],
                                       plain=False)
                    pushed[m].append(g)
                    view.wait(view.push(g))
            got = {m: view.pull() for m, view in views.items()}
        orc = _FtrlOracle(w_init["v1"], *WIRE_FTRL.values())
        for g in pushed["v1"]:
            orc.step(g)
        sgd = w_init["v2"]
        for g in pushed["v2"]:
            sgd = (sgd - np.float32(WIRE_NS_LR) * g).astype(np.float32)
        out["v1_rel_err_vs_ftrl_oracle"] = rel_err(torch.from_numpy(got["v1"]),
                                                   torch.from_numpy(orc.w))
        out["v2_rel_err_vs_sgd_oracle"] = rel_err(torch.from_numpy(got["v2"]),
                                                  torch.from_numpy(sgd))
        if max(out["v1_rel_err_vs_ftrl_oracle"], out["v2_rel_err_vs_sgd_oracle"]) > WIRE_FTRL_TOL:
            raise AssertionError(f"ps_wire ps-server: namespaces off their oracles: {out}")
        del shards
        # serve v1 from the live group
        t1 = time.perf_counter()
        serve = subprocess.Popen(
            [sys.executable, "-m", "distlr_tpu_torch.launch", "serve", "--num-feature-dim",
             str(FULL_D), "--ps-hosts", hosts, "--ps-namespaces", spec, "--ps-namespace", "v1",
             "--port", "0", "--reload-interval", "30"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        ready = serve.stdout.readline()
        if not ready.startswith("SERVING "):
            raise AssertionError(f"launch serve printed {ready!r}: {serve.stderr.read()[-2000:]}")
        host, port = ready.split()[1].rsplit(":", 1)
        with open(os.path.join(tmp, "test", "part-001")) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        labels, scores = _parse_libsvm_replies(score_lines_over_tcp(host, int(port), lines,
                                                                    timeout_s=300))
        Xt, _ = parse_libsvm_file(os.path.join(tmp, "test", "part-001"), FULL_D)
        z = ops.lr_logits_reference(torch.from_numpy(got["v1"]).cuda(),
                                    torch.from_numpy(Xt).to(torch.bfloat16).cuda()).cpu()
        out["serve_v1"] = {**_check_replies(torch, "ps-server v1", labels, scores, z),
                           "seconds": time.perf_counter() - t1}
        serve.send_signal(signal.SIGTERM)
        out["serve_v1"]["sigterm_returncode"] = serve.wait(timeout=60)
        # workers join v1's server (the whole of v1's slice) and train on the card
        t2 = time.perf_counter()
        ps = _launch("ps", "--data-dir", tmp, "--num-feature-dim", str(FULL_D), "--num-workers",
                     str(PS_WORKERS), "--hosts", hosts.split(",")[0], "--async",
                     "--batch-size", str(PS_ASYNC_BATCH), "--num-iteration", "1",
                     "--test-interval", "1", "--ps-optimizer", "ftrl", "--ps-compress", "int8",
                     *ftrl_flags)
        acc = re.findall(r"Iteration 1, accuracy: (\S+)", ps.stdout)
        out["launch_ps_hosts"] = {"seconds": time.perf_counter() - t2,
                                  "negotiated_int8": "negotiated 'int8'" in ps.stderr,
                                  "accuracy": float(acc[0]) if acc else None}
        if not out["launch_ps_hosts"]["negotiated_int8"] or not acc:
            raise AssertionError(f"launch ps --hosts: {out['launch_ps_hosts']}\n"
                                 f"{ps.stderr[-2000:]}")
        server.send_signal(signal.SIGTERM)
        out["sigterm_returncode"] = server.wait(timeout=60)
        deadline = time.monotonic() + 10
        while any(_proc_alive(p) for p in servers) and time.monotonic() < deadline:
            time.sleep(0.05)
        out["servers_left"] = sum(_proc_alive(p) for p in servers)
        if out["sigterm_returncode"] != 143 or out["servers_left"]:
            raise AssertionError(f"launch ps-server: exit {out['sigterm_returncode']} after "
                                 f"SIGTERM, {out['servers_left']} servers left")
    finally:
        for proc in (serve, server):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def phase_ps_wire(torch, seed: int, smi: str) -> dict:
    """What the PS servers compute and what crosses the wire, at the ps
    phase's full width (config-3 CTR rows at D = 1M, PS_SERVERS native
    servers, PS_WORKERS worker threads on the card, full 1,024-row shards,
    bf16, the correct-mean update): each worker's gradient the
    ``fused_lr_grad`` single pass, rank 0's eval ``lr_logits``.

    * sync FTRL (WIRE_FTRL, WIRE_LONG_EPOCHS epochs): both workers end equal, the
      servers' weights within WIRE_FTRL_TOL of a float32 FTRL oracle
      applied to the BSP mean of the kernel's gradients, replayed on the
      card at the oracle's weights (the kernel is deterministic), and
      within WIRE_PLAIN_TOL of the same oracle fed the plain gradients;
    * sync SGD dense f32 (the comparison's baseline), and with int8
      pushes: ``compress_active`` "int8", the weights within
      WIRE_INT8_TOL of the oracle that decodes each worker's gradient
      (``int8_roundtrip`` a server's slice), a byte ratio >=
      WIRE_INT8_MIN_RATIO;
    * sync signSGD (lr WIRE_SIGN_LR): the group runs
      ``--optimizer=signsgd``, the weights equal the majority-vote oracle
      (ties untouched) bit for bit, a byte ratio >= WIRE_SIGN_MIN_RATIO, and
      the share of coordinates whose sign the kernel's gradient and the
      plain one disagree on;
    * async SGD + int8 + accumulation (WIRE_ACCUM, PS_ASYNC_BATCH-row
      batches): the servers count exactly the schedule's pushes plus the
      seeding push, the weights are finite and the test logloss falls;
    * keyed FTRL (:func:`_wire_keyed_runs`) and ``launch ps-server``
      (:func:`_wire_ps_server`);
    * the cost of one push of each codec alone
      (:func:`distlr_tpu_torch.benchmarks.wire_push.push_costs`).
    The dense runs' launches are counted (zeroed before, read after each)."""
    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.benchmarks.wire_push import push_costs  # noqa: PLC0415

    t_phase = time.perf_counter()
    out = {"nvidia_smi": smi, "D": FULL_D, "workers": PS_WORKERS, "servers": PS_SERVERS,
           "shard_rows": PS_SHARD_ROWS, "test_rows": PS_TEST_ROWS,
           "reduced": {"epochs": f"{WIRE_LONG_EPOCHS} for FTRL and the async run, {WIRE_EPOCHS} "
                                 "for the dense f32, int8 and signSGD sync runs (cut in depth)",
                       "shard_rows": f"{PS_SHARD_ROWS} a worker, as the ps phase"},
           "tolerances": {"ftrl": WIRE_FTRL_TOL, "ftrl_plain": WIRE_PLAIN_TOL,
                          "int8": WIRE_INT8_TOL, "keyed": WIRE_KEYED_TOL,
                          "int8_min_ratio": WIRE_INT8_MIN_RATIO,
                          "signsgd_min_ratio": WIRE_SIGN_MIN_RATIO}}
    rss = {}
    with _sampled_peak_rss(rss), tempfile.TemporaryDirectory(prefix="distlr-smoke-wire-") as tmp:
        _ps_data(tmp, seed)
        runs, launches = _wire_dense_runs(torch, ops, tmp, smi)
        out.update(runs)
        out["launches"] = launches
        out["keyed_sparse_lr"] = _wire_keyed_runs(torch, tmp, seed)
        out["ps_server"] = _wire_ps_server(torch, ops, tmp)
    out["push_alone"] = push_costs(FULL_D, PS_SERVERS, WIRE_PUSH_REPS, seed)
    out.update(rss)
    out["phase_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    emit("ps_wire", **out)
    return out


# --- PS fault recovery ---------------------------------------------------------
# a straggler timeout that outlasts a round at this width (about 1.3 s a
# sync round) and bounds how long rank 1 waits out the crashed rank 0
REC_TIMEOUT_MS = 6_000
# the kill run's epochs (cut in depth from 6) and the pushes before the kill
REC_KILL_EPOCHS, REC_KILL_AT_PUSHES = 4, 5
# the CLI chains' epochs: checkpointed, then resumed to (cut from 2 and 4)
REC_CLI_EPOCHS, REC_CLI_RESUMED_EPOCHS = 1, 2
# the supervisor's poll and snapshot intervals in the kill run (its
# defaults are 0.2 s and 1 s)
REC_SUP_POLL_S, REC_SUP_SNAPSHOT_S = 0.05, 0.2
REC_RESUME_TOL = 1e-5
REC_CLI_ROWS = 128


def _rec_sync_resume(torch, ops, cfg, Xt, yt) -> tuple[dict, dict, object]:
    """Sync, checkpoint_interval 1: rank 0 raises after its epoch-1
    checkpoint, rank 1 times out, and the job resumes against the
    surviving group; its weights against an uninterrupted run's on a fresh
    group.  ``(line, launches, resumed weights)``."""
    from distlr_tpu_torch.ps import ServerGroup  # noqa: PLC0415
    from distlr_tpu_torch.train import ps_trainer  # noqa: PLC0415
    from distlr_tpu_torch.train.ps_trainer import ps_param_dim, run_ps_workers  # noqa: PLC0415

    sidecar = os.path.join(cfg.checkpoint_dir, "ps_latest.json")
    launches = {}
    real = ps_trainer.PSWorker._checkpoint
    state = {"crashed": False}

    def crashing(self, ckpt, epoch):
        real(self, ckpt, epoch)
        if epoch == 1 and not state["crashed"]:
            state["crashed"] = True
            raise RuntimeError("injected crash after checkpoint")

    ps_trainer.PSWorker._checkpoint = crashing
    try:
        with ServerGroup(PS_SERVERS, PS_WORKERS, ps_param_dim(cfg),
                         learning_rate=cfg.learning_rate, sync=True) as group:
            try:
                _bounded(torch, lambda: run_ps_workers(cfg, group.hosts, range(PS_WORKERS)))
            except Exception as e:  # noqa: BLE001 — the injected crash, checked below
                crash_error = f"{type(e).__name__}: {e}"
            else:
                raise AssertionError("ps_recovery: the crashed sync run did not fail")
            if not state["crashed"]:
                raise AssertionError(f"ps_recovery: the crash did not fire ({crash_error})")
            with open(sidecar) as f:
                crashed_sidecar = json.load(f)
            counts = _launches(ops)  # the crashed run's: _bounded raised before reading
            report = {}
            resumed, resumed_launches, resume_s = _bounded(torch, lambda: run_ps_workers(
                cfg, group.hosts, range(PS_WORKERS), resume=True, report=report))
    finally:
        ps_trainer.PSWorker._checkpoint = real
    with open(sidecar) as f:
        final_sidecar = json.load(f)
    whole, _, whole_launches, whole_s = _run_ps(torch, cfg.replace(checkpoint_dir=None),
                                                save=False)
    for c in (counts, resumed_launches, whole_launches):
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    w = torch.from_numpy(resumed[0]).cuda()
    w_whole = torch.from_numpy(whole[0]).cuda()
    line = {
        "crash": crash_error, "sidecar_after_crash": crashed_sidecar,
        "sidecar_after_resume": final_sidecar, "resume_seconds": resume_s,
        "uninterrupted_seconds": whole_s,
        "resume_to_first_round_s": report[0]["rendezvous_s"],
        "checkpoint_save_ms": report[0]["checkpoint_ms"],
        "checkpoint_saves": report[0]["checkpoint_count"],
        "checkpoint_bytes": os.path.getsize(os.path.join(
            cfg.checkpoint_dir, f"ckpt-{PS_EPOCHS}.npz")),
        "weights_max_rel_err_vs_uninterrupted": rel_err(w, w_whole),
        "weights_equal_uninterrupted": bool(torch.equal(w, w_whole)),
        "tolerance": REC_RESUME_TOL,
        "test_logloss": _test_logloss(torch, ops, w, Xt, yt),
        "workers": [report[r] for r in range(PS_WORKERS)],
    }
    if crashed_sidecar != {"epoch": 1, "attempt": 0} or final_sidecar != {
            "epoch": PS_EPOCHS, "attempt": 1}:
        raise AssertionError(f"ps_recovery: sidecars {crashed_sidecar} -> {final_sidecar}")
    if line["weights_max_rel_err_vs_uninterrupted"] > REC_RESUME_TOL:
        raise AssertionError(f"ps_recovery: the resumed weights are "
                             f"{line['weights_max_rel_err_vs_uninterrupted']} (rel) from the "
                             f"uninterrupted run's")
    return line, launches, w


def _rec_async_restart(torch, ops, cfg, Xt, yt, init_ll) -> tuple[dict, dict]:
    """Async, max_restarts 1: rank 1's gradient raises once, in its second
    round (the device lock is held then); the run completes, one restart
    is counted, the weights are finite and the test logloss falls."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.models import linear  # noqa: PLC0415

    real = linear.BinaryLR.grad
    calls = {"rank1": 0, "crashed": False}

    def flaky(self, *a, **kw):
        if threading.current_thread().name == "ps-worker-1":
            calls["rank1"] += 1
            if calls["rank1"] == 2 and not calls["crashed"]:
                calls["crashed"] = True
                raise RuntimeError("injected crash in rank 1's second round")
        return real(self, *a, **kw)

    linear.BinaryLR.grad = flaky
    try:
        weights, report, launches, seconds = _run_ps(torch, cfg, save=False, max_restarts=1)
    finally:
        linear.BinaryLR.grad = real
    final_ll = [_test_logloss(torch, ops, x, Xt, yt) for x in weights]
    line = {"seconds": seconds, "crashed": calls["crashed"],
            "restarts": [report[r]["restarts"] for r in range(PS_WORKERS)],
            "test_logloss_init": init_ll, "test_logloss_final": final_ll,
            "workers": [report[r] for r in range(PS_WORKERS)]}
    if (not calls["crashed"] or line["restarts"] != [0, 1]
            or not all(np.isfinite(x).all() for x in weights)
            or not all(ll < init_ll for ll in final_ll)):
        raise AssertionError(f"ps_recovery async restart: {line}")
    return line, launches


def _rec_server_kill(torch, ops, cfg) -> tuple[dict, dict]:
    """Async FTRL under the supervisor, with restarts and retries: server
    rank 1 is SIGKILLed mid-run.  Its slice and its z/n, read right after
    the re-seed (worker pushes held off by a gate for that moment), must
    equal the supervisor's snapshot bit for bit; then the run completes."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.ps import KVWorker, ServerSupervisor  # noqa: PLC0415
    from distlr_tpu_torch.train.ps_trainer import ps_server_group, run_ps_workers  # noqa: PLC0415

    gate = threading.Lock()
    real_run, real_reseed = KVWorker._run_with_retry, ServerSupervisor._reseed
    reseeds = []

    def gated_run(self, op, fn, *, idempotent, on_failure=None):
        if idempotent:
            return real_run(self, op, fn, idempotent=True, on_failure=on_failure)

        def issue():
            with gate:
                return fn()
        return real_run(self, op, issue, idempotent=False, on_failure=on_failure)

    def checked_reseed(self, rank):
        t_call = time.monotonic()
        with gate:
            t_gate = time.monotonic()
            ok = real_reseed(self, rank)
            t_done = time.monotonic()
            if ok and self.events[-1][2] == "reseeded":
                lo, hi = self._group.key_range(rank)
                with self._probe_rank(rank) as kv:
                    w = kv.pull()
                    z, n = kv.pull_opt_state()
                reseeds.append({
                    "at": t_done, "called_at": t_call, "gate_wait_ms": 1e3 * (t_gate - t_call),
                    "reseed_ms": 1e3 * (t_done - t_gate), "rank": rank,
                    "weights_equal_snapshot": w.tobytes() == self._snapshot[lo:hi].tobytes(),
                    "z_equal_snapshot": z.tobytes() == self._opt_z[lo:hi].tobytes(),
                    "n_equal_snapshot": n.tobytes() == self._opt_n[lo:hi].tobytes(),
                    "n_nonzero": int(np.count_nonzero(n))})
        return ok

    group = ps_server_group(cfg)
    killed, respawns = {}, []
    real_respawn = group.respawn

    def timed_respawn(rank):
        t0 = time.monotonic()
        ok = real_respawn(rank)
        respawns.append((t0, time.monotonic()))
        return ok

    group.respawn = timed_respawn

    def killer(sup, stop):
        lo, hi = group.key_range(1)
        while not stop.is_set():
            try:
                with KVWorker(f"127.0.0.1:{group.ports[1]}", hi - lo, client_id=0xFFFD,
                              timeout_ms=2000) as probe:
                    pushes = probe.stats(0)["total_pushes"]
            except OSError:
                pushes = 0
            if sup._snap_valid[1] and pushes >= REC_KILL_AT_PUSHES:
                killed.update(at=time.monotonic(), pushes=pushes)
                group.procs[1].kill()
                return
            time.sleep(0.01)

    KVWorker._run_with_retry, ServerSupervisor._reseed = gated_run, checked_reseed
    report, stop = {}, threading.Event()
    try:
        with group, ServerSupervisor(group, poll_interval=REC_SUP_POLL_S,
                                     snapshot_interval=REC_SUP_SNAPSHOT_S) as sup:
            t = threading.Thread(target=killer, args=(sup, stop), daemon=True,
                                 name="smoke-killer")
            t.start()
            try:
                weights, launches, seconds = _bounded(torch, lambda: run_ps_workers(
                    cfg, group.hosts, range(PS_WORKERS), max_restarts=2, report=report))
            finally:
                stop.set()
                t.join()
    finally:
        KVWorker._run_with_retry, ServerSupervisor._reseed = real_run, real_reseed
    kinds = [(r, ev) for _, r, ev in sup.events]
    at = {ev: t for t, r, ev in sup.events if r == 1}
    line = {
        "seconds": seconds, "poll_interval_s": REC_SUP_POLL_S,
        "snapshot_interval_s": REC_SUP_SNAPSHOT_S,
        "killed_at_pushes": killed.get("pushes"), "events": kinds,
        "kill_to_respawn_ms": 1e3 * (at["respawned"] - killed["at"]) if killed and
        "respawned" in at else None,
        "kill_to_reseed_ms": 1e3 * (reseeds[0]["at"] - killed["at"]) if killed and reseeds
        else None,
        # where the kill-to-reseed time goes: the respawn call (spawn and
        # the PORT line), then the re-seed (the gate: a worker push in
        # flight; the forced init and z/n over a probe connection)
        "respawn_call_ms": [1e3 * (b - a) for a, b in respawns],
        "kill_to_respawn_call_ms": 1e3 * (respawns[0][0] - killed["at"]) if killed and respawns
        else None,
        "reseed_checks": reseeds,
        **{k: sum(report[r][k] for r in range(PS_WORKERS))
           for k in ("retries", "reconnects", "push_outcome_unknown", "restarts")},
        "workers": [report[r] for r in range(PS_WORKERS)],
    }
    ok = (killed and kinds[:2] == [(1, "respawned"), (1, "reseeded")] and reseeds
          and all(c["weights_equal_snapshot"] and c["z_equal_snapshot"]
                  and c["n_equal_snapshot"] and c["n_nonzero"] for c in reseeds)
          and all(np.isfinite(weights[r]).all() for r in range(PS_WORKERS)))
    if not ok:
        raise AssertionError(f"ps_recovery server kill: {line}")
    return line, launches


def _rec_kernel_check(torch, ops, w_run, tmp: str, Xt) -> dict:
    """``fused_lr_grad`` at (PS_SHARD_ROWS, FULL_D) on rank 0's shard and
    ``lr_logits`` on the test rows, against their plain versions
    (REL_TOL), on the resumed weights centred and scaled to logits of
    standard deviation 1.5 (the runs' weights saturate the residuals), as
    :func:`_ps_kernel_shapes` does."""
    from distlr_tpu_torch.data import parse_libsvm_file  # noqa: PLC0415

    X, y = parse_libsvm_file(os.path.join(tmp, "train", "part-001"), FULL_D)
    X, y = torch.from_numpy(X).to(torch.bfloat16).cuda(), torch.from_numpy(y).cuda()
    wc = w_run - w_run.mean()
    wc = wc * (1.5 / float(ops.lr_logits_reference(wc, X).std()))
    mask = torch.ones(X.shape[0], device=X.device)
    g, g_ref = ops.fused_lr_grad(wc, X, y, mask), ops.fused_lr_grad_reference(wc, X, y, mask)
    z, z_ref = ops.lr_logits(wc, Xt), ops.lr_logits_reference(wc, Xt)
    out = {"fused_lr_grad": {"B": X.shape[0], "rel_err": rel_err(g, g_ref),
                             "max_abs_err": float((g - g_ref).abs().max())},
           "lr_logits": {"B": Xt.shape[0], "rel_err": rel_err(z, z_ref),
                         "max_abs_err": float((z - z_ref).abs().max())},
           "tolerance": REL_TOL}
    if max(out["fused_lr_grad"]["rel_err"], out["lr_logits"]["rel_err"]) > REL_TOL:
        raise AssertionError(f"ps_recovery: a kernel disagrees with its plain version: {out}")
    return out


def _cli_ps_recovery(tmp: str, seed: int) -> dict:
    """``launch ps`` on the card with the recovery flags, on REC_CLI_ROWS-row
    shards at D = FULL_D: checkpoints every epoch, then ``--resume`` with
    more epochs (the sidecar advances, the eval lines start after the
    checkpoint); ``--async --supervise-servers --max-worker-restarts 2
    --ps-retry-attempts 4``; and ``--supervise-servers`` without
    ``--async``, which exits 2 with the JAX package's message.  The chains
    run side by side."""
    d, ck = os.path.join(tmp, "cli"), os.path.join(tmp, "cli_ck")
    _ps_data(d, seed, shard_rows=REC_CLI_ROWS, test_rows=REC_CLI_ROWS)
    ps = ["ps", "--data-dir", d, "--num-feature-dim", str(FULL_D), "--num-workers",
          str(PS_WORKERS), "--num-servers", str(PS_SERVERS), "--device", "cuda",
          "--test-interval", "1", "--learning-rate", "0.2"]
    sidecar = os.path.join(ck, "ps_latest.json")

    def resume_chain():
        ckpt = ps + ["--checkpoint-dir", ck, "--checkpoint-interval", "1"]
        _launch(*ckpt, "--num-iteration", str(REC_CLI_EPOCHS))
        with open(sidecar) as f:
            first = json.load(f)
        out = _launch(*ckpt, "--num-iteration", str(REC_CLI_RESUMED_EPOCHS), "--resume").stdout
        with open(sidecar) as f:
            return {"sidecar_first": first, "sidecar_resumed": json.load(f),
                    "resumed_eval_epochs": [int(n) for n, _ in re.findall(EVAL_LINE, out, re.M)]}

    def supervised():
        out = _launch(*ps, "--async", "--supervise-servers", "--max-worker-restarts", "2",
                      "--ps-retry-attempts", "4", "--num-iteration",
                      str(REC_CLI_EPOCHS)).stdout
        return {"exit": 0, "eval_epochs": [int(n) for n, _ in re.findall(EVAL_LINE, out, re.M)]}

    def sync_supervised():
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", *ps,
                               "--supervise-servers"], cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=300)
        return {"exit": proc.returncode, "stderr": proc.stderr.strip()}

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        futs = {k: pool.submit(f) for k, f in (("resume", resume_chain),
                                                ("supervised", supervised),
                                                ("sync_supervised", sync_supervised))}
        out = {k: f.result() for k, f in futs.items()}
    out["seconds"] = time.perf_counter() - t0
    want_msg = ("error: --supervise-servers requires --async (sync BSP state cannot be "
                "reconstructed; use --checkpoint-dir + --resume)")
    resumed = list(range(REC_CLI_EPOCHS + 1, REC_CLI_RESUMED_EPOCHS + 1))
    if (out["resume"]["sidecar_first"] != {"epoch": REC_CLI_EPOCHS, "attempt": 0}
            or out["resume"]["sidecar_resumed"] != {"epoch": REC_CLI_RESUMED_EPOCHS,
                                                    "attempt": 1}
            or out["resume"]["resumed_eval_epochs"] != resumed
            or out["supervised"]["eval_epochs"] != list(range(1, REC_CLI_EPOCHS + 1))
            or out["sync_supervised"]["exit"] != 2
            or want_msg not in out["sync_supervised"]["stderr"]):
        raise AssertionError(f"ps_recovery cli: {out}")
    return out


def phase_ps_recovery(torch, seed: int, smi: str) -> dict:
    """PS fault recovery at the ps phase's full width (config-3 CTR rows at
    D = 1M, PS_SERVERS native servers, PS_WORKERS worker threads on the
    card, 1,024-row shards, bf16), each gradient the ``fused_lr_grad``
    single pass and rank 0's eval ``lr_logits``:

    1. sync resume (:func:`_rec_sync_resume`): a crash after the epoch-1
       checkpoint, a resume against the surviving group, the sidecars, and
       the weights within REC_RESUME_TOL of an uninterrupted run's; the
       checkpoint's save ms and the seconds from the resume to its first
       round;
    2. an async worker restart (:func:`_rec_async_restart`);
    3. a server SIGKILL under the supervisor (:func:`_rec_server_kill`):
       the events, the re-seeded slice and z/n against the snapshot, ms
       from the kill to the re-seed, retries, reconnects and restarts;
    4. the kernels at the path's shapes against their plain versions
       (:func:`_rec_kernel_check`), after the runs' launches were read;
    5. the CLI (:func:`_cli_ps_recovery`).
    """
    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.data import parse_libsvm_file  # noqa: PLC0415
    from distlr_tpu_torch.models import get_model  # noqa: PLC0415

    t_phase = time.perf_counter()
    out = {"nvidia_smi": smi, "D": FULL_D, "workers": PS_WORKERS, "servers": PS_SERVERS,
           "shard_rows": PS_SHARD_ROWS, "test_rows": PS_TEST_ROWS, "epochs": PS_EPOCHS,
           "reduced": {"epochs": f"{PS_EPOCHS} (sync, async restart), {REC_KILL_EPOCHS} "
                                 "(server kill): cut in depth",
                       "shard_rows": f"{PS_SHARD_ROWS} a worker, as the ps phase",
                       "cli": f"{REC_CLI_ROWS}-row shards at D = {FULL_D}, "
                              f"{REC_CLI_EPOCHS} epoch(s) resumed to {REC_CLI_RESUMED_EPOCHS}"}}
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    rss = {}
    with _sampled_peak_rss(rss), tempfile.TemporaryDirectory(prefix="distlr-smoke-rec-") as tmp:
        _ps_data(tmp, seed)
        cfg = Config(data_dir=tmp, num_feature_dim=FULL_D, num_workers=PS_WORKERS,
                     num_servers=PS_SERVERS, batch_size=PS_SHARD_ROWS,
                     num_iteration=PS_EPOCHS, test_interval=1, learning_rate=0.2, l2_c=0.01,
                     compute_dtype="bfloat16", ps_timeout_ms=REC_TIMEOUT_MS)
        Xt, yt = parse_libsvm_file(os.path.join(tmp, "test", "part-001"), FULL_D)
        Xt = torch.from_numpy(Xt).to(torch.bfloat16).cuda()
        yt = torch.from_numpy(yt).float().cuda()
        init_ll = _test_logloss(torch, ops, get_model(cfg).init(cfg).cuda(), Xt, yt)
        line, counts, w_resumed = _rec_sync_resume(
            torch, ops, cfg.replace(checkpoint_dir=os.path.join(tmp, "ck"),
                                    checkpoint_interval=1), Xt, yt)
        out["sync_resume"] = line
        add(counts)
        async_cfg = cfg.replace(sync_mode=False, batch_size=PS_ASYNC_BATCH,
                                ps_timeout_ms=PS_TIMEOUT_MS)
        out["async_restart"], counts = _rec_async_restart(torch, ops, async_cfg, Xt, yt,
                                                          init_ll)
        add(counts)
        out["server_kill"], counts = _rec_server_kill(
            torch, ops, async_cfg.replace(ps_optimizer="ftrl", ps_retry_attempts=4,
                                          num_iteration=REC_KILL_EPOCHS,
                                          test_interval=REC_KILL_EPOCHS))
        add(counts)
        out["launches"] = {k: v for k, v in launches.items() if v}
        others = {k: v for k, v in out["launches"].items()
                  if k not in ("fused_lr_grad", "lr_logits")}
        if not launches.get("fused_lr_grad") or not launches.get("lr_logits") or others:
            raise AssertionError(f"ps_recovery: launches {launches}")
        out["kernels_at_ps_shapes"] = _rec_kernel_check(torch, ops, w_resumed, tmp, Xt)
        del Xt, w_resumed
        out["cli"] = _cli_ps_recovery(tmp, seed)
    out.update(rss)
    out["phase_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    emit("ps_recovery", **out)
    return out


# --- the durable store, its WAL and the chaos fabric --------------------------
DUR_WAL_PUSHES, DUR_PUSH_REPS, DUR_SUP_POLL_S = 8, 3, 0.05
DUR_SNAP_INTERVAL_S, DUR_SNAP_RUN_S = 0.5, 2.5
DUR_RETRY_ATTEMPTS, DUR_CLI_ROWS = 10, 128
# a throttle of each rate on every link, None = the proxy alone
DUR_RATES = {"unthrottled": None, "1gbit": 125_000_000, "100mbit": 12_500_000}
# the WAL's replay applies the same f32 updates in the same order: bits
DUR_WAL_TOL = 1e-6


def _dur_grad_fn(torch, model, cfg, shard):
    """The card's gradient of ``shard`` at host weights ``w``: one
    ``fused_lr_grad`` launch, read back as the f32 vector a push sends."""
    X, y = shard
    mask = torch.ones(X.shape[0], device="cuda")

    def grad(w):
        return model.grad(torch.from_numpy(w).cuda(), (X, y, mask), cfg).cpu().numpy()

    return grad


def _dur_wait_events(sup, want: str, ranks, timeout_s: float = 60.0) -> dict:
    """``{rank: monotonic time}`` of each rank's first ``want`` event."""
    deadline = time.monotonic() + timeout_s
    while True:
        seen = {}
        for t, r, ev in list(sup.events):
            if ev == want and r in ranks:
                seen.setdefault(r, t)
        if len(seen) == len(ranks):
            return seen
        if time.monotonic() > deadline:
            raise AssertionError(f"ps_durable: no {want!r} for every rank in {timeout_s} s: "
                                 f"{sup.events}")
        time.sleep(0.005)


def _dur_wal(torch, grad_fn, w0, root: str) -> dict:
    """Check 1: an async SGD group with the WAL (interval 60 s, fsync
    0.01 s) under a supervisor; DUR_WAL_PUSHES card gradients, each at the
    weights just pulled; both ranks SIGKILLed; their stores' recovered
    clocks, the supervisor's respawn and ``reseeded-from-store``, and the
    pull against the pre-kill pull (bits, or DUR_WAL_TOL with the reason
    printed).  The kill to the re-seed event, the respawn call (spawn,
    restore and replay, then the port line) and a store-free spawn of the
    same slice beside it: their difference is the recovery's share."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.ps import KVWorker, ServerGroup, ServerSupervisor, store  # noqa: PLC0415

    group = ServerGroup(PS_SERVERS, 1, FULL_D, sync=False, learning_rate=0.2, store_dir=root,
                        store_interval_s=60.0, store_wal=True, store_wal_fsync_s=0.01)
    respawns, real_respawn = {}, group.respawn

    def timed_respawn(rank):
        t0 = time.monotonic()
        ok = real_respawn(rank)
        respawns[rank] = (t0, time.monotonic())
        return ok

    group.respawn = timed_respawn
    with group, ServerSupervisor(group, poll_interval=DUR_SUP_POLL_S,
                                 snapshot_interval=60.0) as sup:
        with KVWorker(group.hosts, FULL_D, sync_group=False, timeout_ms=PS_TIMEOUT_MS) as kv:
            kv.push_init(w0)
            for _ in range(DUR_WAL_PUSHES):
                kv.push(grad_fn(kv.pull()))
            before = kv.pull()
        # every acknowledged push is on disk (the group commit runs before
        # the ack): the files the kill leaves
        doc = store.inspect_store(root, now=time.time())
        t_kill = time.monotonic()
        for p in list(group.procs):
            p.kill()
        reseeded = _dur_wait_events(sup, "reseeded-from-store", range(PS_SERVERS))
        with KVWorker(group.hosts, FULL_D, sync_group=False, timeout_ms=PS_TIMEOUT_MS) as kv:
            after = kv.pull()
        events = [(r, ev) for _, r, ev in sup.events]
    fresh = ServerGroup(1, 1, FULL_D // PS_SERVERS, sync=False)
    t0 = time.perf_counter()
    try:
        fresh.start()
        fresh_spawn_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        fresh.stop()
    ranks = {}
    for r, d in sorted(doc["ranks"].items()):
        rank = int(r)
        recovery_ms = 1e3 * (respawns[rank][1] - respawns[rank][0])
        ranks[r] = {
            "recovered_clock": d["recovered_clock"], "snapshot_clock": d["snapshot_clock"],
            "wal_records": d["wal"]["records"], "wal_bytes": d["wal"]["bytes"],
            "snapshot_bytes": d["snapshot_bytes"],
            "wal_bytes_per_push": (d["wal"]["bytes"] - d["wal"]["segments"]
                                   * store.WAL_HEADER_SIZE) / d["wal"]["records"],
            "kill_to_reseeded_from_store_ms": 1e3 * (reseeded[rank] - t_kill),
            "kill_to_respawn_call_ms": 1e3 * (respawns[rank][0] - t_kill),
            "respawn_call_ms": recovery_ms,
            "recovery_ms": recovery_ms - fresh_spawn_ms,
            "recovery_share": (recovery_ms - fresh_spawn_ms) / (1e3 * (reseeded[rank] - t_kill)),
        }
    bits = after.tobytes() == before.tobytes()
    line = {"pushes": DUR_WAL_PUSHES, "fsync_s": 0.01, "ranks": ranks, "events": events,
            "fresh_spawn_ms": fresh_spawn_ms, "pull_equals_pre_kill_bits": bits,
            "store_footprint_bytes": sum(d["snapshot_bytes"] + d["wal"]["bytes"]
                                         for d in doc["ranks"].values())}
    if not bits:
        diff = np.abs(after.astype(np.float64) - before) / max(float(np.abs(before).max()), 1e-30)
        line["max_rel_err_vs_pre_kill"] = float(diff.max())
        line["why"] = ("the recovered weights differ from the pre-kill pull's bits: the replay "
                       "applied the logged f32 updates to the restored slice in another order "
                       "or rounding than the live server did")
    ok = (all(d["recovered_clock"] == 1 + DUR_WAL_PUSHES for d in ranks.values())
          and all(events.count((r, "respawned")) == 1
                  and events.index((r, "respawned")) < events.index((r, "reseeded-from-store"))
                  for r in range(PS_SERVERS))
          and (bits or line["max_rel_err_vs_pre_kill"] <= DUR_WAL_TOL))
    if not ok:
        raise AssertionError(f"ps_durable wal: {line}")
    return line


def _dur_snapshot_only(torch, grad_fn, w0, root: str) -> dict:
    """Check 2: no WAL, a snapshot every DUR_SNAP_INTERVAL_S; card
    gradients pushed for DUR_SNAP_RUN_S, then both ranks SIGKILLed.  Each
    rank's recovered clock is behind the acknowledged pushes by at most
    those of the last snapshot interval and the writer's slack (two
    intervals, as the JAX package's test holds it), and one."""
    from distlr_tpu_torch.ps import KVWorker, ServerGroup, store  # noqa: PLC0415

    acks = []
    with ServerGroup(PS_SERVERS, 1, FULL_D, sync=False, learning_rate=0.2, store_dir=root,
                     store_interval_s=DUR_SNAP_INTERVAL_S) as group:
        with KVWorker(group.hosts, FULL_D, sync_group=False, timeout_ms=PS_TIMEOUT_MS) as kv:
            kv.push_init(w0)
            t_end = time.monotonic() + DUR_SNAP_RUN_S
            while time.monotonic() < t_end:
                kv.push(grad_fn(kv.pull()))
                acks.append(time.monotonic())
            t_kill = time.monotonic()
            for p in group.procs:
                p.kill()
            for p in group.procs:
                p.wait()
        clocks = [store.scan_rank(group.store_rank_dir(r)).recovered_clock
                  for r in range(PS_SERVERS)]
    acked = 1 + len(acks)
    window = 2 * DUR_SNAP_INTERVAL_S
    line = {"interval_s": DUR_SNAP_INTERVAL_S, "acked_clock": acked, "recovered_clocks": clocks,
            "clock_gap": [acked - c for c in clocks],
            "pushes_in_last_interval": sum(1 for t in acks if t_kill - t <= DUR_SNAP_INTERVAL_S),
            "pushes_in_last_two_intervals": sum(1 for t in acks if t_kill - t <= window),
            "push_rate_per_s": len(acks) / DUR_SNAP_RUN_S}
    if any(g > line["pushes_in_last_two_intervals"] + 1 or g < 0 for g in line["clock_gap"]):
        raise AssertionError(f"ps_durable snapshot-only: the loss is not bounded by the "
                             f"interval: {line}")
    return line


def _dur_push_alone(grad, root: str) -> dict:
    """A push alone of one card gradient into a 2-server group at D = 1M,
    the WAL off and on (fsync 0.1, the default): the mean of DUR_PUSH_REPS
    after a warm-up.  Then a snapshot on SIGUSR1: ms until each rank's new
    generation reads back valid at the group's clock."""
    from distlr_tpu_torch.ps import KVWorker, ServerGroup, store  # noqa: PLC0415

    out = {}
    for name, kw in (("wal_off", {}), ("wal_on", {"store_dir": root, "store_interval_s": 60.0,
                                                  "store_wal": True})):
        with ServerGroup(PS_SERVERS, 1, FULL_D, sync=False, learning_rate=1e-3, **kw) as group:
            with KVWorker(group.hosts, FULL_D, sync_group=False,
                          timeout_ms=PS_TIMEOUT_MS) as kv:
                kv.push_init(grad * 0)
                kv.push(grad)
                t0 = time.perf_counter()
                for _ in range(DUR_PUSH_REPS):
                    kv.push(grad)
                out[f"push_{name}_ms"] = 1e3 * (time.perf_counter() - t0) / DUR_PUSH_REPS
            if name == "wal_on":
                clock = 2 + DUR_PUSH_REPS
                t0 = time.perf_counter()
                for p in group.procs:
                    os.kill(p.pid, signal.SIGUSR1)
                deadline, done = time.monotonic() + 30, {}
                while len(done) < PS_SERVERS and time.monotonic() < deadline:
                    for r in set(range(PS_SERVERS)) - set(done):
                        # the server writes a generation to a temporary
                        # file and renames it: a valid one is whole
                        for path in store.snapshot_paths(group.store_rank_dir(r)):
                            meta = store.read_snapshot_meta(path)
                            if meta.valid and meta.push_clock == clock:
                                done[r] = (1e3 * (time.perf_counter() - t0), meta.size_bytes)
                    time.sleep(0.001)
                if len(done) < PS_SERVERS:
                    raise AssertionError(f"ps_durable: no snapshot at clock {clock}: {done}")
                out["snapshot_ms"] = [done[r][0] for r in range(PS_SERVERS)]
                out["snapshot_bytes_per_rank"] = [done[r][1] for r in range(PS_SERVERS)]
    out["wal_cost_ms"] = out["push_wal_on_ms"] - out["push_wal_off_ms"]
    return out


def _dur_drill_run(torch, cfg, *, kill_at_s: float, tmp: str):
    """``run_ps_local`` async with the store, the WAL, supervised servers,
    retries and one restart, behind the plan ``kill`` the group at
    ``kill_at_s``; ``(weights, report, launches, seconds, trace)``, the
    trace holding the fabric's start, rank 0's epoch ends, each worker's
    acknowledged pushes and, for a kill, its time and each rank's store
    as the cut left it (read under the group's lock, so the supervisor's
    respawn waits)."""
    from distlr_tpu_torch.ps import KVWorker, ServerGroup, store  # noqa: PLC0415
    from distlr_tpu_torch.train import ps_trainer  # noqa: PLC0415

    plan = os.path.join(tmp, f"plan-{kill_at_s:.3f}.json")
    with open(plan, "w") as f:
        json.dump({"faults": [{"kind": "kill", "target": "group", "at_s": kill_at_s}]}, f)
    trace = {"evals": [], "acks": []}
    real_psg, real_kill, real_pp = (ps_trainer.ps_server_group, ServerGroup._chaos_kill,
                                    KVWorker.push_pull)

    def server_group(c):
        group = real_psg(c)
        real_start = group.start

        def start():
            out = real_start()
            trace["fabric"] = group.chaos
            return out

        group.start = start
        return group

    def chaos_kill(self, target):
        t = time.monotonic()
        real_kill(self, target)
        with self._lock:
            for p in self.procs:
                p.wait()
            trace["cut"] = {"t": t, "clocks": [
                store.scan_rank(self.store_rank_dir(r)).recovered_clock
                for r in range(self.num_servers)]}

    def push_pull(self, *a, **k):
        out = real_pp(self, *a, **k)
        trace["acks"].append(time.monotonic())
        return out

    ps_trainer.ps_server_group, ServerGroup._chaos_kill, KVWorker.push_pull = (
        server_group, chaos_kill, push_pull)
    report = {}
    try:
        weights, launches, seconds = _bounded(torch, lambda: ps_trainer.run_ps_local(
            cfg.replace(chaos_plan=plan), report=report, max_restarts=1, supervise_servers=True,
            eval_fn=lambda epoch, acc: trace["evals"].append((epoch, time.monotonic(), acc))))
    finally:
        ps_trainer.ps_server_group, ServerGroup._chaos_kill, KVWorker.push_pull = (
            real_psg, real_kill, real_pp)
    return weights, report, launches, seconds, trace


def _dur_drill(torch, ops, cfg, tmp: str, Xt, yt, init_ll) -> tuple[dict, dict, object]:
    """Check 3: the power-loss drill through ``run_ps_local``.  A first run
    with the kill beyond its end gives the epochs' times from the fabric's
    start; the drill cuts the whole group at the middle of epoch 2.  Then:
    exactly one ``kill`` of target ``group``; on each rank ``respawned``,
    then ``reseeded-from-store``; each rank's recovered clock at the cut
    at least the pushes the workers had acknowledged before it, less the
    absorbed ones (1 + acked - absorbed); the run completes with finite
    weights and a test logloss below the init's."""
    import numpy as np  # noqa: PLC0415

    launches = {}
    _, rep0, counts, s0, tr0 = _dur_drill_run(
        torch, cfg.replace(ps_store_dir=os.path.join(tmp, "drill0")), kill_at_s=3600.0, tmp=tmp)
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    start = tr0["fabric"].started_at
    ends = {e: t - start for e, t, _ in tr0["evals"]}
    if sorted(ends) != list(range(1, PS_EPOCHS + 1)):
        raise AssertionError(f"ps_durable drill: the first run's evals {tr0['evals']}")
    kill_at = 0.5 * (ends[1] + ends[2])
    weights, report, counts, seconds, tr = _dur_drill_run(
        torch, cfg.replace(ps_store_dir=os.path.join(tmp, "drill")), kill_at_s=kill_at, tmp=tmp)
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    kills = [e for e in tr["fabric"].events() if e[1] == "kill"]
    cut = tr.get("cut", {})
    evals_before = sum(1 for _, t, _ in tr["evals"] if cut and t < cut["t"])
    acked = sum(1 for t in tr["acks"] if cut and t < cut["t"])
    absorbed = sum(report[r]["push_outcome_unknown"] for r in range(PS_WORKERS))
    events = report.get("supervisor_events", [])
    by_rank = {r: [ev for _, rr, ev in events if rr == r] for r in range(PS_SERVERS)}
    final_ll = _test_logloss(torch, ops, torch.from_numpy(weights[0]).cuda(), Xt, yt)
    line = {
        "epochs": PS_EPOCHS, "batch_rows": PS_ASYNC_BATCH, "retry_attempts": DUR_RETRY_ATTEMPTS,
        "max_restarts": 1, "first_run_s": s0, "first_run_epoch_ends_s": ends,
        "kill_at_s": kill_at, "seconds": seconds,
        "kill_events": [list(e[:2]) + [dict(e[2:])] for e in kills],
        "cut_in_epoch": evals_before + 1, "acked_before_cut": acked, "absorbed": absorbed,
        "clocks_at_cut": cut.get("clocks"), "supervisor_events": by_rank,
        "store_events": report.get("store_events"), "chaos_events": report.get("chaos_events"),
        "store_health": report.get("store_health"),
        **{k: sum(report[r][k] for r in range(PS_WORKERS))
           for k in ("retries", "reconnects", "restarts")},
        "test_logloss_init": init_ll, "test_logloss_final": final_ll,
        "first_run_test_logloss": rep0[0]["test_logloss"],
    }
    ok = (len(kills) == 1 and dict(kills[0][2:])["target"] == "group" and cut
          and all("respawned" in evs and "reseeded-from-store" in evs
                  and evs.index("respawned") < evs.index("reseeded-from-store")
                  for evs in by_rank.values())
          and min(cut["clocks"]) >= 1 + acked - absorbed
          and all(np.isfinite(w).all() for w in weights) and final_ll < init_ll)
    if not ok:
        raise AssertionError(f"ps_durable drill: {line}")
    return line, launches, weights[0]


def _dur_proc_tree(pid: int) -> list[int]:
    return [pid] + [k for c in _child_pids(pid) for k in _dur_proc_tree(c)]


def _dur_cli(tmp: str, seed: int) -> dict:
    """Check 4: ``launch ps-server --async --store-dir D --store-wal`` (HOSTS,
    then PSCTL); one epoch of ``launch ps --hosts ... --async`` on
    DUR_CLI_ROWS-row shards, whose rank 0 retires the group at its end
    (the server exits 0); ``ps-server`` again on D (each rank at its
    clock), ``ps-ctl snapshot`` and ``store``, a pull; SIGKILL of the
    whole process tree; ``ps-ctl store --store-dir D`` offline; ``ps-server``
    again on D, whose pull equals the pre-kill pull bit for bit, and whose
    ``ps-ctl resize 3`` answers the JAX package's durable-group refusal
    with its exit 3; SIGTERM: exit 143 and no server left."""
    from distlr_tpu_torch.ps import KVWorker  # noqa: PLC0415

    d, root = os.path.join(tmp, "cli"), os.path.join(tmp, "cli_store")
    _ps_data(d, seed, shard_rows=DUR_CLI_ROWS, test_rows=DUR_CLI_ROWS)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    common = ["--num-feature-dim", str(FULL_D), "--num-servers", str(PS_SERVERS),
              "--num-workers", str(PS_WORKERS)]
    procs = []

    def ps_server():
        proc = subprocess.Popen([sys.executable, "-m", "distlr_tpu_torch.launch", "ps-server",
                                 *common, "--async", "--store-dir", root, "--store-wal"],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        procs.append(proc)
        hosts, ctl = proc.stdout.readline().split(), proc.stdout.readline().split()
        if not hosts or hosts[0] != "HOSTS" or not ctl or ctl[0] != "PSCTL":
            raise AssertionError(f"launch ps-server printed {hosts!r}, {ctl!r}")
        return proc, hosts[1], ctl[1].replace("0.0.0.0", "127.0.0.1")

    def ps_ctl(*argv):
        p = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", "ps-ctl", *argv],
                           cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        doc = [json.loads(ln[6:]) for ln in p.stdout.splitlines() if ln.startswith("PSCTL ")]
        return p.returncode, doc[0] if doc else p.stderr.strip()

    def clocks(doc):
        return {r: v["recovered_clock"] for r, v in sorted(doc["ranks"].items())}

    out = {"rows_per_shard": DUR_CLI_ROWS}
    t0 = time.perf_counter()
    try:
        first, hosts, ctl = ps_server()
        t1 = time.perf_counter()
        _launch("ps", "--data-dir", d, "--hosts", hosts, "--async", "--num-iteration", "1",
                "--test-interval", "1", *common)
        out["launch_ps_s"] = time.perf_counter() - t1
        out["first_server_exit"] = first.wait(timeout=60)  # the workers retired it
        second, hosts, ctl = ps_server()
        out["snapshot"] = ps_ctl("--ctl", ctl, "snapshot")
        code, doc = ps_ctl("--ctl", ctl, "store")
        out["store_live"] = {"exit": code, "recovered_clocks": clocks(doc)}
        with KVWorker(hosts, FULL_D, sync_group=False, timeout_ms=PS_TIMEOUT_MS) as kv:
            before = kv.pull()
        tree = _dur_proc_tree(second.pid)
        for pid in tree:
            os.kill(pid, signal.SIGKILL)
        second.wait(timeout=30)
        deadline = time.monotonic() + 10
        while any(_proc_alive(p) for p in tree) and time.monotonic() < deadline:
            time.sleep(0.05)
        code, doc = ps_ctl("store", "--store-dir", root)
        out["store_offline"] = {"exit": code, "recovered_clocks": clocks(doc)}
        third, hosts, ctl = ps_server()
        servers = _child_pids(third.pid)
        with KVWorker(hosts, FULL_D, sync_group=False, timeout_ms=PS_TIMEOUT_MS) as kv:
            out["pull_equals_pre_kill_bits"] = kv.pull().tobytes() == before.tobytes()
        out["resize_3"] = ps_ctl("--ctl", ctl, "resize", "3")
        third.send_signal(signal.SIGTERM)
        out["sigterm_returncode"] = third.wait(timeout=60)
        deadline = time.monotonic() + 10
        while any(_proc_alive(p) for p in servers) and time.monotonic() < deadline:
            time.sleep(0.05)
        out["servers_left"] = sum(_proc_alive(p) for p in servers)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out["seconds"] = time.perf_counter() - t0
    want_clock = 1 + PS_WORKERS  # the seeding push, one push a worker
    refusal = ("elastic resize of a durable (store_dir) group is not supported: the per-rank "
               "on-disk slices would no longer match the new layout — stop the group, clear "
               "or migrate the store, and restart at the new size")
    ok = (out["first_server_exit"] == 0
          and out["snapshot"] == (0, {"ok": True, "signalled": PS_SERVERS,
                                      "num_servers": PS_SERVERS})
          and out["store_live"]["exit"] == 0 and out["store_offline"]["exit"] == 0
          and set(out["store_live"]["recovered_clocks"].values()) == {want_clock}
          and set(out["store_offline"]["recovered_clocks"].values()) == {want_clock}
          and out["pull_equals_pre_kill_bits"]
          and out["resize_3"] == (3, {"ok": False, "error": refusal})
          and out["sigterm_returncode"] == 143 and out["servers_left"] == 0)
    if not ok:
        raise AssertionError(f"ps_durable cli: {out}")
    return out


def _dur_chaos_push(hosts: str, codec: str, grad) -> dict:
    """``benchmarks/wire_push.py``'s push alone through ``hosts``: the mean
    of DUR_PUSH_REPS pushes after a warm-up, and the bytes of one."""
    from distlr_tpu_torch.ps import KVWorker  # noqa: PLC0415

    with KVWorker(hosts, FULL_D, sync_group=False, compress=codec,
                  timeout_ms=PS_TIMEOUT_MS) as kv:
        if kv.compress_active != codec:
            raise AssertionError(f"ps_durable chaos: {codec!r} not negotiated")
        kv.push_init(grad * 0)
        kv.push(grad)
        wire0 = kv.push_bytes_wire
        t0 = time.perf_counter()
        for _ in range(DUR_PUSH_REPS):
            kv.push(grad)
        return {"push_ms": 1e3 * (time.perf_counter() - t0) / DUR_PUSH_REPS,
                "wire_bytes": (kv.push_bytes_wire - wire0) // DUR_PUSH_REPS}


def _dur_chaos(grad, tmp: str) -> dict:
    """Check 5: ``launch chaos --upstreams`` in front of two 2-server groups
    at D = 1M (sgd for f32 and int8, signsgd for sign; links 0-1 and 2-3),
    one proxy process a rate of DUR_RATES: a push alone of a card gradient
    in f32, int8 and signSGD through it.  Then a ``reset`` after op 3 on
    link 0 under a retrying client: exactly one push absorbed, counted in
    ``push_outcome_unknown``, and the event in ``--events-path``'s log."""
    from distlr_tpu_torch.ps import KVWorker, RetryPolicy, ServerGroup  # noqa: PLC0415

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))

    def chaos(upstreams, faults, events=None):
        plan = os.path.join(tmp, f"chaos-{len(os.listdir(tmp))}.json")
        with open(plan, "w") as f:
            json.dump({"faults": faults}, f)
        argv = [sys.executable, "-m", "distlr_tpu_torch.launch", "chaos", "--upstreams",
                upstreams, "--plan", plan]
        proc = subprocess.Popen(argv + (["--events-path", events] if events else []), cwd=ROOT,
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                text=True)
        line = proc.stdout.readline().split()
        if not line or line[0] != "HOSTS":
            proc.kill()
            raise AssertionError(f"launch chaos printed {line!r}")
        return proc, line[1].split(",")

    out = {"rates_bytes_per_s": DUR_RATES, "pushes": DUR_PUSH_REPS}
    with ServerGroup(PS_SERVERS, 1, FULL_D, sync=False, learning_rate=1e-3) as sgd, \
            ServerGroup(PS_SERVERS, 1, FULL_D, sync=False, learning_rate=1e-3,
                        optimizer="signsgd") as sign:
        upstreams = f"{sgd.direct_hosts},{sign.direct_hosts}"
        for name, rate in DUR_RATES.items():
            faults = [] if rate is None else [{"kind": "throttle", "bytes_per_sec": rate}]
            proc, links = chaos(upstreams, faults)
            line = {}
            try:
                for codec in ("none", "int8", "signsgd"):
                    line[codec] = _dur_chaos_push(",".join(links[:2] if codec != "signsgd"
                                                           else links[2:]), codec, grad)
            finally:
                proc.send_signal(signal.SIGTERM)
                line["exit"] = proc.wait(timeout=30)
            out[name] = line
        out["direct"] = {codec: _dur_chaos_push(sgd.direct_hosts if codec != "signsgd"
                                                else sign.direct_hosts, codec, grad)
                         for codec in ("none", "int8", "signsgd")}
        events = os.path.join(tmp, "reset-events.json")
        proc, links = chaos(sgd.direct_hosts, [{"kind": "reset", "links": [0], "after_ops": 3}],
                            events)
        reset = {}
        try:
            with KVWorker(",".join(links), FULL_D, sync_group=False, timeout_ms=PS_TIMEOUT_MS,
                          retry=RetryPolicy(attempts=4, backoff_ms=20)) as kv:
                kv.push_init(grad * 0)  # op 1 on link 0
                for _ in range(4):      # ops 2-5: op 3's reply is cut
                    kv.push(grad)
                reset.update(push_outcome_unknown=kv.push_outcome_unknown,
                             reconnects=kv.reconnects, retries=dict(kv.retries))
        finally:
            proc.send_signal(signal.SIGTERM)
            reset["exit"] = proc.wait(timeout=30)
        with open(events) as f:
            reset["events"] = json.load(f)["events"]
        out["reset_after_ops"] = reset
    ok = (all(out[n][c]["wire_bytes"] > 0 and out[n]["exit"] == 143
              for n in DUR_RATES for c in ("none", "int8", "signsgd"))
          and reset["push_outcome_unknown"] == 1 and reset["exit"] == 143
          and reset["events"] == [[0, "reset", {"fault": 0, "op": 3}]])
    if not ok:
        raise AssertionError(f"ps_durable chaos: {out}")
    return out


def phase_ps_durable(torch, seed: int, smi: str) -> dict:
    """The PS durable store, its WAL and the chaos fabric at the ps phase's
    full width (config-3 CTR rows at D = 1M, PS_SERVERS native servers,
    PS_WORKERS workers of PS_SHARD_ROWS rows, bf16), each gradient the
    ``fused_lr_grad`` single pass and rank 0's evals ``lr_logits``:

    1. the WAL keeps every acknowledged push (:func:`_dur_wal`);
    2. snapshot-only recovery loses at most an interval
       (:func:`_dur_snapshot_only`);
    3. a power-loss drill through ``run_ps_local`` (:func:`_dur_drill`);
    4. the CLI chain (:func:`_dur_cli`);
    5. throttled links and a reset through ``launch chaos``
       (:func:`_dur_chaos`);

    with a push alone with the WAL off and on and a snapshot's ms
    (:func:`_dur_push_alone`), and the kernels at the path's shapes
    against their plain versions (:func:`_rec_kernel_check`), after the
    runs' launches were read."""
    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.data import parse_libsvm_file  # noqa: PLC0415
    from distlr_tpu_torch.models import get_model  # noqa: PLC0415

    t_phase = time.perf_counter()
    out = {"nvidia_smi": smi, "D": FULL_D, "workers": PS_WORKERS, "servers": PS_SERVERS,
           "shard_rows": PS_SHARD_ROWS, "test_rows": PS_TEST_ROWS,
           "reduced": {"epochs": f"{PS_EPOCHS} (the drill): cut in depth",
                       "pushes": f"{DUR_WAL_PUSHES} (the WAL), {DUR_SNAP_RUN_S} s (snapshot "
                                 "only), one client",
                       "cli": f"{DUR_CLI_ROWS}-row shards at D = {FULL_D}"}}
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    rss = {}
    with _sampled_peak_rss(rss), tempfile.TemporaryDirectory(prefix="distlr-smoke-dur-") as tmp:
        _ps_data(tmp, seed)
        cfg = Config(data_dir=tmp, num_feature_dim=FULL_D, num_workers=PS_WORKERS,
                     num_servers=PS_SERVERS, batch_size=PS_ASYNC_BATCH, num_iteration=PS_EPOCHS,
                     test_interval=1, learning_rate=0.2, l2_c=0.01, compute_dtype="bfloat16",
                     sync_mode=False, ps_timeout_ms=PS_TIMEOUT_MS, ps_store_wal=True,
                     ps_store_dir=os.path.join(tmp, "unused"),
                     ps_retry_attempts=DUR_RETRY_ATTEMPTS)
        model = get_model(cfg)
        w0 = model.init(cfg).numpy().reshape(-1)
        Xt, yt = parse_libsvm_file(os.path.join(tmp, "test", "part-001"), FULL_D)
        Xt = torch.from_numpy(Xt).to(torch.bfloat16).cuda()
        yt = torch.from_numpy(yt).float().cuda()
        init_ll = _test_logloss(torch, ops, torch.from_numpy(w0).cuda(), Xt, yt)
        X, y = parse_libsvm_file(os.path.join(tmp, "train", "part-001"), FULL_D)
        shard = (torch.from_numpy(X).to(torch.bfloat16).cuda(), torch.from_numpy(y).cuda())
        del X
        grad_fn = _dur_grad_fn(torch, model, cfg, shard)
        out["wal"], counts, _ = _bounded(
            torch, lambda: _dur_wal(torch, grad_fn, w0, os.path.join(tmp, "wal")))
        add(counts)
        out["snapshot_only"], counts, _ = _bounded(
            torch, lambda: _dur_snapshot_only(torch, grad_fn, w0, os.path.join(tmp, "snap")))
        add(counts)
        grad = grad_fn(w0)
        del shard
        torch.cuda.empty_cache()
        out["drill"], counts, w_final = _dur_drill(torch, ops, cfg, tmp, Xt, yt, init_ll)
        add(counts)
        out["launches"] = {k: v for k, v in launches.items() if v}
        others = {k: v for k, v in out["launches"].items()
                  if k not in ("fused_lr_grad", "lr_logits")}
        if not launches.get("fused_lr_grad") or not launches.get("lr_logits") or others:
            raise AssertionError(f"ps_durable: launches {launches}")
        out["push_alone"] = _dur_push_alone(grad, os.path.join(tmp, "push"))
        out["kernels_at_ps_shapes"] = _rec_kernel_check(
            torch, ops, torch.from_numpy(w_final).cuda(), tmp, Xt)
        del Xt
        out["cli"] = _dur_cli(tmp, seed)
        chaos_tmp = os.path.join(tmp, "chaos")
        os.makedirs(chaos_tmp)
        out["chaos"] = _dur_chaos(grad, chaos_tmp)
    out.update(rss)
    out["phase_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    emit("ps_durable", **out)
    return out


# --- live membership resizing -------------------------------------------------
# a 2 -> 4 -> 2 reshard of an async group at D = 1M: each direction moves
# [250,000, 500,000) and [750,000, 1,000,000), 500,000 keys of 12 B
ELASTIC_SERVERS, ELASTIC_GROWN = 2, 4
ELASTIC_MOVED_KEYS, ELASTIC_MOVED_BYTES = 500_000, 6_000_000
ELASTIC_FTRL_KEYS, ELASTIC_FTRL_BYTES = 1_000_000, 28_000_000
ELASTIC_GRAD_B, ELASTIC_FTRL_PUSHES = 512, 8
# the live scenario: the JAX package's "double then halve under chaos"
# (tests/test_elastic.py), at D = 1M, with the card's Hogwild pusher beside
# the online trainer; the partition opens on link 0 at ELASTIC_PARTITION_S
# after the group starts, and the grow runs inside it
ELASTIC_SHARDS, ELASTIC_SHARD_ROWS, ELASTIC_TEST_ROWS = 12, 50, 200
ELASTIC_PARTITION_S, ELASTIC_PARTITION_LEN_S = 5.0, 0.7
ELASTIC_LR, ELASTIC_PUSH_PACE_S, ELASTIC_RELOAD_S = 8.0, 0.05, 0.2
ELASTIC_DRAIN_S, ELASTIC_CLI_ROWS = 60.0, 40


def _el_rows(rng, vocab, w_true, n: int):
    """``n`` one-hot rows of the online phase's planted model (ONLINE_FIELDS
    columns a row, |margin| >= 2) and their labels."""
    return _online_rows(rng, vocab, w_true, n, +1)


def _el_write_shards(shard_dir: str, cols, y, start_seq: int) -> int:
    """``cols``/``y`` as ELASTIC_SHARD_ROWS-row libsvm shards, each renamed
    into place whole, numbered from ``start_seq``; returns the next number."""
    os.makedirs(shard_dir, exist_ok=True)
    seq = start_seq
    for lo in range(0, len(y), ELASTIC_SHARD_ROWS):
        path = os.path.join(shard_dir, f"shard-{seq:06d}.libsvm")
        with open(path + ".tmp", "w") as f:
            f.write("".join(f"{int(y[i])} {_features(cols[i])}\n"
                            for i in range(lo, min(lo + ELASTIC_SHARD_ROWS, len(y)))))
        os.replace(path + ".tmp", path)
        seq += 1
    return seq


def _el_at_rest(seed: int) -> dict:
    """Check 1: a seeded w through resize(4) and resize(2) of an async sgd
    group; a ``route=coord.layout`` client pulls w bit for bit after each,
    at epochs 2 and 3, and each direction moves ELASTIC_MOVED_KEYS keys."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.ps import KVWorker, MembershipCoordinator, ServerGroup  # noqa: PLC0415

    w = np.random.default_rng(seed + 60).standard_normal(FULL_D).astype(np.float32)
    out = {}
    with ServerGroup(ELASTIC_SERVERS, 1, FULL_D, sync=False) as g:
        coord = MembershipCoordinator(g)
        with KVWorker(g.hosts, FULL_D, sync_group=False) as kv:
            kv.push_init(w)
        with KVWorker(None, FULL_D, client_id=1, sync_group=False, route=coord.layout) as kv:
            for target, epoch in ((ELASTIC_GROWN, 2), (ELASTIC_SERVERS, 3)):
                stats = coord.resize(target)
                t0 = time.perf_counter()
                pulled = kv.pull()
                stats["pull_after_ms"] = (time.perf_counter() - t0) * 1e3
                if (not np.array_equal(pulled, w) or stats["epoch"] != epoch
                        or kv.client_epoch != epoch or g.num_servers != target
                        or stats["keys_moved"] != ELASTIC_MOVED_KEYS
                        or stats["bytes_moved"] != ELASTIC_MOVED_BYTES):
                    raise AssertionError(f"ps_elastic at rest: {stats}, client epoch "
                                         f"{kv.client_epoch}, bits kept "
                                         f"{np.array_equal(pulled, w)}")
                out[stats["direction"]] = stats
            out["client_reroutes"] = kv.reroutes
    return out


def _el_ftrl(torch, ops, seed: int) -> dict:
    """Check 2: ELASTIC_FTRL_PUSHES gradients of ``fused_lr_grad`` on the
    card at (ELASTIC_GRAD_B, D), pushed into a 2-rank FTRL group, half
    before a resize(4) (a full rebuild: weights and z/n) and half after; the
    pull equals a static 2-rank group's after the same pushes bit for bit."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.ps import KVWorker, MembershipCoordinator, ServerGroup  # noqa: PLC0415

    gen = torch.Generator(device="cuda").manual_seed(seed + 61)
    X = torch.randn((ELASTIC_GRAD_B, FULL_D), generator=gen, device="cuda").bfloat16()
    y = (torch.rand(ELASTIC_GRAD_B, generator=gen, device="cuda") < 0.5).float()
    mask = torch.ones(ELASTIC_GRAD_B, device="cuda")
    grads = []
    for _ in range(ELASTIC_FTRL_PUSHES):
        w = torch.randn(FULL_D, generator=gen, device="cuda") * 0.01
        grads.append(ops.fused_lr_grad(w, X, y, mask).cpu().numpy())
    g_ref = ops.fused_lr_grad_reference(w, X, y, mask).cpu().numpy()
    kernel_err = {"rel_err": rel_err(torch.from_numpy(grads[-1]), torch.from_numpy(g_ref)),
                  "max_abs_err": float(np.abs(grads[-1] - g_ref).max())}
    del X
    half = ELASTIC_FTRL_PUSHES // 2
    with ServerGroup(ELASTIC_SERVERS, 1, FULL_D, sync=False, optimizer="ftrl") as g:
        coord = MembershipCoordinator(g)
        with KVWorker(None, FULL_D, sync_group=False, route=coord.layout) as kv:
            kv.push_init(np.zeros(FULL_D, np.float32))
            for gv in grads[:half]:
                kv.push(gv)
            before = kv.pull()
            stats = coord.resize(ELASTIC_GROWN)
            kept = np.array_equal(kv.pull(), before)
            for gv in grads[half:]:
                kv.push(gv)
            w_elastic = kv.pull()
    with ServerGroup(ELASTIC_SERVERS, 1, FULL_D, sync=False, optimizer="ftrl") as g:
        with KVWorker(g.hosts, FULL_D, sync_group=False) as kv:
            kv.push_init(np.zeros(FULL_D, np.float32))
            for gv in grads:
                kv.push(gv)
            w_static = kv.pull()
    equal = bool(np.array_equal(w_elastic, w_static))
    if (not kept or not equal or stats["reused"] != 0 or stats["spawned"] != ELASTIC_GROWN
            or stats["keys_moved"] != ELASTIC_FTRL_KEYS
            or stats["bytes_moved"] != ELASTIC_FTRL_BYTES or kernel_err["rel_err"] > REL_TOL):
        raise AssertionError(f"ps_elastic ftrl: {stats}, kept {kept}, equal to static {equal}, "
                             f"kernel {kernel_err}")
    return {"resize": stats, "bits_equal_static": equal, "nonzero_weights":
            int(np.count_nonzero(w_static)), "kernel_vs_plain": kernel_err}


def _el_pct(xs, q: float):
    import numpy as np  # noqa: PLC0415

    return float(np.percentile(np.asarray(xs) * 1e3, q)) if len(xs) else None


def _el_live(torch, ops, seed: int, tmp: str) -> dict:
    """Check 3: the JAX package's "double then halve under chaos" at D = 1M.
    A supervised 2-rank sgd group behind a partition on link 0, coordinated
    with the supervisor; a Hogwild pusher thread (pull, ``fused_lr_grad`` on
    the card, push) and an ``OnlineTrainer`` on labelled shards, both
    through ``route=coord.layout``; a ``ScoringEngine`` on the card fed by
    ``LivePSWatcher(route=)`` behind a ``ScoringServer`` and a
    ``ScoringRouter``, with request traffic.  ``resize(4)`` runs inside the
    partition, then ``resize(2)``.  Held to the JAX test's invariants, and
    to a static group's accuracy on the same data."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.chaos import parse_plan  # noqa: PLC0415
    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.feedback import OnlineTrainer  # noqa: PLC0415
    from distlr_tpu_torch.models import get_model  # noqa: PLC0415
    from distlr_tpu_torch.ps import (  # noqa: PLC0415
        KVWorker,
        MembershipCoordinator,
        RetryPolicy,
        ServerGroup,
        ServerSupervisor,
    )
    from distlr_tpu_torch.serve import (  # noqa: PLC0415
        HotReloader,
        LivePSWatcher,
        ScoringRouter,
        ScoringServer,
        score_lines_over_tcp,
    )

    rng = np.random.default_rng(seed + 62)
    vocab = np.sort(rng.choice(FULL_D, size=ONLINE_FIELDS * ONLINE_VOCAB, replace=False)
                    ).reshape(ONLINE_FIELDS, ONLINE_VOCAB)
    w_true = np.zeros(FULL_D, np.float32)
    w_true[vocab] = rng.permuted(np.tile([-1.0, 1.0], ONLINE_VOCAB // 2)[None].repeat(
        ONLINE_FIELDS, 0), axis=1)
    cols, y = _el_rows(rng, vocab, w_true, ELASTIC_SHARDS * ELASTIC_SHARD_ROWS)
    cols_t, y_t = _el_rows(rng, vocab, w_true, ELASTIC_TEST_ROWS)
    cols_p, y_p = _el_rows(rng, vocab, w_true, ELASTIC_GRAD_B)
    test_lines = [_features(c) for c in cols_t]
    X_p = _device_rows(torch, cols_p, FULL_D, torch.bfloat16)
    y_dev, mask = torch.from_numpy(y_p).float().cuda(), torch.ones(ELASTIC_GRAD_B, device="cuda")
    cfg = Config(model="binary_lr", num_feature_dim=FULL_D, batch_size=25, l2_c=0.0,
                 sync_mode=False, learning_rate=ELASTIC_LR, compute_dtype="bfloat16",
                 ps_retry_attempts=6, ps_retry_backoff_ms=25, ps_retry_deadline_s=30)
    model = get_model(cfg)

    def accuracy(w) -> float:
        return float((((w[cols_t].sum(axis=1)) > 0).astype(np.int32) == y_t).mean())

    def push_round(kv) -> int:
        w = torch.from_numpy(kv.pull()).cuda()
        return kv.push(model.grad(w, (X_p, y_dev, mask), cfg).cpu().numpy())

    third = len(y) // 3
    plan = parse_plan({"seed": seed, "faults": [
        {"kind": "partition", "links": [0],
         "window": [ELASTIC_PARTITION_S, ELASTIC_PARTITION_S + ELASTIC_PARTITION_LEN_S]}]})
    shard_dir = os.path.join(tmp, "shards")
    out: dict = {}
    group = ServerGroup(ELASTIC_SERVERS, 1, FULL_D, sync=False, learning_rate=ELASTIC_LR,
                        via_chaos=plan).start()
    sup = ServerSupervisor(group, poll_interval=0.1).start()
    coord = MembershipCoordinator(group, supervisor=sup)
    stop, traffic_stop = threading.Event(), threading.Event()
    errors: list = []
    pusher_state = {"ok": 0, "rounds": 0}
    requests: list[tuple[float, float]] = []
    serve_errs: list[str] = []
    windows: list[tuple[float, float]] = []
    threads, reloader, srv, router, trainer = [], None, None, None, None
    try:
        with KVWorker(group.direct_hosts, FULL_D, sync_group=False) as kv:
            kv.push_init(np.zeros(FULL_D, np.float32))
        pusher_kv = KVWorker(None, FULL_D, client_id=2, sync_group=False,
                             timeout_ms=cfg.ps_timeout_ms, retry=RetryPolicy.from_config(cfg),
                             route=coord.layout)
        trainer = OnlineTrainer(cfg, None, shard_dir, poll_interval_s=0.05, idle_flush_s=0.3,
                                route=coord.layout)

        def pusher():
            try:
                while not stop.is_set():
                    if push_round(pusher_kv) >= 0:
                        pusher_state["ok"] += 1
                    pusher_state["rounds"] += 1
                    if pusher_state["rounds"] == 3:
                        pusher_state["w_probe"] = pusher_kv.pull()
                    stop.wait(ELASTIC_PUSH_PACE_S)
            except Exception as e:  # noqa: BLE001 — re-raised in the main thread
                errors.append(("pusher", e))

        def train():
            try:
                trainer.run(stop=stop)
                trainer._flush_push()
            except Exception as e:  # noqa: BLE001
                errors.append(("trainer", e))

        eng = _serve_engine(torch, FULL_D)
        watcher = LivePSWatcher(None, FULL_D, route=coord.layout, timeout_ms=5000,
                                retry=RetryPolicy.from_config(cfg))
        reloader = HotReloader(eng, watcher, interval_s=ELASTIC_RELOAD_S).start()
        reloader.wait_for_weights(timeout_s=60)
        srv = ScoringServer(eng, max_wait_ms=SERVE_WAIT_MS).start()
        router = ScoringRouter([f"{srv.host}:{srv.port}"]).start()

        def traffic():
            i = 0
            while not traffic_stop.is_set():
                t0 = time.monotonic()
                for r in score_lines_over_tcp(router.host, router.port,
                                              [test_lines[i % len(test_lines)]]):
                    if r.startswith("ERR"):
                        serve_errs.append(r)
                requests.append((t0, time.monotonic() - t0))
                i += 1
                time.sleep(0.002)

        out["setup_done_at_s"] = group.chaos.now()
        for fn, name in ((pusher, "elastic-pusher"), (train, "elastic-online"),
                         (traffic, "elastic-traffic")):
            threads.append(threading.Thread(target=fn, name=name, daemon=True))
            threads[-1].start()
        seq = _el_write_shards(shard_dir, cols[:third], y[:third], 0)
        while group.chaos.now() < ELASTIC_PARTITION_S + 0.05:
            time.sleep(0.01)
        t0 = time.monotonic()
        out["grow_started_at_s"] = group.chaos.now()
        out["grow"] = coord.resize(ELASTIC_GROWN)
        windows.append((t0, time.monotonic()))
        seq = _el_write_shards(shard_dir, cols[third:2 * third], y[third:2 * third], seq)
        time.sleep(0.6)
        t0 = time.monotonic()
        out["shrink"] = coord.resize(ELASTIC_SERVERS)
        windows.append((t0, time.monotonic()))
        seq = _el_write_shards(shard_dir, cols[2 * third:], y[2 * third:], seq)
        deadline = time.monotonic() + ELASTIC_DRAIN_S
        while (sum(n.endswith(".done") for n in os.listdir(shard_dir)) < seq
               and time.monotonic() < deadline and not errors):
            time.sleep(0.05)
        time.sleep(0.5)  # the idle flush pushes the last span
    finally:
        traffic_stop.set()
        stop.set()
        for th in threads:
            th.join(timeout=60)
        for part in (reloader, router, srv):
            if part is not None:
                part.stop()
    try:
        if errors:
            raise AssertionError(f"ps_elastic live: {errors}")
        done = sum(n.endswith(".done") for n in os.listdir(shard_dir))
        issued = pusher_state["ok"] + trainer.pushes + 2  # + the two seeding push_inits
        unknowns = pusher_kv.push_outcome_unknown + trainer.kv.push_outcome_unknown
        applied = group.global_pushes() - coord.seed_pushes / group.num_servers
        with KVWorker(group.direct_hosts, FULL_D, sync_group=False) as kv:
            w_elastic = kv.pull()
        rstats = router.stats()
        out.update({
            "partition": [ELASTIC_PARTITION_S, ELASTIC_PARTITION_S + ELASTIC_PARTITION_LEN_S],
            "epoch": coord.epoch, "servers": group.num_servers,
            "shards": {"written": seq, "consumed": done, "examples": trainer.examples,
                       "rows": len(y)},
            "pusher": {"rounds": pusher_state["rounds"], "acked": pusher_state["ok"],
                       "absorbed": pusher_kv.push_outcome_unknown,
                       "reroutes": pusher_kv.reroutes, "retries": pusher_kv.retries,
                       "epoch_mismatches": pusher_kv.epoch_mismatches},
            "online": {"pushes": trainer.pushes, "absorbed": trainer.kv.push_outcome_unknown,
                       "reroutes": trainer.kv.reroutes},
            "watcher_reroutes": watcher.kv.reroutes,
            "audit": {"applied": applied, "issued": issued, "unknown": unknowns,
                      "seed_pushes": coord.seed_pushes},
            "serve": {"requests": len(requests), "err_replies": len(serve_errs),
                      "router_errors": rstats["errors"]},
            "supervisor_events": list(sup.events)})
        inside = [s for t, s in requests if any(a <= t <= b for a, b in windows)]
        outside = [s for t, s in requests if not any(a <= t <= b for a, b in windows)]
        out["serve_latency_ms"] = {
            "in_resize": {"n": len(inside), "p50": _el_pct(inside, 50), "p99": _el_pct(inside, 99)},
            "outside": {"n": len(outside), "p50": _el_pct(outside, 50),
                        "p99": _el_pct(outside, 99)}}
    finally:
        pusher_kv.close()
        trainer.close()
        sup.stop()
        group.stop()
    # the main path's launches end here: the twin and the comparison follow
    out["_launches"] = _launches(ops)
    # the static twin: the same shards and the same pusher rounds, no churn
    static_dir = os.path.join(tmp, "static")
    _el_write_shards(static_dir, cols, y, 0)
    with ServerGroup(ELASTIC_SERVERS, 1, FULL_D, sync=False, learning_rate=ELASTIC_LR) as g2:
        tr = OnlineTrainer(cfg, g2.hosts, static_dir, poll_interval_s=0.05)
        tr.run(max_shards=seq)
        tr._flush_push()
        tr.close()
        with KVWorker(g2.hosts, FULL_D, sync_group=False) as kv:
            for _ in range(pusher_state["rounds"]):
                push_round(kv)
            w_static = kv.pull()
    out["accuracy"] = {"elastic": accuracy(w_elastic), "static": accuracy(w_static)}
    w_probe = torch.from_numpy(pusher_state.get("w_probe", w_static)).cuda()
    g_k, g_ref = ops.fused_lr_grad(w_probe, X_p, y_dev, mask), ops.fused_lr_grad_reference(
        w_probe, X_p, y_dev, mask)
    out["pusher_grad_vs_plain"] = {"rel_err": rel_err(g_k, g_ref),
                                   "max_abs_err": float((g_k - g_ref).abs().max())}
    bad = []
    if out["serve"]["err_replies"] or out["serve"]["router_errors"] or not requests:
        bad.append("serving errors")
    if out["supervisor_events"]:
        bad.append("supervisor events")
    if done != seq or trainer.examples != len(y):
        bad.append("shards not consumed exactly once")
    if (coord.epoch, out["servers"]) != (3, ELASTIC_SERVERS):
        bad.append("epoch / servers")
    if applied > issued + unknowns + 1:
        bad.append("applied > issued + unknown + 1")
    if out["accuracy"]["static"] <= 0.9 or out["accuracy"]["elastic"] < (
            out["accuracy"]["static"] - 0.01):
        bad.append("accuracy")
    if not (ELASTIC_PARTITION_S <= out["grow_started_at_s"]
            <= ELASTIC_PARTITION_S + ELASTIC_PARTITION_LEN_S):
        bad.append("the grow ran outside the partition")
    if out["pusher_grad_vs_plain"]["rel_err"] > REL_TOL:
        bad.append("the pusher's gradient disagrees with the plain version")
    if bad:
        raise AssertionError(f"ps_elastic live: {bad}: {out}")
    return out


def _el_cli(torch, ops, seed: int, tmp: str) -> dict:
    """Check 4: ``launch ps-server --elastic --async`` at D = 1M prints
    PSCTL; ``launch serve --ps-ctl`` and ``launch online --ps-ctl`` run
    against it; ``launch ps-ctl resize 4`` exits 0, then ``resize 2
    --no-wait`` and ``status`` polls until ``last_resize.ok``.  A served
    score after each resize equals σ(plain logits) of a direct pull."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.ps import KVWorker, layout_client  # noqa: PLC0415
    from distlr_tpu_torch.serve import score_lines_over_tcp  # noqa: PLC0415

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, lines_of = {}, {}
    shard_dir = os.path.join(tmp, "cli-shards")

    def start(name, *argv):
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "distlr_tpu_torch.launch", *argv], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def ready(name, *keys):
        for key in keys:
            line = procs[name].stdout.readline().strip()
            got, _, rest = line.partition(" ")
            if got != key:
                raise AssertionError(f"launch {name} printed {line!r}, not {key}")
            lines_of[key] = rest

    def ctl(*argv) -> tuple[int, dict]:
        p = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", "ps-ctl", "--ctl",
                            addr, *argv], cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=120)
        last = (p.stdout.strip().splitlines() or ["PSCTL {}"])[-1]
        return p.returncode, json.loads(last[len("PSCTL "):])

    rng = np.random.default_rng(seed + 63)
    cols = np.stack([np.sort(rng.choice(FULL_D, ONLINE_FIELDS, replace=False))
                     for _ in range(ELASTIC_CLI_ROWS)])
    w0 = _bf16_exact(torch, _serve_weights(rng, FULL_D, cols))
    y = (w0[cols].sum(axis=1) > 0).astype(np.int32)
    req = [_features(c) for c in cols]
    out: dict = {}

    def served_vs_pull(what: str) -> dict:
        """Served scores against σ(plain logits of a direct pull); polls
        until the serve's reload caught up (ELASTIC_DRAIN_S at most)."""
        host, port = lines_of["SERVING"].rsplit(":", 1)
        deadline = time.monotonic() + ELASTIC_DRAIN_S
        while True:
            with KVWorker(None, FULL_D, client_id=9, sync_group=False,
                          route=layout_client(addr)) as kv:
                w = kv.pull()
            labels, scores = _parse_libsvm_replies(score_lines_over_tcp(host, int(port), req))
            try:
                return _check_replies(torch, f"ps_elastic cli {what}", labels, scores,
                                      _plain_logits(torch, ops, torch.from_numpy(w).cuda(),
                                                    cols, FULL_D))
            except AssertionError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(ELASTIC_RELOAD_S)

    try:
        start("ps-server", "ps-server", "--num-feature-dim", str(FULL_D), "--num-servers",
              str(ELASTIC_SERVERS), "--async", "--elastic")
        ready("ps-server", "HOSTS", "PSCTL")
        addr = "127.0.0.1:" + lines_of["PSCTL"].rsplit(":", 1)[1]
        with KVWorker(lines_of["HOSTS"], FULL_D, sync_group=False) as kv:
            kv.push_init(w0)
        # the two clients start side by side: both wait for the seeded group
        start("serve", "serve", "--num-feature-dim", str(FULL_D), "--ps-ctl", addr, "--port",
              "0", "--reload-interval", str(ELASTIC_RELOAD_S), "--feature-dtype", "bfloat16")
        start("online", "online", "--num-feature-dim", str(FULL_D), "--l2-c", "0", "--ps-ctl",
              addr, "--shard-dir", shard_dir, "--max-shards", "2", "--poll-interval", "0.05")
        ready("serve", "SERVING")
        ready("online", "ONLINE")
        rc, doc = ctl("resize", str(ELASTIC_GROWN))
        out["resize_4"] = {"exit": rc, **doc}
        out["served_after_grow"] = served_vs_pull("after the grow")
        _el_write_shards(shard_dir, cols[:ELASTIC_CLI_ROWS // 2], y[:ELASTIC_CLI_ROWS // 2], 0)
        deadline = time.monotonic() + ELASTIC_DRAIN_S
        while not os.path.exists(os.path.join(shard_dir, "shard-000000.libsvm.done")):
            if time.monotonic() > deadline:
                raise AssertionError("ps_elastic cli: launch online consumed no shard")
            time.sleep(0.05)
        rc, doc = ctl("resize", str(ELASTIC_SERVERS), "--no-wait")
        out["resize_2_no_wait"] = {"exit": rc, **doc}
        polls = 0
        while True:
            polls += 1
            _, st = ctl("status")
            last = st.get("last_resize") or {}
            if st.get("status") == "active" and last.get("epoch") == 3:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"ps_elastic cli: status {st}")
            time.sleep(0.1)
        out["status_polls"], out["last_resize"] = polls, last
        _el_write_shards(shard_dir, cols[ELASTIC_CLI_ROWS // 2:], y[ELASTIC_CLI_ROWS // 2:], 1)
        out["exits"] = {"online": procs["online"].wait(timeout=ELASTIC_DRAIN_S)}
        out["served_after_shrink"] = served_vs_pull("after the shrink")
        for name in ("serve", "ps-server"):
            procs[name].send_signal(signal.SIGTERM)
            out["exits"][name] = procs[name].wait(timeout=60)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if (out["resize_4"]["exit"] != 0 or not out["resize_4"].get("ok")
            or out["resize_4"].get("epoch") != 2 or not out["resize_2_no_wait"].get("accepted")
            or not out["last_resize"].get("ok")
            or out["exits"] != {"online": 0, "serve": 143, "ps-server": 143}):
        raise AssertionError(f"ps_elastic cli: {out}")
    return out


def phase_ps_elastic(torch, seed: int, smi: str) -> dict:
    """Live membership resizing at D = 1M (async, binary_lr), through the
    entry points a user calls: (1) bits at rest across a 2 -> 4 -> 2
    reshard (:func:`_el_at_rest`); (2) an FTRL group's reshard on card
    gradients, bit-equal to a static group's (:func:`_el_ftrl`); (3) the
    live scenario under chaos with the card's pusher, the online trainer
    and a serving engine on the card (:func:`_el_live`); (4) the CLI chain
    (:func:`_el_cli`).  The launch counts are zeroed just before checks 2
    and 3 and read after them, before their kernel-vs-plain comparisons."""
    from distlr_tpu_torch import ops  # noqa: PLC0415

    t_phase = time.perf_counter()
    out = {"nvidia_smi": smi, "D": FULL_D, "servers": [ELASTIC_SERVERS, ELASTIC_GROWN,
                                                       ELASTIC_SERVERS],
           "reduced": {"live": f"{ELASTIC_SHARDS} shards of {ELASTIC_SHARD_ROWS} rows, one "
                               "online trainer, one pusher, one engine: a smoke test",
                       "ftrl": f"{ELASTIC_FTRL_PUSHES} pushes"}}
    rss: dict = {}
    with _sampled_peak_rss(rss), tempfile.TemporaryDirectory(prefix="distlr-smoke-el-") as tmp:
        t0 = time.perf_counter()
        out["at_rest"] = _el_at_rest(seed)
        out["at_rest"]["check_s"] = time.perf_counter() - t0
        launches = {}
        for name, fn in (("ftrl", lambda: _el_ftrl(torch, ops, seed)),
                         ("live", lambda: _el_live(torch, ops, seed, tmp))):
            t0 = time.perf_counter()
            out[name], counts, _ = _bounded(torch, fn)
            counts = out[name].pop("_launches", counts)
            out[name]["check_s"] = time.perf_counter() - t0
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        # each count was read before its check's comparison launches
        out["launches"] = {k: v for k, v in launches.items() if v}
        others = {k: v for k, v in out["launches"].items()
                  if k not in ("fused_lr_grad", "lr_logits")}
        if not launches.get("fused_lr_grad") or not launches.get("lr_logits") or others:
            raise AssertionError(f"ps_elastic: launches {launches}")
        t0 = time.perf_counter()
        out["cli"] = _el_cli(torch, ops, seed, tmp)
        out["cli"]["check_s"] = time.perf_counter() - t0
    out.update(rss)
    out["phase_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    emit("ps_elastic", **out)
    return out


# --- hot-row serving from a live PS ------------------------------------------
HOT_ROWS, HOT_PROBE_ROWS, HOT_FULL_EVERY, HOT_INTERVAL_S, HOT_EPOCHS = 4096, 64, 10, 0.05, 24


def phase_serve_hot(torch, seed: int, smi: str) -> dict:
    """Hot-row serving at D = 1M: a ``blocked_lr`` engine (R = KEYED_BLOCK,
    config 4's 21 fields) behind a ``ScoringServer`` with a live-PS
    ``HotReloader`` whose ``LivePSWatcher`` refreshes a ``HotSetTracker``'s
    rows (``pull_rows_into``) between full refreshes, while one async keyed
    worker on the card pushes to the group and a client streams one JSON
    batch of HOT_PROBE_ROWS fixed rows.  Pass: >= 2 hot reloads while the
    worker trains and >= 1 full one, no ERR, >= 2 distinct score vectors;
    once the worker stops, a
    hot poll's rows equal a full ``pull_chunked`` of those rows bit for bit,
    and the replies are within SERVE_SCORE_TOL of σ(plain logits) on the
    published table.  The worker runs as rank 1 of a one-worker group, so
    its exit leaves the servers up (rank 0 retires them)."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.data import hashing  # noqa: PLC0415
    from distlr_tpu_torch.ps import KVWorker, ServerGroup  # noqa: PLC0415
    from distlr_tpu_torch.serve import (  # noqa: PLC0415
        HotReloader,
        HotSetTracker,
        LivePSWatcher,
        ScoringEngine,
        ScoringServer,
        score_lines_over_tcp,
    )
    from distlr_tpu_torch.train.ps_trainer import run_ps_workers  # noqa: PLC0415

    R, D = KEYED_BLOCK, SPARSE_D
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="distlr-smoke-hot-") as tmp:
        d = _keyed_data(tmp, "blocked_lr", seed + 20)
        cfg = _keyed_cfg(d, "blocked_lr").replace(
            sync_mode=False, num_workers=1, num_iteration=HOT_EPOCHS, test_interval=0)
        with open(os.path.join(d, "test", "part-001")) as f:
            probe_lines = [ln.strip() for ln, _ in zip(f, range(HOT_PROBE_ROWS))]
        probe = json.dumps({"rows": probe_lines})
        eng = ScoringEngine(Config(model="blocked_lr", num_feature_dim=D, block_size=R,
                                   ctr_fields=SPARSE_FIELDS, l2_c=0.0),
                            max_batch_size=SERVE_BUCKETS[-1], buckets=SERVE_BUCKETS)
        rows = eng.encode_lines(probe_lines)
        probe_keys = eng.row_keys(rows)
        with ServerGroup(PS_SERVERS, 1, D, learning_rate=cfg.learning_rate, sync=False) as sg:
            with KVWorker(sg.hosts, D, client_id=2) as kv:
                kv.push_init(np.zeros(D, np.float32))
            tracker = HotSetTracker(HOT_ROWS)
            watcher = LivePSWatcher(sg.hosts, D, vals_per_key=R, hot_tracker=tracker,
                                    full_refresh_every=HOT_FULL_EVERY)
            if watcher.vals_per_key != R:
                raise AssertionError(f"serve_hot: the watcher pulls vals_per_key="
                                     f"{watcher.vals_per_key}, not {R}")
            reloader = HotReloader(eng, watcher, interval_s=HOT_INTERVAL_S)
            reloader.wait_for_weights(60)
            reloader.start()
            errors = []

            def train():
                try:
                    run_ps_workers(cfg, sg.hosts, [1])
                except Exception as e:  # noqa: BLE001 — re-raised below
                    errors.append(e)

            with ScoringServer(eng, max_wait_ms=SERVE_WAIT_MS, reloader=reloader,
                               hot_tracker=tracker) as srv:
                client = _StreamingProbe(srv.host, srv.port, probe)
                client.wait_for(5)
                t0 = time.perf_counter()
                trainer = threading.Thread(target=train, daemon=True, name="smoke-serve-hot")
                trainer.start()
                trainer.join(PS_WALL_S)
                train_s = time.perf_counter() - t0
                if trainer.is_alive():
                    raise AssertionError(f"serve_hot: the worker did not end within "
                                         f"{PS_WALL_S} s")
                if errors:
                    raise errors[0]
                # two hot polls that began after the last push (no forced
                # full refresh from here: the last poll is a hot one)
                watcher.full_refresh_every = 0
                hot_at_end = watcher.hot_reloads
                t1 = time.perf_counter()
                while watcher.hot_reloads < hot_at_end + 2 and time.perf_counter() - t1 < 30:
                    time.sleep(HOT_INTERVAL_S / 2)
                n_replies = len(client.replies)
                client.wait_for(n_replies + 5, timeout_s=10)
                client.stop()
                reloader.stop()
                stats = srv.stats()
                final = json.loads(score_lines_over_tcp(srv.host, srv.port, [probe])[0])
            table = eng.get_weights().reshape(-1)
            with KVWorker(sg.hosts, D, client_id=3) as kv:
                full = kv.pull_chunked(vals_per_key=R)
                rows_now = kv.pull_chunked(probe_keys, vals_per_key=R)
                hot_keys = tracker.hot_keys()
                hot_table = table.copy()
                rows_ms, full_ms = [], []
                for _ in range(3):
                    t0 = time.perf_counter()
                    kv.pull_rows_into(hot_table, hot_keys, vals_per_key=R)
                    rows_ms.append(1e3 * (time.perf_counter() - t0))
                    t0 = time.perf_counter()
                    kv.pull_chunked(vals_per_key=R)
                    full_ms.append(1e3 * (time.perf_counter() - t0))
    src = stats["reload"]["source"]
    replies = [json.loads(r) for r in client.replies if not r.startswith("ERR")]
    distinct = {tuple(r["scores"]) for r in replies}
    if (client.errors or len(replies) != len(client.replies) or len(distinct) < 2
            or hot_at_end < 2 or src["full_reloads"] < 1):
        raise AssertionError(f"serve_hot: {client.errors}, {len(client.replies)} replies, "
                             f"{len(replies)} not ERR, {len(distinct)} distinct, {src}")
    hot_rows_equal = bool(np.array_equal(table.reshape(-1, R)[probe_keys.astype(np.int64)],
                                         rows_now.reshape(-1, R)))
    if src["last_kind"] != "hot" or not hot_rows_equal:
        raise AssertionError(f"serve_hot: the last poll was {src['last_kind']}; its rows equal "
                             f"a full pull's: {hot_rows_equal}")
    # σ(plain logits) on the published table, on the card
    t = torch.from_numpy(table.reshape(-1, R)).cuda()
    blocks, lane_vals = (torch.from_numpy(np.asarray(a)).cuda() for a in rows[:2])
    plain = torch.sigmoid((t[blocks] * lane_vals).sum(dim=(-1, -2))).cpu().numpy()
    err = float(np.abs(np.asarray(final["scores"]) - plain).max())
    if err > SERVE_SCORE_TOL:
        raise AssertionError(f"serve_hot: replies differ from σ(plain logits) by {err}")
    stale = int((table != full).sum())
    out = {"nvidia_smi": smi, "D": D, "block_size": R, "servers": PS_SERVERS,
           "hot_capacity": HOT_ROWS, "probe_rows": HOT_PROBE_ROWS,
           "probe_row_keys": int(probe_keys.size), "full_refresh_every": HOT_FULL_EVERY,
           "interval_s": HOT_INTERVAL_S, "worker_epochs": HOT_EPOCHS, "train_s": train_s,
           "replies": len(client.replies), "distinct_score_vectors": len(distinct),
           "reloads": stats["reload"]["reloads"], "reload_errors": stats["reload"]["reload_errors"],
           "source": src, "hot_reloads_while_training": hot_at_end,
           "hot_rows_equal_full_pull": hot_rows_equal,
           "replies_vs_plain": err, "tolerance": SERVE_SCORE_TOL,
           "cold_slots_stale_at_end": stale, "hot_keys": int(hot_keys.size),
           "pull_rows_into_ms": rows_ms, "pull_chunked_full_ms": full_ms,
           "hot_wire_bytes": int(hot_keys.size) * (8 + 4 * R),
           "full_wire_bytes": (D // R) * (8 + 4 * R),
           "phase_s": time.perf_counter() - t_phase,
           "reduced": {"traffic": "one streaming client and one JSON batch (a smoke test)",
                       "worker": f"one async worker, {HOT_EPOCHS} epochs of "
                                 f"{KEYED_SHARD_ROWS} rows"}}
    del eng, t
    torch.cuda.empty_cache()
    emit("serve_hot", **out)
    return out


# --- the serving control plane ----------------------------------------------
# two replicas, each hosting the engines v1 and v2 at D = 1M (A reloads both
# live from one PS group of two namespaces, B serves text models), behind one
# ScoringRouter; 8 clients of single lines and JSON batches of 37-256 rows
# (host densify of a 1M-wide row costs ~1 ms, ROADMAP A.19: the batches
# stay small but one 1,024-row request to v1)
ROUTE_CLIENTS, ROUTE_ROWS, ROUTE_JSON_ROWS, ROUTE_BIG_JSON = 8, 4096, (37, 64, 128, 256), 1024
ROUTE_SINGLES = 8             # a client's lines of each addressing, mixed stage
ROUTE_SPLIT, ROUTE_SPLIT_LINES = 0.25, 50
ROUTE_SHADOW, ROUTE_SHADOW_LINES, ROUTE_SHADOW_BLOCK = 0.5, 32, 32
# v2's quota: sheds come in the mixed stage's burst of v2 lines
ROUTE_QUOTA_RATE, ROUTE_QUOTA_BURST = 5.0, 5.0
ROUTE_MAX_INFLIGHT, ROUTE_EJECT_AFTER = 16, 3
ROUTE_HEALTH_S, ROUTE_BACKOFF_S, ROUTE_BACKOFF_MAX_S = 0.5, 0.2, 2.0
ROUTE_RELOAD_S, ROUTE_CLIENT_TIMEOUT_S = 0.5, 120.0
ROUTE_STAGES, ROUTE_HOP_PAIRS = "0.25:0.5,0.5:0.5,1.0:0.5", 10
# v2 = v1 + ROUTE_V2_SHIFT / CTR_FIELDS: every row has CTR_FIELDS ones, so its
# v2 logit is its v1 logit + ~2, and every reply matches exactly one version
ROUTE_V2_SHIFT = 2.0


def _bf16_exact(torch, w):
    """``w`` rounded to bfloat16 values, kept in float32: their ``%g`` text
    reads back to the same bf16 products, so a text-model replica and a
    live-PS one score the same bits."""
    return torch.from_numpy(w).bfloat16().float().numpy()


class _RouteClient:
    """One client of the route phase: two connections to the router (one
    unscoped, one ``MODEL v2``-scoped), sending its requests in order, or
    round and round until stopped (``stream``); keeps ``(request, reply,
    seconds)`` for each.  A transport error or a timeout is recorded and
    ends the client."""

    def __init__(self, host, port, requests, *, stream=False):
        self.requests, self.stream = requests, stream
        self.results: list = []
        self.errors: list[str] = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, args=(host, port), daemon=True)

    def _run(self, host, port):
        import socket  # noqa: PLC0415

        conns = []
        try:
            for scoped in (False, True):
                s = socket.create_connection((host, port), timeout=ROUTE_CLIENT_TIMEOUT_S)
                f = s.makefile("rwb")
                conns.append((s, f))
                if scoped:
                    f.write(b"MODEL v2\n")
                    f.flush()
                    if f.readline().decode().strip() != "OK MODEL v2":
                        raise AssertionError("MODEL v2 was not acknowledged")
            i = 0
            while not self._stop.is_set() and (self.stream or i < len(self.requests)):
                req = self.requests[i % len(self.requests)]
                f = conns[req["scoped"]][1]
                t0 = time.perf_counter()
                f.write((req["wire"] + "\n").encode())
                f.flush()
                reply = f.readline()
                if not reply:
                    raise ConnectionError("the router closed the connection")
                self.results.append((req, reply.decode().strip(), time.perf_counter() - t0))
                i += 1
        except Exception as e:  # noqa: BLE001 — checked by the phase
            self.errors.append(f"{type(e).__name__}: {e}")
        finally:
            for s, f in conns:
                f.close()
                s.close()

    def start(self) -> "_RouteClient":
        self._t.start()
        return self

    def join(self, stop: bool = False) -> "_RouteClient":
        if stop:
            self._stop.set()
        self._t.join(ROUTE_CLIENT_TIMEOUT_S)
        if self._t.is_alive():
            raise AssertionError("route: a client hangs past its timeout")
        return self


def _route_request(lines, rows, *, address="none", want="v1"):
    """A request of ``rows`` (indices into the phase's rows): one libsvm line,
    or a JSON batch for several; unaddressed, ``@v2``-prefixed or sent on
    the ``MODEL v2``-scoped connection; ``want`` is the version that must
    answer (None: either, for split traffic)."""
    body = lines[rows[0]] if len(rows) == 1 else json.dumps({"rows": [lines[r] for r in rows]})
    return {"wire": f"@v2 {body}" if address == "at" else body, "rows": list(rows),
            "scoped": address == "scope", "address": address, "want": want}


def _route_verdict(req, reply, s1, s2) -> str:
    """Which version answered: ``v1`` / ``v2`` (the reply's scores within
    SERVE_SCORE_TOL of σ(plain logits) for exactly that one), or ``shed`` /
    ``route`` for ``ERR SHED`` / ``ERR ROUTE``.  Any other reply, or
    scores that match neither or both, raise."""
    import numpy as np  # noqa: PLC0415

    if reply.startswith(("ERR SHED", "ERR ROUTE")):
        return "shed" if reply.startswith("ERR SHED") else "route"
    if reply.startswith("ERR"):
        raise AssertionError(f"route: {req['wire'][:80]!r} answered {reply!r}")
    scores = (np.asarray(json.loads(reply)["scores"]) if reply.startswith("{")
              else np.asarray([float(reply.split()[1])]))
    rows = np.asarray(req["rows"])
    match = [float(np.abs(scores - s[rows]).max()) <= SERVE_SCORE_TOL for s in (s1, s2)]
    if sum(match) != 1:
        raise AssertionError(f"route: a reply of {len(rows)} rows matches "
                             f"{['v1', 'v2'] if all(match) else 'neither version'}")
    version = "v1" if match[0] else "v2"
    if req["want"] is not None and version != req["want"]:
        raise AssertionError(f"route: {req['address']}-addressed traffic for {req['want']} "
                             f"was answered by {version}")
    return version


def _route_tally(clients, s1, s2) -> dict:
    """Every reply of ``clients`` checked (:func:`_route_verdict`); the
    count of each verdict, and the client seconds of the scored ones."""
    tally = {"v1": 0, "v2": 0, "shed": 0, "route": 0, "tenant_shed": 0}
    for c in clients:
        if c.errors:
            raise AssertionError(f"route: a client failed: {c.errors}")
        for req, reply, _ in c.results:
            tally[_route_verdict(req, reply, s1, s2)] += 1
            tally["tenant_shed"] += reply.startswith("ERR SHED tenant")
    return tally


def _run_clients(host, port, per_client) -> list:
    clients = [_RouteClient(host, port, reqs).start() for reqs in per_client]
    return [c.join() for c in clients]


def _stats(host, port) -> dict:
    from distlr_tpu_torch.serve import score_lines_over_tcp  # noqa: PLC0415

    return json.loads(score_lines_over_tcp(host, port, ["STATS"])[0])


def _route_mixed(host, port, lines, rng, s1, s2) -> dict:
    """Check 1 and 4: ROUTE_CLIENTS clients, each ROUTE_SINGLES lines
    unaddressed, @v2-prefixed and MODEL v2-scoped, and one JSON batch of
    ROUTE_JSON_ROWS rows (alternately unaddressed and @v2), shuffled;
    then the ROUTE_BIG_JSON-row batch to v1 alone."""
    per_client = []
    for k in range(ROUTE_CLIENTS):
        reqs = [_route_request(lines, [int(r)], address=a, want="v1" if a == "none" else "v2")
                for a in ("none", "at", "scope")
                for r in rng.integers(0, ROUTE_ROWS, ROUTE_SINGLES)]
        n = ROUTE_JSON_ROWS[k % len(ROUTE_JSON_ROWS)]
        a = "at" if k % 2 else "none"
        reqs.append(_route_request(lines, rng.integers(0, ROUTE_ROWS, n).tolist(), address=a,
                                   want="v2" if a == "at" else "v1"))
        per_client.append([reqs[i] for i in rng.permutation(len(reqs))])
    t0 = time.perf_counter()
    clients = _run_clients(host, port, per_client)
    mixed_s = time.perf_counter() - t0
    big = _RouteClient(host, port, [_route_request(
        lines, rng.integers(0, ROUTE_ROWS, ROUTE_BIG_JSON).tolist())]).start().join()
    tally = _route_tally(clients + [big], s1, s2)
    if tally["route"] or tally["shed"] != tally["tenant_shed"] or not tally["tenant_shed"]:
        raise AssertionError(f"route mixed: want tenant sheds only, and some: {tally}")
    return {"requests": sum(len(c.results) for c in clients) + 1, "seconds": mixed_s,
            "big_json_ms": 1e3 * big.results[0][2], **tally}


def _route_split(host, port, lines, rng, s1, s2) -> dict:
    """Check 2: SPLIT v1 v2 ROUTE_SPLIT, then ROUTE_CLIENTS x
    ROUTE_SPLIT_LINES unaddressed lines: the share v2 answered lies within
    a binomial 4σ of the weight."""
    from distlr_tpu_torch.serve import RouterAdmin  # noqa: PLC0415

    admin = RouterAdmin(host, port)
    admin.expect_ok(f"SPLIT v1 v2 {ROUTE_SPLIT:g}")
    clients = _run_clients(host, port, [
        [_route_request(lines, [int(r)], want=None)
         for r in rng.integers(0, ROUTE_ROWS, ROUTE_SPLIT_LINES)]
        for _ in range(ROUTE_CLIENTS)])
    admin.expect_ok("SPLIT v1 v2 0")
    tally = _route_tally(clients, s1, s2)
    n = tally["v1"] + tally["v2"]
    share, sigma = tally["v2"] / n, math.sqrt(ROUTE_SPLIT * (1 - ROUTE_SPLIT) / n)
    if n != ROUTE_CLIENTS * ROUTE_SPLIT_LINES or abs(share - ROUTE_SPLIT) > 4 * sigma:
        raise AssertionError(f"route split: v2 answered {tally['v2']} of {n} "
                             f"(weight {ROUTE_SPLIT}, 4σ = {4 * sigma:.4f})")
    return {"weight": ROUTE_SPLIT, "requests": n, "v2_share": share, "four_sigma": 4 * sigma}


def _route_shadow(router, host, port, lines, rng, s1, s2) -> dict:
    """Check 3: SHADOW v1 v2 ROUTE_SHADOW: every primary reply is v1's,
    and STATS' shadow holds a finite PSI above 0."""
    from distlr_tpu_torch.serve import RouterAdmin  # noqa: PLC0415

    admin = RouterAdmin(host, port)
    admin.expect_ok(f"SHADOW v1 v2 {ROUTE_SHADOW:g}")
    clients = _run_clients(host, port, [
        [_route_request(lines, [int(r)]) for r in rng.integers(0, ROUTE_ROWS, ROUTE_SHADOW_LINES)]
        for _ in range(ROUTE_CLIENTS)])
    router._shadow_mirror.drain(60.0)
    shadow = _stats(host, port)["shadow"]
    admin.expect_ok("SHADOW v1 v2 0")
    tally = _route_tally(clients, s1, s2)
    pair = shadow["pairs"].get("v1->v2", {})
    psi = pair.get("psi")
    if tally["v1"] != ROUTE_CLIENTS * ROUTE_SHADOW_LINES or psi is None or not (
            math.isfinite(psi) and psi > 0):
        raise AssertionError(f"route shadow: {tally}, shadow stats {shadow}")
    return {"fraction": ROUTE_SHADOW, "primary_replies": tally["v1"], **shadow}


def _route_failover(router, host, port, lines, rng, s1, s2, restart_b) -> dict:
    """Check 5: clients stream unaddressed and @v2 lines; replica B is
    aborted mid-stream and restarted on its port half a second after the
    router ejected it.  Every
    reply is a version's scores, ERR SHED or ERR ROUTE; the router retried
    and ejected, and reinstated B within ROUTE_BACKOFF_MAX_S of its
    restart."""
    before = _stats(host, port)
    clients = [_RouteClient(host, port, [
        _route_request(lines, [int(r)], address=a, want="v1" if a == "none" else "v2")
        for a in ("none", "at") for r in rng.integers(0, ROUTE_ROWS, 16)], stream=True).start()
        for _ in range(ROUTE_CLIENTS)]
    time.sleep(1.0)
    t_abort = time.perf_counter()
    b_addr = restart_b(None)      # abort B
    rep_b = next(r for r in router.replicas if r.addr == b_addr)
    while rep_b.healthy and time.perf_counter() - t_abort < 30:
        time.sleep(0.01)
    ejected_s = time.perf_counter() - t_abort
    time.sleep(0.5)
    t_restart = time.perf_counter()
    restart_b(b_addr)             # B again, on its port
    while not rep_b.healthy and time.perf_counter() - t_restart < 30:
        time.sleep(0.01)
    reinstate_s = time.perf_counter() - t_restart
    time.sleep(0.5)               # traffic on both again
    for c in clients:
        c.join(stop=True)
    after = _stats(host, port)
    tally = _route_tally(clients, s1, s2)
    delta = {k: after[k] - before[k] for k in ("retries", "shed", "errors", "requests")}
    ejections = sum(r["ejections"] for r in after["replicas"])
    reinstates = sum(r["reinstates"] for r in after["replicas"])
    if (delta["retries"] < 1 or ejections < 1 or reinstates < 1
            or reinstate_s > ROUTE_BACKOFF_MAX_S or not rep_b.healthy):
        raise AssertionError(f"route failover: {delta}, ejections {ejections}, reinstates "
                             f"{reinstates}, reinstated {reinstate_s:.3f} s after the restart")
    return {"replies": sum(tally[k] for k in ("v1", "v2", "shed", "route")), **tally,
            **{f"{k}_delta": v for k, v in delta.items()}, "ejections": ejections,
            "reinstates": reinstates, "eject_after_abort_s": ejected_s,
            "reinstate_after_restart_s": reinstate_s, "probe_backoff_max_s": ROUTE_BACKOFF_MAX_S}


def _route_ramp(host, port, lines, rng, s1, s2, *, fire: bool, journal: str) -> dict:
    """Checks 6 and 7: a RolloutController over ROUTE_STAGES, unwatched
    (``fire`` False: it must promote) or with a scripted poller that fires
    at stage 2 (it must roll back), while a client streams unaddressed
    lines; after it, unaddressed replies are v2's (promoted) or v1's."""
    from distlr_tpu_torch.serve import RolloutController, RouterAdmin  # noqa: PLC0415

    stream = _RouteClient(host, port, [_route_request(lines, [int(r)], want=None)
                                       for r in rng.integers(0, ROUTE_ROWS, 64)],
                          stream=True).start()
    ctrl = None

    def poller():
        return ["distlr_alert_smoke{candidate=v2}"] if ctrl.weight >= 0.5 else []

    ctrl = RolloutController(RouterAdmin(host, port), "v1", "v2", ROUTE_STAGES,
                             alert_poll=poller if fire else None, poll_interval_s=0.05,
                             journal_dir=journal)
    t0 = time.perf_counter()
    outcome = ctrl.run()
    ramp_s = time.perf_counter() - t0
    stream.join(stop=True)
    want = "rolled_back" if fire else "promoted"
    after_version = "v1" if fire else "v2"
    after = _run_clients(host, port, [[_route_request(lines, [int(r)], want=after_version)
                                       for r in rng.integers(0, ROUTE_ROWS, 16)]])
    tally = _route_tally([stream], s1, s2)
    _route_tally(after, s1, s2)
    models = RouterAdmin(host, port).models()
    events = [t["event"] for t in ctrl.transitions]
    if (outcome["outcome"] != want or models["splits"] or tally["route"]
            or (fire and (outcome["stage"] != 1 or events[-1] != "rollback"))
            or (not fire and events[-1] != "promote")):
        raise AssertionError(f"route ramp: {outcome}, events {events}, splits "
                             f"{models['splits']}, stream {tally}")
    return {"outcome": outcome["outcome"], "events": events, "seconds": ramp_s,
            "stream_replies": tally, "after": after_version,
            **({"stage": outcome["stage"], "alerts": outcome["alerts"]} if fire else {})}


def _route_hop(host, port, a_host, a_port, lines, rng) -> dict:
    """The router hop: client ms of a 64-row JSON request and of a single
    line through the router and straight to replica A (v1, A's default
    engine), ROUTE_HOP_PAIRS of each in turns (router, direct, direct,
    router, ...), and the medians' difference."""
    from distlr_tpu_torch.serve import score_lines_over_tcp  # noqa: PLC0415

    out = {}
    for name, req in (("json_64", json.dumps({"rows": [lines[int(r)] for r in
                                                       rng.integers(0, ROUTE_ROWS, 64)]})),
                      ("single", lines[int(rng.integers(0, ROUTE_ROWS))])):
        times = {"via_router_ms": [], "direct_ms": []}
        for i in range(2 * ROUTE_HOP_PAIRS):
            key = "via_router_ms" if i % 4 in (0, 3) else "direct_ms"
            h, p = (host, port) if key == "via_router_ms" else (a_host, a_port)
            t0 = time.perf_counter()
            score_lines_over_tcp(h, p, [req], timeout_s=ROUTE_CLIENT_TIMEOUT_S)
            times[key].append(1e3 * (time.perf_counter() - t0))
        med = {k: sorted(v)[ROUTE_HOP_PAIRS // 2] for k, v in times.items()}
        out[name] = {**times, "median_via_router_ms": med["via_router_ms"],
                     "median_direct_ms": med["direct_ms"],
                     "median_hop_ms": med["via_router_ms"] - med["direct_ms"]}
    return out


def _route_namespace(torch, ops, kv_v2, a_host, a_port, engines_a, lines, cols, w1, w2) -> dict:
    """Check 8: a keyed push into v2's namespace (1.0 on the columns of 16
    rows, learning rate 1): A's v2 engine then serves the new table, by
    σ(plain logits) and bit for bit, and its v1 engine's table is w1 still."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.serve import score_lines_over_tcp  # noqa: PLC0415

    rows = list(range(16))
    keys = np.unique(cols[rows].reshape(-1)).astype(np.uint64)
    kv_v2.push(np.ones(keys.size, np.float32), keys)
    w2_new = w2.copy()
    w2_new[keys.astype(np.int64)] -= 1.0
    t0 = time.perf_counter()
    while not np.array_equal(engines_a["v2"].get_weights(), w2_new):
        if time.perf_counter() - t0 > 30:
            raise AssertionError("route namespace: A's v2 engine never served the push")
        time.sleep(0.05)
    reload_s = time.perf_counter() - t0
    probe = json.dumps({"rows": [lines[r] for r in rows]})
    got = {m: np.asarray(json.loads(score_lines_over_tcp(
        a_host, a_port, [f"@{m} {probe}"])[0])["scores"]) for m in ("v1", "v2")}
    errs = {}
    for m, w in (("v1", w1), ("v2", w2_new)):
        z = _plain_logits(torch, ops, torch.from_numpy(w).cuda(), cols[rows], FULL_D)
        errs[m] = float(np.abs(got[m] - torch.sigmoid(z).numpy()).max())
    v1_same = bool(np.array_equal(engines_a["v1"].get_weights(), w1))
    if max(errs.values()) > SERVE_SCORE_TOL or not v1_same:
        raise AssertionError(f"route namespace: replies vs plain {errs}, v1 table the same "
                             f"{v1_same}")
    return {"pushed_keys": int(keys.size), "v2_served_after_s": reload_s,
            "replies_vs_plain": errs, "v1_table_unchanged": v1_same}


def phase_route(torch, seed: int, smi: str) -> dict:
    """The serving control plane at the full width, through the entry points
    a user calls: replicas A and B, each a ``ScoringServer`` hosting the
    binary_lr engines v1 and v2 (D = 1M, bf16; four engines on the card).
    A reloads both live from one ``ServerGroup`` of 2 servers at total dim
    2M, laid out by ``namespace_layout("v1,v2", 1M)`` and seeded with
    ``push_init(force=True)``; B serves them from text models.  A
    ``ScoringRouter`` (``v1=A+B,v2=A+B``, a quota on v2) is in front.  The
    launch counts are zeroed just before the traffic and read after the
    namespace check: mixed traffic (checks 1, 4), SPLIT (2), SHADOW (3), B
    aborted and restarted under load (5), a ramp that rolls back (7), one
    that promotes (6), then the namespace push (8)."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.ps import KVWorker, ServerGroup, namespace_layout  # noqa: PLC0415
    from distlr_tpu_torch.serve import (  # noqa: PLC0415
        HotReloader,
        LivePSWatcher,
        ScoringRouter,
        ScoringServer,
    )
    from distlr_tpu_torch.train.export import load_weights, save_model_text  # noqa: PLC0415

    rng = np.random.default_rng(seed + 40)
    w_true = (rng.standard_normal(FULL_D) * 0.5).astype(np.float32)
    cols, y = _ctr_cols(rng, ROUTE_ROWS, w_true, FULL_D)
    lines = _libsvm_lines(cols, y)
    w1 = _bf16_exact(torch, _serve_weights(rng, FULL_D, cols))
    w2 = _bf16_exact(torch, w1 + np.float32(ROUTE_V2_SHIFT / CTR_FIELDS))
    s1, s2 = (torch.sigmoid(_plain_logits(torch, ops, torch.from_numpy(w).cuda(), cols,
                                          FULL_D)).numpy() for w in (w1, w2))
    out, rss = {"nvidia_smi": smi, "D": FULL_D, "rows": ROUTE_ROWS, "clients": ROUTE_CLIENTS,
                "buckets": list(SERVE_BUCKETS)}, {}
    t_phase = time.perf_counter()
    servers, reloaders = {}, []
    with _sampled_peak_rss(rss), tempfile.TemporaryDirectory(prefix="distlr-smoke-route-") as tmp, \
            ServerGroup(PS_SERVERS, 1, 2 * FULL_D, learning_rate=1.0, sync=False) as sg, \
            KVWorker(sg.hosts, 2 * FULL_D, client_id=1) as kv:
        layout = namespace_layout("v1,v2", FULL_D)
        for m, w in (("v1", w1), ("v2", w2)):
            kv.namespace(*layout[m]).push_init(w, force=True)
        engines_a = {m: _serve_engine(torch, FULL_D) for m in ("v1", "v2")}
        for i, m in enumerate(("v1", "v2")):
            watcher = LivePSWatcher(sg.hosts, FULL_D, client_id=LivePSWatcher.SERVE_CLIENT_ID - i,
                                    ns_base=layout[m][0], ns_total_dim=2 * FULL_D)
            reloaders.append(HotReloader(engines_a[m], watcher, interval_s=ROUTE_RELOAD_S))
            reloaders[-1].wait_for_weights(60)
            reloaders[-1].start()
        engines_b = {}
        for m, w in (("v1", w1), ("v2", w2)):
            path = os.path.join(tmp, f"{m}.txt")
            save_model_text(path, w)
            engines_b[m] = _serve_engine(torch, FULL_D)
            engines_b[m].set_weights(load_weights(path, shape=(FULL_D,)))
        servers["A"] = ScoringServer(engines=engines_a, max_wait_ms=SERVE_WAIT_MS,
                                     reloader=reloaders[0], extra_reloaders=reloaders[1:]).start()
        servers["B"] = ScoringServer(engines=engines_b, max_wait_ms=SERVE_WAIT_MS).start()
        addr = {k: f"{s.host}:{s.port}" for k, s in servers.items()}

        def restart_b(b_addr):
            """Abort B (``None``), or start it again on its port."""
            if b_addr is None:
                servers["B"].abort()
                return addr["B"]
            servers["B"] = ScoringServer(engines=engines_b, port=servers["B"].port,
                                         max_wait_ms=SERVE_WAIT_MS).start()
            return b_addr

        pool = f"{addr['A']}+{addr['B']}"
        ops.reset_launch_counts()
        try:
            with ScoringRouter(f"v1={pool},v2={pool}", seed=seed,
                               max_inflight=ROUTE_MAX_INFLIGHT, eject_after=ROUTE_EJECT_AFTER,
                               health_interval_s=ROUTE_HEALTH_S,
                               probe_backoff_s=ROUTE_BACKOFF_S,
                               probe_backoff_max_s=ROUTE_BACKOFF_MAX_S,
                               shadow_block=ROUTE_SHADOW_BLOCK,
                               quotas=f"v2={ROUTE_QUOTA_RATE:g}:{ROUTE_QUOTA_BURST:g}") as router:
                h, p = router.host, router.port
                out["mixed"] = _route_mixed(h, p, lines, rng, s1, s2)
                out["split"] = _route_split(h, p, lines, rng, s1, s2)
                out["shadow"] = _route_shadow(router, h, p, lines, rng, s1, s2)
                # the same traffic, seen by the router and by each replica
                stats = {"router": _stats(h, p),
                         **{k: _stats(s.host, s.port) for k, s in servers.items()}}
                out["latency"] = {k: {f: v[f] for f in ("requests", "qps", "p50_ms", "p99_ms")}
                                  for k, v in stats.items()}
                out["hop"] = _route_hop(h, p, servers["A"].host, servers["A"].port, lines, rng)
                out["hop"]["p50_minus_replica_p50_ms"] = {
                    k: stats["router"]["p50_ms"] - stats[k]["p50_ms"] for k in servers}
                out["failover"] = _route_failover(router, h, p, lines, rng, s1, s2, restart_b)
                out["rollback"] = _route_ramp(h, p, lines, rng, s1, s2, fire=True,
                                              journal=tmp)
                out["promote"] = _route_ramp(h, p, lines, rng, s1, s2, fire=False,
                                             journal=tmp)
                final = router.stats()
            out["namespace"] = _route_namespace(torch, ops, kv.namespace(*layout["v2"]),
                                                servers["A"].host, servers["A"].port,
                                                engines_a, lines, cols, w1, w2)
            torch.cuda.synchronize()
            launches = {k: v for k, v in _launches(ops).items() if v}
        finally:
            for s in servers.values():
                s.stop()
    engine_launches = {f"{r}_{m}": sum(e.stats()["bucket_hits"].values())
                       for r, engs in (("A", engines_a), ("B", engines_b))
                       for m, e in engs.items()}
    if set(launches) != {"lr_logits"} or launches["lr_logits"] != sum(engine_launches.values()):
        raise AssertionError(f"route: the path launched {launches}; the engines' buckets "
                             f"{engine_launches}")
    quota = final["per_model"]["v2"]["quota"]
    if quota["shed"] < 1 or final["per_model"]["v2"]["shed"] != quota["shed"]:
        raise AssertionError(f"route: the v2 quota shed nothing: {final['per_model']['v2']}")
    out.update({"launches": launches, "engine_lr_logits_launches": engine_launches,
                "retries": final["retries"], "shed": final["shed"],
                "tenant_shed": quota["shed"], "errors": final["errors"],
                "ejections": sum(r["ejections"] for r in final["replicas"]),
                "reinstates": sum(r["reinstates"] for r in final["replicas"]),
                "router_requests": final["requests"], "per_model": final["per_model"],
                **rss, "phase_s": time.perf_counter() - t_phase,
                "reduced": {"traffic": "a few thousand requests from 8 clients (a smoke test, "
                                       "not a load test); the weights are random, from the seed",
                            "replicas": "two in-process replicas on one card"}})
    del engines_a, engines_b
    torch.cuda.empty_cache()
    emit("route", **out)
    return out


# --- the online-learning loop ---------------------------------------------------
# a row takes one of ONLINE_VOCAB columns (spread over [0, D)) in each of
# ONLINE_FIELDS fields, so features recur and FTRL learns in seconds; a
# label is the sign of the planted margin, |margin| >= 2 (the JAX package's
# closed-loop test rows); the probes' margins are >= 4
ONLINE_FIELDS, ONLINE_VOCAB, ONLINE_MIN_MARGIN, ONLINE_PROBE_MARGIN = 8, 8, 2, 4
ONLINE_ROUND_ROWS, ONLINE_LABEL_FRAC, ONLINE_PROBES = 60, 0.85, 8
ONLINE_WINDOW_S, ONLINE_NEG_RATE, ONLINE_SHARD_RECORDS = 1.0, 0.3, 64
ONLINE_DRIFT_BLOCK, ONLINE_DRIFT_THRESHOLD = 120, 0.15
ONLINE_TICK_S, ONLINE_IDLE_FLUSH_S, ONLINE_RELOAD_S = 0.1, 0.3, 0.2
ONLINE_FTRL = {"ftrl_alpha": 1.0, "ftrl_beta": 1.0, "ftrl_l1": 0.001, "ftrl_l2": 0.0}
ONLINE_DEADLINE_S, ONLINE_REL_TOL = 20.0, 1e-5
# launch online's accumulation defaults (--accum-max 64 when not given)
ONLINE_ACCUM = {"start": 1, "growth": 2.0, "growth_every": 32, "max_k": 64}


def _online_rows(rng, vocab, w_true, n: int, sign: int, min_margin: int = ONLINE_MIN_MARGIN):
    """``n`` rows of the phase as (n, ONLINE_FIELDS) ascending columns and
    their labels under ``sign * w_true``."""
    import numpy as np  # noqa: PLC0415

    cols, ys = [], []
    while len(cols) < n:
        c = np.sort(vocab[np.arange(ONLINE_FIELDS), rng.integers(0, ONLINE_VOCAB, ONLINE_FIELDS)])
        m = sign * float(w_true[c].sum())
        if abs(m) < min_margin:
            continue
        cols.append(c)
        ys.append(int(m > 0))
    return np.stack(cols), np.asarray(ys, np.int32)


def _features(cols_row) -> str:
    return " ".join(f"{c + 1}:1" for c in cols_row)


class _OnlineClient:
    """One connection to the router: ID lines and their LABEL lines, JSON
    probes, plain lines."""

    def __init__(self, host, port):
        import socket  # noqa: PLC0415

        self._s = socket.create_connection((host, port), timeout=ROUTE_CLIENT_TIMEOUT_S)
        self._f = self._s.makefile("rwb")
        self.next_id = 0
        self.seconds: list[float] = []

    def exchange(self, line: str) -> str:
        t0 = time.perf_counter()
        self._f.write((line + "\n").encode())
        self._f.flush()
        reply = self._f.readline().decode().rstrip("\n")
        self.seconds.append(time.perf_counter() - t0)
        if not reply:
            raise ConnectionError("the router closed the connection")
        return reply

    def drive(self, cols, y, rng) -> None:
        for c, label in zip(cols, y):
            rid = f"r{self.next_id}"
            self.next_id += 1
            reply = self.exchange(f"ID {rid} {_features(c)}")
            if reply.startswith("ERR"):
                raise AssertionError(f"online: ID {rid} answered {reply}")
            if rng.random() < ONLINE_LABEL_FRAC:
                reply = self.exchange(f"LABEL {rid} {int(label)}")
                if not reply.startswith("OK"):
                    raise AssertionError(f"online: LABEL {rid} answered {reply}")

    def probe(self, cols):
        import numpy as np  # noqa: PLC0415

        reply = self.exchange(json.dumps({"rows": [_features(c) for c in cols]}))
        if reply.startswith("ERR"):
            raise AssertionError(f"online: the probe answered {reply}")
        return np.asarray(json.loads(reply)["scores"], np.float64)

    def close(self) -> None:
        self._f.close()
        self._s.close()


def _online_replay(torch, tmp: str, shard_paths, smi: str) -> dict:
    """Check 5: the loop's joined shards, all present before ``run``, through
    the port's ``OnlineTrainer`` into a fresh async FTRL group, against a
    numpy replay of the same arithmetic: a pull at each span's start, the
    numpy mean gradient, the accumulation schedule and the FTRL oracle."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.data.libsvm import parse_libsvm_lines  # noqa: PLC0415
    from distlr_tpu_torch.feedback import OnlineTrainer  # noqa: PLC0415
    from distlr_tpu_torch.ps import KVWorker, ServerGroup  # noqa: PLC0415
    from distlr_tpu_torch.train.ps_trainer import _np_dense_grad  # noqa: PLC0415

    d = os.path.join(tmp, "replay")
    os.makedirs(d)
    for i, path in enumerate(shard_paths):
        shutil.copy(path, os.path.join(d, f"shard-{i:06d}.libsvm"))
    cfg = Config(num_feature_dim=FULL_D, l2_c=0.0, sync_mode=False, ps_optimizer="ftrl",
                 ps_timeout_ms=PS_TIMEOUT_MS, **ONLINE_FTRL)
    acc = ONLINE_ACCUM
    with ServerGroup(PS_SERVERS, 1, FULL_D, sync=False, optimizer="ftrl",
                     **ONLINE_FTRL) as sg:
        tr = OnlineTrainer(cfg, sg.hosts, d, accum_start=acc["start"],
                           accum_growth=acc["growth"], accum_growth_every=acc["growth_every"],
                           accum_max=acc["max_k"], poll_interval_s=0.01)
        t0 = time.perf_counter()
        stats = tr.run(max_shards=len(shard_paths))
        run_s = time.perf_counter() - t0
        tr.close()
        with KVWorker(sg.hosts, FULL_D, client_id=9) as kv:
            w_run = kv.pull()
    orc = _FtrlOracle(np.zeros(FULL_D, np.float32), *(ONLINE_FTRL[k] for k in (
        "ftrl_alpha", "ftrl_beta", "ftrl_l1", "ftrl_l2")))
    k, flushes, batches, buf, w_span = acc["start"], 0, 0, None, None

    def flush():
        nonlocal k, flushes, batches, buf
        orc.step(buf / np.float32(batches))
        flushes, batches, buf = flushes + 1, 0, None
        if flushes % acc["growth_every"] == 0:
            k = min(acc["max_k"], max(k + 1, int(round(k * acc["growth"]))))

    B = 256  # the trainer's batch when batch_size is -1
    for i in range(len(shard_paths)):
        with open(os.path.join(d, f"shard-{i:06d}.libsvm.done")) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        X, y = parse_libsvm_lines(lines, FULL_D, dense=True)
        for lo in range(0, len(y), B):
            if batches == 0:
                w_span = orc.w.copy()
            g = _np_dense_grad(w_span, X[lo:lo + B], y[lo:lo + B],
                               np.ones(len(y[lo:lo + B]), np.float32), 0.0, False, None)
            buf = g if buf is None else buf + g
            batches += 1
            if batches >= k:
                flush()
    if batches:
        flush()
    err = float(np.abs(w_run - orc.w).max() / max(np.abs(orc.w).max(), 1e-30))
    out = {"shards": len(shard_paths), "stats": stats, "oracle_pushes": flushes,
           "oracle_accum_k": k, "weights_rel_err_vs_oracle": err,
           "nonzero_weights": int(np.count_nonzero(w_run)), "run_s": run_s,
           "consume_ms_per_shard": 1e3 * tr.consume_s / max(len(shard_paths), 1),
           "parse_ms_per_shard": 1e3 * tr.parse_s / max(len(shard_paths), 1),
           "gradient_ms_per_shard": 1e3 * tr.grad_s / max(len(shard_paths), 1),
           "nvidia_smi": smi}
    if (err > ONLINE_REL_TOL or stats["pushes"] != flushes or stats["accum_k"] != k
            or stats["shards_consumed"] != len(shard_paths)):
        raise AssertionError(f"online replay: the trainer's weights or pushes differ from "
                             f"the numpy replay: {out}")
    return out


def phase_online(torch, seed: int, smi: str) -> dict:
    """The closed online-learning loop at the full width (binary_lr, D = 1M,
    bf16, ``lr_logits``), through the entry points a user runs: an async FTRL
    ``ServerGroup`` of PS_SERVERS servers; ``python -m distlr_tpu_torch.launch
    online`` in a subprocess (it seeds the group); an in-process
    ``ScoringServer`` with a ``HotReloader`` over a ``LivePSWatcher`` and a
    ``FeedbackSink``, behind a ``ScoringRouter`` that fans the LABEL lines
    out.  ID requests come through the router, ~85% of them labelled; the
    JSON probes go to a second listener of the same engine, without a sink
    (a spooled probe row would return as a label-0 sample every round).  The
    launch counts are zeroed just before the traffic and read after check 3.
    Checks: (1) from cold the probes separate; (2) the labels flip and the
    probes follow with no restart, the drift alert fires and then clears on
    steady traffic; (3) with the trainer stopped, the served scores equal
    σ(plain logits of the pulled weights); (4) ``lr_logits`` launched on
    the path; (5) the joined shards replayed into a fresh group equal a numpy
    replay."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.feedback import FeedbackSink  # noqa: PLC0415
    from distlr_tpu_torch.ps import KVWorker, ServerGroup  # noqa: PLC0415
    from distlr_tpu_torch.serve import (  # noqa: PLC0415
        HotReloader,
        LivePSWatcher,
        ScoringRouter,
        ScoringServer,
    )

    rng = np.random.default_rng(seed + 50)
    vocab = np.sort(rng.choice(FULL_D, size=ONLINE_FIELDS * ONLINE_VOCAB, replace=False)
                    ).reshape(ONLINE_FIELDS, ONLINE_VOCAB)
    w_true = np.zeros(FULL_D, np.float32)
    # half of each field's columns +1 and half -1: the labels are balanced
    w_true[vocab] = rng.permuted(np.tile([-1.0, 1.0], vocab.shape[1] // 2)[None].repeat(
        ONLINE_FIELDS, 0), axis=1)
    cols, y = _online_rows(rng, vocab, w_true, 16 * ONLINE_PROBES, +1, ONLINE_PROBE_MARGIN)
    probe_pos, probe_neg = cols[y == 1][:ONLINE_PROBES // 2], cols[y == 0][:ONLINE_PROBES // 2]
    probes = np.concatenate([probe_pos, probe_neg])
    out = {"nvidia_smi": smi, "D": FULL_D, "servers": PS_SERVERS, "ftrl": ONLINE_FTRL,
           "window_s": ONLINE_WINDOW_S, "negative_rate": ONLINE_NEG_RATE,
           "shard_records": ONLINE_SHARD_RECORDS, "round_rows": ONLINE_ROUND_ROWS}
    rss: dict = {}
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with _sampled_peak_rss(rss), tempfile.TemporaryDirectory(prefix="distlr-smoke-online-") as tmp, \
            ServerGroup(PS_SERVERS, 1, FULL_D, sync=False, optimizer="ftrl",
                        **ONLINE_FTRL) as sg:
        shard_dir = os.path.join(tmp, "shards")
        err_path = os.path.join(tmp, "online.err")
        with open(err_path, "w") as err_f:
            trainer = subprocess.Popen(
                [sys.executable, "-m", "distlr_tpu_torch.launch", "online", "--num-feature-dim",
                 str(FULL_D), "--l2-c", "0", "--hosts", sg.hosts, "--shard-dir", shard_dir,
                 "--poll-interval", "0.05", "--ps-timeout", str(PS_TIMEOUT_MS)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err_f, text=True)
        servers, router, client = [], None, None
        try:
            ready = trainer.stdout.readline()
            if not ready.startswith("ONLINE "):
                raise AssertionError(f"launch online printed {ready!r} first")
            eng = _serve_engine(torch, FULL_D)
            reloader = HotReloader(eng, LivePSWatcher(sg.hosts, FULL_D),
                                   interval_s=ONLINE_RELOAD_S, jitter=0.0)
            reloader.wait_for_weights(60)
            reloader.start()
            sink = FeedbackSink(os.path.join(tmp, "spool"), shard_dir, window_s=ONLINE_WINDOW_S,
                                negative_rate=ONLINE_NEG_RATE,
                                shard_records=ONLINE_SHARD_RECORDS,
                                drift_block=ONLINE_DRIFT_BLOCK,
                                drift_threshold=ONLINE_DRIFT_THRESHOLD,
                                tick_interval_s=ONLINE_TICK_S, idle_flush_s=ONLINE_IDLE_FLUSH_S,
                                seed=seed)
            servers.append(ScoringServer(eng, max_wait_ms=SERVE_WAIT_MS, reloader=reloader,
                                         feedback=sink).start())
            router = ScoringRouter(f"{servers[0].host}:{servers[0].port}", seed=seed,
                                   max_inflight=ROUTE_MAX_INFLIGHT).start()
            client = _OnlineClient(router.host, router.port)
            # the probes go to a listener of the same engine without a sink:
            # spooled, they would come back as label-0 samples every round
            servers.append(ScoringServer(eng, max_wait_ms=SERVE_WAIT_MS).start())
            prober = _OnlineClient(servers[1].host, servers[1].port)
            ops.reset_launch_counts()

            def adapted(sign):
                sp, sn = prober.probe(probe_pos).mean(), prober.probe(probe_neg).mean()
                return (sp > 0.6 and sn < 0.4) if sign > 0 else (sp < 0.4 and sn > 0.6), sp, sn

            def phase(sign, tag):
                t0, deadline, rounds = time.perf_counter(), time.monotonic() + ONLINE_DEADLINE_S, 0
                while True:
                    cols, y = _online_rows(rng, vocab, w_true, ONLINE_ROUND_ROWS, sign)
                    client.drive(cols, y, rng)
                    rounds += 1
                    ok, sp, sn = adapted(sign)
                    if ok:
                        return {"seconds_to_adapt": time.perf_counter() - t0, "rounds": rounds,
                                "probe_pos_mean": sp, "probe_neg_mean": sn}
                    if time.monotonic() > deadline:
                        with open(err_path) as f:
                            log_tail = f.read()[-1500:]
                        raise AssertionError(
                            f"online {tag}: the probes never followed the labels: pos {sp:.3f} "
                            f"neg {sn:.3f}, {sink.stats()}; launch online's log:\n{log_tail}")
                    time.sleep(ONLINE_TICK_S)  # the window ticks, the trainer consumes

            out["phase1"] = phase(+1, "phase1")
            out["phase2"] = phase(-1, "phase2")
            if sink.drift.fired_total < 1:
                raise AssertionError(f"online: the drift alert never fired: {sink.drift.stats()}")
            t0, deadline, rounds = time.perf_counter(), time.monotonic() + ONLINE_DEADLINE_S, 0
            while sink.drift.firing:
                cols, y = _online_rows(rng, vocab, w_true, ONLINE_ROUND_ROWS, -1)
                client.drive(cols, y, rng)
                rounds += 1
                if time.monotonic() > deadline:
                    raise AssertionError(f"online: the drift alert never cleared: "
                                         f"{sink.drift.stats()}")
            out["drift_cleared"] = {"seconds": time.perf_counter() - t0, "rounds": rounds,
                                    **sink.drift.stats()}
            if sink.drift.cleared_total < 1:
                raise AssertionError(f"online: the drift alert never cleared: "
                                     f"{sink.drift.stats()}")
            stats = {"router": router.stats(), "replica": servers[0].stats()}
            out["latency"] = {k: {f: v[f] for f in ("requests", "qps", "p50_ms", "p99_ms")}
                              for k, v in stats.items()}
            out["client_request_ms_p50"] = 1e3 * float(np.median(client.seconds))
            # check 3: the trainer stops (SIGTERM: a final flush), the reloader
            # takes the final weights, the served scores are σ(plain z)
            trainer.send_signal(signal.SIGTERM)
            out["trainer_sigterm_returncode"] = trainer.wait(timeout=120)
            with KVWorker(sg.hosts, FULL_D, client_id=9) as kv:
                w = kv.pull()
            deadline = time.monotonic() + 60
            while not np.array_equal(eng.get_weights(), w):
                if time.monotonic() > deadline:
                    raise AssertionError("online: the reloader never took the final weights")
                time.sleep(ONLINE_RELOAD_S / 2)
            replies = [client.exchange(_features(c)) for c in probes]
            json_scores = prober.probe(probes)
            torch.cuda.synchronize()
            launches = {k: v for k, v in _launches(ops).items() if v}
            z = _plain_logits(torch, ops, torch.from_numpy(w).cuda(), probes, FULL_D).double()
            want = torch.sigmoid(z).numpy()
            got = np.asarray([float(r.split()[1]) for r in replies])
            out["served_vs_plain"] = {
                "rows": len(probes),
                "libsvm_max_rel_err": float((np.abs(got - want) / want).max()),
                "json_max_abs_err": float(np.abs(json_scores - want).max())}
            out["feedback"] = sink.stats()
            engine_launches = sum(eng.stats()["bucket_hits"].values())
        finally:
            if client is not None:
                client.close()
                prober.close()
            if router is not None:
                router.stop()
            for s in servers:
                s.stop()
            if trainer.poll() is None:
                trainer.kill()
                trainer.wait()
        with open(err_path) as f:
            done = [ln for ln in f.read().splitlines() if "online trainer done" in ln]
        out["trainer_exit_line"] = done[-1].split("] ", 1)[-1] if done else None
        consumed = sorted(os.path.join(shard_dir, n) for n in os.listdir(shard_dir)
                          if n.endswith(".libsvm.done"))
        written = sorted(n for n in os.listdir(shard_dir) if n.startswith("shard-")
                         and not n.endswith(".tmp"))
        out.update({"shards_written": len(written), "shards_consumed": len(consumed)})
        sv = out["served_vs_plain"]
        if (sv["libsvm_max_rel_err"] > ONLINE_REL_TOL or sv["json_max_abs_err"] > 1e-6
                or out["trainer_sigterm_returncode"] != 0):
            raise AssertionError(f"online: served scores against σ(plain z) {sv}, the trainer "
                                 f"exited {out['trainer_sigterm_returncode']}")
        # check 4: the replicas scored through lr_logits, and only it
        if set(launches) != {"lr_logits"} or launches["lr_logits"] != engine_launches:
            raise AssertionError(f"online: the path launched {launches}; the engine's buckets "
                                 f"{engine_launches}")
        out["launches"] = launches
        out["replay"] = _online_replay(torch, tmp, consumed, smi)
    out.update({**rss, "phase_s": time.perf_counter() - t_phase,
                "reduced": {"traffic": "a few thousand single-row requests from one client "
                                       "(a smoke test, not a load test); the weights start at "
                                       "zero and the labels come from a planted model",
                            "replicas": "one in-process replica behind an in-process router"}})
    emit("online", **out)
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


def _launch(*argv) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"launch {' '.join(argv[:3])} exited {proc.returncode}:\n"
                             f"{proc.stderr[-2000:]}")
    return proc


def _cli_family(tmp: str, family: str) -> dict:
    """gen-data -> sync (2 workers, on the card) -> eval of one family at a
    small size: the eval lines come at the test interval, the saved model
    has the params' size, and eval scores what the last line reported."""
    gen_flags, flags, shape, iters, interval = CLI_FAMILIES[family]
    d = os.path.join(tmp, family)
    _launch("gen-data", "--data-dir", d, "--num-samples", "2000", "--num-parts", "2", *gen_flags)
    out = _launch("sync", "--data-dir", d, *flags, "--num-workers", "2", "--num-iteration",
                  str(iters), "--test-interval", str(interval), "--learning-rate", "0.5",
                  "--l2-c", "0").stdout
    lines = re.findall(EVAL_LINE, out, re.M)
    if [int(n) for n, _ in lines] != list(range(interval, iters + 1, interval)):
        raise AssertionError(f"unexpected eval lines from {family} sync:\n{out}")
    model_file = os.path.join(d, "models", "part-001")
    with open(model_file) as f:
        if int(f.readline()) != math.prod(shape) or len(f.readline().split()) != math.prod(shape):
            raise AssertionError(f"{family} sync wrote a malformed model file")
    ev = _launch("eval", "--data-dir", d, *flags, "--model-file", model_file).stdout
    m = re.search(r"accuracy: (\S+)\s+test_logloss: (\S+)", ev)
    if m is None or abs(float(m.group(1)) - float(lines[-1][1])) > 1e-4:
        raise AssertionError(f"{family} eval disagrees with its last sync line: {ev}")
    return {"sync_accuracy": [float(a) for _, a in lines], "eval_accuracy": float(m.group(1)),
            "eval_logloss": float(m.group(2))}


def _cli_int8_dot_resume(tmp: str) -> dict:
    """binary_lr with int8_dot features: sync 5 epochs with a checkpoint
    every epoch, then sync to 10 with --resume (it must start at epoch 5
    and keep the last 3 checkpoints), then eval of what it saved."""
    from distlr_tpu_torch.train.checkpoint import Checkpointer  # noqa: PLC0415

    d, ck = os.path.join(tmp, "int8_dot"), os.path.join(tmp, "int8_dot_ck")
    _launch("gen-data", "--data-dir", d, "--num-samples", "2000", "--num-parts", "2",
            "--num-feature-dim", "123")
    flags = ["--data-dir", d, "--num-feature-dim", "123", "--feature-dtype", "int8_dot"]
    sync = ["sync", *flags, "--num-workers", "2", "--test-interval", "5", "--learning-rate",
            "0.5", "--l2-c", "0", "--checkpoint-dir", ck, "--checkpoint-interval", "1"]
    first = re.findall(EVAL_LINE, _launch(*sync, "--num-iteration", "5").stdout, re.M)
    proc = _launch(*sync, "--num-iteration", "10", "--resume")
    lines = re.findall(EVAL_LINE, proc.stdout, re.M)
    with Checkpointer(ck) as c:
        steps = c.all_steps()
    if ("resumed from checkpoint at epoch 5" not in proc.stderr
            or [int(n) for n, _ in first + lines] != [5, 10] or steps != [8, 9, 10]):
        raise AssertionError(f"int8_dot sync did not resume from epoch 5: {first} {lines} "
                             f"{steps}\n{proc.stderr[-1500:]}")
    ev = _launch("eval", *flags, "--model-file", os.path.join(d, "models", "part-001")).stdout
    m = re.search(r"accuracy: (\S+)\s+test_logloss: (\S+)", ev)
    if m is None or abs(float(m.group(1)) - float(lines[-1][1])) > 1e-4:
        raise AssertionError(f"int8_dot eval disagrees with its last sync line: {ev}")
    return {"sync_accuracy": [float(a) for _, a in first + lines], "checkpoints": steps,
            "resumed_at_epoch": 5, "eval_accuracy": float(m.group(1)),
            "eval_logloss": float(m.group(2))}


def _cli_ps(tmp: str) -> dict:
    """gen-data -> ps (2 servers, 2 worker threads, steps on the card)
    -> eval of each worker's saved model, then ps --async: sync
    workers end with the same weights, so eval scores what the last line
    reported for either file."""
    d = os.path.join(tmp, "ps")
    _launch("gen-data", "--data-dir", d, "--num-samples", "2000", "--num-parts", "2",
            "--num-feature-dim", "123")
    flags = ["--data-dir", d, "--num-feature-dim", "123"]
    ps = ["ps", *flags, "--num-workers", "2", "--num-servers", "2", "--learning-rate", "0.5",
          "--l2-c", "0"]
    lines = re.findall(EVAL_LINE, _launch(*ps, "--num-iteration", "20", "--test-interval",
                                          "10").stdout, re.M)
    if [int(n) for n, _ in lines] != [10, 20]:
        raise AssertionError(f"unexpected eval lines from launch ps: {lines}")
    evals = []
    for part in ("part-001", "part-002"):
        ev = _launch("eval", *flags, "--model-file", os.path.join(d, "models", part)).stdout
        m = re.search(r"accuracy: (\S+)\s+test_logloss: (\S+)", ev)
        if m is None or abs(float(m.group(1)) - float(lines[-1][1])) > 1e-4:
            raise AssertionError(f"eval of ps's {part} disagrees with its last line: {ev}")
        evals.append(float(m.group(1)))
    async_lines = re.findall(EVAL_LINE, _launch(*ps, "--async", "--batch-size", "100",
                                                "--num-iteration", "10", "--test-interval",
                                                "5").stdout, re.M)
    if [int(n) for n, _ in async_lines] != [5, 10]:
        raise AssertionError(f"unexpected eval lines from launch ps --async: {async_lines}")
    return {"sync_accuracy": [float(a) for _, a in lines], "eval_accuracy": evals,
            "async_accuracy": [float(a) for _, a in async_lines]}


def _cli_serve(tmp: str, *, checkpoints: bool = False) -> dict:
    """gen-data -> sync -> ``serve --model-file ... --port 0`` in a
    subprocess on the card: the SERVING line, 3 test lines answered as the
    in-process engine scores them on the same weights, exit code 143 on
    SIGTERM.  With ``checkpoints``, sync checkpoints every 5 epochs and
    ``--model-file`` is the checkpoint directory (its latest step)."""
    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.serve import ScoringEngine, score_lines_over_tcp  # noqa: PLC0415
    from distlr_tpu_torch.train.checkpoint import Checkpointer  # noqa: PLC0415
    from distlr_tpu_torch.train.export import load_weights  # noqa: PLC0415

    d = os.path.join(tmp, "serve_checkpoint" if checkpoints else "serve")
    ck = os.path.join(tmp, "serve_ck")
    _launch("gen-data", "--data-dir", d, "--num-samples", "2000", "--num-parts", "1",
            "--num-feature-dim", "123")
    _launch("sync", "--data-dir", d, "--num-feature-dim", "123", "--num-iteration", "10",
            "--test-interval", "5", "--learning-rate", "0.5", "--l2-c", "0",
            *(["--checkpoint-dir", ck, "--checkpoint-interval", "5"] if checkpoints else []))
    model_file = ck if checkpoints else os.path.join(d, "models", "part-001")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "distlr_tpu_torch.launch", "serve", "--num-feature-dim", "123",
         "--model-file", model_file, "--port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = proc.stdout.readline()
        if not ready.startswith("SERVING "):
            err = proc.stderr.read()[-2000:] if proc.poll() is not None else ""
            raise AssertionError(f"launch serve printed {ready!r} first\n{err}")
        host, port = ready.split()[1].rsplit(":", 1)
        with open(os.path.join(d, "test", "part-001")) as f:
            lines = [ln.strip() for ln in f if ln.strip()][:3]
        replies = score_lines_over_tcp(host, int(port), lines)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    eng = ScoringEngine(Config(num_feature_dim=123))
    eng.set_weights(load_weights(model_file))
    labels, scores = eng.score(eng.encode_lines(lines))
    want = [f"{int(a)} {float(b):.6g}" for a, b in zip(labels, scores)]
    if rc != 143 or replies != want:
        raise AssertionError(f"launch serve: exit {rc} (want 143), replies {replies}, the "
                             f"in-process engine gives {want}")
    out = {"ready_line": ready.strip().split()[0], "replies": replies,
           "equal_to_in_process_engine": True, "sigterm_returncode": rc}
    if checkpoints:
        with Checkpointer(ck) as c:
            out["checkpoint_steps"] = c.all_steps()
        if out["checkpoint_steps"] != [5, 10]:
            raise AssertionError(f"sync wrote checkpoints {out['checkpoint_steps']}")
    return out


def _cli_route(tmp: str) -> dict:
    """gen-data -> sync (v1) and a sync from another initial seed (v2) ->
    two ``launch serve --model-id v1 --extra-model v2=<v2 model>``
    subprocesses on the card -> ``launch route --replicas v1=A+B,v2=A+B``
    -> ``launch rollout ... --unwatched``: it exits 0 with ``promote`` the
    journal's last event, then replies through the router equal σ(X·w_v2)
    (the plain forward on the card) to SERVE_SCORE_TOL, and every process
    exits 143 on SIGTERM."""
    import numpy as np  # noqa: PLC0415

    import torch  # noqa: PLC0415

    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.serve import ScoringEngine, score_lines_over_tcp  # noqa: PLC0415
    from distlr_tpu_torch.train.export import load_weights  # noqa: PLC0415

    d = os.path.join(tmp, "route")
    _launch("gen-data", "--data-dir", d, "--num-samples", "2000", "--num-parts", "1",
            "--num-feature-dim", "123")
    models = {}
    for m, init_seed in (("v1", "10"), ("v2", "11")):
        _launch("sync", "--data-dir", d, "--num-feature-dim", "123", "--num-iteration", "5",
                "--test-interval", "0", "--learning-rate", "0.5", "--l2-c", "0",
                "--random-seed", init_seed)
        models[m] = os.path.join(tmp, f"route_{m}.txt")
        shutil.copy(os.path.join(d, "models", "part-001"), models[m])
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []

    def start(*argv, ready):
        proc = subprocess.Popen([sys.executable, "-m", "distlr_tpu_torch.launch", *argv],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        procs.append(proc)
        line = proc.stdout.readline()
        if not line.startswith(ready):
            err = proc.stderr.read()[-2000:] if proc.poll() is not None else ""
            raise AssertionError(f"launch {argv[0]} printed {line!r} first\n{err}")
        return line.split()[1]

    try:
        pool = "+".join(start("serve", "--num-feature-dim", "123", "--model-file",
                              models["v1"], "--model-id", "v1", "--extra-model",
                              f"v2={models['v2']}", "--port", "0", ready="SERVING ")
                        for _ in range(2))
        router = start("route", "--replicas", f"v1={pool},v2={pool}", ready="ROUTING ")
        journal = os.path.join(tmp, "route_journal")
        ro = subprocess.run([sys.executable, "-m", "distlr_tpu_torch.launch", "rollout",
                             "--router", router, "--tenant", "v1", "--candidate", "v2",
                             "--stages", "0.5:0.2,1.0:0.2", "--unwatched", "--journal-dir",
                             journal], cwd=ROOT, env=env, capture_output=True, text=True,
                            timeout=300)
        with open(os.path.join(d, "test", "part-001")) as f:
            lines = [ln.strip() for ln in f if ln.strip()][:16]
        host, port = router.rsplit(":", 1)
        replies = score_lines_over_tcp(host, int(port), lines)
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        rcs = [proc.wait(timeout=60) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(os.path.join(journal, "rollout", "ramp-0000.jsonl")) as f:
        events = [json.loads(ln)["event"] for ln in f]
    eng = ScoringEngine(Config(num_feature_dim=123, device="cpu"))
    (X,) = eng.encode_lines(lines)
    got = np.asarray([float(r.split()[1]) for r in replies])
    err = {}
    for m in ("v1", "v2"):
        w = torch.from_numpy(load_weights(models[m], shape=(123,))).cuda()
        z = ops.lr_logits_reference(w, torch.from_numpy(X).cuda())
        err[m] = float(np.abs(got - torch.sigmoid(z).cpu().numpy()).max())
    if (ro.returncode != 0 or events[-1] != "promote" or err["v2"] > SERVE_SCORE_TOL
            or err["v1"] <= SERVE_SCORE_TOL or rcs != [143, 143, 143]):
        raise AssertionError(f"launch rollout exited {ro.returncode} ({ro.stderr[-1500:]}), "
                             f"journal {events}, replies vs σ(X·w) {err}, exits {rcs}")
    return {"rollout_returncode": ro.returncode, "rollout_line": ro.stdout.strip()[-300:],
            "journal_events": events, "replies": len(replies), "replies_vs_plain": err,
            "sigterm_returncodes": rcs}


def _cli_online(tmp: str) -> dict:
    """``launch ps-server --async --ps-optimizer ftrl`` -> ``launch online
    --max-shards 1`` -> ``launch serve --ps-hosts ... --feedback-spool ...``
    on the card, as the closed-loop drive wires them: 40 ``ID`` lines and
    their ``LABEL`` lines, all joined; SIGTERM on serve (143) flushes the
    partial shard, online consumes it and exits 0, and the group's weights
    classify the labelled rows."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch.ps import KVWorker  # noqa: PLC0415
    from distlr_tpu_torch.serve import score_lines_over_tcp  # noqa: PLC0415

    D, n = 123, 40
    d = os.path.join(tmp, "online")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []

    def start(*argv, ready):
        proc = subprocess.Popen([sys.executable, "-m", "distlr_tpu_torch.launch", *argv],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
        procs.append(proc)
        line = proc.stdout.readline()
        if not line.startswith(ready):
            raise AssertionError(f"launch {argv[0]} printed {line!r} first")
        return line.split()[1]

    rng = np.random.default_rng(3)
    w_true = np.where(np.arange(D) % 2 == 0, 1.0, -1.0).astype(np.float32)
    cols = np.stack([np.sort(rng.choice(D, 5, replace=False)) for _ in range(4 * n)])
    margin = w_true[cols].sum(axis=1)
    cols = cols[np.abs(margin) >= 3][:n]
    y = (w_true[cols].sum(axis=1) > 0).astype(int)
    try:
        hosts = start("ps-server", "--num-feature-dim", str(D), "--async", "--ps-optimizer",
                      "ftrl", "--ftrl-alpha", "1.0", ready="HOSTS ")
        start("online", "--num-feature-dim", str(D), "--l2-c", "0", "--hosts", hosts,
              "--shard-dir", os.path.join(d, "shards"), "--max-shards", "1",
              "--poll-interval", "0.05", ready="ONLINE ")
        addr = start("serve", "--num-feature-dim", str(D), "--ps-hosts", hosts, "--port", "0",
                     "--feedback-spool", os.path.join(d, "spool"), "--feedback-shards",
                     os.path.join(d, "shards"), ready="SERVING ")
        host, port = addr.rsplit(":", 1)
        lines = [ln for i, c in enumerate(cols)
                 for ln in (f"ID c{i} {_features(c)}", f"LABEL c{i} {y[i]}")]
        replies = score_lines_over_tcp(host, int(port), lines)
        procs[2].send_signal(signal.SIGTERM)
        rcs = {"serve": procs[2].wait(timeout=120), "online": procs[1].wait(timeout=120)}
        with KVWorker(hosts, D, client_id=9) as kv:
            w = kv.pull()
        procs[0].send_signal(signal.SIGTERM)
        rcs["ps-server"] = procs[0].wait(timeout=60)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    acc = float(((w[cols].sum(axis=1) > 0).astype(int) == y).mean())
    shards = sorted(os.listdir(os.path.join(d, "shards")))
    joined = sum(r == "OK joined" for r in replies[1::2])
    if (rcs != {"serve": 143, "online": 0, "ps-server": 143} or joined != len(cols)
            or shards != ["shard-000000.libsvm.done"] or acc < 0.9):
        raise AssertionError(f"launch online: exits {rcs}, {joined} of {len(cols)} labels "
                             f"joined, shards {shards}, accuracy {acc}")
    return {"exit_codes": rcs, "labels_joined": joined, "shards": shards,
            "accuracy_of_pulled_weights": acc}


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _cli_feature_shards(tmp: str) -> dict:
    """gen-data -> ``sync --num-workers 2 --feature-shards 4`` on the card
    (8 blocks of 31 columns a step) -> ``eval --feature-shards 4``, then the
    same sync without the column blocks: the weights within rel 1e-3."""
    from distlr_tpu_torch.train.export import load_model_text  # noqa: PLC0415

    d = os.path.join(tmp, "feature_shards")
    _launch("gen-data", "--data-dir", d, "--num-samples", "2000", "--num-parts", "2",
            "--num-feature-dim", "124")
    flags = ["--data-dir", d, "--num-feature-dim", "124"]
    sync = ["sync", *flags, "--num-workers", "2", "--num-iteration", "10", "--test-interval",
            "5", "--learning-rate", "0.5", "--l2-c", "0"]
    model_file = os.path.join(d, "models", "part-001")
    lines = re.findall(EVAL_LINE, _launch(*sync, "--feature-shards", "4").stdout, re.M)
    sharded = load_model_text(model_file)
    ev = _launch("eval", *flags, "--feature-shards", "4", "--model-file", model_file).stdout
    m = re.search(r"accuracy: (\S+)\s+test_logloss: (\S+)", ev)
    _launch(*sync)
    rel = float(abs(sharded - load_model_text(model_file)).max()
                / abs(load_model_text(model_file)).max())
    if ([int(n) for n, _ in lines] != [5, 10] or m is None
            or abs(float(m.group(1)) - float(lines[-1][1])) > 1e-4 or rel > REL_TOL):
        raise AssertionError(f"sync --feature-shards 4: lines {lines}, eval {ev}, rel {rel}")
    return {"sync_accuracy": [float(a) for _, a in lines], "eval_accuracy": float(m.group(1)),
            "weights_rel_err_vs_unsharded_sync": rel}


def _free_port() -> int:
    import socket  # noqa: PLC0415

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _cli_one_nccl_rank(tmp: str) -> dict:
    """``sync`` as a one-rank NCCL group (``--coordinator``,
    ``--num-processes 1``, ``--process-id 0``): its ``part-001`` equals a
    plain ``sync``'s byte for byte."""
    d = os.path.join(tmp, "nccl")
    _launch("gen-data", "--data-dir", d, "--num-samples", "2000", "--num-parts", "2",
            "--num-feature-dim", "123")
    sync = ["sync", "--data-dir", d, "--num-feature-dim", "123", "--num-workers", "2",
            "--num-iteration", "10", "--test-interval", "5", "--learning-rate", "0.5",
            "--l2-c", "0"]
    model_file = os.path.join(d, "models", "part-001")
    _launch(*sync)
    plain = _read(model_file)
    proc = _launch(*sync, "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes",
                   "1", "--process-id", "0")
    joined = re.search(r"joined distributed run: process 0 of 1 \((\w+)\)",
                       proc.stderr + proc.stdout)
    same = _read(model_file) == plain
    if joined is None or joined.group(1) != "nccl" or not same:
        raise AssertionError(f"the one-rank NCCL sync: backend "
                             f"{joined and joined.group(1)}, same bytes {same}\n"
                             f"{proc.stderr[-1500:]}")
    return {"backend": joined.group(1), "part_001_equals_plain_sync": same}


def phase_cli() -> None:
    """gen-data -> sync -> eval through ``python -m distlr_tpu_torch.launch``
    for every model family, int8_dot sync with checkpoints then --resume,
    gen-data -> ps -> eval, gen-data -> sync -> serve (of a text model and
    of a checkpoint directory), sync and eval with --feature-shards, sync
    as a one-rank NCCL group, gen-data -> sync x2 -> serve x2 -> route
    -> rollout, and ps-server -> online -> serve --feedback-spool, the
    chains side by side."""
    with tempfile.TemporaryDirectory(prefix="distlr-smoke-cli-") as tmp:
        with ThreadPoolExecutor(len(CLI_FAMILIES) + 8) as pool:
            futures = {f: pool.submit(_cli_family, tmp, f) for f in CLI_FAMILIES}
            chains = {"int8_dot_resume": pool.submit(_cli_int8_dot_resume, tmp),
                      "ps": pool.submit(_cli_ps, tmp),
                      "serve": pool.submit(_cli_serve, tmp),
                      "serve_checkpoint_dir": pool.submit(_cli_serve, tmp, checkpoints=True),
                      "feature_shards": pool.submit(_cli_feature_shards, tmp),
                      "one_nccl_rank": pool.submit(_cli_one_nccl_rank, tmp),
                      "route": pool.submit(_cli_route, tmp),
                      "online": pool.submit(_cli_online, tmp)}
            results = {f: fut.result() for f, fut in futures.items()}
            chains = {k: fut.result() for k, fut in chains.items()}
    emit("cli", **results.pop("binary_lr"), families=results, **chains)


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


# library -> function (a substring of its mangled name, then optionally
# "#" and a label, for a second fact of one function) -> (opcode prefixes,
# least count of them inside one loop of its SASS, what that shows, opcode
# prefixes that no loop of it may hold, a pattern of opcodes that the loop
# holding the most of the first may not hold)
_INT8_CONVERT = ("each int8 of X becomes an f32 by PRMT + FADD: no int-to-float conversion "
                 "(I2F, I2FP; I2F.RP is an integer division's reciprocal) in the loop "
                 "with the most PRMT")
_NO_CONVERSION = r"I2F(?!\.RP)"
SASS_FACTS = {
    "fused_lr_grad": {
        "lr_backward_kernel": (("LDG.E.128",), 16,
                               "16 loads of 16 bytes issued together in the backward's row loop "
                               "(16 rows of a bf16 X, 8 of an f32 one)", (), None),
    },
    "gen_roofline": {
        "gen_kernel": (("IMAD.WIDE", "IMAD.HI"), 17,
                       "every product of a Philox block that depends on t, each pass of t",
                       (), None),
        "const_rows_kernel": (("FFMA",), 8,
                              "a pass's 8 FMAs (2 rows x 4 columns) stay in the pass loop",
                              (), None),
        "mxu_wgmma_kernel": (("HGMMA",), 4,
                             "a pass's 4 wgmma k-steps of a 64-deep chunk in the pass loop, "
                             "and no mma.sync (HMMA)", ("HMMA",), None),
    },
    "fused_lr_int8": {
        "lr_grad_single_pass_kernel": (("PRMT",), 8, _INT8_CONVERT, (), _NO_CONVERSION),
        "lr_logits_streaming_kernel": (("PRMT",), 8, _INT8_CONVERT, (), _NO_CONVERSION),
        "lr_backward_int8_kernel": (("PRMT",), 8, _INT8_CONVERT, (), _NO_CONVERSION),
        "lr_backward_int8_kernel#loads": (("LDG.E.64",), 8,
                                          "8 rows' 8-byte loads issued together in the "
                                          "backward's row loop", (), None),
        "lr_logits_int8dot_kernel": (("IDP",), 2,
                                     "one dp4a per 4 columns of a row in the forward loop",
                                     (), None),
        "lr_backward_int8dot_kernel": (("IDP",), 8,
                                       "one dp4a per element of X in the backward loop", (),
                                       None),
    },
}


# library -> function -> opcode prefixes that none of its instructions may
# hold: the float backward's splits meet in shared memory, with no atomics
SASS_ABSENT = {"fused_lr_grad": {"lr_backward_kernel": ("RED.", "ATOM")}}


def _sass_absent(text: str, table: dict) -> dict:
    """Function -> the instructions of ``table``'s prefixes found anywhere
    in it (in any instance); raises where one is found."""
    found = {fn: set() for fn in table}
    for block in re.split(r"^\s*Function : ", text, flags=re.M)[1:]:
        name = block.split(None, 1)[0]
        for fn, prefixes in table.items():
            if fn not in name:
                continue
            for m in re.finditer(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                                 block, flags=re.M):
                if m.group(1).startswith(prefixes):
                    found[fn].add(m.group(1))
    if any(found.values()):
        raise AssertionError(f"SASS holds instructions it must not: {found}")
    return {fn: {"absent": table[fn], "found": sorted(v)} for fn, v in found.items()}


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


def _sass_facts(loops: dict, table: dict) -> dict:
    facts = {}
    for fn, (prefixes, least, what, absent, not_beside) in table.items():
        names = [n for n in loops if fn.split("#")[0] in n]
        per_loop = [loop for n in names for loop in loops[n]]
        counts = [sum(c for op, c in loop.items() if op.startswith(prefixes))
                  for loop in per_loop]
        best = max(counts, default=0)
        found = sorted({op for loop in per_loop for op in loop
                        if absent and op.startswith(absent)})
        # the loops holding the most of the opcodes, in every instance
        top = [loop for loop, c in zip(per_loop, counts) if c == best]
        beside = sorted({op for loop in top for op in loop
                         if not_beside and re.match(not_beside, op)})
        facts[fn] = {"most_in_one_loop": best, "opcodes": prefixes, "shows": what,
                     "functions": len(names), "absent": absent, "found_absent": found,
                     "not_beside": not_beside, "found_beside": beside,
                     "that_loop": dict(sorted(top[0].items(), key=lambda kv: -kv[1])[:12])
                     if top else {}}
        if best < least:
            raise AssertionError(f"SASS of {fn}: {best} of {prefixes} in its loops, "
                                 f"expected >= {least} ({what}); functions {names}")
        if found or beside:
            raise AssertionError(f"SASS of {fn} holds {found + beside}, which it must not "
                                 f"({what})")
    return facts


def phase_sass() -> dict:
    """What the kernels compiled to: in the float library the backward's
    16 batched 16-byte loads in its row loop and no atomic anywhere in it;
    wgmma (HGMMA) and no mma.sync (HMMA)
    in the probe mxu's pass loop, the FMAs inside const's pass loop, a
    whole Philox block in gen's loop; in the int8 library the byte-permute
    conversion (PRMT, no I2F beside it) in the int8 kernels' loops, 8
    rows' loads together in the two-read backward's, and dp4a (IDP) in the
    int8_dot pair's."""
    from distlr_tpu_torch.ops import build  # noqa: PLC0415

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    facts = {}
    for lib, table in SASS_FACTS.items():
        text = subprocess.run([cuobjdump, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True, timeout=120, check=True).stdout
        facts[lib] = _sass_facts(_sass_loops(text), table)
        if lib in SASS_ABSENT:
            facts[lib]["absent_anywhere"] = _sass_absent(text, SASS_ABSENT[lib])
        emit("sass", library=os.path.relpath(build.library_path(lib), ROOT), facts=facts[lib])
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
        phase = "int8_kernels"
        timing.update(phase_int8_kernels(torch, args.seed))
        phase = "lr_backward"
        timing.update(phase_lr_backward(torch, args.seed))
        phase = "roofline"
        timing.update(phase_roofline(torch, args.seed))
        # the main path at its full width, on one set of rows: bf16, int8
        # and int8_dot features; then above the single pass's bound
        rows = trainer_rows(args.seed, FULL_D, FULL_B, FULL_TEST)
        paths = {}
        for fd, name in (("bfloat16", "trainer"), ("int8", "trainer_int8"),
                         ("int8_dot", "trainer_int8_dot")):
            phase = name
            paths[name] = phase_trainer(torch, rows, feature_dtype=fd, phase=name)
            if name == "trainer":
                # the same rows on the feature-sharded path, held to this one
                phase = "trainer_feature_sharded"
                ref = (paths[name].pop("final_weights"),
                       {"accuracy": paths[name]["test_accuracy"],
                        "logloss": paths[name]["test_logloss"]})
                paths[phase] = phase_trainer_feature_sharded(torch, rows, ref)
            paths[name].pop("final_weights", None)
        phase = "feature_sharded_small"
        paths.update(phase_feature_sharded_small(torch, args.seed))
        rows = trainer_rows(args.seed, WIDE_D, WIDE_B, WIDE_TEST)
        for fd, name in (("bfloat16", "trainer_wide"), ("int8", "trainer_int8_wide")):
            phase = name
            paths[name] = phase_trainer(torch, rows, feature_dtype=fd, phase=name)
        del rows
        time_two_launch(torch, args.seed, timing)
        for family in ("sparse_lr", "sparse_softmax", "blocked_lr", "softmax"):
            phase = f"trainer_{family}"
            phase_family(torch, args.seed, family)
        phase = "step_softmax_wide"
        time_softmax_wide(torch, args.seed)
        phase = "cli"
        phase_cli()
        phase = "ps"
        ps = phase_ps(torch, args.seed, env["nvidia_smi"])
        phase = "serve"
        serve = phase_serve(torch, args.seed, env["nvidia_smi"])
        phase = "ps_keyed"
        phase_ps_keyed(torch, args.seed, env["nvidia_smi"])
        phase = "ps_wire"
        ps_wire = phase_ps_wire(torch, args.seed, env["nvidia_smi"])
        phase = "ps_recovery"
        ps_recovery = phase_ps_recovery(torch, args.seed, env["nvidia_smi"])
        phase = "ps_durable"
        ps_durable = phase_ps_durable(torch, args.seed, env["nvidia_smi"])
        phase = "ps_elastic"
        ps_elastic = phase_ps_elastic(torch, args.seed, env["nvidia_smi"])
        phase = "serve_hot"
        phase_serve_hot(torch, args.seed, env["nvidia_smi"])
        phase = "route"
        route = phase_route(torch, args.seed, env["nvidia_smi"])
        phase = "online"
        online = phase_online(torch, args.seed, env["nvidia_smi"])
        phase = "roofline_experiments"
        launches = phase_roofline_experiments(torch, env["nvidia_smi"])
        # each dense kernel's launches on the main path that runs it, and
        # on every path, the parameter server's runs among them
        by_path = {}
        for path_name, path in paths.items():  # the full width's path first
            for name in path["kernels"]:
                launches.setdefault(name, path["launches"][name])
                by_path.setdefault(name, {})[path_name] = path["launches"][name]
        for mode in ("sync", "sync_serialized", "async"):
            for name, n in ps[mode]["launches"].items():
                if n:
                    by_path.setdefault(name, {})[f"ps_{mode}"] = n
        for name, n in ps_wire["launches"].items():
            by_path.setdefault(name, {})["ps_wire"] = n
        for name, n in ps_recovery["launches"].items():
            by_path.setdefault(name, {})["ps_recovery"] = n
        for name, n in ps_durable["launches"].items():
            by_path.setdefault(name, {})["ps_durable"] = n
        for name, n in ps_elastic["launches"].items():
            by_path.setdefault(name, {})["ps_elastic"] = n
        for shape, t in ps["kernels_at_ps_shapes"]["timing"].items():
            name, rows = shape.rsplit("_B", 1)
            timing[name].setdefault("at_ps_shapes", {})[f"B{rows}"] = t
        # the scoring tier's run, and its live-PS reload's apart
        for path_name, counts in (("serve", serve["launches"]),
                                  ("serve_live_ps", serve["live_ps"]["launches"]),
                                  ("route", route["launches"]),
                                  ("online", online["launches"])):
            for name, n in counts.items():
                by_path.setdefault(name, {})[path_name] = n
        for shape, t in serve["kernels_at_serve_shapes"].items():
            name, rows = shape.rsplit("_B", 1)
            timing[name].setdefault("at_serve_shapes", {})[f"B{rows}"] = t
    except Exception as e:  # report which phase failed, then fail the run
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        raise
    replaces = {**FUSED_REPLACES, **INT8_REPLACES, **BACKWARD_REPLACES,
                **BACKWARD_INT8_REPLACES, **ROOFLINE_REPLACES}
    sources = {**dict.fromkeys({**FUSED_REPLACES, **BACKWARD_REPLACES}, FUSED_SOURCE),
               **dict.fromkeys({**INT8_REPLACES, **BACKWARD_INT8_REPLACES}, INT8_SOURCE),
               **dict.fromkeys(ROOFLINE_REPLACES, ROOFLINE_SOURCE)}
    kernels = []
    for fn in ops.KERNEL_WRAPPERS:
        name = fn.__name__
        t = timing[name]
        entry = {
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "worst_rel_err": t["rel_err"],
        }
        for extra in ("library_note", "two_pass_ms", "row_blocks_ms", "plan", "shape",
                      "at_8_rows", "at_512_rows", "pair_ms", "wrap", "backward_ms",
                      "at_ps_shapes", "at_serve_shapes", "at_2048_rows_1M",
                      "at_8_column_blocks"):
            if extra in t:
                entry[extra] = t[extra]
        if name in by_path:
            entry["launches_by_path"] = by_path[name]
        if name in ("lr_logits_int8dot", "lr_backward_int8dot"):
            entry["replaces_note"] = INT8_NOTE
        if name in ("lr_backward", "lr_backward_int8"):
            entry["replaces_note"] = BACKWARD_NOTE
        if launches[name] < 1:
            raise AssertionError(f"{name} was never launched on its main path")
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                             "count": env["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
