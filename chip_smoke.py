#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``distlr_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py [--seed 0]

It builds the port's CUDA kernels from the sources in the checkout,
holds each against its plain PyTorch version on the card, drives the
port's main path — the sync dense-LR trainer at the repo's full width
(D = 1,000,000 features, 2048 rows a step, bfloat16 features) — through
``Trainer.load_data / fit / evaluate_metrics / save_model``, then the
``gen-data -> sync -> eval`` CLI in a subprocess.  Each phase prints one
JSON line; any failure exits non-zero before the last line, which is
``{"ok": true, "device": {...}}`` only when every phase passed.  Without
CUDA, or without the rest of the repository beside it, it exits non-zero
and prints no result.  Imports nothing of JAX or of ``distlr_tpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import resource
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth and
# the f32 rate of the CUDA cores, which is what the kernels' products use.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Relative bound of a kernel against its plain version: both sum in f32,
# in different orders.
REL_TOL = 1e-3
FULL_D, FULL_B, FULL_TEST = 1_000_000, 2048, 256
CTR_FIELDS = 39


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after a warm-up)."""
    import torch  # noqa: PLC0415

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    from distlr_tpu_torch.ops import build, fused_lr  # noqa: PLC0415

    t0 = time.perf_counter()
    path = build.build("fused_lr_grad")
    fused_lr._lib()
    emit("build", seconds=time.perf_counter() - t0, library=os.path.relpath(path, ROOT))


def _inputs(torch, gen, B, D, x_dtype, masked_tail=0):
    X = torch.randn(B, D, device="cuda", generator=gen).to(x_dtype)
    w = torch.randn(D, device="cuda", generator=gen) / math.sqrt(D)
    y = (torch.rand(B, device="cuda", generator=gen) < 0.5).to(torch.int32)
    mask = torch.ones(B, device="cuda")
    if masked_tail:
        mask[-masked_tail:] = 0
    return w, X, y, mask


def phase_kernels(torch, seed: int) -> dict:
    """Each kernel against its plain version; timings at the full width."""
    from distlr_tpu_torch import ops  # noqa: PLC0415

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = {"fused_lr_grad": 0.0, "lr_logits": 0.0}
    cases = [(64, 256, 10), (100, 1000, 7), (1, 1, 0), (4096, 16384, 0)]
    for B, D, tail in cases:
        for x_dtype in (torch.float32, torch.bfloat16):
            for cd in ("bfloat16", "float32"):
                w, X, y, mask = _inputs(torch, gen, B, D, x_dtype, tail)
                before = (ops.fused_lr_grad.launches, ops.lr_logits.launches)
                g = ops.fused_lr_grad(w, X, y, mask, compute_dtype=cd)
                z = ops.lr_logits(w, X, compute_dtype=cd)
                torch.cuda.synchronize()
                if (ops.fused_lr_grad.launches, ops.lr_logits.launches) != (before[0] + 1, before[1] + 1):
                    raise AssertionError("a kernel wrapper did not count its launch")
                eg = rel_err(g, ops.fused_lr_grad_reference(w, X, y, mask, compute_dtype=cd))
                ez = rel_err(z, ops.lr_logits_reference(w, X, compute_dtype=cd))
                emit("kernel_check", B=B, D=D, x_dtype=str(x_dtype), compute_dtype=cd,
                     grad_rel_err=eg, logits_rel_err=ez)
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

    # the main path's shape: (2048, 1M) bf16 features, bf16 products
    B, D = FULL_B, FULL_D
    w, X, y, mask = _inputs(torch, gen, B, D, torch.bfloat16, masked_tail=48)
    results = {}
    for cd in ("bfloat16", "float32"):
        g = ops.fused_lr_grad(w, X, y, mask, compute_dtype=cd)
        g_ref = ops.fused_lr_grad_reference(w, X, y, mask, compute_dtype=cd)
        z = ops.lr_logits(w, X, compute_dtype=cd)
        z_ref = ops.lr_logits_reference(w, X, compute_dtype=cd)
        eg, ez = rel_err(g, g_ref), rel_err(z, z_ref)
        emit("kernel_check", B=B, D=D, x_dtype="torch.bfloat16", compute_dtype=cd,
             grad_rel_err=eg, logits_rel_err=ez,
             grad_max_abs_err=float((g - g_ref).abs().max()),
             logits_max_abs_err=float((z - z_ref).abs().max()))
        if not (eg <= REL_TOL and ez <= REL_TOL):
            raise AssertionError(f"kernel disagrees with its plain version at full width ({cd})")
        worst["fused_lr_grad"] = max(worst["fused_lr_grad"], eg)
        worst["lr_logits"] = max(worst["lr_logits"], ez)
        if cd == "bfloat16":
            results["fused_lr_grad"] = {"max_abs_err": float((g - g_ref).abs().max())}
            results["lr_logits"] = {"max_abs_err": float((z - z_ref).abs().max())}
        del g_ref, z_ref

    # timings at the main path's shape and types
    x_bytes = B * D * X.element_size()
    wb, yf = w.to(torch.bfloat16), y.to(torch.float32)

    def library_grad():
        r = (torch.sigmoid(torch.mv(X, wb).float()) - yf) * mask
        return torch.mv(X.t(), r.to(torch.bfloat16))

    reps = 25
    grad_bytes = x_bytes + D * 4 + 2 * B * 4 + D * 4      # X, w, y, mask in; g out
    grad_ops = 4 * B * D                                  # a multiply-add each way
    results["fused_lr_grad"].update(
        ms=time_ms(lambda: ops.fused_lr_grad(w, X, y, mask), reps),
        plain_ms=time_ms(lambda: ops.fused_lr_grad_reference(w, X, y, mask), reps),
        library_ms=time_ms(library_grad, reps),
        bound_ms=1e3 * max(grad_bytes / HBM_BYTES_PER_S, grad_ops / F32_FLOPS_PER_S),
        bound_by="bytes" if grad_bytes / HBM_BYTES_PER_S >= grad_ops / F32_FLOPS_PER_S else "operations",
        two_read_floor_ms=1e3 * (2 * x_bytes) / HBM_BYTES_PER_S,
    )
    logits_bytes = x_bytes + D * 4 + B * 4
    logits_ops = 2 * B * D
    results["lr_logits"].update(
        ms=time_ms(lambda: ops.lr_logits(w, X), reps),
        plain_ms=time_ms(lambda: ops.lr_logits_reference(w, X), reps),
        library_ms=time_ms(lambda: torch.mv(X, wb), reps),
        bound_ms=1e3 * max(logits_bytes / HBM_BYTES_PER_S, logits_ops / F32_FLOPS_PER_S),
        bound_by="bytes" if logits_bytes / HBM_BYTES_PER_S >= logits_ops / F32_FLOPS_PER_S else "operations",
    )
    for name, r in results.items():
        r["rel_err"] = worst[name]
        emit("kernel_timing", kernel=name, B=B, D=D, x_dtype="bfloat16", reps=reps, **r)
    del X
    torch.cuda.empty_cache()
    return results


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


def phase_trainer(torch, seed: int) -> dict:
    """The main path at full width: load_data -> fit -> evaluate -> save."""
    import numpy as np  # noqa: PLC0415

    from distlr_tpu_torch import ops  # noqa: PLC0415
    from distlr_tpu_torch.config import Config  # noqa: PLC0415
    from distlr_tpu_torch.train import GlobalShardedData, Trainer  # noqa: PLC0415

    steps = 3
    rng = np.random.default_rng(seed)
    w_true = (rng.standard_normal(FULL_D) * 0.5).astype(np.float32)
    t0 = time.perf_counter()
    train = GlobalShardedData([_ctr_rows(rng, FULL_B, w_true, FULL_D)])
    test = GlobalShardedData([_ctr_rows(rng, FULL_TEST, w_true, FULL_D)])
    data_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="distlr-smoke-") as tmp:
        cfg = Config(num_feature_dim=FULL_D, feature_dtype="bfloat16",
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
        launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
        saved_ok = os.path.getsize(path) > FULL_D and open(path).readline().strip() == str(FULL_D)

    if launches["fused_lr_grad"] < steps or launches["lr_logits"] < 1:
        raise AssertionError(f"the main path did not run its kernels once a step: {launches}")
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
        "D": FULL_D, "B": FULL_B, "test_rows": FULL_TEST, "steps": steps,
        "launches": launches, "loss": loss, "test_accuracy": metrics["accuracy"],
        "test_logloss": metrics["logloss"], "step_ms": 1e3 * trainer.timer.sec_per_step,
        "step_device_ms": step_device_ms,
        "weights_rel_err_vs_plain": w_rel, "data_build_s": data_s, "load_s": load_s,
        "fit_eval_save_s": fit_s,
        "host_peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "device_peak_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit("trainer", **out)
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
        phase = "kernels"
        timing = phase_kernels(torch, args.seed)
        phase = "trainer"
        trainer = phase_trainer(torch, args.seed)
        phase = "cli"
        phase_cli()
    except Exception as e:  # report which phase failed, then fail the run
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        raise
    replaces = {"fused_lr_grad": "distlr_tpu/ops/pallas_lr.py:86",
                "lr_logits": "distlr_tpu/ops/pallas_lr.py:75"}
    kernels = []
    for fn in ops.KERNEL_WRAPPERS:
        t = timing[fn.__name__]
        kernels.append({
            "name": fn.__name__, "route": "cuda",
            "source": "distlr_tpu_torch/ops/csrc/fused_lr_grad.cu",
            "replaces": replaces[fn.__name__],
            "launches": trainer["launches"][fn.__name__],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "worst_rel_err": t["rel_err"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                             "count": env["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
