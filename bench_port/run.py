"""Run one cell of the port's benchmark once.

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench_port/``
and the ``distlr_tpu_torch`` package.  It drives the user's entry of
``distlr_tpu_torch``: libsvm shards made from the seed, ``Trainer.load_data``,
then one ``Trainer.fit`` call of whole epochs, an eval every
``test_interval`` epochs, as a user's job runs.

Set-up (``setup_s``, from the start of this process): the cell's rows and
their libsvm shards under ``$TMPDIR``, ``Trainer(cfg).load_data()``,
``init_weights()``, epochs through one ``fit`` call (the first warms up
and records its first three steps, the traffic's ``timed_epochs`` after it
are timed), one eval.  The window's epoch count is
the multiple of ``test_interval`` that the timed epoch says fills
``--seconds`` most nearly, so the window ends on an eval of its final
weights.  Kernels build at their first call into ``build/`` inside the
checkout (``distlr_tpu_torch.utils.native``), so only the first run of a
checkout compiles.

The window: ``train_samples_per_s`` is every row trained in it over its
whole length, evals and epoch boundaries included.  With ``--trace 1``
``torch.profiler`` records the card over the window and the per-layer
metrics are read from it and from the program's phase spans.

After the window: the device's peak memory is read, the trainer is freed,
and the plain reference (``bench_port/reference/``) parses the shards
again, trains from its own initial weights over every step that set-up and
the window ran, in order, and evaluates its own final weights; the
program's first steps, final weights and last eval are judged against it.
The numbers and their limits end standard error and the result line.

Exit codes: 0 with a result; 2 without a card or with fewer cards than the
cell asks for; 3 when JAX or the JAX package is loaded once the window has
closed; 1 on any other failure.  No result is printed unless 0.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from bench_port import gen, judge, spec, trace  # noqa: E402

#: top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "distlr_tpu")
#: the reference sides ``correct`` can judge: (precision key, half batch)
SIDES = {"reference": ("precision", False), "control": ("control", False),
         "half_batch": ("precision", True)}


def forbidden_modules(names) -> list[str]:
    """The names whose top-level part (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``distlr_tpu_torch`` is not
    ``distlr_tpu``."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    cell: spec.Cell
    window_s: float
    steps: int
    evals: int
    phases: dict
    spans: list
    events: list | None
    busy_s: float
    step_bounds: list[float]  # the least time of each batch of an epoch
    eval_bound: float
    on_card: bool


@dataclasses.dataclass
class Setup:
    cell: spec.Cell
    seed: int
    device: str
    tmp: str
    trainer: object
    train_rows: gen.Rows
    test_rows: gen.Rows
    first_steps: dict   # losses of the first steps, weights after the first and third
    setup_epochs: int
    epoch_s: float      # the mean of set-up's timed epochs, boundaries included
    setup_s: float

    @property
    def batch_size(self) -> int:
        return self.cell.traffic["batch_size"]

    @property
    def batches_per_epoch(self) -> int:
        return -(-len(self.train_rows) // self.batch_size)

    def window_epochs(self, seconds: float) -> int:
        """The multiple of ``test_interval`` epochs nearest ``seconds`` at
        the timed epoch's pace (at least one)."""
        ti = self.cell.traffic["test_interval"]
        return ti * max(1, round(seconds / (ti * self.epoch_s)))


def _program_config(cell: spec.Cell, seed: int, data_dir: str, device: str):
    from distlr_tpu_torch.config import Config  # noqa: PLC0415

    c, t = cell.config, cell.traffic
    return Config(
        model=c["model"], num_feature_dim=c["num_feature_dim"], data_dir=data_dir,
        batch_size=t["batch_size"], learning_rate=c["learning_rate"], l2_c=c["l2_c"],
        test_interval=t["test_interval"], random_seed=init_seed(seed),
        feature_dtype=c["feature_dtype"], compute_dtype=c["compute_dtype"],
        nnz_max=c.get("nnz_max"), prefetch=t["prefetch"], num_workers=1, device=device)


def init_seed(seed: int) -> int:
    """The seed the weights' init takes (the program's ``random_seed``)."""
    return int(seed) % 2**63


def setup(cell: spec.Cell, seed: int, device: str, t_start: float) -> Setup:
    """Everything before the window; ``setup_s`` counts from ``t_start``."""
    import torch  # noqa: PLC0415

    from distlr_tpu_torch.train.trainer import Trainer  # noqa: PLC0415

    c = cell.config
    B = cell.traffic["batch_size"]
    if c["train_rows"] < judge.RECORDED_STEPS * B:
        raise ValueError(f"{cell.name}: the first {judge.RECORDED_STEPS} steps need "
                         f"{judge.RECORDED_STEPS * B} rows, the cell has {c['train_rows']}")
    tmp = tempfile.mkdtemp(prefix="bench_port-")
    try:
        train_rows, test_rows = gen.make_rows(seed, c, c["train_rows"], c["test_rows"])
        gen.write_split(tmp, "train", train_rows)
        gen.write_split(tmp, "test", test_rows)
        trainer = Trainer(_program_config(cell, seed, tmp, device)).load_data()
        trainer.init_weights()

        # set-up's epochs in one fit call, through its own feed: one to warm
        # up, whose first steps are recorded, then the traffic's
        # ``timed_epochs`` (default 1), which size the window; every step's
        # start is timed
        step, first, starts = trainer.train_step, {"losses": []}, []

        def recording(w, batch):
            starts.append(time.perf_counter())
            w, metrics = step(w, batch)
            k = len(starts)
            if k <= judge.RECORDED_STEPS:
                first["losses"].append(float(metrics["loss"]))
            if k in (1, judge.RECORDED_STEPS):
                first["w1" if k == 1 else "w3"] = w.detach().to(device="cpu",
                                                                 dtype=torch.float64)
            return w, metrics

        timed = int(cell.traffic.get("timed_epochs", 1))
        trainer.train_step = recording
        try:
            trainer.fit(epochs=1 + timed)
        finally:
            trainer.train_step = step
        bpe = len(starts) // (1 + timed)
        epoch_s = (starts[-1] - starts[bpe - 1]) / timed
        trainer.evaluate_metrics()
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return Setup(cell, seed, device, tmp, trainer, train_rows, test_rows, first, 1 + timed,
                 epoch_s, time.perf_counter() - t_start)


def _counts(rows: gen.Rows) -> dict:
    return {"rows": len(rows), "nnz": rows.nnz(), "distinct": rows.distinct()}


def _cpu_seconds() -> float:
    t = os.times()
    return t.user + t.system


def window(s: Setup, seconds: float, traced: bool) -> dict:
    """One ``fit`` call of ``s.window_epochs(seconds)`` epochs: what the
    window did, and with ``traced`` its device trace."""
    import torch  # noqa: PLC0415

    from distlr_tpu_torch.obs.tracing import get_tracer  # noqa: PLC0415

    trainer, epochs = s.trainer, s.window_epochs(seconds)
    cuda = trainer.device.type == "cuda"
    device_trace = trace.DeviceTrace() if traced and cuda else None
    if device_trace:
        device_trace.start()
    tracer = get_tracer()
    cpu0 = _cpu_seconds()
    tracer.reset()
    t_epoch = time.perf_counter()
    t0 = time.perf_counter()
    trainer.fit(epochs=epochs)
    if cuda:
        torch.cuda.synchronize(trainer.device)
    t1 = time.perf_counter()
    phases = tracer.breakdown()
    h2d = phases.get("h2d", {})
    out = {"t0": t0, "t1": t1, "epochs": epochs,
           "evals": epochs // s.cell.traffic["test_interval"], "phases": phases,
           # for standard error: the epoch count's basis, the host's pin
           # and enqueue a batch, the process's CPU seconds over the window
           "diagnostics": {"setup_epoch_s": s.epoch_s, "epochs": epochs,
                           "h2d_ms_per_batch": (1e3 * h2d["seconds"] / h2d["count"]
                                                if h2d.get("count") else None),
                           "process_cpu_s": _cpu_seconds() - cpu0},
           "memory_peak_bytes": torch.cuda.max_memory_allocated(trainer.device) if cuda else 0}
    if traced:
        out["spans"] = [(e["name"], t_epoch + e["ts"] / 1e6, t_epoch + (e["ts"] + e["dur"]) / 1e6)
                        for e in tracer.chrome_trace()["traceEvents"]]
        out["events"] = (trace.clip(device_trace.stop(s.tmp), t0, t1)
                         if device_trace else None)
    return out


def program_side(s: Setup) -> dict:
    """What the program produced, read before it is freed: its first
    steps, its final weights and the window's last eval of them."""
    import torch  # noqa: PLC0415

    m = s.trainer.metrics
    return {**s.first_steps,
            "w_final": s.trainer.weights.detach().to(device="cpu", dtype=torch.float64),
            "eval": {"logloss": float(m.latest("test_logloss")),
                     "accuracy": float(m.latest("accuracy"))}}


def free_program(s: Setup) -> None:
    import torch  # noqa: PLC0415

    s.trainer = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Reference:
    """The plain reference on a cell's shards in ``data_dir``: the train
    split's batches in the program's order and the test rows, parsed again
    from the libsvm text, and the cell's initial weights worked out again."""

    def __init__(self, cell: spec.Cell, seed: int, data_dir: str, device: str):
        self.cell, self.mod, self.device = cell, cell.reference, device
        c, B = cell.config, cell.traffic["batch_size"]
        cols, vals, y = self.mod.read_libsvm(os.path.join(data_dir, "train", "part-001"))
        self.raw = [(cols[k:k + B], vals[k:k + B], y[k:k + B]) for k in range(0, len(y), B)]
        self.test_raw = self.mod.read_libsvm(os.path.join(data_dir, "test", "part-001"))
        self.w0 = self.mod.init_weights(c["init"], init_seed(seed), c["num_feature_dim"])

    def precision(self, key: str) -> dict:
        """The configuration's precision (``precision``: operands as stated,
        float64 sums) or its control's (``control``)."""
        prec = self.cell.config[key]
        return dict(prec, accumulate="float64") if key == "precision" else prec

    def side(self, name: str, epochs: int) -> dict:
        """The side ``name`` of ``SIDES`` over ``epochs`` passes: its first
        steps, final weights and its eval of them at its own precision."""
        key, half = SIDES[name]
        prec, c = self.precision(key), self.cell.config
        batches = [self.mod.Batch(*b, prec, self.device) for b in self.raw]
        out = self.mod.train(self.w0, batches, c["learning_rate"], c["l2_c"], prec, epochs,
                             recorded=judge.RECORDED_STEPS, half_batch=half)
        out["eval"] = self.mod.evaluate(out["w_final"],
                                        self.mod.Batch(*self.test_raw, prec, self.device), prec)
        return out

    def judge(self, side: dict, reference: dict) -> dict:
        return judge.numbers(side, reference, self.w0, self.cell.config["learning_rate"])


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str,
             t_start: float | None = None, sides: tuple[str, ...] = ()) -> dict:
    """One run of ``cell``: the result line's object.  ``sides`` names
    reference sides (``control``, ``half_batch``) to judge over the same
    steps as well; their numbers and all of the program's go under
    ``"sides"``."""
    import torch  # noqa: PLC0415

    s = setup(cell, seed, device, time.perf_counter() if t_start is None else t_start)
    try:
        w = window(s, seconds, traced)
        program = program_side(s)
        free_program(s)
        window_s = w["t1"] - w["t0"]
        steps = w["epochs"] * s.batches_per_epoch
        samples = w["epochs"] * len(s.train_rows)
        if traced:
            metrics = _per_layer(s, w, window_s, steps)
        else:
            metrics = {"train_samples_per_s": {"value": samples / window_s, "unit": "samples/s"},
                       "setup_s": {"value": s.setup_s, "unit": "s"}}
        ref = Reference(cell, seed, s.tmp, device)
        epochs = s.setup_epochs + w["epochs"]
        exact = ref.side("reference", epochs)
        numbers = ref.judge(program, exact)
        other = {name: ref.judge(ref.side(name, epochs), exact) for name in sides}
    finally:
        shutil.rmtree(s.tmp, ignore_errors=True)
    cuda = device.startswith("cuda")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": w["memory_peak_bytes"]}
    result = {"correct": judge.verdict(numbers, cell.limits), "attempted": steps, "failed": 0,
              "metrics": metrics, "device": dev}
    if traced:
        events = w["events"] or []
        dev["busy_s"] = trace.busy_seconds(events)
        dev["window_s"] = window_s
        if events:
            result["breakdown"] = trace.breakdown(events, w["spans"], w["t0"], w["t1"])
    result["diagnostics"] = {**w["diagnostics"], "phases": w["phases"]}
    if sides:
        result["sides"] = {"program": numbers, **other}
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in judge.checks(numbers, cell.limits).items()}
    return result


def _per_layer(s: Setup, w: dict, window_s: float, steps: int) -> dict:
    cell, B = s.cell, s.batch_size
    batches = [_counts(s.train_rows.take(k * B, (k + 1) * B)) for k in range(s.batches_per_epoch)]
    test = _counts(s.test_rows)
    events = w["events"]
    ctx = Context(
        cell=cell, window_s=window_s, steps=steps, evals=w["evals"], phases=w["phases"],
        spans=w["spans"], events=events, busy_s=trace.busy_seconds(events or []),
        step_bounds=[cell.work.step_bound_s(cell, b) for b in batches],
        eval_bound=cell.work.eval_bound_s(cell, test), on_card=s.device.startswith("cuda"))
    units = {m["name"]: m["unit"] for m in cell.per_layer}
    out = {}
    for name, reader in cell.readers().items():
        value = reader.read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": units[name]}
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = spec.load_cell(os.getcwd(), args.workload)
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", _T_START)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    result.pop("sides", None)
    for name, value in result.pop("diagnostics").items():
        print(f"window {name}: {value}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, chk in result["checks"].items():
        print(f"check {name}: {chk['value']} (limit {chk['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
