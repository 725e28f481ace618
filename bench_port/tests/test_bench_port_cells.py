"""Every cell rehearsed on the CPU at a tiny width, sound and with the
timed path broken underneath; the control at the cell's own size."""

from __future__ import annotations

import pytest
import torch

from bench_port import judge, run
from bench_port.tests.conftest import KEPT, ROOT, TINY, TINY_BATCH, WORKLOADS, load_cell

SEED = 2**31 + 17


#: a window this short runs the least epochs a window can: one eval interval
SECONDS = 0.01


def _run(cell, traced=False):
    return run.run_cell(cell, seed=SEED, seconds=SECONDS, traced=traced, device="cpu")


@pytest.mark.parametrize("workload", KEPT)
def test_rehearsal_is_correct(tiny, workload):
    cell = tiny(workload)
    r = _run(cell)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert r["metrics"]["train_samples_per_s"]["value"] > 0
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(cell.limits)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_rehearsal_reads_the_spans(tiny, workload):
    """Off the card a traced run reads the program's spans; the device
    metrics, which need the card's trace, stay out of the line."""
    cell = tiny(workload)
    r = _run(cell, traced=True)
    assert r["correct"] is True, r["checks"]
    assert "data_wait_share" in r["metrics"]
    device_metrics = {m["name"] for m in cell.per_layer if m["source"] == "device_trace"}
    assert not device_metrics & set(r["metrics"])
    assert "train_mfu" not in r["metrics"]
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0


def _frozen_step(make_step, cell=None):
    """A step that returns the weights unchanged."""
    def make(model, cfg, mesh):
        real = make_step(model, cfg, mesh)

        def step(w, batch):
            _, metrics = real(w.clone(), batch)
            return w, metrics
        return step
    return make


def _half_batch_step(make_step, cell=None):
    """A step that leaves the second half of the batch out and takes the
    mean over the rest."""
    def make(model, cfg, mesh):
        real = make_step(model, cfg, mesh)

        def step(w, batch):
            *inputs, y, mask = batch
            mask = mask.clone()
            mask[len(mask) // 2:] = 0
            return real(w, (*inputs, y, mask))
        return step
    return make


def _altered_eval(make_eval, cell=None):
    """An eval whose answer is altered where it is made: one more row
    counted right."""
    def make(model, mesh=None):
        real = make_eval(model, mesh)

        def evaluate(w, batch):
            out = dict(real(w, batch))
            out["accuracy"] = out["accuracy"] + 1.0 / len(batch[-1])
            return out
        return evaluate
    return make


def _late_step(fault):
    """A step that runs sound through a tiny cell's set-up and once in
    the window does ``fault(real, w, batch, previous batch)`` instead."""
    def breaker(make_step, cell):
        setup_steps = (1 + cell.traffic.get("timed_epochs", 1)) * (TINY["train_rows"] // TINY_BATCH)

        def make(model, cfg, mesh):
            real, calls, last = make_step(model, cfg, mesh), [0], [None]

            def step(w, batch):
                calls[0] += 1
                prev, last[0] = last[0], batch
                if calls[0] == setup_steps + 2:
                    return fault(real, w, batch, prev)
                return real(w, batch)
            return step
        return make
    return breaker


def _unchanged(real, w, batch, prev):
    _, metrics = real(w.clone(), batch)
    return w, metrics


def _stale(real, w, batch, prev):
    return real(w, prev)


FAULTS = {
    "state_unchanged": ("make_sync_train_step", _frozen_step),
    "half_batch": ("make_sync_train_step", _half_batch_step),
    "answer_altered": ("make_eval_step", _altered_eval),
    "window_step_unchanged": ("make_sync_train_step", _late_step(_unchanged)),
    "window_stale_batch": ("make_sync_train_step", _late_step(_stale)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", KEPT)
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, workload, fault):
    """The harness's run, with the program broken underneath (the check
    for a card is the only part skipped): ``correct`` comes out false.  No
    cell spans chips, so the fault of a skipped exchange has no place."""
    from distlr_tpu_torch.train import trainer as trainer_mod

    name, breaker = FAULTS[fault]
    cell = tiny(workload)
    monkeypatch.setattr(trainer_mod, name, breaker(getattr(trainer_mod, name), cell))
    r = _run(cell)
    assert r["correct"] is False, r["checks"]


#: epochs the control test's sides run: a dozen, fewer than a window's
CONTROL_EPOCHS = 12


@pytest.mark.parametrize("workload", KEPT)
def test_control_is_not_correct(tmp_path, workload):
    """The reference at the precision below the configuration's, in the
    program's place, at the cell's own size (its train and test rows) for
    a dozen epochs, fails the cell's limits; so does the half-batch fault;
    the reference run twice agrees with itself."""
    from bench_port import gen

    cell = load_cell(workload)
    c = cell.config
    train, test = gen.make_rows(SEED, c, c["train_rows"], c["test_rows"])
    gen.write_split(str(tmp_path), "train", train)
    gen.write_split(str(tmp_path), "test", test)
    ref = run.Reference(cell, SEED, str(tmp_path), "cpu")
    exact = ref.side("reference", CONTROL_EPOCHS)
    for side in ("control", "half_batch"):
        nums = ref.judge(ref.side(side, CONTROL_EPOCHS), exact)
        assert not judge.verdict(nums, cell.limits), (side, nums)
    assert judge.verdict(ref.judge(ref.side("reference", CONTROL_EPOCHS), exact), cell.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_card(workload):
    """One short run of each cell on the card, at its own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from bench_port import spec

    r = run.run_cell(spec.load_cell(str(ROOT), workload), seed=SEED, seconds=2.0,
                     traced=False, device="cuda")
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
