"""The input pipeline's span readers on a hand-made context: values
worked out by hand, and nothing where the program recorded no such span
(off the card, or a program that lacks the span)."""

from __future__ import annotations

import pytest

from bench_port import run, spec
from bench_port.tests.conftest import ROOT

#: a dense cell's phases over a 40 s window: 4 steps of 2 GB pinned in
#: 0.1 s each, 1 s spent waiting on copies, two epochs' refills of 3 s
PHASES = {
    "data_load": {"seconds": 20.0, "count": 6},
    "h2d": {"seconds": 0.5, "count": 4},
    "pin": {"seconds": 0.4, "count": 4, "bytes": 8_000_000_000},
    "h2d_copy": {"seconds": 0.8, "count": 4, "bytes": 8_000_000_000},
    "copy_wait": {"seconds": 1.0, "count": 3},
    "epoch_fill": {"seconds": 6.0, "count": 2},
}
WINDOW_S = 40.0
WANT = {"pin_gb_per_s": 20.0, "copy_wait_share": 2.5, "epoch_fill_share": 15.0}
#: the phases each reader reads; without them it reads nothing
NEEDS = {"pin_gb_per_s": ("pin",), "copy_wait_share": ("copy_wait", "h2d_copy"),
         "epoch_fill_share": ("epoch_fill",)}


def _ctx(phases, window_s=WINDOW_S):
    return run.Context(cell=None, window_s=window_s, steps=4, evals=0, phases=phases, spans=[],
                       events=None, busy_s=0.0, step_bounds=[], eval_bound=0.0, on_card=True)


def _reader(name):
    return spec.load_module(str(ROOT / "bench_port" / "metrics" / f"{name}.py"))


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_hand_worked_value(name):
    assert _reader(name).read(_ctx(PHASES)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_without_its_phases(name):
    phases = {k: v for k, v in PHASES.items() if k not in NEEDS[name]}
    assert _reader(name).read(_ctx(phases)) is None


@pytest.mark.parametrize("name", ["copy_wait_share", "epoch_fill_share"])
def test_share_reads_nothing_over_an_empty_window(name):
    assert _reader(name).read(_ctx(PHASES, window_s=0.0)) is None


def test_copy_wait_share_is_zero_where_no_step_waited_for_its_copy():
    phases = {k: v for k, v in PHASES.items() if k != "copy_wait"}
    assert _reader("copy_wait_share").read(_ctx(phases)) == 0.0


def test_pin_rate_needs_bytes():
    phases = {**PHASES, "pin": {"seconds": 0.4, "count": 4}}
    assert _reader("pin_gb_per_s").read(_ctx(phases)) is None


def test_each_reader_is_listed_for_the_dense_cell():
    cell = spec.load_cell(str(ROOT), "criteo_dense_1m.sync_b2048")
    listed = {m["name"]: m for m in cell.per_layer}
    for name in WANT:
        assert listed[name]["source"] == "program_span"
        assert listed[name]["layer"] == "train.trainer input pipeline"
        assert listed[name]["moves"] == "train_samples_per_s"
