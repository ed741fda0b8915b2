"""The comparison that decides ``correct`` fails the control and the
faults: at a size that a test run holds, the reference in bfloat16 in
the program's place, and a run whose timed path is broken underneath
(its state left unchanged; half of each chunk left out and the rest
weighted double) come out not correct against the cells' limits.

The control's readings grow with the updates a row takes in an epoch
(bfloat16 loses an update below half its last place), so its test logs
give each item thousands of ratings (the resident cells) or each user
hundreds (the tiled ones, whose catalog passes 40 item blocks)."""

import time

import numpy as np
import pytest
import torch

from cfbench import control
from cfbench import harness as hz
from cfbench.run import run_cell

CONTROL_SHAPES = {
    "biasedmf-k40.netflix": (20_000, 300, 1_000_000),
    "bprmf-k40-pair.netflix": (20_000, 300, 1_000_000),
    "biasedmf-k40.ml25m": (6_000, 42_000, 1_500_000),
    "bprmf-k40-pair.ml25m": (6_000, 42_000, 1_500_000),
}


def exceeds(cell, numbers):
    limits = cell.spec_file["limits"]
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("name", sorted(CONTROL_SHAPES))
def test_control_and_reference_faults_fail_the_limits(small_cell, name):
    cell = small_cell(name, *CONTROL_SHAPES[name])
    r = control.seed_readings(cell, 2 ** 31 + 21, "cpu", True)
    assert not exceeds(cell, r["program"])
    for fault in ("bfloat16", "half", "unchanged"):
        assert exceeds(cell, r[fault]), (fault, r[fault])


def unchanged(fn):
    def epoch(W, H, *a, **kw):
        return (W, H) if "sgd" in fn.__name__ else (W, H, None)
    return epoch


def half_batch(fn):
    """The epoch on chunks whose odd slots weigh nothing and whose even
    slots weigh double (row 3 of the packed chunks: the slot weight)."""
    def epoch(W, H, packed, *a, **kw):
        p = packed.clone()
        w = p[:, 3].view(torch.float32)
        w[:, 1::2] = 0.0
        w[:, 0::2] *= 2.0
        return fn(W, H, p, *a, **kw)
    epoch.__name__ = fn.__name__
    return epoch


def broken_cell(small_cell, name):
    return small_cell(name, *((3_000, 42_000, 60_000) if "ml25m" in name
                              else (3_000, 1_500, 60_000)))


@pytest.mark.parametrize("fault", [unchanged, half_batch])
@pytest.mark.parametrize("name", sorted(CONTROL_SHAPES))
def test_a_broken_timed_path_is_not_correct(small_cell, name, fault):
    cell = broken_cell(small_cell, name)
    with hz.patched(cell.program.EPOCH_WRAPPERS, fault):
        res = run_cell(cell, 77, 0.1, False, "cpu", time.perf_counter())
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("fault", [unchanged, half_batch])
@pytest.mark.parametrize("name", sorted(CONTROL_SHAPES))
def test_a_timed_path_broken_only_in_the_window_is_not_correct(
        small_cell, monkeypatch, name, fault):
    """Set-up's epochs sound, the window's broken: the window epoch's
    numbers fail, the first epoch's pass."""
    cell = broken_cell(small_cell, name)
    sound_window = hz.window

    def window(*a, **kw):
        with hz.patched(cell.program.EPOCH_WRAPPERS, fault):
            return sound_window(*a, **kw)

    monkeypatch.setattr(hz, "window", window)
    res = run_cell(cell, 78, 0.1, False, "cpu", time.perf_counter())
    chk = res["checks"]
    assert res["correct"] is False
    assert chk["loss_gap"]["value"] <= chk["loss_gap"]["limit"]
    assert any(chk[k]["value"] > chk[k]["limit"]
               for k in ("window_loss_gap", "window_change_gap"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONTROL_SHAPES))
def test_on_the_card_sound_runs_pass_and_the_control_fails(
        cuda_device, small_cell, name):
    cell = small_cell(name, *CONTROL_SHAPES[name])
    r = control.seed_readings(cell, 2 ** 31 + 99, cuda_device, True)
    assert not exceeds(cell, r["program"])
    assert exceeds(cell, r["bfloat16"]) and exceeds(cell, r["half"])
    assert np.isfinite(r["program"]["loss"])


@pytest.mark.parametrize("name", ["biasedmf-k40.netflix",
                                  "bprmf-k40-pair.netflix"])
def test_a_window_that_repeats_an_earlier_epochs_order_is_not_correct(
        small_cell, monkeypatch, name):
    """Each window epoch run with the epoch index (and so the visit
    order, negatives and random bits) of the window's first."""
    cell = broken_cell(small_cell, name)
    sound_window = hz.window

    def window(model, *a, **kw):
        iterate = model.iterate

        def stale():
            model._epoch_counter = hz.SETUP_EPOCHS
            iterate()

        model.iterate = stale
        return sound_window(model, *a, **kw)

    monkeypatch.setattr(hz, "window", window)
    res = run_cell(cell, 79, 1.0, False, "cpu", time.perf_counter())
    assert res["attempted"] >= 2
    assert res["correct"] is False
