"""The port's spans and counters (``mymedialite_tpu_torch/trace.py``):
nothing recorded while recording is off; under a profiler, each epoch of
BiasedMF and BPRMF one ``step.iterate`` tree whose spans lie on the
profiler's clock beside their ``mml.*`` ranges; the plan's phase
counters, always on.

The ``cuda`` case runs on a GPU machine without jax (bypass the suite's
conftest):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_trace.py -q
"""

import importlib.util
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mymedialite_tpu_torch import trace
from mymedialite_tpu_torch.data.synthetic import (
    posonly_from_ratings, synthetic_ratings,
)
from mymedialite_tpu_torch.models.registry import (
    create_item_recommender, create_rating_predictor,
)
from mymedialite_tpu_torch.ops import bpr_epoch as BE
from mymedialite_tpu_torch.ops import bpr_plan as BP
from mymedialite_tpu_torch.ops import plan as P
from mymedialite_tpu_torch.ops import sgd_epoch as SE

# the children of each family's step.iterate, the first epoch's also
# step.tables (and BPR's plan, built at its first iterate)
STEP_CHILDREN = {
    "rating": {"copy.rates", "step.order", "copy.order", "kernel.sgd_epoch"},
    "triple": {"copy.rates", "step.bits", "step.order", "copy.order",
               "copy.order_back", "step.negatives", "copy.negatives",
               "kernel.bpr_epoch"},
}
PLAN_PHASES = {"plan.shuffle", "plan.popularity", "plan.bucketize",
               "copy.plan"}


@pytest.fixture(autouse=True)
def clean():
    trace.reset()
    yield
    trace.reset()


def _ratings():
    return synthetic_ratings(num_users=300, num_items=200, num_ratings=5000,
                             seed=1)


def _model(family, device="cpu"):
    """A small BiasedMF or BPRMF on ``device``, its model initialised."""
    r = _ratings()
    if family == "rating":
        m = create_rating_predictor("BiasedMatrixFactorization",
                                    f"num_factors=8 device={device}")
        m.ratings = r
    else:
        m = create_item_recommender("BPRMF", f"num_factors=8 device={device}")
        m.feedback = posonly_from_ratings(r)
    m.init_model()
    return m


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_off_records_nothing():
    assert not trace.on()
    sp = trace.span("step.iterate", route="resident")
    assert sp is trace.NOOP and trace.span("copy.rates") is trace.NOOP
    with sp as inner:
        inner.set(epoch=1)
        _model("rating").iterate()
    assert trace.spans() == []
    # the counters stay on
    assert trace.counters()["plan.prepare.seconds"] > 0


@pytest.mark.parametrize("family", ["rating", "triple"])
def test_two_epochs_give_two_step_trees_on_the_profilers_clock(family):
    model = _model(family)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.iterate()
        model.iterate()
    spans = trace.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["step.iterate"] * 2
    assert roots[0].epoch != roots[1].epoch
    assert [s.attrs for s in roots] == [
        {"route": "resident", "epoch": 1}, {"route": "resident", "epoch": 2}]
    first = {s.name for s in _children(spans, roots[0])}
    second = {s.name for s in _children(spans, roots[1])}
    expect = STEP_CHILDREN[family]
    assert second == expect
    if family == "rating":
        assert first == expect | {"step.tables"}
    else:
        assert first == expect | {"step.tables", "plan.prepare"}
        prep = next(s for s in spans if s.name == "plan.prepare")
        assert prep.attrs == {"fn": "prepare_bpr_mxu"}
        assert {s.name for s in _children(spans, prep)} == \
            PLAN_PHASES | {"plan.membership"}
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.start <= s.end
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end
            assert s.epoch == p.epoch
    kernel = next(iter(k for k in expect if k.startswith("kernel.")))
    assert [s.epoch for s in spans if s.name == kernel] == \
        [r.epoch for r in roots]
    # each span starts within 1 ms of its own range in the profiler
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("mml.")
              and "cpu" in str(e.device_type()).lower()]
    for name in {s.name for s in spans}:
        mine = sorted(s.start for s in spans if s.name == name)
        theirs = sorted(e.start_ns() for e in events
                        if e.name() == "mml." + name)
        assert len(mine) == len(theirs), name
        for a, b in zip(mine, theirs):
            assert abs(a - b) < 1_000_000, (name, a - b)


def test_recording_without_a_profiler_and_reset():
    model = _model("rating")
    with trace.recording():
        assert trace.on()
        model.iterate()
    assert not trace.on()
    assert [s.name for s in trace.spans() if s.parent is None] == \
        ["step.iterate"]
    model.iterate()
    assert len([s for s in trace.spans() if s.parent is None]) == 1
    trace.reset()
    assert trace.spans() == [] and trace.counters() == {}


@pytest.mark.parametrize("family", ["rating", "triple"])
def test_plan_phases_are_counted_once_per_outermost_call(family):
    r = _ratings()
    with trace.recording():
        if family == "rating":
            P.prepare_mxu_tiled(r.users, r.items, r.values, r.num_users,
                                r.num_items, slab_blocks=1)
            fn, phases = "prepare_mxu_tiled", PLAN_PHASES
        else:
            BP.prepare_bpr_mxu(posonly_from_ratings(r), uniform_user=True)
            fn, phases = "prepare_bpr_mxu", PLAN_PHASES | {"plan.membership"}
    c = trace.counters()
    assert set(c) == {name + ".seconds" for name in phases | {"plan.prepare"}}
    for name in phases | {"plan.prepare"}:
        assert c[name + ".seconds"] > 0, name
    # the nested prepare_mxu_data counts in its caller's plan.prepare
    spans = trace.spans()
    prep = [s for s in spans if s.name == "plan.prepare"]
    assert [s.attrs for s in prep] == [{"fn": fn}]
    assert [s.name for s in spans].count("plan.bucketize") == 1
    assert c["plan.prepare.seconds"] >= c["plan.bucketize.seconds"]


def test_a_phase_inside_its_own_name_counts_once():
    t0 = time.perf_counter()
    with trace.recording():
        with trace.phase("plan.prepare", fn="outer"):
            with trace.phase("plan.prepare", fn="inner"):
                with trace.phase("plan.shuffle"):
                    time.sleep(0.05)
    wall = time.perf_counter() - t0
    c = trace.counters()
    assert set(c) == {"plan.prepare.seconds", "plan.shuffle.seconds"}
    # counted twice, the nested phase would add a second 0.05 s
    assert 0.05 <= c["plan.shuffle.seconds"] <= c["plan.prepare.seconds"] \
        <= wall
    assert [(s.name, s.attrs) for s in trace.spans()] == [
        ("plan.prepare", {"fn": "outer"}), ("plan.shuffle", {})]


@pytest.mark.parametrize("tiled", [False, True])
def test_the_tiled_order_and_wrapper_spans(tiled):
    r = _ratings()
    prepare = P.prepare_mxu_tiled if tiled else P.prepare_mxu_data
    kw = dict(slab_blocks=1) if tiled else dict(chunk=128)
    plan = prepare(r.users, r.items, r.values, r.num_users, r.num_items,
                   item_block=64, **kw)
    fe = P.fused_width(8)
    W = torch.zeros(plan.u_pad, fe)
    H = torch.zeros(plan.i_pad, fe)
    rates = torch.zeros(fe, 4)
    wrapper = SE.sgd_epoch_tiled if tiled else SE.sgd_epoch
    extra = dict(slab_blocks=plan.slab_blocks) if tiled else {}
    with trace.recording():
        with trace.span("step.iterate"):
            order = plan.epoch_order(7)
            wrapper(W, H, plan.packed, order, (3.0, 1.0, 4.0), rates,
                    user_block=plan.user_block, item_block=plan.item_block,
                    loss=0, biased=True, **extra)
    names = [s.name for s in trace.spans()]
    assert names == ["step.iterate", "step.order", "copy.order",
                     "kernel." + wrapper.__name__]
    by_id = {s.id: s for s in trace.spans()}
    assert all(by_id[s.parent].name == "step.iterate"
               for s in trace.spans()[1:])


@pytest.mark.parametrize("family", ["rating", "triple"])
def test_counters_hold_only_the_plan_phases(family):
    """An epoch adds to no counter: two epochs leave the counters of the
    plan's phases as the first left them."""
    model = _model(family)
    model.iterate()
    first = trace.counters()
    phases = PLAN_PHASES | {"plan.prepare", "plan.membership"}
    assert first and set(first) <= {p + ".seconds" for p in phases}
    with trace.recording():
        model.iterate()
        model.iterate()
    assert trace.counters() == first


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["rating", "triple"])
def test_traced_epochs_on_the_card(family):
    """Two traced epochs on the card: a ``kernel.<wrapper>`` span per
    launch, the MF segment tables built once, and the device's busy
    union in ``cfbench.trace.reduce`` the same with the ``mml.*`` ranges
    as without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfbench import trace as bench_trace
    model = _model(family, "cuda")
    wrapper = SE.sgd_epoch if family == "rating" else BE.bpr_epoch
    launches = wrapper.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(bench_trace.WINDOW):
            model.iterate()
            model.iterate()
            torch.cuda.synchronize()
    spans = trace.spans()
    kernels = [s for s in spans if s.name == "kernel." + wrapper.__name__]
    assert len(kernels) == wrapper.launches - launches == 2
    if family == "rating":
        # the segment tables are built once, at the first epoch
        segs = [s for s in spans if s.name == "kernel.segments"]
        assert [s.epoch for s in segs] == [kernels[0].epoch]
    events = list(prof.profiler.kineto_results.events())
    ours = {id(e) for e in events if e.name().startswith("mml.")}
    assert ours
    with_ranges = bench_trace.reduce(events)
    without = bench_trace.reduce([e for e in events if id(e) not in ours])
    assert with_ranges["busy_s"] > 0
    assert with_ranges["busy_s"] == without["busy_s"]
    assert np.isclose(with_ranges["window_s"], without["window_s"])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["rating", "triple"])
def test_chip_smokes_busy_sum_leaves_out_the_ranges(family):
    """``chip_smoke.py profiled_busy`` sums the self device time of
    ``key_averages()`` under a profiler of the device alone, as here: the
    ``mml.*`` ranges of a traced epoch add nothing to its sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    model = _model(family, "cuda")
    model.iterate()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.iterate()
        torch.cuda.synchronize()
    assert [s.name for s in trace.spans() if s.parent is None] == \
        ["step.iterate"]
    rows = prof.key_averages()
    busy, ops = smoke.device_busy(rows)
    assert busy > 0 and ops > 0
    assert (busy, ops) == smoke.device_busy(
        [r for r in rows if not r.key.startswith("mml.")])
