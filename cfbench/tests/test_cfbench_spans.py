"""The readers of the port's spans and counters: the step's host and
wait time from hand-built span lists, the plan's phase counters, and
None for another family or where the port records nothing."""

from types import SimpleNamespace

import pytest

from cfbench import harness as hz
from cfbench.metrics import _steps

STEP_READERS = ("step_host_ms.rating", "step_host_ms.triple",
                "step_wait_ms.rating", "step_wait_ms.triple")
MS = 1_000_000


def sp(id_, name, start, end, parent=None, epoch=None):
    """A span as ``trace.spans()`` gives it, times in ms."""
    return SimpleNamespace(id=id_, name=name, start=start * MS,
                           end=None if end is None else end * MS,
                           parent=parent, epoch=epoch or id_, attrs={})


def epochs():
    """Three epochs of a BPR step (ms): host (outside copies and
    kernels) 4, 7 and 10; waits 80, 90 and 100. The second's copies
    overlap each other and a kernel span nests one of its own."""
    return [
        sp(1, "step.iterate", 0, 100),
        sp(2, "copy.rates", 1, 81, 1, 1),
        sp(3, "step.order", 81, 84, 2, 1),
        sp(4, "kernel.bpr_epoch", 84, 100, 1, 1),
        sp(10, "step.iterate", 200, 320),
        sp(11, "copy.rates", 201, 261, 10, 10),
        sp(12, "copy.order", 241, 291, 10, 10),
        sp(13, "step.bits", 291, 297, 10, 10),
        sp(14, "kernel.bpr_epoch", 297, 320, 10, 10),
        sp(15, "kernel.segments", 300, 310, 14, 10),
        sp(20, "step.iterate", 400, 600),
        sp(21, "copy.rates", 401, 501, 20, 20),
        sp(22, "step.negatives", 501, 510, 20, 20),
        sp(23, "kernel.bpr_epoch", 510, 600, 20, 20),
    ]


@pytest.fixture
def spans(monkeypatch):
    """Sets what ``trace.spans()`` returns."""
    from mymedialite_tpu_torch import trace

    def give(lst):
        monkeypatch.setattr(trace, "spans", lambda: list(lst))
    return give


def read(metric, family):
    return hz.metric_reader(metric).read({"family": family})


def test_the_step_split_of_each_epoch():
    split = _steps.split(epochs())
    assert [(h / MS, w / MS) for h, w in split] == \
        [(4, 80), (7, 90), (10, 100)]


@pytest.mark.parametrize("metric, value", [
    ("step_host_ms.triple", 7.0), ("step_wait_ms.triple", 90.0)])
def test_the_step_medians(spans, metric, value):
    spans(epochs())
    assert read(metric, "triple") == pytest.approx(value)
    other = metric.replace("triple", "rating")
    assert read(other, "triple") is None
    assert read(other, "rating") == pytest.approx(value)


def test_unfinished_and_nested_steps_are_not_epochs(spans):
    lst = epochs()[:4] + [sp(30, "step.iterate", 700, None),
                          sp(31, "step.iterate", 710, 720, 30, 30)]
    spans(lst)
    assert read("step_host_ms.triple", "triple") == pytest.approx(4.0)


@pytest.mark.parametrize("metric", STEP_READERS)
def test_no_spans_read_none(spans, metric):
    spans([])
    assert read(metric, metric.rsplit(".", 1)[1]) is None


@pytest.mark.parametrize("metric", STEP_READERS + (
    "plan_bucketize_s", "plan_membership_s"))
def test_a_program_without_the_trace_module_reads_none(monkeypatch,
                                                       metric):
    import sys
    monkeypatch.setitem(sys.modules, "mymedialite_tpu_torch.trace", None)
    assert read(metric, "triple") is None
    assert read(metric, "rating") is None


def test_the_plan_counters(monkeypatch):
    from mymedialite_tpu_torch import trace
    c = {"plan.bucketize.seconds": 2.5, "plan.membership.seconds": 7.25}
    monkeypatch.setattr(trace, "counters", lambda: dict(c))
    assert read("plan_bucketize_s", "rating") == 2.5
    assert read("plan_bucketize_s", "triple") == 2.5
    assert read("plan_membership_s", "triple") == 7.25
    assert read("plan_membership_s", "rating") is None
    c.clear()
    assert read("plan_bucketize_s", "rating") is None
    assert read("plan_membership_s", "triple") is None
