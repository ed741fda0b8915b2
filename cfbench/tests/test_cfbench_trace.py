"""The trace's reduction: busy time, the operations launched inside the
epoch wrappers, and a window narrowed to the epochs whose device records
are whole where the profiler dropped some."""

import pytest

from cfbench import trace as tr


class Ev:
    def __init__(self, name, start, end, dev=False, corr=0):
        self._name, self._s, self._e, self._dev, self._c = \
            name, start, end, dev, corr

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


def events(drop=()):
    """A window of 4 epochs of 100 ns, each one kernel of 90 ns launched
    inside its wrapper range; the kernels of ``drop`` left out."""
    out = [Ev(tr.WINDOW, 0, 400)]
    for k in range(4):
        s = 100 * k
        out += [Ev(tr.WRAPPER, s, s + 5), Ev("cudaLaunchKernel", s + 1,
                                             s + 2, corr=k + 1)]
        if k not in drop:
            out.append(Ev("epoch_kernel", s + 5, s + 95, dev=True,
                          corr=k + 1))
    return out


def test_whole_records_keep_the_window():
    red = tr.reduce(events())
    assert not red["narrowed"]
    assert red["window_s"] == pytest.approx(400e-9)
    assert red["busy_s"] == pytest.approx(360e-9)
    assert (red["wrapped_ranges"], red["wrapped_epochs"]) == (4, 4)


@pytest.mark.parametrize("drop, span", [((0,), (105, 395)),
                                        ((2,), (5, 195)),
                                        ((0, 3), (105, 295))])
def test_a_dropped_record_narrows_the_window(drop, span):
    red = tr.reduce(events(drop))
    assert red["narrowed"]
    assert red["window_s"] == pytest.approx((span[1] - span[0]) * 1e-9)
    kept = (span[1] - span[0] + 10) // 100
    assert red["busy_s"] == pytest.approx(kept * 90e-9)
    assert red["wrapped_epochs"] == 4 - len(drop)


def test_no_record_of_any_epoch_is_an_error():
    ev = events(drop=(0, 1, 2, 3)) + [Ev("memcpy", 0, 10, dev=True)]
    with pytest.raises(RuntimeError):
        tr.reduce(ev)
