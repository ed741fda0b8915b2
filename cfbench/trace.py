"""Reduction of one ``torch.profiler`` session over the measured window
to the device's busy time, idle gaps and the kernels launched inside
named host ranges.

Kernels are attributed to a host range (``record_function``) by the
correlation between a launch call on the host, made inside the range,
and the device activity it started: a renamed kernel still counts.
"""

from __future__ import annotations

import collections

WINDOW = "cfbench.window"
EPOCH = "cfbench.epoch"
WRAPPER = "cfbench.epoch_kernels"


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _longest_run(seen: set, n: int):
    """(first, last) of the longest run of consecutive indices of
    range(n) that are all in ``seen``."""
    best, k = (0, -1), 0
    while k < n:
        if k not in seen:
            k += 1
            continue
        j = k
        while j + 1 < n and j + 1 in seen:
            j += 1
        if j - k > best[1] - best[0]:
            best = (k, j)
        k = j + 1
    return best


def reduce(events) -> dict:
    """``events``: the profiler's kineto events. Returns window_s,
    busy_s (device operations' union inside the window), the device
    seconds of the operations launched inside ``WRAPPER`` ranges, and
    the breakdown's two lists.

    Where the profiler dropped the device records of some wrapper range
    (one an epoch), the busy time of the window would read short: the
    window is then narrowed to the longest run of ranges whose records
    are whole, from the first device operation launched in the first of
    them to the end of the last one launched in the last (``narrowed``
    True)."""
    host, device = [], []
    for e in events:
        is_dev = "cuda" in str(e.device_type()).lower()
        (device if is_dev else host).append(e)
    win = [(e.start_ns(), e.end_ns()) for e in host if e.name() == WINDOW]
    if not win:
        raise RuntimeError(f"trace: no {WINDOW} range")
    w0, w1 = win[0]
    ops = [e for e in device if not e.is_user_annotation()
           and e.name() not in (WINDOW, EPOCH, WRAPPER)]

    # operations launched inside the wrapper ranges, by correlation id;
    # the ranges (one an epoch) whose launches left a device record
    ranges = sorted((e.start_ns(), e.end_ns()) for e in host
                    if e.name() == WRAPPER)
    range_of = {}
    for e in host:
        if e.name().startswith("cu"):
            for k, (s, t) in enumerate(ranges):
                if s <= e.start_ns() <= t:
                    range_of[e.correlation_id()] = k
    wrapped, ops_of = [], collections.defaultdict(list)
    for e in ops:
        k = range_of.get(e.correlation_id(),
                         range_of.get(e.linked_correlation_id()))
        if k is not None:
            wrapped.append(e)
            ops_of[k].append(e)
    wrapped_ns = sum(e.duration_ns() for e in wrapped)
    if ops and ranges and not ops_of:
        raise RuntimeError("trace: no device record of any epoch")
    narrowed = 0 < len(ops_of) < len(ranges)
    if narrowed:
        a, b = _longest_run(set(ops_of), len(ranges))
        w0 = min(e.start_ns() for e in ops_of[a])
        w1 = max(e.end_ns() for e in ops_of[b])

    spans = [(max(e.start_ns(), w0), min(e.end_ns(), w1)) for e in ops]
    busy = _union([(s, e) for s, e in spans if e > s])
    busy_ns = sum(e - s for s, e in busy)
    by_name = collections.Counter()
    for e in ops:
        by_name[e.name()[:200]] += e.duration_ns()
    gaps = collections.Counter()
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            mid = (s + prev) // 2
            inner = [h for h in host if h.start_ns() <= mid <= h.end_ns()
                     and h.name() != WINDOW]
            name = min(inner, key=lambda h: h.duration_ns()).name() \
                if inner else "(no host range)"
            gaps[name[:200]] += s - prev
        prev = max(prev, e)
    return dict(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
        wrapped_s=wrapped_ns / 1e9, wrapped_ops=len(wrapped),
        wrapped_ranges=len(ranges), wrapped_epochs=len(ops_of),
        narrowed=narrowed,
        device_ops=[[n, t / 1e9] for n, t in by_name.most_common(10)],
        idle_gaps=[[n, t / 1e9] for n, t in gaps.most_common(10)])
