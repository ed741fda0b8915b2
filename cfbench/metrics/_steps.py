"""The arithmetic of the four step readers (``step_host_ms.*``,
``step_wait_ms.*``) over the port's spans
(``mymedialite_tpu_torch/trace.py``). No ``per_layer`` entry names this
file: it is no metric."""

import statistics


def _covered(intervals, lo, hi) -> int:
    """Nanoseconds of [lo, hi) that the union of ``intervals`` covers."""
    total, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def split(spans) -> list:
    """(host ns, wait ns) of each whole ``step.iterate`` root of
    ``spans``: its time outside its ``copy.*`` and ``kernel.*``
    descendants, and its time inside its ``copy.*`` ones."""
    whole = [s for s in spans if s.end is not None]
    of_epoch = {}
    for s in whole:
        of_epoch.setdefault(s.epoch, []).append(s)
    out = []
    for root in whole:
        if root.name != "step.iterate" or root.parent is not None:
            continue
        kids = [k for k in of_epoch[root.epoch] if k is not root]
        copies = [(k.start, k.end) for k in kids
                  if k.name.startswith("copy.")]
        kernels = [(k.start, k.end) for k in kids
                   if k.name.startswith("kernel.")]
        length = root.end - root.start
        out.append((length - _covered(copies + kernels, root.start,
                                      root.end),
                    _covered(copies, root.start, root.end)))
    return out


def median_ms(ctx, family, which):
    """The median over the window's epochs of their host (``which`` 0)
    or wait (1) time, in ms; None for another family or no spans."""
    if ctx["family"] != family:
        return None
    try:
        from mymedialite_tpu_torch import trace
    except ImportError:
        return None
    parts = split(trace.spans())
    if not parts:
        return None
    return statistics.median(p[which] for p in parts) / 1e6
