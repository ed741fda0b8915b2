"""Shares that the per-layer readers of several families compute alike."""


def step_mfu(ctx, family):
    """Percent of the float32 peak that the window's epochs reach: the
    useful operations of the epochs completed over the window's host
    time."""
    if ctx["family"] != family or ctx["peaks"] is None or not ctx["epochs"]:
        return None
    ops = ctx["work"]["ops"] * ctx["epochs"]
    return 100.0 * ops / (ctx["host_window_s"]
                          * ctx["peaks"]["fp32_flops_per_s"])


def roofline(ctx, family):
    """Percent of the least time an epoch needs (bytes or operations at
    the published peaks) in the device time of the operations launched
    inside the epoch wrappers, per epoch: over the epochs whose launches
    left device records in the trace (a record the profiler drops takes
    its epoch out of both sides)."""
    if ctx["family"] != family or ctx["least"] is None \
            or not ctx["wrapped_s"] or not ctx["traced_epochs"]:
        return None
    return 100.0 * ctx["least"][0] * ctx["traced_epochs"] / ctx["wrapped_s"]


def idle(ctx, family):
    """Percent of the traced window in which no kernel, copy or set ran
    on the device (narrowed to whole records where the profiler dropped
    some: ``trace.reduce``)."""
    if ctx["family"] != family or not ctx["window_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
