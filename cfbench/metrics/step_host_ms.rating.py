"""The host's own time in a rating epoch: the median, over the traced
window's epochs, of each ``step.iterate`` span of the port less the part
its ``copy.*`` and ``kernel.*`` descendants cover (the program's spans,
``mymedialite_tpu_torch/trace.py``; the arithmetic in ``_steps.py``).
In the rating cells the host queues next to no device work in that
time, so the card waits behind it once the previous epoch is done. None
where the port records no spans."""

from cfbench.metrics import _steps

LAYER = "model step"
UNIT = "ms"
MOVES = "rating_updates_per_s"


def read(ctx):
    return _steps.median_ms(ctx, "rating", 0)
