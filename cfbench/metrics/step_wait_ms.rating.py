"""The host blocked on the card in a rating epoch: the median, over the
traced window's epochs, of the time inside the ``copy.*`` spans of each
``step.iterate`` span of the port (a copy through pageable memory waits
for the stream; the arithmetic in ``_steps.py``). None where the port
records no spans."""

from cfbench.metrics import _steps

LAYER = "model step"
UNIT = "ms"
MOVES = "rating_updates_per_s"


def read(ctx):
    return _steps.median_ms(ctx, "rating", 1)
