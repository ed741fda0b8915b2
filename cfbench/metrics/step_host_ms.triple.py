"""The host's own time in a BPR epoch: ``step_host_ms.rating``'s
arithmetic (``_steps.py``) over the BPR cells' ``step.iterate`` spans.
This is host time, not the card's idle: the random bits launched in
``step.bits`` keep the card busy into the host's ``step.order``, so the
card idles for less than this."""

from cfbench.metrics import _steps

LAYER = "model step"
UNIT = "ms"
MOVES = "triple_updates_per_s"


def read(ctx):
    return _steps.median_ms(ctx, "triple", 0)
