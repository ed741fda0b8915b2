"""The host blocked on the card in a BPR epoch: ``step_wait_ms.rating``'s
arithmetic (``_steps.py``) over the BPR cells' ``step.iterate`` spans."""

from cfbench.metrics import _steps

LAYER = "model step"
UNIT = "ms"
MOVES = "triple_updates_per_s"


def read(ctx):
    return _steps.median_ms(ctx, "triple", 1)
