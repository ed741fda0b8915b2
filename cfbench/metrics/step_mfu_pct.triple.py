"""The BPR epoch's share of the card's float32 peak (67 TFLOP/s):
``counts/triple.py`` operations of the completed epochs over the traced
window's host time."""

from cfbench import shares

LAYER = "model step"
UNIT = "%"
MOVES = "triple_updates_per_s"


def read(ctx):
    return shares.step_mfu(ctx, "triple")
