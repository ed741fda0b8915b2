"""The share of the traced window of a BPR cell in which the card ran no
kernel, copy or set."""

from cfbench import shares

LAYER = "device"
UNIT = "%"
MOVES = "triple_updates_per_s"


def read(ctx):
    return shares.idle(ctx, "triple")
