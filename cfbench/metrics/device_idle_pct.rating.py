"""The share of the traced window of a rating cell in which the card ran
no kernel, copy or set."""

from cfbench import shares

LAYER = "device"
UNIT = "%"
MOVES = "rating_updates_per_s"


def read(ctx):
    return shares.idle(ctx, "rating")
