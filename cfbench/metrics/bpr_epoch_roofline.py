"""The BPR epoch kernels' (sampler and walk) share of their roofline: an
epoch's least time (``counts/triple.py`` at ``peaks.json``) over the
device time of the operations launched inside the port's ``bpr_epoch``
/ ``bpr_epoch_tiled`` wrappers, per epoch."""

from cfbench import shares

LAYER = "epoch kernels"
UNIT = "%"
MOVES = "triple_updates_per_s"


def read(ctx):
    return shares.roofline(ctx, "triple")
