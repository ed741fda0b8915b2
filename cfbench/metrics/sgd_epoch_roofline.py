"""The rating-SGD epoch kernels' share of their roofline: an epoch's least
time (``counts/rating.py`` at ``peaks.json``) over the device time of the
operations launched inside the port's ``sgd_epoch`` /
``sgd_epoch_tiled`` wrappers, per epoch."""

from cfbench import shares

LAYER = "epoch kernels"
UNIT = "%"
MOVES = "rating_updates_per_s"


def read(ctx):
    return shares.roofline(ctx, "rating")
