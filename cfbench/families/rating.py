"""Rating prediction by matrix factorisation: the port's
``BiasedMatrixFactorization`` through ``create_rating_predictor``."""

from __future__ import annotations

import numpy as np

# the end-to-end rate this family's cells report: (name, unit)
RATE = ("rating_updates_per_s", "ratings/s")
# the plan functions the model calls, timed from outside (plan_s); nested
# calls count once
PLAN_FUNCTIONS = (("mymedialite_tpu_torch.ops.plan", "prepare_mxu_data"),
                 ("mymedialite_tpu_torch.ops.plan", "prepare_mxu_tiled"))
# the epoch wrappers as the model module binds them, each run inside a
# record_function range in a traced run; their launch counters
EPOCH_WRAPPERS = (("mymedialite_tpu_torch.models.mf", "sgd_epoch"),
                  ("mymedialite_tpu_torch.models.mf", "sgd_epoch_tiled"))


def build(config: dict, log: dict, seed: int, device: str):
    """The configured model on the log, seeded with ``seed``."""
    from mymedialite_tpu_torch.data.arrays import RatingData
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    opts = " ".join(f"{k}={v}" for k, v in
                    config["hyperparameters"].items())
    model = create_rating_predictor(config["model"], f"{opts} device={device}")
    model.random_seed = int(seed)
    model.ratings = RatingData(
        log["users"].astype(np.int32), log["items"].astype(np.int32),
        log["values"], num_users=log["num_users"],
        num_items=log["num_items"])
    return model


def leaves(model) -> dict:
    """Copies of the trained leaves, read through the public tables."""
    W, H = model.W_ext, model.H_ext
    U, k = model.num_users_trained, model.num_factors
    return dict(user_factors=W[:U, :k].clone(), user_bias=W[:U, k].clone(),
                item_factors=H[:, :k].clone(),
                item_bias=H[:, k + 1].clone())


def state(model):
    """The tensors that ``iterate`` carries from one epoch to the next:
    the kernel-layout tables."""
    return model._mxu_tables


def leaves_of(model, tables) -> dict:
    """``leaves`` of a copy of ``state``, through the model's own write-
    back of its kernel-layout tables (which spends its current state)."""
    model._mxu_tables = tuple(tables)
    return leaves(model)
