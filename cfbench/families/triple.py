"""Item recommendation from positive-only feedback by BPR: the port's
``BPRMF`` through ``create_item_recommender``, the log's (user, item)
pairs as the feedback."""

from __future__ import annotations

import numpy as np

RATE = ("triple_updates_per_s", "triples/s")
PLAN_FUNCTIONS = (("mymedialite_tpu_torch.ops.bpr_plan", "prepare_bpr_mxu"),
                 ("mymedialite_tpu_torch.ops.plan", "prepare_mxu_data"))
EPOCH_WRAPPERS = (("mymedialite_tpu_torch.models.bpr", "bpr_epoch"),
                  ("mymedialite_tpu_torch.models.bpr", "bpr_epoch_tiled"))


def build(config: dict, log: dict, seed: int, device: str):
    from mymedialite_tpu_torch.data.arrays import PosOnlyData
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    opts = " ".join(f"{k}={v}" for k, v in
                    config["hyperparameters"].items())
    model = create_item_recommender(config["model"], f"{opts} device={device}")
    model.random_seed = int(seed)
    model.feedback = PosOnlyData(
        log["users"].astype(np.int32), log["items"].astype(np.int32),
        num_users=log["num_users"], num_items=log["num_items"])
    return model


def leaves(model) -> dict:
    return {k: v.clone() for k, v in model.params.items()}


def state(model):
    """The tensors that ``iterate`` carries from one epoch to the next:
    the kernel-layout tables."""
    return model._mxu_tables


def leaves_of(model, tables) -> dict:
    """``leaves`` of a copy of ``state``, through the model's own write-
    back of its kernel-layout tables (which spends its current state)."""
    model._mxu_tables = tuple(tables)
    return leaves(model)
