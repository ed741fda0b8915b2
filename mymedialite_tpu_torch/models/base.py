"""Recommender base classes of the port.

The same interfaces as ``mymedialite_tpu/models/base.py`` (reference
``IRecommender.cs:33-82``, ``RatingPrediction/RatingPredictor.cs:26-52``,
``IIterativeModel.cs``): ``predict_batch`` over rating pairs is the
primitive, ``pair_scorer`` hands the evaluator a scorer on device
tensors, ``train``, ``save_model`` and ``load_model``. The incremental
API (``add_ratings``, ``_retrain``, ``retrain_user``) is not ported yet
and raises.
"""

from __future__ import annotations

import numpy as np
from torch import nn

from mymedialite_tpu.utils.params import echo

_NOT_PORTED = "not yet ported to mymedialite_tpu_torch"


class Recommender(nn.Module):
    """Root of the recommender hierarchy. An ``nn.Module`` so that the
    model tables are buffers; ``train()`` is the recommender's training
    (reference IRecommender.Train), not the module's train/eval switch,
    which no model of the port uses."""

    HYPERPARAMS: dict = {}
    num_users_trained: int = 0
    num_items_trained: int = 0

    def __init__(self):
        nn.Module.__init__(self)

    def predict(self, user_id: int, item_id: int) -> float:
        return float(self.predict_batch(np.array([user_id], dtype=np.int32),
                                        np.array([item_id], dtype=np.int32))[0])

    def predict_batch(self, users: np.ndarray, items: np.ndarray) -> np.ndarray:
        """Vectorized point predictions (numpy in, float32 numpy out)."""
        raise NotImplementedError

    def pair_scorer(self):
        """Optional scorer ``fn(users, items) -> predictions`` on int64
        tensors on the model's device, so that the evaluator predicts and
        reduces without leaving the device. None = host scoring only."""
        return None

    def can_predict(self, user_id: int, item_id: int) -> bool:
        return (0 <= user_id < self.num_users_trained
                and 0 <= item_id < self.num_items_trained)

    def train(self) -> None:
        raise NotImplementedError

    def save_model(self, path: str) -> None:
        raise NotImplementedError(f"{type(self).__name__} does not support saving")

    def load_model(self, path: str) -> None:
        raise NotImplementedError(f"{type(self).__name__} does not support loading")

    def __str__(self) -> str:
        return echo(self)

    __repr__ = __str__


class RatingPredictor(Recommender):
    """Explicit-feedback recommender (reference RatingPredictor.cs:26-52)."""

    def __init__(self):
        super().__init__()
        self._ratings = None
        self.min_rating = 0.0
        self.max_rating = 5.0

    @property
    def ratings(self):
        return self._ratings

    @ratings.setter
    def ratings(self, data):
        self._ratings = data
        if data is not None:
            self.min_rating = data.scale.min
            self.max_rating = data.scale.max
            self.num_users_trained = data.num_users
            self.num_items_trained = data.num_items

    # incremental updates (reference IncrementalRatingPredictor.cs:24-108)

    def add_ratings(self, users, items, values) -> None:
        raise NotImplementedError(f"add_ratings is {_NOT_PORTED}")

    def update_ratings(self, users, items, values) -> None:
        raise NotImplementedError(f"update_ratings is {_NOT_PORTED}")

    def remove_ratings(self, users, items) -> None:
        raise NotImplementedError(f"remove_ratings is {_NOT_PORTED}")

    def _retrain(self, users, items) -> None:
        raise NotImplementedError(f"_retrain is {_NOT_PORTED}")


class IterativeModel:
    """Mixin: models trained by repeated ``iterate()`` calls — drives the
    CLI's --find-iter loop (reference IIterativeModel.cs)."""

    num_iter: int = 30

    def iterate(self) -> None:
        raise NotImplementedError

    def compute_objective(self) -> float:
        return float("nan")
