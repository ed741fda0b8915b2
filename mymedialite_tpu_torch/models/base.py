"""Recommender base classes of the port.

The same interfaces as ``mymedialite_tpu/models/base.py`` (reference
``IRecommender.cs:33-82``, ``RatingPrediction/RatingPredictor.cs:26-52``,
``IIterativeModel.cs``, ``ItemRecommendation/ItemRecommender.cs``):
``predict_batch`` over pairs is the primitive, ``pair_scorer`` and
``catalog_scorer`` hand the evaluators scorers on device tensors on the
device that ``tables_device`` names, ``score_catalog`` and ``recommend``
(reference ``Recommender.cs:52-103``) serve from them, ``train``,
``save_model`` and ``load_model``. The incremental APIs
(``add_ratings`` / ``add_feedback``, ``_retrain``, ``retrain_user``) and
fold-in are not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from mymedialite_tpu_torch.utils.params import echo

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

    def catalog_scorer(self):
        """Optional scorer ``fn(users) -> [len(users), num_items_trained]``
        float32 scores, users an int64 tensor on the model's device, so
        that the ranking evaluator scores and ranks on the device. None =
        host scoring only (``score_catalog``)."""
        return None

    def tables_device(self) -> torch.device:
        """The device the model's tables live on, where its scorers take
        their tensors; the CPU for models that keep none (MostPopular)."""
        return torch.device("cpu")

    def score_catalog(self, users) -> np.ndarray:
        """[len(users), num_items_trained] float32 scores (numpy).
        Default: ``predict_batch`` over the catalog, one user at a time;
        models with a ``catalog_scorer`` override it with
        ``_scores_from_scorer``."""
        users = np.asarray(users, dtype=np.int32)
        n_items = self.num_items_trained
        out = np.empty((users.size, n_items), dtype=np.float32)
        all_items = np.arange(n_items, dtype=np.int32)
        for r, u in enumerate(users):
            out[r] = self.predict_batch(np.full(n_items, u, dtype=np.int32),
                                        all_items)
        return out

    def _scores_from_scorer(self, users) -> np.ndarray:
        """``score_catalog`` through the model's ``catalog_scorer``."""
        scorer = self.catalog_scorer()
        u = torch.from_numpy(np.asarray(users, dtype=np.int64)).to(
            self.tables_device())
        with torch.no_grad():
            return scorer(u).cpu().numpy()

    def recommend(self, user_id: int, n: int = -1,
                  candidates: Optional[Sequence[int]] = None,
                  ignore_items: Optional[Sequence[int]] = None):
        """Top-n (item_id, score) pairs by descending score (reference
        Recommender.Recommend, Recommender.cs:52-103): the host selection
        of the JAX package (``np.argpartition``, then a stable sort),
        which settles exact ties at the cut as it does."""
        scores = self.score_catalog(np.array([user_id], dtype=np.int32))[0]
        mask = np.zeros(scores.size, dtype=bool)
        if candidates is not None:
            cand = np.asarray(list(candidates), dtype=np.int64)
            cand = cand[(cand >= 0) & (cand < scores.size)]
            mask[:] = True
            mask[cand] = False
        if ignore_items is not None:
            ign = np.asarray(list(ignore_items), dtype=np.int64)
            ign = ign[(ign >= 0) & (ign < scores.size)]
            mask[ign] = True
        scores = np.where(mask, -np.inf, scores)
        if n < 0:
            order = np.argsort(-scores, kind="stable")
        else:
            n = min(n, scores.size)
            top = np.argpartition(-scores, n - 1)[:n] if n < scores.size \
                else np.arange(scores.size)
            order = top[np.argsort(-scores[top], kind="stable")]
        return [(int(i), float(scores[i])) for i in order
                if np.isfinite(scores[i])]

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


def pairs_catalog_scorer(pair_fn, num_items: int):
    """A ``catalog_scorer`` from a pair scorer: every (user, item) of the
    batch against the whole catalog, in one call of ``pair_fn``."""
    def score(users):
        items = torch.arange(num_items, device=users.device)
        u = users[:, None].expand(-1, num_items).reshape(-1)
        return pair_fn(u, items.repeat(users.shape[0])).reshape(
            users.shape[0], num_items)
    return score


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


class ItemRecommender(Recommender):
    """Implicit-feedback recommender (reference ItemRecommender.cs:42-55)."""

    def __init__(self):
        super().__init__()
        self._feedback = None

    @property
    def feedback(self):
        return self._feedback

    @feedback.setter
    def feedback(self, data):
        self._feedback = data
        if data is not None:
            self.num_users_trained = data.num_users
            self.num_items_trained = data.num_items


class IncrementalItemRecommender(ItemRecommender):
    """Online updates for implicit feedback (reference
    IncrementalItemRecommender.cs:29-102); not ported yet."""

    update_users = False
    update_items = False

    def add_feedback(self, users, items) -> None:
        raise NotImplementedError(f"add_feedback is {_NOT_PORTED}")

    def remove_feedback(self, users, items) -> None:
        raise NotImplementedError(f"remove_feedback is {_NOT_PORTED}")

    def remove_user(self, user_id: int) -> None:
        raise NotImplementedError(f"remove_user is {_NOT_PORTED}")

    def remove_item(self, item_id: int) -> None:
        raise NotImplementedError(f"remove_item is {_NOT_PORTED}")

    def _retrain(self, users, items) -> None:
        raise NotImplementedError(f"_retrain is {_NOT_PORTED}")


class FoldInItemRecommender:
    """Reference IFoldInItemRecommender: score candidates for an unseen
    user given the items they accessed; not ported yet."""

    def score_items_foldin(self, accessed_items, candidates):
        raise NotImplementedError(f"score_items_foldin is {_NOT_PORTED}")


class IterativeModel:
    """Mixin: models trained by repeated ``iterate()`` calls — drives the
    CLI's --find-iter loop (reference IIterativeModel.cs)."""

    num_iter: int = 30

    def iterate(self) -> None:
        raise NotImplementedError

    def compute_objective(self) -> float:
        return float("nan")
