"""Recommender base classes of the port.

The same interfaces as ``mymedialite_tpu/models/base.py`` (reference
``IRecommender.cs:33-82``, ``RatingPrediction/RatingPredictor.cs:26-52``,
``IIterativeModel.cs``, ``ItemRecommendation/ItemRecommender.cs``):
``predict_batch`` over pairs is the primitive, ``pair_scorer`` and
``catalog_scorer`` hand the evaluators scorers on device tensors on the
device that ``tables_device`` names, ``score_catalog`` and ``recommend``
(reference ``Recommender.cs:52-103``) serve from them, ``train``,
``save_model`` and ``load_model``; the incremental updates
(``IncrementalRatingPredictor``: ``add_ratings`` and the buffered
prequential mode of ``eval/online.py``; ``IncrementalItemRecommender``:
``add_feedback``; reference ``IncrementalRatingPredictor.cs:24-108``,
``IncrementalItemRecommender.cs:29-102``) and the fold-in interfaces.
As in the JAX package, only the incremental classes have
``add_ratings`` / ``add_feedback``: the online evaluators test for
them with ``hasattr``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from mymedialite_tpu_torch.utils.params import echo


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

    def catalog_scorer(self, device=None):
        """Optional scorer ``fn(users) -> [len(users), num_items_trained]``
        float32 scores, users an int64 tensor on the model's device (or
        on ``device``, the data-parallel ranking eval's replica), so
        that the ranking evaluator scores and ranks on the device. None =
        host scoring only (``score_catalog``)."""
        return None

    def _on_device(self, scorer, device):
        """``scorer`` for users on ``device``: where that is not the
        tables' device, users move there and scores back (models with a
        mesh route build their replicas on copies of their tables
        instead)."""
        home = self.tables_device()
        if scorer is None or device is None or torch.device(device) == home:
            return scorer
        return lambda users: scorer(users.to(home)).to(device)

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


class IncrementalRatingPredictor(RatingPredictor):
    """Online updates for explicit feedback (reference
    IncrementalRatingPredictor.cs:24-108; JAX ``models/base.py:171-306``).
    ``add_ratings`` and its siblings change ``ratings`` and call the
    model's ``_retrain`` on the touched ids."""

    # Models whose _retrain reads per-entity histories through
    # _rated_by_user/_rated_by_item (rather than self.ratings directly)
    # run prequential eval in buffered mode: events append to host
    # buffers and fold into the immutable dataset once at the end.
    SUPPORTS_ONLINE_BUFFER = False
    # Prediction for (u, i) reads only u's and i's rows: the online
    # evaluator batches predictions between touched-row collisions.
    ONLINE_PREDICT_ROW_LOCAL = False

    def __init__(self):
        super().__init__()
        self.update_users = True
        self.update_items = True
        self._online_active = False

    def begin_online_updates(self) -> bool:
        """Enter buffered prequential-update mode (``eval/online.py``);
        False (and the per-event path) for models whose ``_retrain``
        reads the whole dataset."""
        if not self.SUPPORTS_ONLINE_BUFFER:
            return False
        self._online_user_hist = {}
        self._online_item_hist = {}
        self._online_events = ([], [], [])
        self._online_active = True
        return True

    def end_online_updates(self) -> None:
        """Fold the buffered events into the dataset (one array rebuild)."""
        if not self._online_active:
            return
        self._online_active = False
        ue, ie, ve = self._online_events
        if ue:
            self.ratings = self.ratings.add(ue, ie, ve)
        self._online_user_hist = None
        self._online_item_hist = None
        self._online_events = None
        self._online_flush()

    def _online_flush(self) -> None:
        """Hook: drop the epoch state built on the dataset before the
        buffered events folded in."""

    def _history(self, csr, other, k: int, buffers):
        data = self.ratings
        if 0 <= k < csr.indptr.size - 1:
            idx = csr.segment(k)
            ids, vals = other[idx], data.values[idx]
        else:
            ids = np.array([], dtype=np.int32)
            vals = np.array([], dtype=np.float32)
        if self._online_active:
            hist = buffers.get(k)
            if hist:
                ids = np.concatenate([ids, np.asarray(hist[0], np.int32)])
                vals = np.concatenate([vals, np.asarray(hist[1],
                                                        np.float32)])
        return ids, vals

    def _rated_by_user(self, u: int):
        """(items, values) rated by u: the dataset plus any buffered
        online events (reference DataSet.ByUser)."""
        data = self.ratings
        return self._history(data.by_user, data.items, u,
                             getattr(self, "_online_user_hist", None))

    def _rated_by_item(self, i: int):
        """(users, values) who rated i: the dataset plus buffered events."""
        data = self.ratings
        return self._history(data.by_item, data.users, i,
                             getattr(self, "_online_item_hist", None))

    def add_ratings(self, users, items, values) -> None:
        if self._online_active:
            ue, ie, ve = self._online_events
            for u, i, v in zip(users, items, values):
                u, i, v = int(u), int(i), float(v)
                ue.append(u)
                ie.append(i)
                ve.append(v)
                uh = self._online_user_hist.setdefault(u, ([], []))
                uh[0].append(i)
                uh[1].append(v)
                ih = self._online_item_hist.setdefault(i, ([], []))
                ih[0].append(u)
                ih[1].append(v)
            self._retrain(users, items)
            return
        self.ratings = self.ratings.add(users, items, values)
        self._retrain(users, items)

    def update_ratings(self, users, items, values) -> None:
        self.ratings = self.ratings.update(users, items, values)
        self._retrain(users, items)

    def remove_ratings(self, users, items) -> None:
        data = self.ratings
        keep = np.ones(len(data), dtype=bool)
        for u, i in zip(users, items):
            seg = data.by_user.segment(u)
            keep[seg[data.items[seg] == i]] = False
        self.ratings = data.remove_indices(np.flatnonzero(~keep))
        self._retrain(users, items)

    def add_user(self, user_id: int) -> None:
        self.num_users_trained = max(self.num_users_trained, user_id + 1)

    def add_item(self, item_id: int) -> None:
        self.num_items_trained = max(self.num_items_trained, item_id + 1)

    def remove_user(self, user_id: int) -> None:
        self.ratings = self.ratings.remove_user(user_id)
        self._retrain([user_id], [])

    def remove_item(self, item_id: int) -> None:
        self.ratings = self.ratings.remove_item(item_id)
        self._retrain([], [item_id])

    def _retrain(self, users, items) -> None:
        """Hook: refresh per-user/per-item state after an incremental
        change (reference RetrainUser/RetrainItem)."""


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
    IncrementalItemRecommender.cs:29-102)."""

    # reference IncrementalItemRecommender.cs:32-35: the C# defaults
    # (false); models override them (BPRMF.cs:116)
    update_users = False
    update_items = False

    def add_feedback(self, users, items) -> None:
        self.feedback = self.feedback.add(users, items)
        self._retrain(users, items)

    def remove_feedback(self, users, items) -> None:
        self.feedback = self.feedback.remove(users, items)
        self._retrain(users, items)

    def remove_user(self, user_id: int) -> None:
        self.feedback = self.feedback.remove_user(user_id)
        self._retrain([user_id], [])

    def remove_item(self, item_id: int) -> None:
        self.feedback = self.feedback.remove_item(item_id)
        self._retrain([], [item_id])

    def _retrain(self, users, items) -> None:
        pass


class FoldInRatingPredictor:
    """Reference IFoldInRatingPredictor: score candidate items for an
    unseen user given (item_id, rating) pairs, without changing the
    model."""

    def score_items_foldin(self, rated_items, candidates):
        raise NotImplementedError


class FoldInItemRecommender:
    """Reference IFoldInItemRecommender: the same, given the items the
    user accessed."""

    def score_items_foldin(self, accessed_items, candidates):
        raise NotImplementedError


class IterativeModel:
    """Mixin: models trained by repeated ``iterate()`` calls — drives the
    CLI's --find-iter loop (reference IIterativeModel.cs)."""

    num_iter: int = 30

    def iterate(self) -> None:
        raise NotImplementedError

    def compute_objective(self) -> float:
        return float("nan")
