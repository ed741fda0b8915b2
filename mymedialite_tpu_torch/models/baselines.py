"""Trivial / baseline rating predictors of the port.

Counterparts of ``mymedialite_tpu/models/baselines.py`` (reference
``RatingPrediction/{GlobalAverage, UserAverage, ItemAverage,
EntityAverage, Constant, Random, UserItemBaseline}.cs``). The averages
and biases are tensors on the model's ``device`` (default ``cuda``),
summed there with ``index_add_`` / ``bincount`` in float64 as the JAX
package sums them with ``np.add.at``; ``pair_scorer`` and
``catalog_scorer`` predict on that device. ``RandomRating`` draws on the
host from ``np.random.default_rng(random_seed)`` in the JAX package's
order, so its predictions are equal, not merely alike. The model files
are the JAX package's text.

Every model is an ``IncrementalRatingPredictor``: the averages
recompute on ``_retrain`` and UserItemBaseline refreshes the touched
biases (``retrain_user`` / ``retrain_item``, JAX
``baselines.py:230-285``), summing in float64 on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from mymedialite_tpu_torch.device import resolve_device
from mymedialite_tpu_torch.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu_torch.models.base import (
    IncrementalRatingPredictor, IterativeModel, RatingPredictor,
    pairs_catalog_scorer,
)


def _f32(x) -> torch.Tensor:
    """A float32 scalar tensor (a numpy float32 operand, not a weak
    Python float)."""
    return torch.tensor(np.float32(x))


class _DeviceRatingPredictor(IncrementalRatingPredictor):
    """Shared plumbing: ``device``, predictions through ``pair_scorer``,
    catalog scores from the pair scorer over every item."""

    EXTRA_PARAMS = {"device": str}

    def __init__(self):
        super().__init__()
        self.device = "cuda"

    def tables_device(self):
        return resolve_device(self.device)

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(
            self.tables_device())

    def _predict_pairs(self, users, items):
        raise NotImplementedError

    def pair_scorer(self):
        return self._predict_pairs

    def predict_batch(self, users, items):
        dev = self.tables_device()
        u = torch.from_numpy(np.asarray(users, dtype=np.int64)).to(dev)
        i = torch.from_numpy(np.asarray(items, dtype=np.int64)).to(dev)
        with torch.no_grad():
            return self._predict_pairs(u, i).cpu().numpy()

    def catalog_scorer(self, device=None):
        return self._on_device(pairs_catalog_scorer(
            self._predict_pairs, self.num_items_trained), device)

    def score_catalog(self, users):
        return self._scores_from_scorer(users)

    def can_predict(self, user_id, item_id):
        return True


class GlobalAverage(_DeviceRatingPredictor):
    """Predicts the global rating average (reference GlobalAverage.cs)."""

    def __init__(self):
        super().__init__()
        self.global_average = 0.0

    def train(self):
        self.global_average = self.ratings.average

    def _retrain(self, users, items):
        self.global_average = self.ratings.average

    def _predict_pairs(self, users, items):
        return torch.full(users.shape, float(np.float32(self.global_average)),
                          dtype=torch.float32, device=users.device)

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.scalar(self.global_average)

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            self.global_average = r.scalar()


class _EntityAverage(_DeviceRatingPredictor):
    """Per-entity average with global-average fallback
    (reference EntityAverage.cs:25-80)."""

    ENTITY = "user"  # or "item"

    def __init__(self):
        super().__init__()
        self.entity_averages = torch.zeros(0)
        self.global_average = 0.0

    def train(self):
        data = self.ratings
        user = self.ENTITY == "user"
        n = data.num_users if user else data.num_items
        ids = self._tensor(data.users if user else data.items, torch.int64)
        values = self._tensor(data.values).double()
        sums = torch.zeros(n, dtype=torch.float64, device=ids.device)
        sums.index_add_(0, ids, values)
        counts = torch.bincount(ids, minlength=n)
        self.global_average = data.average
        self.entity_averages = torch.where(
            counts > 0, sums / counts.clamp(min=1).double(),
            torch.tensor(self.global_average, dtype=torch.float64)
        ).float()

    def _retrain(self, users, items):
        self.train()

    def _predict_pairs(self, users, items):
        ids = users if self.ENTITY == "user" else items
        avg = self.entity_averages
        n = avg.shape[0]
        ok = (ids >= 0) & (ids < n)
        if n == 0:
            picked = torch.zeros(ids.shape, dtype=torch.float32,
                                 device=ids.device)
        else:
            picked = avg[ids.clamp(0, n - 1)]
        return torch.where(ok, picked, _f32(self.global_average).to(
            ids.device))

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.scalar(self.global_average)
            w.vector(self.entity_averages.cpu().numpy())

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            self.global_average = r.scalar()
            self.entity_averages = self._tensor(r.vector())


class UserAverage(_EntityAverage):
    """Reference UserAverage.cs."""
    ENTITY = "user"


class ItemAverage(_EntityAverage):
    """Reference ItemAverage.cs."""
    ENTITY = "item"


class Constant(_DeviceRatingPredictor):
    """Always predicts a constant (reference Constant.cs; default 1.0)."""

    HYPERPARAMS = {"constant_rating": float}

    def __init__(self):
        super().__init__()
        self.constant_rating = 1.0

    def train(self):
        pass

    def _predict_pairs(self, users, items):
        return torch.full(users.shape, float(np.float32(self.constant_rating)),
                          dtype=torch.float32, device=users.device)

    def save_model(self, path):
        pass

    def load_model(self, path):
        pass


class RandomRating(_DeviceRatingPredictor):
    """Uniform random predictions on the rating scale (reference
    RatingPrediction/Random.cs). The draws come from the host generator
    in call order, as in the JAX package: no pair or catalog scorer, so
    the evaluators call ``predict_batch`` as the JAX ones do."""

    def __init__(self):
        super().__init__()
        self.random_seed = 42
        self._rng = np.random.default_rng(42)

    def train(self):
        self._rng = np.random.default_rng(self.random_seed)

    def pair_scorer(self):
        return None

    def catalog_scorer(self, device=None):
        return None

    def predict_batch(self, users, items):
        n = np.asarray(users).shape
        return (self.min_rating + self._rng.random(n) *
                (self.max_rating - self.min_rating)).astype(np.float32)

    def score_catalog(self, users):
        return RatingPredictor.score_catalog(self, users)

    def save_model(self, path):
        pass

    def load_model(self, path):
        pass


class UserItemBaseline(_DeviceRatingPredictor, IterativeModel):
    """Koren's mu + b_u + b_i baseline, alternating closed-form updates with
    regularization (reference UserItemBaseline.cs:28-140; RegU=15, RegI=10,
    NumIter=10). Each half-step is one ``index_add_`` of the residuals
    in float64 on the model's device."""

    HYPERPARAMS = {"reg_u": float, "reg_i": float, "num_iter": int}

    # prediction reads only (b_u, b_i); the retrains read the histories
    # through _rated_by_*: buffered prequential mode works
    SUPPORTS_ONLINE_BUFFER = True
    ONLINE_PREDICT_ROW_LOCAL = True

    def __init__(self):
        super().__init__()
        self.reg_u = 15.0
        self.reg_i = 10.0
        self.num_iter = 10
        self.global_average = 0.0
        self.user_biases = torch.zeros(0)
        self.item_biases = torch.zeros(0)
        self._train_tensors = None

    def train(self):
        data = self.ratings
        self.global_average = data.average
        self.user_biases = self._tensor(np.zeros(data.num_users))
        self.item_biases = self._tensor(np.zeros(data.num_items))
        self._train_tensors = (self._tensor(data.users, torch.int64),
                               self._tensor(data.items, torch.int64),
                               self._tensor(data.values))
        for _ in range(self.num_iter):
            self.iterate()
        self._train_tensors = None

    def iterate(self):
        if self._train_tensors is None:
            data = self.ratings
            self._train_tensors = (self._tensor(data.users, torch.int64),
                                   self._tensor(data.items, torch.int64),
                                   self._tensor(data.values))
        users, items, values = self._train_tensors
        # order matters: items first, then users (reference Iterate :98-102)
        self.item_biases = self._optimize(items, users, self.user_biases,
                                          self.item_biases.shape[0], values,
                                          self.reg_i)
        self.user_biases = self._optimize(users, items, self.item_biases,
                                          self.user_biases.shape[0], values,
                                          self.reg_u)

    def _optimize(self, ids, other_ids, other_biases, n, values, reg):
        # float32 residuals, as numpy forms them from float32 operands
        resid = values - _f32(self.global_average).to(values.device) \
            - other_biases[other_ids]
        sums = torch.zeros(n, dtype=torch.float64, device=ids.device)
        sums.index_add_(0, ids, resid.double())
        counts = torch.bincount(ids, minlength=n)
        return torch.where(counts > 0, sums / (reg + counts.double()),
                           torch.zeros((), dtype=torch.float64,
                                       device=ids.device)).float()

    def _biases_of(self, users, items):
        bu, bi = self.user_biases, self.item_biases
        zero = torch.zeros((), dtype=torch.float32, device=users.device)

        def pick(table, ids):
            n = table.shape[0]
            if n == 0:
                return torch.zeros(ids.shape, dtype=torch.float32,
                                   device=ids.device)
            ok = (ids >= 0) & (ids < n)
            return torch.where(ok, table[ids.clamp(0, n - 1)], zero)
        return pick(bu, users), pick(bi, items)

    def _predict_pairs(self, users, items):
        bu, bi = self._biases_of(users, items)
        gavg = _f32(self.global_average).to(users.device)
        return ((gavg + bu) + bi).clamp(self.min_rating, self.max_rating)

    def catalog_scorer(self, device=None):
        bu, bi = self.user_biases, self.item_biases
        gavg = _f32(self.global_average).to(bu.device)
        lo, hi = self.min_rating, self.max_rating

        def score(users):
            u = users.clamp(0, max(bu.shape[0] - 1, 0))
            return ((gavg + bu[u][:, None]) + bi[None, :]).clamp(lo, hi)
        return self._on_device(score, device)

    def _refresh_bias(self, own, other, k, ids, vals, reg):
        """own[k] = (own[k] + sum(r - mu - other[j])) / (reg + n) over the
        history (ids, vals), the sum in float64 on the device; ids outside
        ``other`` count a zero bias."""
        if ids.size == 0:
            return
        dev = own.device
        ids = torch.from_numpy(ids.astype(np.int64)).to(dev)
        vals = torch.from_numpy(vals.astype(np.float32)).to(dev)
        n = other.shape[0]
        ok = (ids >= 0) & (ids < n)
        b = torch.where(ok, other[ids.clamp(0, max(n - 1, 0))],
                        torch.zeros((), dtype=torch.float32, device=dev)) \
            if n else torch.zeros_like(vals)
        resid = vals - _f32(self.global_average).to(dev) - b
        s = own[k].double() + resid.double().sum()
        own[k] = (s / (reg + ids.numel())).float()

    def retrain_user(self, user_id):
        """Refresh b_u from the user's history (reference
        UserItemBaseline.cs:151-160): the previous b_u joins the sum
        before the division, as in the reference."""
        if not self.update_users or not (
                0 <= user_id < self.user_biases.shape[0]):
            return
        items, vals = self._rated_by_user(user_id)
        self._refresh_bias(self.user_biases, self.item_biases, user_id,
                           items, vals, self.reg_u)

    def retrain_item(self, item_id):
        """Refresh b_i (reference UserItemBaseline.cs:163-172). Copied on
        purpose from the JAX package: the residuals subtract the user
        biases, which the C# RetrainItem does not (ROADMAP §C)."""
        if not self.update_items or not (
                0 <= item_id < self.item_biases.shape[0]):
            return
        users, vals = self._rated_by_item(item_id)
        self._refresh_bias(self.item_biases, self.user_biases, item_id,
                           users, vals, self.reg_i)

    def _grow(self, num_users, num_items):
        """Zero-extend the biases (reference AddUser / AddItem)."""
        def grow(t, n):
            if n <= t.shape[0]:
                return t
            return torch.cat([t, t.new_zeros(n - t.shape[0])])
        self.user_biases = grow(self.user_biases, num_users)
        self.item_biases = grow(self.item_biases, num_items)

    def _retrain(self, users, items):
        """The touched biases only, users first, then items (reference
        UserItemBaseline.cs:175-182). Copied on purpose from the JAX
        package: an id that occurs twice in one batch is refreshed twice,
        each time folding its previous value into the sum (ROADMAP §C)."""
        if self.user_biases.numel() == 0:
            return
        self._grow(max((int(u) for u in users), default=-1) + 1,
                   max((int(i) for i in items), default=-1) + 1)
        for u in users:
            self.retrain_user(int(u))
        for i in items:
            self.retrain_item(int(i))

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.scalar(self.global_average)
            w.vector(self.user_biases.cpu().numpy())
            w.vector(self.item_biases.cpu().numpy())

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            self.global_average = r.scalar()
            self.user_biases = self._tensor(r.vector())
            self.item_biases = self._tensor(r.vector())
        self.num_users_trained = self.user_biases.shape[0]
        self.num_items_trained = self.item_biases.shape[0]

    def load_state(self, state: dict):
        """Start from given biases ({global_average, user_biases,
        item_biases}, from ``convert.baseline_state_from_jax``)."""
        self.global_average = float(state["global_average"])
        self.user_biases = self._tensor(state["user_biases"])
        self.item_biases = self._tensor(state["item_biases"])
