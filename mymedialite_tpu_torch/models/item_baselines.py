"""Trivial and popularity item recommenders of the port.

Counterparts of ``mymedialite_tpu/models/item_baselines.py`` (reference
``ItemRecommendation/{MostPopular, MostPopularByAttributes, Zero,
Random, BigramRules}.cs``). ``MostPopular`` (the item CLI's default),
``Zero``, ``RandomItem`` and ``MostPopularByAttributes`` count and score
on the host in numpy, as in the JAX package; ``RandomItem`` draws from
``np.random.default_rng(random_seed)`` in the JAX package's order, so
its scores are equal, not merely alike. ``BigramRules`` forms its item
co-occurrence counts Mᵀ·M as one float32 product on the model's
``device`` with TF32 off, so that the counts stay exact integers. The
model files are the JAX package's text.
"""

from __future__ import annotations

import numpy as np
import torch

from mymedialite_tpu_torch.device import exact_float32, resolve_device
from mymedialite_tpu_torch.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu_torch.models.base import (
    IncrementalItemRecommender, ItemRecommender,
)
from mymedialite_tpu_torch.ops.correlation import incidence_dense

# unknown users and items score float.MinValue (reference Predict)
_UNKNOWN = -np.float32(3.4e38)


class MostPopular(IncrementalItemRecommender):
    """Popularity count, optionally per-user de-duplicated (reference
    MostPopular.cs:38-120); an online update recounts."""

    HYPERPARAMS = {"by_user": bool}

    def __init__(self):
        super().__init__()
        self.by_user = False
        self.view_count = np.zeros(0, dtype=np.int64)

    def train(self):
        f = self.feedback
        if self.by_user:
            self.view_count = f.dedup_count_by_item.copy()
        else:
            self.view_count = np.bincount(
                f.items, minlength=f.num_items).astype(np.int64)

    def _norm(self):
        # normalized by the number of users (by_user) or of events
        return (self.feedback.num_users if self.by_user
                else max(len(self.feedback), 1))

    def predict_batch(self, users, items):
        items = np.asarray(items, dtype=np.int64)
        out = np.full(items.shape, _UNKNOWN, dtype=np.float32)
        ok = (items >= 0) & (items < self.view_count.shape[0])
        out[ok] = self.view_count[items[ok]] / self._norm()
        return out

    def score_catalog(self, users):
        row = (self.view_count / self._norm()).astype(np.float32)
        return np.tile(row, (np.asarray(users).size, 1))

    def _retrain(self, users, items):
        self.train()

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.int_vector(self.view_count)

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            self.view_count = r.int_vector().astype(np.int64)
        self.num_items_trained = self.view_count.shape[0]


class Zero(ItemRecommender):
    """Always scores 0 (reference Zero.cs:24)."""

    def train(self):
        pass

    def predict_batch(self, users, items):
        return np.zeros(np.asarray(users).shape, dtype=np.float32)

    def score_catalog(self, users):
        return np.zeros((np.asarray(users).size, self.num_items_trained),
                        dtype=np.float32)

    def save_model(self, path):
        pass

    def load_model(self, path):
        pass


class RandomItem(ItemRecommender):
    """Uniform random scores (reference ItemRecommendation/Random.cs:24).
    The catalog scores are ``predict_batch`` over the catalog, one user
    at a time, as in the JAX package: the draws come in the same order."""

    def __init__(self):
        super().__init__()
        self.random_seed = 42
        self._rng = np.random.default_rng(42)

    def train(self):
        self._rng = np.random.default_rng(self.random_seed)

    def predict_batch(self, users, items):
        return self._rng.random(np.asarray(users).shape).astype(np.float32)

    def save_model(self, path):
        pass

    def load_model(self, path):
        pass


def _scores_by_user(model, users, items, num_users: int, num_items: int):
    """``predict_batch`` from ``score_catalog``: each distinct valid user
    scored once; unknown ids score float.MinValue."""
    users = np.asarray(users, dtype=np.int64)
    items = np.asarray(items, dtype=np.int64)
    out = np.full(users.shape, _UNKNOWN, dtype=np.float32)
    ok = (users >= 0) & (users < num_users) & (items >= 0) & (items < num_items)
    if ok.any():
        uniq, rows = np.unique(users[ok], return_inverse=True)
        out[ok] = model.score_catalog(uniq)[rows, items[ok]]
    return out


class MostPopularByAttributes(ItemRecommender):
    """Popularity within item-attribute groups (reference
    MostPopularByAttributes.cs:47-120): score(u, i) = (1 + the user's
    per-attribute event counts summed over i's attributes) *
    (popularity + 1) / (|attrs(i)| + 1)."""

    REQUIRED_SIDE_INFO = ("item_attributes",)

    def __init__(self):
        super().__init__()
        self.item_attributes = None  # InteractionData: item -> attribute
        self._mp = MostPopular()
        self._attr_count = None      # [U, n_attr]
        self._A = None               # [I, n_attr] binary

    def train(self):
        if self.item_attributes is None:
            raise ValueError("MostPopularByAttributes needs item attributes")
        f = self.feedback
        self._mp.feedback = f
        self._mp.train()
        n_attr = self.item_attributes.num_items
        I = max(f.num_items, self.item_attributes.num_users)
        self.num_items_trained = I
        A = np.zeros((I, n_attr), dtype=np.float32)
        A[self.item_attributes.users, self.item_attributes.items] = 1.0
        self._A = A
        # one increment per feedback event and attribute (not de-duplicated)
        cnt = np.zeros((f.num_users, I), dtype=np.float32)
        np.add.at(cnt, (f.users, f.items), 1.0)
        self._attr_count = cnt @ A

    def score_catalog(self, users):
        users = np.clip(np.asarray(users, dtype=np.int64), 0,
                        self._attr_count.shape[0] - 1)
        mp_row = (self._mp.view_count / self._mp._norm()).astype(np.float32)
        attr_term = 1.0 + self._attr_count[users] @ self._A.T  # [B, I]
        denom = self._A.sum(axis=1) + 1.0
        return (attr_term * (mp_row + 1.0)[None, :] /
                denom[None, :]).astype(np.float32)

    def predict_batch(self, users, items):
        return _scores_by_user(self, users, items, self.feedback.num_users,
                               self.num_items_trained)

    def save_model(self, path):
        raise NotImplementedError  # as the reference

    def load_model(self, path):
        raise NotImplementedError


class BigramRules(ItemRecommender):
    """Item -> item association rules from co-occurring events (reference
    BigramRules.cs:27-100): score(u, i) = sum over j in I_u, j != i, of
    support * confidence = C[j, i]^2 / (|U_j| * N), C = Mᵀ·M the
    co-occurrence counts of the binary incidence M."""

    EXTRA_PARAMS = {"device": str}

    def __init__(self):
        super().__init__()
        self.device = "cuda"
        self._R = None               # [I, I] rule weights (numpy)
        self._M = None               # [U, I] binary incidence (numpy)

    def train(self):
        f = self.feedback
        M = incidence_dense(f, f.num_users, f.num_items)
        Md = torch.from_numpy(M).to(resolve_device(self.device))
        with exact_float32():
            C = (Md.T @ Md).cpu().numpy()
        np.fill_diagonal(C, 0.0)
        cnt = np.maximum(M.sum(axis=0), 1.0)  # |U_j|
        N = max(len(f), 1)
        self._R = (C * C / (cnt[:, None] * N)).astype(np.float32)
        self._M = M

    def score_catalog(self, users):
        users = np.clip(np.asarray(users, dtype=np.int64), 0,
                        self._M.shape[0] - 1)
        return (self._M[users] @ self._R).astype(np.float32)

    def predict_batch(self, users, items):
        return _scores_by_user(self, users, items, self._M.shape[0],
                               self._R.shape[0])

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.matrix(self._R)

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            self._R = r.matrix()
        self.num_items_trained = self._R.shape[0]
        if self.feedback is not None:
            f = self.feedback
            self._M = incidence_dense(f, f.num_users, f.num_items)
