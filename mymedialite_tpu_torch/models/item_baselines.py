"""Popularity item recommender of the port.

Counterpart of ``mymedialite_tpu/models/item_baselines.py`` ``MostPopular``
(reference ``ItemRecommendation/MostPopular.cs:38-120``), the default
recommender of the item_recommendation CLI. Counting and scoring are host
numpy, as in the JAX package; the model file format is the same.
``Zero``, ``Random``, ``MostPopularByAttributes`` and ``BigramRules`` are
not ported yet.
"""

from __future__ import annotations

import numpy as np

from mymedialite_tpu_torch.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu_torch.models.base import IncrementalItemRecommender


class MostPopular(IncrementalItemRecommender):
    """Popularity count, optionally per-user de-duplicated."""

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
        out = np.full(items.shape, -np.float32(3.4e38), dtype=np.float32)
        ok = (items >= 0) & (items < self.view_count.shape[0])
        out[ok] = self.view_count[items[ok]] / self._norm()
        return out

    def score_catalog(self, users):
        row = (self.view_count / self._norm()).astype(np.float32)
        return np.tile(row, (np.asarray(users).size, 1))

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.int_vector(self.view_count)

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            self.view_count = r.int_vector().astype(np.int64)
        self.num_items_trained = self.view_count.shape[0]
