"""Recommenders that serve pre-computed predictions from a file.

Counterparts of ``mymedialite_tpu/models/external.py`` (reference
``RatingPrediction/ExternalRatingPredictor.cs:32`` and
``ItemRecommendation/ExternalItemRecommender.cs:32``): 'training' reads
a ``user item score`` file through the program's ID mappings (the CLIs
hand them to any model with a ``user_mapping`` attribute) and serves
lookups from it.

The JAX package keeps the scores in a Python dict and looks pairs up
one by one. The port keeps them on the device as sorted int64 keys
``u * num_items + i`` with their scores, and looks a batch of pairs up
with one ``torch.searchsorted``. The dict's semantics stay: the last
line of a duplicated pair wins; a missing pair scores 0.0 (rating) or
-3.4e38 (item); ``num_users_trained`` and ``num_items_trained`` come
from the file. The item recommender's catalog scores scatter each
user's listed scores into a row of -3.4e38.
"""

from __future__ import annotations

import numpy as np
import torch

from mymedialite_tpu_torch.data.io import read_rating_data
from mymedialite_tpu_torch.device import resolve_device
from mymedialite_tpu_torch.models.base import ItemRecommender, RatingPredictor


class _ExternalScores:
    HYPERPARAMS = {"prediction_file": str}
    EXTRA_PARAMS = {"device": str}
    DEFAULT = 0.0

    def _init_scores(self):
        self.prediction_file = "FILENAME"
        self.device = "cuda"
        self.user_mapping = None
        self.item_mapping = None
        self._keys = None       # sorted int64 u * num_items + i
        self._scores = None     # float32, aligned with _keys
        self._width = 1         # num_items of the file: the key's stride

    def _read(self):
        data = read_rating_data(self.prediction_file, self.user_mapping,
                                self.item_mapping, use_cache=False)
        dev = resolve_device(self.device)
        self._width = max(data.num_items, 1)
        keys = data.users.astype(np.int64) * self._width + data.items
        # the last line of a pair wins: a stable sort keeps the lines of
        # a key in file order, and the last of each run is kept
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        last = np.ones(keys.size, dtype=bool)
        last[:-1] = keys[1:] != keys[:-1]
        self._keys = torch.from_numpy(keys[last]).to(dev)
        self._scores = torch.from_numpy(
            np.ascontiguousarray(data.values[order][last])).to(dev)
        self.num_users_trained = data.num_users
        self.num_items_trained = data.num_items

    def tables_device(self):
        if self._keys is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        return self._keys.device

    def _find(self, users, items):
        """(position in the keys, listed?) of each pair; users and items
        are int64 numpy arrays."""
        dev = self.tables_device()
        u = torch.from_numpy(np.asarray(users, dtype=np.int64)).to(dev)
        i = torch.from_numpy(np.asarray(items, dtype=np.int64)).to(dev)
        ok = (u >= 0) & (i >= 0) & (i < self._width)
        if self._keys.numel() == 0:
            return torch.zeros_like(u), torch.zeros_like(ok)
        key = torch.where(ok, u * self._width + i, torch.full_like(u, -1))
        at = torch.searchsorted(self._keys, key).clamp(
            max=self._keys.numel() - 1)
        return at, ok & (self._keys[at] == key)

    def can_predict(self, user_id, item_id):
        return bool(self._find([user_id], [item_id])[1].item())

    def predict_batch(self, users, items):
        """The listed scores; the default where the file lists no such
        pair."""
        at, hit = self._find(users, items)
        out = torch.full(hit.shape, self.DEFAULT, dtype=torch.float32,
                         device=hit.device)
        out[hit] = self._scores[at[hit]]
        return out.cpu().numpy()

    def save_model(self, path):
        pass

    def load_model(self, path):
        pass


class ExternalRatingPredictor(_ExternalScores, RatingPredictor):
    """Ratings from a prediction file; unlisted pairs predict 0.0. No
    pair scorer: the evaluator takes ``predict_batch`` on the host
    path, as the JAX package does."""

    def __init__(self):
        RatingPredictor.__init__(self)
        self._init_scores()

    def train(self):
        self._read()


class ExternalItemRecommender(_ExternalScores, ItemRecommender):
    """Item scores from a prediction file; unlisted pairs score
    -3.4e38 (reference float.MinValue)."""

    DEFAULT = -3.4e38

    def __init__(self):
        ItemRecommender.__init__(self)
        self._init_scores()

    def train(self):
        self._read()

    def catalog_scorer(self, device=None):
        """[B, num_items_trained] scores: each user's listed scores
        scattered into a row of -3.4e38 (the user's keys are one run of
        the sorted keys, found by two ``searchsorted`` calls)."""
        if self._keys is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        keys, scores, width = self._keys, self._scores, self._width
        num_items = self.num_items_trained

        def score(users):
            B = users.shape[0]
            out = torch.full((B, num_items), self.DEFAULT,
                             dtype=torch.float32, device=users.device)
            lo = torch.searchsorted(keys, users * width)
            hi = torch.searchsorted(keys, (users + 1) * width)
            hi = torch.where(users >= 0, hi, lo)
            counts = hi - lo
            row = torch.repeat_interleave(
                torch.arange(B, device=users.device), counts)
            start = torch.cumsum(counts, 0) - counts
            at = lo[row] + torch.arange(row.numel(), device=users.device) \
                - start[row]
            out[row, keys[at] - users[row] * width] = scores[at]
            return out
        return self._on_device(score, device)

    def score_catalog(self, users):
        return self._scores_from_scorer(users)
