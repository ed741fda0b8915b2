"""Synthetic rating data for the port's smoke runs and GPU tests.

The same generator, with the same seeds giving the same ratings, as
``mymedialite_tpu/data/synthetic.py`` ``synthetic_ratings`` and
``split_ratings`` (``tests/test_torch_data.py`` holds the two equal):
Zipf-like item popularity, log-normal user activity, a low-rank plus
biases score on a half-star 1..5 scale. Numpy only; the ratings are
``RatingData``, the dataset type the port's models and CLI take.
"""

from __future__ import annotations

import numpy as np

from mymedialite_tpu.data.arrays import RatingData


def synthetic_ratings(num_users: int = 943, num_items: int = 1682,
                      num_ratings: int = 100_000, rank: int = 8,
                      noise: float = 0.6, seed: int = 42) -> RatingData:
    """``num_ratings`` draws of (user, item), de-duplicated (first
    occurrence kept), rated by a planted rank-``rank`` model plus biases
    and Gaussian noise of std ``noise``."""
    rng = np.random.default_rng(seed)
    item_p = 1.0 / np.arange(1, num_items + 1) ** 0.8
    item_p /= item_p.sum()
    user_p = rng.lognormal(0.0, 1.0, num_users)
    user_p /= user_p.sum()
    users = rng.choice(num_users, size=num_ratings, p=user_p).astype(np.int32)
    items = rng.choice(num_items, size=num_ratings, p=item_p).astype(np.int32)
    _, first = np.unique(users.astype(np.int64) * num_items + items,
                         return_index=True)
    first = np.sort(first)
    users, items = users[first], items[first]
    n = users.size

    P = rng.normal(0, 1.0 / np.sqrt(rank), (num_users, rank))
    Q = rng.normal(0, 1.0 / np.sqrt(rank), (num_items, rank))
    bu = rng.normal(0, 0.35, num_users)
    bi = rng.normal(0, 0.35, num_items)
    raw = 3.6 + bu[users] + bi[items] + np.einsum(
        "nf,nf->n", P[users], Q[items]) * 1.2 + rng.normal(0, noise, n)
    values = np.clip(np.round(raw * 2) / 2, 1.0, 5.0)
    return RatingData(users, items, values, num_users=num_users,
                      num_items=num_items)


def split_ratings(data: RatingData, test_fraction: float = 0.2,
                  seed: int = 1):
    """(train, test): a random ``test_fraction`` of the ratings held out,
    both parts in their original order."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(data))
    n_test = int(len(data) * test_fraction)
    return (data.select(np.sort(perm[n_test:])),
            data.select(np.sort(perm[:n_test])))
