"""Synthetic rating data for the port's smoke runs and GPU tests.

The same generator, with the same seeds giving the same ratings, as
``mymedialite_tpu/data/synthetic.py`` ``synthetic_ratings`` and
``split_ratings`` (``tests/test_torch_data.py`` holds the two equal):
Zipf-like item popularity, log-normal user activity, a low-rank plus
biases score on a half-star 1..5 scale. Numpy draws the random numbers;
the rating draws' searches and de-duplication run in torch on ``device``
(the CPU by default); the ratings are ``RatingData``, the dataset type
the port's models and CLI take.

``synthetic_ratings`` also draws timestamps (``with_times``) with a
per-item linear drift (``time_drift``), the planted factors
(``return_factors``), and ``synthetic_posonly`` draws implicit feedback
from a planted low-rank preference (a chunked Gumbel argmax), both as
the JAX package's functions of those names do, array for array.
``posonly_from_ratings`` views the rated (user, item) pairs as
positive-only feedback for the item-recommendation path, and
``split_posonly`` splits it as the JAX package's function of that name
does, with the same seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from mymedialite_tpu_torch.data.arrays import PosOnlyData, RatingData


def _choice(rng, n: int, size: int, p, device):
    """``rng.choice(n, size=size, p=p)``, its search of the cumulative
    distribution run with ``torch.searchsorted`` on ``device``: numpy's
    algorithm (``cumsum``, normalised by the last entry, ``random``, a
    right-sided search), the same draws."""
    cdf = p.cumsum()
    cdf /= cdf[-1]
    u = torch.from_numpy(rng.random(size)).to(device)
    return torch.searchsorted(torch.from_numpy(cdf).to(device), u,
                              right=True)


def _first_occurrences(users, items, num_items: int):
    """The indices of each distinct (user, item)'s first draw, ascending:
    ``np.sort(np.unique(keys, return_index=True)[1])``, by a stable sort
    where the draws lie."""
    sorted_keys, perm = torch.sort(users * num_items + items, stable=True)
    head = torch.ones_like(sorted_keys, dtype=torch.bool)
    head[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return torch.sort(perm[head]).values


def synthetic_ratings(num_users: int = 943, num_items: int = 1682,
                      num_ratings: int = 100_000, rank: int = 8,
                      noise: float = 0.6, seed: int = 42,
                      with_times: bool = False, time_drift: float = 0.0,
                      return_factors: bool = False, device="cpu"):
    """``num_ratings`` draws of (user, item), de-duplicated (first
    occurrence kept), rated by a planted rank-``rank`` model plus biases
    and Gaussian noise of std ``noise``.

    ``with_times`` adds unix times drawn uniformly from [880,000,000,
    893,000,000) after the noise, so that the ratings stay those of a
    draw without times; ``time_drift`` > 0 then adds a per-item linear
    drift of that size over the time span (the time-aware baselines'
    signal). ``return_factors`` returns (data, (P, Q, b_u, b_i)), the
    planted model (e.g. for a trust graph that agrees with it).
    ``device`` (a torch device) runs the draws' searches and the
    de-duplication, with the same result anywhere: at tens of millions of
    draws they are most of the host's time, so the card may take them."""
    rng = np.random.default_rng(seed)
    item_p = 1.0 / np.arange(1, num_items + 1) ** 0.8
    item_p /= item_p.sum()
    user_p = rng.lognormal(0.0, 1.0, num_users)
    user_p /= user_p.sum()
    users = _choice(rng, num_users, num_ratings, user_p, device)
    items = _choice(rng, num_items, num_ratings, item_p, device)
    first = _first_occurrences(users, items, num_items)
    users, items = (t[first].cpu().numpy().astype(np.int32)
                    for t in (users, items))
    n = users.size

    P = rng.normal(0, 1.0 / np.sqrt(rank), (num_users, rank))
    Q = rng.normal(0, 1.0 / np.sqrt(rank), (num_items, rank))
    bu = rng.normal(0, 0.35, num_users)
    bi = rng.normal(0, 0.35, num_items)
    raw = 3.6 + bu[users] + bi[items] + np.einsum(
        "nf,nf->n", P[users], Q[items]) * 1.2 + rng.normal(0, noise, n)
    times = None
    if with_times:
        times = rng.integers(880_000_000, 893_000_000, n)
        if time_drift:
            d_i = rng.normal(0, 1.0, num_items)
            t_norm = (times - 880_000_000) / 13_000_000.0
            raw = raw + time_drift * (t_norm - 0.5) * d_i[items]
    values = np.clip(np.round(raw * 2) / 2, 1.0, 5.0)
    data = RatingData(users, items, values, num_users=num_users,
                      num_items=num_items, times=times)
    if return_factors:
        return data, (P, Q, bu, bi)
    return data


def synthetic_posonly(num_users: int = 943, num_items: int = 1682,
                      num_events: int = 50_000, rank: int = 8,
                      seed: int = 7) -> PosOnlyData:
    """Implicit feedback whose events follow softmax(popularity +
    planted affinity) per user, drawn by the Gumbel trick in chunks of
    4,096 events (a [4096, num_items] temporary), de-duplicated (first
    occurrence kept) and cut to ``num_events``."""
    rng = np.random.default_rng(seed)
    P = rng.normal(0, 1, (num_users, rank)).astype(np.float32)
    Q = rng.normal(0, 1, (num_items, rank)).astype(np.float32)
    pop = rng.normal(0, 1, num_items).astype(np.float32)
    user_p = rng.lognormal(0.0, 1.0, num_users)
    user_p /= user_p.sum()
    users = rng.choice(num_users, size=num_events * 2,
                       p=user_p).astype(np.int32)
    items = np.empty(users.size, dtype=np.int32)
    # the affinity outweighs the popularity, so that factor models beat
    # the most-popular ranking
    scale = np.float32(2.0 / np.sqrt(rank))
    for s in range(0, users.size, 4096):
        chunk = users[s:s + 4096]
        logits = P[chunk] @ Q.T * scale + 0.5 * pop[None, :]
        g = rng.gumbel(size=logits.shape).astype(np.float32)
        items[s:s + 4096] = np.argmax(logits + g, axis=1)
    _, first = np.unique(users.astype(np.int64) * num_items + items,
                         return_index=True)
    first = np.sort(first)[:num_events]
    return PosOnlyData(users[first], items[first], num_users=num_users,
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


def posonly_from_ratings(data: RatingData) -> PosOnlyData:
    """The rated (user, item) pairs as positive-only feedback."""
    return PosOnlyData(data.users, data.items, num_users=data.num_users,
                       num_items=data.num_items)


def split_posonly(data: PosOnlyData, test_fraction: float = 0.2,
                  seed: int = 1):
    """(train, test): a random ``test_fraction`` of the events held out,
    both parts in their original order."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(data))
    n_test = int(len(data) * test_fraction)
    return (data.select(np.sort(perm[n_test:])),
            data.select(np.sort(perm[:n_test])))
