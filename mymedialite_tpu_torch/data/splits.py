"""Dataset splits as pure index-array operations.

Counterparts of the reference split objects:
``RatingsSimpleSplit.cs``, ``RatingCrossValidationSplit.cs``,
``RatingsChronologicalSplit.cs:30-65``, ``RatingsPerUserChronologicalSplit.cs``,
``PosOnlyFeedbackSimpleSplit.cs``, ``PosOnlyFeedbackCrossValidationSplit.cs``.

Each split returns (train, test) datasets (or lists of folds) built by
indexing the source COO arrays — the array analog of the reference's
zero-copy proxy views.

The port's own copy of ``mymedialite_tpu/data/splits.py``:
the same behaviour, and no import of the JAX package.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from mymedialite_tpu_torch.data.arrays import PosOnlyData, RatingData


def simple_split(data, ratio: float, rng: np.random.Generator
                 ) -> Tuple[object, object]:
    """Random split: ``ratio`` fraction into test (reference RatingsSimpleSplit)."""
    if not 0 < ratio < 1:
        raise ValueError(f"ratio must be in (0,1), got {ratio}")
    n = len(data)
    perm = rng.permutation(n)
    n_test = int(round(n * ratio))
    test_idx = np.sort(perm[:n_test])
    train_idx = np.sort(perm[n_test:])
    return data.select(train_idx), data.select(test_idx)


def crossvalidation_split(data, num_folds: int, shuffle: bool = False,
                          rng: np.random.Generator = None) -> List[Tuple[object, object]]:
    """k-fold split; element i goes to fold ``i % num_folds`` (the reference's
    assignment rule, RatingCrossValidationSplit.cs), optionally after a shuffle.
    Returns a list of (train, test) pairs."""
    if num_folds < 2:
        raise ValueError("num_folds must be >= 2")
    n = len(data)
    order = rng.permutation(n) if shuffle else np.arange(n)
    fold_of = np.empty(n, dtype=np.int64)
    fold_of[order] = np.arange(n) % num_folds
    folds = []
    for f in range(num_folds):
        test_idx = np.nonzero(fold_of == f)[0]
        train_idx = np.nonzero(fold_of != f)[0]
        folds.append((data.select(train_idx), data.select(test_idx)))
    return folds


def chronological_split_ratio(data: RatingData, ratio: float
                              ) -> Tuple[RatingData, RatingData]:
    """Latest ``ratio`` fraction (by timestamp) into test
    (reference RatingsChronologicalSplit.cs:30-65)."""
    if data.times is None:
        raise ValueError("chronological split requires timed ratings")
    order = np.argsort(data.times, kind="stable")
    n_test = int(round(len(data) * ratio))
    split = len(data) - n_test
    return data.select(np.sort(order[:split])), data.select(np.sort(order[split:]))


def chronological_split_time(data: RatingData, split_time: int
                             ) -> Tuple[RatingData, RatingData]:
    """Ratings at/after ``split_time`` go to test."""
    if data.times is None:
        raise ValueError("chronological split requires timed ratings")
    test_mask = data.times >= split_time
    return (data.select(np.nonzero(~test_mask)[0]),
            data.select(np.nonzero(test_mask)[0]))


def per_user_chronological_split(data: RatingData, ratio: float = None,
                                 num_test_per_user: int = None
                                 ) -> Tuple[RatingData, RatingData]:
    """Per-user: each user's latest ratings go to test
    (reference RatingsPerUserChronologicalSplit.cs)."""
    if data.times is None:
        raise ValueError("chronological split requires timed ratings")
    if (ratio is None) == (num_test_per_user is None):
        raise ValueError("specify exactly one of ratio / num_test_per_user")
    test_mask = np.zeros(len(data), dtype=bool)
    csr = data.by_user
    for u in range(data.num_users):
        seg = csr.segment(u)
        if seg.size == 0:
            continue
        seg = seg[np.argsort(data.times[seg], kind="stable")]
        k = (int(round(seg.size * ratio)) if ratio is not None
             else min(num_test_per_user, seg.size))
        if k > 0:
            test_mask[seg[seg.size - k:]] = True
    return (data.select(np.nonzero(~test_mask)[0]),
            data.select(np.nonzero(test_mask)[0]))


# Implicit-feedback variants share the same index machinery.

def posonly_simple_split(data: PosOnlyData, ratio: float,
                         rng: np.random.Generator) -> Tuple[PosOnlyData, PosOnlyData]:
    return simple_split(data, ratio, rng)


def posonly_crossvalidation_split(data: PosOnlyData, num_folds: int,
                                  shuffle: bool = False, rng=None):
    return crossvalidation_split(data, num_folds, shuffle, rng)
