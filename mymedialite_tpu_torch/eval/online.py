"""Online ("prequential") evaluation: predict, then train on what was
just predicted.

The port's counterpart of ``mymedialite_tpu/eval/online.py`` (reference
``Eval/RatingsOnline.cs:35-80``, per rating in random order, and
``Eval/ItemsOnline.cs:43-105``, per user). This is the streaming-serving
protocol: the incremental-update path (``add_ratings`` /
``add_feedback`` -> a row refresh on the model's device) runs one event
at a time. The event order is the JAX package's: a numpy permutation
from ``random_seed``.
"""

from __future__ import annotations

import numpy as np

from mymedialite_tpu_torch.data.arrays import PosOnlyData
from mymedialite_tpu_torch.eval.measures import compute_cbd
from mymedialite_tpu_torch.eval.ranking import candidates_for_mode, evaluate_items
from mymedialite_tpu_torch.eval.results import (
    ItemRecommendationResults, RatingPredictionResults,
)


def evaluate_ratings_online(recommender, test, rng=None
                            ) -> RatingPredictionResults:
    """Reference RatingsOnline.EvaluateOnline: iterate test ratings in
    random order; predict, accumulate RMSE/MAE/CBD, then add_ratings.

    Fast path (protocol-exact): models that declare
    ``ONLINE_PREDICT_ROW_LOCAL`` (prediction for (u, i) reads only u's
    and i's rows) get *chunked* predictions — events are batched into
    one predict_batch call until an event's user or item collides with
    a row already updated inside the chunk, at which point the chunk is
    flushed. Updates themselves stay strictly in event order. Models
    that support it additionally run in buffered-update mode
    (begin/end_online_updates): events append to O(1) host buffers and
    fold into the immutable dataset once at the end."""
    if not hasattr(recommender, "add_ratings"):
        raise TypeError("recommender must support incremental updates")
    rng = rng or np.random.default_rng(getattr(recommender, "random_seed", 42))
    order = rng.permutation(len(test))
    users = np.asarray(test.users, dtype=np.int32)[order]
    items = np.asarray(test.items, dtype=np.int32)[order]
    values = np.asarray(test.values, dtype=np.float32)[order]
    n = len(test)
    lo, hi = recommender.min_rating, recommender.max_rating

    begin = getattr(recommender, "begin_online_updates", None)
    buffered = bool(begin()) if begin is not None else False
    preds = np.empty(n, dtype=np.float64)

    if getattr(recommender, "ONLINE_PREDICT_ROW_LOCAL", False):
        # chunk boundaries: first same-user or same-item repeat
        touched_u, touched_i = set(), set()
        start = 0
        bounds = []
        for t in range(n):
            u, i = int(users[t]), int(items[t])
            if u in touched_u or i in touched_i:
                bounds.append((start, t))
                start = t
                touched_u.clear()
                touched_i.clear()
            touched_u.add(u)
            touched_i.add(i)
        bounds.append((start, n))
        for a, b in bounds:
            preds[a:b] = recommender.predict_batch(users[a:b], items[a:b])
            for t in range(a, b):
                recommender.add_ratings([int(users[t])], [int(items[t])],
                                        [float(values[t])])
    else:
        for t in range(n):
            u, i = int(users[t]), int(items[t])
            preds[t] = recommender.predict(u, i)
            recommender.add_ratings([u], [i], [float(values[t])])

    if buffered:
        recommender.end_online_updates()

    err = preds - values
    result = RatingPredictionResults()
    result["RMSE"] = float(np.sqrt(np.mean(err * err)))
    result["MAE"] = float(np.mean(np.abs(err)))
    result["NMAE"] = result["MAE"] / (hi - lo)
    result["CBD"] = float(np.mean(compute_cbd(values, preds, lo, hi)))
    return result


def evaluate_items_online(recommender, test, training, test_users=None,
                          candidate_items=None, candidate_item_mode="OVERLAP",
                          rng=None) -> ItemRecommendationResults:
    """Reference ItemsOnline.EvaluateOnline: per test user (random order),
    evaluate that user's test items, then AddFeedback them."""
    if not hasattr(recommender, "add_feedback"):
        raise TypeError("recommender must support incremental updates")
    rng = rng or np.random.default_rng(getattr(recommender, "random_seed", 42))
    if test_users is None:
        test_users = test.all_users
    test_users = np.asarray(test_users)
    test_users = test_users[rng.permutation(test_users.size)]
    cand = candidates_for_mode(candidate_item_mode, test, training,
                               candidate_items)
    cand_set = set(int(c) for c in cand)

    per_user = []
    for u in test_users:
        u = int(u)
        items_u = test.items_by_user(u) if u < test.num_users else \
            np.array([], dtype=np.int32)
        if not any(int(i) in cand_set for i in items_u):
            continue
        current = PosOnlyData(np.full(items_u.size, u, dtype=np.int32),
                              items_u, num_users=max(u + 1, test.num_users),
                              num_items=test.num_items)
        res = evaluate_items(recommender, current, training,
                             test_users=[u], candidate_items=cand,
                             candidate_item_mode="EXPLICIT")
        per_user.append(res)
        recommender.add_feedback(np.full(items_u.size, u, dtype=np.int32),
                                 items_u)

    result = ItemRecommendationResults()
    for m in ItemRecommendationResults.ALL_MEASURES:
        result[m] = (sum(r[m] for r in per_user) / len(per_user)
                     if per_user else 0.0)
    result["num_users"] = len(per_user)
    result["num_lists"] = len(per_user)
    result["num_items"] = len(cand_set)
    return result
