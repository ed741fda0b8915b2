"""Fold-in evaluation: score items for users represented only by a
held-out history, without (or with) retraining.

The port's counterpart of ``mymedialite_tpu/eval/foldin.py`` (reference
``Eval/FoldIn.cs:29-180``), three protocols:
1. true fold-in (ScoreItems on the frozen model),
2. complete retraining per user,
3. incremental update per user.
"""

from __future__ import annotations

import numpy as np

from mymedialite_tpu_torch.eval.crossval import clone_recommender
from mymedialite_tpu_torch.eval.measures import compute_cbd
from mymedialite_tpu_torch.eval.results import RatingPredictionResults


def _accumulate(recommender, preds_actuals):
    se = ae = cbd = 0.0
    n = 0
    lo, hi = recommender.min_rating, recommender.max_rating
    for pred, actual in preds_actuals:
        err = pred - actual
        se += err * err
        ae += abs(err)
        cbd += float(compute_cbd(actual, pred, lo, hi))
        n += 1
    result = RatingPredictionResults()
    result["RMSE"] = np.sqrt(se / n) if n else float("nan")
    result["MAE"] = ae / n if n else float("nan")
    result["NMAE"] = (ae / n) / (hi - lo) if n else float("nan")
    result["CBD"] = cbd / n if n else float("nan")
    return result


def _user_eval_pairs(update_data, eval_data):
    common = np.intersect1d(update_data.all_users, eval_data.all_users)
    for u in common:
        u = int(u)
        idx_known = update_data.by_user.segment(u)
        known = [(int(update_data.items[k]), float(update_data.values[k]))
                 for k in idx_known]
        idx_eval = eval_data.by_user.segment(u)
        to_rate = [(int(eval_data.items[k]), float(eval_data.values[k]))
                   for k in idx_eval]
        yield u, known, to_rate


def evaluate_fold_in(recommender, update_data, eval_data
                     ) -> RatingPredictionResults:
    """Protocol 1 (reference EvaluateFoldIn :34-75): true fold-in via
    ScoreItems; the trained model is never mutated."""
    pairs = []
    for _, known, to_rate in _user_eval_pairs(update_data, eval_data):
        items = [i for i, _ in to_rate]
        actual = {i: v for i, v in to_rate}
        scored = recommender.score_items_foldin(known, items)
        pairs.extend((s, actual[i]) for i, s in scored)
    return _accumulate(recommender, pairs)


def evaluate_fold_in_complete_retraining(recommender, update_data, eval_data
                                         ) -> RatingPredictionResults:
    """Protocol 2 (reference :77-128): per user, clone + retrain on
    training data plus the user's update ratings."""
    pairs = []
    for u, known, to_rate in _user_eval_pairs(update_data, eval_data):
        local = clone_recommender(recommender)
        local.ratings = recommender.ratings.add(
            [u] * len(known), [i for i, _ in known], [v for _, v in known])
        local.train()
        items = np.array([i for i, _ in to_rate], dtype=np.int32)
        preds = local.predict_batch(np.full(items.size, u, dtype=np.int32),
                                    items)
        pairs.extend(zip(preds.tolist(), (v for _, v in to_rate)))
    return _accumulate(recommender, pairs)


def evaluate_fold_in_incremental_training(recommender, update_data, eval_data
                                          ) -> RatingPredictionResults:
    """Protocol 3 (reference :130-180): per user, AddRatings (incremental
    in-place update), evaluate, then RemoveRatings to restore."""
    pairs = []
    for u, known, to_rate in _user_eval_pairs(update_data, eval_data):
        us = [u] * len(known)
        its = [i for i, _ in known]
        recommender.add_ratings(us, its, [v for _, v in known])
        items = np.array([i for i, _ in to_rate], dtype=np.int32)
        preds = recommender.predict_batch(
            np.full(items.size, u, dtype=np.int32), items)
        pairs.extend(zip(preds.tolist(), (v for _, v in to_rate)))
        recommender.remove_ratings(us, its)
    return _accumulate(recommender, pairs)
