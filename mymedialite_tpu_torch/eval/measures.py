"""Ranking / error measures, exact-parity with the reference formulas.

Two forms of each ranking measure:
- the list form (``*_list``): operates on an explicit ranked item list —
  direct counterparts of reference ``Eval/Measures/{AUC,NDCG,
  PrecisionAndRecall,ReciprocalRank}.cs``; used in tests as the oracle.
- the rank form (in ``ranking.py``): vectorized over per-user correct-item
  rank arrays, used by the batched evaluation path. Both are tested
  to agree.

The port's own copy of ``mymedialite_tpu/eval/measures.py``:
the same behaviour, and no import of the JAX package.
"""

from __future__ import annotations

import numpy as np


def auc_list(ranked_items, relevant_items, num_dropped_items: int = 0) -> float:
    """Reference Eval/Measures/AUC.cs:42-68 (with dropped-items correction)."""
    relevant = set(relevant_items)
    num_relevant_in_list = sum(1 for i in ranked_items if i in relevant)
    num_eval_items = len(ranked_items) + num_dropped_items
    num_eval_pairs = (num_eval_items - num_relevant_in_list) * num_relevant_in_list
    if num_eval_pairs < 0:
        raise ValueError("num_eval_pairs cannot be less than 0")
    if num_eval_pairs == 0:
        return 0.5
    num_correct_pairs = 0
    hit_count = 0
    for item in ranked_items:
        if item not in relevant:
            num_correct_pairs += hit_count
        else:
            hit_count += 1
    missing_relevant = len(relevant) - num_relevant_in_list
    if num_dropped_items - missing_relevant < 0:
        raise ValueError("more missing relevant items than dropped items")
    num_correct_pairs += hit_count * (num_dropped_items - missing_relevant)
    return num_correct_pairs / num_eval_pairs


def average_precision_list(ranked_items, correct_items) -> float:
    """Reference PrecisionAndRecall.AP (PrecisionAndRecall.cs:45-66):
    divides by |correct_items| (all correct, in list or not)."""
    correct = set(correct_items)
    hit_count = 0
    ap_sum = 0.0
    for pos, item in enumerate(ranked_items):
        if item in correct:
            hit_count += 1
            ap_sum += hit_count / (pos + 1)
    return ap_sum / len(correct) if hit_count else 0.0


def hits_at_list(ranked_items, correct_items, n: int) -> int:
    """Reference PrecisionAndRecall.HitsAt (:118-141)."""
    if n < 1:
        raise ValueError("n must be at least 1")
    correct = set(correct_items)
    return sum(1 for pos, item in enumerate(ranked_items[:n]) if item in correct)


def precision_at_list(ranked_items, correct_items, n: int) -> float:
    return hits_at_list(ranked_items, correct_items, n) / n


def recall_at_list(ranked_items, correct_items, n: int) -> float:
    return hits_at_list(ranked_items, correct_items, n) / len(set(correct_items))


def idcg(n: int) -> float:
    """Ideal DCG of n relevant items, binary gains, log2 discount
    (reference NDCG.ComputeIDCG)."""
    return float(np.sum(1.0 / np.log2(np.arange(n) + 2))) if n > 0 else 0.0


def ndcg_list(ranked_items, correct_items) -> float:
    """Reference NDCG.Compute (NDCG.cs:36-55)."""
    correct = set(correct_items)
    dcg = sum(1.0 / np.log2(pos + 2)
              for pos, item in enumerate(ranked_items) if item in correct)
    return dcg / idcg(len(correct))


def reciprocal_rank_list(ranked_items, correct_items) -> float:
    """Reference ReciprocalRank.Compute (:39-56)."""
    correct = set(correct_items)
    for pos, item in enumerate(ranked_items):
        if item in correct:
            return 1.0 / (pos + 1)
    return 0.0


def compute_cbd(actual, prediction, min_rating, max_rating):
    """Capped binomial deviation (reference Eval/Ratings.cs:150-162):
    map to [0,1], cap prediction to [0.01, 0.99], binomial deviance in log10.
    Vectorized over numpy arrays."""
    rng = max_rating - min_rating
    p = (np.asarray(prediction, dtype=np.float64) - min_rating) / rng
    a = (np.asarray(actual, dtype=np.float64) - min_rating) / rng
    p = np.clip(p, 0.01, 0.99)
    return -(a * np.log10(p) + (1 - a) * np.log10(1 - p))


def logistic_loss(actual01, prediction01):
    """Binary log-loss in nats over [0,1]-normalized values
    (reference Eval/Measures/LogisticLoss.cs:35-57)."""
    p = np.clip(np.asarray(prediction01, dtype=np.float64), 1e-15, 1 - 1e-15)
    a = np.asarray(actual01, dtype=np.float64)
    return -(a * np.log(p) + (1 - a) * np.log(1 - p))
