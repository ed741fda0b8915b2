"""Rating-prediction evaluation (RMSE/MAE/NMAE/CBD + cold-start breakdown).

Port of ``mymedialite_tpu/eval/rating.py`` (reference
``Eval/Ratings.cs:73-162``). Prediction and the metric reduction run as
one torch pass on the model's device over the whole test set; per-chunk
partial sums (float32, 1,024 pairs a chunk) come back to the host and
are finished there in float64, as in the JAX package. The test set is
uploaded once per device and cached on the data object (mutating ops
return new data objects, so the cache cannot go stale).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mymedialite_tpu_torch.eval.measures import compute_cbd
from mymedialite_tpu_torch.eval.results import RatingPredictionResults
from mymedialite_tpu_torch.device import resolve_device

_CHUNK = 1024


def _device_eval_arrays(test, device):
    """(u, i, v, w) tensors padded to whole chunks (w = 1 real, 0 pad)."""
    cached = test.__dict__.get("_torch_eval")
    if cached is not None and cached[0] == device:
        return cached[1]
    n = len(test)
    cap = max(_CHUNK, -(-n // _CHUNK) * _CHUNK)
    u = np.zeros(cap, np.int64)
    i = np.zeros(cap, np.int64)
    v = np.zeros(cap, np.float32)
    w = np.zeros(cap, np.float32)
    u[:n], i[:n], v[:n], w[:n] = test.users, test.items, test.values, 1.0
    out = tuple(torch.from_numpy(a).to(device) for a in (u, i, v, w))
    test.__dict__["_torch_eval"] = (device, out)
    return out


def _metric_sums(scorer, u, i, v, w, lo, hi, breakdown):
    """[M, 3, k] chunk sums of (err^2, |err|, CBD) under M masks
    (all / new user / new item / both), and the [M, k] chunk counts."""
    pred = scorer(u, i)
    err = pred - v
    rng = hi - lo
    # CBD (Eval/Ratings.cs:150-162): [0,1]-mapped, prediction capped,
    # binomial deviance in log10
    p01 = ((pred - lo) / rng).clamp(0.01, 0.99)
    a01 = (v - lo) / rng
    cbd = -(a01 * torch.log10(p01) + (1.0 - a01) * torch.log10(1.0 - p01))
    per = torch.stack([err * err, err.abs(), cbd])            # [3, n]
    if breakdown is None:
        masks = w[None, :]
    else:
        cu, ci, U, I = breakdown
        nu = (u >= U) | (cu[u.clamp(0, cu.shape[0] - 1)] == 0)
        ni = (i >= I) | (ci[i.clamp(0, ci.shape[0] - 1)] == 0)
        masks = torch.stack([torch.ones_like(w), nu.to(w.dtype),
                             ni.to(w.dtype), (nu & ni).to(w.dtype)]) * w
    k = u.shape[0] // _CHUNK
    per = per.reshape(3, k, _CHUNK)
    masks = masks.reshape(masks.shape[0], k, _CHUNK)
    sums = torch.einsum("jkc,mkc->mjk", per, masks)
    return sums, masks.sum(dim=-1)


def _with_times(recommender, test) -> bool:
    """A time-aware model on timed test data predicts with the times."""
    return getattr(recommender, "time_aware", False) and \
        test.times is not None


def _evaluate_indices(recommender, test, idx):
    """The host protocol over the test pairs ``idx`` from
    ``predict_batch`` (``predict_batch_time`` for a time-aware model on
    timed data) in float64, for models without a pair scorer (JAX:
    ``_evaluate_indices``)."""
    if idx.size == 0:
        return None
    actual = test.values[idx]
    users, items = test.users[idx], test.items[idx]
    if _with_times(recommender, test):
        pred = recommender.predict_batch_time(users, items, test.times[idx])
    else:
        pred = recommender.predict_batch(users, items)
    pred = np.asarray(pred, dtype=np.float64)
    err = pred - actual
    lo, hi = recommender.min_rating, recommender.max_rating
    return {
        "RMSE": float(np.sqrt(np.mean(err ** 2))),
        "MAE": float(np.mean(np.abs(err))),
        "NMAE": float(np.mean(np.abs(err)) / (hi - lo)),
        "CBD": float(np.mean(compute_cbd(actual, pred, lo, hi))),
    }


def _evaluate_host(recommender, test, training) -> RatingPredictionResults:
    all_idx = np.arange(len(test))
    results = RatingPredictionResults(
        _evaluate_indices(recommender, test, all_idx) or {})
    if training is not None:
        tu, ti = test.users, test.items
        cu, ci = training.count_by_user, training.count_by_item
        new_user = (tu >= training.num_users) | (np.where(
            tu < training.num_users,
            cu[np.minimum(tu, training.num_users - 1)], 0) == 0)
        new_item = (ti >= training.num_items) | (np.where(
            ti < training.num_items,
            ci[np.minimum(ti, training.num_items - 1)], 0) == 0)
        results.new_user_results = _evaluate_indices(
            recommender, test, all_idx[new_user])
        results.new_item_results = _evaluate_indices(
            recommender, test, all_idx[new_item])
        results.new_user_new_item_results = _evaluate_indices(
            recommender, test, all_idx[new_user & new_item])
    return results


def evaluate_ratings(recommender, test, training=None) -> RatingPredictionResults:
    """Full protocol, with the cold-start breakdown when ``training`` is
    given (reference Eval/Ratings.cs:82-92: new-user / new-item /
    new-user-new-item subsets by zero training count or unseen id).
    Models without a pair scorer (``RandomRating``) and a time-aware
    model on timed data take the host path through ``predict_batch`` or
    ``predict_batch_time``, as in the JAX package."""
    scorer = recommender.pair_scorer() \
        if len(test) and not _with_times(recommender, test) else None
    if scorer is None:
        return _evaluate_host(recommender, test, training)
    device = resolve_device(recommender.device)
    u, i, v, w = _device_eval_arrays(test, device)
    lo = float(recommender.min_rating)
    hi = float(recommender.max_rating)
    breakdown = None
    if training is not None:
        breakdown = (
            torch.from_numpy(np.asarray(training.count_by_user)).to(device),
            torch.from_numpy(np.asarray(training.count_by_item)).to(device),
            training.num_users, training.num_items)
    with torch.no_grad():
        sums, counts = _metric_sums(scorer, u, i, v, w, lo, hi, breakdown)
    sums = sums.cpu().numpy().astype(np.float64)        # [M, 3, k]
    counts = counts.cpu().numpy().astype(np.float64)    # [M, k]
    out = []
    for m in range(sums.shape[0]):
        c = counts[m].sum()
        if c == 0:
            out.append(None)
            continue
        se, ae, cb = sums[m].sum(axis=1)
        out.append({
            "RMSE": float(math.sqrt(se / c)),
            "MAE": float(ae / c),
            "NMAE": float(ae / c / (hi - lo)),
            "CBD": float(cb / c),
        })
    results = RatingPredictionResults(out[0] or {})
    if training is not None:
        results.new_user_results = out[1]
        results.new_item_results = out[2]
        results.new_user_new_item_results = out[3]
    return results


def compute_fit(recommender) -> float:
    """RMSE of the recommender on its own training data (reference
    Eval/Ratings.cs ComputeFit), from ``predict_batch`` in float64 as in
    the JAX package."""
    data = recommender.ratings
    pred = np.asarray(recommender.predict_batch(data.users, data.items),
                      dtype=np.float64)
    return float(np.sqrt(np.mean((pred - data.values) ** 2)))
