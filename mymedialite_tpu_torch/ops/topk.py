"""Full-catalog top-k recommendation of the port.

Counterpart of ``mymedialite_tpu/ops/topk.py`` ``recommend_batch`` (an
XLA matmul + ``lax.top_k`` there, not a Pallas kernel): per block of
users, the model's catalog scores with the user's training items and the
non-candidates masked to -3e38, then the k best. It serves the
item_recommendation CLI's ``--prediction-file``. Ties go to the smaller
item id, as in ``lax.top_k``: the k best are read off a stable
descending sort, since ``torch.topk`` leaves the order of ties open.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -3.0e38


def recommend_batch(recommender, users, n: int, training=None,
                    candidates=None, block: int = 1024):
    """Top-n items per user, each user's training items excluded.
    Returns (ids [len(users), n] int32, scores float32) numpy arrays;
    slots past the number of scoreable items hold id -1."""
    users = np.asarray(users, dtype=np.int32)
    num_items = recommender.num_items_trained
    scorer = recommender.catalog_scorer()
    dev = recommender.params["user_factors"].device if scorer is not None \
        else torch.device("cpu")
    cand_mask = torch.ones(num_items, dtype=torch.bool)
    if candidates is not None:
        cand_mask[:] = False
        cand = np.asarray(list(candidates), dtype=np.int64)
        cand_mask[torch.from_numpy(cand[(cand >= 0) & (cand < num_items)])] = \
            True
    cand_mask = cand_mask.to(dev)
    k = min(n, num_items)
    out_ids = np.full((users.size, n), -1, dtype=np.int32)
    out_scores = np.full((users.size, n), -np.inf, dtype=np.float32)
    for start in range(0, users.size, block):
        batch = users[start:start + block]
        with torch.no_grad():
            if scorer is not None:
                scores = scorer(torch.from_numpy(batch.astype(np.int64))
                                .to(dev))
            else:
                scores = torch.from_numpy(np.asarray(
                    recommender.score_catalog(batch), dtype=np.float32))
            scores = torch.where(cand_mask[None, :], scores, NEG_INF)
            if training is not None:
                counts = np.where(batch < training.num_users,
                                  training.count_by_user[
                                      np.minimum(batch, training.num_users - 1)],
                                  0)
                P = max(int(counts.max()) if batch.size else 1, 1)
                ignore = np.full((batch.size, P), num_items, dtype=np.int64)
                for r, u in enumerate(batch):
                    if u < training.num_users:
                        items_u = training.items_by_user(int(u))
                        ignore[r, :items_u.size] = items_u
                scores = torch.cat([scores, torch.zeros(
                    (batch.size, 1), dtype=scores.dtype, device=dev)], 1)
                scores.scatter_(1, torch.from_numpy(ignore).to(dev), NEG_INF)
                scores = scores[:, :num_items]
            s, ids = torch.sort(scores, dim=1, descending=True, stable=True)
            s, ids = s[:, :k].cpu().numpy(), ids[:, :k].cpu().numpy()
        ids = ids.astype(np.int32)
        ids[s <= np.float32(NEG_INF)] = -1
        out_ids[start:start + block, :k] = ids
        out_scores[start:start + block, :k] = s
    return out_ids, out_scores
