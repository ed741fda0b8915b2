"""Full-catalog top-k recommendation of the port.

Counterpart of ``mymedialite_tpu/ops/topk.py`` (``topk_from_factors``
and ``recommend_batch``: an XLA matmul + ``lax.top_k`` there). It serves
the item_recommendation CLI's ``--prediction-file``. Per block of users,
each user's training items and the non-candidates are excluded, then the
k best are taken, ties going to the smaller item id as in
``lax.top_k``. Two routes, fixed by the model and k, never by a failure:

- the fused top-k kernel (``ops/catalog_topk.py``, kernel 6) for models
  with ``fused_rows`` (the BPR family) whose tables are on a CUDA device,
  when k = min(n, num_items) <= ``MAX_K``: the fused rows padded once
  to 16-byte rows, then per block a [B, N] byte mask made on the card (0
  for the non-candidates and the user's training items) and one call on
  the block's rows;
- the model's catalog scores with those items set to -3e38 and a stable
  descending sort (``torch.topk`` leaves the order of ties open)
  otherwise: the full list (k past 64, where the JAX package also leaves
  its Pallas kernel for XLA), the rating models (``fused_rows`` explains
  why), MostPopular, and every model on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from mymedialite_tpu_torch.eval.ranking import ragged_rows, row_counts
from mymedialite_tpu_torch.ops.catalog_topk import (
    MAX_K, catalog_topk, pad_columns,
)

NEG_INF = -3.0e38


def topk_from_factors(user_rows, item_table, ignore_rows, cand_mask, *,
                      k: int):
    """Top-k items for a block of users (JAX ``topk_from_factors``).

    user_rows [B, f], item_table [N, f] float32; ignore_rows [B, P] int
    items to exclude per user, padded with an id >= N; cand_mask [N]
    float 1/0. Returns (ids [B, k] int32, scores [B, k])."""
    scores = user_rows @ item_table.T
    scores = scores.masked_fill(cand_mask[None, :] <= 0, NEG_INF)
    B, N = scores.shape
    if ignore_rows.shape[1] > 0:
        rows = torch.arange(B, device=scores.device)[:, None].expand_as(
            ignore_rows)
        keep = ignore_rows < N
        scores[rows[keep], ignore_rows[keep].long()] = NEG_INF
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return ids[:, :k].to(torch.int32), vals[:, :k]


def takes_topk_kernel(recommender, k: int) -> bool:
    """Whether ``recommend_batch`` serves this model and k through the
    fused top-k kernel."""
    return (hasattr(recommender, "fused_rows") and k <= MAX_K
            and recommender.tables_device().type == "cuda")


def recommend_batch(recommender, users, n: int, training=None,
                    candidates=None, block: int = 1024):
    """Top-n items per user, each user's training items excluded.
    Returns (ids [len(users), n] int32, scores float32) numpy arrays;
    slots past the number of scoreable items hold id -1."""
    users = np.asarray(users, dtype=np.int32)
    num_items = recommender.num_items_trained
    k = min(n, num_items)
    dev = recommender.tables_device()
    fused = takes_topk_kernel(recommender, k)
    if fused:
        # 16-byte rows for the kernel, padded once per pass
        user_rows, item_rows = (pad_columns(t)
                                for t in recommender.fused_rows())
    else:
        scorer = recommender.catalog_scorer()
    cand_mask = torch.ones(num_items, dtype=torch.bool)
    if candidates is not None:
        cand_mask[:] = False
        cand = np.asarray(list(candidates), dtype=np.int64)
        cand_mask[torch.from_numpy(cand[(cand >= 0) & (cand < num_items)])] = \
            True
    cand_mask = cand_mask.to(dev)
    out_ids = np.full((users.size, n), -1, dtype=np.int32)
    out_scores = np.full((users.size, n), -np.inf, dtype=np.float32)
    for start in range(0, users.size, block):
        batch = users[start:start + block]
        B = batch.size
        ignore = None
        if training is not None:
            csr = training.by_user
            P = max(int(row_counts(csr, batch, training.num_users).max()), 1)
            ignore = torch.from_numpy(ragged_rows(
                csr, batch, training.num_users, P, num_items)).to(dev)
        u = torch.from_numpy(batch.astype(np.int64)).to(dev)
        with torch.no_grad():
            if fused:
                mask = cand_mask.to(torch.int8).expand(B, -1).contiguous()
                if ignore is not None:
                    rows = torch.arange(B, device=dev)[:, None].expand_as(
                        ignore)
                    keep = ignore < num_items
                    mask[rows[keep], ignore[keep]] = 0
                ids, s = catalog_topk(
                    user_rows[u.clamp(0, user_rows.shape[0] - 1)], item_rows,
                    mask, k=k)
            else:
                if scorer is not None:
                    scores = scorer(u)
                else:
                    scores = torch.from_numpy(np.asarray(
                        recommender.score_catalog(batch), dtype=np.float32)
                        ).to(dev)
                scores = torch.where(cand_mask[None, :], scores, NEG_INF)
                if ignore is not None:
                    # one spare column takes the pad entries
                    scores = torch.cat([scores, torch.zeros(
                        (B, 1), dtype=scores.dtype, device=dev)], 1)
                    scores.scatter_(1, ignore, NEG_INF)
                    scores = scores[:, :num_items]
                s, ids = torch.sort(scores, dim=1, descending=True,
                                    stable=True)
                s, ids = s[:, :k], ids[:, :k]
            s, ids = s.cpu().numpy(), ids.cpu().numpy()
        ids = ids.astype(np.int32)
        ids[s <= np.float32(NEG_INF)] = -1
        out_ids[start:start + block, :k] = ids
        out_scores[start:start + block, :k] = s
    return out_ids, out_scores
