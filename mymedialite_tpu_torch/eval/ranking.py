"""Item-recommendation (ranking) evaluation of the port.

Port of ``mymedialite_tpu/eval/ranking.py`` ``evaluate_items``
(reference ``Eval/Items.cs:62-209``), with the same protocol: candidate
modes TRAINING / TEST / OVERLAP / UNION / EXPLICIT, the per-user skip
rules, training items ignored unless ``repeated_events``, list length
``n``, and measures averaged over the evaluated users. The candidate
sets and the per-batch measure math (``candidates_for_mode``,
``_measures_batch``) are copies of the JAX package's jax-free helpers.

Per batch of users, the score-and-rank step runs in torch on the
device of the model's tables (``tables_device``): the model's
``catalog_scorer`` (one matmul; host ``score_catalog`` for models
without one), the candidate and ignore
masks, and the stable descending rank of each correct item — # greater
+ # equal with a smaller index, -inf ties included — read off a stable
``torch.sort``.

Data-parallel over a mesh (JAX ``eval/ranking.py:270-300``): where the
recommender has a mesh (``model_mesh``) and a catalog scorer, the batch
(a multiple of the devices) splits into one equal part per mesh device,
the ragged tail padded with its last user as the JAX package pads it;
each device scores and ranks its part against its replica of the
scoring tables (``catalog_scorer(device)``) and the candidate mask, and the
measure sums are taken on the host over the batch's real users: the
numbers of one device. The models whose JAX counterparts have a
``catalog_scorer`` -- the MF family (SocialMF included), the BPR family
and WRMF, SLIM and the SVD++ family -- take the default mesh of every
visible card, as the JAX eval shards over ``jax.devices()``; their
``mesh = None`` keeps one device. KNN, the baselines, the time-aware
models and the externals, which the JAX package scores on the host, have
no ``mesh``: they rank on one device unless one is set by hand.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from mymedialite_tpu_torch.eval.results import ItemRecommendationResults
from mymedialite_tpu_torch.parallel.mesh import model_mesh


def candidates_for_mode(mode: str, test, training,
                        explicit: Optional[Sequence[int]] = None) -> np.ndarray:
    """Candidate item set (reference Items.Candidates, Eval/Items.cs:62-96)."""
    mode = mode.upper()
    test_items = test.all_items if test is not None else np.array([], dtype=np.int32)
    if mode == "TRAINING":
        return np.asarray(training.all_items)
    if mode == "TEST":
        return np.asarray(test_items)
    if mode == "OVERLAP":
        return np.intersect1d(test_items, training.all_items)
    if mode == "UNION":
        return np.union1d(test_items, training.all_items)
    if mode == "EXPLICIT":
        if explicit is None:
            raise ValueError("EXPLICIT mode requires a candidate_items list")
        return np.unique(np.asarray(list(explicit), dtype=np.int64))
    raise ValueError(f"Unknown candidate_item_mode: {mode}")


def _measures_batch(ranks, m_arr, n_cand_arr, n, sums):
    """Vectorized ``_user_measures`` over a [B, P2] rank matrix (the
    per-user loop was the steady-state bottleneck of ranking eval at
    bench scale). Rows hold the kernel's ranks for each user's correct
    slots; pad slots return num_items-scale sentinels that sort past
    every real rank. Accumulates measure sums into ``sums`` and returns
    the number of evaluated users. Copied from the JAX package with
    its candidate helper; tests hold the two equal."""
    B, P2 = ranks.shape
    m = m_arr.astype(np.int64)
    n_cand = n_cand_arr.astype(np.int64)
    ok = (m > 0) & (m != n_cand)       # reference Items.cs:152-163
    if not ok.any():
        return 0
    ranks = np.sort(ranks, axis=1).astype(np.int64)
    slot = np.arange(P2, dtype=np.int64)[None, :]
    L = n_cand if n < 0 else np.minimum(n, n_cand)
    valid = slot < m[:, None]
    in_mask = valid & (ranks < L[:, None])
    m_in = in_mask.sum(axis=1)
    m_safe = np.maximum(m, 1)

    # AUC with dropped-items correction (AUC.cs:42-68); sorted ranks
    # make the in-list exactly the first m_in valid slots, so the
    # in-list position k equals the slot index
    dropped = n_cand - L
    pairs = (n_cand - m_in) * m_in
    term = np.where(in_mask,
                    (L[:, None] - 1 - ranks) - (m_in[:, None] - 1 - slot),
                    0)
    missing_relevant = m - m_in
    bad = ok & (pairs > 0) & (dropped - missing_relevant < 0)
    if bad.any():
        raise ValueError(
            "more missing relevant items than dropped items — "
            "train/test overlap with full-list evaluation (reference "
            "AUC.cs:64 'Should not happen')")
    correct_pairs = term.sum(axis=1) + m_in * (dropped - missing_relevant)
    auc = np.where(pairs > 0, correct_pairs / np.maximum(pairs, 1), 0.5)

    # AP (PrecisionAndRecall.cs:45-66)
    ap = np.where(in_mask, (slot + 1) / (ranks + 1.0), 0.0).sum(axis=1) \
        / m_safe
    # NDCG (NDCG.cs:36-55): idcg via one cumulative table over max m
    dcg = np.where(in_mask, 1.0 / np.log2(ranks + 2.0), 0.0).sum(axis=1)
    max_m = int(m.max())
    idcg_tab = np.concatenate(
        [[1.0], np.cumsum(1.0 / np.log2(np.arange(max_m) + 2))])
    ndcg = dcg / idcg_tab[np.minimum(m, max_m)]
    # MRR (ReciprocalRank.cs:39-56): smallest rank = sorted slot 0
    mrr = np.where(m_in > 0, 1.0 / (ranks[:, 0] + 1.0), 0.0)

    okf = ok.astype(np.float64)
    sums["AUC"] += float((auc * okf).sum())
    sums["MAP"] += float((ap * okf).sum())
    sums["NDCG"] += float((ndcg * okf).sum())
    sums["MRR"] += float((mrr * okf).sum())
    # prec@/recall@ (PrecisionAndRecall.cs:68-141)
    for N in (5, 10):
        cut = np.minimum(N, L)
        hits = (valid & (ranks < cut[:, None])).sum(axis=1)
        sums[f"prec@{N}"] += float((hits / N * okf).sum())
        sums[f"recall@{N}"] += float((hits / m_safe * okf).sum())
    return int(ok.sum())


def ragged_rows(csr, batch, num_rows: int, width: int, pad: int):
    """[len(batch), width] int64: row r holds the CSR keys of user
    batch[r] in their order (sorted item ids), then ``pad``; users >=
    ``num_rows`` get empty rows. One vectorised gather, no loop over the
    users."""
    B = batch.size
    out = np.full((B, width), pad, np.int64)
    if num_rows == 0:
        return out
    u = np.minimum(batch.astype(np.int64), num_rows - 1)
    ok = batch < num_rows
    starts = np.where(ok, csr.indptr[u], 0)
    cnt = np.where(ok, csr.indptr[u + 1] - csr.indptr[u], 0)
    total = int(cnt.sum())
    if total:
        row = np.repeat(np.arange(B), cnt)
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(cnt) - cnt, cnt)
        out[row, within] = csr.keys[np.repeat(starts, cnt) + within]
    return out


def row_counts(csr, users, num_rows: int) -> np.ndarray:
    """Per-user CSR row lengths, 0 for users >= ``num_rows``."""
    if num_rows == 0:
        return np.zeros(users.size, np.int64)
    u = np.minimum(users.astype(np.int64), num_rows - 1)
    return np.where(users < num_rows, csr.indptr[u + 1] - csr.indptr[u], 0)


def rank_correct_items(scores, cand_mask, ignore_rows, correct_rows,
                       num_items: int):
    """[B, P2] int64 ranks of ``correct_rows`` in each row's stable
    descending order of ``scores`` [B, <= num_items] after masking:
    non-candidates and ``ignore_rows`` get -inf, items past the scores'
    width -1e30. Pad entries (== num_items) of ``correct_rows`` get rank
    ``num_items``; pad entries of ``ignore_rows`` are dropped."""
    B = scores.shape[0]
    dev = scores.device
    if scores.shape[1] < num_items:
        # items unknown to the model rank last, deterministically
        scores = torch.cat([scores, torch.full(
            (B, num_items - scores.shape[1]), -1e30, dtype=scores.dtype,
            device=dev)], dim=1)
    s = torch.where(cand_mask[None, :], scores, float("-inf"))
    # one spare column takes the pad entries of the ignore rows
    s = torch.cat([s, torch.zeros((B, 1), dtype=s.dtype, device=dev)], 1)
    s.scatter_(1, ignore_rows, float("-inf"))
    s = s[:, :num_items]
    order = torch.sort(s, dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(num_items, device=dev).expand(B, -1))
    r = rank.gather(1, correct_rows.clamp(max=num_items - 1))
    return torch.where(correct_rows < num_items, r,
                       torch.full_like(r, num_items))


def _ranks_on_mesh(mesh, scorers, masks, batch, ignore_rows, correct_rows,
                   num_items: int) -> np.ndarray:
    """The batch's rank rows, its users split into one equal part per
    global mesh device, each of this process's parts scored and ranked on
    its device; every process's rows gathered on the host."""
    part = batch.size // mesh.global_size
    out = []
    for d, dev in enumerate(mesh.devices):
        g = mesh.first_device + d
        sl = slice(g * part, (g + 1) * part)
        scores = scorers[d](torch.from_numpy(batch[sl].astype(np.int64))
                            .to(dev))
        out.append(rank_correct_items(
            scores, masks[d], torch.from_numpy(ignore_rows[sl]).to(dev),
            torch.from_numpy(correct_rows[sl]).to(dev), num_items))
    return mesh.gather_rows(out, "cpu").numpy()


def evaluate_items(recommender, test, training,
                   test_users: Optional[Sequence[int]] = None,
                   candidate_items: Optional[Sequence[int]] = None,
                   candidate_item_mode: str = "OVERLAP",
                   repeated_events: bool = False,
                   n: int = -1,
                   batch_size: int = 512) -> ItemRecommendationResults:
    """Ranking evaluation (reference Eval/Items.Evaluate,
    Items.cs:126-209)."""
    if test_users is None:
        test_users = test.all_users
    test_users = np.asarray(test_users, dtype=np.int32)
    cand = candidates_for_mode(candidate_item_mode, test, training,
                               candidate_items)
    num_items = max(recommender.num_items_trained,
                    int(cand.max()) + 1 if cand.size else 0,
                    training.num_items, test.num_items)
    cand_mask = np.zeros(num_items, dtype=bool)
    cand_mask[cand] = True
    num_candidates = int(cand_mask.sum())

    scorer = recommender.catalog_scorer()
    dev = recommender.tables_device()
    cand_mask_dev = torch.from_numpy(cand_mask).to(dev)
    mesh = model_mesh(recommender) if scorer is not None else None
    if mesh is not None:
        D = mesh.global_size
        batch_size = max(-(-batch_size // D), 1) * D
        scorers = [recommender.catalog_scorer(d) for d in mesh.devices]
        masks = mesh.replicate(cand_mask_dev)
    cand_mask_ext = np.append(cand_mask, False)   # pad id num_items
    te_csr = test.by_user
    tr_csr = None if repeated_events else training.by_user

    def row_width(csr, num_rows):
        if test_users.size == 0:
            return 1
        return max(int(row_counts(csr, test_users, num_rows).max()), 1)

    def first_of_each(mat):
        """First occurrence of each real item per (sorted) row."""
        keep = mat < num_items
        keep[:, 1:] &= mat[:, 1:] != mat[:, :-1]
        return keep

    w_ignore = 1 if tr_csr is None else row_width(tr_csr, training.num_users)
    w_correct = row_width(te_csr, test.num_users)
    sums = {m: 0.0 for m in ItemRecommendationResults.ALL_MEASURES}
    num_evaluated = 0
    for start in range(0, test_users.size, batch_size):
        batch = test_users[start:start + batch_size]
        nreal = batch.size
        if mesh is not None:
            target = batch_size if test_users.size > batch_size else \
                max(-(-nreal // D) * D, D)
            # the ragged tail padded with its last user (JAX)
            batch = np.concatenate([batch, np.full(target - nreal, batch[-1],
                                                   dtype=batch.dtype)])
        if tr_csr is not None:
            tmat = ragged_rows(tr_csr, batch, training.num_users, w_ignore,
                               num_items)
            tkeep = first_of_each(tmat)
            ignore_rows = np.where(tkeep, tmat, num_items)
            ignored_in_cand = (tkeep & cand_mask_ext[tmat]).sum(axis=1)
        else:
            ignore_rows = np.full((batch.size, 1), num_items, np.int64)
            ignored_in_cand = np.zeros(batch.size, np.int64)
        cmat = ragged_rows(te_csr, batch, test.num_users, w_correct,
                           num_items)
        ckeep = first_of_each(cmat) & cand_mask_ext[cmat]
        correct_rows = np.sort(np.where(ckeep, cmat, num_items), axis=1)
        with torch.no_grad():
            if mesh is not None:
                ranks = _ranks_on_mesh(mesh, scorers, masks, batch,
                                       ignore_rows, correct_rows, num_items)
            else:
                if scorer is not None:
                    scores = scorer(torch.from_numpy(batch.astype(np.int64))
                                    .to(dev))
                else:
                    scores = torch.from_numpy(np.asarray(
                        recommender.score_catalog(batch), dtype=np.float32)
                        ).to(dev)
                ranks = rank_correct_items(
                    scores, cand_mask_dev,
                    torch.from_numpy(ignore_rows).to(dev),
                    torch.from_numpy(correct_rows).to(dev),
                    num_items).cpu().numpy()
        num_evaluated += _measures_batch(
            ranks[:nreal], ckeep.sum(axis=1)[:nreal],
            (num_candidates - ignored_in_cand)[:nreal], n, sums)

    result = ItemRecommendationResults()
    for key in sums:
        result[key] = sums[key] / num_evaluated if num_evaluated else 0.0
    result["num_users"] = num_evaluated
    result["num_lists"] = num_evaluated
    result["num_items"] = int(cand.size)
    return result
