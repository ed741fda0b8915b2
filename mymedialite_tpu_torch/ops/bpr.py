"""BPR objective and the uniform-user triple sampler of the port.

Counterparts of ``mymedialite_tpu/ops/bpr.py`` ``bpr_objective`` and
the uniform-user branch of ``_sample_triples`` (with
``_sample_negatives``), which the models use for the fixed
convergence-loss sample (reference ``BPRMF.cs:135-150``). Training runs
the fused epoch of ``ops/bpr_epoch.py``; the JAX package's XLA
minibatch epoch has no counterpart here.

The sampler draws from a ``torch.Generator``, so it gives other triples
than the JAX package's threefry draws from the same seed; the regime is
the same: user ~ Uniform(users with 0 < |I_u| < num_items), positive ~
Uniform(I_u), negative = the first of ``trials`` uniform draws outside
I_u (the first draw when all hit positives).
"""

from __future__ import annotations

import numpy as np
import torch


def bpr_objective(params, hp, loss_u, loss_i, loss_j) -> torch.Tensor:
    """BPR-Opt on a fixed triple sample: sum of ln(1 + e^-x) plus the L2
    complexity of the touched rows (JAX ``ops/bpr.py:204``)."""
    wu = params["user_factors"][loss_u]
    hi = params["item_factors"][loss_i]
    hj = params["item_factors"][loss_j]
    bi, bj = params["item_bias"][loss_i], params["item_bias"][loss_j]
    x = bi - bj + (wu * (hi - hj)).sum(dim=-1)
    ranking_loss = torch.log1p(torch.exp(-x)).sum()
    complexity = (hp["reg_u"] * (wu ** 2).sum()
                  + hp["reg_i"] * (hi ** 2).sum()
                  + hp["reg_j"] * (hj ** 2).sum()
                  + hp["bias_reg"] * (bi ** 2).sum()
                  + hp["bias_reg"] * (bj ** 2).sum())
    return ranking_loss + complexity


def sample_uniform_user_triples(feedback, n: int, trials: int,
                                generator: torch.Generator, device):
    """``n`` (u, i, j) int64 tensors on ``device`` from the uniform-user
    regime, drawn with ``generator`` (a generator of ``device``)."""
    U, I = feedback.num_users, feedback.num_items
    users = torch.from_numpy(np.asarray(feedback.users, np.int64)).to(device)
    items = torch.from_numpy(np.asarray(feedback.items, np.int64)).to(device)
    counts = torch.bincount(users, minlength=U)
    valid = torch.nonzero((counts > 0) & (counts < I)).flatten()
    if valid.numel() == 0:
        valid = torch.zeros(1, dtype=torch.int64, device=device)
    # events grouped by user: user u's items are hist[indptr[u]:indptr[u+1]]
    by_user = torch.sort(users, stable=True).indices
    hist = items[by_user]
    indptr = torch.zeros(U + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(counts, 0)
    pos_keys = torch.sort(users * I + items).values

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=generator,
                             device=device)

    u = valid[randint(valid.numel(), (n,))]
    off = randint(2 ** 31 - 1, (n,)) % counts[u].clamp(min=1)
    i = hist[(indptr[u] + off).clamp(max=max(hist.numel() - 1, 0))]
    cand = randint(max(I, 1), (trials, n))
    key = u[None, :] * I + cand
    at = torch.searchsorted(pos_keys, key).clamp(max=max(pos_keys.numel() - 1,
                                                          0))
    is_pos = pos_keys[at] == key
    first = (~is_pos).to(torch.uint8).argmax(0, keepdim=True)
    j = cand.gather(0, first).squeeze(0)
    return u, i, j
