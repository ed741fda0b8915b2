"""Loss ids, the fused-table layout and the training objective of the
matrix-factorization family.

Port of the jax-free-able parts of ``mymedialite_tpu/ops/sgd.py``:
``_gradient_common`` (reference SetupLoss,
BiasedMatrixFactorization.cs:246-261), ``extend_tables`` /
``split_tables`` and ``mf_objective`` (reference ComputeObjective,
BiasedMatrixFactorization.cs:515-552), which the bold driver reads.
"""

from __future__ import annotations

import numpy as np
import torch

# Loss ids (reference OptimizationTarget enum, BiasedMatrixFactorization)
LOSS_RMSE = 0
LOSS_MAE = 1
LOSS_LOGISTIC = 2


def gradient_common(loss: int, err, sig, rating_range):
    """The per-example common gradient factor of the biased model."""
    if loss == LOSS_RMSE:
        return err * sig * (1.0 - sig) * rating_range
    if loss == LOSS_MAE:
        return torch.sign(err) * sig * (1.0 - sig) * rating_range
    if loss == LOSS_LOGISTIC:
        return err
    raise ValueError(f"unknown loss {loss}")


def _f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def extend_tables(user_factors, item_factors, user_bias=None, item_bias=None,
                  group_users: int = 16_384, device=None):
    """Build the fused [factors | b_u | 1] x [factors | 1 | b_i] tables
    from arrays or tensors, on ``device`` (default: where
    ``user_factors`` lies). The user table is padded to a multiple of
    group_users (the JAX package's std layout, kept so that tables pass
    between the two packages unchanged)."""
    W = _f32(user_factors, device)
    H = _f32(item_factors, W.device)
    U, f = W.shape
    G = min(group_users, max(U, 1))
    U_pad = max((U + G - 1) // G, 1) * G
    We = torch.zeros((U_pad, f + 2), dtype=torch.float32, device=W.device)
    We[:U, :f] = W
    if user_bias is not None:
        We[:U, f] = _f32(user_bias, W.device)
    We[:, f + 1] = 1.0
    He = torch.zeros((H.shape[0], f + 2), dtype=torch.float32,
                     device=W.device)
    He[:, :f] = H
    He[:, f] = 1.0
    if item_bias is not None:
        He[:, f + 1] = _f32(item_bias, W.device)
    return We, He


def split_tables(W_ext, H_ext, num_users: int):
    """Inverse of extend_tables; numpy (wu, hi, bu, bi)."""
    We = W_ext.detach().cpu().numpy()[:num_users]
    He = H_ext.detach().cpu().numpy()
    f = We.shape[1] - 2
    return We[:, :f], He[:, :f], We[:, f], He[:, f + 1]


def mf_objective(params: dict, data: dict, hp: dict, counts: dict, *,
                 loss: int, biased: bool) -> torch.Tensor:
    """Training objective = loss sum + count-weighted L2 complexity.

    params: user_factors [U, f], item_factors [I, f], global_bias, and
    if biased user_bias [U], item_bias [I]. data: users, items, values
    (every rating once). hp: min_rating, rating_range, reg_u, reg_i,
    bias_reg. counts: count_user [U], count_item [I]."""
    u, i, v = data["users"], data["items"], data["values"]
    wu = params["user_factors"][u]
    hi = params["item_factors"][i]
    dot = (wu * hi).sum(dim=-1)
    if biased:
        score = params["global_bias"] + params["user_bias"][u] + \
            params["item_bias"][i] + dot
        pred = hp["min_rating"] + torch.sigmoid(score) * hp["rating_range"]
    else:
        pred = params["global_bias"] + dot

    if loss == LOSS_RMSE:
        loss_sum = ((v - pred) ** 2).sum()
    elif loss == LOSS_MAE:
        loss_sum = (v - pred).abs().sum()
    else:  # logistic, on [0,1]-normalized values
        a = (v - hp["min_rating"]) / hp["rating_range"]
        p01 = ((pred - hp["min_rating"]) / hp["rating_range"]).clamp(
            1e-15, 1 - 1e-15)
        loss_sum = -(a * torch.log(p01) + (1 - a) * torch.log1p(-p01)).sum()

    wu_reg = counts["count_user"].to(torch.float32) * hp["reg_u"]
    wi_reg = counts["count_item"].to(torch.float32) * hp["reg_i"]
    complexity = (wu_reg * (params["user_factors"] ** 2).sum(-1)).sum()
    complexity = complexity + \
        (wi_reg * (params["item_factors"] ** 2).sum(-1)).sum()
    if biased:
        complexity = complexity + \
            (wu_reg * hp["bias_reg"] * params["user_bias"] ** 2).sum()
        complexity = complexity + \
            (wi_reg * hp["bias_reg"] * params["item_bias"] ** 2).sum()
    return loss_sum + complexity
