"""SocialMF: matrix factorization with social (trust) regularization.

Counterpart of ``mymedialite_tpu/models/social_mf.py`` (reference
``RatingPrediction/SocialMF.cs``, Jamali & Ester, RecSys 2010):
BiasedMatrixFactorization's prediction, with a regularizer that pulls
each user's factors toward the mean factors of the users they trust,
trained by full-batch gradient descent (reference IterateBatch
:77-191). The gradient of a step is the rating error's (``err = pred -
rating``, through ``ops/sgd.py gradient_common``), one ``ops/sgd.py
add_rows`` a side (the same bits in any order of its sum), plus L2 on
the factor and bias columns (the column of 1s stays frozen), plus the social term on the users' factor and bias columns

    social_reg * [D (P - T P) - T^T D (P - T P)]

with T the row-normalized trust matrix and D the users with at least
one trusted user. The JAX package builds T densely ([U, U]: 9.7 GB at
the Epinions shape, 922 GB at Netflix's) and takes two matmuls; the
port keeps T and T^T as ``torch.sparse_csr_tensor``s and takes two
``torch.sparse.mm``. ``update_learn_rate`` runs after every step.

SocialMF trains by its own ``iterate`` and never builds BiasedMF's
chunk plan: it launches no kernel of ``csrc/``. The user space grows to
cover users who appear only in the trust relation (reference
InitModel :57-66).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from mymedialite_tpu_torch.device import resolve_device
from mymedialite_tpu_torch.models.mf import BiasedMatrixFactorization
from mymedialite_tpu_torch.ops import sgd


def trust_matrices(trusters, trusted, num_users: int, device,
                   dtype=torch.float32):
    """(T, T^T, has_conn): the row-normalized trust matrix of the edges
    (trusters[k] trusts trusted[k]) and its transpose as CSR tensors
    [num_users, num_users] on ``device``, and the float mask of users
    with an edge. Duplicate edges count once; edges past ``num_users``
    are dropped (the JAX package's dense assignment)."""
    u = torch.as_tensor(np.asarray(trusters, dtype=np.int64), device=device)
    v = torch.as_tensor(np.asarray(trusted, dtype=np.int64), device=device)
    keep = (u >= 0) & (v >= 0) & (u < num_users) & (v < num_users)
    key = torch.unique(u[keep] * num_users + v[keep])      # sorted
    rows, cols = key // num_users, key % num_users
    counts = torch.bincount(rows, minlength=num_users)
    vals = (1.0 / counts.to(torch.float64))[rows].to(dtype)

    def csr(r, c, x):
        crow = torch.zeros(num_users + 1, dtype=torch.int64, device=device)
        crow[1:] = torch.cumsum(torch.bincount(r, minlength=num_users), 0)
        with warnings.catch_warnings():
            # the beta notice, and the invariant-check notice that some
            # builds give even with check_invariants passed
            warnings.filterwarnings("ignore", "Sparse CSR tensor support")
            warnings.filterwarnings("ignore", "Sparse invariant checks")
            return torch.sparse_csr_tensor(
                crow, c, x, (num_users, num_users), dtype=dtype,
                device=device, check_invariants=False)
    T = csr(rows, cols, vals)
    order = torch.argsort(cols * num_users + rows)
    Tt = csr(cols[order], rows[order], vals[order])
    return T, Tt, (counts > 0).to(dtype)


def social_mf_step(W, H, data, trust, hp, *, num_users: int,
                   num_factors: int, loss: int, update_user: bool = True,
                   update_item: bool = True):
    """One full-batch step on the fused tables (JAX ``_social_mf_step``);
    returns the new (W, H). ``data`` holds the ratings (users, items,
    values), ``trust`` is ``trust_matrices``'s triple, ``hp`` the
    scalars (global_bias, min_rating, rating_range, learn_rate,
    bias_learn_rate, reg_u, reg_i, bias_reg, social_reg). Computes in
    the tables' dtype."""
    f, U = num_factors, num_users
    u, i, v = data["users"], data["items"], data["values"]
    T, Tt, has_conn = trust
    dtype, dev = W.dtype, W.device
    wu, hi = W[u], H[i]
    sig = torch.sigmoid(hp["global_bias"] + (wu * hi).sum(dim=-1))
    pred = hp["min_rating"] + sig * hp["rating_range"]
    err = pred - v.to(dtype)     # the reference's prediction - rating
    g = sgd.gradient_common(loss, err, sig, hp["rating_range"])

    def cols(*values):
        return torch.tensor(values, dtype=dtype, device=dev)
    f32 = np.float32
    reg_u, reg_i, lr = f32(hp["reg_u"]), f32(hp["reg_i"]), \
        f32(hp["learn_rate"])
    b_reg, b_lr = f32(hp["bias_reg"]), f32(hp["bias_learn_rate"])
    w_l2 = cols(*([reg_u] * f + [reg_u * b_reg, 0.0]))
    h_l2 = cols(*([reg_i] * f + [0.0, reg_i * b_reg]))
    w_lr = cols(*([lr] * f + [lr * b_lr, 0.0]))
    h_lr = cols(*([lr] * f + [0.0, lr * b_lr]))

    grad_W = sgd.add_rows(torch.zeros_like(W), u, g[:, None] * hi)
    grad_H = sgd.add_rows(torch.zeros_like(H), i, g[:, None] * wu)
    grad_W += W * w_l2
    grad_H += H * h_l2

    # the social term on the users' factor and bias columns
    P = W[:U, :f + 1].contiguous()
    M1 = has_conn[:, None] * (P - torch.sparse.mm(T, P))
    grad_W[:U, :f + 1] += float(f32(hp["social_reg"])) * (
        M1 - torch.sparse.mm(Tt, M1))
    if update_user:
        W = W - grad_W * w_lr
    if update_item:
        H = H - grad_H * h_lr
    return W, H


class SocialMF(BiasedMatrixFactorization):
    REQUIRED_SIDE_INFO = ("user_relation",)
    HYPERPARAMS = dict(BiasedMatrixFactorization.HYPERPARAMS,
                       social_regularization=float)

    def __init__(self):
        super().__init__()
        self.social_regularization = 1.0
        self.user_relation = None   # trust edges: user -> trusted user
        self._trust = None

    def init_model(self, tables=None):
        # grow the user space to cover relation-only users
        # (reference SocialMF.InitModel :57-66)
        rel = self.user_relation
        if rel is not None and len(rel):
            n = max(rel.num_users, rel.num_items)
            if n > self.ratings.num_users:
                self.ratings = self.ratings.select(
                    np.arange(len(self.ratings)), num_users=n)
        super().init_model(tables)

    def _prepare_epoch_data(self):
        """No chunk plan and no blocked layout: the trust matrices and
        the flat ratings of the full-batch step."""
        self._sync_std_tables()
        self._plan = None
        self._blocked = None
        self._flat_cache = None
        self._trust = None

    def _ensure_epoch_ready(self):
        """Build the trust matrices when missing (a loaded model, or
        after an incremental update)."""
        if self.ratings is None:
            raise RuntimeError(
                f"{type(self).__name__}: no ratings set; assign "
                ".ratings before iterating a loaded model")
        if self._trust is None:
            U = self.num_users_trained
            rel = self.user_relation
            dev = resolve_device(self.device)
            if rel is None:
                empty = np.zeros(0, np.int64)
                self._trust = trust_matrices(empty, empty, U, dev)
            else:
                self._trust = trust_matrices(rel.users, rel.items, U, dev)

    def _drop_epoch_state(self):
        super()._drop_epoch_state()
        self._trust = None

    def _hp(self):
        return dict(global_bias=float(np.float32(self.global_bias)),
                    min_rating=float(np.float32(self.min_rating)),
                    rating_range=float(np.float32(self._rating_range())),
                    learn_rate=self.current_learnrate,
                    bias_learn_rate=self.bias_learn_rate,
                    reg_u=self.reg_u, reg_i=self.reg_i,
                    bias_reg=self.bias_reg,
                    social_reg=self.social_regularization)

    def iterate(self, update_user: bool = True, update_item: bool = True):
        self._ensure_epoch_ready()
        data, _ = self._flat_data()
        with torch.no_grad():
            self.W_ext, self.H_ext = social_mf_step(
                self.W_ext, self.H_ext, data, self._trust, self._hp(),
                num_users=self.num_users_trained,
                num_factors=self.num_factors, loss=self.loss_id,
                update_user=update_user, update_item=update_item)
        self.update_learn_rate()
