"""SLIM: sparse linear item-item models of the port.

Counterparts of ``mymedialite_tpu/models/slim.py`` (reference
``ItemRecommendation/SLIM.cs:45``: the score of item i for user u is
sum_{k in I_u} W[i, k]; ``LeastSquareSLIM.cs:55``: elastic-net
coordinate descent with k-nearest-neighbour feature selection;
``BPRSLIM.cs:56``: W trained on BPR triples). W is a dense [I, I]
float32 table on the model's device, as in the JAX package.

- LeastSquareSLIM: the JAX package's Jacobi sweep, damped by 0.5: one
  [I, I] x [I, I] product W C with the co-occurrence C = M^T M, then the
  soft-threshold and the feature mask; in float32 without TF32
  (``device.exact_float32``). C comes from the int8 item-major
  incidence of ``ops/correlation.py`` (``_int8_table``) through
  ``torch._int_mm``, exact in int32; the column counts ``cj`` are its
  diagonal. The mask keeps each item's k most cosine-similar items
  (``binary_correlation_topk`` over the item-major view).
- BPRSLIM: batches of triples from ``ops/bpr.py sample_triples``; per
  triple the rows W[i, I_u] and W[j, I_u] are gathered over the user's
  padded history (duplicates of an item counted once), and the deltas
  go back with ``ops/sgd.py add_rows`` (the same bits in any order of
  its sum) into the flat view of W (the JAX package
  writes the same update as one-hot [B, I] matmuls, a TPU idiom).
  Duplicate (row, column) pairs of a batch sum; k = i is skipped in the
  i-row and k = j in the j-row; every triple reads the batch's starting
  W. The padded history [U, L_max] is built on the device from the
  sampling state, with no loop over the users.

Both are incremental: ``add_feedback`` retrains in full. The catalog
scores are the history incidence [B, I] times W^T; they are scored,
then ranked by a sort, not through the fused top-k kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from mymedialite_tpu_torch.device import exact_float32, resolve_device
from mymedialite_tpu_torch.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu_torch.models.base import (
    IncrementalItemRecommender, IterativeModel,
)
from mymedialite_tpu_torch.ops import bpr as bpr_ops
from mymedialite_tpu_torch.ops import correlation as corr_ops
from mymedialite_tpu_torch.ops.sgd import add_rows
from mymedialite_tpu_torch.parallel.mesh import DEFAULT_MESH

# rows of C per int8 product
_GRAM_ROWS = 4096


def device_history(sampler, num_users: int):
    """(hist [U, L_max] int32 padded with -1, lens [U] int64) on the
    sampler's device: each user's items sorted, duplicates kept (the
    JAX package's ``padded_history`` of ``by_user``), from the sampling
    state's sorted keys in one scatter."""
    counts, indptr = sampler["counts"], sampler["indptr"]
    items = sampler["hist_items"]
    dev = items.device
    L = max(int(counts.max()) if counts.numel() else 0, 1)
    hist = torch.full((num_users, L), -1, dtype=torch.int32, device=dev)
    rows = torch.repeat_interleave(torch.arange(num_users, device=dev),
                                   counts)
    pos = torch.arange(rows.numel(), device=dev) - indptr[rows]
    hist[rows, pos] = items.to(torch.int32)
    return hist, counts


def history_rows(hist, lens, users, num_items: int):
    """The padded histories of ``users``: (ids [B, L_max] int64 clamped
    into the catalog, valid [B, L_max] bool). An item listed twice is
    valid once. The full width keeps the host from waiting on the card
    for a batch's longest history; the pad entries add 0."""
    n = lens[users]
    h = hist[users].long()
    valid = torch.arange(h.shape[1], device=h.device)[None, :] < n[:, None]
    valid[:, 1:] &= h[:, 1:] != h[:, :-1]
    return h.clamp(0, num_items - 1), valid


def slim_scores(W, hist, lens, users):
    """[B, I] catalog scores: the users' 0/1 history rows times W^T
    (JAX ``_slim_catalog``), users clamped into the table."""
    I = W.shape[0]
    u = users.clamp(0, hist.shape[0] - 1)
    h, valid = history_rows(hist, lens, u, I)
    A = torch.zeros((u.shape[0], I), dtype=W.dtype, device=W.device)
    rows = torch.arange(u.shape[0], device=W.device)[:, None].expand_as(h)
    A[rows[valid], h[valid]] = 1.0
    with exact_float32():
        return A @ W.T


def cooccurrence(feedback, device):
    """(C [I, I] float32, cj [I] float32): C = M^T M of the 0/1 incidence
    (a pair listed twice counts once), from the int8 item-major table
    through ``torch._int_mm`` in row blocks, exact in int32; cj, the
    users per item, is C's diagonal."""
    I, U = feedback.num_items, feedback.num_users
    i_pad = max(corr_ops._round_up(I, 8), 32)
    u_pad = corr_ops._round_up(max(U, 1), 8)
    items = torch.from_numpy(np.asarray(feedback.items, np.int64)).to(device)
    users = torch.from_numpy(np.asarray(feedback.users, np.int64)).to(device)
    A = corr_ops._int8_table(items, users, 1, i_pad, u_pad, device)
    del items, users
    C = torch.empty((I, I), dtype=torch.float32, device=device)
    for r0 in range(0, I, _GRAM_ROWS):
        r1 = min(r0 + _GRAM_ROWS, I)
        # _int_mm takes at least 17 rows: a short last block starts
        # earlier
        n = max(r1 - r0, 32)
        s = min(r0, i_pad - n)
        C[r0:r1] = torch._int_mm(A[s:s + n], A.T)[r0 - s:r1 - s, :I].float()
    del A
    return C, torch.diagonal(C).clone()


def feature_mask(feedback, k: int, device):
    """[I, I] float32: 1 where item j is among item i's k most
    cosine-similar items (``binary_correlation_topk`` over the
    item-major view), 0 on the diagonal; every off-diagonal entry for
    k <= 0."""
    I = feedback.num_items
    if k <= 0:
        return 1.0 - torch.eye(I, dtype=torch.float32, device=device)
    view = type("ItemMajor", (), dict(users=feedback.items,
                                      items=feedback.users))
    nn, _ = corr_ops.binary_correlation_topk(
        view, I, feedback.num_users, k=k, kind="cosine", device=device)
    mask = torch.zeros((I, I), dtype=torch.float32, device=device)
    rows = torch.arange(I, device=device)[:, None].expand_as(nn)
    mask[rows.reshape(-1), nn.reshape(-1).long()] = 1.0
    mask.fill_diagonal_(0.0)
    return mask


def ls_slim_sweep(W, C, cj, mask, num_users: float, reg_l1: float,
                  reg_l2: float):
    """One Jacobi sweep of the elastic-net update (JAX ``_ls_slim_sweep``,
    reference LeastSquareSLIM.cs:140-176): grad = (C - (W C - cj * W)) /
    U, then W = soft_threshold(grad, l1) / (1 + l2) under the mask.
    Returns the new W (before damping)."""
    with exact_float32():
        A = W @ C
    grad = (C - (A - cj[None, :] * W)) / num_users
    new_w = torch.where(grad.abs() > reg_l1,
                        (grad - torch.sign(grad) * reg_l1) / (1.0 + reg_l2),
                        torch.zeros((), dtype=W.dtype, device=W.device))
    return new_w * mask


def bpr_slim_step(W, hist, lens, u, i, j, w, lr: float, reg_i: float,
                  reg_j: float, *, update_j: bool):
    """One batch of BPR updates of W in place (JAX ``_bpr_slim_epoch``'s
    step): x_uij = sum_{k in I_u} (W[i, k] - W[j, k]); W[i, k] += lr (g -
    reg_i W[i, k]) for k in I_u, k != i; with ``update_j``, W[j, k] +=
    lr (-g - reg_j W[j, k]) for k in I_u, k != j; g = sigmoid(-x) w.
    Every triple reads W as it was at the batch's start."""
    I = W.shape[0]
    h, valid = history_rows(hist, lens, u, I)
    wi, wj = W[i[:, None], h], W[j[:, None], h]
    fv = valid.to(W.dtype)
    x = ((wi - wj) * fv).sum(dim=1)
    g = torch.sigmoid(-x) * w.to(W.dtype)
    Wf = W.view(-1)
    di = lr * (g[:, None] - reg_i * wi) * fv * (h != i[:, None])
    if update_j:
        dj = lr * (-g[:, None] - reg_j * wj) * fv * (h != j[:, None])
    add_rows(Wf, (i[:, None] * I + h).reshape(-1), di.reshape(-1))
    if update_j:
        add_rows(Wf, (j[:, None] * I + h).reshape(-1), dj.reshape(-1))


class _SLIM(IncrementalItemRecommender, IterativeModel):
    EXTRA_PARAMS = {"init_mean": float, "init_stdev": float, "device": str}

    def __init__(self):
        super().__init__()
        # defaults per reference SLIM.cs:63-68
        self.num_iter = 15
        self.init_mean = 0.0
        self.init_stdev = 0.1
        self.random_seed = 42
        self.device = "cuda"
        # the mesh the ranking eval splits its users over (every visible
        # card by default, None: one device); training stays on one
        # device, as in the JAX package
        self.mesh = DEFAULT_MESH
        self.W = None           # [I, I] item weights, zero diagonal
        self._gen = None
        self._score_hist = None

    def _generator(self):
        if self._gen is None:
            self._gen = torch.Generator(device=resolve_device(self.device))
            self._gen.manual_seed(self.random_seed)
        return self._gen

    def init_model(self, tables=None):
        """W = N(init_mean, init_stdev) off the diagonal, from the
        model's generator; ``tables`` ({W}, ``convert.slim_state_from_jax``)
        starts from a given W."""
        I = self.feedback.num_items
        dev = resolve_device(self.device)
        self._gen = None
        if tables is not None:
            self.W = torch.as_tensor(tables["W"], dtype=torch.float32,
                                     device=dev).clone()
        else:
            self.W = self.init_mean + self.init_stdev * torch.randn(
                (I, I), generator=self._generator(), device=dev)
            self.W.fill_diagonal_(0.0)
        self._score_hist = None

    def train(self):
        self.init_model()
        for _ in range(self.num_iter):
            self.iterate()

    def tables_device(self):
        if self.W is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        return self.W.device

    def _history(self):
        """(hist, lens) of the feedback on the tables' device, built once
        per feedback."""
        if self._score_hist is None:
            sampler, _ = bpr_ops.make_sampler_data(
                self.feedback, device=self.tables_device())
            self._score_hist = device_history(sampler,
                                              self.feedback.num_users)
        return self._score_hist

    def catalog_scorer(self, device=None):
        if self.W is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        W = self.W
        hist, lens = self._history()
        return self._on_device(
            lambda users: slim_scores(W, hist, lens, users), device)

    def score_catalog(self, users):
        return self._scores_from_scorer(users)

    def predict_batch(self, users, items):
        users = np.asarray(users, dtype=np.int64)
        items = np.asarray(items, dtype=np.int64)
        out = np.full(users.shape, -np.float32(3.4e38), dtype=np.float32)
        ok = (users >= 0) & (users < self.feedback.num_users) & \
             (items >= 0) & (items < self.W.shape[0])
        if ok.any():
            uniq, rows = np.unique(users[ok], return_inverse=True)
            out[ok] = self.score_catalog(uniq)[rows, items[ok]]
        return out

    def _retrain(self, users, items):
        if self.W is not None:
            self.train()

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "3.05") as w:
            w.matrix(self.W.cpu().numpy())

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            W = r.matrix()
        self.W = torch.from_numpy(np.asarray(W, np.float32)).to(
            resolve_device(self.device))
        self.num_items_trained = self.W.shape[0]
        self._score_hist = None
        self._loaded()

    def _loaded(self):
        """Hook: drop the feedback-derived training state."""


class LeastSquareSLIM(_SLIM):
    """Reference LeastSquareSLIM.cs:55: elastic-net descent with k
    cosine-nearest-neighbour feature selection."""

    HYPERPARAMS = {
        "reg_l1": float,
        "reg_l2": float,
        "k": int,
        "num_iter": int,
    }

    def __init__(self):
        super().__init__()
        self.reg_l1 = 0.01
        self.reg_l2 = 0.001
        self.k = 50
        # the Jacobi sweep oscillates undamped; averaging each sweep
        # with the previous W by 0.5 converges (JAX slim.py:145)
        self.damping = 0.5
        self._C = None

    def init_model(self, tables=None):
        """W starts at zero (reference SLIM.cs InitModel), or at
        ``tables``' W."""
        if tables is None:
            I = self.feedback.num_items
            self.W = torch.zeros((I, I), dtype=torch.float32,
                                 device=resolve_device(self.device))
            self._score_hist = None
        else:
            super().init_model(tables)
        self._build_epoch_state()

    def _build_epoch_state(self):
        dev = self.tables_device()
        self._C, self._cj = cooccurrence(self.feedback, dev)
        self._mask = feature_mask(self.feedback, self.k, dev)
        self._num_users = self.feedback.num_users

    def _loaded(self):
        self._C = None

    def _ensure_epoch_ready(self):
        if self._C is None:
            if self.feedback is None:
                raise RuntimeError("LeastSquareSLIM: no feedback set")
            self._build_epoch_state()

    def iterate(self):
        self._ensure_epoch_ready()
        f32 = np.float32
        with torch.no_grad():
            new_w = ls_slim_sweep(self.W, self._C, self._cj, self._mask,
                                  float(f32(self._num_users)),
                                  float(f32(self.reg_l1)),
                                  float(f32(self.reg_l2)))
            d = float(f32(self.damping))
            self.W = (1.0 - d) * self.W + d * new_w


class BPRSLIM(_SLIM):
    """Reference BPRSLIM.cs:56: SLIM trained on BPR triples."""

    HYPERPARAMS = {
        "reg_i": float,
        "reg_j": float,
        "num_iter": int,
        "learn_rate": float,
        "uniform_user_sampling": bool,
        "with_replacement": bool,
        "update_j": bool,
    }
    EXTRA_PARAMS = dict(_SLIM.EXTRA_PARAMS, batch_size=int,
                        num_neg_trials=int)

    def __init__(self):
        super().__init__()
        self.learn_rate = 0.05
        self.reg_i = 0.0025
        self.reg_j = 0.00025
        self.uniform_user_sampling = True
        self.with_replacement = False
        self.update_j = True
        self.batch_size = 1024
        self.num_neg_trials = 8
        self._sampling = None

    def init_model(self, tables=None):
        super().init_model(tables)
        self._build_epoch_state()

    def _build_epoch_state(self):
        """The sampling state and the padded history [U, L_max] on the
        tables' device; ``history_bytes`` is the history's size."""
        self._sampling = bpr_ops.make_sampler_data(
            self.feedback, self.num_neg_trials, device=self.tables_device())
        self._score_hist = device_history(self._sampling[0],
                                          self.feedback.num_users)
        hist = self._score_hist[0]
        self.history_bytes = hist.numel() * hist.element_size()

    def _loaded(self):
        self._sampling = None

    def _ensure_epoch_ready(self):
        if self._sampling is None:
            if self.feedback is None:
                raise RuntimeError("BPRSLIM: no feedback set")
            self._build_epoch_state()

    def _regime(self) -> int:
        return (bpr_ops.UNIFORM_USER if self.uniform_user_sampling
                else bpr_ops.UNIFORM_PAIR)

    def step(self, u, i, j, w):
        """One batch update on the triples (u, i, j) with weights w."""
        hist, lens = self._history()
        f32 = np.float32
        with torch.no_grad():
            bpr_slim_step(self.W, hist, lens, u, i, j, w,
                          float(f32(self.learn_rate)), float(f32(self.reg_i)),
                          float(f32(self.reg_j)), update_j=self.update_j)

    def iterate(self):
        """|feedback| triples in batches of ``batch_size``, drawn from the
        model's generator."""
        self._ensure_epoch_ready()
        sampler, meta = self._sampling
        B, num_batches = bpr_ops.epoch_batches(meta["num_events"],
                                               self.batch_size)
        for _ in range(num_batches):
            u, i, j, w = bpr_ops.sample_triples(
                self._generator(), sampler, meta, B, self._regime())
            self.step(u, i, j, w)
