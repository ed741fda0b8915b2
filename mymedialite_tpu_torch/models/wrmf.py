"""WRMF — weighted regularized matrix factorization (implicit ALS), on
the port.

Counterpart of ``mymedialite_tpu/models/wrmf.py`` (reference
``ItemRecommendation/WRMF.cs:53-180``, Hu/Koren/Volinsky 2008). One
alternation solves every user row, then every item row, in closed form:
each side is a few batched solves (``ops/als.py``) on the model's device
instead of a Parallel.For over per-row matrix inverses.

Rows are grouped into power-of-two history-length buckets, and a
bucket's rows are solved ``chunk`` at a time with chunk x L <= 2M
gathered history slots, which bounds the [chunk, L, f] temporary (about
320 MB at f=40) whatever the longest history. Storage, prediction,
serving (kernel 6 through ``ItemMF.fused_rows``) and the model file are
``ItemMF``'s, the same text as the JAX package's.

``solve_chunk`` caps the rows of one batched solve; it changes no
result, only the number of launches (the port's default is larger than
the JAX package's 256). An online update (``add_feedback``) grows the
tables with zero rows and re-solves only the touched rows
(``wrmf_solve_row``); every other row stays bit-unchanged.

On a mesh (every visible card by default, or ``model.mesh =
make_mesh(...)``; ``model.mesh = None`` keeps one device) each bucket's rows
split into one contiguous shard per mesh device, padded with empty rows
to a multiple of chunk x the devices (JAX ``models/wrmf.py:79-80``; on
the mesh a bucket's chunk is at most its rows over the devices, so that
the padding stays under one row a device), and each device solves its
shard against its replica of the fixed side (``wrmf_optimize_sharded``):
the same W as one device's solves.
"""

from __future__ import annotations

import numpy as np
import torch

from mymedialite_tpu_torch.models.bpr import ItemMF
from mymedialite_tpu_torch.ops.als import (
    gram, wrmf_optimize, wrmf_optimize_sharded, wrmf_solve_row,
)
from mymedialite_tpu_torch.parallel.mesh import model_mesh


class WRMF(ItemMF):
    HYPERPARAMS = {
        "num_factors": int,
        "regularization": float,
        "alpha": float,
        "num_iter": int,
    }
    EXTRA_PARAMS = dict(ItemMF.EXTRA_PARAMS, solve_chunk=int)

    # gathered-history memory budget per solve step: chunk * L <= 2M
    # slots (f=40 -> ~320 MB)
    _GATHER_BUDGET = 2_097_152

    def __init__(self):
        super().__init__()
        # defaults per reference WRMF.cs:56-65
        self.alpha = 1.0
        self.regularization = 0.015
        self.num_iter = 15
        self.solve_chunk = 1 << 16
        self._user_hist = None
        self._item_hist = None
        self._hist_mesh = None   # the mesh the histories are laid out for

    def init_model(self, tables=None):
        super().init_model(tables)
        self._build_histories()

    def _build_histories(self):
        f = self.feedback
        self._hist_mesh = mesh = model_mesh(self)
        self._user_hist = self._bucketize(f.by_user, f.num_users, mesh)
        self._item_hist = self._bucketize(f.by_item, f.num_items, mesh)

    def _bucketize(self, csr, num_rows: int, mesh):
        """Length-bucketed padded histories: rows grouped by history
        length into power-of-two buckets (memory O(2 nnz), not rows x
        Lmax). Returns a list of (row_ids, hist [n, L], lens [n], chunk),
        tensors on the model's device; on a ``mesh`` hist and lens are
        lists of this process's row shards, n padded to a multiple of
        chunk x the global devices."""
        dev = self.params["user_factors"].device
        D = mesh.global_size if mesh is not None else 1
        counts = csr.counts()[:num_rows]
        bounds = [16]
        while bounds[-1] < max(int(counts.max()) if counts.size else 1, 1):
            bounds.append(bounds[-1] * 2)
        bidx = np.searchsorted(bounds, counts)
        buckets = []
        for b_i, L in enumerate(bounds):
            rows = np.nonzero(bidx == b_i)[0]
            if rows.size == 0:
                continue
            cap = max(self._GATHER_BUDGET // L, 8)
            chunk = min(self.solve_chunk, 1 << (cap.bit_length() - 1))
            n_pad = rows.size
            if D > 1:
                chunk = min(chunk, -(-rows.size // D))
                n_pad = -(-rows.size // (chunk * D)) * chunk * D
            cnt_r = counts[rows].astype(np.int64)
            hist = np.zeros((n_pad, L), np.int64)
            lens = np.zeros(n_pad, np.int64)
            lens[:rows.size] = cnt_r
            # vectorized ragged fill: flat positions within each row
            total = int(cnt_r.sum())
            row_rep = np.repeat(np.arange(rows.size, dtype=np.int64), cnt_r)
            within = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(cnt_r) - cnt_r, cnt_r)
            starts = np.repeat(csr.indptr[rows].astype(np.int64), cnt_r)
            hist[row_rep, within] = csr.keys[starts + within]
            hist, lens = (torch.from_numpy(a).to(dev) for a in (hist, lens))
            if mesh is not None:
                hist, lens = mesh.shard_rows(hist), mesh.shard_rows(lens)
            buckets.append((torch.from_numpy(rows.astype(np.int64)).to(dev),
                            hist, lens, chunk))
        return buckets

    def _optimize(self, H, buckets, num_rows: int):
        """Solve all rows bucket by bucket (each row's system involves
        only its own history, so the buckets are independent), on the
        mesh the histories were laid out for."""
        W = torch.zeros((num_rows, H.shape[1]), dtype=H.dtype,
                        device=H.device)
        mesh = self._hist_mesh
        HH = gram(H) if mesh is None else None
        for rows, hist, lens, chunk in buckets:
            if mesh is None:
                Wb = wrmf_optimize(H, hist, lens, self.alpha,
                                   self.regularization, chunk=chunk, HH=HH)
            else:
                Wb = wrmf_optimize_sharded(mesh, H, hist, lens, self.alpha,
                                           self.regularization, chunk=chunk)
            W[rows] = Wb[:rows.shape[0]]
        return W

    def _loaded(self):
        self._user_hist = self._item_hist = None

    def _ensure_epoch_ready(self):
        """Rebuild the histories when missing, e.g. after ``load_model``
        or an online update, so that ``iterate()`` keeps training
        (reference Model.Load + --find-iter contract, IO/Model.cs:67-83),
        or laid out for another mesh than the model's."""
        if self._user_hist is not None and \
                self._hist_mesh is model_mesh(self):
            return
        if self.feedback is None:
            raise RuntimeError(
                "WRMF: no feedback set; assign .feedback before "
                "iterating a loaded model")
        self._grow_tables()
        self._build_histories()

    def iterate(self):
        """One alternation (reference WRMF.Iterate :68-73): the user side,
        then the item side."""
        self._ensure_epoch_ready()
        p = self.params
        with torch.no_grad():
            user_factors = self._optimize(
                p["item_factors"], self._user_hist,
                p["user_factors"].shape[0])
            item_factors = self._optimize(
                user_factors, self._item_hist, p["item_factors"].shape[0])
        self.params = dict(p, user_factors=user_factors,
                           item_factors=item_factors)

    def _grow_tables(self):
        """Zero rows for users and items the feedback has and the tables
        lack (JAX ``_grow_tables``)."""
        f = self.feedback
        p = dict(self.params)
        for side, n in (("user_factors", f.num_users),
                        ("item_factors", f.num_items)):
            grow = n - p[side].shape[0]
            if grow > 0:
                p[side] = torch.cat([p[side], p[side].new_zeros(
                    (grow, self.num_factors))])
        self.params = p
        self.num_users_trained = max(self.num_users_trained, f.num_users)
        self.num_items_trained = max(self.num_items_trained, f.num_items)

    def retrain_user(self, user_id):
        """Re-solve only this user's row against the current item factors
        (reference WRMF.RetrainUser, WRMF.cs:158-163)."""
        p = self.params
        ids = self.feedback.by_user.secondary(user_id)
        with torch.no_grad():
            p["user_factors"][user_id] = wrmf_solve_row(
                p["item_factors"], ids, self.alpha, self.regularization)

    def retrain_item(self, item_id):
        """Reference WRMF.RetrainItem, WRMF.cs:165-172."""
        p = self.params
        ids = self.feedback.by_item.secondary(item_id)
        with torch.no_grad():
            p["item_factors"][item_id] = wrmf_solve_row(
                p["user_factors"], ids, self.alpha, self.regularization)

    def _retrain(self, users, items):
        """Grow the tables, then re-solve only the touched rows; the
        bucketed histories of iterate() are rebuilt when training
        resumes."""
        if self._params is None and self._mxu_tables is None:
            return
        self._grow_tables()
        self._user_hist = self._item_hist = None
        self._fused = None
        if self.update_users:
            for u in np.unique(np.asarray(users, dtype=np.int64)):
                self.retrain_user(int(u))
        if self.update_items:
            for i in np.unique(np.asarray(items, dtype=np.int64)):
                self.retrain_item(int(i))
