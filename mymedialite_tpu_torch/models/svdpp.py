"""SVD++ / asymmetric-factor-model family of rating predictors (the port).

Counterparts of ``mymedialite_tpu/models/svdpp.py`` (reference
``RatingPrediction/SVDPlusPlus.cs:43``, ``SigmoidSVDPlusPlus.cs:42``,
``SigmoidItemAsymmetricFactorModel.cs:29``,
``SigmoidUserAsymmetricFactorModel.cs:43``, the combined model and
``GSVDPlusPlus.cs:29``). Training takes one of two routes, as the JAX
package on one TPU chip picks them (``_svdpp_mxu_mode`` and
``_prepare``): the three-phase SVD++ epoch of ``ops/svdpp_epoch.py`` —
on a CUDA device the hand-written kernel ``csrc/svdpp_epoch.cu``, one
launch per epoch — over the static schedule of ``ops/svdpp_plan.py``
(the schedule and update semantics of the JAX package's Pallas epoch)
while Q and Y fit ``svdpp_plan.SVDPP_TABLE_BYTES``, the regularization
is uniform and every user block fits a pass; else the grouped epoch of
``ops/svdpp.py`` (plain PyTorch, the JAX package's XLA epoch), whose
user groups ``group_users`` sizes (0: sized from the data and the learn
rate). Frequency regularization and GSVDPlusPlus always take the
grouped epoch. The models are transductive: the pairs in
``additional_feedback`` (the CLI passes the test pairs) join the users'
histories I_u.

Tables: ``params`` holds float32 tensors p [U, f] (models with p),
user_bias [U], item_bias [I], item_factors [I, f] and y [I, f], U the
users with ratings or feedback; ``global_bias`` is a float. The epoch
runs on kernel-layout copies that stay resident across ``iterate()``
calls and fold back when ``params`` is read.

An online update (``add_ratings``, JAX ``svdpp.py:488-509``) re-plans
on the grown ratings, grows the tables with zero rows and runs one
``iterate()`` on the route that ``route`` picks; the user AFM passes the
update to its inner model with users and items swapped.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from mymedialite_tpu_torch.data.arrays import RatingData
from mymedialite_tpu_torch.device import exact_float32, resolve_device
from mymedialite_tpu_torch.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu_torch.models.base import (
    IncrementalRatingPredictor, IterativeModel, RatingPredictor,
)
from mymedialite_tpu_torch.models.mf import _LOSS_ID, OptimizationTarget
from mymedialite_tpu_torch.ops import svdpp_plan as sp
from mymedialite_tpu_torch.ops.plan import xla_epochs_forced
from mymedialite_tpu_torch.ops.svdpp import (
    history_edges, inv_sqrt_counts, precompute_user_factors, prepare_groups,
    shard_groups, svdpp_epoch_grouped, svdpp_epoch_sharded,
)
from mymedialite_tpu_torch.ops.svdpp_epoch import svdpp_epoch
from mymedialite_tpu_torch.parallel.mesh import (
    DEFAULT_MESH, model_mesh, one_device_route,
)

log = logging.getLogger("mymedialite_tpu_torch")


def _rows(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` cut or zero-padded to n rows."""
    if a.shape[0] >= n:
        return a[:n]
    return np.concatenate([a, np.zeros((n - a.shape[0],) + a.shape[1:],
                                       a.dtype)])


def _catalog_scorer(uf, q, user_bias, item_bias, global_bias, min_rating,
                    max_rating, sigmoid):
    """``fn(users) -> [len(users), len(q)]``: global bias + user bias +
    item bias + ``uf[u] @ q.T``, then the clip or the sigmoid (JAX:
    ``_svdpp_catalog_raw`` with ``_svdpp_catalog_clip`` /
    ``_svdpp_catalog_sigmoid``). Users outside uf's rows score with zero
    factors and bias, as the JAX package's padded user rows do."""
    U = uf.shape[0]
    rng = max(max_rating - min_rating, 1e-9)

    def score(users):
        ok = ((users >= 0) & (users < U))[:, None]
        u = users.clamp(0, U - 1)
        zero = torch.zeros((), dtype=torch.float32, device=uf.device)
        raw = global_bias + torch.where(ok, user_bias[u][:, None], zero) \
            + item_bias[None, :] + torch.where(ok, uf[u] @ q.T, zero)
        if sigmoid:
            return min_rating + torch.sigmoid(raw) * rng
        return raw.clamp(min_rating, max_rating)
    return score


class SVDPlusPlus(IncrementalRatingPredictor, IterativeModel):
    """prediction(u,i) = mu + b_u + b_i + <q_i, p_u + |I_u|^-1/2 sum y_j>,
    clamped to the rating scale (reference SVDPlusPlus.cs:43)."""

    HYPERPARAMS = {
        "num_factors": int,
        "regularization": float,
        "bias_reg": float,
        "frequency_regularization": bool,
        "learn_rate": float,
        "bias_learn_rate": float,
        "learn_rate_decay": float,
        "num_iter": int,
    }
    EXTRA_PARAMS = {
        "init_mean": float,
        "init_stdev": float,
        "group_users": int,
        "device": str,
    }

    SIGMOID = False
    USE_P = True
    # the kernel route is open to the model (GSVD++'s x updates keep the
    # grouped epoch)
    KERNEL_ELIGIBLE = True
    # the grouped epoch has a mesh form (GSVD++'s has not, JAX :737)
    SHARDABLE = True

    def __init__(self):
        super().__init__()
        # defaults per reference SVDPlusPlus.cs:77-84
        self.num_factors = 10
        self.regularization = 0.015
        self.bias_reg = 0.33
        self.learn_rate = 0.001
        self.bias_learn_rate = 0.7
        self.learn_rate_decay = 1.0
        self.num_iter = 30
        self.frequency_regularization = False
        self.init_mean = 0.0
        self.init_stdev = 0.1
        self.group_users = 0  # 0 = auto-size (see _auto_group_users)
        self.random_seed = 42
        self.loss = OptimizationTarget.RMSE
        self.device = "cuda"
        # the device mesh (parallel/mesh.py), every visible card by
        # default, None: one device; on a mesh the model trains on the
        # sharded grouped epoch (GSVD++ on one device)
        self.mesh = DEFAULT_MESH
        # IncrementalRatingPredictor's switches (update both sides)
        self.update_users = True
        self.update_items = True

        self.additional_feedback = None  # (users, items) arrays or None
        self.global_bias = 0.0
        self.current_learnrate = None
        self._params = None
        self._mxu_tables = None     # resident kernel-layout (W, Q, Y)
        self._plan = None
        self._groups = None         # the grouped route's layout
        self._shards = None         # (mesh, each device's groups)
        self._new_of_old = None
        self._edges = None          # (users, items, inv_sqrt) on device
        self._user_factors_cache = None

    # --- params with lazy kernel-layout write-back ---

    @property
    def params(self):
        if self._mxu_tables is not None:
            p, bu, q, bi, y = sp.svdpp_tables_from_mxu(
                *self._mxu_tables, self._new_of_old,
                num_users=self.num_users_trained,
                num_factors=self.num_factors)
            params = dict(user_bias=bu.contiguous(), item_bias=bi.contiguous(),
                          item_factors=q.contiguous(), y=y.contiguous())
            if self.USE_P:
                params["p"] = p.contiguous()
            self._params = params
            self._mxu_tables = None
        return self._params

    @params.setter
    def params(self, value):
        self._params = value
        self._mxu_tables = None
        self._user_factors_cache = None

    # --- data plumbing ---

    def _num_users(self):
        n = self.ratings.num_users
        fb = self.additional_feedback
        if fb is not None and len(fb[0]):
            n = max(n, int(np.max(fb[0])) + 1)
        return n

    def _num_items(self):
        n = self.ratings.num_items
        fb = self.additional_feedback
        if fb is not None and len(fb[1]):
            n = max(n, int(np.max(fb[1])) + 1)
        return n

    def _prepare_edges(self):
        """The histories I_u and 1/sqrt(|I_u|) on the device; sets the
        trained user and item counts. Called with no resident tables
        (``init_model`` and ``load_model`` drop them first)."""
        if self.ratings is None:
            raise RuntimeError(
                f"{type(self).__name__}: no ratings set; SVD++ reads the "
                "users' histories, assign .ratings first")
        U, I = self._num_users(), self._num_items()
        hu, hi = history_edges(self.ratings.users, self.ratings.items, I,
                               self.additional_feedback)
        dev = resolve_device(self.device)
        self.num_users_trained, self.num_items_trained = U, I
        self._hist = (hu, hi)
        self._edges = (torch.from_numpy(hu.astype(np.int64)).to(dev),
                       torch.from_numpy(hi.astype(np.int64)).to(dev),
                       torch.from_numpy(inv_sqrt_counts(hu, U)).to(dev))
        self._plan = None
        self._groups = self._shards = None
        self._user_factors_cache = None
        self._prepare_side()

    def _prepare_side(self):
        """Hook: side information sized by the catalog (GSVD++)."""

    def _auto_group_users(self, num_users: int) -> int:
        """The grouped epoch's group size (JAX: ``_auto_group_users``):
        ``group_users`` when set, else a power of two that bounds the
        ratings aggregated into one y update (about 65,536, fewer at
        learn rates above 0.001), at least 64 users, at most 16,384."""
        if self.group_users > 0:
            return min(self.group_users, max(num_users, 1))
        avg, budget = self._y_step_budget(num_users)
        g = int(2 ** np.floor(np.log2(max(budget / avg, 64.0))))
        return min(g, 16_384, max(num_users, 1))

    def _y_step_budget(self, num_users: int):
        """(ratings per user, the ratings one y step may aggregate):
        ``_auto_group_users``'s bound."""
        avg = max(1.0, len(self.ratings) / max(num_users, 1))
        return avg, 65_536.0 * min(1.0, 0.001 / max(self.learn_rate, 1e-9))

    def _warn_mesh_step(self, group: int, mesh):
        """Warn where a step of the sharded epoch, which merges the y
        steps of one group a device, aggregates more ratings than
        ``_auto_group_users`` lets one group's y step take: at the
        automatic size on D >= 2 devices the tables can turn non-finite
        (the Netflix shape at D = 4, in both packages; ROADMAP C). The
        size stays the JAX package's; ``group_users`` sets a smaller
        one."""
        avg, budget = self._y_step_budget(self.num_users_trained)
        D = mesh.global_size
        step = D * group * avg
        if step > budget:
            log.warning(
                "%s: a step of the sharded epoch merges %d groups of %d "
                "users, about %.0f ratings, past the %.0f that one y step "
                "is kept under; the tables may diverge: set group_users "
                "to at most %d", type(self).__name__, D, group,
                step, budget, max(int(budget / (avg * D)), 1))

    def route(self) -> str:
        """"kernel" (``csrc/svdpp_epoch.cu``), "grouped" (the grouped
        epoch) or "sharded" (its mesh form), from the data, the
        hyperparameters and the mesh, as the JAX package decides: on a
        mesh the sharded grouped epoch even where the kernel fits (JAX
        ``_prepare``: a mesh keeps the XLA epoch)."""
        if self._plan is None and self._groups is None:
            if self._edges is None:
                self._prepare_edges()
            self._prepare_epoch()
        if self._plan is not None:
            return "kernel"
        return "sharded" if self._shards is not None else "grouped"

    def _prepare_epoch(self):
        """The kernel route's chunk plan where Q and Y fit, the
        regularization is uniform, every user block fits a pass and
        ``MML_MXU`` is not 0; else the grouped epoch's layout (JAX:
        ``_prepare``, ``_svdpp_mxu_mode``)."""
        data = self.ratings
        hu, hi = self._hist
        dev = resolve_device(self.device)
        self._plan = self._groups = self._shards = None
        mesh = model_mesh(self)
        if mesh is not None and not self.SHARDABLE:
            one_device_route(self, "grouped", mesh)
            mesh = None
        if (mesh is None and self.KERNEL_ELIGIBLE
                and not xla_epochs_forced()
                and not self.frequency_regularization
                and sp.svdpp_mxu_supported(self._num_items(),
                                           self.num_factors)):
            try:
                self._plan = sp.prepare_svdpp_mxu(
                    data.users, data.items, data.values, hu, hi,
                    self.num_users_trained, self.num_items_trained,
                    pass_len=sp.PASS_LEN, shuffle_seed=self.random_seed,
                    device=dev)
            except ValueError:
                # a user block too heavy for one pass: the grouped epoch
                self._plan = None
        if self._plan is not None:
            self._new_of_old = torch.from_numpy(
                self._plan.new_of_old.astype(np.int64)).to(dev)
            return
        U = self.num_users_trained
        group = self._auto_group_users(U)
        self._groups = prepare_groups(
            data.users, data.items, data.values, hu, hi, U, group,
            device=dev,
            pad_groups_multiple=mesh.global_size if mesh is not None else 1)
        if mesh is not None:
            self._warn_mesh_step(group, mesh)
            self._shards = (mesh, shard_groups(mesh, self._groups))
        self._regs = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
                      for k, v in self._entity_regs().items()}

    def _entity_regs(self) -> dict:
        """Per-entity regularization of the grouped epoch (JAX:
        ``_prepare``): user_reg and item_reg are reg / sqrt(ratings) with
        frequency regularization (reg without ratings), else reg; y_reg
        is reg / sqrt(feedback count), or reg, and 0 for items without
        feedback (SVDPlusPlus.cs:95-100)."""
        U, I = self.num_users_trained, self.num_items_trained
        reg = self.regularization
        cu = np.bincount(self.ratings.users, minlength=U)[:U]
        ci = np.bincount(self.ratings.items, minlength=I)[:I]
        fc = np.bincount(self._hist[1], minlength=I)[:I]
        if self.frequency_regularization:
            user_reg = np.where(cu > 0, reg / np.sqrt(np.maximum(cu, 1)), reg)
            item_reg = np.where(ci > 0, reg / np.sqrt(np.maximum(ci, 1)), reg)
            y_reg = np.where(fc > 0, reg / np.sqrt(np.maximum(fc, 1)), 0.0)
        else:
            user_reg = np.full(U, reg)
            item_reg = np.full(I, reg)
            y_reg = np.where(fc > 0, reg, 0.0)
        return dict(user_reg=user_reg, item_reg=item_reg, y_reg=y_reg)

    def _rating_range(self) -> float:
        return max(self.max_rating - self.min_rating, 1e-9)

    def _init_global_bias(self):
        return float(self.ratings.average)

    def init_model(self, tables=None):
        """N(mean, stdev) init of q, y and p from a ``torch.Generator``
        seeded by ``random_seed``, zero rows for items and users without
        training ratings, zero biases (JAX: ``init_model``). ``tables``
        (from ``convert.svdpp_tables_from_jax``) starts from given tables
        instead."""
        self._mxu_tables = None
        self._prepare_edges()
        self._prepare_epoch()
        dev = resolve_device(self.device)
        U, I, f = self.num_users_trained, self.num_items_trained, \
            self.num_factors
        if tables is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(self.random_seed)

            def draw(rows, seen_ids):
                t = self.init_mean + self.init_stdev * torch.randn(
                    (rows, f), generator=gen, device=dev)
                seen = np.zeros(rows, dtype=bool)
                seen[seen_ids] = True
                t[torch.from_numpy(~seen).to(dev)] = 0.0
                return t

            params = dict(item_factors=draw(I, self.ratings.items),
                          y=draw(I, self.ratings.items),
                          user_bias=torch.zeros(U, device=dev),
                          item_bias=torch.zeros(I, device=dev))
            if self.USE_P:
                params["p"] = draw(U, self.ratings.users)
            params.update(self._init_side(gen, dev))
            self.global_bias = self._init_global_bias()
        else:
            params = {k: torch.as_tensor(np.asarray(tables[k], np.float32),
                                         device=dev).clone()
                      for k in ("user_bias", "item_bias", "item_factors",
                                "y") + (("p",) if self.USE_P else ())
                      + self.SIDE_TABLES}
            if params["user_bias"].shape[0] != U:
                raise ValueError(f"tables hold {params['user_bias'].shape[0]}"
                                 f" users, the data {U}")
            self.global_bias = float(tables["global_bias"])
        self.params = params
        self.current_learnrate = self.learn_rate

    # tables of the side information, drawn after the others (GSVD++: x)
    SIDE_TABLES = ()

    def _init_side(self, gen, dev) -> dict:
        return {}

    def train(self):
        self.init_model()
        for _ in range(self.num_iter):
            self.iterate()

    def _ensure_epoch_ready(self):
        """Build the plan or the groups when missing, e.g. after
        ``load_model``."""
        if self._plan is None and self._groups is None:
            self._prepare_epoch()

    def _grouped_hp(self) -> dict:
        return dict(global_bias=self.global_bias,
                    learn_rate=self.current_learnrate,
                    bias_learn_rate=self.bias_learn_rate,
                    bias_reg=self.bias_reg, min_rating=self.min_rating,
                    rating_range=self._rating_range())

    def _iterate_grouped(self):
        """One grouped epoch on ``params`` (JAX: ``svdpp_epoch``), on the
        mesh where there is one (``svdpp_epoch_sharded``)."""
        with torch.no_grad():
            if self._shards is not None:
                mesh, shards = self._shards
                svdpp_epoch_sharded(
                    mesh, self.params, shards, self._edges[2],
                    self._grouped_hp(), self._regs, loss=_LOSS_ID[self.loss],
                    sigmoid=self.SIGMOID, use_p=self.USE_P,
                    update_user=self.update_users,
                    update_item=self.update_items)
                self._user_factors_cache = None
                self.current_learnrate *= self.learn_rate_decay
                return
            svdpp_epoch_grouped(
                self.params, self._groups, self._edges[2],
                self._grouped_hp(), self._regs, loss=_LOSS_ID[self.loss],
                sigmoid=self.SIGMOID, use_p=self.USE_P,
                update_user=self.update_users, update_item=self.update_items,
                attr_norm=self._attr_norm())
        self._user_factors_cache = None
        self.current_learnrate *= self.learn_rate_decay

    def _attr_norm(self):
        """GSVD++'s [I, A] attribute rows; None for the other models."""
        return None

    def iterate(self):
        """One epoch: through ``svdpp_epoch`` on the resident kernel-layout
        tables (JAX: ``_iterate_mxu``), or the grouped epoch."""
        self._ensure_epoch_ready()
        self._user_factors_cache = None
        if self._groups is not None:
            return self._iterate_grouped()
        plan = self._plan
        f = self.num_factors
        fe = sp.svdpp_fe(f)
        if self._mxu_tables is not None:
            W, Q, Y = self._mxu_tables
        else:
            p = self._params
            p_mat = p["p"] if self.USE_P else torch.zeros(
                (self.num_users_trained, f), device=p["y"].device)
            W, Q, Y = sp.svdpp_tables_to_mxu(
                p_mat, p["user_bias"], plan.inv_sqrt, p["item_factors"],
                p["item_bias"], p["y"], self._new_of_old, u_pad=plan.u_pad,
                i_pad=plan.i_pad, fe=fe)
        svdpp_epoch(W, Q, Y, plan.packed, plan.schedule, *self._epoch_args(),
                    user_block=plan.user_block, item_block=plan.item_block,
                    num_factors=f, loss=_LOSS_ID[self.loss],
                    sigmoid=self.SIGMOID)
        self._mxu_tables = (W, Q, Y)
        self.current_learnrate *= self.learn_rate_decay

    def _epoch_args(self):
        """(hp, rates) of the next epoch, at the current learn rate."""
        f = self.num_factors
        rates = sp.svdpp_mxu_rates(
            f, sp.svdpp_fe(f), self.current_learnrate, self.bias_learn_rate,
            self.regularization, self.bias_reg, self.regularization,
            use_p=self.USE_P, update_user=self.update_users,
            update_item=self.update_items, device=self._plan.packed.device)
        return (self.global_bias, self.min_rating, self._rating_range()), rates

    # --- prediction (lazy PrecomputeUserFactors, SVDPlusPlus.cs:216-226) ---

    def _user_factors(self):
        if self._user_factors_cache is None:
            hu, hi, inv = self._edges
            p = self.params
            self._user_factors_cache = precompute_user_factors(
                p["y"], hu, hi, inv, self.num_users_trained, p.get("p"))
        return self._user_factors_cache

    def _bound(self, score):
        if self.SIGMOID:
            return self.min_rating + torch.sigmoid(score) * \
                self._rating_range()
        return score.clamp(self.min_rating, self.max_rating)

    def _predict_pairs(self, uf, p, users, items):
        """Out-of-range ids contribute only the global bias (reference
        Predict bounds checks); JAX: ``predict_batch``."""
        q = self._item_factors(p)
        U, I = self.num_users_trained, q.shape[0]
        u_ok = (users >= 0) & (users < U)
        i_ok = (items >= 0) & (items < I)
        uc = users.clamp(0, uf.shape[0] - 1)
        ic = items.clamp(0, I - 1)
        zero = torch.zeros((), dtype=torch.float32, device=uf.device)
        dot = (uf[uc] * q[ic]).sum(dim=-1)
        score = self.global_bias \
            + torch.where(u_ok, p["user_bias"][uc], zero) \
            + torch.where(i_ok, p["item_bias"][ic], zero) \
            + torch.where(u_ok & i_ok, dot, zero)
        return self._bound(score)

    def _item_factors(self, p):
        """The item factors that prediction reads (GSVD++ adds its
        attribute factors)."""
        return p["item_factors"]

    def pair_scorer(self):
        if self._params is None and self._mxu_tables is None:
            return None
        uf, p = self._user_factors(), self.params
        return lambda users, items: self._predict_pairs(uf, p, users, items)

    def predict_batch(self, users, items):
        uf = self._user_factors()
        dev = uf.device
        u = torch.from_numpy(np.asarray(users, dtype=np.int64)).to(dev)
        i = torch.from_numpy(np.asarray(items, dtype=np.int64)).to(dev)
        with torch.no_grad():
            out = self._predict_pairs(uf, self.params, u, i)
        return out.cpu().numpy()

    def tables_device(self):
        if self._mxu_tables is not None:
            return self._mxu_tables[0].device
        if self._params is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        return self._params["item_factors"].device

    def catalog_scorer(self, device=None):
        """The catalog scorer on the tables' device, or on copies of its
        tables on ``device``."""
        if self._params is None and self._mxu_tables is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        uf, p = self._user_factors(), self.params
        tabs = (uf, self._item_factors(p), p["user_bias"], p["item_bias"])
        if device is not None:
            tabs = tuple(t.to(device) for t in tabs)
        return _catalog_scorer(*tabs, self.global_bias, self.min_rating,
                               self.max_rating, self.SIGMOID)

    def score_catalog(self, users):
        return self._scores_from_scorer(users)

    def _retrain(self, users, items):
        """Re-plan on the current ratings, grow the tables with zero rows
        for new users and items, and run one epoch over all of them (the
        JAX package's simplified RetrainUser)."""
        if self._params is None and self._mxu_tables is None:
            return
        old = dict(self.params)
        self._prepare_edges()
        self._prepare_epoch()
        U, I = self.num_users_trained, self.num_items_trained

        def grow(t, n):
            if t.shape[0] >= n:
                return t
            return torch.cat([t, t.new_zeros((n - t.shape[0],)
                                             + tuple(t.shape[1:]))])
        for k in ("user_bias", "p"):
            if k in old:
                old[k] = grow(old[k], U)
        for k in ("item_bias", "item_factors", "y"):
            old[k] = grow(old[k], I)
        self.params = old
        self.iterate()

    # --- persistence (reference SVDPlusPlus.cs:272-311) ---

    def save_model(self, path, model_name=None):
        U, p = self.num_users_trained, self.params
        host = lambda t: t.detach().cpu().numpy()  # noqa: E731
        with ModelWriter(path, model_name or type(self).__name__, "2.99") as w:
            w.scalar(self.global_bias)
            w.scalar(self.min_rating)
            w.scalar(self.max_rating)
            w.vector(host(p["user_bias"])[:U])
            w.vector(host(p["item_bias"]))
            w.matrix(host(p["p"])[:U] if self.USE_P
                     else np.zeros((U, self.num_factors), np.float32))
            w.matrix(host(p["y"]))
            w.matrix(host(p["item_factors"]))
            for name in self.SIDE_TABLES:
                w.matrix(host(p[name]))

    def load_model(self, path, model_name=None):
        """Load a model file; the histories come from ``.ratings`` (and
        ``additional_feedback``), which must be set."""
        with ModelReader(path, model_name or type(self).__name__) as r:
            gb = r.scalar()
            self.min_rating = r.scalar()
            self.max_rating = r.scalar()
            bu = r.vector()
            bi = r.vector()
            p = r.matrix()
            y = r.matrix()
            q = r.matrix()
            side = {name: r.matrix() for name in self.SIDE_TABLES}
        self.num_factors = q.shape[1]
        self._mxu_tables = None
        self._prepare_edges()
        U = self.num_users_trained
        dev = resolve_device(self.device)
        tables = dict(user_bias=_rows(bu, U), item_bias=bi, item_factors=q,
                      y=y, **side)
        if self.USE_P:
            tables["p"] = _rows(p, U)
        self.params = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                       for k, v in tables.items()}
        self.global_bias = gb
        self.current_learnrate = self.learn_rate


class SigmoidSVDPlusPlus(SVDPlusPlus):
    """SVD++ with sigmoid bounding and a selectable loss
    (reference SigmoidSVDPlusPlus.cs:42)."""

    HYPERPARAMS = dict(SVDPlusPlus.HYPERPARAMS, loss=OptimizationTarget)
    SIGMOID = True

    def _init_global_bias(self):
        # logit of the normalized average
        avg = (self.ratings.average - self.min_rating) / self._rating_range()
        avg = min(max(avg, 1e-6), 1 - 1e-6)
        return math.log(avg / (1 - avg))


class SigmoidItemAsymmetricFactorModel(SigmoidSVDPlusPlus):
    """AFM: the user expressed purely by the rated items, no p matrix
    (reference SigmoidItemAsymmetricFactorModel.cs:29)."""
    USE_P = False


def _copy_hyperparameters(src, dst):
    """The hyperparameters, the seed and the mesh (not a hyperparameter:
    it goes to no model file) of ``src`` onto an inner model."""
    for name in list(src.HYPERPARAMS) + list(src.EXTRA_PARAMS):
        if hasattr(src, name) and hasattr(dst, name):
            setattr(dst, name, getattr(src, name))
    dst.random_seed = src.random_seed
    dst.mesh = getattr(src, "mesh", None)


class SigmoidUserAsymmetricFactorModel(SigmoidSVDPlusPlus):
    """Mirrored AFM: items expressed by their raters (reference
    SigmoidUserAsymmetricFactorModel.cs:43): the item AFM trained on the
    transposed ratings. Its model file is the inner model's under this
    class's name."""
    USE_P = False

    @property
    def ratings(self):
        return self._ratings

    @ratings.setter
    def ratings(self, data):
        RatingPredictor.ratings.fset(self, data)
        self._ratings_t = None if data is None else RatingData(
            data.items, data.users, data.values, num_users=data.num_items,
            num_items=data.num_users, scale=data.scale)

    def _new_inner(self):
        inner = SigmoidItemAsymmetricFactorModel()
        _copy_hyperparameters(self, inner)
        inner.ratings = self._ratings_t
        return inner

    def train(self):
        inner = self._new_inner()
        if self.additional_feedback is not None:
            au, ai = self.additional_feedback
            inner.additional_feedback = (ai, au)
        inner.train()
        self._inner = inner

    def iterate(self):
        self._inner.iterate()

    def predict_batch(self, users, items):
        return self._inner.predict_batch(items, users)

    def pair_scorer(self):
        inner = getattr(self, "_inner", None)
        if inner is None:
            return None
        score = inner.pair_scorer()
        return lambda users, items: score(items, users)

    def _trained_inner(self):
        inner = getattr(self, "_inner", None)
        if inner is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        return inner

    def tables_device(self):
        return self._trained_inner().tables_device()

    def catalog_scorer(self, device=None):
        """The role swap (JAX: ``catalog_scorer`` of this model): the
        inner model's item factors and biases are this model's user side,
        its user factors and biases, cut to its real users, the catalog
        (on copies on ``device`` where one is given)."""
        inner = self._trained_inner()
        ip, nI = inner.params, inner.num_users_trained
        tabs = (ip["item_factors"], inner._user_factors()[:nI],
                ip["item_bias"], ip["user_bias"][:nI])
        if device is not None:
            tabs = tuple(t.to(device) for t in tabs)
        return _catalog_scorer(*tabs, inner.global_bias, self.min_rating,
                               self.max_rating, True)

    def _retrain(self, users, items):
        inner = getattr(self, "_inner", None)
        if inner is None:
            return
        inner.ratings = self._ratings_t
        inner._retrain(items, users)

    def save_model(self, path, model_name=None):
        self._inner.save_model(path, model_name or type(self).__name__)

    def load_model(self, path, model_name=None):
        inner = self._new_inner()
        inner.load_model(path, model_name or type(self).__name__)
        self._inner = inner


class SigmoidCombinedAsymmetricFactorModel(SigmoidSVDPlusPlus):
    """Both AFM directions (reference SigmoidCombinedAsymmetricFactorModel):
    the prediction is the mean of the item AFM's and the user AFM's. The
    model file names the two files ``path-item`` and ``path-user``."""
    USE_P = False

    def _inner_models(self):
        models = (SigmoidItemAsymmetricFactorModel(),
                  SigmoidUserAsymmetricFactorModel())
        for inner in models:
            _copy_hyperparameters(self, inner)
            inner.ratings = self.ratings
        return models

    def train(self):
        self._item_afm, self._user_afm = self._inner_models()
        for inner in (self._item_afm, self._user_afm):
            inner.additional_feedback = self.additional_feedback
            inner.train()

    def iterate(self):
        self._item_afm.iterate()
        self._user_afm.iterate()

    def predict_batch(self, users, items):
        return 0.5 * (self._item_afm.predict_batch(users, items)
                      + self._user_afm.predict_batch(users, items))

    def pair_scorer(self):
        if getattr(self, "_item_afm", None) is None:
            return None
        a = self._item_afm.pair_scorer()
        b = self._user_afm.pair_scorer()
        return lambda users, items: 0.5 * (a(users, items) + b(users, items))

    def tables_device(self):
        if getattr(self, "_item_afm", None) is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        return self._item_afm.tables_device()

    def catalog_scorer(self, device=None):
        """The mean of the two models' catalog scores (JAX:
        ``_svdpp_catalog_combined``)."""
        self.tables_device()
        a = self._item_afm.catalog_scorer(device)
        b = self._user_afm.catalog_scorer(device)
        return lambda users: 0.5 * (a(users) + b(users))

    def save_model(self, path):
        self._item_afm.save_model(path + "-item")
        self._user_afm.save_model(path + "-user")
        with open(path, "w") as f:
            f.write(f"{type(self).__name__}\n2.99\ncombined\n")

    def load_model(self, path):
        # as in the JAX package, the loaded inner models see no
        # additional feedback
        self._item_afm, self._user_afm = self._inner_models()
        self._item_afm.load_model(path + "-item")
        self._user_afm.load_model(path + "-user")


class GSVDPlusPlus(SVDPlusPlus):
    """gSVD++ (reference GSVDPlusPlus.cs:29-243, Manzato SAC 2013): SVD++
    whose effective item factor is q_i plus the mean of the item's
    attribute factors x_a (``attr_norm @ x``). Needs ``item_attributes``
    (lines item<TAB>attribute); always trains on the grouped epoch (JAX:
    ``GSVDPlusPlus``). Its model file adds x after q."""

    REQUIRED_SIDE_INFO = ("item_attributes",)
    KERNEL_ELIGIBLE = False
    SHARDABLE = False
    SIDE_TABLES = ("x",)

    def __init__(self):
        super().__init__()
        self.item_attributes = None  # InteractionData: item -> attribute
        self._attr = None            # (attr_norm [I, A], x_reg [A])

    def _prepare_side(self):
        """The items' attribute rows, each summing to 1 (zero for items
        without attributes), and x_reg: reg / the attribute's item count
        with frequency regularization (GSVDPlusPlus.cs:90-94: the count,
        not its square root), else reg."""
        if self.item_attributes is None:
            raise ValueError("GSVDPlusPlus needs item attributes")
        I = self.num_items_trained
        n_attr = self.item_attributes.num_items
        A = np.zeros((I, n_attr), dtype=np.float32)
        au = np.asarray(self.item_attributes.users)
        aa = np.asarray(self.item_attributes.items)
        keep = au < I
        A[au[keep], aa[keep]] = 1.0
        counts = A.sum(axis=1, keepdims=True)
        A_norm = np.divide(A, counts, out=np.zeros_like(A), where=counts > 0)
        col = np.maximum(A.sum(axis=0), 1.0)
        reg = self.regularization
        x_reg = (reg / col if self.frequency_regularization
                 else np.full(n_attr, reg)).astype(np.float32)
        dev = resolve_device(self.device)
        self._attr = (torch.from_numpy(A_norm).to(dev),
                      torch.from_numpy(x_reg).to(dev))

    def _prepare_epoch(self):
        super()._prepare_epoch()
        self._regs["x_reg"] = self._attr[1]

    def _init_side(self, gen, dev) -> dict:
        n_attr = self._attr[0].shape[1]
        return dict(x=self.init_mean + self.init_stdev * torch.randn(
            (n_attr, self.num_factors), generator=gen, device=dev))

    def _attr_norm(self):
        return self._attr[0]

    def _item_factors(self, p):
        """q + attr_norm @ x, in float32 (no TF32)."""
        with exact_float32():
            return p["item_factors"] + self._attr[0] @ p["x"]
