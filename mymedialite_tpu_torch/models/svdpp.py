"""SVD++ / asymmetric-factor-model family of rating predictors (the port).

Counterparts of ``mymedialite_tpu/models/svdpp.py`` (reference
``RatingPrediction/SVDPlusPlus.cs:43``, ``SigmoidSVDPlusPlus.cs:42``,
``SigmoidItemAsymmetricFactorModel.cs:29``,
``SigmoidUserAsymmetricFactorModel.cs:43`` and the combined model).
Training runs the three-phase SVD++ epoch of ``ops/svdpp_epoch.py`` —
on a CUDA device the hand-written kernel ``csrc/svdpp_epoch.cu``, one
launch per epoch — over the static schedule of ``ops/svdpp_plan.py``:
the schedule and update semantics of the JAX package's Pallas epoch.
The models are transductive: the pairs in ``additional_feedback`` (the
CLI passes the test pairs) join the users' histories I_u.

Tables: ``params`` holds float32 tensors p [U, f] (models with p),
user_bias [U], item_bias [I], item_factors [I, f] and y [I, f], U the
users with ratings or feedback; ``global_bias`` is a float. The epoch
runs on kernel-layout copies that stay resident across ``iterate()``
calls and fold back when ``params`` is read.

Not ported yet, each raising "not yet ported": what the JAX package runs
on its XLA grouped epoch (frequency regularization, ``group_users``,
which sizes that epoch's user groups, catalogs whose Q and Y pass
``svdpp_plan.SVDPP_TABLE_BYTES``, a user block past the pass length, and
GSVDPlusPlus, which the registry refuses), ``catalog_scorer`` and the
incremental API.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mymedialite_tpu_torch.data.arrays import RatingData
from mymedialite_tpu_torch.device import resolve_device
from mymedialite_tpu_torch.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu_torch.models.base import IterativeModel, RatingPredictor
from mymedialite_tpu_torch.models.mf import _LOSS_ID, OptimizationTarget
from mymedialite_tpu_torch.ops import svdpp_plan as sp
from mymedialite_tpu_torch.ops.svdpp import (
    history_edges, inv_sqrt_counts, precompute_user_factors,
)
from mymedialite_tpu_torch.ops.svdpp_epoch import svdpp_epoch

_NOT_PORTED = "not yet ported to mymedialite_tpu_torch"


def _rows(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` cut or zero-padded to n rows."""
    if a.shape[0] >= n:
        return a[:n]
    return np.concatenate([a, np.zeros((n - a.shape[0],) + a.shape[1:],
                                       a.dtype)])


class SVDPlusPlus(RatingPredictor, IterativeModel):
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
        self.group_users = 0  # 0 = auto; any other value is not ported
        self.random_seed = 42
        self.loss = OptimizationTarget.RMSE
        self.device = "cuda"
        # IncrementalRatingPredictor's switches (update both sides)
        self.update_users = True
        self.update_items = True

        self.additional_feedback = None  # (users, items) arrays or None
        self.global_bias = 0.0
        self.current_learnrate = None
        self._params = None
        self._mxu_tables = None     # resident kernel-layout (W, Q, Y)
        self._plan = None
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
        self._user_factors_cache = None

    def _prepare_epoch(self):
        """The chunk plan of the kernel path; raises "not yet ported"
        where the JAX package takes its XLA grouped epoch."""
        if self.frequency_regularization:
            raise NotImplementedError("frequency_regularization=True runs "
                                      f"on {sp.XLA_EPOCH_NOT_PORTED}")
        if self.group_users:
            raise NotImplementedError("group_users sizes the user groups "
                                      f"of {sp.XLA_EPOCH_NOT_PORTED}")
        sp.require_kernel_path(self._num_items(), self.num_factors)
        data = self.ratings
        hu, hi = self._hist
        dev = resolve_device(self.device)
        self._plan = sp.prepare_svdpp_mxu(
            data.users, data.items, data.values, hu, hi,
            self.num_users_trained, self.num_items_trained,
            pass_len=sp.PASS_LEN, shuffle_seed=self.random_seed, device=dev)
        self._new_of_old = torch.from_numpy(
            self._plan.new_of_old.astype(np.int64)).to(dev)

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
            self.global_bias = self._init_global_bias()
        else:
            params = {k: torch.as_tensor(np.asarray(tables[k], np.float32),
                                         device=dev).clone()
                      for k in ("user_bias", "item_bias", "item_factors",
                                "y") + (("p",) if self.USE_P else ())}
            if params["user_bias"].shape[0] != U:
                raise ValueError(f"tables hold {params['user_bias'].shape[0]}"
                                 f" users, the data {U}")
            self.global_bias = float(tables["global_bias"])
        self.params = params
        self.current_learnrate = self.learn_rate

    def train(self):
        self.init_model()
        for _ in range(self.num_iter):
            self.iterate()

    def _ensure_epoch_ready(self):
        """Build the plan when missing, e.g. after ``load_model``."""
        if self._plan is None:
            self._prepare_epoch()

    def iterate(self):
        """One epoch through ``svdpp_epoch`` on the resident kernel-layout
        tables (JAX: ``_iterate_mxu``)."""
        self._ensure_epoch_ready()
        self._user_factors_cache = None
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
        U, I = self.num_users_trained, p["item_factors"].shape[0]
        u_ok = (users >= 0) & (users < U)
        i_ok = (items >= 0) & (items < I)
        uc = users.clamp(0, uf.shape[0] - 1)
        ic = items.clamp(0, I - 1)
        zero = torch.zeros((), dtype=torch.float32, device=uf.device)
        dot = (uf[uc] * p["item_factors"][ic]).sum(dim=-1)
        score = self.global_bias \
            + torch.where(u_ok, p["user_bias"][uc], zero) \
            + torch.where(i_ok, p["item_bias"][ic], zero) \
            + torch.where(u_ok & i_ok, dot, zero)
        return self._bound(score)

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

    def catalog_scorer(self):
        raise NotImplementedError(f"catalog_scorer is {_NOT_PORTED}")

    def score_catalog(self, users):
        raise NotImplementedError(f"score_catalog is {_NOT_PORTED}")

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
        self.num_factors = q.shape[1]
        self._mxu_tables = None
        self._prepare_edges()
        U = self.num_users_trained
        dev = resolve_device(self.device)
        tables = dict(user_bias=_rows(bu, U), item_bias=bi, item_factors=q,
                      y=y)
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
    for name in list(src.HYPERPARAMS) + list(src.EXTRA_PARAMS):
        if hasattr(src, name) and hasattr(dst, name):
            setattr(dst, name, getattr(src, name))
    dst.random_seed = src.random_seed


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
