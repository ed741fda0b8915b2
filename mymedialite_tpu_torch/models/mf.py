"""Matrix factorization rating predictors (plain + biased) of the port.

Counterparts of ``mymedialite_tpu/models/mf.py`` (reference
``RatingPrediction/MatrixFactorization.cs:50`` and
``RatingPrediction/BiasedMatrixFactorization.cs:77``). Training runs the
chunked minibatch SGD epoch of ``ops/sgd_epoch.py`` — on a CUDA device
the hand-written kernel ``csrc/sgd_epoch.cu``, one launch per epoch —
over the chunk plan of ``ops/plan.py``, in the same order and with the
same update semantics as the JAX package's resident Pallas epoch.

Tables: the fused std layout ([factors | b_u | 1] x [factors | 1 | b_i],
``ops/sgd.py extend_tables``) is what predict, the objective and
save/load read; the epoch runs on kernel-layout copies (user rows on
the user-block grid, item rows permuted onto the item-block grid,
columns padded to 64) that stay resident across ``iterate()`` calls and
fold back into the std layout when the std tables are read.

Everything computes in float32. ``mxu_dtype`` is accepted so that the
JAX package's option strings configure the port too; the bf16 operand
rounding it selects there is a TPU idiom and has no effect here. The
``max_threads`` / ``naive_parallelization`` / ``batch_size`` knobs are
likewise accepted and unused; ``group_users`` sets the std layout's user
padding, as in the JAX package.
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

from mymedialite_tpu.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu_torch.device import resolve_device
from mymedialite_tpu_torch.models.base import IterativeModel, RatingPredictor
from mymedialite_tpu_torch.ops import plan as mxu
from mymedialite_tpu_torch.ops import sgd
from mymedialite_tpu_torch.ops.sgd_epoch import sgd_epoch

_NOT_PORTED = "not yet ported to mymedialite_tpu_torch"


class OptimizationTarget(enum.Enum):
    """Reference OptimizationTarget enum (RMSE / MAE / LogisticLoss)."""
    RMSE = "RMSE"
    MAE = "MAE"
    LOGISTIC_LOSS = "LogisticLoss"


_LOSS_ID = {
    OptimizationTarget.RMSE: sgd.LOSS_RMSE,
    OptimizationTarget.MAE: sgd.LOSS_MAE,
    OptimizationTarget.LOGISTIC_LOSS: sgd.LOSS_LOGISTIC,
}


class MatrixFactorization(RatingPredictor, IterativeModel):
    """Plain MF: prediction = global_bias + <w_u, h_i>, clamped to the
    rating scale (reference MatrixFactorization.cs:50-217)."""

    HYPERPARAMS = {
        "num_factors": int,
        "regularization": float,
        "learn_rate": float,
        "learn_rate_decay": float,
        "num_iter": int,
    }
    EXTRA_PARAMS = {
        "init_mean": float,
        "init_stdev": float,
        "batch_size": int,
        "group_users": int,
        "mxu_dtype": str,
        "device": str,
    }

    BIASED = False
    BOUND = "clip"

    def __init__(self):
        super().__init__()
        # defaults per reference MatrixFactorization.cs:87-95
        self.num_factors = 10
        self.regularization = 0.015
        self.learn_rate = 0.01
        self.learn_rate_decay = 1.0
        self.num_iter = 30
        self.init_mean = 0.0
        self.init_stdev = 0.1
        self.batch_size = 131_072
        self.group_users = 16_384
        self.mxu_dtype = "bf16"
        self.random_seed = 42
        self.device = "cuda"

        self.register_buffer("_W_ext", None)   # [U_pad, f+2] std layout
        self.register_buffer("_H_ext", None)   # [I, f+2]
        self._mxu_tables = None     # resident kernel-layout (W, H)
        self.global_bias = 0.0
        self.current_learnrate = None
        self._plan = None
        self._new_of_old = None
        self._flat_cache = None
        self._epoch_counter = 0

    # --- std tables with lazy kernel-layout write-back ---

    @property
    def W_ext(self):
        self._sync_std_tables()
        return self._W_ext

    @W_ext.setter
    def W_ext(self, v):
        self._W_ext = v
        self._mxu_tables = None

    @property
    def H_ext(self):
        self._sync_std_tables()
        return self._H_ext

    @H_ext.setter
    def H_ext(self, v):
        self._H_ext = v
        self._mxu_tables = None

    def _sync_std_tables(self):
        if self._mxu_tables is None:
            return
        We, He = self._mxu_tables
        num_users_pad, fe_std = self._mxu_std_shape
        self._W_ext, self._H_ext = mxu.tables_mxu_to_std(
            We, He, self._new_of_old, num_users_pad=num_users_pad,
            fe_std=fe_std)
        self._mxu_tables = None

    # --- hyperparameter plumbing ---

    @property
    def reg_u(self):
        return getattr(self, "_reg_u", self.regularization)

    @reg_u.setter
    def reg_u(self, v):
        self._reg_u = float(v)

    @property
    def reg_i(self):
        return getattr(self, "_reg_i", self.regularization)

    @reg_i.setter
    def reg_i(self, v):
        self._reg_i = float(v)

    @property
    def loss_id(self):
        return sgd.LOSS_RMSE

    @property
    def frequency_regularization(self):
        return False

    def _rating_range(self) -> float:
        return max(self.max_rating - self.min_rating, 1e-9)

    # --- model init / training ---

    def _init_global_bias(self):
        return float(self.ratings.average)

    def init_model(self, tables=None):
        """N(mean, stdev) factor init from a ``torch.Generator`` seeded by
        ``random_seed``, zero rows for entities without training examples
        (reference MatrixFactorization.cs:99-116). ``tables`` (from
        ``convert.tables_from_jax``) starts from given tables instead."""
        data = self.ratings
        dev = resolve_device(self.device)
        if tables is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(self.random_seed)
            U, I, f = data.num_users, data.num_items, self.num_factors
            wu = self.init_mean + self.init_stdev * torch.randn(
                (U, f), generator=gen, device=dev)
            hi = self.init_mean + self.init_stdev * torch.randn(
                (I, f), generator=gen, device=dev)
            wu[torch.from_numpy(data.count_by_user == 0).to(dev)] = 0.0
            hi[torch.from_numpy(data.count_by_item == 0).to(dev)] = 0.0
            self.W_ext, self.H_ext = sgd.extend_tables(
                wu, hi, group_users=self.group_users)
            self.global_bias = self._init_global_bias()
        else:
            self.W_ext = torch.as_tensor(tables["W_ext"], dtype=torch.float32,
                                         device=dev).clone()
            self.H_ext = torch.as_tensor(tables["H_ext"], dtype=torch.float32,
                                         device=dev).clone()
            self.global_bias = float(tables["global_bias"])
            self.min_rating = tables["min_rating"]
            self.max_rating = tables["max_rating"]
            self.num_users_trained = tables["num_users_trained"]
        self.current_learnrate = self.learn_rate
        self._prepare_epoch_data()

    def _prepare_epoch_data(self):
        if self.frequency_regularization:
            raise NotImplementedError(
                f"frequency_regularization=True is {_NOT_PORTED}")
        # a new plan means a new item permutation: fold resident
        # kernel-layout tables back into the std layout first
        self._sync_std_tables()
        data = self.ratings
        dev = resolve_device(self.device)
        self._plan = mxu.prepare_mxu_data(
            data.users, data.items, data.values, data.num_users,
            data.num_items, user_block=512, item_block=1024, chunk=640,
            shuffle_seed=self.random_seed, device=dev)
        self._new_of_old = torch.from_numpy(
            self._plan.new_of_old.astype(np.int64)).to(dev)
        self._flat_cache = None

    def _flat_data(self):
        """Every training rating once, on device, for the objective."""
        if self._flat_cache is None:
            data = self.ratings
            dev = resolve_device(self.device)
            self._flat_cache = (
                dict(users=torch.from_numpy(data.users.astype(np.int64)).to(dev),
                     items=torch.from_numpy(data.items.astype(np.int64)).to(dev),
                     values=torch.from_numpy(
                         data.values.astype(np.float32)).to(dev)),
                dict(count_user=torch.from_numpy(
                         np.asarray(data.count_by_user)).to(dev),
                     count_item=torch.from_numpy(
                         np.asarray(data.count_by_item)).to(dev)))
        return self._flat_cache

    def train(self):
        self.init_model()
        for _ in range(self.num_iter):
            self.iterate()

    def _ensure_epoch_ready(self):
        """Build the chunk plan when missing, e.g. after ``load_model``,
        so that iterate() continues training a loaded model."""
        if self._plan is None:
            if self.ratings is None:
                raise RuntimeError(
                    f"{type(self).__name__}: no ratings set; assign "
                    ".ratings before iterating a loaded model")
            self._prepare_epoch_data()

    def _epoch_rates(self, update_user: bool, update_item: bool):
        """[fe, 4] per-column rates at the current learn rate."""
        f = self.num_factors
        return mxu.mxu_column_rates(
            f, mxu.fused_width(f), self.current_learnrate, self.reg_u,
            self.reg_i, getattr(self, "bias_learn_rate", 1.0),
            getattr(self, "bias_reg", 0.0), self.BIASED, update_user,
            update_item, device=self._plan.packed.device)

    def iterate(self, update_user: bool = True, update_item: bool = True):
        """One epoch through ``sgd_epoch`` on the resident kernel-layout
        tables (JAX: ``_iterate_mxu``)."""
        self._ensure_epoch_ready()
        plan = self._plan
        if self._mxu_tables is not None:
            We, He = self._mxu_tables
        else:
            self._mxu_std_shape = tuple(self._W_ext.shape)
            We, He = mxu.tables_std_to_mxu(
                self._W_ext, self._H_ext, self._new_of_old, u_pad=plan.u_pad,
                i_pad=plan.i_pad, fe_mxu=mxu.fused_width(self.num_factors))
        rates = self._epoch_rates(update_user, update_item)
        hp = (self.global_bias, self.min_rating, self._rating_range())
        self._epoch_counter += 1
        seed = (self.random_seed + 1) * 1_000_003 + self._epoch_counter
        sgd_epoch(We, He, plan.packed, plan.epoch_order(seed), hp, rates,
                  user_block=plan.user_block, item_block=plan.item_block,
                  loss=self.loss_id, biased=self.BIASED)
        self._mxu_tables = (We, He)
        self.update_learn_rate()

    def update_learn_rate(self):
        self.current_learnrate *= self.learn_rate_decay

    def _params_dict(self):
        f = self.num_factors
        U = self.num_users_trained
        W, H = self.W_ext, self.H_ext
        return dict(global_bias=self.global_bias,
                    user_factors=W[:U, :f], item_factors=H[:, :f],
                    user_bias=W[:U, f], item_bias=H[:, f + 1])

    def compute_objective(self) -> float:
        self._ensure_epoch_ready()
        data, counts = self._flat_data()
        hp = dict(min_rating=self.min_rating,
                  rating_range=self._rating_range(),
                  reg_u=self.reg_u, reg_i=self.reg_i,
                  bias_reg=getattr(self, "bias_reg", 0.0))
        return float(sgd.mf_objective(self._params_dict(), data, hp, counts,
                                      loss=self.loss_id, biased=self.BIASED))

    # --- prediction ---

    def _predict_pairs(self, W, H, users, items):
        """Out-of-range ids contribute only the global bias (reference
        Predict bounds checks); JAX: ``_pairs_from_rows``."""
        f = W.shape[1] - 2
        u_ok = (users >= 0) & (users < self.num_users_trained)
        i_ok = (items >= 0) & (items < H.shape[0])
        wu = W[users.clamp(0, W.shape[0] - 1)]
        hi = H[items.clamp(0, H.shape[0] - 1)]
        dot = (wu[:, :f] * hi[:, :f]).sum(dim=-1)
        zero = torch.zeros((), dtype=torch.float32, device=W.device)
        score = self.global_bias + torch.where(u_ok & i_ok, dot, zero)
        if self.BIASED:
            score = score + torch.where(u_ok, wu[:, f], zero)
            score = score + torch.where(i_ok, hi[:, f + 1], zero)
        if self.BOUND == "sigmoid":
            return self.min_rating + torch.sigmoid(score) * (
                self.max_rating - self.min_rating)
        return score.clamp(self.min_rating, self.max_rating)

    def pair_scorer(self):
        if self._W_ext is None:
            return None
        W, H = self.W_ext, self.H_ext
        return lambda users, items: self._predict_pairs(W, H, users, items)

    def predict_batch(self, users, items):
        W = self.W_ext
        dev = W.device
        u = torch.from_numpy(np.asarray(users, dtype=np.int64)).to(dev)
        i = torch.from_numpy(np.asarray(items, dtype=np.int64)).to(dev)
        with torch.no_grad():
            out = self._predict_pairs(W, self.H_ext, u, i)
        return out.cpu().numpy()

    # --- incremental updates: not ported yet ---

    def retrain_user(self, user_id):
        raise NotImplementedError(f"retrain_user is {_NOT_PORTED}")

    def retrain_item(self, item_id):
        raise NotImplementedError(f"retrain_item is {_NOT_PORTED}")

    # --- persistence (reference MatrixFactorization SaveModel/LoadModel) ---

    def save_model(self, path):
        wu, hi, _, _ = sgd.split_tables(self.W_ext, self.H_ext,
                                        self.num_users_trained)
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.scalar(self.global_bias)
            w.matrix(wu)
            w.matrix(hi)

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            gb = r.scalar()
            wu = r.matrix()
            hi = r.matrix()
        self._set_loaded(gb, wu, hi)

    def _set_loaded(self, gb, wu, hi, bu=None, bi=None):
        if wu.shape[1] != hi.shape[1]:
            raise IOError("number of user and item factors must match")
        self.num_factors = wu.shape[1]
        self.num_users_trained = wu.shape[0]
        self.num_items_trained = hi.shape[0]
        self.global_bias = gb
        self.W_ext, self.H_ext = sgd.extend_tables(
            wu, hi, bu, bi, group_users=self.group_users,
            device=resolve_device(self.device))
        self.current_learnrate = self.learn_rate
        self._plan = None


class BiasedMatrixFactorization(MatrixFactorization):
    """The flagship rating predictor (reference
    BiasedMatrixFactorization.cs:77): prediction =
    min + sigmoid(global + b_u + b_i + <w_u,h_i>) * range."""

    HYPERPARAMS = {
        "num_factors": int,
        "bias_reg": float,
        "reg_u": float,
        "reg_i": float,
        "frequency_regularization": bool,
        "learn_rate": float,
        "bias_learn_rate": float,
        "learn_rate_decay": float,
        "num_iter": int,
        "bold_driver": bool,
        "loss": OptimizationTarget,
        "max_threads": int,
        "naive_parallelization": bool,
    }
    EXTRA_PARAMS = {
        "regularization": float,
        "init_mean": float,
        "init_stdev": float,
        "batch_size": int,
        "group_users": int,
        "mxu_dtype": str,
        "device": str,
    }

    BIASED = True
    BOUND = "sigmoid"

    def __init__(self):
        super().__init__()
        # defaults per reference BiasedMatrixFactorization.cs:85-92
        self.bias_reg = 0.01
        self.bias_learn_rate = 1.0
        self.frequency_regularization = False
        self.bold_driver = False
        self.loss = OptimizationTarget.RMSE
        self.max_threads = 1
        self.naive_parallelization = False
        self._last_loss = -math.inf

    # BiasedMF's Regularization setter fans out to RegU/RegI
    # (reference BiasedMatrixFactorization.cs:96-103)
    @property
    def regularization(self):
        return getattr(self, "_regularization", 0.015)

    @regularization.setter
    def regularization(self, v):
        self._regularization = float(v)
        self._reg_u = float(v)
        self._reg_i = float(v)

    @property
    def frequency_regularization(self):
        return getattr(self, "_freq_reg", False)

    @frequency_regularization.setter
    def frequency_regularization(self, v):
        self._freq_reg = bool(v)

    @property
    def loss_id(self):
        return _LOSS_ID[self.loss]

    def _init_global_bias(self):
        # logit of the normalized average (reference Train :188-190)
        avg = (self.ratings.average - self.min_rating) / self._rating_range()
        avg = min(max(avg, 1e-6), 1 - 1e-6)
        return math.log(avg / (1 - avg))

    def init_model(self, tables=None):
        super().init_model(tables)
        if self.bold_driver:
            self._last_loss = self.compute_objective()

    def update_learn_rate(self):
        """Bold driver (reference UpdateLearnRate :225-244): halve on an
        objective increase, *1.05 on a decrease."""
        if self.bold_driver:
            loss = self.compute_objective()
            if loss > self._last_loss:
                self.current_learnrate *= 0.5
            elif loss < self._last_loss:
                self.current_learnrate *= 1.05
            self._last_loss = loss
        else:
            self.current_learnrate *= self.learn_rate_decay

    # persistence (reference BiasedMatrixFactorization.cs:339-402)

    def save_model(self, path):
        wu, hi, bu, bi = sgd.split_tables(self.W_ext, self.H_ext,
                                          self.num_users_trained)
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.scalar(self.global_bias)
            w.scalar(self.min_rating)
            w.scalar(self.max_rating)
            w.vector(bu)
            w.matrix(wu)
            w.vector(bi)
            w.matrix(hi)

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            gb = r.scalar()
            self.min_rating = r.scalar()
            self.max_rating = r.scalar()
            bu = r.vector()
            wu = r.matrix()
            bi = r.vector()
            hi = r.matrix()
        if bu.shape[0] != wu.shape[0] or bi.shape[0] != hi.shape[0]:
            raise IOError("bias/factor dimensions must match")
        self._set_loaded(gb, wu, hi, bu, bi)
