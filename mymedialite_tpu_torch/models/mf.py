"""Matrix factorization rating predictors (plain + biased) of the port.

Counterparts of ``mymedialite_tpu/models/mf.py`` (reference
``RatingPrediction/MatrixFactorization.cs:50`` and
``RatingPrediction/BiasedMatrixFactorization.cs:77``). Training takes
one of three routes, as the JAX package on one TPU chip picks its epoch
(``_mxu_mode``): the chunked minibatch SGD epoch of
``ops/sgd_epoch.py`` — on a CUDA device the hand-written kernel
``csrc/sgd_epoch.cu``, one launch per epoch — over the chunk plan of
``ops/plan.py`` (resident, or slab-tiled for big catalogs), in the same
order and with the same update semantics as the JAX package's Pallas
epochs; or, with frequency regularization and past the tiled
schedule's ``MAX_SLABS``, the blocked minibatch epoch of ``ops/sgd.py``
(plain PyTorch, as the JAX package's XLA epoch), whose minibatches are
``batch_size`` ratings of one group of ``group_users`` users.

On a device mesh (the ``mesh`` attribute, None for one device;
``parallel/mesh.py``) the kernel routes become "sharded"
and "sharded-tiled" (JAX ``_mxu_mode`` on a mesh): the epoch runs the
same kernel once per cell of the DSGD diagonal (``sgd_epoch_sharded``),
on W shards and item partitions that stay on their devices across
``iterate()`` calls and are gathered back when the std tables are read.
Frequency regularization and catalogs past the sharded-tiled bound keep
the one-device blocked epoch, and say so in the log.

Tables: the fused std layout ([factors | b_u | 1] x [factors | 1 | b_i],
``ops/sgd.py extend_tables``) is what predict, the objective and
save/load read; the epoch runs on kernel-layout copies (user rows on
the user-block grid, item rows permuted onto the item-block grid,
columns padded to 64) that stay resident across ``iterate()`` calls and
fold back into the std layout when the std tables are read.

Everything computes in float32. ``mxu_dtype`` is accepted so that the
JAX package's option strings configure the port too; the bf16 operand
rounding it selects there is a TPU idiom and has no effect here. The
``max_threads`` / ``naive_parallelization`` knobs are likewise accepted
and unused; ``group_users`` sets the std layout's user padding, as in
the JAX package, and with ``batch_size`` the blocked epoch's groups and
minibatches.

Online updates (``add_ratings`` and its siblings, reference
MatrixFactorization.cs:142-160, 262-352; JAX ``mf.py:599-848``) refresh
only the touched rows: a fresh N(init_mean, init_stdev) row from the
model's own ``torch.Generator``, then ``num_iter`` gradient steps over
the entity's whole history against the frozen other side
(``learn_row``). They drop the epoch state (the chunk plan, the blocked
layout, the kernel-layout tables after folding them back), so that the
next ``iterate()`` plans on the grown ratings. Fold-in
(``score_items_foldin``) learns a row for an unseen user the same way
and changes nothing.
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

from mymedialite_tpu_torch.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu_torch.device import exact_float32, resolve_device
from mymedialite_tpu_torch.models.base import (
    FoldInRatingPredictor, IncrementalRatingPredictor, IterativeModel,
)
from mymedialite_tpu_torch.ops import plan as mxu
from mymedialite_tpu_torch.ops import sgd
from mymedialite_tpu_torch.ops.sgd_epoch import (
    sgd_epoch, sgd_epoch_sharded, sgd_epoch_sharded_tiled, sgd_epoch_tiled,
)
from mymedialite_tpu_torch.parallel.mesh import (
    DEFAULT_MESH, model_mesh, one_device_route,
)

# the fresh rows of the online updates come from a generator seeded
# with random_seed + _ROW_SEED_OFFSET (not the init draws' stream)
_ROW_SEED_OFFSET = 1


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


def row_rates(fe: int, learn_rate, reg, bias_lr, bias_reg, *, biased: bool,
              frozen_col: int, bias_col: int, device="cpu"):
    """(lr_vec, reg_vec) [fe] float32 of a row refresh: learn_rate and
    reg on the factor columns, bias_lr * learn_rate and bias_reg * reg
    on the bias column (0 for the plain model), 0 on the frozen column
    of 1s (JAX ``_learn_row_body``; the products in float32, as there)."""
    f32 = np.float32
    lr_vec = np.full(fe, f32(learn_rate), np.float32)
    reg_vec = np.full(fe, f32(reg), np.float32)
    lr_vec[frozen_col] = reg_vec[frozen_col] = 0.0
    lr_vec[bias_col] = f32(bias_lr) * f32(learn_rate) if biased else 0.0
    reg_vec[bias_col] = f32(bias_reg) * f32(reg) if biased else 0.0
    return (torch.from_numpy(lr_vec).to(device),
            torch.from_numpy(reg_vec).to(device))


def learn_row(row, other_rows, values, lr_vec, reg_vec, global_bias,
              min_rating, rating_range, *, num_iter: int, decay: float,
              biased: bool, loss: int):
    """``num_iter`` full-history gradient steps of one fused row against
    the frozen rows ``other_rows`` [L, fe] it was rated with (``values``
    [L]): the per-example error of the plain (raw score) or the biased
    (sigmoid, ``loss``) model, summed over the history, minus
    ``L * reg_vec * row``, times ``lr_vec``, the rate decaying by
    ``decay`` a step (JAX ``_learn_row_body``; reference LearnFactors on
    the ByUser / ByItem lists, MatrixFactorization.cs:142-160). Products
    in float32 without TF32."""
    n_real = float(values.numel())
    lr_scale = 1.0
    with exact_float32():
        for _ in range(num_iter):
            score = other_rows @ row
            if biased:
                sig = torch.sigmoid(score + global_bias)
                err = values - (min_rating + sig * rating_range)
                g = sgd.gradient_common(loss, err, sig, rating_range)
            else:
                g = values - (score + global_bias)
            grad = g @ other_rows - n_real * reg_vec * row
            row = row + lr_scale * lr_vec * grad
            lr_scale *= decay
    return row


class MatrixFactorization(IncrementalRatingPredictor, IterativeModel,
                          FoldInRatingPredictor):
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
    # the retrains read the histories through _rated_by_user / _item and
    # prediction touches only rows (u, i): buffered prequential eval and
    # chunked predictions are exact (eval/online.py)
    SUPPORTS_ONLINE_BUFFER = True
    ONLINE_PREDICT_ROW_LOCAL = True

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

        # the device mesh (parallel/mesh.py): every visible card by
        # default (model_mesh resolves it), None: one device
        self.mesh = DEFAULT_MESH
        self.register_buffer("_W_ext", None)   # [U_pad, f+2] std layout
        self.register_buffer("_H_ext", None)   # [I, f+2]
        # resident kernel-layout (W, H); on a mesh (W shards, partitions)
        self._mxu_tables = None
        self.global_bias = 0.0
        self.current_learnrate = None
        self._plan = None
        self._mesh = None           # the mesh of a sharded plan
        self._new_of_old = None
        self._blocked = None        # (data, meta, freq) of the blocked route
        self._order_gen = None      # draws the blocked epoch's batch orders
        self._row_gen = None        # draws the online updates' fresh rows
        self._group_rows = None     # the user rows of a group of the layout
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
        """The lazy write-back that reading ``W_ext`` / ``H_ext`` runs;
        local only: across processes ``iterate`` has gathered already."""
        if self._mxu_tables is not None:
            self._gather_tables()

    def _gather_tables(self):
        """The kernel-layout tables written back to the std tables. On a
        mesh of several processes a collective (``Mesh.gather_rows``),
        so every sharded ``iterate`` calls it at its end there, and no
        attribute access runs one."""
        We, He = self._mxu_tables
        if isinstance(We, list):
            # the mesh's W shards and item partitions, gathered on the
            # std tables' device; their pad rows are never read back
            dev = self._mxu_std_device
            We, He = self._mesh.gather_rows(We, dev), \
                self._mesh.gather_rows(He, dev)
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
        self._order_gen = None
        self._row_gen = None
        self._prepare_epoch_data()

    def _route(self) -> str:
        """"resident", "tiled" or "minibatch" (the blocked epoch) on one
        device, "sharded" or "sharded-tiled" on a mesh (``model_mesh``):
        the JAX package's choice (``_mxu_mode``), from the data, the
        hyperparameters and the mesh. The kernels take per-column rates,
        so frequency regularization takes the blocked epoch, on one
        device also on a mesh (its sharded form is not ported), as does
        a catalog past the sharded-tiled bound."""
        mesh = model_mesh(self)
        if self.frequency_regularization:
            route = "minibatch"
        else:
            route = mxu.select_schedule(self.ratings.num_items,
                                        self.num_factors,
                                        mesh.global_size if mesh else 1)
        if mesh is not None and not route.startswith("sharded"):
            one_device_route(self, route, mesh)
        return route

    def _prepare_epoch_data(self):
        # a new plan means a new item permutation: fold resident
        # kernel-layout tables back into the std layout first
        self._sync_std_tables()
        data = self.ratings
        dev = resolve_device(self.device)
        self._plan = None
        self._blocked = None
        self._flat_cache = None
        route = self._route()
        self._mesh = model_mesh(self) if route.startswith("sharded") else None
        if route == "minibatch":
            bdata, meta = sgd.prepare_blocked_data(
                data.users, data.items, data.values, data.num_users,
                self.batch_size, self.group_users,
                shuffle_seed=self.random_seed, device=dev)
            freq = None
            if self.frequency_regularization:
                freq = sgd.blocked_freq(
                    data.count_by_user, data.count_by_item,
                    meta["ngroups"] * meta["group_users"], dev)
            self._blocked = (bdata, meta, freq)
            self._group_rows = meta["group_users"]
            if self._order_gen is None:
                self._order_gen = torch.Generator()
                self._order_gen.manual_seed(self.random_seed)
            return
        if route == "sharded-tiled":
            # a mesh and a big catalog: slab-tiled partitions, the
            # histogram-optimal chunk as on the tiled route
            self._plan = mxu.prepare_mxu_sharded_tiled(
                data.users, data.items, data.values, data.num_users,
                data.num_items, self._mesh.global_size, user_block=512,
                item_block=1024, chunk=None,
                slab_blocks=mxu.default_slab_blocks(self.num_factors),
                shuffle_seed=self.random_seed, device=dev)
        elif route == "sharded":
            self._plan = mxu.prepare_mxu_sharded(
                data.users, data.items, data.values, data.num_users,
                data.num_items, self._mesh.global_size, user_block=512,
                item_block=1024, chunk=640, shuffle_seed=self.random_seed,
                device=dev)
        elif route == "tiled":
            # big catalogs: the histogram-optimal chunk keeps padding
            # bounded in their sparse (512 x 1024) cells
            self._plan = mxu.prepare_mxu_tiled(
                data.users, data.items, data.values, data.num_users,
                data.num_items, user_block=512, item_block=1024, chunk=None,
                slab_blocks=mxu.default_slab_blocks(self.num_factors),
                shuffle_seed=self.random_seed, device=dev)
        else:
            self._plan = mxu.prepare_mxu_data(
                data.users, data.items, data.values, data.num_users,
                data.num_items, user_block=512, item_block=1024, chunk=640,
                shuffle_seed=self.random_seed, device=dev)
        self._new_of_old = torch.from_numpy(
            self._plan.new_of_old.astype(np.int64)).to(dev)
        if self._mesh is not None:
            # the chunks once on each mesh device
            self._packed = self._mesh.replicate(self._plan.packed)

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
        """Build the chunk plan or the blocked layout when missing, e.g.
        after ``load_model``, so that iterate() continues training a
        loaded model; on the blocked route grow loaded tables to the
        epoch's padded user grid and to the catalog (JAX:
        ``_ensure_epoch_ready``)."""
        if self._plan is None and self._blocked is None:
            if self.ratings is None:
                raise RuntimeError(
                    f"{type(self).__name__}: no ratings set; assign "
                    ".ratings before iterating a loaded model")
            self._prepare_epoch_data()
        if self._blocked is None:
            return
        meta = self._blocked[1]
        need_u = meta["ngroups"] * meta["group_users"]
        W, H = self._W_ext, self._H_ext
        if W.shape[0] < need_u:
            pad = torch.zeros((need_u - W.shape[0], W.shape[1]),
                              dtype=W.dtype, device=W.device)
            pad[:, -1] = 1.0
            self.W_ext = torch.cat([W, pad])
        if H.shape[0] < self.ratings.num_items:
            pad = torch.zeros((self.ratings.num_items - H.shape[0],
                               H.shape[1]), dtype=H.dtype, device=H.device)
            pad[:, -2] = 1.0
            self.H_ext = torch.cat([H, pad])

    def _epoch_rates(self, update_user: bool, update_item: bool):
        """[fe, 4] per-column rates at the current learn rate."""
        f = self.num_factors
        return mxu.mxu_column_rates(
            f, mxu.fused_width(f), self.current_learnrate, self.reg_u,
            self.reg_i, getattr(self, "bias_learn_rate", 1.0),
            getattr(self, "bias_reg", 0.0), self.BIASED, update_user,
            update_item, device=self._plan.packed.device)

    def _batch_orders(self, ngroups: int, nb: int) -> torch.Tensor:
        """[ngroups, nb] int64 (host): each group's batch permutation for
        the next blocked epoch, from the model's own generator (the JAX
        package draws ``jax.random.permutation(fold_in(key, g), nb)``)."""
        return torch.stack([torch.randperm(nb, generator=self._order_gen)
                            for _ in range(ngroups)])

    def _iterate_blocked(self, update_user: bool, update_item: bool):
        """One blocked epoch on the std tables (JAX: ``iterate`` with
        ``sgd.sgd_epoch_blocked``)."""
        data, meta, freq = self._blocked
        W, H = self._W_ext, self._H_ext
        rates = sgd.column_rates(
            self.num_factors, self.current_learnrate, self.reg_u, self.reg_i,
            getattr(self, "bias_learn_rate", 1.0),
            getattr(self, "bias_reg", 0.0), self.BIASED, update_user,
            update_item, device=W.device)
        orders = self._batch_orders(meta["ngroups"],
                                    meta["l_pad"] // meta["batch"])
        hp = (self.global_bias, self.min_rating, self._rating_range())
        with torch.no_grad():
            sgd.sgd_epoch_blocked(W, H, data, orders, hp, rates, freq,
                                  meta=meta, loss=self.loss_id,
                                  biased=self.BIASED)
        self.update_learn_rate()

    def iterate(self, update_user: bool = True, update_item: bool = True):
        """One epoch: through ``sgd_epoch`` / ``sgd_epoch_tiled`` on the
        resident kernel-layout tables (JAX: ``_iterate_mxu``), on a mesh
        through ``sgd_epoch_sharded`` / ``sgd_epoch_sharded_tiled`` on
        the W shards and item partitions, or the blocked epoch on the std
        tables."""
        self._ensure_epoch_ready()
        if self._blocked is not None:
            return self._iterate_blocked(update_user, update_item)
        plan = self._plan
        mesh = self._mesh
        if self._mxu_tables is not None:
            We, He = self._mxu_tables
        else:
            self._mxu_std_shape = tuple(self._W_ext.shape)
            self._mxu_std_device = self._W_ext.device
            We, He = mxu.tables_std_to_mxu(
                self._W_ext, self._H_ext, self._new_of_old, u_pad=plan.u_pad,
                i_pad=plan.i_pad, fe_mxu=mxu.fused_width(self.num_factors))
            if mesh is not None:
                We, He = mesh.shard_rows(We), mesh.shard_rows(He)
        rates = self._epoch_rates(update_user, update_item)
        hp = (self.global_bias, self.min_rating, self._rating_range())
        self._epoch_counter += 1
        seed = (self.random_seed + 1) * 1_000_003 + self._epoch_counter
        kw = dict(user_block=plan.user_block, item_block=plan.item_block,
                  loss=self.loss_id, biased=self.BIASED)
        if mesh is not None:
            sharded = (sgd_epoch_sharded_tiled
                       if isinstance(plan, mxu.MxuShardedTiledPlan)
                       else sgd_epoch_sharded)
            if sharded is sgd_epoch_sharded_tiled:
                kw["slab_blocks"] = plan.slab_blocks
            sharded(mesh, We, He, self._packed, plan.epoch_order(seed),
                    plan.cell_counts, hp, rates, **kw)
        elif isinstance(plan, mxu.MxuTiledPlan):
            sgd_epoch_tiled(We, He, plan.packed, plan.epoch_order(seed), hp,
                            rates, slab_blocks=plan.slab_blocks, **kw)
        else:
            sgd_epoch(We, He, plan.packed, plan.epoch_order(seed), hp, rates,
                      **kw)
        self._mxu_tables = (We, He)
        if mesh is not None and mesh.process_count > 1:
            # every process holds the whole tables after each epoch, so
            # that each can predict, save and serve alone
            self._gather_tables()
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
        return float(sgd.mf_objective(
            self._params_dict(), data, hp, counts, loss=self.loss_id,
            biased=self.BIASED,
            frequency_regularization=self.frequency_regularization))

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

    def tables_device(self):
        if self._mxu_tables is not None:
            return self._mxu_std_device if self._mesh is not None \
                else self._mxu_tables[0].device
        if self._W_ext is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        return self._W_ext.device

    def catalog_scorer(self, device=None):
        """``fn(users) -> [len(users), num_items]`` on the tables' device
        (or on copies on ``device``; JAX: ``_mf_catalog_clip`` /
        ``_mf_catalog_sigmoid``): the fused ``W_ext @ H_ext.T`` over all
        columns (both biases inside) for the biased model, the factor
        columns alone for the plain one, plus the global bias, then the
        model's clip or sigmoid."""
        if self._W_ext is None and self._mxu_tables is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        W, H = self.W_ext, self.H_ext
        if device is not None:
            W, H = W.to(device), H.to(device)
        if not self.BIASED:
            f = self.num_factors
            W, H = W[:, :f], H[:, :f]
        gb, lo, hi = self.global_bias, self.min_rating, self.max_rating
        rng = max(hi - lo, 1e-9)
        sigmoid = self.BOUND == "sigmoid"

        def score(users):
            raw = gb + W[users.clamp(0, W.shape[0] - 1)] @ H.T
            if sigmoid:
                return lo + torch.sigmoid(raw) * rng
            return raw.clamp(lo, hi)
        return score

    def score_catalog(self, users):
        return self._scores_from_scorer(users)

    def predict_batch(self, users, items):
        W = self.W_ext
        dev = W.device
        u = torch.from_numpy(np.asarray(users, dtype=np.int64)).to(dev)
        i = torch.from_numpy(np.asarray(items, dtype=np.int64)).to(dev)
        with torch.no_grad():
            out = self._predict_pairs(W, self.H_ext, u, i)
        return out.cpu().numpy()

    # --- incremental updates (reference MatrixFactorization.cs:262-320) ---

    def add_user(self, user_id):
        """Grow W_ext to cover user_id, by whole groups of the std layout
        (JAX ``add_user``); new rows are [0 ... 0 | 0 | 1]."""
        super().add_user(user_id)
        W = self.W_ext
        grow = user_id + 1 - W.shape[0]
        if grow > 0:
            G = self._group_rows or self.group_users
            pad = W.new_zeros((-(-grow // G) * G, W.shape[1]))
            pad[:, -1] = 1.0
            self.W_ext = torch.cat([W, pad])

    def add_item(self, item_id):
        """Grow H_ext to cover item_id; new rows are [0 ... 0 | 1 | 0]."""
        super().add_item(item_id)
        H = self.H_ext
        grow = item_id + 1 - H.shape[0]
        if grow > 0:
            pad = H.new_zeros((grow, H.shape[1]))
            pad[:, -2] = 1.0
            self.H_ext = torch.cat([H, pad])

    def _drop_epoch_state(self):
        """Fold the kernel-layout tables back into the std tables and drop
        every layout built on the previous ratings (the chunk plan, the
        blocked layout, the objective's flat copy): the next iterate()
        plans on the current ratings."""
        self._sync_std_tables()
        self._plan = None
        self._blocked = None
        self._flat_cache = None

    def _retrain(self, users, items):
        """Refresh the touched rows only, users first (reference
        AddRatings, MatrixFactorization.cs:262-279)."""
        if self._W_ext is None and self._mxu_tables is None:
            return
        self._drop_epoch_state()
        for u in np.unique(np.asarray(users, dtype=np.int64)):
            self.add_user(int(u))
            if self.update_users:
                self.retrain_user(int(u))
        for i in np.unique(np.asarray(items, dtype=np.int64)):
            self.add_item(int(i))
            if self.update_items:
                self.retrain_item(int(i))

    def _online_flush(self):
        self._drop_epoch_state()

    def _fresh_row(self, frozen_col: int):
        """N(init_mean, init_stdev) factors, zero biases and the frozen
        column at 1, on the tables' device."""
        dev = self._W_ext.device
        if self._row_gen is None:
            self._row_gen = torch.Generator(device=dev)
            self._row_gen.manual_seed(self.random_seed + _ROW_SEED_OFFSET)
        f = self.num_factors
        row = torch.zeros(f + 2, dtype=torch.float32, device=dev)
        row[:f] = self.init_mean + self.init_stdev * torch.randn(
            f, generator=self._row_gen, device=dev)
        row[frozen_col] = 1.0
        return row

    def _row_args(self, side: str, reg):
        """(frozen_col, lr_vec, reg_vec, hp) of a refresh of a user
        ("user") or item row, at the model's learn_rate (not the decayed
        current rate, as in the JAX package)."""
        fe = self.num_factors + 2
        frozen, bias = (fe - 1, fe - 2) if side == "user" else (fe - 2, fe - 1)
        lr_vec, reg_vec = row_rates(
            fe, self.learn_rate, reg, getattr(self, "bias_learn_rate", 1.0),
            getattr(self, "bias_reg", 0.0), biased=self.BIASED,
            frozen_col=frozen, bias_col=bias, device=self._W_ext.device)
        hp = (float(np.float32(self.global_bias)),
              float(np.float32(self.min_rating)),
              float(np.float32(self._rating_range())))
        return frozen, lr_vec, reg_vec, hp

    def _learn(self, row, other, ids, values, lr_vec, reg_vec, hp):
        """``learn_row`` over the history (ids, values) against ``other``.
        An id past ``other`` reads its last row, as the JAX package's
        gather clamps (a user refreshed in the same batch as a new item
        it rated, before the item's row exists; ROADMAP §C)."""
        dev = other.device
        idx = torch.from_numpy(np.asarray(ids, dtype=np.int64)).to(dev)
        vals = torch.from_numpy(np.asarray(values, dtype=np.float32)).to(dev)
        rows = other[idx.clamp(0, other.shape[0] - 1)]
        return learn_row(row, rows, vals, lr_vec, reg_vec, *hp,
                         num_iter=self.num_iter, decay=self.learn_rate_decay,
                         biased=self.BIASED, loss=self.loss_id)

    def refresh_row(self, side: str, row_id: int):
        """Re-learn one user ("user") or item row from a fresh start row
        over its whole history, the other side frozen, and write it back
        (reference RetrainUser / RetrainItem,
        MatrixFactorization.cs:142-160)."""
        W, H = self.W_ext, self.H_ext
        if side == "user":
            own, other = W, H
            ids, vals = self._rated_by_user(row_id)
            reg = self.reg_u
        else:
            own, other = H, W
            ids, vals = self._rated_by_item(row_id)
            reg = self.reg_i
        frozen, lr_vec, reg_vec, hp = self._row_args(side, reg)
        with torch.no_grad():
            own[row_id] = self._learn(self._fresh_row(frozen), other, ids,
                                      vals, lr_vec, reg_vec, hp)

    def retrain_user(self, user_id):
        self.refresh_row("user", user_id)

    def retrain_item(self, item_id):
        self.refresh_row("item", item_id)

    def _reset_row(self, table, row_id: int, one_col: int):
        with torch.no_grad():
            table[row_id] = 0.0
            table[row_id, one_col] = 1.0

    def remove_user(self, user_id):
        super().remove_user(user_id)
        self._reset_row(self.W_ext, user_id, -1)

    def remove_item(self, item_id):
        super().remove_item(item_id)
        self._reset_row(self.H_ext, item_id, -2)

    # --- fold-in (reference MatrixFactorization.cs:326-352) ---

    def score_items_foldin(self, rated_items, candidates):
        """Scores of ``candidates`` for an unseen user given (item,
        rating) pairs: a user row learned as ``retrain_user`` learns one,
        with ``regularization``; the model does not change."""
        items = [i for i, _ in rated_items]
        values = [v for _, v in rated_items]
        H = self.H_ext
        frozen, lr_vec, reg_vec, hp = self._row_args(
            "user", self.regularization)
        with torch.no_grad():
            row = self._learn(self._fresh_row(frozen), H, items, values,
                              lr_vec, reg_vec, hp)
            cand = torch.as_tensor(list(candidates), dtype=torch.int64,
                                   device=H.device)
            score = self.global_bias + H[cand] @ row
            if self.BOUND == "sigmoid":
                score = self.min_rating + torch.sigmoid(score) * \
                    self._rating_range()
            else:
                score = score.clamp(self.min_rating, self.max_rating)
        return [(int(i), float(s)) for i, s in
                zip(cand.tolist(), score.cpu().numpy())]

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
        self._blocked = None
        self._row_gen = None
        self._group_rows = min(self.group_users, max(wu.shape[0], 1))


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
