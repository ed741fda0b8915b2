"""BPR-family item recommenders of the port.

Counterparts of ``mymedialite_tpu/models/bpr.py`` (reference
``ItemRecommendation/MF.cs:29``, ``BPRMF.cs:73``, ``WeightedBPRMF.cs:32``,
``SoftMarginRankingMF.cs:52``). Training runs the fused BPR epoch of
``ops/bpr_epoch.py`` — on a CUDA device the hand-written kernel
``csrc/bpr_epoch.cu``, one launch per epoch — over the chunk plan and
sampling state of ``ops/bpr_plan.py``, in the same order, with the same
negative-block draws and the same update semantics as the JAX package's
Pallas epoch: the resident schedule while the item table fits
``plan.RESIDENT_ITEM_TABLE_BYTES``, the slab-tiled one (sub-bucketed
membership keys, negative slabs drawn per group) past it. Past the tiled
schedule's ``MAX_SLABS`` slabs the models train on the minibatch epoch
of ``ops/bpr.py`` (plain PyTorch, the JAX package's XLA epoch): batches
of ``batch_size`` sampled triples, |feedback| triples per epoch, in the
regime the sampling switches select.

Tables: ``params`` (user_factors [U, f], item_factors [I, f], item_bias
[I]) is what predict, the objective and save/load read; the epoch runs
on kernel-layout copies that stay resident across ``iterate()`` calls
and fold back into ``params`` when it is read.

Everything computes in float32; ``mxu_dtype`` is accepted so that the
JAX package's option strings configure the port, and has no effect;
``batch_size`` sizes the minibatch epoch's batches.

Online updates (``add_feedback``, reference BPRMF.cs:391-422; JAX
``bpr.py:579-720``) grow the tables (new rows N(init_mean, init_stdev)
from the model's generator, new item biases 0), rebuild the sampling
state on the device from the new feedback (one sort), drop the chunk
plan and refresh the touched users: a fresh row, then one pairwise step
over |I_u| triples whose positives and negatives are drawn from that
state, never from a host CSR of every event. ``score_items_foldin``
learns a vector for an unseen user without changing the model.
On a device mesh (the ``mesh`` attribute, None for one device;
``parallel/mesh.py``) the kernel routes become "sharded"
and "sharded-tiled": the epoch runs the same kernel once per cell of the
DSGD diagonal (``bpr_epoch_sharded``), each cell's negatives drawn within
the item partition its device holds (JAX ``bpr.py:273-330``).
``MultiCoreBPRMF`` is BPRMF with a ``max_threads`` knob and takes the
same routes (JAX ``bpr.py:739-770``); its XLA fallback on a mesh is not
ported, so past the sharded-tiled bound it trains on one device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mymedialite_tpu_torch import trace
from mymedialite_tpu_torch.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu_torch.device import exact_float32, resolve_device
from mymedialite_tpu_torch.models.base import (
    FoldInItemRecommender, IncrementalItemRecommender, IterativeModel,
)
from mymedialite_tpu_torch.ops import bpr as bpr_ops
from mymedialite_tpu_torch.ops import bpr_plan
from mymedialite_tpu_torch.ops.bpr import bpr_objective
from mymedialite_tpu_torch.ops.bpr_epoch import (
    bpr_epoch, bpr_epoch_sharded, bpr_epoch_sharded_tiled, bpr_epoch_tiled,
)
from mymedialite_tpu_torch.ops.plan import (
    MxuShardedTiledPlan, default_slab_blocks, fused_width, select_schedule,
)
from mymedialite_tpu_torch.parallel.mesh import (
    DEFAULT_MESH, model_mesh, one_device_route,
)

# unknown users and items score float.MinValue (reference MF.Predict)
_UNKNOWN = -np.float32(3.4e38)


class ItemMF(IncrementalItemRecommender, IterativeModel):
    """Factor storage, init, prediction and save/load of the implicit-MF
    models (reference ItemRecommendation/MF.cs:29-196)."""

    EXTRA_PARAMS = {
        "init_mean": float,
        "init_stdev": float,
        "batch_size": int,
        "mxu_dtype": str,
        "device": str,
    }
    HAS_ITEM_BIAS = False

    def __init__(self):
        super().__init__()
        self.num_factors = 10
        self.num_iter = 30
        self.init_mean = 0.0
        self.init_stdev = 0.1
        self.batch_size = 8192
        self.mxu_dtype = "bf16"
        self.random_seed = 42
        self.device = "cuda"
        # the device mesh (parallel/mesh.py): every visible card by
        # default (model_mesh resolves it), None: one device
        self.mesh = DEFAULT_MESH
        self._params = None
        # resident kernel-layout (W, H); on a mesh (W shards, partitions)
        self._mxu_tables = None
        self._fused = None          # (tables, users, items) of fused_rows
        self._gen = None

    # --- params with lazy write-back of the kernel-layout tables ---

    @property
    def params(self):
        """The std tables, written back from the kernel layout at first
        read; local only: across processes ``iterate`` has gathered
        already."""
        if self._mxu_tables is not None:
            self._gather_tables()
        return self._params

    def _gather_tables(self):
        """The kernel-layout tables written back to ``params``. On a mesh
        of several processes a collective (``Mesh.gather_rows``), so every
        sharded ``iterate`` calls it at its end there, and no attribute
        access runs one."""
        self._params = self._materialize_params(self._mxu_tables)
        self._mxu_tables = None

    @params.setter
    def params(self, value):
        self._params = value
        self._mxu_tables = None

    def _materialize_params(self, tabs):
        raise NotImplementedError

    def init_model(self, tables=None):
        """N(mean, stdev) factors from a ``torch.Generator`` seeded by
        ``random_seed``; ``tables`` (from ``convert.bpr_tables_from_jax``)
        starts from given tables instead."""
        f = self.feedback
        dev = resolve_device(self.device)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(self.random_seed)
        if tables is None:
            def normal(shape):
                return self.init_mean + self.init_stdev * torch.randn(
                    shape, generator=self._gen, device=dev)
            self.params = dict(
                user_factors=normal((f.num_users, self.num_factors)),
                item_factors=normal((f.num_items, self.num_factors)))
        else:
            self.params = {k: torch.as_tensor(v, dtype=torch.float32,
                                              device=dev).clone()
                           for k, v in tables.items()}
            self.num_factors = self.params["user_factors"].shape[1]

    def train(self):
        self.init_model()
        for _ in range(self.num_iter):
            self.iterate()

    def iterate(self):
        raise NotImplementedError

    def predict_batch(self, users, items):
        p = self.params
        W, H = p["user_factors"], p["item_factors"]
        U, I = W.shape[0], H.shape[0]
        u = torch.from_numpy(np.asarray(users, dtype=np.int64)).to(W.device)
        i = torch.from_numpy(np.asarray(items, dtype=np.int64)).to(W.device)
        ok = (u >= 0) & (u < U) & (i >= 0) & (i < I)
        uc, ic = u.clamp(0, U - 1), i.clamp(0, I - 1)
        with torch.no_grad():
            score = (W[uc] * H[ic]).sum(dim=-1)
            if "item_bias" in p:
                score = score + p["item_bias"][ic]
            score = torch.where(ok, score, torch.full_like(score, _UNKNOWN))
        return score.cpu().numpy()

    def tables_device(self):
        if self._mxu_tables is not None:
            W = self._mxu_tables[0]
            return self._mxu_std_device if isinstance(W, list) else W.device
        if self._params is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        return self._params["user_factors"].device

    def catalog_scorer(self, device=None):
        """``fn(users)``: ``W[users] @ H.T`` (+ the item bias) on the
        tables' device, or on copies on ``device``."""
        if self.params is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        p = self.params
        W, H, bias = p["user_factors"], p["item_factors"], p.get("item_bias")
        if device is not None:
            W, H = W.to(device), H.to(device)
            bias = None if bias is None else bias.to(device)

        def score(users):
            s = W[users.clamp(0, W.shape[0] - 1)] @ H.T
            return s if bias is None else s + bias[None, :]
        return score

    def score_catalog(self, users):
        return self._scores_from_scorer(users)

    def fused_rows(self):
        """(users [U, f+1], items [I, f+1]) float32 on the tables' device,
        such that ``users[u] @ items.T`` is the catalog score of u: the
        user factors with a column of 1s against the item factors with
        the item bias (the plain factors for a model without one). This
        is what ``ops/topk.py recommend_batch`` hands the fused top-k
        kernel (``ops/catalog_topk.py``); the score equals
        ``catalog_scorer``'s up to the order of summation. Built once per
        trained state.

        The rating models have no such rows: their catalog score bounds
        ``gb + dot`` by a clip or a sigmoid, which sends distinct dots to
        equal float32 scores (every item past the scale's top clips to
        its maximum; the sigmoid saturates). The JAX package breaks those
        ties by the smaller id; a top-k over the raw dot would break them
        by the dot and give other ids."""
        p = self.params
        key = tuple(p.get(k) for k in ("user_factors", "item_factors",
                                       "item_bias"))
        if self._fused is None or any(
                a is not b for a, b in zip(self._fused[0], key)):
            W, H, bias = key
            if bias is not None:
                W = torch.cat([W, torch.ones_like(W[:, :1])], 1)
                H = torch.cat([H, bias[:, None]], 1)
            self._fused = (key, W.contiguous(), H.contiguous())
        return self._fused[1], self._fused[2]

    def save_model(self, path):
        p = self.params
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w.matrix(p["user_factors"].cpu().numpy())
            if "item_bias" in p:
                w.vector(p["item_bias"].cpu().numpy())
            w.matrix(p["item_factors"].cpu().numpy())

    def load_model(self, path):
        has_bias = "item_bias" in (self._params or {}) or self.HAS_ITEM_BIAS
        with ModelReader(path, type(self).__name__) as r:
            wu = r.matrix()
            bias = r.vector() if has_bias else None
            hi = r.matrix()
        if wu.shape[1] != hi.shape[1]:
            raise IOError("number of user and item factors must match")
        self.num_factors = wu.shape[1]
        self.num_users_trained = wu.shape[0]
        self.num_items_trained = hi.shape[0]
        dev = resolve_device(self.device)

        def tensor(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        params = dict(user_factors=tensor(wu), item_factors=tensor(hi))
        if bias is not None:
            params["item_bias"] = tensor(bias)
        self.params = params
        self._loaded()

    def _loaded(self):
        """Hook: drop the training state of the previous tables."""

    def _generator(self):
        """The model's generator on the tables' device (a loaded model
        seeds one from ``random_seed``)."""
        if self._gen is None:
            self._gen = torch.Generator(device=self.tables_device())
            self._gen.manual_seed(self.random_seed)
        return self._gen

    def _normal_rows(self, n: int) -> torch.Tensor:
        return self.init_mean + self.init_stdev * torch.randn(
            (n, self.num_factors), generator=self._generator(),
            device=self.tables_device())


class BPRMF(ItemMF, FoldInItemRecommender):
    """Bayesian Personalized Ranking MF (reference BPRMF.cs:73-553): SGD
    over (user, positive item, sampled negative item) triples, with an
    item bias and separate RegU / RegI / RegJ. One iteration is one pass
    of |feedback| triple updates through the fused epoch."""

    HYPERPARAMS = {
        "num_factors": int,
        "bias_reg": float,
        "reg_u": float,
        "reg_i": float,
        "reg_j": float,
        "num_iter": int,
        "learn_rate": float,
        "uniform_user_sampling": bool,
        "with_replacement": bool,
        "update_j": bool,
    }
    EXTRA_PARAMS = dict(ItemMF.EXTRA_PARAMS, num_neg_trials=int)

    HAS_ITEM_BIAS = True
    SOFT_MARGIN = False
    # online updates refresh the users, not the items (reference BPRMF
    # ctor)
    update_users = True
    update_items = False
    # WBPR popularity negatives (WeightedBPRMF): the negative block is
    # drawn by popularity mass and the local slot by inverse CDF
    MXU_POPULARITY = False
    # the minibatch epoch has a mesh form for this class (MultiCoreBPRMF)
    SHARDED_MINIBATCH = False

    def __init__(self):
        super().__init__()
        # defaults per reference BPRMF.cs:78-101
        self.bias_reg = 0.0
        self.reg_u = 0.0025
        self.reg_i = 0.0025
        self.reg_j = 0.00025
        self.learn_rate = 0.05
        self.uniform_user_sampling = True
        self.with_replacement = False
        self.update_j = True
        self.num_neg_trials = 8
        self._loss_sample = None
        self._plan = None
        self._tiled = None
        self._mesh = None           # the mesh of a sharded plan
        self._sampler = None        # the minibatch route's sampling state
        self._sharded = None        # its mesh form's (MultiCoreBPRMF)
        self._sampling = None       # (sampler, meta) of the feedback
        self._epoch_counter = 0

    def _regime(self) -> int:
        """The minibatch epoch's sampling regime (JAX: ``_regime``, WBPR
        for the popularity model): uniform-user sampling with or without
        replacement is the same iid draw."""
        if self.MXU_POPULARITY:
            return bpr_ops.WBPR
        if self.uniform_user_sampling:
            return bpr_ops.UNIFORM_USER
        return (bpr_ops.UNIFORM_PAIR if self.with_replacement
                else bpr_ops.UNIFORM_PAIR_WOR)

    def _hp(self):
        return dict(learn_rate=self.learn_rate, reg_u=self.reg_u,
                    reg_i=self.reg_i, reg_j=self.reg_j,
                    bias_reg=self.bias_reg)

    def init_model(self, tables=None):
        super().init_model(tables)
        if tables is None:
            self.params["item_bias"] = torch.zeros(
                self.feedback.num_items, dtype=torch.float32,
                device=self.params["user_factors"].device)
        self._build_epoch_state()

    def _build_epoch_state(self):
        """The feedback-derived training state: the sampling state and
        the fixed loss sample of sqrt(|U|) * 100 uniform-user triples
        drawn from it (reference BPRMF.cs:135-150); past the tiled bound
        the sampling state stays for the minibatch epoch, else the chunk
        plan is built at the next iterate()."""
        f = self.feedback
        n = int(math.isqrt(max(f.num_users - 1, 1))) * 100
        sampler, meta = self._build_sampling()
        self._loss_sample = bpr_ops.sample_triples(
            self._generator(), sampler, meta, max(n, 1),
            bpr_ops.UNIFORM_USER)[:3]

    def _build_sampling(self):
        """The sampling state of the current feedback, on the device
        (``make_sampler_data``: one sort of the user * num_items + item
        keys); drops the chunk plan and the fused rows, so that the next
        iterate() plans on this feedback. Past the tiled bound the state
        also feeds the minibatch epoch."""
        f = self.feedback
        dev = self.tables_device()
        sampler, meta = bpr_ops.make_sampler_data(f, self.num_neg_trials,
                                                  device=dev)
        self._sampling = (sampler, meta)
        self._plan = None
        self._fused = None
        self._sampler = None
        self._sharded = None
        if self._route() == "minibatch":
            pop = (bpr_ops.popularity_cdf(f.count_by_item, dev)
                   if self.MXU_POPULARITY else None)
            self._sampler = (sampler, meta, pop)
            mesh = model_mesh(self)
            if mesh is not None and self.SHARDED_MINIBATCH:
                self._build_sharded_sampling(mesh, pop)
        return sampler, meta

    def _build_sharded_sampling(self, mesh, pop):
        """The mesh's sampling state (``make_sampler_data_sharded``), one
        generator a device seeded from ``random_seed`` and the device, and
        the popularity CDF on each device (WBPR)."""
        data, meta = bpr_ops.make_sampler_data_sharded(
            self.feedback, mesh.global_size, self.num_neg_trials)
        gens = []
        for d, dev in enumerate(mesh.devices):
            gen = torch.Generator(device=dev)
            g = mesh.first_device + d
            gen.manual_seed((self.random_seed * 1_000_003 + g) & 0x7FFFFFFF)
            gens.append(gen)
        self._sharded = (mesh, bpr_ops.device_samplers(mesh, data, meta),
                         meta, gens, mesh.replicate(pop) if pop is not None
                         else None)

    def _loaded(self):
        self._loss_sample = None
        self._plan = None
        self._sampler = self._sharded = None
        self._sampling = None
        self._epoch_counter = 0

    def _ensure_epoch_ready(self):
        """Build the feedback-derived state when missing, e.g. after
        ``load_model``, so that iterate() continues training a loaded
        model."""
        if self._loss_sample is not None:
            return
        if self.feedback is None:
            raise RuntimeError(
                f"{type(self).__name__}: no feedback set; assign "
                ".feedback before iterating a loaded model")
        self._grow_tables()
        self._build_epoch_state()

    def _route(self) -> str:
        """"resident", "tiled" or "minibatch" on one device, "sharded" or
        "sharded-tiled" on a mesh (``model_mesh``), from the catalog, the
        factors and the mesh (JAX: ``_mxu_mode``); past the sharded-tiled
        bound the minibatch epoch runs on one device."""
        mesh = model_mesh(self)
        route = select_schedule(self.feedback.num_items, self.num_factors,
                                mesh.global_size if mesh else 1)
        if mesh is not None and not route.startswith("sharded") and not (
                route == "minibatch" and self.SHARDED_MINIBATCH):
            one_device_route(self, route, mesh)
        return route

    def _prepare_plan(self):
        f = self.feedback
        schedule = self._route()
        # a new plan means a new item permutation: fold resident tables
        # back into params first
        params = self.params
        dev = params["user_factors"].device
        tiled = schedule == "tiled"
        self._tiled = None
        self._mesh = None
        uniform_user = self.uniform_user_sampling and not self.MXU_POPULARITY
        # half the rating path's slab: each chunk reads two slabs
        half_slab = max(default_slab_blocks(self.num_factors) // 2, 1)
        if schedule.startswith("sharded"):
            self._mesh = model_mesh(self)
            if schedule == "sharded":
                prepare = bpr_plan.prepare_bpr_mxu_sharded
                kw = dict(chunk=640, bitmask="auto")
            else:
                prepare = bpr_plan.prepare_bpr_mxu_sharded_tiled
                kw = dict(slab_blocks=half_slab)
            self._plan, self._neg_state, self._neg_meta = prepare(
                f, self._mesh.global_size, uniform_user=uniform_user,
                shuffle_seed=self.random_seed,
                num_neg_trials=self.num_neg_trials, device=dev, **kw)
            self._new_of_old = torch.from_numpy(
                self._plan.new_of_old.astype(np.int64)).to(dev)
            # the chunks and the epoch's sampling tables once on each
            # mesh device
            self._packed = self._mesh.replicate(self._plan.packed)
            used = (("subkeys_tbl", "cdf_tbl") if schedule == "sharded-tiled"
                    else ("keys_tbl", "cdf_tbl", "bitmask_tbl"))
            self._mesh_state = {k: self._mesh.replicate(self._neg_state[k])
                                for k in used if k in self._neg_state}
            return
        self._plan, self._neg_state, self._neg_meta = bpr_plan.prepare_bpr_mxu(
            f, uniform_user=uniform_user, shuffle_seed=self.random_seed,
            num_neg_trials=self.num_neg_trials,
            # tiled: the histogram-optimal chunk, at a fixed cost of 256
            # slots per chunk, and sub-bucketed membership keys (the flat
            # key table stays small and unused), as the JAX model
            chunk=None if tiled else 640, kcap=128 if tiled else None,
            subkeys=tiled, ksub_cap=256 if tiled else None,
            bitmask=False if tiled else "auto",
            chunk_overhead=256 if tiled else 0, device=dev)
        self._new_of_old = torch.from_numpy(
            self._plan.new_of_old.astype(np.int64)).to(dev)
        if tiled:
            B, S, slab_items = bpr_plan.bpr_tiled_plan(
                self._plan, self._neg_state["nvalid"], slab_blocks=half_slab)
            self._tiled = dict(slab_blocks=B, num_slabs=S,
                               slab_items=slab_items)

    def _materialize_params(self, tabs):
        We, He = tabs
        if isinstance(We, list):
            # the mesh's W shards and item partitions, gathered on the
            # params' device; their pad rows are never read back
            dev = self._mxu_std_device
            We, He = self._mesh.gather_rows(We, dev), \
                self._mesh.gather_rows(He, dev)
        W, H, bias = bpr_plan.bpr_tables_from_mxu(
            We, He, self._new_of_old, num_users=self._mxu_num_users,
            num_factors=self.num_factors)
        return dict(user_factors=W, item_factors=H, item_bias=bias)

    def _epoch_bits(self, seed: int, nc: int, trials: int, C: int):
        """[nc, trials, C] int32 random bits for the epoch's sampler, from
        a ``torch.Generator`` seeded with ``seed & 0x7FFFFFFF``. The
        sampler reads the low 31 bits only, so the draws span [0, 2^31)."""
        dev = self._plan.packed.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed & 0x7FFFFFFF)
        return torch.randint(0, 2 ** 31, (nc, trials, C), dtype=torch.int32,
                             generator=gen, device=dev)

    def _iterate_minibatch(self):
        """One minibatch epoch on ``params`` (JAX: ``iterate`` with
        ``bpr_ops.bpr_epoch``), triples drawn from the model's
        generator; on a mesh, where the model has the sharded form
        (MultiCoreBPRMF), ``bpr_ops.bpr_epoch_sharded``."""
        if self._sharded is not None:
            return self._iterate_minibatch_sharded()
        sampler, meta, pop = self._sampler
        batch, num_batches = bpr_ops.epoch_batches(meta["num_events"],
                                                   self.batch_size)
        with torch.no_grad():
            bpr_ops.bpr_epoch(
                self.params, sampler, meta, self._gen, self._hp(), pop,
                batch_size=batch, num_batches=num_batches,
                regime=self._regime(), update_j=self.update_j,
                soft_margin=self.SOFT_MARGIN)

    def _iterate_minibatch_sharded(self):
        """One sharded minibatch epoch (JAX ``MultiCoreBPRMF.iterate``):
        per device min(batch_size, events // D) triples a step for its
        own users, ceil(events / (D x batch)) steps; W row-sharded,
        padded to u_loc x D rows."""
        mesh, samplers, meta, gens, pop = self._sharded
        p = self.params
        U = p["user_factors"].shape[0]
        rows = meta["u_loc"] * mesh.global_size
        W = p["user_factors"]
        if rows > U:
            W = torch.cat([W, W.new_zeros((rows - U, W.shape[1]))])
        batch, num_batches = bpr_ops.sharded_epoch_batches(
            meta["num_events"], self.batch_size, mesh.global_size)
        shards = mesh.shard_rows(W[:rows])
        with torch.no_grad():
            bpr_ops.bpr_epoch_sharded(
                mesh, dict(p, user_factors=shards), samplers, meta, gens,
                self._hp(), pop, batch_size=batch, num_batches=num_batches,
                regime=self._regime(), update_j=self.update_j,
                soft_margin=self.SOFT_MARGIN)
            p["user_factors"].copy_(mesh.gather_rows(
                shards, p["user_factors"].device)[:U])

    def iterate(self):
        """One epoch through ``bpr_epoch`` (or ``bpr_epoch_tiled``) on the
        resident kernel-layout tables (JAX: ``_iterate_mxu``), or the
        minibatch epoch past the tiled bound. Inside the span
        ``step.iterate`` (``trace.py``; attrs ``route`` and, on the kernel
        routes, ``epoch``)."""
        with trace.span("step.iterate") as step:
            self._ensure_epoch_ready()
            if self._plan is None and self._sampler is None:
                self._prepare_plan()
            if self._sampler is not None:
                step.set(route="minibatch")
                return self._iterate_minibatch()
            plan = self._plan
            f = self.num_factors
            fe = fused_width(f)
            mesh = self._mesh
            if self._mxu_tables is not None:
                We, He = self._mxu_tables
            else:
                with trace.span("step.tables"):
                    p = self._params
                    self._mxu_num_users = p["user_factors"].shape[0]
                    self._mxu_std_device = p["user_factors"].device
                    We, He = bpr_plan.bpr_tables_to_mxu(
                        p["user_factors"], p["item_factors"], p["item_bias"],
                        self._new_of_old, u_pad=plan.u_pad, i_pad=plan.i_pad,
                        fe=fe)
                    if mesh is not None:
                        We, He = mesh.shard_rows(We), mesh.shard_rows(He)
            rates = bpr_plan.bpr_mxu_column_rates(
                f, fe, self.learn_rate, self.reg_u, self.reg_i, self.reg_j,
                self.bias_reg, self.update_j, device=plan.packed.device)
            self._epoch_counter += 1
            step.set(route="mesh" if mesh is not None else "tiled"
                     if self._tiled is not None else "resident",
                     epoch=self._epoch_counter)
            trials, num_items = self._neg_meta[2], self._neg_meta[3]
            seed = (self.random_seed + 1) * 1_000_003 + self._epoch_counter
            state = self._neg_state
            block_mass = state["block_mass"] if self.MXU_POPULARITY else None
            if mesh is not None:
                self._iterate_sharded(We, He, seed, trials, rates, block_mass)
                self._mxu_tables = (We, He)
                if mesh.process_count > 1:
                    # every process holds the whole tables after each
                    # epoch, so that each can predict, save and serve alone
                    self._gather_tables()
                return
            with trace.span("step.bits"):
                bits = self._epoch_bits(seed, plan.num_chunks, trials,
                                        plan.chunk)
            if self._tiled is not None:
                tl = self._tiled
                order = bpr_plan.bpr_tiled_epoch_order(
                    plan, state["nvalid"], tl["slab_items"],
                    slab_blocks=tl["slab_blocks"], num_slabs=tl["num_slabs"],
                    num_items=num_items, seed=seed, block_mass=block_mass)
                bpr_epoch_tiled(
                    We, He, plan.packed, state["subkeys_tbl"],
                    state["cdf_tbl"], bits, order, rates,
                    slab_blocks=tl["slab_blocks"], user_block=plan.user_block,
                    item_block=plan.item_block, soft_margin=self.SOFT_MARGIN,
                    wbpr=self.MXU_POPULARITY, subkeys=True)
                self._mxu_tables = (We, He)
                return
            order = plan.epoch_order(seed)
            with trace.span("copy.order_back"):
                ub_visit = order[0].cpu().numpy()
            jb, nval, bkt = bpr_plan.epoch_negative_plan(
                plan, state["nvalid"], ub_visit, num_items,
                (self.random_seed + 7) * 999_983 + self._epoch_counter,
                block_mass=block_mass)
            bpr_epoch(We, He, plan.packed, state["keys_tbl"],
                      state["cdf_tbl"], bits, order, jb, nval, bkt, rates,
                      user_block=plan.user_block, item_block=plan.item_block,
                      soft_margin=self.SOFT_MARGIN, wbpr=self.MXU_POPULARITY,
                      bitmask_tbl=state.get("bitmask_tbl"))
            self._mxu_tables = (We, He)

    def _cell_bits(self, seed: int, trials: int) -> list:
        """[g][k] int32 random bits [n, trials, C] of each cell's n chunks
        on global device g, for this process's devices (None for the
        others'), from one ``torch.Generator`` a device seeded with a
        hash of ``seed`` and g."""
        plan, mesh = self._plan, self._mesh
        out = [None] * mesh.global_size
        for d, dev in enumerate(mesh.devices):
            g = mesh.first_device + d
            gen = torch.Generator(device=dev)
            gen.manual_seed((seed * 1_000_003 + g) & 0x7FFFFFFF)
            out[g] = [torch.randint(0, 2 ** 31, (int(n), trials, plan.chunk),
                                    dtype=torch.int32, generator=gen,
                                    device=dev)
                      for n in plan.cell_counts[g]]
        return out

    def _iterate_sharded(self, W_shards, H_parts, seed, trials, rates,
                         block_mass):
        """One epoch of the mesh's diagonal schedule (JAX: ``_iterate_mxu``
        on a ``BprShardedPlan`` / ``BprShardedTiledPlan``), in place on
        the shards and partitions."""
        plan, state = self._plan, self._neg_state
        tables = self._mesh_state
        kw = dict(part_blocks=plan.part_blocks, user_block=plan.user_block,
                  item_block=plan.item_block, soft_margin=self.SOFT_MARGIN,
                  wbpr=self.MXU_POPULARITY)
        bits = self._cell_bits(seed, trials)
        if isinstance(plan, MxuShardedTiledPlan):
            order = bpr_plan.bpr_sharded_tiled_epoch_order(
                plan, state["nvalid"], seed, block_mass=block_mass)
            bpr_epoch_sharded_tiled(
                self._mesh, W_shards, H_parts, self._packed,
                tables["subkeys_tbl"], tables["cdf_tbl"], bits, order,
                plan.cell_counts, rates, slab_blocks=plan.slab_blocks, **kw)
        else:
            order = bpr_plan.bpr_sharded_epoch_order(
                plan, state["nvalid"], seed, block_mass=block_mass)
            bpr_epoch_sharded(
                self._mesh, W_shards, H_parts, self._packed,
                tables["keys_tbl"], tables["cdf_tbl"], bits, order,
                plan.cell_counts, rates,
                bitmask_tbl=tables.get("bitmask_tbl"), **kw)

    def compute_objective(self):
        self._ensure_epoch_ready()
        u, i, j = self._loss_sample
        with torch.no_grad():
            return float(bpr_objective(self.params, self._hp(), u, i, j))

    # --- incremental updates (reference BPRMF.cs:391-422) ---

    def _grow_tables(self):
        """Rows for users and items the feedback has and the tables lack:
        N(init_mean, init_stdev) factors from the model's generator, item
        biases 0 (JAX ``_grow_tables``)."""
        f = self.feedback
        p = self.params
        grow_u = f.num_users - p["user_factors"].shape[0]
        grow_i = f.num_items - p["item_factors"].shape[0]
        if grow_u > 0:
            p["user_factors"] = torch.cat([p["user_factors"],
                                           self._normal_rows(grow_u)])
        if grow_i > 0:
            p["item_factors"] = torch.cat([p["item_factors"],
                                           self._normal_rows(grow_i)])
            p["item_bias"] = torch.cat([p["item_bias"],
                                        p["item_bias"].new_zeros(grow_i)])
        self._fused = None
        self.num_users_trained = max(self.num_users_trained, f.num_users)
        self.num_items_trained = max(self.num_items_trained, f.num_items)

    def _retrain(self, users, items):
        """Grow the tables, rebuild the sampling state from the current
        feedback, drop the chunk plan, then refresh the touched users
        (and items, with ``update_items``)."""
        if self._params is None and self._mxu_tables is None:
            return
        self._ensure_epoch_ready()  # a loaded model: build the state first
        self._grow_tables()
        self._build_sampling()
        with torch.no_grad():
            if self.update_users:
                for u in np.unique(np.asarray(users, dtype=np.int64)):
                    self.retrain_user(int(u))
            if self.update_items:
                for i in np.unique(np.asarray(items, dtype=np.int64)):
                    self.retrain_item(int(i))

    def retrain_user(self, user_id):
        """A fresh row, then one pairwise step over |I_u| triples:
        positives drawn from I_u, the first of ``num_neg_trials`` uniform
        candidates outside it as negatives (a triple without one weighs
        0); only the user row moves (reference RetrainUser,
        BPRMF.cs:391-403). I_u is the user's slice of the sampling
        state's sorted keys, duplicates kept."""
        p = self.params
        p["user_factors"][user_id] = self._normal_rows(1)[0]
        sampler, meta = self._sampling
        lo, hi = sampler["indptr"][user_id:user_id + 2].tolist()
        n = hi - lo
        if n == 0:
            return
        gen, dev = self._generator(), p["user_factors"].device
        items_u = sampler["hist_items"][lo:hi]
        pos = items_u[torch.randint(0, n, (n,), generator=gen, device=dev)]
        users = torch.full((n,), user_id, dtype=torch.int64, device=dev)
        cand = bpr_ops.negative_candidates(gen, meta["num_items"],
                                           meta["num_neg_trials"], n, dev)
        neg, ok = bpr_ops.first_negatives(sampler, users, cand,
                                          meta["num_items"])
        bpr_ops.bpr_step(p, users, pos, neg, ok, self._hp(), update_i=False,
                         update_j=False)

    def retrain_item(self, item_id):
        """A fresh item row, then pairwise steps over
        max(|events| / |items|, 1) triples of sampled users: item_id is
        the positive where the user has it (its row moves as i), else
        the negative against a sampled one (its row moves as j)
        (reference RetrainItem, BPRMF.cs:405-422)."""
        p = self.params
        p["item_factors"][item_id] = self._normal_rows(1)[0]
        sampler, meta = self._sampling
        gen, dev = self._generator(), p["user_factors"].device
        n = max(meta["num_events"] // max(meta["num_items"], 1), 1)
        valid = sampler["valid_users"]
        users = valid[torch.randint(0, valid.numel(), (n,), generator=gen,
                                    device=dev)]
        this = torch.full((n,), item_id, dtype=torch.int64, device=dev)
        is_pos = bpr_ops.segment_contains(sampler, users, this,
                                          meta["num_items"])
        cand = bpr_ops.negative_candidates(gen, meta["num_items"],
                                           meta["num_neg_trials"], n, dev)
        other, ok = bpr_ops.first_negatives(sampler, users, cand,
                                            meta["num_items"])
        pos = torch.where(is_pos, this, other)
        neg = torch.where(is_pos, other, this)
        w = ok.to(torch.float32)
        hp = self._hp()
        bpr_ops.bpr_step(p, users, pos, neg, w * is_pos, hp, update_u=False,
                         update_j=False)
        bpr_ops.bpr_step(p, users, pos, neg, w * ~is_pos, hp, update_u=False,
                         update_i=False, update_j=True)

    # --- fold-in (reference BPRMF.cs:497-542) ---

    def foldin_draws(self, accessed_items):
        """The draws of one fold-in: (start vector [f] on the device,
        positives and negatives [num_iter, |I|] numpy), the vector from
        the model's generator, the ids from a numpy generator seeded from
        it: each iteration |I| positives from the distinct accessed items
        and |I| negatives from the other items (the positives again when
        there are none)."""
        pos_set = np.unique(np.asarray(list(accessed_items), dtype=np.int32))
        I = self.params["item_factors"].shape[0]
        vec = self._normal_rows(1)[0]
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=self._generator(),
                                 device=vec.device).item())
        rng = np.random.default_rng(seed)
        neg_pool = np.setdiff1d(np.arange(I, dtype=np.int32), pos_set)
        pos, neg = [], []
        for _ in range(self.num_iter):
            p = rng.choice(pos_set, size=pos_set.size)
            pos.append(p)
            neg.append(rng.choice(neg_pool, size=pos_set.size)
                       if neg_pool.size else p)
        return vec, np.stack(pos), np.stack(neg)

    def foldin_vector(self, vec, pos, neg):
        """The fold-in loop on given draws: per iteration one BPR step of
        the user vector over the drawn (positive, negative) pairs, the
        item side frozen, ``reg_u`` times |I| (JAX
        ``score_items_foldin``)."""
        p = self.params
        H, bias = p["item_factors"], p["item_bias"]
        dev = H.device
        n = pos.shape[1]
        with torch.no_grad(), exact_float32():
            for it in range(pos.shape[0]):
                pi = torch.from_numpy(pos[it].astype(np.int64)).to(dev)
                nj = torch.from_numpy(neg[it].astype(np.int64)).to(dev)
                hi, hj = H[pi], H[nj]
                x = bias[pi] - bias[nj] + (hi - hj) @ vec
                g = torch.sigmoid(-x)
                vec = vec + self.learn_rate * (
                    (g[:, None] * (hi - hj)).sum(dim=0)
                    - self.reg_u * vec * n)
        return vec

    def score_items_foldin(self, accessed_items, candidates):
        """Scores of ``candidates`` for an unseen user who accessed
        ``accessed_items``: ``foldin_vector`` on ``foldin_draws``, then
        the item bias plus the product; the model does not change."""
        vec = self.foldin_vector(*self.foldin_draws(accessed_items))
        p = self.params
        cand = torch.as_tensor(list(candidates), dtype=torch.int64,
                               device=vec.device)
        with torch.no_grad(), exact_float32():
            scores = p["item_bias"][cand] + p["item_factors"][cand] @ vec
        return [(int(c), float(s)) for c, s in
                zip(cand.tolist(), scores.cpu().numpy())]


class MultiCoreBPRMF(BPRMF):
    """Reference MultiCoreBPRMF.cs:30 (hogwild BPR over index blocks).
    The JAX model prefers BPRMF's kernel routes, on a mesh the sharded
    ones (``models/bpr.py:739-770``), and so does the port: the DSGD
    cells of the mesh's diagonal, conflict-free where the reference
    tolerates races; on one device the kernel plan, or the minibatch
    epoch past the tiled bound. Past the sharded-tiled bound on a mesh
    it takes the sharded minibatch epoch (``ops/bpr.py
    bpr_epoch_sharded``, JAX ``models/bpr.py:770-800``): users split over
    the devices, item deltas merged every minibatch. ``max_threads`` is
    accepted and unused."""

    HYPERPARAMS = dict(BPRMF.HYPERPARAMS, max_threads=int)
    SHARDED_MINIBATCH = True

    def __init__(self):
        super().__init__()
        self.max_threads = 1

    def _setup_mesh(self):
        """The JAX model's hook (``models/bpr.py:739``): the mesh it
        trains on, ``model_mesh``; None on one device."""
        return model_mesh(self)


class WeightedBPRMF(BPRMF):
    """WBPR (reference WeightedBPRMF.cs:32): (u, i) uniform over events,
    negatives by popularity."""

    HYPERPARAMS = {
        "num_factors": int,
        "bias_reg": float,
        "reg_u": float,
        "reg_i": float,
        "reg_j": float,
        "num_iter": int,
        "learn_rate": float,
    }

    MXU_POPULARITY = True


class SoftMarginRankingMF(BPRMF):
    """Hinge-loss ranking MF (reference SoftMarginRankingMF.cs:52):
    updates only on margin violations."""

    SOFT_MARGIN = True

    def __init__(self):
        super().__init__()
        self.learn_rate = 0.1  # reference default
