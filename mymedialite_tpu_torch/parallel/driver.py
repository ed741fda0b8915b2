"""Every mesh route of the port across processes on ``torch.distributed``
(the port's counterpart of the JAX package's two-process driver).

    python -m mymedialite_tpu_torch.parallel.driver MODE PORT PID OUT
        [--device cuda:0|own|cpu] [--shape small|check]

MODE ``dist``: one of two cooperating processes, 2 mesh devices each (a
4-device global mesh), through the multi-host functions of
``parallel/mesh.py``: ``initialize_distributed`` (from the
``JAX_COORDINATOR`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
variables this module sets from PORT and PID) -> ``make_global_mesh``,
then every route (``ROUTES``) on the same data, each process holding
its shards and the routes' collectives joining them:

- ``blocked``: one ``sgd_epoch_blocked_sharded`` step, each process
  loading only its groups (``host_local_rows`` -> ``shard_host_local``);
- ``sgd_epoch``, ``sgd_epoch_tiled``, ``bpr_epoch``,
  ``bpr_epoch_tiled``: one epoch of kernels 1-4's sharded wrappers, each
  process launching its cells, the partitions passed around the ring;
  on a card each is also run with ``plain=True`` from the same inputs
  and held to it (``plain_err``);
- ``mf_train`` / ``bpr_train``: BiasedMatrixFactorization and BPRMF
  ``train()`` on the "sharded" route, one more ``iterate()``, and their
  predictions on fixed pairs, read first by process 0 alone;
- ``mf_default``: ``mf_train`` with the model's mesh left at its
  default, which resolves to the global mesh (``default_mesh``, pointed
  at the process's devices): the same tables;
- ``svdpp``: SVDPlusPlus on the sharded grouped epoch;
- ``wrmf``: WRMF on the sharded solves;
- ``bpr_minibatch``: the sharded minibatch BPR epoch;
- ``ranking``: the data-parallel ranking eval of ``bpr_train``'s model
  (so after it);
- ``flat``: the flat epoch data-parallel over the mesh.

MODE ``single``: the one-process 4-device run of the same routes. OUT:
a ``.npz`` of each route's tables and results under ``ROUTE/NAME``,
equal on both processes; ``local/...`` the process's own BPR negatives
(global device g, sub-epoch k), ``ms/ROUTE`` its time (CUDA events on a
card; for kernels 1-4's routes the wrapper call alone, without the plan,
the tables' sharding and gathering and the plain rerun),
``launches/ROUTE`` the kernel cells it launched and ``plain_err/ROUTE``
its kernel cells against their plain versions.
``--device``: the mesh devices, ``cuda:0`` (the default; both processes
on one card: gloo, since NCCL refuses two ranks on one card), ``own``
(card PID for process PID: NCCL) or ``cpu`` (gloo). ``--shape``:
``small`` (2,000 x 3,000 x 20,000 ratings, k=16) or ``check`` (2,000 x
3,000 x 100,000, k=40). Asking for a card where there is none raises.
Prints one ``route ROUTE: ...`` line a route and ``driver-ok MODE PID``
at the end.
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import timedelta

import numpy as np
import torch

SHAPES = {"small": dict(num_users=2000, num_items=3000, num_ratings=20_000,
                        k=16, batch=256),
          "check": dict(num_users=2000, num_items=3000, num_ratings=100_000,
                        k=40, batch=1024)}
ROUTES = ("blocked", "sgd_epoch", "sgd_epoch_tiled", "bpr_epoch",
          "bpr_epoch_tiled", "mf_train", "mf_default", "bpr_train", "svdpp",
          "wrmf", "bpr_minibatch", "ranking", "flat")
# the kernel routes: their wrapper (whose launches count) per route
KERNEL_ROUTES = {"sgd_epoch": "sgd_epoch", "sgd_epoch_tiled":
                 "sgd_epoch_tiled", "bpr_epoch": "bpr_epoch",
                 "bpr_epoch_tiled": "bpr_epoch_tiled", "mf_train":
                 "sgd_epoch", "mf_default": "sgd_epoch",
                 "bpr_train": "bpr_epoch"}
# a collective that waits longer fails the run instead of hanging it
COLLECTIVE_TIMEOUT_S = 240


def build_data(shape: str):
    """(ratings, feedback, train, test): ``synthetic_ratings`` of the
    shape (seed 3, phase 3's data at ``check``), its pairs as
    positive-only feedback, and that feedback split 80/20."""
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, split_ratings, synthetic_ratings,
    )
    s = SHAPES[shape]
    data = synthetic_ratings(num_users=s["num_users"],
                             num_items=s["num_items"],
                             num_ratings=s["num_ratings"], seed=3)
    train, test = split_ratings(data, 0.2, seed=2)
    return (data, posonly_from_ratings(data), posonly_from_ratings(train),
            posonly_from_ratings(test))


def _normal(rng, *shape):
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


class Routes:
    """The routes on one mesh; each returns a dict of host arrays."""

    def __init__(self, mesh, shape: str):
        self.mesh = mesh
        self.dev = mesh.devices[0]
        self.s = SHAPES[shape]
        self.data, self.feedback, self.train, self.test = build_data(shape)
        self.local = {}
        self.plain_err = {}
        self.epoch_ms = {}
        self.bpr_model = None

    def tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    # --- the blocked MF epoch, from this process's groups only ---

    def blocked(self):
        from mymedialite_tpu_torch.ops import sgd
        from mymedialite_tpu_torch.parallel.mesh import (
            host_local_rows, shard_host_local,
        )
        mesh, data, k = self.mesh, self.data, self.s["k"]
        U = data.num_users
        G = -(-U // (2 * mesh.global_size))
        bdata, meta = sgd.prepare_blocked_data(
            data.users, data.items, data.values, U,
            batch_size=self.s["batch"], group_users=G, shuffle_seed=4)
        rng = np.random.default_rng(1)
        W, H = sgd.extend_tables(_normal(rng, U, k),
                                 _normal(rng, data.num_items, k),
                                 _normal(rng, U), _normal(rng, data.num_items),
                                 group_users=G)
        lo, hi = host_local_rows(meta["ngroups"])
        local = {key: v[lo:hi] for key, v in bdata.items()}
        W_sh = shard_host_local(mesh, W[lo * G:hi * G].numpy())
        H_dev = H.to(self.dev)
        gl = meta["ngroups"] // mesh.global_size
        nb = meta["l_pad"] // meta["batch"]
        orders = np.stack([np.random.default_rng(2 + g).permutation(nb)
                           for g in range(gl)])
        rates = sgd.column_rates(k, 0.01, 0.015, 0.015, 1.0, 0.01, True,
                                 True, True, device=self.dev)
        sgd.sgd_epoch_blocked_sharded(
            mesh, W_sh, H_dev, local, orders, (float(data.average), 1.0, 4.0),
            rates, meta=meta, loss=sgd.LOSS_RMSE, biased=True)
        return dict(W=mesh.gather_rows(W_sh, "cpu").numpy(),
                    H=H_dev.cpu().numpy())

    # --- kernels 1-4's sharded epochs through their wrappers ---

    def _sgd(self, tiled: bool):
        from mymedialite_tpu_torch.ops import plan as mxu
        from mymedialite_tpu_torch.ops import sgd_epoch as se
        mesh, data, k = self.mesh, self.data, self.s["k"]
        args = (data.users, data.items, data.values, data.num_users,
                data.num_items, mesh.global_size)
        if tiled:
            plan = mxu.prepare_mxu_sharded_tiled(
                *args, chunk=None, slab_blocks=1, shuffle_seed=4,
                device=self.dev)
        else:
            plan = mxu.prepare_mxu_sharded(*args, chunk=640, shuffle_seed=4,
                                           device=self.dev)
        rng = np.random.default_rng(5)
        W, H = mxu.extend_tables_mxu(
            plan, _normal(rng, data.num_users, k),
            _normal(rng, data.num_items, k), _normal(rng, data.num_users),
            _normal(rng, data.num_items))
        fe = W.shape[1]
        rates = mxu.mxu_column_rates(k, fe, 0.01, 0.015, 0.015, 1.0, 0.01,
                                     True, True, True, device=self.dev)
        order = plan.epoch_order(6)
        kw = dict(user_block=plan.user_block, item_block=plan.item_block,
                  loss=0, biased=True)
        if tiled:
            kw["slab_blocks"] = plan.slab_blocks
        fn = se.sgd_epoch_sharded_tiled if tiled else se.sgd_epoch_sharded

        def run(plain):
            Ws, Hs = mesh.shard_rows(W.clone()), mesh.shard_rows(H.clone())
            _, ms = _timed(lambda: fn(
                mesh, Ws, Hs, plan.packed, order, plan.cell_counts,
                (0.6, 1.0, 4.0), rates, plain=plain, **kw), self.dev)
            return (mesh.gather_rows(Ws, "cpu"),
                    mesh.gather_rows(Hs, "cpu")), ms
        return plan, run

    def _bpr(self, tiled: bool):
        from mymedialite_tpu_torch.ops import bpr_epoch as be
        from mymedialite_tpu_torch.ops import bpr_plan
        from mymedialite_tpu_torch.ops.plan import fused_width
        mesh, fb, k = self.mesh, self.feedback, self.s["k"]
        D = mesh.global_size
        if tiled:
            plan, state, meta = bpr_plan.prepare_bpr_mxu_sharded_tiled(
                fb, D, uniform_user=True, shuffle_seed=4, slab_blocks=1,
                device=self.dev)
            order = bpr_plan.bpr_sharded_tiled_epoch_order(
                plan, state["nvalid"], 6)
        else:
            plan, state, meta = bpr_plan.prepare_bpr_mxu_sharded(
                fb, D, uniform_user=True, shuffle_seed=4, bitmask=True,
                device=self.dev)
            order = bpr_plan.bpr_sharded_epoch_order(plan, state["nvalid"], 6)
        rng = np.random.default_rng(5)
        fe = fused_width(k)
        W, H = bpr_plan.bpr_tables_to_mxu(
            *(self.tensor(a) for a in (_normal(rng, fb.num_users, k),
                                       _normal(rng, fb.num_items, k),
                                       _normal(rng, fb.num_items))),
            self.tensor(plan.new_of_old.astype(np.int64)), u_pad=plan.u_pad,
            i_pad=plan.i_pad, fe=fe)
        rates = bpr_plan.bpr_mxu_column_rates(k, fe, 0.05, 0.0025, 0.0025,
                                              0.00025, 0.0, True,
                                              device=self.dev)
        # every global device's bits from one seeded draw, as the JAX
        # package's [D, D, nc_pad, T, C]; a process reads its own rows
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(7)
        bits = torch.randint(0, 2 ** 31, (D, D, plan.nc_pad, meta[2],
                                          plan.chunk), dtype=torch.int32,
                             generator=gen, device=self.dev)
        kw = dict(part_blocks=plan.part_blocks, user_block=plan.user_block,
                  item_block=plan.item_block, return_negatives=True)

        def epoch(Ws, Hs, plain):
            if tiled:
                return be.bpr_epoch_sharded_tiled(
                    mesh, Ws, Hs, plan.packed, state["subkeys_tbl"],
                    state["cdf_tbl"], bits, order, plan.cell_counts, rates,
                    slab_blocks=plan.slab_blocks, plain=plain, **kw)[2]
            return be.bpr_epoch_sharded(
                mesh, Ws, Hs, plan.packed, state["keys_tbl"],
                state["cdf_tbl"], bits, order, plan.cell_counts, rates,
                bitmask_tbl=state["bitmask_tbl"], plain=plain, **kw)[2]

        def run(plain):
            Ws, Hs = mesh.shard_rows(W.clone()), mesh.shard_rows(H.clone())
            negs, ms = _timed(lambda: epoch(Ws, Hs, plain), self.dev)
            return (mesh.gather_rows(Ws, "cpu"), mesh.gather_rows(Hs, "cpu"),
                    negs), ms
        return plan, run

    def _kernel_route(self, name, plan, run):
        """The epoch through the wrappers (the wrapper call alone timed:
        not the sharding of the tables before it nor their gathering
        after it), then (on a card) the same epoch with plain cells, held
        to it; returns the tables."""
        out, self.epoch_ms[name] = run(False)
        if self.dev.type == "cuda":
            ref, _ = run(True)
            err = max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(out[:2], ref[:2]))
            if len(out) == 3:
                for row, ref_row in zip(out[2], ref[2]):
                    for x, y in zip(row, ref_row):
                        if (x is None) != (y is None) or (
                                x is not None and not torch.equal(x, y)):
                            raise AssertionError(
                                f"{name}: the kernel's negatives differ "
                                "from the plain version's")
            self.plain_err[name] = err
        if len(out) == 3:
            g0 = self.mesh.first_device
            for d, row in enumerate(out[2]):
                for k, neg in enumerate(row):
                    if neg is not None:
                        self.local[f"{name}/neg_g{g0 + d}_k{k}"] = \
                            neg.cpu().numpy()
        return dict(W=out[0].numpy(), H=out[1].numpy(),
                    cells=plan.cell_counts)

    def sgd_epoch(self):
        return self._kernel_route("sgd_epoch", *self._sgd(False))

    def sgd_epoch_tiled(self):
        return self._kernel_route("sgd_epoch_tiled", *self._sgd(True))

    def bpr_epoch(self):
        return self._kernel_route("bpr_epoch", *self._bpr(False))

    def bpr_epoch_tiled(self):
        return self._kernel_route("bpr_epoch_tiled", *self._bpr(True))

    # --- the model routes through train() ---

    def _pairs(self):
        rng = np.random.default_rng(11)
        return (rng.integers(0, self.data.num_users, 512),
                rng.integers(0, self.data.num_items, 512))

    def _lone_read(self, m):
        """One more epoch outside ``train()`` (as the incremental API's
        retrains run), then the first process alone predicts while the
        others wait in a barrier: a collective hidden in reading the
        tables would meet the barrier and fail or hang. Returns the
        predictions on fixed pairs."""
        m.iterate()
        pairs = self._pairs()
        lone = (np.asarray(m.predict_batch(*pairs))
                if self.mesh.process_index == 0 else None)
        if self.mesh.process_count > 1:
            import torch.distributed as dist
            dist.barrier()
        pred = np.asarray(m.predict_batch(*pairs))
        assert lone is None or np.array_equal(lone, pred)
        return pred

    def mf_train(self, default: bool = False):
        from mymedialite_tpu_torch.models.mf import BiasedMatrixFactorization
        m = BiasedMatrixFactorization()
        m.num_factors, m.num_iter = self.s["k"], 2
        m.device = str(self.dev)
        if not default:
            m.mesh = self.mesh
        m.ratings = self.data
        m.train()
        assert m._route() == "sharded", m._route()
        pred = self._lone_read(m)
        return dict(W=m.W_ext[:m.num_users_trained].cpu().numpy(),
                    H=m.H_ext.cpu().numpy(), predictions=pred)

    def mf_default(self):
        """``mf_train`` on the default mesh: across the processes the
        global mesh, in one process the 4 devices."""
        from mymedialite_tpu_torch.parallel.mesh import (
            default_devices, default_mesh,
        )
        with default_devices(self.mesh.devices):
            mesh = default_mesh(self.dev)
            assert (mesh.global_size, mesh.process_index,
                    mesh.process_count) == (
                self.mesh.global_size, self.mesh.process_index,
                self.mesh.process_count), mesh
            return self.mf_train(default=True)

    def bpr_train(self):
        from mymedialite_tpu_torch.models.bpr import BPRMF
        m = BPRMF()
        m.num_factors, m.num_iter = self.s["k"], 2
        m.device, m.mesh = str(self.dev), self.mesh
        m.feedback = self.train
        m.train()
        assert m._route() == "sharded", m._route()
        self.bpr_model = m
        pred = self._lone_read(m)
        p = m.params
        return dict(W=p["user_factors"].cpu().numpy(),
                    H=p["item_factors"].cpu().numpy(),
                    bias=p["item_bias"].cpu().numpy(), predictions=pred)

    def svdpp(self):
        from mymedialite_tpu_torch.models.svdpp import SVDPlusPlus
        m = SVDPlusPlus()
        m.num_factors, m.num_iter, m.group_users = 20, 2, 64
        m.learn_rate = 0.003
        m.device, m.mesh = str(self.dev), self.mesh
        m.ratings = self.data
        m.train()
        assert m.route() == "sharded", m.route()
        out = {k: v.cpu().numpy() for k, v in m.params.items()}
        out["predictions"] = np.asarray(m.predict_batch(*self._pairs()))
        return out

    def wrmf(self):
        from mymedialite_tpu_torch.models.registry import (
            create_item_recommender,
        )
        m = create_item_recommender(
            "WRMF", f"num_factors={self.s['k']} num_iter=2 "
            f"regularization=100 device={self.dev.type}")
        m.mesh = self.mesh
        m.feedback = self.train
        m.train()
        return {k: v.cpu().numpy() for k, v in m.params.items()}

    def bpr_minibatch(self):
        from mymedialite_tpu_torch.ops import bpr
        mesh, k = self.mesh, self.s["k"]
        sdata, smeta = bpr.make_sampler_data_sharded(self.train,
                                                     mesh.global_size)
        samplers = bpr.device_samplers(mesh, sdata, smeta)
        gens = []
        for d, dev in enumerate(mesh.devices):
            gens.append(torch.Generator(device=dev))
            gens[-1].manual_seed(40 + mesh.first_device + d)
        rng = np.random.default_rng(8)
        W = self.tensor(_normal(rng, smeta["u_loc"] * mesh.global_size, k))
        params = dict(user_factors=mesh.shard_rows(W),
                      item_factors=self.tensor(_normal(
                          rng, self.train.num_items, k)),
                      item_bias=self.tensor(_normal(rng,
                                                    self.train.num_items)))
        batch, num_batches = bpr.sharded_epoch_batches(
            smeta["num_events"], 512, mesh.global_size)
        bpr.bpr_epoch_sharded(
            mesh, params, samplers, smeta, gens,
            dict(learn_rate=0.05, reg_u=0.0025, reg_i=0.0025, reg_j=0.00025,
                 bias_reg=0.0), batch_size=batch, num_batches=num_batches,
            regime=bpr.UNIFORM_USER, update_j=True)
        return dict(W=mesh.gather_rows(params["user_factors"], "cpu").numpy(),
                    H=params["item_factors"].cpu().numpy(),
                    bias=params["item_bias"].cpu().numpy())

    def ranking(self):
        from mymedialite_tpu_torch.eval.ranking import evaluate_items
        res = evaluate_items(self.bpr_model, self.test, self.train)
        keys = sorted(k for k, v in res.items()
                      if isinstance(v, (int, float)))
        return dict(names=np.array(keys),
                    values=np.array([float(res[k]) for k in keys]))

    def flat(self):
        from mymedialite_tpu_torch.ops import sgd
        mesh, data, k = self.mesh, self.data, self.s["k"]
        U, I = data.num_users, data.num_items
        rng = np.random.default_rng(9)
        params = dict(global_bias=float(data.average),
                      user_factors=self.tensor(_normal(rng, U, k)),
                      item_factors=self.tensor(_normal(rng, I, k)),
                      user_bias=self.tensor(_normal(rng, U)),
                      item_bias=self.tensor(_normal(rng, I)))
        batch = 4 * self.s["batch"]
        flat = sgd.prepare_epoch_data(data.users, data.items, data.values,
                                      batch, num_users=U, num_items=I,
                                      device=self.dev)
        order = rng.permutation(flat["users"].shape[0] // batch)
        sgd.sgd_epoch_sharded_flat(
            mesh, params, flat, order,
            dict(learn_rate=0.01, reg_u=0.015, reg_i=0.015, bias_reg=0.01,
                 bias_learn_rate=1.0, min_rating=1.0, rating_range=4.0),
            batch_size=batch, loss=sgd.LOSS_RMSE, biased=True,
            update_user=True, update_item=True,
            frequency_regularization=False)
        return {name: t.cpu().numpy() for name, t in params.items()
                if name != "global_bias"}


def _launch_counts() -> dict:
    from mymedialite_tpu_torch.ops import bpr_epoch as be
    from mymedialite_tpu_torch.ops import sgd_epoch as se
    return {"sgd_epoch": se.sgd_epoch.launches,
            "sgd_epoch_tiled": se.sgd_epoch_tiled.launches,
            "bpr_epoch": be.bpr_epoch.launches,
            "bpr_epoch_tiled": be.bpr_epoch_tiled.launches}


def _timed(fn, dev):
    """(fn()'s result, its ms: CUDA events on a card, else the clock)."""
    if dev.type == "cuda":
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(dev)
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize(dev)
        return out, s.elapsed_time(e)
    t0 = time.perf_counter()
    out = fn()
    return out, 1000.0 * (time.perf_counter() - t0)


def run(mode: str, port: int, pid: int, out_path: str, device: str,
        shape: str = "small"):
    from mymedialite_tpu_torch.device import resolve_device
    from mymedialite_tpu_torch.parallel.mesh import (
        initialize_distributed, make_global_mesh,
    )
    n_local = 2 if mode == "dist" else 4
    if mode == "dist":
        os.environ["JAX_COORDINATOR"] = f"localhost:{port}"
        os.environ["JAX_NUM_PROCESSES"] = "2"
        os.environ["JAX_PROCESS_ID"] = str(pid)
    backend = "nccl" if device == "own" else "gloo"
    dev = resolve_device(f"cuda:{pid}" if device == "own" else device)
    inited = initialize_distributed(
        backend=backend, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    assert inited is (mode == "dist"), (inited, mode)
    mesh = make_global_mesh(devices=[dev] * n_local)
    assert mesh.global_size == 4, mesh

    r = Routes(mesh, shape)
    out = {}
    for name in ROUTES:
        before = _launch_counts()
        result, ms = _timed(getattr(r, name), dev)
        ms = r.epoch_ms.get(name, ms)
        after = _launch_counts()
        for key, value in result.items():
            out[f"{name}/{key}"] = value
        out[f"ms/{name}"] = np.float64(ms)
        line = f"route {name}: {ms:.1f} ms"
        if name in KERNEL_ROUTES:
            cells = after[KERNEL_ROUTES[name]] - before[KERNEL_ROUTES[name]]
            out[f"launches/{name}"] = np.int64(cells)
            line += f", {cells} cells of {KERNEL_ROUTES[name]} launched"
        if name in r.plain_err:
            out[f"plain_err/{name}"] = np.float64(r.plain_err[name])
            line += f", against the plain cells {r.plain_err[name]:.3e}"
        print(line, flush=True)
    out.update({f"local/{k}": v for k, v in r.local.items()})
    np.savez(out_path, **out)
    if inited:
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    print("driver-ok", mode, pid, flush=True)


# keys of a rank's output that are its own (not equal across the ranks)
RANK_OWN = ("local/", "ms/", "launches/", "plain_err/")


def _gap(a: np.ndarray, b: np.ndarray) -> float:
    """Largest absolute difference; inf where the shapes or non-numeric
    entries differ."""
    if a.shape != b.shape:
        return float("inf")
    if a.dtype.kind not in "fiub":
        return 0.0 if np.array_equal(a, b) else float("inf")
    if a.size == 0:
        return 0.0
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


def compare(ranks, single) -> dict:
    """Route by route, the ranks' outputs (``np.load``'s) against each
    other and against the one-process run's: {route: (ranks equal bit
    for bit, largest gap to ``single``)}. The BPR negatives of every
    rank's cells together must equal the one-process run's exactly (a
    gap of inf otherwise)."""
    out = {}
    for key in single.files:
        if key.startswith(RANK_OWN):
            continue
        route = key.split("/")[0]
        equal, gap = out.get(route, (True, 0.0))
        equal = equal and all(key in r.files and np.array_equal(
            r[key], ranks[0][key]) for r in ranks)
        gap = max(gap, max(_gap(r[key], single[key]) if key in r.files
                           else float("inf") for r in ranks))
        out[route] = (equal, gap)
    negs = {}
    for r in ranks:
        negs.update({k: r[k] for k in r.files if k.startswith("local/")})
    for key in (k for k in single.files if k.startswith("local/")):
        route = key.split("/")[1]
        equal, gap = out[route]
        if key not in negs or not np.array_equal(negs[key], single[key]):
            gap = float("inf")
        out[route] = (equal, gap)
    if set(negs) != {k for k in single.files if k.startswith("local/")}:
        for route in {k.split("/")[1] for k in negs}:
            out[route] = (out[route][0], float("inf"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["dist", "single"])
    ap.add_argument("port", type=int)
    ap.add_argument("pid", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--shape", default="small", choices=sorted(SHAPES))
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    run(a.mode, a.port, a.pid, a.out, a.device, a.shape)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
