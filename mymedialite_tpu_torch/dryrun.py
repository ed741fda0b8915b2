"""Entry points of the port: a forward step, and a dry run of every mesh
path at tiny shapes.

The counterpart of the repository's ``__graft_entry__.py`` (the JAX
package's), on the port's one-controller mesh (``parallel/mesh.py``):

- ``entry(device="cuda")``: BiasedMatrixFactorization's batch scoring
  (gather and the sigmoid-bounded prediction), a function and its
  arguments on ``device``;
- ``dryrun_multichip(n, devices=None)``: a mesh of ``n`` devices (the
  first n visible cards, or ``devices``, e.g. ``["cpu"] * 8`` or a rig of
  one card named n times) and one step of each path the JAX dry run
  runs, each asserting what JAX's asserts: 1 the sharded blocked MF
  epoch, 2 the flat epoch data-parallel over the mesh
  (``sgd_epoch_sharded_flat``, the JAX dry run's flat epoch under XLA's
  SPMD partitioner, which no model calls), 3 the sharded minibatch BPR
  epoch, 4 the sharded ALS solves, 5
  SVDPlusPlus on the sharded grouped epoch through ``train()``, 6
  cross-validation folds on the mesh, 7 the multi-host functions in one
  process, 8 the sharded DSGD epoch of kernel 1, 9-10 BiasedMF and BPRMF
  on their sharded kernel routes through ``train()``, 11-12 on the
  sharded-tiled ones. Prints one summary line.

    python -m mymedialite_tpu_torch.dryrun [N] [--cpu]

runs both on the first N cards (on one card named N times where there
are fewer), or on ``["cpu"] * N`` with ``--cpu``; without a card and
without ``--cpu`` it raises.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch


def entry(device="cuda"):
    """(forward, (params, users, items)): BiasedMF's bounded batch
    prediction on a 1..5 scale, its arguments on ``device``."""
    from mymedialite_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    f, U, I = 32, 64, 96
    params = dict(global_bias=torch.tensor(0.2, device=dev),
                  user_factors=0.1 * torch.ones((U, f), device=dev),
                  item_factors=0.1 * torch.ones((I, f), device=dev),
                  user_bias=torch.zeros(U, device=dev),
                  item_bias=torch.zeros(I, device=dev))
    users = torch.arange(128, device=dev) % U
    items = torch.arange(128, device=dev) % I

    def forward(params, users, items):
        wu = params["user_factors"][users]
        hi = params["item_factors"][items]
        score = (params["global_bias"] + params["user_bias"][users]
                 + params["item_bias"][items] + (wu * hi).sum(dim=-1))
        return 1.0 + torch.sigmoid(score) * 4.0

    return forward, (params, users, items)


@contextlib.contextmanager
def _forced_schedule(route: str):
    """The MF and BPR models' schedule forced to ``route`` (as the JAX
    dry run forces ``MML_MXU``); restored after."""
    from mymedialite_tpu_torch.models import bpr as bpr_models
    from mymedialite_tpu_torch.ops import plan
    saved = plan.select_schedule, bpr_models.select_schedule
    plan.select_schedule = bpr_models.select_schedule = \
        lambda *a, **k: route
    try:
        yield
    finally:
        plan.select_schedule, bpr_models.select_schedule = saved


def _moved(before, after) -> bool:
    return float((after.cpu() - before.cpu()).abs().sum()) > 0.0


def dryrun_multichip(n_devices: int, devices=None) -> None:
    from mymedialite_tpu_torch.data.arrays import PosOnlyData, RatingData
    from mymedialite_tpu_torch.eval.crossval import crossvalidate_ratings
    from mymedialite_tpu_torch.models.bpr import BPRMF
    from mymedialite_tpu_torch.models.mf import BiasedMatrixFactorization
    from mymedialite_tpu_torch.models.svdpp import SVDPlusPlus
    from mymedialite_tpu_torch.ops import als, bpr, sgd
    from mymedialite_tpu_torch.ops import plan as mxu
    from mymedialite_tpu_torch.ops import sgd_epoch
    from mymedialite_tpu_torch.parallel.mesh import (
        host_local_rows, initialize_distributed, make_global_mesh,
        make_mesh, shard_host_local,
    )

    mesh = make_mesh(n_devices, devices)
    dev = mesh.devices[0]
    device_name = str(dev)

    # --- path 1: the sharded blocked MF epoch: user groups over the
    # devices, the item table merged per group step
    G = 16
    U = G * n_devices
    I = 24 * n_devices
    f = 8
    n_ratings = 64 * n_devices
    rng = np.random.default_rng(0)
    users = rng.integers(0, U, n_ratings).astype(np.int32)
    items = rng.integers(0, I, n_ratings).astype(np.int32)
    values = rng.uniform(1, 5, n_ratings).astype(np.float32)
    data, meta = sgd.prepare_blocked_data(users, items, values, U,
                                          batch_size=32, group_users=G,
                                          shuffle_seed=0, device=dev)
    W, H = sgd.extend_tables(
        0.1 * rng.standard_normal((U, f)).astype(np.float32),
        0.1 * rng.standard_normal((I, f)).astype(np.float32),
        group_users=G)
    W, H = W.to(dev), H.to(dev)
    before = W.clone()
    hp = (0.0, 1.0, 4.0)
    rates = sgd.column_rates(f, 0.01, 0.015, 0.015, 1.0, 0.01, True, True,
                             True, device=dev)
    nb = meta["l_pad"] // meta["batch"]
    gl = meta["ngroups"] // n_devices
    orders = np.stack([rng.permutation(nb) for _ in range(gl)])
    W1, H1 = W.clone(), H.clone()
    sgd.sgd_epoch_blocked_sharded(mesh, W1, H1, data, orders, hp, rates,
                                  meta=meta, loss=sgd.LOSS_RMSE, biased=True)
    assert _moved(before, W1), "sharded blocked step produced no update"

    # --- path 2: the flat epoch, data-parallel: each batch split over the
    # devices, the parts' deltas merged before the next batch
    params = dict(
        global_bias=0.0,
        user_factors=torch.from_numpy((0.1 * rng.standard_normal(
            (U, f))).astype(np.float32)).to(dev),
        item_factors=torch.from_numpy((0.1 * rng.standard_normal(
            (I, f))).astype(np.float32)).to(dev),
        user_bias=torch.zeros(U, device=dev),
        item_bias=torch.zeros(I, device=dev))
    batch = 16 * n_devices
    flat = sgd.prepare_epoch_data(users, items, values, batch, device=dev)
    before2 = params["user_factors"].clone()
    hp2 = dict(learn_rate=0.01, reg_u=0.015, reg_i=0.015, bias_reg=0.01,
               bias_learn_rate=1.0, min_rating=1.0, rating_range=4.0)
    sgd.sgd_epoch_sharded_flat(
        mesh, params, flat, rng.permutation(flat["users"].shape[0] // batch),
        hp2, batch_size=batch, loss=sgd.LOSS_RMSE, biased=True,
        update_user=True, update_item=True, frequency_regularization=False)
    assert _moved(before2, params["user_factors"]), \
        "flat sharded step produced no update"

    # --- path 3: the sharded minibatch BPR epoch: users per device, item
    # deltas merged per minibatch
    fb = PosOnlyData(users % U, items % I, num_users=U, num_items=I)
    sdata, smeta = bpr.make_sampler_data_sharded(fb, n_devices)
    samplers = bpr.device_samplers(mesh, sdata, smeta)
    gens = []
    for d, gdev in enumerate(mesh.devices):
        gens.append(torch.Generator(device=gdev))
        gens[-1].manual_seed(1 + d)
    Wb = torch.from_numpy((0.1 * rng.standard_normal(
        (smeta["u_loc"] * n_devices, f))).astype(np.float32)).to(dev)
    bparams = dict(user_factors=mesh.shard_rows(Wb.clone()),
                   item_factors=torch.from_numpy((0.1 * rng.standard_normal(
                       (I, f))).astype(np.float32)).to(dev),
                   item_bias=torch.zeros(I, device=dev))
    bhp = dict(learn_rate=0.05, reg_u=0.0025, reg_i=0.0025, reg_j=0.00025,
               bias_reg=0.0)
    bpr.bpr_epoch_sharded(mesh, bparams, samplers, smeta, gens, bhp,
                          batch_size=8, num_batches=4,
                          regime=bpr.UNIFORM_USER, update_j=True)
    assert _moved(Wb, mesh.gather_rows(bparams["user_factors"])), \
        "sharded BPR step produced no update"

    # --- path 4: the sharded ALS row solves
    chunk, Lh = 4, 6
    hist4 = torch.from_numpy(rng.integers(
        0, I, (n_devices * chunk * 2, Lh))).to(dev)
    lens4 = torch.from_numpy(rng.integers(0, Lh + 1, hist4.shape[0])).to(dev)
    Hf = torch.from_numpy((0.1 * rng.standard_normal((I, f))).astype(
        np.float32)).to(dev)
    Wa = als.wrmf_optimize_sharded(mesh, Hf, hist4, lens4, 1.0, 0.015,
                                   chunk=chunk)
    assert bool(torch.isfinite(Wa).all()), "sharded ALS produced non-finite"

    # --- path 5: SVDPlusPlus on the sharded grouped epoch through train()
    ratings = RatingData(users, items, values, num_users=U, num_items=I)

    def svdpp():
        m = SVDPlusPlus()
        m.num_iter, m.num_factors, m.group_users = 1, 4, G
        m.device, m.mesh = device_name, mesh
        return m
    m5 = svdpp()
    m5.ratings = ratings
    m5.train()
    assert m5.route() == "sharded" and m5._shards[0].size == n_devices, \
        "SVD++ sharded path did not engage"
    assert np.isfinite(m5.predict_batch(np.arange(4), np.arange(4))).all()

    # --- path 6: cross-validation folds, each trained on the mesh
    cv = crossvalidate_ratings(svdpp(), ratings, num_folds=2)
    assert np.isfinite(cv["RMSE"]), "CV on the mesh produced non-finite"

    # --- path 7: the multi-host functions, one process
    assert initialize_distributed() is False
    gmesh = make_global_mesh(devices=mesh.devices)
    assert gmesh.global_size == n_devices and gmesh.process_count == 1
    lo, hi = host_local_rows(meta["ngroups"])
    assert (lo, hi) == (0, meta["ngroups"])
    assert sum(s.shape[0] for s in shard_host_local(
        gmesh, data["gu"][lo:hi].cpu().numpy())) == meta["ngroups"]
    host_rows = before.cpu().clone()
    W7 = [s.to(d) for s, d in zip(shard_host_local(gmesh, host_rows),
                                  gmesh.devices)]
    sgd.sgd_epoch_blocked_sharded(gmesh, W7, H.clone(),
                                  {k: v[lo:hi] for k, v in data.items()},
                                  orders, hp, rates, meta=meta,
                                  loss=sgd.LOSS_RMSE, biased=True)
    assert _moved(before, gmesh.gather_rows(W7)), \
        "host-sharded blocked step produced no update"

    # --- path 8: the sharded DSGD epoch of kernel 1: user blocks over
    # the devices, item partitions ring-shifted between sub-epochs
    plan8 = mxu.prepare_mxu_sharded(users, items, values, U, I, n_devices,
                                    user_block=8, item_block=8, chunk=8,
                                    shuffle_seed=0, device=dev)
    W8, H8 = mxu.extend_tables_mxu(
        plan8, 0.1 * rng.standard_normal((U, f)),
        0.1 * rng.standard_normal((I, f)))
    W8before = W8.clone()
    Ws, Hs = mesh.shard_rows(W8), mesh.shard_rows(H8)
    sgd_epoch.sgd_epoch_sharded(
        mesh, Ws, Hs, plan8.packed, plan8.epoch_order(1), plan8.cell_counts,
        (3.0, 1.0, 4.0), mxu.mxu_column_rates(f, W8.shape[1], 0.01, 0.015,
                                              0.015, 1.0, 0.01, True, True,
                                              True, device=dev),
        user_block=8, item_block=8, loss=sgd.LOSS_RMSE, biased=True)
    assert _moved(W8before, mesh.gather_rows(Ws)), \
        "sharded DSGD epoch produced no update"

    # --- paths 9-12: the sharded kernel routes through train(), then the
    # sharded-tiled ones
    def mf():
        m = BiasedMatrixFactorization()
        m.num_factors, m.num_iter = 4, 1
        m.device, m.mesh = device_name, mesh
        m.ratings = ratings
        m.train()
        assert np.isfinite(m.predict_batch(np.arange(4), np.arange(4))).all()
        return m

    def bprmf():
        m = BPRMF()
        m.num_factors, m.num_iter = 4, 1
        m.device, m.mesh = device_name, mesh
        m.feedback = fb
        m.train()
        assert np.isfinite(m.predict_batch(np.arange(4), np.arange(4))).all()
        return m
    assert isinstance(mf()._plan, mxu.MxuShardedPlan), \
        "model layer did not select the sharded SGD epoch"
    assert isinstance(bprmf()._plan, mxu.MxuShardedPlan), \
        "model layer did not select the sharded BPR epoch"
    with _forced_schedule("sharded-tiled"):
        assert isinstance(mf()._plan, mxu.MxuShardedTiledPlan), \
            "model layer did not select the sharded-tiled SGD epoch"
        assert isinstance(bprmf()._plan, mxu.MxuShardedTiledPlan), \
            "model layer did not select the sharded-tiled BPR epoch"

    print("dryrun paths ok: 1 sharded-blocked-SGD, 2 flat-SPMD-SGD, "
          "3 sharded-BPR-minibatch, 4 sharded-ALS, 5 sharded-SVD++, "
          "6 CV-on-the-mesh, 7 multi-host-scaffold, 8 sharded-DSGD-SGD, "
          "9 model-sharded-SGD, 10 model-sharded-BPR, "
          f"11 model-sharded-tiled-SGD, 12 model-sharded-tiled-BPR on {mesh}",
          flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv and argv[0].isdigit() else 8
    cpu = "--cpu" in argv
    fn, args = entry("cpu" if cpu else "cuda")
    out = fn(*args)
    print("entry() ok:", tuple(out.shape), float(out[0]))
    devices = ["cpu"] * n if cpu else None
    if not cpu and torch.cuda.device_count() < n:
        devices = ["cuda:0"] * n     # a rig of one card named n times
    dryrun_multichip(n, devices)
    print(f"dryrun_multichip({n}) ok: 12 paths")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
