"""The port's sharded slab-tiled schedule against the JAX package's, on
the CPU; mirrors tests/test_mxu_sharded_tiled.py, and holds the route
choice on a mesh (``ops/plan.py select_schedule(num_devices=D)``) to
``kernel_select.select_mxu_mode``.

The JAX side runs ``sgd_epoch_mxu_sharded_tiled`` /
``bpr_epoch_mxu_sharded_tiled`` in interpret mode with float32 operands
on its virtual CPU mesh cut to D devices; the port's mesh is ``["cpu"] *
D``. Plans and orders are compared array for array (the JAX order without
its refetch flags), the epochs from the same tables, order and random
bits to atol 1e-5, the BPR negatives exactly. At these sizes the models
reach the sharded-tiled route only when it is forced, as the JAX tests
force it with ``MML_MXU=sharded-tiled-interpret``.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mymedialite_tpu.ops import kernel_select
from mymedialite_tpu.ops import pallas_bpr as pb
from mymedialite_tpu.ops import pallas_sgd as ps
from mymedialite_tpu_torch.eval.ranking import evaluate_items
from mymedialite_tpu_torch.eval.rating import evaluate_ratings
from mymedialite_tpu_torch.models import bpr as tbpr
from mymedialite_tpu_torch.ops import bpr_plan as tb
from mymedialite_tpu_torch.ops import plan as tp
from mymedialite_tpu_torch.ops.bpr_epoch import (
    bpr_epoch_sharded_tiled, bpr_epoch_tiled,
)
from mymedialite_tpu_torch.ops.sgd_epoch import (
    sgd_epoch_sharded_tiled, sgd_epoch_tiled,
)
from test_torch_sharded import (
    MESHES, FE, F, assert_same_negatives, assert_same_order, assert_same_plan,
    bpr_tables, covered_once, cpu_mesh, events, feedback, jax_bpr_bits,
    jax_sharded, mf_tables, planted_feedback, planted_ratings, train_bpr,
    train_mf,
)
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(user_block=8, item_block=8, chunk=8, slab_blocks=2, shuffle_seed=0)


def sgd_plans(D, seed=0, **shape):
    users, items, values = events(seed=seed, **shape)
    U, I = shape.get("U", 100), shape.get("I", 90)
    return (ps.prepare_mxu_sharded_tiled(users, items, values, U, I, D, **KW),
            tp.prepare_mxu_sharded_tiled(users, items, values, U, I, D, **KW))


@pytest.mark.parametrize("D", MESHES)
def test_sgd_plan_and_order_identical(D):
    jplan, tplan = sgd_plans(D)
    assert isinstance(tplan, tp.MxuShardedTiledPlan)
    assert_same_plan(tplan, jplan)
    for name in ("slab_blocks", "slabs_per_part", "slab_rows", "n_ublocks",
                 "n_iblocks"):
        assert getattr(tplan, name) == getattr(jplan, name), name
    assert tplan.slabs_per_part >= 1
    for seed in (3, None):
        assert_same_order(tplan.epoch_order(seed), jplan.epoch_order(seed)[:4])


def test_every_event_covered_once():
    jplan, tplan = sgd_plans(8, seed=5, U=60, I=70, n=900)
    covered_once(tplan, tplan.epoch_order(9)[3])


@pytest.mark.parametrize("loss", [0, 1, 2], ids=["rmse", "mae", "logistic"])
@pytest.mark.parametrize("D", MESHES)
def test_sgd_epoch_matches_jax(D, loss):
    jplan, tplan = sgd_plans(D)
    W0, H0 = mf_tables(tplan, 100, 90)
    args = (F, FE, 0.01, 0.015, 0.015, 1.0, 0.01, True, True, True)
    hp = (3.0, 1.0, 4.0)
    hp_j = np.zeros((1, 8), np.float32)
    hp_j[0, :3] = hp
    mesh, (Wj, Hj) = jax_sharded(D, W0, H0)
    Wj, Hj = ps.sgd_epoch_mxu_sharded_tiled(
        mesh, Wj, Hj, jplan.packed, jplan.epoch_order(3), jnp.asarray(hp_j),
        ps.mxu_column_rates(*args), meta=jplan.meta(FE),
        slabs_per_part=jplan.slabs_per_part, loss=loss, biased=True,
        mxu_dtype="f32", interpret=True)
    tmesh = cpu_mesh(D)
    Ws = tmesh.shard_rows(torch.from_numpy(W0.copy()))
    Hs = tmesh.shard_rows(torch.from_numpy(H0.copy()))
    sgd_epoch_sharded_tiled(
        tmesh, Ws, Hs, tplan.packed, tplan.epoch_order(3), tplan.cell_counts,
        hp, tp.mxu_column_rates(*args), slab_blocks=tplan.slab_blocks,
        user_block=8, item_block=8, loss=loss, biased=True)
    Wt, Ht = tmesh.gather_rows(Ws).numpy(), tmesh.gather_rows(Hs).numpy()
    np.testing.assert_allclose(Wt, np.asarray(Wj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(Ht, np.asarray(Hj), rtol=0, atol=1e-5)
    assert np.abs(Wt - W0).sum() > 0, "the epoch was a no-op"


@pytest.mark.parametrize("D", [2, 8])
def test_sgd_epoch_equals_sequential_cells(D):
    _, plan = sgd_plans(D)
    W0, H0 = mf_tables(plan, 100, 90)
    rates = tp.mxu_column_rates(F, FE, 0.01, 0.015, 0.015, 1.0, 0.01, True,
                                True, True)
    hp = (3.0, 1.0, 4.0)
    kw = dict(slab_blocks=plan.slab_blocks, user_block=8, item_block=8,
              loss=0, biased=True)
    order = plan.epoch_order(3)
    mesh = cpu_mesh(D)
    Ws = mesh.shard_rows(torch.from_numpy(W0.copy()))
    Hs = mesh.shard_rows(torch.from_numpy(H0.copy()))
    sgd_epoch_sharded_tiled(mesh, Ws, Hs, plan.packed, order,
                            plan.cell_counts, hp, rates, **kw)
    W, H = torch.from_numpy(W0.copy()), torch.from_numpy(H0.copy())
    upd, pr = plan.u_pad_dev, plan.part_rows
    for k in range(D):
        for d in range(D):
            n = plan.cell_counts[d, k]
            if n:
                p = (d + k) % D
                cell = tuple(torch.from_numpy(a[d, k, :n].copy())
                             for a in order)
                sgd_epoch_tiled(W[d * upd:(d + 1) * upd],
                                H[p * pr:(p + 1) * pr], plan.packed, cell,
                                hp, rates, **kw)
    assert torch.equal(mesh.gather_rows(Ws), W)
    assert torch.equal(mesh.gather_rows(Hs), H)


# --- BPR ---

def bpr_plans(D, *, uniform_user=True, seed=2, **shape):
    fbj, fbt = feedback(seed=seed, **shape)
    args = dict(uniform_user=uniform_user, chunk_overhead=0, **KW)
    return (pb.prepare_bpr_mxu_sharded_tiled(fbj, D, **args),
            tb.prepare_bpr_mxu_sharded_tiled(fbt, D, **args))


@pytest.mark.parametrize("wbpr", [False, True], ids=["uniform", "wbpr"])
@pytest.mark.parametrize("D", MESHES)
def test_bpr_plan_and_order_identical(D, wbpr):
    (jplan, jstate, jmeta), (tplan, tstate, tmeta) = bpr_plans(
        D, uniform_user=not wbpr, U=100, I=90)
    assert_same_plan(tplan, jplan)
    assert tplan.slab_blocks == jplan.slab_blocks
    assert tmeta == tuple(jmeta)
    assert tstate["ksub"] == jstate["ksub"]
    for name in ("subkeys_tbl", "keys_tbl", "cdf_tbl"):
        np.testing.assert_array_equal(tstate[name].numpy(),
                                      np.asarray(jstate[name]))
    mass = (lambda s: s["block_mass"] if wbpr else None)
    jorder = jplan.epoch_order(jstate["nvalid"], 5, block_mass=mass(jstate))
    torder = tb.bpr_sharded_tiled_epoch_order(tplan, tstate["nvalid"], 5,
                                              block_mass=mass(tstate))
    assert_same_order(torder, jorder[:9])
    covered_once(tplan, torder[8])


# (soft_margin, wbpr)
@pytest.mark.parametrize("variant", [(False, False), (True, False),
                                     (False, True)],
                         ids=["bpr", "hinge", "wbpr"])
@pytest.mark.parametrize("D", MESHES)
def test_bpr_epoch_matches_jax(D, variant):
    soft_margin, wbpr = variant
    (jplan, jstate, jmeta), (tplan, tstate, _) = bpr_plans(
        D, uniform_user=not wbpr, U=100, I=90)
    trials = jmeta[2]
    We, He = bpr_tables(jplan, 100, 90, seed=3)
    rates = pb.bpr_mxu_column_rates(F, FE, 0.05, 0.0025, 0.0025, 0.00025,
                                    0.01, True)
    mass = (lambda s: s["block_mass"] if wbpr else None)
    jorder = jplan.epoch_order(jstate["nvalid"], 5, block_mass=mass(jstate))
    bits = jax_bpr_bits(D, jplan, trials, seed=7)
    mesh, (Wj, Hj) = jax_sharded(D, We, He)
    Wj, Hj, jnegs = pb.bpr_epoch_mxu_sharded_tiled(
        mesh, Wj, Hj, jplan.packed, jstate["subkeys_tbl"], jstate["cdf_tbl"],
        jnp.asarray(bits), jorder, rates,
        meta=jplan.meta(FE) + (jstate["ksub"], trials),
        slabs_per_part=jplan.slabs_per_part, soft_margin=soft_margin,
        wbpr=wbpr, mxu_dtype="f32", interpret=True)
    tmesh = cpu_mesh(D)
    Ws = tmesh.shard_rows(torch.from_numpy(We.copy()))
    Hs = tmesh.shard_rows(torch.from_numpy(He.copy()))
    torder = tb.bpr_sharded_tiled_epoch_order(tplan, tstate["nvalid"], 5,
                                              block_mass=mass(tstate))
    _, _, tnegs = bpr_epoch_sharded_tiled(
        tmesh, Ws, Hs, tplan.packed, tstate["subkeys_tbl"], tstate["cdf_tbl"],
        torch.from_numpy(bits), torder, tplan.cell_counts,
        torch.from_numpy(np.array(rates)), part_blocks=tplan.part_blocks,
        slab_blocks=tplan.slab_blocks, user_block=8, item_block=8,
        soft_margin=soft_margin, wbpr=wbpr, return_negatives=True)
    assert_same_negatives(tnegs, np.asarray(jnegs), tplan.cell_counts)
    np.testing.assert_allclose(tmesh.gather_rows(Ws).numpy(), np.asarray(Wj),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tmesh.gather_rows(Hs).numpy(), np.asarray(Hj),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("D", [2, 8])
def test_bpr_epoch_equals_sequential_cells(D):
    _, (plan, state, meta) = bpr_plans(D, uniform_user=False, U=100, I=90)
    We, He = bpr_tables(plan, 100, 90, seed=3)
    rates = tb.bpr_mxu_column_rates(F, FE, 0.05, 0.0025, 0.0025, 0.00025,
                                    0.01, True)
    order = tb.bpr_sharded_tiled_epoch_order(plan, state["nvalid"], 6,
                                             block_mass=state["block_mass"])
    bits = torch.from_numpy(jax_bpr_bits(D, plan, meta[2], seed=9))
    B, PB = plan.slab_blocks, plan.part_blocks
    kw = dict(slab_blocks=B, user_block=8, item_block=8, wbpr=True,
              subkeys=True, return_negatives=True)
    mesh = cpu_mesh(D)
    Ws = mesh.shard_rows(torch.from_numpy(We.copy()))
    Hs = mesh.shard_rows(torch.from_numpy(He.copy()))
    _, _, negs = bpr_epoch_sharded_tiled(
        mesh, Ws, Hs, plan.packed, state["subkeys_tbl"], state["cdf_tbl"],
        bits, order, plan.cell_counts, rates, part_blocks=PB, **kw)
    W, H = torch.from_numpy(We.copy()), torch.from_numpy(He.copy())
    upd, pr = plan.u_pad_dev, plan.part_rows
    for k in range(D):
        for d in range(D):
            n = plan.cell_counts[d, k]
            if not n:
                continue
            p = (d + k) % D
            ub, ibr, isl, _, jbr, jsl, nval, bkt, row = (
                torch.from_numpy(a[d, k, :n].copy()) for a in order)
            _, _, neg = bpr_epoch_tiled(
                W[d * upd:(d + 1) * upd], H[p * pr:(p + 1) * pr],
                plan.packed, state["subkeys_tbl"],
                state["cdf_tbl"][p * PB:(p + 1) * PB], bits[d, k, :n],
                (ub, ibr, isl, jsl * B + jbr, jbr, jsl, nval, bkt, row),
                rates, **kw)
            assert torch.equal(negs[d][k], neg)
    assert torch.equal(mesh.gather_rows(Ws), W)
    assert torch.equal(mesh.gather_rows(Hs), H)


def test_partition_negative_marginal():
    """P(negative block | partition) = nvalid_b / (the partition's items)
    through the slab-then-block draw."""
    D = 8
    _, (plan, state, _) = bpr_plans(D, uniform_user=False, U=64, I=100,
                                    n=4000, seed=4)
    nvalid = state["nvalid"]
    PB, n_ib = plan.part_blocks, plan.n_iblocks
    counts = np.zeros(n_ib, np.int64)
    for s in range(300):
        order = tb.bpr_sharded_tiled_epoch_order(plan, nvalid, s)
        jb, row = order[3], order[8]
        np.add.at(counts, jb[row < plan.num_chunks], 1)
    checked = 0
    for p in range(D):
        lo, hi = p * PB, min((p + 1) * PB, n_ib)
        tot = counts[lo:hi].sum() if hi > lo else 0
        if tot < 500:
            continue
        exp = nvalid[lo:hi] / max(nvalid[lo:hi].sum(), 1)
        got = counts[lo:hi] / tot
        assert np.abs(got - exp).max() < 0.1, (p, got, exp)
        checked += 1
    assert checked


# --- the route choice ---

PORT_NAME = {"sharded-interpret": "sharded",
             "sharded-tiled-interpret": "sharded-tiled",
             "interpret": "resident", "tiled-interpret": "tiled",
             "": "minibatch"}


@pytest.mark.parametrize("D", MESHES)
def test_route_choice_matches_jax(D, monkeypatch):
    """The predicates and the mesh's choice equal the JAX package's over
    a grid of catalogs and factor counts, at each mesh size."""
    devices = jax.devices()[:D]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices)
    monkeypatch.setenv("MML_MXU", "sharded-interpret")
    for items in (100, 3_000, 40_960, 41_000, 100_000, 163_840, 200_000,
                  624_961, 2_200_000, 5_000_000, 20_000_000):
        for f in (10, 40, 62, 120, 254):
            assert tp.mxu_sharded_supported(items, f, D) == \
                ps.mxu_sharded_supported(items, f, D), (items, f)
            assert tp.mxu_sharded_tiled_supported(items, f, D) == \
                ps.mxu_sharded_tiled_supported(items, f, D), (items, f)
            assert tp.select_schedule(items, f, D) == \
                PORT_NAME[kernel_select.select_mxu_mode(items, f)], (items, f)
    assert tp.select_schedule(624_961, 40, D) != "minibatch"


def test_kdd_catalog_on_eight_devices_selects_sharded_tiled():
    """The JAX tests' shape: 624,961 items at k=40 on 8 devices pass the
    resident partition bound and stay within the sharded-tiled one."""
    assert not tp.mxu_sharded_supported(624_961, 40, 8)
    assert tp.mxu_sharded_tiled_supported(624_961, 40, 8)
    assert tp.select_schedule(624_961, 40, 8) == "sharded-tiled"
    # phase 24's big catalog: the minibatch epoch on one device, kernels
    # 2 and 4 on a 4-device mesh
    assert tp.select_schedule(2_200_000, 40) == "minibatch"
    assert tp.select_schedule(2_200_000, 40, 4) == "sharded-tiled"


def test_unsupported_mesh_shape_warns(caplog):
    with caplog.at_level(logging.WARNING, logger="mymedialite_tpu_torch"):
        assert tp.select_schedule(700_000, 40_000, 8) == "minibatch"
    assert any("no kernel schedule" in r.message for r in caplog.records)


# --- the model layer, the route forced as MML_MXU=sharded-tiled-interpret
# forces the JAX models' ---

def force_sharded_tiled(mp):
    mp.setattr(tp, "select_schedule", lambda *a, **k: "sharded-tiled")
    mp.setattr(tbpr, "select_schedule", lambda *a, **k: "sharded-tiled")


def test_biasedmf_sharded_tiled_engages_and_matches(monkeypatch, tmp_path):
    train, test = planted_ratings()
    m_one = train_mf(None, train)
    rmse_one = evaluate_ratings(m_one, test)["RMSE"]
    force_sharded_tiled(monkeypatch)
    m_st = train_mf(cpu_mesh(4), train)
    assert isinstance(m_st._plan, tp.MxuShardedTiledPlan), \
        "the sharded-tiled plan is not engaged through train()"
    rmse_st = evaluate_ratings(m_st, test)["RMSE"]
    assert np.isfinite(rmse_st)
    assert abs(rmse_st - rmse_one) < 0.06, (rmse_st, rmse_one)
    path = str(tmp_path / "mf.model")
    m_st.save_model(path)
    from mymedialite_tpu_torch.models.mf import BiasedMatrixFactorization
    loaded = BiasedMatrixFactorization()
    loaded.device = "cpu"
    loaded.ratings = train
    loaded.load_model(path)
    np.testing.assert_array_equal(
        loaded.predict_batch(test.users, test.items),
        m_st.predict_batch(test.users, test.items))


def test_bprmf_sharded_tiled_engages_and_ranks(monkeypatch):
    train, test = planted_feedback()
    m_one = train_bpr(tbpr.BPRMF, None, train)
    auc_one = evaluate_items(m_one, test, train)["AUC"]
    force_sharded_tiled(monkeypatch)
    m_st = train_bpr(tbpr.BPRMF, cpu_mesh(4), train)
    assert isinstance(m_st._plan, tp.MxuShardedTiledPlan), \
        "the sharded-tiled BPR plan is not engaged through train()"
    auc_st = evaluate_items(m_st, test, train)["AUC"]
    assert auc_st > 0.6, f"sharded-tiled BPR did not learn ({auc_st})"
    assert abs(auc_st - auc_one) < 0.05, (auc_st, auc_one)


def test_wbpr_sharded_tiled_runs(monkeypatch):
    force_sharded_tiled(monkeypatch)
    _, fb = feedback(80, 60, 1200, seed=13)
    m = train_bpr(tbpr.WeightedBPRMF, cpu_mesh(4), fb, num_iter=2, f=6)
    assert isinstance(m._plan, tp.MxuShardedTiledPlan)
    s = m.predict_batch(np.arange(8, dtype=np.int32),
                        np.arange(8, dtype=np.int32))
    assert np.isfinite(s).all()
