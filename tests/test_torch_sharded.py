"""The port's sharded schedule (the DSGD diagonal over a device mesh)
against the JAX package's, on the CPU; mirrors tests/test_mxu_sharded.py.

The JAX side runs ``sgd_epoch_mxu_sharded`` / ``bpr_epoch_mxu_sharded``
in interpret mode with float32 operands on its 8-device virtual CPU mesh
(``tests/conftest.py``), cut to D devices; the port's mesh is ``["cpu"] *
D``, on which the wrappers run their plain versions. Plans and orders are
compared array for array, the epochs from the same tables, order and
random bits to atol 1e-5 (the sums inside a chunk run in another order),
the BPR negatives exactly. The port's sharded epoch equals its own cells
run one after another in (k, d) order bit for bit; the models engage the
sharded plans on a CPU mesh and reach the one-device quality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mymedialite_tpu.data.arrays import PosOnlyData as JPosOnly
from mymedialite_tpu.models import mf as jmf
from mymedialite_tpu.ops import pallas_bpr as pb
from mymedialite_tpu.ops import pallas_sgd as ps
from mymedialite_tpu.parallel.mesh import make_mesh as jax_mesh
from mymedialite_tpu.utils.params import configure
from mymedialite_tpu_torch.convert import tables_from_jax
from mymedialite_tpu_torch.data.arrays import PosOnlyData, RatingData
from mymedialite_tpu_torch.eval.ranking import evaluate_items
from mymedialite_tpu_torch.eval.rating import evaluate_ratings
from mymedialite_tpu_torch.models import bpr as tbpr
from mymedialite_tpu_torch.models import mf as tmf
from mymedialite_tpu_torch.ops import bpr_plan as tb
from mymedialite_tpu_torch.ops import plan as tp
from mymedialite_tpu_torch.ops.bpr_epoch import bpr_epoch, bpr_epoch_sharded
from mymedialite_tpu_torch.ops.sgd_epoch import sgd_epoch, sgd_epoch_sharded
from mymedialite_tpu_torch.parallel.mesh import make_mesh, model_mesh
from torch_threads import one_torch_thread  # noqa: F401

MESHES = (2, 4, 8)
F, FE = 6, 16


def cpu_mesh(D):
    return make_mesh(devices=["cpu"] * D)


def jax_sharded(D, *tables):
    """The JAX mesh of D CPU devices and the tables row-sharded on it."""
    mesh = jax_mesh(D)
    sh2 = NamedSharding(mesh, P("data", None))
    return mesh, [jax.device_put(jnp.asarray(t), sh2) for t in tables]


def events(U=100, I=90, n=1800, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, U, n).astype(np.int32),
            rng.integers(0, I, n).astype(np.int32),
            rng.uniform(1, 5, n).astype(np.float32))


def feedback(U=100, I=80, n=1500, seed=0):
    """tests/test_mxu_sharded.py's feedback, in both packages."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, I, n).astype(np.int32)
    return (JPosOnly(u, i, num_users=U, num_items=I),
            PosOnlyData(u, i, num_users=U, num_items=I))


def mf_tables(plan, U, I, seed=1):
    rng = np.random.default_rng(seed)
    W0 = np.zeros((plan.u_pad, FE), np.float32)
    W0[:U, :F] = 0.1 * rng.standard_normal((U, F))
    W0[:U, F + 1] = 1.0
    H0 = np.zeros((plan.i_pad, FE), np.float32)
    H0[plan.new_of_old, :F] = 0.1 * rng.standard_normal((I, F))
    H0[plan.new_of_old, F] = 1.0
    return W0, H0


def assert_same_plan(tplan, jplan):
    np.testing.assert_array_equal(tplan.packed.numpy(),
                                  np.asarray(jplan.packed)[:-1])
    assert not np.asarray(jplan.packed)[-1].any()    # JAX's pad chunk
    for name in ("num_devices", "nc_pad", "chunk", "user_block",
                 "item_block", "ub_per_dev", "part_blocks", "u_pad",
                 "i_pad", "u_pad_dev", "part_rows", "n_ratings"):
        assert getattr(tplan, name) == getattr(jplan, name), name
    for name in ("ub_c", "ib_c", "new_of_old", "old_of_new"):
        np.testing.assert_array_equal(getattr(tplan, name),
                                      getattr(jplan, name))
    for d in range(tplan.num_devices):
        for k in range(tplan.num_devices):
            np.testing.assert_array_equal(tplan.cells[d][k],
                                          jplan.cells[d][k])


def assert_same_order(torder, jorder):
    assert len(torder) == len(jorder)
    for t, j in zip(torder, jorder):
        assert t.dtype == np.int32
        np.testing.assert_array_equal(t, np.asarray(j))


def covered_once(plan, row):
    """Every chunk visited once across the cells, pads never."""
    counts = plan.cell_counts
    real = np.concatenate([row[d, k, :counts[d, k]]
                           for d in range(plan.num_devices)
                           for k in range(plan.num_devices)])
    assert sorted(real.tolist()) == list(range(plan.num_chunks))
    pads = np.concatenate([row[d, k, counts[d, k]:]
                           for d in range(plan.num_devices)
                           for k in range(plan.num_devices)])
    assert (pads == plan.num_chunks).all()


# --- the sharded MF plan and epoch ---

@pytest.mark.parametrize("D", MESHES)
def test_sgd_plan_and_order_identical(D):
    users, items, values = events()
    kw = dict(user_block=8, item_block=8, chunk=8, shuffle_seed=0)
    jplan = ps.prepare_mxu_sharded(users, items, values, 100, 90, D, **kw)
    tplan = tp.prepare_mxu_sharded(users, items, values, 100, 90, D, **kw)
    assert isinstance(tplan, tp.MxuShardedPlan)
    assert_same_plan(tplan, jplan)
    for seed in (3, None):
        assert_same_order(tplan.epoch_order(seed), jplan.epoch_order(seed))
    covered_once(tplan, tplan.epoch_order(9)[2])


def sgd_inputs(D, loss=0, biased=True):
    users, items, values = events()
    kw = dict(user_block=8, item_block=8, chunk=8, shuffle_seed=0)
    jplan = ps.prepare_mxu_sharded(users, items, values, 100, 90, D, **kw)
    tplan = tp.prepare_mxu_sharded(users, items, values, 100, 90, D, **kw)
    W0, H0 = mf_tables(tplan, 100, 90)
    args = (F, FE, 0.01, 0.015, 0.015, 1.0, 0.01, biased, True, True)
    return jplan, tplan, W0, H0, ps.mxu_column_rates(*args), \
        tp.mxu_column_rates(*args)


@pytest.mark.parametrize("loss,biased", [(0, True), (1, True), (2, True),
                                         (0, False)],
                         ids=["rmse", "mae", "logistic", "plain"])
@pytest.mark.parametrize("D", MESHES)
def test_sgd_epoch_matches_jax(D, loss, biased):
    jplan, tplan, W0, H0, rates_j, rates_t = sgd_inputs(D, loss, biased)
    hp = (3.0, 1.0, 4.0)
    hp_j = np.zeros((1, 8), np.float32)
    hp_j[0, :3] = hp
    mesh, (Wj, Hj) = jax_sharded(D, W0, H0)
    Wj, Hj = ps.sgd_epoch_mxu_sharded(
        mesh, Wj, Hj, jplan.packed, jplan.epoch_order(3), jnp.asarray(hp_j),
        rates_j, meta=jplan.meta(FE), loss=loss, biased=biased,
        mxu_dtype="f32", interpret=True)
    tmesh = cpu_mesh(D)
    Ws = tmesh.shard_rows(torch.from_numpy(W0.copy()))
    Hs = tmesh.shard_rows(torch.from_numpy(H0.copy()))
    launches = sgd_epoch.launches
    sgd_epoch_sharded(tmesh, Ws, Hs, tplan.packed, tplan.epoch_order(3),
                      tplan.cell_counts, hp, rates_t,
                      user_block=tplan.user_block,
                      item_block=tplan.item_block, loss=loss, biased=biased)
    assert sgd_epoch.launches == launches        # the CPU launches nothing
    Wt, Ht = tmesh.gather_rows(Ws), tmesh.gather_rows(Hs)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=0, atol=1e-5)
    assert np.abs(Wt.numpy() - W0).max() > 0, "the epoch was a no-op"


@pytest.mark.parametrize("D", MESHES)
def test_sgd_epoch_equals_sequential_cells(D):
    """Sub-epoch k touches disjoint W rows and partitions, so the sharded
    epoch equals its cells run one after another in (k, d) order through
    ``sgd_epoch`` on the shard views, bit for bit."""
    _, plan, W0, H0, _, rates = sgd_inputs(D)
    hp = (3.0, 1.0, 4.0)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=0, biased=True)
    order = plan.epoch_order(3)
    mesh = cpu_mesh(D)
    Ws = mesh.shard_rows(torch.from_numpy(W0.copy()))
    Hs = mesh.shard_rows(torch.from_numpy(H0.copy()))
    sgd_epoch_sharded(mesh, Ws, Hs, plan.packed, order, plan.cell_counts, hp,
                      rates, **kw)
    W, H = torch.from_numpy(W0.copy()), torch.from_numpy(H0.copy())
    upd, pr = plan.u_pad_dev, plan.part_rows
    for k in range(D):
        for d in range(D):
            n = plan.cell_counts[d, k]
            if not n:
                continue
            p = (d + k) % D
            cell = tuple(torch.from_numpy(a[d, k, :n].copy()) for a in order)
            sgd_epoch(W[d * upd:(d + 1) * upd], H[p * pr:(p + 1) * pr],
                      plan.packed, cell, hp, rates, **kw)
    assert torch.equal(mesh.gather_rows(Ws), W)
    assert torch.equal(mesh.gather_rows(Hs), H)


def test_plain_flag_runs_the_reference_cells():
    """``plain=True`` gives the plain version of every cell: on the CPU
    the wrapper's own route, so the two agree bit for bit."""
    _, plan, W0, H0, _, rates = sgd_inputs(4)
    mesh = cpu_mesh(4)
    out = []
    for plain in (False, True):
        Ws = mesh.shard_rows(torch.from_numpy(W0.copy()))
        Hs = mesh.shard_rows(torch.from_numpy(H0.copy()))
        sgd_epoch_sharded(mesh, Ws, Hs, plan.packed, plan.epoch_order(2),
                          plan.cell_counts, (3.0, 1.0, 4.0), rates,
                          user_block=8, item_block=8, loss=0, biased=True,
                          plain=plain)
        out.append((mesh.gather_rows(Ws), mesh.gather_rows(Hs)))
    assert all(torch.equal(a, b) for a, b in zip(*out))


# --- the sharded BPR plan and epoch ---

def bpr_plans(D, *, uniform_user=True, bitmask=False, seed=0, **kw):
    fbj, fbt = feedback(seed=seed, **kw)
    args = dict(uniform_user=uniform_user, user_block=8, item_block=8,
                chunk=8, shuffle_seed=0)
    jplan, jstate, jmeta = pb.prepare_bpr_mxu_sharded(fbj, D, bitmask=bitmask,
                                                      **args)
    tplan, tstate, tmeta = tb.prepare_bpr_mxu_sharded(fbt, D, bitmask=bitmask,
                                                      **args)
    return (jplan, jstate, jmeta), (tplan, tstate, tmeta)


@pytest.mark.parametrize("wbpr", [False, True], ids=["uniform", "wbpr"])
@pytest.mark.parametrize("D", MESHES)
def test_bpr_plan_and_order_identical(D, wbpr):
    (jplan, jstate, jmeta), (tplan, tstate, tmeta) = bpr_plans(
        D, uniform_user=not wbpr, bitmask=True)
    assert_same_plan(tplan, jplan)
    assert tmeta == tuple(jmeta)
    for name in ("keys_tbl", "cdf_tbl", "bitmask_tbl"):
        np.testing.assert_array_equal(tstate[name].numpy(),
                                      np.asarray(jstate[name]))
    np.testing.assert_array_equal(tstate["nvalid"], jstate["nvalid"])
    mass = (lambda s: s["block_mass"] if wbpr else None)
    jorder = jplan.epoch_order(jstate["nvalid"], 3, block_mass=mass(jstate))
    torder = tb.bpr_sharded_epoch_order(tplan, tstate["nvalid"], 3,
                                        block_mass=mass(tstate))
    assert_same_order(torder, jorder)
    covered_once(tplan, torder[6])


def jax_bpr_bits(D, plan, trials, seed=5):
    bits = pb.epoch_random_bits(jax.random.PRNGKey(seed),
                                nc=D * D * plan.nc_pad, trials=trials,
                                C=plan.chunk)
    return np.array(bits).reshape(D, D, plan.nc_pad, trials, plan.chunk)


def bpr_tables(plan, U, I, seed=1):
    rng = np.random.default_rng(seed)
    We, He = pb.bpr_tables_to_mxu(
        jnp.asarray(0.1 * rng.standard_normal((U, F)), jnp.float32),
        jnp.asarray(0.1 * rng.standard_normal((I, F)), jnp.float32),
        jnp.asarray(0.1 * rng.standard_normal(I), jnp.float32),
        jnp.asarray(plan.new_of_old), u_pad=plan.u_pad, i_pad=plan.i_pad,
        fe=FE)
    return np.asarray(We), np.asarray(He)


def assert_same_negatives(tnegs, jnegs, counts):
    D = counts.shape[0]
    for d in range(D):
        for k in range(D):
            n = counts[d, k]
            if n:
                np.testing.assert_array_equal(
                    tnegs[d][k].numpy(), jnegs[d, k, :n],
                    err_msg=f"negatives of cell d={d} k={k}")
            else:
                assert tnegs[d][k] is None


# (soft_margin, wbpr, bitmask)
BPR_VARIANTS = [(False, False, False), (True, False, False),
                (False, True, False), (False, False, True)]


@pytest.mark.parametrize("variant", BPR_VARIANTS,
                         ids=["keys", "hinge", "wbpr", "bitmask"])
@pytest.mark.parametrize("D", MESHES)
def test_bpr_epoch_matches_jax(D, variant):
    soft_margin, wbpr, bitmask = variant
    (jplan, jstate, jmeta), (tplan, tstate, _) = bpr_plans(
        D, uniform_user=not wbpr, bitmask=bitmask)
    trials = jmeta[2]
    We, He = bpr_tables(jplan, 100, 80)
    rates = pb.bpr_mxu_column_rates(F, FE, 0.05, 0.0025, 0.0025, 0.00025,
                                    0.01, True)
    jorder = jplan.epoch_order(jstate["nvalid"], 3, block_mass=(
        jstate["block_mass"] if wbpr else None))
    bits = jax_bpr_bits(D, jplan, trials)
    mesh, (Wj, Hj) = jax_sharded(D, We, He)
    Wj, Hj, jnegs = pb.bpr_epoch_mxu_sharded(
        mesh, Wj, Hj, jplan.packed, jstate["keys_tbl"], jstate["cdf_tbl"],
        jnp.asarray(bits), jorder, rates,
        meta=jplan.meta(FE) + (jmeta[1], trials), soft_margin=soft_margin,
        wbpr=wbpr, mxu_dtype="f32", interpret=True,
        bm_tbl=jstate["bitmask_tbl"] if bitmask else None)

    tmesh = cpu_mesh(D)
    Ws = tmesh.shard_rows(torch.from_numpy(We.copy()))
    Hs = tmesh.shard_rows(torch.from_numpy(He.copy()))
    torder = tb.bpr_sharded_epoch_order(tplan, tstate["nvalid"], 3,
                                        block_mass=(tstate["block_mass"]
                                                    if wbpr else None))
    _, _, tnegs = bpr_epoch_sharded(
        tmesh, Ws, Hs, tplan.packed, tstate["keys_tbl"], tstate["cdf_tbl"],
        torch.from_numpy(bits), torder, tplan.cell_counts,
        torch.from_numpy(np.array(rates)), part_blocks=tplan.part_blocks,
        user_block=tplan.user_block, item_block=tplan.item_block,
        soft_margin=soft_margin, wbpr=wbpr,
        bitmask_tbl=tstate["bitmask_tbl"] if bitmask else None,
        return_negatives=True)
    assert_same_negatives(tnegs, np.asarray(jnegs), tplan.cell_counts)
    np.testing.assert_allclose(tmesh.gather_rows(Ws).numpy(), np.asarray(Wj),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tmesh.gather_rows(Hs).numpy(), np.asarray(Hj),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("D", MESHES)
def test_bpr_epoch_equals_sequential_cells(D):
    """The sharded BPR epoch equals its cells run one after another in
    (k, d) order through ``bpr_epoch`` on the shard views, the partition's
    CDF rows and the same bits, bit for bit, negatives included."""
    _, (plan, state, meta) = bpr_plans(D, uniform_user=False)
    We, He = bpr_tables(plan, 100, 80)
    rates = tb.bpr_mxu_column_rates(F, FE, 0.05, 0.0025, 0.0025, 0.00025,
                                    0.01, True)
    order = tb.bpr_sharded_epoch_order(plan, state["nvalid"], 4,
                                       block_mass=state["block_mass"])
    bits = torch.from_numpy(jax_bpr_bits(D, plan, meta[2], seed=8))
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              wbpr=True, return_negatives=True)
    mesh = cpu_mesh(D)
    Ws = mesh.shard_rows(torch.from_numpy(We.copy()))
    Hs = mesh.shard_rows(torch.from_numpy(He.copy()))
    _, _, negs = bpr_epoch_sharded(
        mesh, Ws, Hs, plan.packed, state["keys_tbl"], state["cdf_tbl"], bits,
        order, plan.cell_counts, rates, part_blocks=plan.part_blocks, **kw)
    W, H = torch.from_numpy(We.copy()), torch.from_numpy(He.copy())
    upd, pr, PB = plan.u_pad_dev, plan.part_rows, plan.part_blocks
    for k in range(D):
        for d in range(D):
            n = plan.cell_counts[d, k]
            if not n:
                continue
            p = (d + k) % D
            ub, ib, jb, _, nval, bkt, row = (
                torch.from_numpy(a[d, k, :n].copy()) for a in order)
            _, _, neg = bpr_epoch(
                W[d * upd:(d + 1) * upd], H[p * pr:(p + 1) * pr],
                plan.packed, state["keys_tbl"],
                state["cdf_tbl"][p * PB:(p + 1) * PB], bits[d, k, :n],
                (ub, ib, row), jb, nval, bkt, rates, **kw)
            assert torch.equal(negs[d][k], neg)
    assert torch.equal(mesh.gather_rows(Ws), W)
    assert torch.equal(mesh.gather_rows(Hs), H)


def test_partition_negative_marginal():
    """The within-partition draw keeps P(block | partition) = nvalid_b /
    (the partition's items), as tests/test_mxu_sharded.py's."""
    D = 8
    _, (plan, state, _) = bpr_plans(D, uniform_user=False, U=64, I=100,
                                    n=4000, seed=2)
    nvalid = state["nvalid"]
    PB, n_ib = plan.part_blocks, plan.n_iblocks
    counts = np.zeros(n_ib, np.int64)
    for s in range(400):
        order = tb.bpr_sharded_epoch_order(plan, nvalid, s)
        jbg, row = order[3], order[6]
        np.add.at(counts, jbg[row < plan.num_chunks], 1)
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


# --- the model layer ---

def planted_ratings():
    """tests/test_mxu_sharded.py's planted ratings, split 80/20."""
    rng = np.random.default_rng(7)
    U, I, n = 200, 120, 4000
    users = rng.integers(0, U, n).astype(np.int32)
    items = rng.integers(0, I, n).astype(np.int32)
    wu = rng.standard_normal((U, 4))
    hi = rng.standard_normal((I, 4))
    vals = np.clip(3 + (wu[users] * hi[items]).sum(1) * 0.5
                   + 0.3 * rng.standard_normal(n), 1, 5).astype(np.float32)
    return (RatingData(users[:3200], items[:3200], vals[:3200],
                       num_users=U, num_items=I),
            RatingData(users[3200:], items[3200:], vals[3200:],
                       num_users=U, num_items=I))


def planted_feedback():
    """tests/test_mxu_sharded.py's planted preferences, split 80/20."""
    rng = np.random.default_rng(11)
    U, I = 160, 96
    tr_u, tr_i, te_u, te_i = [], [], [], []
    for u in range(U):
        base = (u * 7) % I
        liked = np.unique((base + np.unique(rng.integers(0, 20, 24))) % I)
        rng.shuffle(liked)
        cut = max(int(liked.size * 0.8), 1)
        tr_u.extend([u] * cut)
        tr_i.extend(liked[:cut])
        te_u.extend([u] * (liked.size - cut))
        te_i.extend(liked[cut:])
    return (PosOnlyData(np.asarray(tr_u, np.int32), np.asarray(tr_i, np.int32),
                        num_users=U, num_items=I),
            PosOnlyData(np.asarray(te_u, np.int32), np.asarray(te_i, np.int32),
                        num_users=U, num_items=I))


def train_mf(mesh, train):
    m = tmf.BiasedMatrixFactorization()
    m.device = "cpu"
    m.num_factors = 8
    m.num_iter = 8
    m.mesh = mesh
    m.ratings = train
    m.train()
    return m


@pytest.mark.parametrize("D", [4, 8])
def test_biasedmf_sharded_engages_and_matches(D, tmp_path):
    train, test = planted_ratings()
    m_sh = train_mf(cpu_mesh(D), train)
    assert isinstance(m_sh._plan, tp.MxuShardedPlan) \
        and not isinstance(m_sh._plan, tp.MxuShardedTiledPlan), \
        "the sharded plan is not engaged through train()"
    assert isinstance(m_sh._mxu_tables[0], list)
    assert len(m_sh._mxu_tables[0]) == D
    rmse_sh = evaluate_ratings(m_sh, test)["RMSE"]
    m_one = train_mf(None, train)
    assert isinstance(m_one._plan, tp.MxuPlan)
    rmse_one = evaluate_ratings(m_one, test)["RMSE"]
    assert np.isfinite(rmse_sh)
    assert abs(rmse_sh - rmse_one) < 0.06, (rmse_sh, rmse_one)
    # the gathered std tables: pad rows of the shards stay out
    assert m_sh.W_ext.shape == m_one.W_ext.shape
    assert m_sh.H_ext.shape == m_one.H_ext.shape
    # save -> load keeps the predictions
    path = str(tmp_path / "mf.model")
    m_sh.save_model(path)
    loaded = tmf.BiasedMatrixFactorization()
    loaded.device = "cpu"
    loaded.ratings = train
    loaded.load_model(path)
    np.testing.assert_array_equal(
        loaded.predict_batch(test.users, test.items),
        m_sh.predict_batch(test.users, test.items))
    assert evaluate_ratings(loaded, test)["RMSE"] == rmse_sh


def test_biasedmf_sharded_matches_jax_model(monkeypatch):
    """From the same initial tables, one epoch of the port's BiasedMF on
    ["cpu"] * 8 equals one of the JAX model's under
    MML_MXU=sharded-interpret on the 8-device CPU mesh."""
    train, _ = planted_ratings()
    from mymedialite_tpu.data.arrays import RatingData as JRating
    jtrain = JRating(train.users, train.items, train.values,
                     num_users=train.num_users, num_items=train.num_items)
    monkeypatch.setenv("MML_MXU", "sharded-interpret")
    jm = jmf.BiasedMatrixFactorization()
    configure(jm, "num_factors=8 mxu_dtype=f32")
    jm.ratings = jtrain
    jm.init_model()
    assert isinstance(jm._mxu_plan, ps.MxuShardedPlan)
    assert jm._mxu_mesh.devices.size == 8
    tm = tmf.BiasedMatrixFactorization()
    configure(tm, "num_factors=8 device=cpu")
    tm.mesh = cpu_mesh(8)
    tm.ratings = train
    tm.init_model(tables=tables_from_jax(jm))
    assert isinstance(tm._plan, tp.MxuShardedPlan)
    jm.iterate()
    tm.iterate()
    np.testing.assert_allclose(tm.W_ext.numpy(), np.asarray(jm.W_ext),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.H_ext.numpy(), np.asarray(jm.H_ext),
                               rtol=0, atol=1e-5)


def train_bpr(cls, mesh, train, num_iter=15, f=8):
    m = cls()
    m.device = "cpu"
    m.num_factors = f
    m.num_iter = num_iter
    m.mesh = mesh
    m.feedback = train
    m.train()
    return m


@pytest.mark.parametrize("D", [4, 8])
def test_bprmf_sharded_engages_and_ranks(D, tmp_path):
    train, test = planted_feedback()
    m_sh = train_bpr(tbpr.BPRMF, cpu_mesh(D), train)
    assert isinstance(m_sh._plan, tp.MxuShardedPlan) \
        and not isinstance(m_sh._plan, tp.MxuShardedTiledPlan), \
        "the sharded BPR plan is not engaged through train()"
    auc_sh = evaluate_items(m_sh, test, train)["AUC"]
    m_one = train_bpr(tbpr.BPRMF, None, train)
    assert isinstance(m_one._plan, tp.MxuPlan)
    auc_one = evaluate_items(m_one, test, train)["AUC"]
    assert auc_sh > 0.6, f"sharded BPR did not learn (AUC {auc_sh})"
    assert abs(auc_sh - auc_one) < 0.05, (auc_sh, auc_one)
    path = str(tmp_path / "bpr.model")
    m_sh.save_model(path)
    loaded = tbpr.BPRMF()
    loaded.device = "cpu"
    loaded.load_model(path)
    users = np.repeat(np.arange(16, dtype=np.int32), 6)
    items = np.tile(np.arange(6, dtype=np.int32), 16)
    np.testing.assert_array_equal(loaded.predict_batch(users, items),
                                  m_sh.predict_batch(users, items))


@pytest.mark.parametrize("cls", [tbpr.WeightedBPRMF, tbpr.MultiCoreBPRMF,
                                 tbpr.SoftMarginRankingMF],
                         ids=["wbpr", "multicore", "soft-margin"])
def test_bpr_family_sharded_runs(cls):
    """WeightedBPRMF (popularity negatives within the resident partition),
    MultiCoreBPRMF (the sharded kernel route, as the JAX model prefers)
    and the hinge model ride the sharded plan and give finite scores, as
    test_wbpr_sharded_runs and test_multicore_bprmf_prefers_sharded_mxu
    hold the JAX models to."""
    _, fb = feedback(80, 60, 1200, seed=3)
    m = train_bpr(cls, cpu_mesh(4), fb, num_iter=2)
    assert isinstance(m._plan, tp.MxuShardedPlan)
    assert model_mesh(m).size == 4 and m._mesh is m.mesh
    s = m.predict_batch(np.arange(8, dtype=np.int32),
                        np.arange(8, dtype=np.int32))
    assert np.isfinite(s).all()


def test_one_device_routes_on_a_mesh_log(caplog):
    """Frequency regularization has no sharded form in the port: on a
    mesh the model keeps its one-device route and says so."""
    import logging
    train, _ = planted_ratings()
    m = tmf.BiasedMatrixFactorization()
    configure_opts = "num_factors=4 num_iter=1 frequency_regularization=true"
    from mymedialite_tpu_torch.utils.params import configure as tconfigure
    tconfigure(m, configure_opts + " device=cpu")
    m.mesh = cpu_mesh(4)
    m.ratings = train
    with caplog.at_level(logging.WARNING, logger="mymedialite_tpu_torch"):
        m.train()
    assert m._blocked is not None and m._plan is None
    assert any("no sharded form" in r.message for r in caplog.records)


def test_a_one_device_mesh_is_no_mesh():
    train, _ = planted_ratings()
    m = train_mf(cpu_mesh(1), train)
    assert isinstance(m._plan, tp.MxuPlan)
