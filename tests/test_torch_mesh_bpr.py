"""The sharded minibatch BPR epoch of the port (``ops/bpr.py
make_sampler_data_sharded``, ``sample_triples_sharded``,
``bpr_step_sharded``, ``bpr_epoch_sharded``) and MultiCoreBPRMF's route
past the sharded-tiled bound, against the JAX package's
``bpr_epoch_sharded`` on its virtual CPU mesh.

The sampling state equals the JAX package's array for array. Fed the
JAX package's per-device triples (recomputed from ``fold_in(fold_in(key,
d), b)`` and, without replacement, the permutation of ``fold_in(kd,
0x5eed)``, as its ``device_fn`` draws them), the port's sharded steps
land within 1e-5 of JAX's epoch on D = 2, 4 and 8 CPU "devices" in all
four regimes, with the hinge and without the j update. A step is not one
``bpr_step`` over the concatenated triples: each device's j bias reads
its own bias after its i updates. The port's own draws keep every
device's triples among its users, and MultiCoreBPRMF past the bound
trains on the mesh (BPRMF stays on one device and says so).
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mymedialite_tpu.data.arrays import PosOnlyData as JaxPosOnly
from mymedialite_tpu.models import bpr as jbpr
from mymedialite_tpu.ops import bpr as jb
from mymedialite_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mymedialite_tpu.parallel.mesh import replicated, row_sharded_2d
from mymedialite_tpu.utils.params import configure as jax_configure
from mymedialite_tpu_torch.convert import bpr_tables_from_jax
from mymedialite_tpu_torch.data.arrays import PosOnlyData
from mymedialite_tpu_torch.models import bpr as tbpr
from mymedialite_tpu_torch.models.registry import create_item_recommender
from mymedialite_tpu_torch.ops import bpr as tb
from mymedialite_tpu_torch.ops import plan as tplan
from mymedialite_tpu_torch.parallel.mesh import make_mesh
from torch_threads import one_torch_thread  # noqa: F401

U, I, F = 83, 60, 6
HP = dict(learn_rate=0.05, reg_u=0.01, reg_i=0.02, reg_j=0.005, bias_reg=0.1)
REGIMES = [tb.UNIFORM_USER, tb.UNIFORM_PAIR, tb.UNIFORM_PAIR_WOR, tb.WBPR]


@pytest.fixture(scope="module")
def feedback():
    rng = np.random.default_rng(0)
    key = np.unique(rng.integers(0, U, 1500) * I
                    + (rng.zipf(1.3, 1500) % I))
    u, i = (key // I).astype(np.int32), (key % I).astype(np.int32)
    return (JaxPosOnly(u, i, num_users=U, num_items=I),
            PosOnlyData(u, i, num_users=U, num_items=I))


@pytest.mark.parametrize("D", [2, 3, 4, 8])
def test_sampler_data_equals_jax(feedback, D):
    jf, tf = feedback
    jd, jm = jb.make_sampler_data_sharded(jf, D, 8)
    td, tm = tb.make_sampler_data_sharded(tf, D, 8)
    assert tm == jm
    assert sorted(td) == sorted(jd)
    for k in jd:
        a = np.asarray(jd[k])
        assert td[k].dtype == a.dtype and td[k].shape == a.shape, k
        np.testing.assert_array_equal(td[k], a, k)


def test_sampler_data_with_an_empty_device():
    """A device past the last user (U < D x u_loc) owns nothing: empty
    lists padded with zeros, weight 0 in the epoch."""
    u = np.array([0, 0, 1, 2], np.int32)
    i = np.array([1, 2, 0, 3], np.int32)
    jd, jm = jb.make_sampler_data_sharded(
        JaxPosOnly(u, i, num_users=3, num_items=5), 4)
    td, tm = tb.make_sampler_data_sharded(
        PosOnlyData(u, i, num_users=3, num_items=5), 4)
    assert tm == jm and td["ev_count"].tolist() == [2, 1, 1, 0]
    for k in jd:
        np.testing.assert_array_equal(td[k], np.asarray(jd[k]), k)


def ids(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _negatives(trials, depth, num_items, wbpr):
    return jax.jit(lambda k, hist, indptr, u, pop: jb._sample_negatives(
        k, dict(hist_items=hist, indptr=indptr), u, num_items, trials,
        depth, pop_cdf=pop if wbpr else None))


def jax_device_triples(jd, jm, key, d, batch, nb, regime, pop):
    """Device d's triples, batch by batch, as the JAX package's sharded
    ``device_fn`` draws them."""
    hist, indptr = jnp.asarray(jd["hist_items"][d]), jnp.asarray(
        jd["indptr"][d])
    counts, valid = jnp.asarray(jd["counts"][d]), jnp.asarray(
        jd["valid_users"][d])
    vcount, ecount = int(jd["valid_count"][d]), int(jd["ev_count"][d])
    ev_u, ev_i = jnp.asarray(jd["ev_user"][d]), jnp.asarray(jd["ev_item"][d])
    kd = jax.random.fold_in(key, d)
    neg = _negatives(jm["num_neg_trials"], jm["search_depth"],
                     jm["num_items"], regime == jb.WBPR)
    perm = None
    if regime == jb.UNIFORM_PAIR_WOR:
        perm = jax.random.permutation(jax.random.fold_in(kd, 0x5eed),
                                      jnp.arange(nb * batch, dtype=jnp.int32))
    out = []
    for b in range(nb):
        k_u, k_i, k_j = jax.random.split(jax.random.fold_in(kd, b), 3)
        if regime == jb.UNIFORM_USER:
            uidx = jax.random.randint(k_u, (batch,), 0, valid.shape[0],
                                      dtype=jnp.int32)
            u = valid[uidx]
            r = jax.random.randint(k_i, (batch,), 0,
                                   jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
            i = hist[jnp.minimum(indptr[u] + r % jnp.maximum(counts[u], 1),
                                 hist.shape[0] - 1)]
            base = ((counts[u] > 0) & (vcount > 0)).astype(jnp.float32)
        elif regime == jb.UNIFORM_PAIR_WOR:
            raw = perm[b * batch:(b + 1) * batch]
            eidx = raw % max(ecount, 1)
            u, i = ev_u[eidx], ev_i[eidx]
            base = ((raw < ecount) & (ecount > 0)).astype(jnp.float32)
        else:
            eidx = jax.random.randint(k_u, (batch,), 0, ev_u.shape[0],
                                      dtype=jnp.int32)
            u, i = ev_u[eidx], ev_i[eidx]
            base = jnp.full((batch,), float(ecount > 0), jnp.float32)
        j, ok = neg(k_j, hist, indptr, u, pop)
        out.append((ids(u), ids(i), ids(j),
                    torch.from_numpy(np.array(ok.astype(jnp.float32)
                                              * base))))
    return out


def tables(U_rows, seed=1):
    rng = np.random.default_rng(seed)
    t = dict(user_factors=0.1 * rng.standard_normal((U_rows, F)),
             item_factors=0.1 * rng.standard_normal((I, F)),
             item_bias=0.1 * rng.standard_normal(I))
    return {k: v.astype(np.float32) for k, v in t.items()}


def jax_sharded(D, jd, jm, t, key, pop, **kw):
    mesh = jax_make_mesh(D)
    sh = {k: jax.device_put(np.asarray(v), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("data", *([None] * (
            np.asarray(v).ndim - 1))))) for k, v in jd.items()}
    params = dict(user_factors=jax.device_put(t["user_factors"],
                                              row_sharded_2d(mesh)),
                  item_factors=jax.device_put(t["item_factors"],
                                              replicated(mesh)),
                  item_bias=jax.device_put(t["item_bias"], replicated(mesh)))
    out = jb.bpr_epoch_sharded(
        mesh, params, sh, key, {k: jnp.float32(v) for k, v in HP.items()},
        pop, meta_static=tuple(sorted(jm.items())), **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def port_steps(D, t, triples_by_device, **kw):
    mesh = make_mesh(devices=["cpu"] * D)
    got = {k: torch.from_numpy(v.copy()) for k, v in t.items()}
    W = mesh.shard_rows(got["user_factors"])
    H, b = mesh.replicate(got["item_factors"]), mesh.replicate(
        got["item_bias"])
    for step in zip(*triples_by_device):
        H, b = tb.bpr_step_sharded(mesh, W, H, b, list(step), HP, **kw)
    return {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("regime,soft_margin,update_j", [
    (tb.UNIFORM_USER, False, True), (tb.UNIFORM_PAIR, True, True),
    (tb.UNIFORM_PAIR_WOR, False, False), (tb.WBPR, False, True),
    (tb.UNIFORM_USER, True, False)])
def test_sharded_steps_on_jax_triples(feedback, D, regime, soft_margin,
                                      update_j):
    jf, _ = feedback
    jd, jm = jb.make_sampler_data_sharded(jf, D, 8)
    pop = jb.popularity_cdf(jf)
    t = tables(jm["u_loc"] * D)
    batch, nb = tb.sharded_epoch_batches(jm["num_events"], 64, D)
    key = jax.random.PRNGKey(5)
    kw = dict(update_j=update_j, soft_margin=soft_margin)
    want = jax_sharded(D, jd, jm, t, key, pop, batch_size=batch,
                       num_batches=nb, regime=regime, **kw)
    triples = [jax_device_triples(jd, jm, key, d, batch, nb, regime, pop)
               for d in range(D)]
    got = port_steps(D, t, triples, **kw)
    for k in t:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
        assert not np.array_equal(got[k], t[k])


def test_a_step_is_not_one_step_over_the_concatenation():
    """Device 0's j equals device 1's i: device 1's j bias read its own
    bias after its i updates, and device 0 read the start bias, which one
    ``bpr_step`` over the concatenated triples would not do."""
    D = 2
    t = tables(4)
    one = lambda *v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    trip = [(one(0), one(1), one(2), torch.ones(1)),
            (one(1), one(2), one(2), torch.ones(1))]
    got = port_steps(D, t, [[trip[0]], [trip[1]]], update_j=True)
    ref = {k: torch.from_numpy(v.copy()) for k, v in t.items()}
    u = torch.cat([trip[0][0], trip[1][0] + 2])
    tb.bpr_step(ref, u, one(1, 2), one(2, 2), torch.ones(2), HP,
                update_j=True)
    assert np.abs(got["item_bias"] - ref["item_bias"].numpy()).max() > 1e-6
    # item 2's bias by hand: device 0 (j = 2, start bias), device 1 (i = 2,
    # then j = 2 from its own updated bias)
    b0 = torch.from_numpy(t["item_bias"].copy())
    lr, br = HP["learn_rate"], HP["bias_reg"]

    def g_of(W_row, hi, hj, bi, bj):
        return torch.sigmoid(-(bi - bj + (W_row * (hi - hj)).sum()))
    H0 = torch.from_numpy(t["item_factors"])
    W0 = torch.from_numpy(t["user_factors"])
    g0 = g_of(W0[0], H0[1], H0[2], b0[1], b0[2])
    g1 = g_of(W0[3], H0[2], H0[2], b0[2], b0[2])
    di1 = lr * (g1 - br * b0[2])
    dj1 = lr * (-g1 - br * (b0[2] + di1))
    dj0 = lr * (-g0 - br * b0[2])
    np.testing.assert_allclose(got["item_bias"][2],
                               float(b0[2] + di1 + dj1 + dj0), atol=1e-7)


@pytest.mark.parametrize("regime", REGIMES)
def test_own_draws_stay_on_each_device(feedback, regime):
    """With its own generators each device draws only its users' events
    (local ids below u_loc and real pairs), and the epoch moves every
    table."""
    _, tf = feedback
    D = 4
    mesh = make_mesh(devices=["cpu"] * D)
    data, meta = tb.make_sampler_data_sharded(tf, D, 8)
    samplers = tb.device_samplers(mesh, data, meta)
    pairs = set(zip(tf.users.tolist(), tf.items.tolist()))
    gens = [torch.Generator().manual_seed(d) for d in range(D)]
    pop = [tb.popularity_cdf(tf.count_by_item)] * D
    perm = [torch.randperm(4 * 64, generator=g) for g in gens]
    for d in range(D):
        for b in range(4):
            u, i, j, w = tb.sample_triples_sharded(
                gens[d], samplers[d], meta, 64, regime, perm=perm[d],
                batch_index=b, pop_cdf=pop[d] if regime == tb.WBPR else None)
            real = w > 0
            assert int(real.sum()) > 0
            g = u[real] + d * meta["u_loc"]
            assert all((a, c) in pairs for a, c in zip(g.tolist(),
                                                       i[real].tolist()))
            assert not any((a, c) in pairs for a, c in zip(
                g.tolist(), j[real].tolist()))
    t = tables(meta["u_loc"] * D)
    params = {k: torch.from_numpy(v.copy()) for k, v in t.items()}
    params["user_factors"] = mesh.shard_rows(params["user_factors"])
    tb.bpr_epoch_sharded(mesh, params, samplers, meta, gens, HP,
                         pop if regime == tb.WBPR else None, batch_size=64,
                         num_batches=4, regime=regime, update_j=True)
    assert not np.array_equal(params["item_factors"].numpy(),
                              t["item_factors"])


@pytest.fixture
def shared_sharded_runs(monkeypatch):
    """The port's next init_model starts from the JAX model's tables; its
    sharded epoch replays the JAX sharded epoch's per-device triples
    (recorded keys)."""
    tables_, runs = [], []
    jax_init, port_init = jbpr.BPRMF.init_model, tbpr.BPRMF.init_model
    jax_epoch = jb.bpr_epoch_sharded

    def record(self):
        jax_init(self)
        tables_.append(bpr_tables_from_jax(self))

    def replay(self, t=None):
        port_init(self, tables_.pop(0) if t is None else t)

    def epoch(mesh, params, data, key, hp, pop, **kw):
        runs.append(({k: np.asarray(v) for k, v in data.items()},
                     dict(kw["meta_static"]), key, pop, kw["batch_size"],
                     kw["num_batches"], kw["regime"]))
        return jax_epoch(mesh, params, data, key, hp, pop, **kw)

    def port_epoch(mesh, params, samplers, meta, generators, hp,
                   pop_cdf=None, *, batch_size, num_batches, regime,
                   update_j, soft_margin=False):
        jd, jm, key, jpop, batch, nb, jregime = runs.pop(0)
        assert (batch, nb, jregime) == (batch_size, num_batches, regime)
        triples = [jax_device_triples(jd, jm, key, d, batch, nb, regime,
                                      jpop) for d in range(mesh.size)]
        H = mesh.replicate(params["item_factors"])
        b = mesh.replicate(params["item_bias"])
        for step in zip(*triples):
            H, b = tb.bpr_step_sharded(mesh, params["user_factors"], H, b,
                                       list(step), hp, update_j=update_j,
                                       soft_margin=soft_margin)

    monkeypatch.setattr(jbpr.BPRMF, "init_model", record)
    monkeypatch.setattr(tbpr.BPRMF, "init_model", replay)
    monkeypatch.setattr(jb, "bpr_epoch_sharded", epoch)
    monkeypatch.setattr(tb, "bpr_epoch_sharded", port_epoch)


@pytest.mark.parametrize("opts", ["", "uniform_user_sampling=false"])
def test_multicore_past_the_bound_matches_jax(feedback, shared_sharded_runs,
                                              monkeypatch, opts):
    """MultiCoreBPRMF past the sharded-tiled bound on a mesh of 8 (the JAX
    model shards over the test suite's 8 host devices)."""
    monkeypatch.setattr(tplan, "RESIDENT_ITEM_TABLE_BYTES", 64)
    assert tplan.select_schedule(I, F, 8) == "minibatch"
    jf, tf = feedback
    o = f"num_factors={F} num_iter=2 batch_size=128 {opts}"
    jm = jbpr.MultiCoreBPRMF()
    jax_configure(jm, o)
    tm = create_item_recommender("MultiCoreBPRMF", o + " device=cpu")
    tm.mesh = make_mesh(devices=["cpu"] * 8)
    jm.feedback, tm.feedback = jf, tf
    jm.train()
    tm.train()
    assert jm._mesh is not None and tm._sharded is not None
    for k in ("user_factors", "item_factors", "item_bias"):
        np.testing.assert_allclose(tm.params[k].numpy(),
                                   np.asarray(jm.params[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_multicore_trains_on_the_mesh_and_bprmf_does_not(feedback,
                                                         monkeypatch,
                                                         caplog):
    monkeypatch.setattr(tplan, "RESIDENT_ITEM_TABLE_BYTES", 64)
    _, tf = feedback
    mesh = make_mesh(devices=["cpu"] * 4)
    o = f"num_factors={F} num_iter=3 learn_rate=0.1 batch_size=64 device=cpu"
    with caplog.at_level(logging.WARNING, logger="mymedialite_tpu_torch"):
        mc = create_item_recommender("MultiCoreBPRMF", o)
        mc.mesh = mesh
        mc.feedback = tf
        mc.train()
        assert mc._sharded is not None
        assert not any("no sharded form" in r.message
                       for r in caplog.records)
        before = mc.compute_objective()
        for _ in range(5):
            mc.iterate()
        assert mc.compute_objective() < before
        b = create_item_recommender("BPRMF", o)
        b.mesh = mesh
        b.feedback = tf
        b.train()
    assert b._sharded is None and b._sampler is not None
    assert any("no sharded form" in r.message and "BPRMF" in r.message
               for r in caplog.records)
