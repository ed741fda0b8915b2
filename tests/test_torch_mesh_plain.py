"""The plain-PyTorch mesh routes of the port beside the DSGD kernels,
against the JAX package on its virtual CPU mesh, with ``["cpu"] * D``
meshes (D = 2, 4, 8):

- the sharded blocked MF epoch (``ops/sgd.py sgd_epoch_blocked_sharded``)
  fed the JAX package's batch orders (drawn from ``fold_in(key, g)``
  with the local g) lands within 1e-5 of JAX's sharded epoch; with
  frequency regularization it reads a user's rate at the global row,
  where JAX reads the slab-relative row (a fault of the JAX package,
  pinned: fed JAX's slab-relative vector it equals JAX);
- WRMF's sharded solves (``ops/als.py wrmf_optimize_sharded``) equal one
  device's to 1e-6, as JAX's test requires, and WRMF with a mesh matches
  the JAX model (which solves on the suite's 8 host devices);
- the data-parallel ranking eval gives one device's numbers, exactly
  for a batch the devices divide, and the JAX package's to 1e-6;
- a cross-validation fold, a fold-in clone and the clones of
  ``clone_recommender`` train on the mesh of the model they copy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mymedialite_tpu.eval.ranking import evaluate_items as jax_evaluate
from mymedialite_tpu.models import registry as jreg
from mymedialite_tpu.models.wrmf import WRMF as JaxWRMF
from mymedialite_tpu.ops import als as jals
from mymedialite_tpu.ops import sgd as jsgd
from mymedialite_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mymedialite_tpu.parallel.mesh import replicated, row_sharded_2d
from mymedialite_tpu_torch.convert import (
    bpr_tables_from_jax, wrmf_tables_from_jax,
)
from mymedialite_tpu_torch.data.arrays import RatingData
from mymedialite_tpu_torch.data.synthetic import (
    posonly_from_ratings, synthetic_ratings,
)
from mymedialite_tpu_torch.eval.crossval import (
    clone_recommender, crossvalidate_ratings,
)
from mymedialite_tpu_torch.eval.foldin import (
    evaluate_fold_in_complete_retraining,
)
from mymedialite_tpu_torch.eval.ranking import evaluate_items
from mymedialite_tpu_torch.models import svdpp as tsv
from mymedialite_tpu_torch.models.registry import (
    create_item_recommender, create_rating_predictor,
)
from mymedialite_tpu_torch.ops import als as tals
from mymedialite_tpu_torch.ops import sgd as tsgd
from mymedialite_tpu_torch.parallel.mesh import DEFAULT_MESH, make_mesh
from torch_threads import one_torch_thread  # noqa: F401

G, F, B = 16, 5, 64


def cpu_mesh(D):
    return make_mesh(devices=["cpu"] * D)


def blocked_data(D, seed=0):
    """Ratings over 2 groups a device (U = 2 x D x G users)."""
    rng = np.random.default_rng(seed)
    U, I, N = 2 * D * G, 40, 150 * D
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    v = rng.integers(1, 6, N).astype(np.float32)
    W = (0.1 * rng.standard_normal((U, F))).astype(np.float32)
    H = (0.1 * rng.standard_normal((I, F))).astype(np.float32)
    return U, I, u, i, v, W, H


def local_orders(key, meta, D):
    """The batch orders of the JAX sharded epoch: device d's g-th group
    uses ``permutation(fold_in(key, g), nb)``, g local."""
    nb = meta["l_pad"] // meta["batch"]
    return np.stack([np.asarray(jax.random.permutation(
        jax.random.fold_in(key, g), nb))
        for g in range(meta["ngroups"] // D)])


def jax_blocked_sharded(D, We, He, jd, key, rates, freq, meta, **kw):
    mesh = jax_make_mesh(D)
    sh2 = row_sharded_2d(mesh)
    data = {k: jax.device_put(np.asarray(v), sh2) for k, v in jd.items()}
    hp = dict(global_bias=jnp.float32(0.3), min_rating=jnp.float32(1.0),
              rating_range=jnp.float32(4.0))
    W2, H2 = jsgd.sgd_epoch_blocked_sharded(
        mesh, jax.device_put(np.asarray(We), sh2),
        jax.device_put(np.asarray(He), replicated(mesh)), data, key, hp,
        rates, freq, meta=tuple(sorted(meta.items())), **kw)
    return np.asarray(W2), np.asarray(H2)


def port_blocked_sharded(D, We, He, td, orders, rates, freq, meta, **kw):
    W = torch.from_numpy(np.array(We))
    H = torch.from_numpy(np.array(He))
    tsgd.sgd_epoch_blocked_sharded(cpu_mesh(D), W, H, td,
                                   torch.from_numpy(orders), (0.3, 1.0, 4.0),
                                   rates, freq, meta=meta, **kw)
    return W.numpy(), H.numpy()


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("biased,loss", [(True, 0), (True, 1), (False, 0)])
def test_blocked_sharded_matches_jax(D, biased, loss):
    U, I, u, i, v, W, H = blocked_data(D)
    jd, meta = jsgd.prepare_blocked_data(u, i, v, U, batch_size=B,
                                         group_users=G, shuffle_seed=3)
    td, tmeta = tsgd.prepare_blocked_data(u, i, v, U, batch_size=B,
                                          group_users=G, shuffle_seed=3)
    assert tmeta == meta and meta["ngroups"] == 2 * D
    We, He = jsgd.extend_tables(W, H, group_users=G)
    args = (F, 0.05, 0.01, 0.02, 0.7, 0.1, biased, True, True)
    key = jax.random.PRNGKey(4)
    kw = dict(loss=loss, biased=biased)
    Wj, Hj = jax_blocked_sharded(D, We, He, jd, key, jsgd.column_rates(*args),
                                 (jnp.zeros(0), jnp.zeros(0)), meta,
                                 frequency_regularization=False, **kw)
    Wt, Ht = port_blocked_sharded(D, We, He, td, local_orders(key, meta, D),
                                  tsgd.column_rates(*args), None, meta, **kw)
    np.testing.assert_allclose(Wt, Wj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-5)
    assert not np.array_equal(Ht, np.asarray(He))


def test_blocked_sharded_frequency_regularization_pinned():
    """JAX's sharded epoch reads ``inv_cu[u]`` with u slab-relative
    (``ops/sgd.py:497``), its one-device epoch ``inv_cu[u + g * G]``
    (``:359``); the port reads the global row in both. Fed a vector that
    repeats rows [0, G) in every group, the port equals JAX; fed the
    real one, it differs, as it should."""
    D = 2
    U, I, u, i, v, W, H = blocked_data(D, seed=1)
    jd, meta = jsgd.prepare_blocked_data(u, i, v, U, batch_size=B,
                                         group_users=G, shuffle_seed=3)
    td, _ = tsgd.prepare_blocked_data(u, i, v, U, batch_size=B,
                                      group_users=G, shuffle_seed=3)
    We, He = jsgd.extend_tables(W, H, group_users=G)
    args = (F, 0.05, 0.01, 0.02, 0.7, 0.1, True, True, True)
    freq = tsgd.blocked_freq(np.bincount(u, minlength=U),
                             np.bincount(i, minlength=I), U)
    key = jax.random.PRNGKey(6)
    kw = dict(loss=0, biased=True)
    Wj, Hj = jax_blocked_sharded(
        D, We, He, jd, key, jsgd.column_rates(*args),
        (jnp.asarray(freq[0].numpy()), jnp.asarray(freq[1].numpy())), meta,
        frequency_regularization=True, **kw)
    orders = local_orders(key, meta, D)
    rates = tsgd.column_rates(*args)
    slab_relative = (freq[0][:G].repeat(meta["ngroups"]), freq[1])
    Wp, Hp = port_blocked_sharded(D, We, He, td, orders, rates,
                                  slab_relative, meta, **kw)
    np.testing.assert_allclose(Wp, Wj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(Hp, Hj, rtol=0, atol=1e-5)
    Wt, _ = port_blocked_sharded(D, We, He, td, orders, rates, freq, meta,
                                 **kw)
    assert np.abs(Wt - Wj).max() > 1e-4
    # group 0's user rows move only in the first step, from the start H:
    # the one-device epoch's group 0 (global rows) gives the same rows
    W1 = torch.from_numpy(np.array(We))
    H1 = torch.from_numpy(np.array(He))
    tsgd.sgd_epoch_blocked(W1, H1, td, torch.from_numpy(
        np.concatenate([orders] * D)), (0.3, 1.0, 4.0), rates, freq,
        meta=meta, groups=[0], **kw)
    np.testing.assert_allclose(Wt[:G], W1.numpy()[:G], rtol=0, atol=1e-6)


def test_blocked_sharded_needs_whole_groups_per_device():
    U, I, u, i, v, W, H = blocked_data(2)
    td, meta = tsgd.prepare_blocked_data(u, i, v, U, batch_size=B,
                                         group_users=G, shuffle_seed=3)
    We, He = tsgd.extend_tables(W, H, group_users=G)
    with pytest.raises(ValueError):
        tsgd.sgd_epoch_blocked_sharded(
            cpu_mesh(3), We, He, td, np.zeros((1, 1), np.int64),
            (0.3, 1.0, 4.0), tsgd.column_rates(F, 0.05, 0.01, 0.02, 0.7,
                                               0.1, True, True, True),
            meta=meta, loss=0, biased=True)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_wrmf_sharded_solves_equal_one_device(D):
    """JAX ``tests/test_models_item.py:501-530`` on the port: the rows'
    systems are independent, so the sharded solves are one device's."""
    rng = np.random.default_rng(0)
    I, f, U, L, chunk = 40, 6, 100, 12, 8
    H = rng.normal(size=(I, f)).astype(np.float32)
    hist = rng.integers(0, I, (U, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, U).astype(np.int32)
    hist8, lens8, _ = jals.pad_rows(hist, lens, chunk * D)
    args = (torch.from_numpy(H), torch.from_numpy(hist8.astype(np.int64)),
            torch.from_numpy(lens8.astype(np.int64)), 1.0, 0.015)
    single = tals.wrmf_optimize(*args, chunk=chunk)
    sharded = tals.wrmf_optimize_sharded(cpu_mesh(D), *args, chunk=chunk)
    np.testing.assert_allclose(sharded.numpy(), single.numpy(), atol=1e-6)
    want = jals.wrmf_optimize(jnp.asarray(H), jnp.asarray(hist8),
                              jnp.asarray(lens8), jnp.float32(1.0),
                              jnp.float32(0.015), chunk=chunk)
    np.testing.assert_allclose(sharded.numpy(), np.asarray(want), atol=1e-4)
    with pytest.raises(ValueError):
        tals.wrmf_optimize_sharded(cpu_mesh(D), args[0], args[1][:-1],
                                   args[2][:-1], 1.0, 0.015, chunk=chunk)


@pytest.fixture(scope="module")
def item_data():
    from mymedialite_tpu.data.synthetic import (
        split_posonly, synthetic_posonly,
    )
    fb = synthetic_posonly(num_users=300, num_items=400, num_events=6000,
                           seed=5)
    return split_posonly(fb, seed=6)


@pytest.mark.parametrize("D", [2, 8])
def test_wrmf_on_a_mesh_matches_jax(item_data, D):
    train, _ = item_data
    j = JaxWRMF()
    j.num_factors, j.num_iter = 8, 2
    j.feedback = train
    j.init_model()
    assert j._mesh is not None          # the suite's 8 host devices
    t = create_item_recommender("WRMF", "num_factors=8 num_iter=2 "
                                "solve_chunk=64 device=cpu")
    t.mesh = cpu_mesh(D)
    t.feedback = train
    t.init_model(tables=wrmf_tables_from_jax(j))
    for rows, hist, lens, chunk in t._user_hist + t._item_hist:
        assert isinstance(hist, list) and len(hist) == D
        assert sum(h.shape[0] for h in hist) % (chunk * D) == 0
        assert sum(h.shape[0] for h in hist) - rows.shape[0] < chunk * D
    for _ in range(2):
        j.iterate()
        t.iterate()
    for side in ("user_factors", "item_factors"):
        b = np.asarray(j.params[side], np.float64)
        err = np.abs(t.params[side].numpy() - b).max() / np.abs(b).max()
        assert err <= 1e-4, side
    one = create_item_recommender("WRMF", "num_factors=8 num_iter=2 "
                                  "solve_chunk=64 device=cpu")
    one.feedback = train
    one.init_model(tables=wrmf_tables_from_jax(j))
    one.params = {k: v.clone() for k, v in t.params.items()}
    H = t.params["item_factors"]
    np.testing.assert_allclose(
        t._optimize(H, t._user_hist, t.params["user_factors"].shape[0]),
        one._optimize(H, one._user_hist, t.params["user_factors"].shape[0]),
        atol=1e-6)


def test_wrmf_mesh_set_or_cleared_after_init(item_data):
    """A mesh set or cleared between ``init_model`` and ``iterate`` lays
    the histories out anew for it; each alternation equals one device's
    (1e-6)."""
    train, _ = item_data

    def wrmf():
        m = create_item_recommender("WRMF", "num_factors=8 solve_chunk=64 "
                                    "device=cpu")
        m.feedback = train
        m.init_model()
        return m
    t, one = wrmf(), wrmf()
    one.params = {k: v.clone() for k, v in t.params.items()}
    for mesh in (cpu_mesh(4), None, cpu_mesh(2)):
        t.mesh = mesh
        t.iterate()
        one.iterate()
        assert t._hist_mesh is mesh
        assert isinstance(t._user_hist[0][1], list) is (mesh is not None)
        for side in ("user_factors", "item_factors"):
            np.testing.assert_allclose(t.params[side], one.params[side],
                                       atol=1e-6, err_msg=side)


MEASURES = ("AUC", "MAP", "NDCG", "MRR", "prec@5", "recall@10")


@pytest.mark.parametrize("name", ["BPRMF", "WRMF"])
@pytest.mark.parametrize("D,batch", [(2, 512), (4, 64), (8, 48), (8, 100)])
def test_data_parallel_eval_equals_one_device(item_data, name, D, batch):
    train, test = item_data
    j = jreg.create_item_recommender(name)
    j.num_factors, j.num_iter = 8, 2
    j.feedback = train
    j.train()
    tabs = (bpr_tables_from_jax(j) if name == "BPRMF"
            else wrmf_tables_from_jax(j))
    t = create_item_recommender(name, "num_factors=8 device=cpu")
    t.feedback = train
    t.init_model(tables=tabs)
    one = evaluate_items(t, test, train, batch_size=batch)
    t.mesh = cpu_mesh(D)
    calls = []
    real = t.catalog_scorer
    t.catalog_scorer = lambda dev=None: calls.append(dev) or real(dev)
    many = evaluate_items(t, test, train, batch_size=batch)
    assert sum(dev is not None for dev in calls) == D
    for k in MEASURES + ("num_users", "num_items"):
        if batch % D == 0:
            assert many[k] == one[k], k
        else:
            assert abs(many[k] - one[k]) <= 1e-12, k
    want = jax_evaluate(j, test, train, batch_size=batch)
    for k in MEASURES:
        assert abs(many[k] - float(want[k])) <= 1e-6, k


def test_data_parallel_eval_of_a_rating_model():
    """The rating models' catalog scorers (the rating_based_ranking CLI):
    SVDPlusPlus and BiasedMatrixFactorization on a mesh rank as on one
    device."""
    r = synthetic_ratings(num_users=120, num_items=80, num_ratings=3000,
                          seed=4)
    fb = posonly_from_ratings(r)
    for name in ("SVDPlusPlus", "BiasedMatrixFactorization"):
        m = create_rating_predictor(name, "num_factors=4 num_iter=2 "
                                    "device=cpu")
        m.ratings = r
        m.train()
        one = evaluate_items(m, fb, fb, repeated_events=True, batch_size=50)
        m.mesh = cpu_mesh(4)
        many = evaluate_items(m, fb, fb, repeated_events=True, batch_size=50)
        for k in MEASURES:
            assert abs(many[k] - one[k]) <= 1e-12, (name, k)


def test_catalog_scorer_on_another_device_falls_back():
    """A model without a mesh route scores on its own device and hands the
    scores to the asking device (``catalog_scorer(device)`` through the
    base ``_on_device``)."""
    r = synthetic_ratings(num_users=30, num_items=20, num_ratings=300, seed=1)
    m = create_rating_predictor("UserItemBaseline", "device=cpu")
    m.ratings = r
    m.train()
    users = torch.arange(5)
    torch.testing.assert_close(m.catalog_scorer("cpu")(users),
                               m.catalog_scorer()(users))
    seen = []
    score = m.catalog_scorer()
    out = m._on_device(lambda u: seen.append(u.device) or score(u),
                       "meta")(users)
    assert seen == [torch.device("cpu")] and out.device.type == "meta"
    assert out.shape == (5, 20)
    assert m.catalog_scorer("meta")(users).device.type == "meta"


@pytest.fixture(scope="module")
def rating_data():
    return synthetic_ratings(num_users=96, num_items=60, num_ratings=2400,
                             seed=2)


def test_clone_keeps_the_mesh(rating_data):
    m = create_rating_predictor("SVDPlusPlus", "num_factors=4 device=cpu")
    m.mesh = cpu_mesh(2)
    c = clone_recommender(m)
    assert c.mesh is m.mesh
    w = create_item_recommender("WRMF", "device=cpu")
    assert clone_recommender(w).mesh is DEFAULT_MESH
    w.mesh = None
    assert clone_recommender(w).mesh is None


def test_cv_folds_train_on_the_mesh(rating_data, monkeypatch):
    calls = []
    real = tsv.svdpp_epoch_sharded

    def counted(mesh, *a, **kw):
        calls.append(mesh.size)
        return real(mesh, *a, **kw)
    monkeypatch.setattr(tsv, "svdpp_epoch_sharded", counted)
    m = create_rating_predictor("SVDPlusPlus", "num_factors=4 num_iter=1 "
                                "group_users=16 device=cpu")
    m.mesh = cpu_mesh(2)
    res = crossvalidate_ratings(m, rating_data, num_folds=3, parallel=False)
    assert np.isfinite(res["RMSE"])
    assert calls == [2] * 3


def test_foldin_clones_train_on_the_mesh(rating_data, monkeypatch):
    calls = []
    real = tsv.svdpp_epoch_sharded

    def counted(mesh, *a, **kw):
        calls.append(mesh.size)
        return real(mesh, *a, **kw)
    monkeypatch.setattr(tsv, "svdpp_epoch_sharded", counted)
    m = create_rating_predictor("SVDPlusPlus", "num_factors=4 num_iter=1 "
                                "group_users=16 device=cpu")
    m.mesh = cpu_mesh(4)
    m.ratings = rating_data
    users = rating_data.users[:40]
    update = RatingData(users, rating_data.items[:40],
                        rating_data.values[:40], num_users=96, num_items=60)
    evaluate = RatingData(users[:10], rating_data.items[40:50],
                          rating_data.values[40:50], num_users=96,
                          num_items=60)
    res = evaluate_fold_in_complete_retraining(m, update, evaluate)
    assert np.isfinite(res["RMSE"]) and calls and set(calls) == {4}
