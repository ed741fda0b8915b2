"""The incremental rating API of the port (``models/base.py``
``IncrementalRatingPredictor``, the retrains of ``models/{mf, baselines,
svdpp, knn}.py``) against the JAX package on the same inputs, on the CPU.

- The MF row learner (``mf.learn_row``) equals the JAX ``_learn_row`` from
  the same start row, for every loss x biased x user/item side, to 1e-5.
- UserItemBaseline's and the averages' retrains equal the JAX ones to
  1e-6, including the two pinned faults (ROADMAP §C): ``retrain_item``
  subtracts the user biases, and an id twice in one batch is refreshed
  twice.
- An MF/BiasedMF ``add_ratings`` at ``init_stdev=0`` (the fresh row is
  then ``init_mean`` in both packages) gives the JAX tables to 1e-5,
  grows the tables for new ids as the JAX package does, and leaves one
  live copy of the tables; the next iterate() plans on the grown ratings.
- The KNN ``_retrain`` is a full ``train()``: predictions equal a model
  trained on the grown ratings exactly.
- SVD++'s ``_retrain`` from the same tables equals the JAX one (its
  Pallas epoch in interpret mode with float32 operands) to 1e-5.
- Which models have ``add_ratings`` follows the JAX hierarchy.
"""

import numpy as np
import pytest
import torch

from mymedialite_tpu.data.synthetic import split_ratings, synthetic_ratings
from mymedialite_tpu.models import mf as jmf
from mymedialite_tpu.models import svdpp as jsv
from mymedialite_tpu.models.registry import (
    create_rating_predictor as jax_create,
)
from mymedialite_tpu.ops import sgd as jsgd
from mymedialite_tpu.utils.params import configure as jax_configure
from mymedialite_tpu_torch.convert import (
    baseline_state_from_jax, svdpp_tables_from_jax, tables_from_jax,
)
from mymedialite_tpu_torch.data.arrays import PosOnlyData, RatingData
from mymedialite_tpu_torch.models import mf as tmf
from mymedialite_tpu_torch.models.registry import (
    RATING_PREDICTOR_CLASSES, create_rating_predictor,
)
from mymedialite_tpu_torch.ops import sgd as tsgd
from test_torch_svdpp import jax_f32_interpret
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def data():
    """200 x 300 x 6000 synthetic ratings, split 80/20."""
    return split_ratings(synthetic_ratings(num_users=200, num_items=300,
                                           num_ratings=6000, seed=21),
                         seed=22)


def port_data(d):
    return RatingData(d.users, d.items, d.values, num_users=d.num_users,
                      num_items=d.num_items, scale=d.scale)


# --- the MF row learner ---------------------------------------------------

LOSSES = [("rmse", jsgd.LOSS_RMSE), ("mae", jsgd.LOSS_MAE),
          ("logistic", jsgd.LOSS_LOGISTIC)]
ROW_CASES = ([(f"biased-{n}", True, loss) for n, loss in LOSSES]
             + [("plain", False, jsgd.LOSS_RMSE)])


@pytest.mark.parametrize("side", ["user", "item"])
@pytest.mark.parametrize("case", ROW_CASES, ids=[c[0] for c in ROW_CASES])
def test_learn_row_matches_jax(case, side):
    _, biased, loss = case
    rng = np.random.default_rng(5)
    f, L = 6, 37
    fe = f + 2
    frozen, bias = (fe - 1, fe - 2) if side == "user" else (fe - 2, fe - 1)
    row = (0.1 * rng.standard_normal(fe)).astype(np.float32)
    row[frozen] = 1.0
    other = (0.3 * rng.standard_normal((L, fe))).astype(np.float32)
    other[:, bias] = 1.0
    values = rng.uniform(1, 5, L).astype(np.float32)
    hp = dict(learn_rate=0.02, reg=0.05, bias_lr=0.7, bias_reg=0.3,
              global_bias=0.3, min_rating=1.0, rating_range=4.0)
    kw = dict(num_iter=12, decay=0.95, biased=biased, loss=loss)
    idx, v, w = jmf._pad_history(np.arange(L), values)
    ref = np.asarray(jmf._learn_row(
        row, other[idx], v, w, np.float32(hp["learn_rate"]),
        np.float32(hp["reg"]), np.float32(hp["bias_lr"]),
        np.float32(hp["bias_reg"]), np.float32(hp["global_bias"]),
        np.float32(hp["min_rating"]), np.float32(hp["rating_range"]),
        frozen_col=frozen, bias_col=bias, **kw))
    lr_vec, reg_vec = tmf.row_rates(
        fe, hp["learn_rate"], hp["reg"], hp["bias_lr"], hp["bias_reg"],
        biased=biased, frozen_col=frozen, bias_col=bias)
    got = tmf.learn_row(torch.from_numpy(row), torch.from_numpy(other),
                        torch.from_numpy(values), lr_vec, reg_vec,
                        hp["global_bias"], hp["min_rating"],
                        hp["rating_range"], **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    assert got[frozen] == 1.0
    if not biased:
        assert got[bias] == row[bias]


def test_learn_row_empty_history_keeps_the_row():
    row = torch.tensor([0.1, -0.2, 0.0, 1.0])
    lr_vec, reg_vec = tmf.row_rates(4, 0.01, 0.1, 1.0, 0.1, biased=True,
                                    frozen_col=3, bias_col=2)
    got = tmf.learn_row(row, torch.zeros((0, 4)), torch.zeros(0), lr_vec,
                        reg_vec, 0.0, 1.0, 4.0, num_iter=5, decay=1.0,
                        biased=True, loss=tsgd.LOSS_RMSE)
    assert torch.equal(got, row)


# --- baselines ------------------------------------------------------------

def baseline_pair(name, train, opts=""):
    j = jax_create(name)
    t = create_rating_predictor(name, (opts + " device=cpu").strip())
    if opts:
        jax_configure(j, opts)
    j.ratings = train
    t.ratings = port_data(train)
    j.train()
    t.train()
    return j, t


def _state(model):
    s = baseline_state_from_jax(model) if hasattr(model, "user_biases") \
        else None
    if s is not None:
        for k in ("user_biases", "item_biases"):
            s[k] = np.asarray(getattr(model, k).cpu() if isinstance(
                getattr(model, k), torch.Tensor) else getattr(model, k))
    return s


EVENTS = [  # (users, items, values): single events, new ids, a duplicate
    ([3], [5], [4.0]), ([200], [7], [2.0]), ([4], [300], [5.0]),
    ([201], [301], [3.0]), ([9, 9], [11, 12], [1.0, 5.0]),
]


@pytest.mark.parametrize("name", ["GlobalAverage", "UserAverage",
                                  "ItemAverage", "UserItemBaseline"])
def test_baseline_retrains_match_jax(name, data):
    train, test = data
    opts = "reg_u=5 reg_i=2 num_iter=4" if name == "UserItemBaseline" else ""
    j, t = baseline_pair(name, train, opts)
    users = np.array([0, 3, 200, 201, 9, -1, 250])
    items = np.array([1, 5, 7, 301, 12, 3, 400])
    for us, its, vs in EVENTS:
        j.add_ratings(us, its, vs)
        t.add_ratings(us, its, vs)
        np.testing.assert_allclose(t.predict_batch(users, items),
                                   j.predict_batch(users, items),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.predict_batch(test.users, test.items),
                               j.predict_batch(test.users, test.items),
                               rtol=0, atol=1e-6)
    if name == "UserItemBaseline":
        js, ts = _state(j), _state(t)
        for k in ("user_biases", "item_biases"):
            assert ts[k].shape == js[k].shape
            np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=1e-6)


def test_user_item_baseline_pinned_faults(data):
    """Copied on purpose from the JAX package (ROADMAP §C): retrain_item
    subtracts the user biases; a user twice in one batch is refreshed
    twice, the second refresh folding in the first."""
    train, _ = data
    _, t = baseline_pair("UserItemBaseline", train)
    mu = np.float32(t.global_average)
    bu = t.user_biases.clone()
    users, vals = t._rated_by_item(7)
    b_i = float(t.item_biases[7])
    expect = (b_i + float(np.sum((vals - mu - bu[users].numpy())
                                 .astype(np.float64)))) / (t.reg_i + users.size)
    t.retrain_item(7)
    assert float(t.item_biases[7]) == pytest.approx(expect, abs=1e-6)
    once = t.user_biases[9].item()
    t._retrain([9], [])
    after_one = t.user_biases[9].item()
    t.user_biases[9] = once
    t._retrain([9, 9], [])
    assert t.user_biases[9].item() != pytest.approx(after_one, abs=1e-9)


def test_update_and_remove_ratings_match_jax(data):
    train, _ = data
    j, t = baseline_pair("UserItemBaseline", train)
    u, i = int(train.users[10]), int(train.items[10])
    for m in (j, t):
        m.update_ratings([u], [i], [1.0])
        m.remove_ratings([int(train.users[11])], [int(train.items[11])])
        m.remove_user(int(train.users[12]))
        m.remove_item(int(train.items[13]))
    assert len(t.ratings) == len(j.ratings)
    js, ts = _state(j), _state(t)
    for k in ("user_biases", "item_biases"):
        np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=1e-6)


# --- MF -------------------------------------------------------------------

MF_CASES = [("MatrixFactorization", "num_factors=6 num_iter=4"),
            ("BiasedMatrixFactorization", "num_factors=6 num_iter=4"),
            ("BiasedMatrixFactorization", "num_factors=6 num_iter=4 "
                                          "loss=MAE learn_rate_decay=0.9")]


@pytest.fixture(params=range(len(MF_CASES)),
                ids=["plain", "biased", "biased-mae-decay"])
def mf_pair(request, data):
    """A JAX MF model trained 3 epochs (its XLA epoch), the port's started
    from its tables; both then at init_stdev=0."""
    train, _ = data
    name, opts = MF_CASES[request.param]
    jm = getattr(jmf, name)()
    jax_configure(jm, opts + " num_iter=3")
    jm.ratings = train
    jm.train()
    tm = create_rating_predictor(name, opts + " device=cpu")
    tm.ratings = port_data(train)
    tm.init_model(tables=tables_from_jax(jm))
    for m in (jm, tm):
        m.init_stdev = 0.0
        m.init_mean = 0.0
        m.num_iter = 4
    return jm, tm


def assert_tables_close(jm, tm, atol):
    """The tables agree on the real user rows and every item row. The
    user table's padding past them depends on the route (the JAX model
    here trains on its XLA epoch, whose groups size the padding; the
    port's on the kernel route pads whole default groups, as the JAX
    package's kernel route does): it must be [0 ... 0 | 0 | 1] rows."""
    U = jm.num_users_trained
    assert tm.num_users_trained == U
    W = tm.W_ext.numpy()
    np.testing.assert_allclose(W[:U], np.asarray(jm.W_ext)[:U], rtol=0,
                               atol=atol)
    pad = np.zeros(W.shape[1], np.float32)
    pad[-1] = 1.0
    assert (W[U:] == pad).all()
    assert tuple(tm.H_ext.shape) == tuple(jm.H_ext.shape)
    np.testing.assert_allclose(tm.H_ext.numpy(), np.asarray(jm.H_ext),
                               rtol=0, atol=atol)


def test_mf_add_ratings_matches_jax(mf_pair, data):
    jm, tm = mf_pair
    _, test = data
    for k in range(0, 40, 4):
        us, its, vs = (test.users[k:k + 4], test.items[k:k + 4],
                       test.values[k:k + 4])
        jm.add_ratings(us, its, vs)
        tm.add_ratings(us, its, vs)
    assert_tables_close(jm, tm, 1e-5)
    assert tm._plan is None and tm._mxu_tables is None


def test_mf_new_ids_grow_like_jax(mf_pair):
    """A new user and a new item in one event: the user's refresh reads
    the item's row before it exists, clamped to the last row, as the JAX
    gather does (ROADMAP §C); then the tables grow as the JAX ones."""
    jm, tm = mf_pair
    for m in (jm, tm):
        m.add_ratings([200, 3], [300, 301], [4.0, 2.0])
    assert_tables_close(jm, tm, 1e-5)
    for m in (jm, tm):
        m.remove_user(200)
        m.remove_item(301)
    assert_tables_close(jm, tm, 1e-5)
    assert tm.num_users_trained == jm.num_users_trained
    assert tm.num_items_trained == jm.num_items_trained


def test_mf_retrain_after_epochs_keeps_one_copy(data):
    """A retrain between epochs folds the kernel-layout tables back into
    the std tables and drops the plan; the next iterate() plans on the
    grown ratings and trains from the retrained tables."""
    train, test = data
    tm = create_rating_predictor("BiasedMatrixFactorization",
                                 "num_factors=6 num_iter=2 device=cpu")
    tm.ratings = port_data(train)
    tm.train()
    assert tm._mxu_tables is not None
    tm.add_ratings(test.users[:5], test.items[:5], test.values[:5])
    assert tm._mxu_tables is None and tm._plan is None
    W = tm.W_ext.clone()
    tm.iterate()
    assert tm._plan.n_ratings == len(train) + 5
    assert tm._mxu_tables is not None
    assert not torch.equal(tm.W_ext, W)


def test_mf_generator_draws_fresh_rows(data):
    """At init_stdev > 0 a refresh starts from a draw of the model's own
    generator: two refreshes of one row differ, a reseeded model repeats."""
    train, _ = data

    def model():
        m = create_rating_predictor("MatrixFactorization",
                                    "num_factors=4 num_iter=1 device=cpu")
        m.ratings = port_data(train)
        m.train()
        return m
    a, b = model(), model()
    a.retrain_user(3)
    r1 = a.W_ext[3].clone()
    a.retrain_user(3)
    b.retrain_user(3)
    assert not torch.equal(a.W_ext[3], r1)
    assert torch.equal(b.W_ext[3], r1)


# --- KNN ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["UserKNN", "ItemKNN"])
def test_knn_retrain_is_a_full_train(name, data):
    train, test = data
    t = create_rating_predictor(name, "k=20 device=cpu")
    t.ratings = port_data(train)
    t.train()
    t.add_ratings(test.users[:3], test.items[:3], test.values[:3])
    fresh = create_rating_predictor(name, "k=20 device=cpu")
    fresh.ratings = t.ratings
    fresh.train()
    np.testing.assert_array_equal(t.predict_batch(test.users, test.items),
                                  fresh.predict_batch(test.users, test.items))


# --- SVD++ ----------------------------------------------------------------

def test_svdpp_retrain_matches_jax(data):
    """One add_ratings: both packages re-plan on the grown ratings and run
    one kernel-route epoch from the same tables."""
    train, test = data
    opts = "num_factors=6 num_iter=2 learn_rate=0.01"
    with pytest.MonkeyPatch.context() as mp:
        jax_f32_interpret(mp)
        jm = jsv.SVDPlusPlus()
        jax_configure(jm, opts)
        jm.ratings = train
        jm.init_model()
        tm = create_rating_predictor("SVDPlusPlus", opts + " device=cpu")
        tm.ratings = port_data(train)
        tm.init_model(tables=svdpp_tables_from_jax(jm))
        assert tm.route() == "kernel"
        ev = (test.users[:6], test.items[:6], test.values[:6])
        jm.add_ratings(*ev)
        tm.add_ratings(*ev)
        U = tm.num_users_trained
        ref = svdpp_tables_from_jax(jm)
        got = {k: v.numpy() for k, v in tm.params.items()}
        for k in ("user_bias", "item_bias", "item_factors", "y", "p"):
            np.testing.assert_allclose(got[k][:U], ref[k][:U], rtol=0,
                                       atol=1e-5, err_msg=k)
        assert tm._plan.n_ratings == len(train) + 6


def test_hasattr_add_ratings_follows_the_jax_hierarchy():
    """Every ported rating model has add_ratings exactly where the JAX
    model of the same name has it (the online evaluator's gate)."""
    for name in RATING_PREDICTOR_CLASSES:
        t = create_rating_predictor(name, "device=cpu")
        j = jax_create(name)
        for attr in ("add_ratings", "begin_online_updates",
                     "score_items_foldin"):
            assert hasattr(t, attr) == hasattr(j, attr), (name, attr)
        for flag in ("SUPPORTS_ONLINE_BUFFER", "ONLINE_PREDICT_ROW_LOCAL"):
            assert getattr(t, flag, False) == getattr(j, flag, False), \
                (name, flag)


# --- the CSR views of derived datasets ------------------------------------

@pytest.mark.parametrize("kind", ["ratings", "feedback"])
def test_derived_csr_views_equal_a_fresh_build(kind):
    """A dataset made by add (an append) or by a remove method (a filter)
    from one with built views derives its views; they equal build_csr's,
    duplicates and new ids included. A plain select builds its own."""
    from mymedialite_tpu_torch.data import arrays
    rng = np.random.default_rng(8)
    u, i = rng.integers(0, 40, 500), rng.integers(0, 30, 500)
    data = (RatingData(u, i, rng.uniform(1, 5, 500)) if kind == "ratings"
            else PosOnlyData(u, i))
    for step in range(16):
        data.by_user, data.by_item   # noqa: B018 (build the views)
        if step % 4 == 1:
            if kind == "ratings":
                data = data.remove_indices(
                    np.nonzero(rng.random(len(data)) < 0.1)[0])
            else:
                pick = rng.integers(0, len(data), 20)
                data = data.remove(data.users[pick], data.items[pick])
        elif step % 4 == 3:
            data = (data.remove_user(int(data.users[0])) if step % 8 == 3
                    else data.remove_item(int(data.items[0])))
        else:
            n = int(rng.integers(1, 6))
            new_u, new_i = rng.integers(0, 45, n), rng.integers(0, 33, n)
            data = (data.add(new_u, new_i, rng.uniform(1, 5, n))
                    if kind == "ratings" else data.add(new_u, new_i))
        assert data._csr_source is not None
        for name, args in (("by_user", (data.users, data.items,
                                        data.num_users)),
                           ("by_item", (data.items, data.users,
                                        data.num_items))):
            got, ref = getattr(data, name), arrays.build_csr(*args)
            for field in ("indptr", "order", "keys"):
                a, b = getattr(got, field), getattr(ref, field)
                assert a.dtype == b.dtype, (name, field)
                np.testing.assert_array_equal(a, b, err_msg=(name, field))
        assert data._csr_source is None
    assert data.select(np.array([1, 2, 3]))._csr_source is None
    assert data.select(np.array([3, 1, 2]))._csr_source is None


def test_long_histories_diverge_in_both_packages():
    """Pinned JAX-package fault, copied (ROADMAP §C): a refresh sums the
    gradient over the whole history before each step, so once
    n * learn_rate * reg is far past 2 the regularization alone grows the
    row every step and 30 steps overflow float32, in both packages."""
    rng = np.random.default_rng(6)
    L, fe = 20_000, 8
    other = (0.1 * rng.standard_normal((L, fe))).astype(np.float32)
    other[:, -1] = 1.0
    values = rng.uniform(1, 5, L).astype(np.float32)
    row = np.zeros(fe, np.float32)
    row[:6] = 0.1
    row[-2] = 1.0
    kw = dict(num_iter=30, decay=1.0, biased=True, loss=jsgd.LOSS_RMSE)
    lr, reg = 0.01, 0.15                       # n * lr * reg = 30
    idx, v, w = jmf._pad_history(np.arange(L), values)
    ref = np.asarray(jmf._learn_row(
        row, other[idx], v, w, np.float32(lr), np.float32(reg),
        np.float32(1.0), np.float32(0.01), np.float32(0.0), np.float32(1.0),
        np.float32(4.0), frozen_col=fe - 2, bias_col=fe - 1, **kw))
    lr_vec, reg_vec = tmf.row_rates(fe, lr, reg, 1.0, 0.01, biased=True,
                                    frozen_col=fe - 2, bias_col=fe - 1)
    got = tmf.learn_row(torch.from_numpy(row), torch.from_numpy(other),
                        torch.from_numpy(values), lr_vec, reg_vec, 0.0, 1.0,
                        4.0, **kw)
    assert not np.isfinite(ref).all()
    assert not torch.isfinite(got).all()


@pytest.mark.parametrize("name", ["SigmoidSVDPlusPlus",
                                  "SigmoidItemAsymmetricFactorModel",
                                  "SigmoidUserAsymmetricFactorModel",
                                  "SigmoidCombinedAsymmetricFactorModel",
                                  "GSVDPlusPlus"])
def test_svdpp_family_add_ratings(name, data):
    """add_ratings on every SVD++-family model, as in the JAX package: a
    re-plan and one epoch (the user AFM on its inner model with users and
    items swapped, GSVD++ on the grouped epoch), the combined model's a
    no-op on its own tables; new ids grow the tables."""
    train, test = data
    t = create_rating_predictor(name, "num_factors=4 num_iter=1 device=cpu")
    t.ratings = port_data(train)
    if name == "GSVDPlusPlus":
        items = np.arange(302)
        t.item_attributes = PosOnlyData(items, items % 5)
    t.train()
    users = np.array([0, 5, 200])
    items = np.array([1, 7, 300])
    before = t.predict_batch(users, items)
    t.add_ratings([200, 5], [300, 7], [5.0, 1.0])
    after = t.predict_batch(users, items)
    assert np.isfinite(after).all()
    assert len(t.ratings) == len(train) + 2
    if name != "SigmoidCombinedAsymmetricFactorModel":
        assert not np.array_equal(before, after)
