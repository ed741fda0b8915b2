"""The KNN family of the port (``mymedialite_tpu_torch/models/knn.py``)
against the JAX package's on the same data, on the CPU, in both storage
modes (dense, and top-k with ``DENSE_NMAX`` shrunk in both packages as
``tests/test_knn.py`` does it).

Implicit models: catalog scores and point predictions agree to 1e-5.
Rating models: predictions agree to 1e-5 on every pair whose K-th
positive weight is not tied with the next (to 1e-6); at such a tie the
JAX package
takes an arbitrary K of the tied co-raters (``np.argpartition``) and the
port the smaller ids (ROADMAP §C). Model files pass between the packages
both ways with the same predictions; ``convert.knn_state_from_jax``
starts the port from the JAX correlation.
"""

import numpy as np
import pytest

from mymedialite_tpu.data.arrays import PosOnlyData, RatingData
from mymedialite_tpu.models import knn as JK
from mymedialite_tpu.ops import correlation as J
from mymedialite_tpu_torch.convert import (
    baseline_state_from_jax, knn_state_from_jax,
)
from mymedialite_tpu_torch.models import knn as TK
from mymedialite_tpu_torch.models.registry import (
    create_item_recommender, create_rating_predictor,
)
from mymedialite_tpu_torch.ops import correlation as T
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
IMPLICIT = ["UserKNN", "ItemKNN", "UserAttributeKNN", "ItemAttributeKNN"]
RATING = ["UserKNNRating", "ItemKNNRating", "UserAttributeKNNRating",
          "ItemAttributeKNNRating"]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    u, i = rng.integers(0, 60, 900), rng.integers(0, 45, 900)
    vals = rng.choice([1.0, 1.5, 2, 2.5, 3, 3.5, 4, 4.5, 5], 900)
    attrs = {"user": PosOnlyData(rng.integers(0, 60, 150),
                                 rng.integers(0, 9, 150), 60, 9),
             "item": PosOnlyData(rng.integers(0, 45, 120),
                                 rng.integers(0, 7, 120), 45, 7)}
    return PosOnlyData(u, i, 60, 45), RatingData(u, i, vals, 60, 45), attrs


@pytest.fixture(params=["dense", "topk"])
def mode(request, monkeypatch):
    if request.param == "topk":
        monkeypatch.setattr(J, "DENSE_NMAX", 8)
        monkeypatch.setattr(T, "DENSE_NMAX", 8)
    return request.param


def attach(model, attrs):
    if getattr(model, "ATTRIBUTES", False):
        model.attributes = attrs[model.ENTITY]


def implicit_pair(name, data, opts=None):
    fb, _, attrs = data
    j = getattr(JK, name)()
    t = getattr(TK, name)()
    t.device = "cpu"
    for m in (j, t):
        for k, v in (opts or {"k": 12}).items():
            setattr(m, k, v)
        m.feedback = fb
        attach(m, attrs)
    j.train()
    t.train()
    return j, t


@pytest.mark.parametrize("name", IMPLICIT)
def test_implicit_scores_match(name, data, mode):
    j, t = implicit_pair(name, data, {"k": 12, "q": 2.0})
    assert t.is_topk == j.is_topk == (mode == "topk")
    users = np.arange(60)
    np.testing.assert_allclose(t.score_catalog(users), j.score_catalog(users),
                               atol=TOL, rtol=0)
    u = np.array([0, 5, 59, 60, -1, 3])
    i = np.array([1, 44, 2, 3, 4, 45])
    np.testing.assert_allclose(t.predict_batch(u, i), j.predict_batch(u, i),
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(t.get_most_similar(3, 7),
                                  j.get_most_similar(3, 7))
    assert t.get_similarity(3, 4) == pytest.approx(j.get_similarity(3, 4),
                                                   abs=1e-6)


@pytest.mark.parametrize("correlation", ["Jaccard", "Cooccurrence",
                                         "BidirectionalConditionalProbability"])
def test_implicit_other_measures_and_weights(correlation, data, mode):
    kind = next(c for c in JK.BinaryCorrelationType
                if c.value == correlation)
    opts = {"k": 9, "correlation": kind, "weighted": True, "alpha": 0.3}
    j, t = implicit_pair("ItemKNN", data, opts)
    topt = dict(opts, correlation=TK.BinaryCorrelationType(correlation))
    t = TK.ItemKNN()
    t.device = "cpu"
    for k, v in topt.items():
        setattr(t, k, v)
    t.feedback = data[0]
    t.train()
    users = np.arange(60)
    np.testing.assert_allclose(t.score_catalog(users), j.score_catalog(users),
                               atol=TOL, rtol=0)


def test_sum_up_inf_k(data):
    j, t = implicit_pair("UserKNN", data, {"k": JK.INF_K})
    users = np.arange(60)
    np.testing.assert_allclose(t.score_catalog(users), j.score_catalog(users),
                               atol=TOL, rtol=0)


def test_sum_up_refused_past_dense_nmax(data, monkeypatch):
    monkeypatch.setattr(T, "DENSE_NMAX", 8)
    t = create_item_recommender("UserKNN", f"k={TK.INF_K} device=cpu")
    t.feedback = data[0]
    with pytest.raises(ValueError, match="SumUp"):
        t.train()


def rating_pair(name, data, k=5):
    _, r, attrs = data
    j = getattr(JK, name)()
    t = getattr(TK, name)()
    t.device = "cpu"
    for m in (j, t):
        m.k = k
        m.ratings = r
        attach(m, attrs)
    j.train()
    t.train()
    return j, t


def tied_at_k(j, users, items, gap=1e-6):
    """Pairs whose K-th positive weight (JAX lookups) ties the next, to
    ``gap`` (the two packages' correlations may differ in the last
    ulp)."""
    r = j.ratings
    out = np.zeros(users.size, bool)
    n = (j.nbr_ids if j.is_topk else j.corr).shape[0]
    for p, (u, i) in enumerate(zip(users, items)):
        user = j.ENTITY == "user"
        row, fixed = (u, i) if user else (i, u)
        if row >= n or fixed >= (r.num_items if user else r.num_users):
            continue
        seg = (r.by_item if user else r.by_user).segment(fixed)
        others = (r.users if user else r.items)[seg]
        w = j._lookup_corr(row, others)
        w = np.sort(w[(w > 0) & (others != row)])[::-1]
        out[p] = w.size > j.k and w[j.k - 1] - w[j.k] <= gap
    return out


@pytest.mark.parametrize("name", RATING)
def test_rating_predictions_match(name, data, mode):
    """K = 5 for the collaborative models; the attribute correlations
    (few attributes) tie almost everywhere, so K = 400 there. Negative
    ids are left out: the JAX package reads correlation row -1 for them
    (numpy's wraparound), the port predicts the baseline (ROADMAP §C)."""
    j, t = rating_pair(name, data, k=400 if "Attribute" in name else 5)
    rng = np.random.default_rng(2)
    u = np.append(rng.integers(0, 60, 400), [60, 0])
    i = np.append(rng.integers(0, 45, 400), [0, 45])
    pj, pt = j.predict_batch(u, i), t.predict_batch(u, i)
    tied = tied_at_k(j, u, i)
    assert tied.sum() < u.size // 4
    np.testing.assert_allclose(pt[~tied], pj[~tied], atol=TOL, rtol=0)


def test_rating_k_inf_and_large_k_match_everywhere(data, mode):
    """With K past every list length no tie can matter: all pairs."""
    for k in (JK.INF_K, 400):
        j, t = rating_pair("ItemKNNRating", data, k=k)
        u, i = np.arange(60).repeat(3), np.tile([0, 7, 44], 60)
        np.testing.assert_allclose(t.predict_batch(u, i),
                                   j.predict_batch(u, i), atol=TOL, rtol=0)


def test_rating_tie_at_k_takes_the_smaller_ids():
    """User 0 and four raters of item 0 with equal weights; K = 2 takes
    raters 1 and 2, whose residuals the prediction then averages."""
    users = np.array([0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 1, 2, 3, 4])
    items = np.array([1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 0, 0, 0, 0])
    vals = np.array([5.0, 5, 5, 5, 5, 1, 1, 1, 1, 1, 5, 4, 1, 2])
    r = RatingData(users, items, vals, 5, 3)
    t = create_rating_predictor("UserKNN", "k=2 device=cpu")
    t.ratings = r
    t.train()
    w = t.corr[0, 1:].numpy()
    assert np.all(w == w[0]) and w[0] > 0
    base = t.baseline.predict_batch(np.array([0, 1, 2]), np.zeros(3, int))
    b1 = t.baseline.predict_batch(np.array([1, 2]), np.zeros(2, int))
    want = base[0] + np.mean(np.array([5.0, 4.0]) - b1)
    assert t.predict_batch(np.array([0]), np.array([0]))[0] == \
        pytest.approx(np.clip(want, 1, 5), abs=TOL)


@pytest.mark.parametrize("name", ["UserKNN", "ItemAttributeKNN"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_implicit_model_files_both_ways(name, direction, data, mode,
                                        tmp_path):
    j, t = implicit_pair(name, data)
    path = str(tmp_path / "knn.model")
    fresh = getattr(TK, name)() if direction == "jax_to_port" \
        else getattr(JK, name)()
    if direction == "jax_to_port":
        fresh.device = "cpu"
    writer = j if direction == "jax_to_port" else t
    writer.save_model(path)
    fresh.k = 12
    fresh.feedback = data[0]
    attach(fresh, data[2])
    fresh.load_model(path)
    assert fresh.is_topk == (mode == "topk")
    users = np.arange(60)
    np.testing.assert_allclose(fresh.score_catalog(users),
                               writer.score_catalog(users), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["ItemKNNRating", "UserAttributeKNNRating"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_rating_model_files_both_ways(name, direction, data, mode, tmp_path):
    j, t = rating_pair(name, data, k=400)
    path = str(tmp_path / "knn.model")
    writer = j if direction == "jax_to_port" else t
    fresh = getattr(TK, name)() if direction == "jax_to_port" \
        else getattr(JK, name)()
    if direction == "jax_to_port":
        fresh.device = "cpu"
    writer.save_model(path)
    fresh.k = 400
    fresh.ratings = data[1]
    fresh.load_model(path)
    u, i = np.arange(60).repeat(2), np.tile([3, 30], 60)
    np.testing.assert_allclose(fresh.predict_batch(u, i),
                               writer.predict_batch(u, i), atol=TOL, rtol=0)


def test_state_carriers(data, mode):
    j, _ = rating_pair("UserKNNRating", data, k=400)
    t = TK.UserKNNRating()
    t.device = "cpu"
    t.k = 400
    t.ratings = data[1]
    t.load_state(knn_state_from_jax(j))
    t.baseline.load_state(baseline_state_from_jax(j.baseline))
    t.baseline.ratings = data[1]
    u, i = np.arange(60), np.arange(60) % 45
    np.testing.assert_allclose(t.predict_batch(u, i), j.predict_batch(u, i),
                               atol=TOL, rtol=0)
    ji, _ = implicit_pair("ItemKNN", data)
    ti = TK.ItemKNN()
    ti.device = "cpu"
    ti.k = 12
    ti.feedback = data[0]
    ti.load_state(knn_state_from_jax(ji))
    np.testing.assert_allclose(ti.score_catalog(np.arange(60)),
                               ji.score_catalog(np.arange(60)), atol=TOL)
