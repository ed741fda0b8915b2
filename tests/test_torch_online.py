"""The online (prequential) protocol of the port (``eval/online.py``)
against the JAX package's on the same data, on the CPU.

- ``evaluate_ratings_online`` gives the JAX results for GlobalAverage,
  UserAverage, ItemAverage and UserItemBaseline to 1e-6, and for MF and
  BiasedMF at ``init_stdev=0`` (started from the JAX tables) to 1e-4.
- The buffered + chunked path equals the per-event path to 1e-5, as the
  JAX package's own test holds (tests/test_models_rating.py:243-278);
  afterwards the events are folded into the dataset and iterate() trains
  on them.
- ``evaluate_items_online`` gives the JAX results for MostPopular; a
  BPRMF runs the protocol and grows its feedback by the test events.
- A model without ``add_ratings`` is refused, as in the JAX package.
"""

import numpy as np
import pytest

from mymedialite_tpu.data.synthetic import split_ratings, synthetic_ratings
from mymedialite_tpu.eval.online import (
    evaluate_items_online as jax_items_online,
    evaluate_ratings_online as jax_ratings_online,
)
from mymedialite_tpu.models import mf as jmf
from mymedialite_tpu.models.registry import (
    create_item_recommender as jax_create_item,
    create_rating_predictor as jax_create,
)
from mymedialite_tpu.utils.params import configure as jax_configure
from mymedialite_tpu_torch.convert import tables_from_jax
from mymedialite_tpu_torch.data.arrays import PosOnlyData, RatingData
from mymedialite_tpu_torch.data.synthetic import (
    posonly_from_ratings, split_posonly,
)
from mymedialite_tpu_torch.data.synthetic import (
    synthetic_ratings as port_synthetic_ratings,
)
from mymedialite_tpu_torch.eval.online import (
    evaluate_items_online, evaluate_ratings_online,
)
from mymedialite_tpu_torch.models.registry import (
    create_item_recommender, create_rating_predictor,
)
from torch_threads import one_torch_thread  # noqa: F401

KEYS = ("RMSE", "MAE", "NMAE", "CBD")


@pytest.fixture(scope="module")
def data():
    """200 x 300 x 6000 synthetic ratings, split 80/20; 600 test events."""
    train, test = split_ratings(synthetic_ratings(num_users=200,
                                                  num_items=300,
                                                  num_ratings=6000, seed=15),
                                seed=16)
    return train, test.select(np.arange(600))


def port_data(d):
    return RatingData(d.users, d.items, d.values, num_users=d.num_users,
                      num_items=d.num_items, scale=d.scale)


def assert_results(got, ref, atol):
    for k in KEYS:
        assert got[k] == pytest.approx(ref[k], abs=atol), (k, got, ref)


@pytest.mark.parametrize("name", ["GlobalAverage", "UserAverage",
                                  "ItemAverage", "UserItemBaseline"])
def test_baselines_match_jax(name, data):
    train, test = data
    j = jax_create(name)
    t = create_rating_predictor(name, "device=cpu")
    j.ratings = train
    t.ratings = port_data(train)
    j.train()
    t.train()
    assert_results(evaluate_ratings_online(t, port_data(test)),
                   jax_ratings_online(j, test), 1e-6)
    assert len(t.ratings) == len(j.ratings) == len(train) + len(test)


def mf_pair(name, train, stdev_after=0.0):
    """A JAX MF trained 3 epochs, the port started from its tables; both
    then at init_stdev=0 with 5 refresh steps."""
    jm = getattr(jmf, name)()
    jax_configure(jm, "num_factors=6 num_iter=3")
    jm.ratings = train
    jm.train()
    tm = create_rating_predictor(name, "num_factors=6 device=cpu")
    tm.ratings = port_data(train)
    tm.init_model(tables=tables_from_jax(jm))
    for m in (jm, tm):
        m.init_stdev = stdev_after
        m.num_iter = 5
    return jm, tm


@pytest.mark.parametrize("name", ["MatrixFactorization",
                                  "BiasedMatrixFactorization"])
def test_mf_matches_jax(name, data):
    train, test = data
    jm, tm = mf_pair(name, train)
    assert_results(evaluate_ratings_online(tm, port_data(test)),
                   jax_ratings_online(jm, test), 1e-4)


@pytest.mark.parametrize("name", ["MatrixFactorization",
                                  "BiasedMatrixFactorization",
                                  "UserItemBaseline"])
def test_buffered_chunked_path_equals_per_event_path(name, data):
    train, test = data

    def model(fast):
        if name == "UserItemBaseline":
            m = create_rating_predictor(name, "device=cpu")
            m.ratings = port_data(train)
            m.train()
        else:
            m = mf_pair(name, train)[1]
        if not fast:
            m.SUPPORTS_ONLINE_BUFFER = False
            m.ONLINE_PREDICT_ROW_LOCAL = False
        return m
    fast, slow = model(True), model(False)
    assert fast.SUPPORTS_ONLINE_BUFFER and fast.ONLINE_PREDICT_ROW_LOCAL
    assert_results(evaluate_ratings_online(fast, port_data(test)),
                   evaluate_ratings_online(slow, port_data(test)), 1e-5)


def test_events_fold_into_dataset_then_iterate(data):
    train, test = data
    _, tm = mf_pair("BiasedMatrixFactorization", train, stdev_after=0.1)
    evaluate_ratings_online(tm, port_data(test))
    assert len(tm.ratings) == len(train) + len(test)
    assert not tm._online_active
    assert tm._plan is None
    tm.iterate()
    assert tm._plan.n_ratings == len(train) + len(test)
    assert np.isfinite(tm.predict(0, 0))


def test_non_incremental_model_is_refused():
    m = create_item_recommender("Zero")
    with pytest.raises(TypeError, match="incremental"):
        evaluate_items_online(m, None, None)
    assert not hasattr(m, "add_feedback")


@pytest.fixture(scope="module")
def items_data():
    fb = posonly_from_ratings(port_synthetic_ratings(
        num_users=150, num_items=120, num_ratings=4000, seed=4))
    return split_posonly(fb, seed=5)


def jax_posonly(d):
    from mymedialite_tpu.data.arrays import PosOnlyData as JaxPosOnly
    return JaxPosOnly(d.users, d.items, num_users=d.num_users,
                      num_items=d.num_items)


@pytest.mark.parametrize("by_user", [False, True])
def test_items_online_most_popular_matches_jax(items_data, by_user):
    train, test = items_data
    j = jax_create_item("MostPopular")
    t = create_item_recommender("MostPopular")
    j.by_user = t.by_user = by_user
    j.feedback = jax_posonly(train)
    t.feedback = train
    j.train()
    t.train()
    ref = jax_items_online(j, jax_posonly(test), jax_posonly(train))
    got = evaluate_items_online(t, test, train)
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k
    assert len(t.feedback) == len(j.feedback)


def test_items_online_bprmf_grows_the_feedback(items_data):
    train, test = items_data
    t = create_item_recommender("BPRMF", "num_factors=6 num_iter=3 "
                                "device=cpu")
    t.feedback = train
    t.train()
    res = evaluate_items_online(t, test, train)
    assert 0.0 < res["AUC"] <= 1.0 and res["num_users"] > 0
    assert len(t.feedback) == len(train) + len(test)
    assert isinstance(t.feedback, PosOnlyData)
    assert t._sampling[1]["num_events"] == len(t.feedback)
    assert t._plan is None
    t.iterate()
    assert t._plan is not None
