"""The rating baselines of the port (``mymedialite_tpu_torch/models/
baselines.py``) against the JAX package's on the same data, on the CPU.

Predictions (in range, past the training ids, negative ids) agree to
1e-6, the rating evaluation to 1e-6, ``RandomRating``'s draws are equal,
and model files pass between the packages both ways with predictions
equal to 1e-6. The incremental API runs as the JAX package's (its
parity tests are tests/test_torch_incremental_rating.py).
"""

import numpy as np
import pytest
import torch

from mymedialite_tpu.data.synthetic import split_ratings, synthetic_ratings
from mymedialite_tpu.eval.rating import evaluate_ratings as jax_evaluate
from mymedialite_tpu.models.registry import (
    create_rating_predictor as jax_create,
)
from mymedialite_tpu.utils.params import configure as jax_configure
from mymedialite_tpu_torch.convert import baseline_state_from_jax
from mymedialite_tpu_torch.eval.rating import evaluate_ratings
from mymedialite_tpu_torch.models import baselines as tb
from mymedialite_tpu_torch.models.registry import create_rating_predictor
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ["GlobalAverage", "UserAverage", "ItemAverage", "Constant", "Random",
         "UserItemBaseline"]
OPTIONS = {"Constant": "constant_rating=3.25",
           "UserItemBaseline": "reg_u=5 reg_i=2 num_iter=4"}
TOL = 1e-6


@pytest.fixture(scope="module")
def data():
    return split_ratings(synthetic_ratings(num_users=200, num_items=300,
                                           num_ratings=6000, seed=3))


def pairs(test):
    """The test pairs plus ids past the training set and negative ids."""
    return (np.concatenate([test.users, [205, -1, 3, 250]]),
            np.concatenate([test.items, [4, 2, -3, 350]]))


def both(name, train):
    j = jax_create(name)
    t = create_rating_predictor(name, "device=cpu")
    if name in OPTIONS:
        jax_configure(j, OPTIONS[name])
        t = create_rating_predictor(name, OPTIONS[name] + " device=cpu")
    j.ratings = train
    t.ratings = train
    j.train()
    t.train()
    return j, t


@pytest.mark.parametrize("name", NAMES)
def test_predictions_and_evaluation_match(name, data):
    train, test = data
    j, t = both(name, train)
    u, i = pairs(test)
    np.testing.assert_allclose(t.predict_batch(u, i), j.predict_batch(u, i),
                               atol=TOL, rtol=0)
    want = jax_evaluate(j, test, train)
    got = evaluate_ratings(t, test, train)
    for key in ("RMSE", "MAE", "NMAE", "CBD"):
        assert got[key] == pytest.approx(want[key], abs=TOL), key
    for part in ("new_user_results", "new_item_results"):
        a, b = getattr(want, part), getattr(got, part)
        assert (a is None) == (b is None), part


@pytest.mark.parametrize("name", NAMES)
def test_catalog_scores_match(name, data):
    train, _ = data
    j, t = both(name, train)
    users = np.array([0, 7, 199])
    np.testing.assert_allclose(t.score_catalog(users),
                               j.score_catalog(users), atol=TOL, rtol=0)


def test_random_draws_are_equal(data):
    """The same host generator, seeded by ``random_seed``, in call order."""
    train, test = data
    j, t = both("Random", train)
    for _ in range(3):
        np.testing.assert_array_equal(t.predict_batch(test.users, test.items),
                                      j.predict_batch(test.users, test.items))
    j.random_seed = t.random_seed = 7
    j.train()
    t.train()
    np.testing.assert_array_equal(t.predict_batch(test.users, test.items),
                                  j.predict_batch(test.users, test.items))


@pytest.mark.parametrize("name", ["GlobalAverage", "UserAverage",
                                  "ItemAverage", "UserItemBaseline"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_model_files_both_ways(name, direction, data, tmp_path):
    train, test = data
    j, t = both(name, train)
    path = str(tmp_path / "model")
    writer, reader = (j, create_rating_predictor(name, "device=cpu")) \
        if direction == "jax_to_port" else (t, jax_create(name))
    writer.save_model(path)
    reader.ratings = train
    reader.load_model(path)
    u, i = pairs(test)
    np.testing.assert_allclose(reader.predict_batch(u, i),
                               writer.predict_batch(u, i), atol=TOL, rtol=0)
    if direction == "port_to_jax":
        t.save_model(str(tmp_path / "again"))
        j.save_model(str(tmp_path / "jax"))
        assert open(tmp_path / "again").read() == \
            open(tmp_path / "jax").read()


def test_user_item_baseline_iterate_and_state(data):
    """``iterate`` continues the alternation as the JAX model's does, and
    ``load_state`` starts from the JAX biases."""
    train, test = data
    j, t = both("UserItemBaseline", train)
    j.iterate()
    t.iterate()
    np.testing.assert_allclose(t.user_biases.numpy(), j.user_biases,
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(t.item_biases.numpy(), j.item_biases,
                               atol=TOL, rtol=0)
    fresh = tb.UserItemBaseline()
    fresh.device = "cpu"
    fresh.ratings = train
    fresh.load_state(baseline_state_from_jax(j))
    np.testing.assert_allclose(
        fresh.predict_batch(test.users, test.items),
        j.predict_batch(test.users, test.items), atol=TOL, rtol=0)


def test_incremental_api_runs_as_in_jax(data):
    train, test = data
    j, t = both("UserItemBaseline", train)
    for m in (j, t):
        m.retrain_user(0)
        m.retrain_item(0)
        m._retrain([0], [1])
        m.add_ratings([0], [1], [3.0])
    np.testing.assert_allclose(
        t.predict_batch(*pairs(test)), j.predict_batch(*pairs(test)),
        atol=TOL, rtol=0)


def test_cuda_is_asked_for_never_assumed(monkeypatch, data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = tb.UserItemBaseline()                # default device: cuda
    m.ratings = data[0]
    with pytest.raises(RuntimeError, match="device=cpu"):
        m.train()
