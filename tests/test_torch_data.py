"""The port's synthetic data (``mymedialite_tpu_torch/data/synthetic.py``)
against the JAX package's generator: the same seeds give the same
ratings and the same splits. And the port's registry configures a model
from an options string as the CLI's ``--recommender-options`` does."""

import numpy as np
import pytest

from mymedialite_tpu.data import synthetic as jsyn
from mymedialite_tpu_torch.data import synthetic as tsyn
from mymedialite_tpu_torch.models.registry import create_rating_predictor


@pytest.mark.parametrize("shape", [
    dict(num_users=50, num_items=70, num_ratings=900, seed=3),
    dict(num_users=300, num_items=200, num_ratings=6000, rank=4,
         noise=0.3, seed=11),
    dict(num_users=3000, num_items=2000, num_ratings=200_000, rank=4,
         seed=11),
    dict(num_users=400, num_items=300, num_ratings=9000, seed=1,
         with_times=True, time_drift=1.0),
    dict(num_users=60, num_items=40, num_ratings=700, seed=5,
         with_times=True),
])
def test_synthetic_ratings_match_jax(shape):
    """The draws' searches and de-duplication run in torch (here on the
    CPU) and give the JAX package's numpy data."""
    a, b = tsyn.synthetic_ratings(**shape), jsyn.synthetic_ratings(**shape)
    assert (a.num_users, a.num_items) == (b.num_users, b.num_items)
    assert a.users.dtype == b.users.dtype == np.int32
    for name in ("users", "items", "values", "times"):
        x, y = getattr(a, name), getattr(b, name)
        if y is None:
            assert x is None
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fraction,seed", [(0.2, 1), (0.1, 5)])
def test_split_ratings_match_jax(fraction, seed):
    data = jsyn.synthetic_ratings(num_users=80, num_items=90,
                                  num_ratings=1500, seed=2)
    for a, b in zip(tsyn.split_ratings(data, fraction, seed),
                    jsyn.split_ratings(data, fraction, seed)):
        for name in ("users", "items", "values"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_registry_applies_options():
    m = create_rating_predictor("BiasedMatrixFactorization",
                                "num_factors=7 num_iter=2 device=cpu")
    assert (m.num_factors, m.num_iter) == (7, 2)
    assert create_rating_predictor("MatrixFactorization").num_factors != 7
    with pytest.raises(KeyError):
        create_rating_predictor("BiasedMatrixFactorization", "no_such_key=1")


@pytest.mark.parametrize("opts", [
    dict(with_times=True), dict(with_times=True, time_drift=1.0),
    dict(with_times=True, time_drift=0.5, return_factors=True),
    dict(return_factors=True)],
    ids=["times", "drift", "drift-factors", "factors"])
def test_synthetic_timed_ratings_match_jax(opts):
    shape = dict(num_users=60, num_items=50, num_ratings=1200, seed=7)
    a, b = tsyn.synthetic_ratings(**shape, **opts), \
        jsyn.synthetic_ratings(**shape, **opts)
    if opts.get("return_factors"):
        (a, fa), (b, fb) = a, b
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)
    for name in ("users", "items", "values", "times"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None and not opts.get("with_times")
        else:
            np.testing.assert_array_equal(x, y)


def test_times_are_drawn_after_the_ratings():
    """with_times=False gives the ratings of a draw without times, and
    time_drift=0 the same ratings with times."""
    shape = dict(num_users=60, num_items=50, num_ratings=1200, seed=9)
    plain = tsyn.synthetic_ratings(**shape)
    timed = tsyn.synthetic_ratings(**shape, with_times=True)
    drift = tsyn.synthetic_ratings(**shape, with_times=True, time_drift=1.0)
    assert plain.times is None
    for name in ("users", "items", "values"):
        np.testing.assert_array_equal(getattr(plain, name),
                                      getattr(timed, name))
    np.testing.assert_array_equal(timed.times, drift.times)
    assert not np.array_equal(timed.values, drift.values)
    assert timed.times.min() >= 880_000_000 and \
        timed.times.max() < 893_000_000


@pytest.mark.parametrize("shape", [
    dict(num_users=50, num_items=40, num_events=800, seed=3),
    dict(num_users=300, num_items=120, num_events=5000, rank=4, seed=11)])
def test_synthetic_posonly_matches_jax(shape):
    a, b = tsyn.synthetic_posonly(**shape), jsyn.synthetic_posonly(**shape)
    assert (a.num_users, a.num_items) == (b.num_users, b.num_items)
    np.testing.assert_array_equal(a.users, b.users)
    np.testing.assert_array_equal(a.items, b.items)
