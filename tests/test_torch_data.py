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
])
def test_synthetic_ratings_match_jax(shape):
    a, b = tsyn.synthetic_ratings(**shape), jsyn.synthetic_ratings(**shape)
    assert (a.num_users, a.num_items) == (b.num_users, b.num_items)
    for name in ("users", "items", "values"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


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
