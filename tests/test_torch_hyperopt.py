"""The Nelder-Mead search of the port (``mymedialite_tpu_torch/
hyperopt.py``) against the JAX package's (``mymedialite_tpu/
hyperopt.py``) on UserItemBaseline, a deterministic model, on the CPU.

The search visits the same points in the same order, each evaluation
within 1e-6 of the JAX package's, and picks the same hyperparameters:
over 15 iterations and over the full 50 (99 evaluations on this
fixture). The two packages' float32 RMSEs of one point differ by up to
4.2e-8 here; a simplex whose points tie closer than that could part the
two searches, which this fixture does not.
"""

import re

import numpy as np
import pytest

from mymedialite_tpu import hyperopt as jho
from mymedialite_tpu.data.arrays import RatingData as JaxRatingData
from mymedialite_tpu.data.synthetic import synthetic_ratings
from mymedialite_tpu.models.registry import create_rating_predictor as jcreate
from mymedialite_tpu_torch import hyperopt as tho
from mymedialite_tpu_torch.data.arrays import RatingData
from mymedialite_tpu_torch.models.registry import create_rating_predictor
from torch_threads import one_torch_thread  # noqa: F401

_LINE = re.compile(r"Nelder-Mead: (.*): (\S+)$")


@pytest.fixture(scope="module")
def pair():
    d = synthetic_ratings(num_users=150, num_items=200, num_ratings=4000,
                          seed=8)
    args = (d.users, d.items, d.values)
    kw = dict(num_users=d.num_users, num_items=d.num_items)

    def make():
        jm = jcreate("UserItemBaseline")
        tm = create_rating_predictor("UserItemBaseline", "device=cpu")
        jm.ratings = JaxRatingData(*args, **kw)
        tm.ratings = RatingData(*args, **kw)
        return jm, tm
    return make


def search(cls, model, capsys):
    capsys.readouterr()
    best = cls("RMSE", model, rng=np.random.default_rng(42)).find_minimum()
    lines = [_LINE.match(ln).groups() for ln in
             capsys.readouterr().err.splitlines() if ln.startswith("Nelder")]
    return best, lines


def test_search_matches_jax(pair, capsys, monkeypatch):
    monkeypatch.setattr(jho, "NUM_IT", 15)
    monkeypatch.setattr(tho, "NUM_IT", 15)
    jm, tm = pair()
    n = len(tm.ratings)
    want, jlines = search(jho.NelderMead, jm, capsys)
    got, tlines = search(tho.NelderMead, tm, capsys)
    assert len(tlines) == len(jlines) > 15
    for (tc, tv), (jc, jv) in zip(tlines, jlines):
        assert tc == jc
        assert float(tv) == pytest.approx(float(jv), abs=1e-6)
    assert got == pytest.approx(want, abs=1e-6)
    assert (tm.reg_u, tm.reg_i) == (jm.reg_u, jm.reg_i)
    # the recommender ends on the whole data: the split's two parts
    assert len(tm.ratings) == len(jm.ratings) == n


def test_full_search_best_value(pair, capsys):
    jm, tm = pair()
    want, jlines = search(jho.NelderMead, jm, capsys)
    got, tlines = search(tho.NelderMead, tm, capsys)
    assert got == pytest.approx(want, abs=1e-6)
    assert len(tlines) == len(jlines) > 50
    for (tc, tv), (jc, jv) in zip(tlines, jlines):
        assert tc == jc
        assert float(tv) == pytest.approx(float(jv), abs=1e-6)
    assert (tm.reg_u, tm.reg_i) == (jm.reg_u, jm.reg_i)
    assert tho.HP_SPACES == jho.HP_SPACES
    assert (tho.ALPHA, tho.GAMMA, tho.RHO, tho.SIGMA, tho.SPLIT_RATIO) == \
        (jho.ALPHA, jho.GAMMA, jho.RHO, jho.SIGMA, jho.SPLIT_RATIO)


def test_unprepared_model_refused(pair):
    m = create_rating_predictor("ItemAverage", "device=cpu")
    m.ratings = pair()[1].ratings
    with pytest.raises(ValueError, match="not prepared for type"):
        tho.NelderMead("RMSE", m)
