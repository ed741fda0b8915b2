"""Cross-validation of the port (``mymedialite_tpu_torch/eval/crossval.py``)
against the JAX package's (``mymedialite_tpu/eval/crossval.py``) on the
CPU, with deterministic models: UserItemBaseline (ratings, also its fit
and the iterative form), MostPopular and ItemKNN (items),
UserItemBaseline as a ranker, and WRMF for the iterative item form (the
port's folds start from the JAX folds' initial tables, in fold order,
both packages' folds run in order). Results agree within 1e-6 and the
iterative forms print the same lines. The port runs its folds on threads
only for a model on the CPU.
"""

import re

import numpy as np
import pytest

from mymedialite_tpu.data.arrays import PosOnlyData as JaxPosOnly
from mymedialite_tpu.data.arrays import RatingData as JaxRatingData
from mymedialite_tpu.data.synthetic import synthetic_ratings
from mymedialite_tpu.eval import crossval as jcv
from mymedialite_tpu.models import registry as jreg
from mymedialite_tpu.models import wrmf as jwrmf
from mymedialite_tpu.utils.params import configure as jax_configure
from mymedialite_tpu_torch.convert import wrmf_tables_from_jax
from mymedialite_tpu_torch.data.arrays import PosOnlyData, RatingData
from mymedialite_tpu_torch.eval import crossval as tcv
from mymedialite_tpu_torch.models import registry as treg
from mymedialite_tpu_torch.models import wrmf as twrmf
from torch_threads import one_torch_thread  # noqa: F401

_NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


@pytest.fixture(scope="module")
def data():
    d = synthetic_ratings(num_users=120, num_items=90, num_ratings=3000,
                          seed=8)
    args = (d.users, d.items)
    kw = dict(num_users=d.num_users, num_items=d.num_items)
    return dict(jr=JaxRatingData(*args, d.values, **kw),
                tr=RatingData(*args, d.values, **kw),
                jp=JaxPosOnly(*args, **kw), tp=PosOnlyData(*args, **kw))


def models(kind, name, opts=""):
    create = dict(rating=(jreg.create_rating_predictor,
                          treg.create_rating_predictor),
                  item=(jreg.create_item_recommender,
                        treg.create_item_recommender))[kind]
    jm = create[0](name)
    if opts:
        jax_configure(jm, opts)
    tm = create[1](name, (opts + " device=cpu") if name != "MostPopular"
                   else opts)
    return jm, tm


def assert_results_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def rng():
    return np.random.default_rng(3)


@pytest.mark.parametrize("compute_fit", [False, True])
def test_crossvalidate_ratings(data, compute_fit):
    jm, tm = models("rating", "UserItemBaseline")
    want = jcv.crossvalidate_ratings(jm, data["jr"], 4, compute_fit,
                                     shuffle=True, rng=rng())
    got = tcv.crossvalidate_ratings(tm, data["tr"], 4, compute_fit,
                                    shuffle=True, rng=rng())
    assert_results_equal(got, want)
    assert str(got) == str(want)


@pytest.mark.parametrize("name", ["MostPopular", "ItemKNN"])
def test_crossvalidate_items(data, name):
    jm, tm = models("item", name, "k=20" if name == "ItemKNN" else "")
    kw = dict(candidate_item_mode="OVERLAP", rng=rng())
    want = jcv.crossvalidate_items(jm, data["jp"], 3, **kw)
    kw["rng"] = rng()
    got = tcv.crossvalidate_items(tm, data["tp"], 3, **kw)
    assert_results_equal(got, want)


def test_crossvalidate_rating_based_ranking(data):
    jm, tm = models("rating", "UserItemBaseline")
    want = jcv.crossvalidate_rating_based_ranking(jm, data["jr"], 3,
                                                  rng=rng())
    got = tcv.crossvalidate_rating_based_ranking(tm, data["tr"], 3,
                                                 rng=rng())
    assert_results_equal(got, want)


def same_lines(a, b):
    a, b = a.strip().splitlines(), b.strip().splitlines()
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert _NUM.sub("#", x) == _NUM.sub("#", y)
        for p, q in zip(_NUM.findall(x), _NUM.findall(y)):
            assert float(p) == pytest.approx(float(q), abs=1e-5)


def test_iterative_ratings(data, capsys):
    jm, tm = models("rating", "UserItemBaseline", "num_iter=1")
    jcv.iterative_crossvalidate_ratings(jm, data["jr"], 3, 4, 2, rng=rng(),
                                        show_fold_results=True)
    want = capsys.readouterr()
    tcv.iterative_crossvalidate_ratings(tm, data["tr"], 3, 4, 2, rng=rng(),
                                        show_fold_results=True)
    got = capsys.readouterr()
    same_lines(got.out, want.out)
    same_lines(got.err, want.err)
    assert got.out.count("iteration") == 4


def test_iterative_items(data, capsys, monkeypatch):
    """WRMF from the JAX folds' initial tables, folds in order."""
    monkeypatch.setenv("MML_SEQUENTIAL_CV", "1")
    stash = []
    jax_init, port_init = jwrmf.WRMF.init_model, twrmf.WRMF.init_model

    def record(self):
        jax_init(self)
        stash.append(wrmf_tables_from_jax(self))

    monkeypatch.setattr(jwrmf.WRMF, "init_model", record)
    monkeypatch.setattr(twrmf.WRMF, "init_model",
                        lambda self, tables=None: port_init(
                            self, stash.pop(0) if tables is None else tables))
    jm, tm = models("item", "WRMF", "num_factors=4 num_iter=1")
    jcv.iterative_crossvalidate_items(jm, data["jp"], 2, 2, 1, rng=rng())
    want = capsys.readouterr().out
    tcv.iterative_crossvalidate_items(tm, data["tp"], 2, 2, 1, rng=rng())
    got = capsys.readouterr().out
    same_lines(got, want)
    assert got.count("iteration") == 2 and not stash


def test_clone_and_fold_threads(monkeypatch):
    m = treg.create_rating_predictor("BiasedMatrixFactorization",
                                     "num_factors=3 bias_reg=0.5 device=cpu")
    m.random_seed = 9
    c = tcv.clone_recommender(m)
    assert (c.num_factors, c.bias_reg, c.device, c.random_seed) == \
        (3, 0.5, "cpu", 9)
    assert tcv.folds_in_parallel(m)
    m.device = "cuda"
    assert not tcv.folds_in_parallel(m)
    assert tcv.folds_in_parallel(treg.create_item_recommender("MostPopular"))
    seen = []
    import threading
    jobs = [lambda: seen.append(threading.get_ident()) for _ in range(3)]
    tcv.run_folds(jobs, parallel=False)
    assert set(seen) == {threading.get_ident()}
    monkeypatch.setenv("MML_SEQUENTIAL_CV", "1")
    seen.clear()
    tcv.run_folds(jobs, parallel=True)
    assert set(seen) == {threading.get_ident()}
