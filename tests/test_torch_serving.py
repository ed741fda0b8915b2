"""The serving slice of the port against the JAX package, on the CPU:
``ops/topk.py recommend_batch`` for the BPR family (both of its routes),
the rating models' ``catalog_scorer`` / ``score_catalog`` (MF, biased
MF, the five SVD++ models), ``recommend``, the base ``score_catalog``
default, the model's device (``tables_device``) in the evaluator and the
server, and the vectorised ignore rows.

Each JAX model trains one epoch (the Pallas epochs in interpret mode with
float32 operands, as in tests/test_torch_bpr.py, test_torch_mf.py and
test_torch_svdpp.py: for SVD++ the test, and only the test, rebinds the
JAX epoch with ``mxu_dtype="f32"`` and its pass length to 256); the port
model then starts from those tables (``convert.*_from_jax``), so both
score the same tables. Scores agree to 1e-5; top-n lists exactly, the
scores beside them to 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

from mymedialite_tpu.data.arrays import RatingData as JaxRatingData
from mymedialite_tpu.data.synthetic import (
    split_posonly, split_ratings, synthetic_posonly, synthetic_ratings,
)
from mymedialite_tpu.eval.ranking import evaluate_items as jax_evaluate_items
from mymedialite_tpu.models import base as jbase
from mymedialite_tpu.models import bpr as jbpr
from mymedialite_tpu.models import mf as jmf
from mymedialite_tpu.models import svdpp as jsv
from mymedialite_tpu.ops import pallas_sgd as ps
from mymedialite_tpu.ops import pallas_svdpp as psv
from mymedialite_tpu.ops.topk import recommend_batch as jax_recommend_batch
from mymedialite_tpu.utils.params import configure as jax_configure
from mymedialite_tpu_torch.convert import (
    bpr_tables_from_jax, svdpp_tables_from_jax, tables_from_jax,
)
from mymedialite_tpu_torch.data.arrays import PosOnlyData, RatingData
from mymedialite_tpu_torch.eval.ranking import evaluate_items, ragged_rows
from mymedialite_tpu_torch.models import base as tbase
from mymedialite_tpu_torch.models import svdpp as tsv
from mymedialite_tpu_torch.models.registry import (
    create_item_recommender, create_rating_predictor,
)
from mymedialite_tpu_torch.ops import topk as ttopk
from mymedialite_tpu_torch.ops.catalog_topk import catalog_topk
from mymedialite_tpu_torch.ops.topk import recommend_batch
from torch_threads import one_torch_thread  # noqa: F401

BPR_MODELS = ["BPRMF", "WeightedBPRMF", "SoftMarginRankingMF"]
SVDPP_MODELS = ["SVDPlusPlus", "SigmoidSVDPlusPlus",
                "SigmoidItemAsymmetricFactorModel",
                "SigmoidUserAsymmetricFactorModel",
                "SigmoidCombinedAsymmetricFactorModel"]


# --- the BPR family: recommend_batch ----------------------------------

@pytest.fixture(scope="module")
def feedback():
    """500 users x 400 items, 6k events, split 80/20."""
    return split_posonly(synthetic_posonly(num_users=500, num_items=400,
                                           num_events=6000, seed=31), seed=32)


@pytest.fixture(scope="module", params=BPR_MODELS)
def bpr_pair(request, feedback):
    train, _ = feedback
    jm = getattr(jbpr, request.param)()
    jax_configure(jm, "num_factors=8 num_iter=1 mxu_dtype=f32")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MML_MXU", "interpret")
        jm.feedback = train
        jm.train()
    assert np.abs(np.asarray(jm.params["item_bias"])).max() > 0
    tm = create_item_recommender(request.param, "num_factors=8 device=cpu")
    tm.feedback = train
    tm.init_model(tables=bpr_tables_from_jax(jm))
    return jm, tm, train


SERVE_CASES = [(10, True, None), (10, False, None), (10, True, "thirds"),
               (-1, True, None), (-1, False, "thirds")]
SERVE_IDS = ["n10-train", "n10", "n10-train-cand", "all-train",
             "all-cand"]


def _serve_args(train, n, with_training, cand):
    users = np.arange(0, train.num_users, 3, dtype=np.int32)
    k = n if n > 0 else train.num_items
    candidates = None if cand is None else range(0, train.num_items, 3)
    return users, k, dict(training=train if with_training else None,
                          candidates=candidates, block=64)


@pytest.mark.parametrize("n,with_training,cand", SERVE_CASES, ids=SERVE_IDS)
def test_recommend_batch_matches_jax(bpr_pair, n, with_training, cand):
    """The sort route (every model on the CPU) gives the JAX lists."""
    jm, tm, train = bpr_pair
    users, k, kw = _serve_args(train, n, with_training, cand)
    assert not ttopk.takes_topk_kernel(tm, k)
    want_ids, want_s = jax_recommend_batch(jm, users, k, **kw)
    got_ids, got_s = recommend_batch(tm, users, k, **kw)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
    if n < 0 and with_training:
        assert (got_ids == -1).any()       # training items leave the list


@pytest.mark.parametrize("n,with_training,cand", SERVE_CASES[:3],
                         ids=SERVE_IDS[:3])
def test_kernel_route_matches_jax(bpr_pair, monkeypatch, n, with_training,
                                  cand):
    """The kernel route's masks and fused rows, run on the CPU with
    catalog_topk's plain version, give the JAX lists."""
    jm, tm, train = bpr_pair
    users, k, kw = _serve_args(train, n, with_training, cand)
    monkeypatch.setattr(ttopk, "takes_topk_kernel", lambda rec, k: True)
    calls = []
    real = ttopk.catalog_topk
    monkeypatch.setattr(ttopk, "catalog_topk",
                        lambda *a, **kw: calls.append(a[2]) or real(*a, **kw))
    want_ids, want_s = jax_recommend_batch(jm, users, k, **kw)
    got_ids, got_s = recommend_batch(tm, users, k, **kw)
    assert len(calls) == -(-users.size // 64)
    assert calls[0].dtype == torch.int8
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)


def test_fused_rows(bpr_pair):
    """users[u] @ items.T is the catalog score; built once per state."""
    _, tm, train = bpr_pair
    U, I = tm.fused_rows()
    assert U.shape == (train.num_users, 9) and I.shape == (train.num_items, 9)
    assert (U[:, -1] == 1).all()
    users = torch.arange(0, train.num_users, 7)
    torch.testing.assert_close(U[users] @ I.T, tm.catalog_scorer()(users),
                               rtol=0, atol=1e-5)
    assert tm.fused_rows()[1] is I
    p = tm.params                          # a new state: new rows
    tm.params = dict(p, item_factors=p["item_factors"].clone())
    assert tm.fused_rows()[1] is not I


def test_takes_topk_kernel_rules(bpr_pair, monkeypatch):
    _, tm, _ = bpr_pair
    monkeypatch.setattr(type(tm), "tables_device",
                        lambda self: torch.device("cuda"))
    assert ttopk.takes_topk_kernel(tm, 64)
    assert not ttopk.takes_topk_kernel(tm, 65)
    mf = create_rating_predictor("BiasedMatrixFactorization")
    monkeypatch.setattr(type(mf), "tables_device",
                        lambda self: torch.device("cuda"))
    assert not ttopk.takes_topk_kernel(mf, 10)
    assert not ttopk.takes_topk_kernel(
        create_item_recommender("MostPopular"), 10)


def assert_same_list(got, want):
    """Two ``recommend`` lists: the same ids in the same order, scores
    to 1e-5."""
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=1e-5)


def test_recommend_matches_jax(bpr_pair):
    jm, tm, train = bpr_pair
    for u, n, cand, ign in ((0, 5, None, None), (3, -1, None, [1, 2, 3]),
                            (7, 10, range(0, 400, 2), range(0, 40))):
        assert_same_list(tm.recommend(u, n, cand, ign),
                         jm.recommend(u, n, cand, ign))


# --- the vectorised ignore rows --------------------------------------

def test_ragged_rows_equal_the_loop(feedback):
    """ragged_rows gives what recommend_batch's per-user loop gave."""
    train, _ = feedback
    port = PosOnlyData(train.users, train.items, num_users=train.num_users,
                       num_items=train.num_items)
    batch = np.concatenate([np.arange(0, port.num_users, 2),
                            [port.num_users, port.num_users + 5]]
                           ).astype(np.int32)
    counts = np.where(batch < port.num_users, port.count_by_user[
        np.minimum(batch, port.num_users - 1)], 0)
    P = max(int(counts.max()), 1)
    loop = np.full((batch.size, P), port.num_items, dtype=np.int64)
    for r, u in enumerate(batch):
        if u < port.num_users:
            items_u = port.items_by_user(int(u))
            loop[r, :items_u.size] = items_u
    got = ragged_rows(port.by_user, batch, port.num_users, P, port.num_items)
    np.testing.assert_array_equal(got, loop)


# --- the rating models: catalog scorers ------------------------------

@pytest.fixture(scope="module")
def ratings():
    """150 x 200 x 4000 synthetic ratings, split 80/20."""
    return split_ratings(synthetic_ratings(num_users=150, num_items=200,
                                           num_ratings=4000, seed=41), seed=42)


@pytest.fixture(scope="module", params=["MatrixFactorization",
                                        "BiasedMatrixFactorization"])
def mf_pair(request, ratings):
    train, _ = ratings
    jm = getattr(jmf, request.param)()
    jax_configure(jm, "num_factors=6 num_iter=1 mxu_dtype=f32")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MML_MXU", "interpret")
        mp.setattr(ps, "device_epoch_order",
                   lambda plan, seed: plan.epoch_order(seed))
        jm.ratings = train
        jm.train()
    tm = create_rating_predictor(request.param, "num_factors=6 device=cpu")
    tm.ratings = train
    tm.init_model(tables=tables_from_jax(jm))
    return jm, tm, train


def test_mf_score_catalog_matches_jax(mf_pair):
    jm, tm, train = mf_pair
    users = np.arange(train.num_users + 4, dtype=np.int32)
    got = tm.score_catalog(users)
    assert got.shape == (users.size, train.num_items)
    np.testing.assert_allclose(got, np.asarray(jm.score_catalog(users)),
                               rtol=0, atol=1e-5)
    assert got.std() > 0.01


def test_mf_recommend_and_serving_match_jax(mf_pair):
    jm, tm, train = mf_pair
    for u, n, cand, ign in ((0, 5, None, None), (4, -1, range(50), [1, 2]),
                            (9, 10, None, range(0, 200, 5))):
        assert_same_list(tm.recommend(u, n, cand, ign),
                         jm.recommend(u, n, cand, ign))
    users = np.arange(0, train.num_users, 2, dtype=np.int32)
    got_ids, got_s = recommend_batch(tm, users, 10, training=train, block=32)
    want_ids, want_s = jax_recommend_batch(jm, users, 10, training=train,
                                           block=32)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)


def test_base_score_catalog_default(mf_pair):
    """The base default (predict_batch over the catalog, one user at a
    time) equals the JAX default and the model's scorer."""
    jm, tm, train = mf_pair
    users = np.array([0, 5, 17, train.num_users - 1], dtype=np.int32)
    got = tbase.Recommender.score_catalog(tm, users)
    np.testing.assert_allclose(got, jbase.Recommender.score_catalog(jm, users),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, tm.score_catalog(users), rtol=0,
                               atol=1e-5)


def test_rating_model_device_in_evaluator_and_server(mf_pair, ratings):
    """Both evaluators take the model's device from ``tables_device``:
    an MF model on the CPU ranks and serves (the ItemMF-only lookup of
    ``params["user_factors"]`` failed for it) as in the JAX package."""
    jm, tm, train = mf_pair
    _, test = ratings
    assert tm.tables_device() == torch.device("cpu")
    assert create_item_recommender("MostPopular").tables_device() == \
        torch.device("cpu")

    def posonly(d, cls):
        return cls(d.users, d.items, num_users=d.num_users,
                   num_items=d.num_items)
    got = evaluate_items(tm, posonly(test, PosOnlyData),
                         posonly(train, PosOnlyData),
                         candidate_item_mode="UNION")
    want = jax_evaluate_items(jm, test, train, candidate_item_mode="UNION")
    for key in ("AUC", "MAP", "NDCG", "prec@5"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    ids, _ = recommend_batch(tm, np.arange(8), 5,
                             training=posonly(train, PosOnlyData))
    assert (ids >= 0).all()


def _jax_svdpp_f32_interpret(mp):
    """The JAX SVD++ epoch on the CPU with float32 operands and a pass of
    256 grid steps (as tests/test_torch_svdpp.py); the package itself is
    not edited."""
    mp.setenv("MML_MXU", "interpret")
    mp.setattr(psv, "svdpp_epoch_mxu",
               functools.partial(psv.svdpp_epoch_mxu, mxu_dtype="f32"))
    mp.setattr(psv, "prepare_svdpp_mxu",
               functools.partial(psv.prepare_svdpp_mxu, pass_len=256))


def _jax_leaves(model):
    """The JAX models that hold tables, in the order the port's
    ``train`` initialises its own."""
    if hasattr(model, "_item_afm"):
        return _jax_leaves(model._item_afm) + _jax_leaves(model._user_afm)
    if hasattr(model, "_inner"):
        return [model._inner]
    return [model]


@pytest.fixture(scope="module", params=SVDPP_MODELS)
def svdpp_pair(request, ratings):
    """The JAX model after one epoch, and the port model initialised from
    its tables (the port trains zero epochs)."""
    train, test = ratings
    name = request.param
    opts = "num_factors=4 learn_rate=0.01"
    jm = getattr(jsv, name)()
    jax_configure(jm, opts + " num_iter=1")
    tm = create_rating_predictor(name, opts + " num_iter=0 device=cpu")
    parts = [(train.users, train.items, train.values)]
    jm.ratings = JaxRatingData(*parts[0], num_users=train.num_users,
                               num_items=train.num_items)
    tm.ratings = RatingData(*parts[0], num_users=train.num_users,
                            num_items=train.num_items)
    jm.additional_feedback = tm.additional_feedback = (test.users, test.items)
    with pytest.MonkeyPatch.context() as mp:
        _jax_svdpp_f32_interpret(mp)
        jm.train()
        stash = [svdpp_tables_from_jax(leaf) for leaf in _jax_leaves(jm)]
        port_init = tsv.SVDPlusPlus.init_model
        mp.setattr(tsv.SVDPlusPlus, "init_model",
                   lambda self, tables=None: port_init(self, stash.pop(0)))
        tm.train()
        assert not stash
    return jm, tm, train


def test_svdpp_score_catalog_matches_jax(svdpp_pair):
    jm, tm, train = svdpp_pair
    users = np.arange(0, tm.num_users_trained, dtype=np.int32)
    got = tm.score_catalog(users)
    want = np.asarray(jm.score_catalog(users))
    assert got.shape == want.shape == (users.size, tm.num_items_trained)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.std() > 1e-3
    assert tm.tables_device() == torch.device("cpu")


def test_svdpp_recommend_matches_jax(svdpp_pair):
    jm, tm, _ = svdpp_pair
    for u, n, cand, ign in ((1, 5, None, None), (6, 12, range(60), [2, 3])):
        assert_same_list(tm.recommend(u, n, cand, ign),
                         jm.recommend(u, n, cand, ign))


def test_catalog_topk_untouched_on_the_cpu():
    assert catalog_topk.launches == 0
