"""Fold-in of the port (``eval/foldin.py``, ``score_items_foldin`` of the
MF and BPR families) against the JAX package on the same data, on the
CPU.

- The three protocols (true fold-in, complete retraining per user,
  incremental update per user) give the JAX results to 1e-5 for
  BiasedMatrixFactorization at ``init_stdev=0`` (a fresh row is then
  ``init_mean`` in both packages) and for UserItemBaseline. The JAX
  models train on their Pallas epoch in interpret mode with float32
  operands and the host epoch order, the route and order of the port's
  kernel epoch (as in tests/test_torch_mf.py); the true and incremental
  protocols start the port from the JAX tables.
- The BPR fold-in loop (``foldin_vector``), fed the JAX package's draws,
  gives its scores to 1e-5, and the model does not change.
"""

import numpy as np
import pytest

import jax

from mymedialite_tpu.data.synthetic import split_ratings, synthetic_ratings
from mymedialite_tpu.eval.foldin import (
    evaluate_fold_in as jax_fold_in,
    evaluate_fold_in_complete_retraining as jax_complete,
    evaluate_fold_in_incremental_training as jax_incremental,
)
from mymedialite_tpu.models.registry import (
    create_item_recommender as jax_create_item,
    create_rating_predictor as jax_create,
)
from mymedialite_tpu.utils.params import configure as jax_configure
from mymedialite_tpu_torch.convert import bpr_tables_from_jax, tables_from_jax
from mymedialite_tpu_torch.data.arrays import RatingData
from mymedialite_tpu_torch.eval.foldin import (
    evaluate_fold_in, evaluate_fold_in_complete_retraining,
    evaluate_fold_in_incremental_training,
)
from mymedialite_tpu_torch.models.registry import (
    create_item_recommender, create_rating_predictor,
)
from test_torch_incremental_item import jax_posonly, port_feedback
from test_torch_mf import jax_mode
from torch_threads import one_torch_thread  # noqa: F401

KEYS = ("RMSE", "MAE", "NMAE", "CBD")
MF_OPTS = "num_factors=6 num_iter=2 init_stdev=0"


@pytest.fixture(scope="module")
def foldin_data():
    """Training ratings, and 12 held-out users' ratings split 50/50 into
    the update and the evaluation part."""
    data = synthetic_ratings(num_ratings=6000, num_users=200, num_items=250,
                             seed=31)
    train, rest = split_ratings(data, test_fraction=0.3, seed=32)
    keep = np.isin(rest.users, np.unique(rest.users)[:12])
    rest = rest.select(np.nonzero(keep)[0])
    update, eval_ = split_ratings(rest, test_fraction=0.5, seed=33)
    return train, update, eval_


def port_data(d):
    return RatingData(d.users, d.items, d.values, num_users=d.num_users,
                      num_items=d.num_items, scale=d.scale)


def assert_results(got, ref):
    for k in KEYS:
        assert got[k] == pytest.approx(ref[k], abs=1e-5), (k, got, ref)


def trained_pair(name, opts, train, monkeypatch):
    jax_mode(monkeypatch)
    j = jax_create(name)
    j.ratings = train
    t = create_rating_predictor(name, (opts + " device=cpu").strip())
    t.ratings = port_data(train)
    if opts:
        jax_configure(j, opts + (" mxu_dtype=f32" if "num_factors" in opts
                                 else ""))
    j.train()
    if hasattr(t, "init_model"):
        t.init_model(tables=tables_from_jax(j))
    else:
        t.train()
    return j, t


def test_true_fold_in_biased_mf(foldin_data, monkeypatch):
    train, update, eval_ = foldin_data
    j, t = trained_pair("BiasedMatrixFactorization", MF_OPTS, train,
                        monkeypatch)
    W = t.W_ext.clone()
    assert_results(evaluate_fold_in(t, port_data(update), port_data(eval_)),
                   jax_fold_in(j, update, eval_))
    assert (t.W_ext == W).all()


@pytest.mark.parametrize("name,opts", [
    ("BiasedMatrixFactorization", MF_OPTS),
    ("UserItemBaseline", "")], ids=["biased-mf", "user-item-baseline"])
def test_complete_retraining(name, opts, foldin_data, monkeypatch):
    train, update, eval_ = foldin_data
    j, t = trained_pair(name, opts, train, monkeypatch)
    assert_results(evaluate_fold_in_complete_retraining(
        t, port_data(update), port_data(eval_)),
        jax_complete(j, update, eval_))


@pytest.mark.parametrize("name,opts", [
    ("BiasedMatrixFactorization", MF_OPTS),
    ("UserItemBaseline", "")], ids=["biased-mf", "user-item-baseline"])
def test_incremental_training(name, opts, foldin_data, monkeypatch):
    train, update, eval_ = foldin_data
    j, t = trained_pair(name, opts, train, monkeypatch)
    assert_results(evaluate_fold_in_incremental_training(
        t, port_data(update), port_data(eval_)),
        jax_incremental(j, update, eval_))
    assert len(t.ratings) == len(train)


def jax_foldin_draws(jm, accessed):
    """The draws the JAX BPRMF.score_items_foldin makes, from a copy of
    its key: the start vector and the numpy generator's ids."""
    pos_set = np.unique(np.asarray(accessed, dtype=np.int32))
    I = jm.params["item_factors"].shape[0]
    _, sub = jax.random.split(jm._key)
    vec = jm.init_mean + jm.init_stdev * np.asarray(jax.random.normal(
        sub, (jm.num_factors,), dtype=np.float32))
    rng = np.random.default_rng(int(jax.random.randint(sub, (), 0,
                                                       2 ** 31 - 1)))
    neg_pool = np.setdiff1d(np.arange(I, dtype=np.int32), pos_set)
    pos, neg = [], []
    for _ in range(jm.num_iter):
        pos.append(rng.choice(pos_set, size=pos_set.size))
        neg.append(rng.choice(neg_pool, size=pos_set.size))
    return vec.astype(np.float32), np.stack(pos), np.stack(neg)


def test_bpr_foldin_loop_matches_jax_on_its_draws():
    import torch
    fb = port_feedback(seed=8)
    jm = jax_create_item("BPRMF")
    jax_configure(jm, "num_factors=6 num_iter=4")
    jm.feedback = jax_posonly(fb)
    jm.train()
    tm = create_item_recommender("BPRMF", "num_factors=6 num_iter=4 "
                                 "device=cpu")
    tm.feedback = fb
    tm.init_model(tables=bpr_tables_from_jax(jm))
    accessed, cand = [3, 7, 7, 20, 41], [0, 1, 2, 3, 50, 60]
    vec, pos, neg = jax_foldin_draws(jm, accessed)
    ref = jm.score_items_foldin(accessed, cand)
    got_vec = tm.foldin_vector(torch.from_numpy(vec), pos, neg)
    p = tm.params
    c = torch.tensor(cand)
    got = (p["item_bias"][c] + p["item_factors"][c] @ got_vec).numpy()
    np.testing.assert_allclose(got, [s for _, s in ref], rtol=0, atol=1e-5)
    before = {k: v.clone() for k, v in tm.params.items()}
    scored = tm.score_items_foldin(accessed, cand)
    assert [i for i, _ in scored] == cand
    assert np.isfinite([s for _, s in scored]).all()
    assert all(torch.equal(before[k], v) for k, v in tm.params.items())
