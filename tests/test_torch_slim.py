"""The port's SLIM models (``mymedialite_tpu_torch/models/slim.py``)
against the JAX package's, on the CPU: the co-occurrence C and the
column counts exactly; three LeastSquareSLIM sweeps on the same C and
feature mask within 1e-5; the port's own mask on the rows whose k-th
neighbour is not tied; a BPRSLIM epoch fed the JAX package's triples
from the same W within 1e-5; catalog scores within 1e-5; model files
both ways; and the JAX package's own SLIM cases
(tests/test_slim_social.py) on the port."""

import jax
import numpy as np
import pytest
import torch

from mymedialite_tpu.data.synthetic import split_posonly as j_split
from mymedialite_tpu.data.synthetic import synthetic_posonly as j_synth
from mymedialite_tpu.models import slim as jslim
from mymedialite_tpu.ops import bpr as jbpr
from mymedialite_tpu_torch import convert
from mymedialite_tpu_torch.data.synthetic import (
    split_posonly, synthetic_posonly,
)
from mymedialite_tpu_torch.eval.ranking import evaluate_items
from mymedialite_tpu_torch.models import slim as tslim
from mymedialite_tpu_torch.models.registry import create_item_recommender
from mymedialite_tpu_torch.ops.bpr_epoch import bpr_epoch
from mymedialite_tpu_torch.ops.catalog_topk import catalog_topk

TOL = 1e-5
SHAPE = dict(num_users=160, num_items=110, num_events=3500, seed=11)


@pytest.fixture(scope="module")
def data():
    """(port train, port test, JAX train, JAX test)."""
    return (split_posonly(synthetic_posonly(**SHAPE), seed=12)
            + j_split(j_synth(**SHAPE), seed=12))


def test_synthetic_posonly_matches_jax(data):
    a, b = synthetic_posonly(**SHAPE), j_synth(**SHAPE)
    np.testing.assert_array_equal(a.users, b.users)
    np.testing.assert_array_equal(a.items, b.items)
    assert (a.num_users, a.num_items) == (b.num_users, b.num_items)


def ls_pair(data, **opts):
    train, _, jtrain, _ = data
    j = jslim.LeastSquareSLIM()
    t = create_item_recommender("LeastSquareSLIM", "device=cpu")
    for k, v in opts.items():
        setattr(j, k, v)
        setattr(t, k, v)
    j.feedback, t.feedback = jtrain, train
    j.init_model()
    t.init_model()
    return j, t


def test_cooccurrence_and_counts_equal_jax_exactly(data):
    j, t = ls_pair(data)
    np.testing.assert_array_equal(t._C.numpy(), np.asarray(j._C))
    np.testing.assert_array_equal(t._cj.numpy(), np.asarray(j._cj))
    # a pair listed twice counts once
    train = data[0]
    doubled = train.add(train.users[:50], train.items[:50])
    C, _ = tslim.cooccurrence(doubled, "cpu")
    np.testing.assert_array_equal(C.numpy(), t._C.numpy())


@pytest.mark.parametrize("opts", [{}, {"reg_l1": 0.0001, "k": 20},
                                  {"k": 0}], ids=["default", "tuned", "k0"])
def test_three_sweeps_on_the_jax_mask(data, opts):
    j, t = ls_pair(data, **opts)
    t._mask = torch.from_numpy(np.array(j._mask))
    for _ in range(3):
        j.iterate()
        t.iterate()
    np.testing.assert_allclose(t.W.numpy(), np.asarray(j.W), rtol=0,
                               atol=TOL)
    assert np.abs(np.asarray(j.W)).max() > 0


def test_mask_matches_jax_where_the_kth_neighbour_is_not_tied(data):
    train = data[0]
    k = 10
    j, t = ls_pair(data, k=k)
    M = np.zeros((train.num_users, train.num_items))
    M[train.users, train.items] = 1.0
    ov = M.T @ M
    cnt = np.diag(ov)
    cos = ov / np.sqrt(np.maximum(np.outer(cnt, cnt), 1e-300))
    np.fill_diagonal(cos, -np.inf)
    srt = -np.sort(-cos, axis=1)
    untied = np.abs(srt[:, k - 1] - srt[:, k]) > 1e-6
    assert untied.sum() > train.num_items // 4
    np.testing.assert_array_equal(t._mask.numpy()[untied],
                                  np.asarray(j._mask)[untied])
    assert (t._mask.sum(dim=1) == k).all()


def jax_triples(key, sampler, meta, B, nb, regime):
    out = []
    for b in range(nb):
        u, i, j, w = jbpr._sample_triples(jax.random.fold_in(key, b),
                                          sampler, meta, B, regime)
        out.append(tuple(torch.from_numpy(np.asarray(a).astype(
            np.float32 if a is w else np.int64)) for a in (u, i, j, w)))
    return out


@pytest.mark.parametrize("update_j", [True, False])
def test_bpr_epoch_on_the_jax_triples(data, update_j):
    train, _, jtrain, _ = data
    j = jslim.BPRSLIM()
    j.feedback = jtrain
    j.update_j = update_j
    j.init_model()
    W0 = np.asarray(j.W).copy()
    B = 256
    meta = j._meta
    nb = -(-meta["num_events"] // B)
    key = jax.random.PRNGKey(5)
    regime = jbpr.UNIFORM_USER
    W_jax = jslim._bpr_slim_epoch(
        j.W, j._sampler, j._hist, j._lens, key, np.float32(j.learn_rate),
        np.float32(j.reg_i), np.float32(j.reg_j), batch_size=B,
        num_batches=nb, meta_static=tuple(sorted(meta.items())),
        regime=regime, update_j=update_j)
    t = create_item_recommender("BPRSLIM", "device=cpu")
    t.feedback = train
    t.update_j = update_j
    t.init_model(tables=convert.slim_state_from_jax(W0))
    hist, lens = t._history()
    np.testing.assert_array_equal(hist.numpy(), np.asarray(j._hist))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(j._lens))
    for triple in jax_triples(key, j._sampler, meta, B, nb, regime):
        t.step(*triple)
    np.testing.assert_allclose(t.W.numpy(), np.asarray(W_jax), rtol=0,
                               atol=TOL)
    assert np.abs(t.W.numpy() - W0).max() > 1e-3


def test_step_sums_duplicates_and_skips_the_own_column():
    """Two triples on the same (i, k) cells add; the i-row skips k = i,
    the j-row k = j; both read the starting W; an item listed twice in a
    history counts once."""
    I = 5
    W = torch.arange(I * I, dtype=torch.float64).reshape(I, I) / 100
    W.fill_diagonal_(0.0)
    hist = torch.tensor([[0, 1, 1, 3], [2, -1, -1, -1]], dtype=torch.int32)
    lens = torch.tensor([4, 1])
    u, i, j = torch.tensor([0, 0]), torch.tensor([1, 1]), torch.tensor([4, 4])
    w = torch.ones(2)
    start = W.clone()
    tslim.bpr_slim_step(W, hist, lens, u, i, j, w, 0.1, 0.01, 0.02,
                        update_j=True)
    ref = start.clone()
    ks = [0, 1, 3]
    x = sum(start[1, k] - start[4, k] for k in ks)
    g = torch.sigmoid(-x)
    for _ in range(2):
        for k in ks:
            if k != 1:
                ref[1, k] += 0.1 * (g - 0.01 * start[1, k])
            ref[4, k] += 0.1 * (-g - 0.02 * start[4, k])
    np.testing.assert_allclose(W.numpy(), ref.numpy(), rtol=0, atol=1e-12)


def test_catalog_scores_match_jax(data):
    train, _, jtrain, _ = data
    j, t = ls_pair(data, reg_l1=0.0001)
    t._mask = torch.from_numpy(np.array(j._mask))
    for _ in range(2):
        j.iterate()
        t.iterate()
    users = np.array([0, 3, 7, train.num_users - 1, 50])
    np.testing.assert_allclose(t.score_catalog(users),
                               j.score_catalog(users), rtol=0, atol=TOL)
    items = np.array([1, 2, 3, 200, 4])
    np.testing.assert_allclose(t.predict_batch(users, items),
                               j.predict_batch(users, items), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("name", ["LeastSquareSLIM", "BPRSLIM"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_model_files_across_packages(data, name, direction, tmp_path):
    train, _, jtrain, _ = data
    j = getattr(jslim, name)()
    j.feedback, j.num_iter = jtrain, 1
    j.train()
    t = create_item_recommender(name, "num_iter=1 device=cpu")
    t.feedback = train
    t.train()
    path = str(tmp_path / "slim.model")
    users = np.arange(20)
    if direction == "port_to_jax":
        t.save_model(path)
        other = getattr(jslim, name)()
        other.feedback = jtrain
        ref = t
    else:
        j.save_model(path)
        other = create_item_recommender(name, "device=cpu")
        other.feedback = train
        ref = j
    other.load_model(path)
    np.testing.assert_allclose(other.score_catalog(users),
                               ref.score_catalog(users), rtol=0, atol=1e-5)


def test_no_kernel_runs_and_retrain_is_full(data):
    train, _ = data[:2]
    t = create_item_recommender("BPRSLIM", "num_iter=1 device=cpu")
    t.feedback = train
    before = (bpr_epoch.launches, catalog_topk.launches)
    t.train()
    assert t.history_bytes == t._score_hist[0].numel() * 4
    W1 = t.W.clone()
    t.add_feedback([0, 1], [5, 6])
    assert not torch.equal(W1, t.W)
    assert (bpr_epoch.launches, catalog_topk.launches) == before


# the JAX package's SLIM cases (tests/test_slim_social.py), on the port

@pytest.fixture(scope="module")
def implicit_ml_like():
    return split_posonly(synthetic_posonly(num_events=15000, num_users=400,
                                           num_items=600, seed=11), seed=12)


def _random_auc(train, test):
    rnd = create_item_recommender("Random")
    rnd.feedback = train
    rnd.train()
    return evaluate_items(rnd, test, train)["AUC"]


class TestLeastSquareSLIM:
    def test_learns(self, implicit_ml_like):
        train, test = implicit_ml_like
        m = create_item_recommender("LeastSquareSLIM", "num_iter=10 "
                                    "device=cpu")
        m.feedback = train
        m.train()
        res = evaluate_items(m, test, train)
        assert res["AUC"] > _random_auc(train, test) + 0.1

    def test_diag_zero_and_sparse(self, implicit_ml_like):
        train, _ = implicit_ml_like
        m = create_item_recommender("LeastSquareSLIM", "num_iter=3 k=10 "
                                    "device=cpu")
        m.feedback = train
        m.train()
        W = m.W.numpy()
        assert np.allclose(np.diag(W), 0.0)
        assert (np.count_nonzero(W, axis=1) <= 10).all()

    def test_save_load(self, implicit_ml_like, tmp_path):
        train, _ = implicit_ml_like
        m = create_item_recommender("LeastSquareSLIM", "num_iter=2 "
                                    "device=cpu")
        m.feedback = train
        m.train()
        users, items = np.array([0, 1, 2]), np.array([0, 1, 2])
        before = m.predict_batch(users, items)
        p = str(tmp_path / "slim.model")
        m.save_model(p)
        m2 = create_item_recommender("LeastSquareSLIM", "device=cpu")
        m2.feedback = train
        m2.load_model(p)
        np.testing.assert_allclose(before, m2.predict_batch(users, items),
                                   atol=1e-5)


class TestBPRSLIM:
    def test_smoke_and_learns(self, implicit_ml_like):
        train, test = implicit_ml_like
        m = create_item_recommender("BPRSLIM", "num_iter=10 batch_size=512 "
                                    "device=cpu")
        m.feedback = train
        m.train()
        res = evaluate_items(m, test, train)
        assert res["AUC"] > _random_auc(train, test) + 0.05
