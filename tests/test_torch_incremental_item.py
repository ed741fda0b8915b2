"""The incremental item API of the port (``models/base.py``
``IncrementalItemRecommender``, the retrains of ``models/{bpr, wrmf,
item_baselines, knn}.py``, ``ops/als.py wrmf_solve_row``) against the
JAX package on the same inputs, on the CPU.

- ``ops.bpr.bpr_step`` with chosen sides, on the same triples (duplicates
  included) equals the JAX ``BPRMF._pairwise_updates`` to 1e-6, for the
  user, the positive and the negative side.
- A BPRMF ``add_feedback`` grows the tables (new rows N(init_mean,
  init_stdev) in distribution over 8,192 draws, new biases 0), reads
  each touched user's items from the sampling state on the device
  (never ``data/arrays.build_csr``), moves only the touched user rows,
  and the next iterate() plans on the grown feedback.
- ``wrmf_solve_row`` equals the JAX one to 1e-5; a WRMF ``add_feedback``
  from the same tables re-solves the touched rows as the JAX one does
  (1e-5) and leaves every other row bit-unchanged.
- MostPopular's and the implicit KNNs' retrains are full retrains.
"""

import numpy as np
import pytest
import torch

from mymedialite_tpu.data.arrays import PosOnlyData as JaxPosOnly
from mymedialite_tpu.models.registry import (
    create_item_recommender as jax_create,
)
from mymedialite_tpu.ops.als import wrmf_solve_row as jax_solve_row
from mymedialite_tpu.utils.params import configure as jax_configure
from mymedialite_tpu_torch.convert import (
    bpr_tables_from_jax, wrmf_tables_from_jax,
)
from mymedialite_tpu_torch.data import arrays
from mymedialite_tpu_torch.data.synthetic import (
    posonly_from_ratings, split_posonly, synthetic_ratings,
)
from mymedialite_tpu_torch.models.registry import create_item_recommender
from mymedialite_tpu_torch.ops import bpr as bpr_ops
from mymedialite_tpu_torch.ops.als import wrmf_solve_row
from torch_threads import one_torch_thread  # noqa: F401


def port_feedback(seed=4, num_users=150, num_items=120, num_ratings=4000):
    return posonly_from_ratings(synthetic_ratings(
        num_users=num_users, num_items=num_items, num_ratings=num_ratings,
        seed=seed))


def jax_posonly(d):
    return JaxPosOnly(d.users, d.items, num_users=d.num_users,
                      num_items=d.num_items)


@pytest.fixture(scope="module")
def data():
    return split_posonly(port_feedback(), seed=5)


def bpr_pair(train, opts="num_factors=6 num_iter=2"):
    jm = jax_create("BPRMF")
    jax_configure(jm, opts)
    jm.feedback = jax_posonly(train)
    jm.train()
    tm = create_item_recommender("BPRMF", opts + " device=cpu")
    tm.feedback = train
    tm.init_model(tables=bpr_tables_from_jax(jm))
    return jm, tm


@pytest.mark.parametrize("sides", [(True, False, False), (False, True, False),
                                   (False, False, True), (True, True, True)],
                         ids=["u", "i", "j", "all"])
def test_pairwise_updates_match_jax(sides, data):
    train, _ = data
    jm, tm = bpr_pair(train)
    jm.bias_reg = tm.bias_reg = 0.05
    rng = np.random.default_rng(3)
    n = 64
    u = rng.integers(0, 150, n)
    u[:8] = 5                                    # duplicate users
    i = rng.integers(0, 120, n)
    j = rng.integers(0, 120, n)
    i[8:12] = j[12:16] = 7                       # an item on both sides
    w = (rng.random(n) > 0.2).astype(np.float32)
    jm._pairwise_updates(u, i, j, w, *sides)
    p = tm.params
    bpr_ops.bpr_step(
        p, *(torch.from_numpy(a.astype(np.int64)) for a in (u, i, j)),
        torch.from_numpy(w), tm._hp(), update_u=sides[0],
        update_i=sides[1], update_j=sides[2])
    ref = bpr_tables_from_jax(jm)
    for k in ("user_factors", "item_factors", "item_bias"):
        np.testing.assert_allclose(p[k].numpy(), ref[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_add_feedback_reads_the_sampling_state_not_a_host_csr(data,
                                                              monkeypatch):
    train, test = data
    tm = create_item_recommender("BPRMF", "num_factors=6 num_iter=2 "
                                 "device=cpu")
    tm.feedback = train
    tm.train()
    u = int(test.users[0])
    new = test.items[test.users == u]
    expect_items = np.sort(np.concatenate([train.items_by_user(u), new]))
    before = {k: v.clone() for k, v in tm.params.items()}

    def no_csr(*a, **k):
        raise AssertionError("build_csr called during add_feedback")
    monkeypatch.setattr(arrays, "build_csr", no_csr)
    tm.add_feedback(np.full(new.size, u), new)
    sampler = tm._sampling[0]
    lo, hi = sampler["indptr"][u:u + 2].tolist()
    np.testing.assert_array_equal(sampler["hist_items"][lo:hi].numpy(),
                                  expect_items)
    p = tm.params
    moved = (p["user_factors"] != before["user_factors"]).any(dim=1)
    assert moved.nonzero().flatten().tolist() == [u]
    for k in ("item_factors", "item_bias"):
        assert torch.equal(p[k], before[k])
    monkeypatch.undo()
    assert tm._plan is None and tm._fused is None
    tm.iterate()
    assert tm._plan is not None
    assert int(tm._plan.packed.shape[0]) > 0


def test_retrain_item_moves_only_that_item(data):
    train, _ = data
    tm = create_item_recommender("BPRMF", "num_factors=6 num_iter=2 "
                                 "device=cpu")
    tm.feedback = train
    tm.train()
    tm.update_users, tm.update_items = False, True
    before = {k: v.clone() for k, v in tm.params.items()}
    tm.add_feedback([3], [9])
    p = tm.params
    assert torch.equal(p["user_factors"], before["user_factors"])
    moved = (p["item_factors"] != before["item_factors"]).any(dim=1)
    assert 9 in moved.nonzero().flatten().tolist()
    assert torch.isfinite(p["item_factors"]).all()


def test_loaded_bprmf_grows_its_tables(tmp_path):
    """A loaded model given feedback with 1,024 more users and 64 more
    items grows its tables: new factor rows N(init_mean, init_stdev) over
    8,192 and 512 draws, new biases 0, old rows unchanged."""
    small = port_feedback(seed=9, num_users=100, num_items=80,
                          num_ratings=2000)
    tm = create_item_recommender("BPRMF", "num_factors=8 num_iter=1 "
                                 "device=cpu")
    tm.feedback = small
    tm.train()
    path = str(tmp_path / "bpr.model")
    tm.save_model(path)
    big = port_feedback(seed=10, num_users=1124, num_items=144,
                        num_ratings=20000)
    m = create_item_recommender("BPRMF", "num_factors=8 num_iter=1 "
                                "init_mean=0.5 init_stdev=0.2 device=cpu")
    m.feedback = big
    m.load_model(path)
    m.feedback = big
    old = {k: v.clone() for k, v in m.params.items()}
    m.add_feedback([big.num_users - 1], [0])
    p = m.params
    assert p["user_factors"].shape == (big.num_users, 8)
    assert p["item_factors"].shape == (big.num_items, 8)
    assert m.num_users_trained == big.num_users
    new_u = p["user_factors"][100:-1].flatten().double()
    assert new_u.numel() >= 4096
    assert abs(new_u.mean().item() - 0.5) < 4 * 0.2 / new_u.numel() ** 0.5
    assert abs(new_u.std().item() / 0.2 - 1) < 0.05
    new_i = p["item_factors"][80:].flatten().double()
    assert abs(new_i.mean().item() - 0.5) < 4 * 0.2 / new_i.numel() ** 0.5
    assert abs(new_i.std().item() / 0.2 - 1) < 0.15
    assert (p["item_bias"][80:] == 0).all()
    assert torch.equal(p["user_factors"][:100], old["user_factors"][:100])
    m.iterate()
    assert torch.isfinite(m.params["user_factors"]).all()


def test_wrmf_solve_row_matches_jax():
    rng = np.random.default_rng(2)
    H = rng.standard_normal((90, 8)).astype(np.float32)
    for ids in (np.array([3, 5, 5, 80, 11]), np.arange(40),
                np.array([], np.int64)):
        ref = np.asarray(jax_solve_row(H, ids, np.float32(2.0),
                                       np.float32(0.1)))
        got = wrmf_solve_row(torch.from_numpy(H), ids, 2.0, 0.1).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_wrmf_add_feedback_resolves_only_touched_rows(data):
    train, _ = data
    jm = jax_create("WRMF")
    jax_configure(jm, "num_factors=8 num_iter=2")
    jm.feedback = jax_posonly(train)
    jm.train()
    tm = create_item_recommender("WRMF", "num_factors=8 num_iter=2 "
                                 "device=cpu")
    tm.feedback = train
    tm.init_model(tables=wrmf_tables_from_jax(jm))
    for m in (jm, tm):
        m.update_users = m.update_items = True
    before = {k: v.clone() for k, v in tm.params.items()}
    u, i = [5, 150], [7, 120]                      # a new user, a new item
    jm.add_feedback(u, i)
    tm.add_feedback(u, i)
    ref = wrmf_tables_from_jax(jm)
    p = tm.params
    for side, rows in (("user_factors", u), ("item_factors", i)):
        np.testing.assert_allclose(p[side].numpy(), ref[side], rtol=0,
                                   atol=1e-5)
        keep = torch.ones(p[side].shape[0], dtype=torch.bool)
        keep[rows] = False
        old = before[side]
        assert torch.equal(p[side][:old.shape[0]][keep[:old.shape[0]]],
                           old[keep[:old.shape[0]]])
    tm.iterate()
    assert torch.isfinite(tm.params["user_factors"]).all()


def test_wrmf_updates_nothing_by_default(data):
    """update_users / update_items default to False on WRMF, as in the
    JAX package (IncrementalItemRecommender's C# defaults): the tables
    only grow."""
    train, _ = data
    tm = create_item_recommender("WRMF", "num_factors=4 num_iter=1 "
                                 "device=cpu")
    tm.feedback = train
    tm.train()
    before = tm.params["user_factors"].clone()
    tm.add_feedback([5], [7])
    assert torch.equal(tm.params["user_factors"], before)


def test_most_popular_retrain_recounts(data):
    train, test = data
    t = create_item_recommender("MostPopular")
    t.feedback = train
    t.train()
    t.add_feedback(test.users[:50], test.items[:50])
    t.remove_feedback(test.users[:5], test.items[:5])
    fresh = create_item_recommender("MostPopular")
    fresh.feedback = t.feedback
    fresh.train()
    np.testing.assert_array_equal(t.view_count, fresh.view_count)


@pytest.mark.parametrize("name", ["UserKNN", "ItemKNN"])
def test_implicit_knn_retrain_is_a_full_train(name, data):
    train, test = data
    t = create_item_recommender(name, "k=10 device=cpu")
    t.feedback = train
    t.train()
    t.add_feedback(test.users[:20], test.items[:20])
    fresh = create_item_recommender(name, "k=10 device=cpu")
    fresh.feedback = t.feedback
    fresh.train()
    users = np.arange(20)
    np.testing.assert_array_equal(t.score_catalog(users),
                                  fresh.score_catalog(users))


@pytest.mark.parametrize("name", ["BPRMF", "WeightedBPRMF", "WRMF",
                                  "MostPopular", "ItemKNN"])
def test_removals_run_as_in_jax(name, data):
    """remove_feedback, remove_user and remove_item shrink the feedback
    as the JAX models' do and leave finite scores."""
    train, _ = data
    opts = {"MostPopular": "", "ItemKNN": "k=10 device=cpu"}.get(
        name, "num_factors=4 num_iter=1 device=cpu")
    t = create_item_recommender(name, opts)
    j = jax_create(name)
    if opts:
        jax_configure(j, opts.replace(" device=cpu", "").replace(
            "device=cpu", ""))
    t.feedback, j.feedback = train, jax_posonly(train)
    t.train()
    j.train()
    u, i = int(train.users[0]), int(train.items[0])
    for m in (t, j):
        m.update_users = m.update_items = True
        m.remove_feedback([u], [i])
        m.remove_user(int(train.users[1]))
        m.remove_item(int(train.items[2]))
    assert len(t.feedback) == len(j.feedback)
    assert np.isfinite(t.score_catalog(np.arange(10))).all()
