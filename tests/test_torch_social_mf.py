"""The port's SocialMF (``mymedialite_tpu_torch/models/social_mf.py``)
against the JAX package's, on the CPU: five full-batch steps from the
same tables (``convert.tables_from_jax``) within 1e-5, the user space
grown for users known only from the trust relation, the sparse trust
matrices against the JAX package's dense one, and no kernel plan."""

import numpy as np
import pytest
import torch

from mymedialite_tpu.data.arrays import PosOnlyData as JPosOnly
from mymedialite_tpu.data.synthetic import split_ratings as j_split
from mymedialite_tpu.data.synthetic import synthetic_ratings as j_synth
from mymedialite_tpu.models.mf import OptimizationTarget as JTarget
from mymedialite_tpu.models.social_mf import SocialMF as JSocialMF
from mymedialite_tpu_torch import convert
from mymedialite_tpu_torch.data.arrays import PosOnlyData
from mymedialite_tpu_torch.data.synthetic import (
    split_ratings, synthetic_ratings,
)
from mymedialite_tpu_torch.eval.rating import evaluate_ratings
from mymedialite_tpu_torch.models import social_mf as tsm
from mymedialite_tpu_torch.models.mf import OptimizationTarget as TTarget
from mymedialite_tpu_torch.models.registry import create_rating_predictor
from mymedialite_tpu_torch.ops.sgd_epoch import sgd_epoch

TOL = 1e-5
SHAPE = dict(num_users=120, num_items=90, num_ratings=3000, seed=8)
OPTS = dict(num_factors=6, learn_rate=0.002, social_regularization=0.5,
            group_users=256)


def trust_edges(num_users, extra_users=0, seed=3):
    """Each user trusts 4 others; ``extra_users`` users past the ratings
    trust and are trusted too; a duplicated edge and a self-loop."""
    rng = np.random.default_rng(seed)
    n = num_users + extra_users
    u = np.repeat(np.arange(n), 4)
    v = rng.integers(0, n, u.size)
    u = np.concatenate([u, [1, 2]])
    v = np.concatenate([v, [v[4], 2]])
    return u.astype(np.int32), v.astype(np.int32), n


def configure_both(j, t, **opts):
    for k, v in opts.items():
        setattr(j, k, v)
        setattr(t, k, v)


@pytest.fixture(scope="module")
def data():
    return (split_ratings(synthetic_ratings(**SHAPE), 0.2, seed=1)
            + j_split(j_synth(**SHAPE), 0.2, seed=1))


def pair(data, extra_users=0, steps=5, loss=None, **opts):
    train, _, jtrain, _ = data
    u, v, n = trust_edges(train.num_users, extra_users)
    j = JSocialMF()
    t = create_rating_predictor("SocialMF", "device=cpu")
    configure_both(j, t, **dict(OPTS, **opts))
    if loss is not None:
        j.loss, t.loss = JTarget(loss), TTarget(loss)
    j.user_relation = JPosOnly(u, v, num_users=n, num_items=n)
    t.user_relation = PosOnlyData(u, v, num_users=n, num_items=n)
    j.ratings, t.ratings = jtrain, train
    j.init_model()
    t.init_model(tables=convert.tables_from_jax(j))
    for _ in range(steps):
        j.iterate()
        t.iterate()
    return j, t


@pytest.mark.parametrize("opts", [
    {}, {"loss": "MAE"}, {"bias_reg": 0.1, "bias_learn_rate": 0.5,
                          "learn_rate_decay": 0.9}],
    ids=["rmse", "mae", "bias-and-decay"])
def test_five_steps_match_jax(data, opts):
    j, t = pair(data, **opts)
    np.testing.assert_allclose(t.W_ext.numpy(), np.asarray(j.W_ext),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(t.H_ext.numpy(), np.asarray(j.H_ext),
                               rtol=0, atol=TOL)
    assert t.current_learnrate == pytest.approx(j.current_learnrate)


def test_relation_only_users_grow_the_user_space(data):
    train, test, _, jtest = data
    j, t = pair(data, extra_users=7)
    n = train.num_users + 7
    assert t.num_users_trained == j.num_users_trained == n
    assert t.ratings.num_users == n
    W = t.W_ext.numpy()
    f = t.num_factors
    # the new users start at zero (no ratings) and the social term moves
    # them toward the users they trust
    assert np.abs(W[train.num_users:n, :f]).max() > 0
    np.testing.assert_allclose(W, np.asarray(j.W_ext), rtol=0, atol=TOL)
    np.testing.assert_allclose(t.predict_batch(test.users, test.items),
                               j.predict_batch(jtest.users, jtest.items),
                               rtol=0, atol=TOL)


def test_sparse_trust_equals_the_dense_matrix(data):
    train = data[0]
    u, v, n = trust_edges(train.num_users, extra_users=3)
    j = JSocialMF()
    j.user_relation = JPosOnly(u, v, num_users=n, num_items=n)
    dense = j._trust_matrix(n)
    T, Tt, has_conn = tsm.trust_matrices(u, v, n, "cpu")
    np.testing.assert_array_equal(T.to_dense().numpy(), dense)
    np.testing.assert_array_equal(Tt.to_dense().numpy(), dense.T)
    np.testing.assert_array_equal(has_conn.numpy(),
                                  (dense.sum(axis=1) > 0).astype(np.float32))
    P = np.random.default_rng(0).normal(size=(n, 5)).astype(np.float32)
    np.testing.assert_allclose(torch.sparse.mm(T, torch.from_numpy(P)),
                               dense @ P, rtol=0, atol=1e-6)
    np.testing.assert_allclose(torch.sparse.mm(Tt, torch.from_numpy(P)),
                               dense.T @ P, rtol=0, atol=1e-6)


def test_trains_on_its_own_step_and_beats_the_average(data):
    train, test = data[:2]
    u, v, n = trust_edges(train.num_users)
    t = create_rating_predictor(
        "SocialMF", "num_factors=6 num_iter=60 learn_rate=0.002 "
        "social_regularization=0.5 device=cpu")
    t.user_relation = PosOnlyData(u, v, num_users=n, num_items=n)
    t.ratings = train
    before = sgd_epoch.launches
    t.train()
    assert sgd_epoch.launches == before and t._plan is None
    rmse = evaluate_ratings(t, test)["RMSE"]
    assert rmse < np.sqrt(np.mean((test.values - train.values.mean()) ** 2))


def test_step_in_float64_stays_near_float32(data):
    """The chip check's witness: one step in float64 from the same
    tables within 1e-5 of the float32 step."""
    _, t = pair(data, steps=0)
    data32, _ = t._flat_data()
    hp = t._hp()
    kw = dict(num_users=t.num_users_trained, num_factors=t.num_factors,
              loss=t.loss_id)
    t._ensure_epoch_ready()
    rel = t.user_relation
    trust64 = tsm.trust_matrices(rel.users, rel.items, t.num_users_trained,
                                 "cpu", dtype=torch.float64)
    W32, H32 = tsm.social_mf_step(t.W_ext, t.H_ext, data32, t._trust, hp,
                                  **kw)
    W64, H64 = tsm.social_mf_step(t.W_ext.double(), t.H_ext.double(), data32,
                                  trust64, hp, **kw)
    np.testing.assert_allclose(W32.numpy(), W64.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(H32.numpy(), H64.numpy(), rtol=0, atol=TOL)


def test_save_load_and_continue(data, tmp_path):
    train, test = data[:2]
    _, t = pair(data, steps=2)
    path = str(tmp_path / "s.model")
    t.save_model(path)
    t2 = create_rating_predictor("SocialMF", "device=cpu")
    t2.user_relation = t.user_relation
    t2.load_model(path)
    np.testing.assert_array_equal(t2.predict_batch(test.users, test.items),
                                  t.predict_batch(test.users, test.items))
    t2.ratings = train
    t2.iterate()
    assert torch.isfinite(t2.W_ext).all()


# the JAX package's SocialMF cases (tests/test_slim_social.py), on the port

def test_smoke_without_relation():
    train, _ = split_ratings(synthetic_ratings(num_ratings=3000,
                                               num_users=100, num_items=120,
                                               seed=9))
    m = create_rating_predictor("SocialMF", "num_iter=5 learn_rate=0.01 "
                                "device=cpu")
    m.ratings = train
    m.train()
    assert np.isfinite(m.predict(0, 0))


def test_social_pull():
    """A ring of trust: full-batch steps with the social term still beat
    the global average."""
    from mymedialite_tpu_torch.data.arrays import InteractionData
    train, test = split_ratings(synthetic_ratings(num_ratings=3000,
                                                  num_users=100,
                                                  num_items=120, seed=10))
    m = create_rating_predictor("SocialMF", "num_iter=100 learn_rate=0.01 "
                                "social_regularization=1 device=cpu")
    m.ratings = train
    users = np.arange(100)
    m.user_relation = InteractionData(users, (users + 1) % 100)
    m.train()
    ga = create_rating_predictor("GlobalAverage", "device=cpu")
    ga.ratings = train
    ga.train()
    assert evaluate_ratings(m, test)["RMSE"] < \
        evaluate_ratings(ga, test)["RMSE"]
