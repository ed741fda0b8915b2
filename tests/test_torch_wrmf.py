"""WRMF of the port (``mymedialite_tpu_torch/models/wrmf.py``) against
the JAX package's on the same data, on the CPU.

The port starts from the JAX model's initial tables
(``convert.wrmf_tables_from_jax``; the two packages draw them from
different generators). After one alternation, and after three, the user
and item factors agree to 1e-4 relative to the largest entry; the length buckets hold the JAX package's rows and
histories; on equal tables the ranking measures agree to 1e-6 and the
top-n lists (kernel 6's plain route) exactly; model files pass between
the packages both ways with predictions equal to 1e-6, and a loaded
model trains on as the JAX one does.
"""

import numpy as np
import pytest

from mymedialite_tpu.data.arrays import PosOnlyData
from mymedialite_tpu.data.synthetic import split_posonly, synthetic_posonly
from mymedialite_tpu.eval.ranking import evaluate_items as jax_evaluate
from mymedialite_tpu.models.wrmf import WRMF as JaxWRMF
from mymedialite_tpu.ops.topk import recommend_batch as jax_recommend_batch
from mymedialite_tpu_torch.convert import wrmf_tables_from_jax
from mymedialite_tpu_torch.eval.ranking import evaluate_items
from mymedialite_tpu_torch.models.registry import create_item_recommender
from mymedialite_tpu_torch.ops import topk as ttopk
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-4
MEASURES = ("AUC", "MAP", "NDCG", "MRR", "prec@5", "recall@10")


@pytest.fixture(scope="module")
def data():
    """300 users x 400 items, 6,000 Zipf-popular events split 80/20: the
    item histories span four length buckets."""
    fb = synthetic_posonly(num_users=300, num_items=400, num_events=6000,
                           seed=5)
    return split_posonly(fb, seed=6)


def jax_model(train, num_iter=1, **hp):
    m = JaxWRMF()
    m.num_factors = 8
    m.num_iter = num_iter
    for k, v in hp.items():
        setattr(m, k, v)
    m.feedback = train
    m.init_model()
    return m


def port_model(train, tables, num_iter=1, opts=""):
    m = create_item_recommender(
        "WRMF", f"num_factors=8 num_iter={num_iter} device=cpu {opts}")
    m.feedback = train
    m.init_model(tables=tables)
    return m


def rel_err(a, b):
    b = np.asarray(b, np.float64)
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


@pytest.mark.parametrize("alternations", [1, 3])
def test_alternations_match_jax(alternations, data):
    train, _ = data
    j = jax_model(train, alpha=2.0, regularization=0.1)
    t = port_model(train, wrmf_tables_from_jax(j),
                   opts="alpha=2 regularization=0.1")
    for _ in range(alternations):
        j.iterate()
        t.iterate()
    for side in ("user_factors", "item_factors"):
        assert rel_err(t.params[side].numpy(), j.params[side]) <= REL, side


def test_buckets_hold_the_jax_histories(data):
    train, _ = data
    j = jax_model(train)
    t = port_model(train, wrmf_tables_from_jax(j), opts="solve_chunk=64")
    for jb, tb in ((j._user_hist, t._user_hist),
                   (j._item_hist, t._item_hist)):
        assert len(jb) == len(tb) >= 2
        for (rows, (hist, lens), _), (trows, thist, tlens, chunk) in zip(
                jb, tb):
            n = rows.size
            np.testing.assert_array_equal(trows.numpy(), rows)
            np.testing.assert_array_equal(tlens.numpy(), np.asarray(lens)[:n])
            np.testing.assert_array_equal(thist.numpy(),
                                          np.asarray(hist)[:n])
            assert chunk * thist.shape[1] <= t._GATHER_BUDGET
            assert chunk <= 64


def test_ranking_and_top_n_on_equal_tables(data, monkeypatch):
    train, test = data
    j = jax_model(train, num_iter=2)
    j.train()
    t = port_model(train, wrmf_tables_from_jax(j))
    want = jax_evaluate(j, test, train)
    got = evaluate_items(t, test, train)
    for key in MEASURES:
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    users = np.arange(train.num_users)
    j_ids, j_scores = jax_recommend_batch(j, users, 10, training=train)
    # kernel 6's route (its plain version on CPU tensors)
    monkeypatch.setattr(ttopk, "takes_topk_kernel", lambda *a: True)
    ids, scores = ttopk.recommend_batch(t, users, 10, training=train)
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    np.testing.assert_allclose(scores, np.asarray(j_scores), atol=1e-5)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_model_files_both_ways(direction, data, tmp_path):
    train, test = data
    j = jax_model(train, num_iter=2)
    j.train()
    t = port_model(train, wrmf_tables_from_jax(j))
    t.iterate()
    path = str(tmp_path / "wrmf.model")
    if direction == "jax_to_port":
        writer = j
        reader = create_item_recommender("WRMF", "device=cpu")
    else:
        writer, reader = t, JaxWRMF()
    writer.save_model(path)
    reader.feedback = train
    reader.load_model(path)
    np.testing.assert_allclose(
        reader.predict_batch(test.users, test.items),
        writer.predict_batch(test.users, test.items), atol=1e-6, rtol=0)


def test_loaded_model_trains_on(data, tmp_path):
    """After ``load_model`` the histories are rebuilt at the next
    ``iterate``, as in the JAX package; a larger feedback grows zero
    rows first."""
    train, _ = data
    j = jax_model(train)
    j.train()
    path = str(tmp_path / "wrmf.model")
    j.save_model(path)
    t = create_item_recommender("WRMF", "num_factors=8 device=cpu")
    bigger = PosOnlyData(np.append(train.users, 310),
                         np.append(train.items, 405))
    t.feedback = bigger
    t.load_model(path)
    t.iterate()
    j2 = JaxWRMF()
    j2.feedback = bigger
    j2.load_model(path)
    j2.iterate()
    assert t.params["user_factors"].shape == (311, 8)
    for side in ("user_factors", "item_factors"):
        assert rel_err(t.params[side].numpy(), j2.params[side]) <= REL, side


def test_incremental_api_runs_as_in_jax(data):
    """retrain_user / retrain_item re-solve one row each, as the JAX
    model's (the add_feedback parity is in
    tests/test_torch_incremental_item.py)."""
    train, _ = data
    j = jax_model(train, num_iter=1)
    t = port_model(train, wrmf_tables_from_jax(j))
    for m in (j, t):
        m.retrain_user(3)
        m.retrain_item(4)
    for side in ("user_factors", "item_factors"):
        np.testing.assert_allclose(t.params[side].numpy(), j.params[side],
                                   rtol=0, atol=1e-5)
