"""The item-recommendation slice of the port (``mymedialite_tpu_torch``:
models/bpr.py + models/item_baselines.py + eval/ranking.py) against the
JAX package on the same data, on the CPU.

The JAX models run their Pallas BPR epoch in interpret mode with
float32 operands (``MML_MXU=interpret``, ``mxu_dtype=f32``). The port
starts from the JAX tables after ``init_model``
(``convert.bpr_tables_from_jax``) and takes the JAX package's random
bits for each epoch in place of its own ``torch.Generator`` draws (the
two generators give other bits from the same seed). After 3 epochs the
tables agree to 1e-4; on equal tables the ranking measures agree to
1e-6, the objective to 1e-6 relative and the top-n lists exactly; model
files pass between the
packages with predictions equal to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax

from mymedialite_tpu.data.synthetic import split_posonly, synthetic_posonly
from mymedialite_tpu.eval.ranking import evaluate_items as jax_evaluate
from mymedialite_tpu.models import bpr as jbpr
from mymedialite_tpu.models import item_baselines as jbase
from mymedialite_tpu.ops import pallas_bpr as pb
from mymedialite_tpu.ops.topk import recommend_batch as jax_recommend_batch
from mymedialite_tpu.utils.params import configure
from mymedialite_tpu_torch.convert import bpr_tables_from_jax
from mymedialite_tpu_torch.eval.ranking import evaluate_items
from mymedialite_tpu_torch.models import bpr as tbpr
from mymedialite_tpu_torch.models.registry import create_item_recommender
from mymedialite_tpu_torch.ops import plan as tplan
from mymedialite_tpu_torch.ops.bpr_epoch import bpr_epoch
from mymedialite_tpu_torch.ops.topk import recommend_batch
from torch_threads import one_torch_thread  # noqa: F401

MEASURES = ("AUC", "MAP", "NDCG", "MRR", "prec@5", "prec@10", "recall@5",
            "recall@10")
MODELS = ["BPRMF", "WeightedBPRMF", "SoftMarginRankingMF"]
OPTS = "num_factors=8 num_iter=3"


@pytest.fixture(scope="module")
def data():
    """1,200 users x 1,500 items (three user blocks, two item blocks of
    the models' plan), 12k events split 80/20."""
    fb = synthetic_posonly(num_users=1200, num_items=1500, num_events=12000,
                           seed=5)
    return split_posonly(fb, seed=6)


def jax_bits(seed, nc, trials, C):
    """The JAX model's epoch bits for this epoch seed, as a tensor."""
    key = jax.random.key(seed & 0x7FFFFFFF, impl="unsafe_rbg")
    return torch.from_numpy(np.array(
        pb.epoch_random_bits(key, nc=nc, trials=trials, C=C)))


def port_from(jm, name, train, opts=OPTS):
    """A port model with the JAX model's current tables and bits."""
    tm = create_item_recommender(name, opts + " device=cpu")
    tm.feedback = train
    tm.init_model(tables=bpr_tables_from_jax(jm))
    tm._epoch_bits = jax_bits
    return tm


@pytest.fixture(scope="module", params=MODELS)
def trained(request, data):
    train, test = data
    jm = getattr(jbpr, request.param)()
    configure(jm, OPTS + " mxu_dtype=f32")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MML_MXU", "interpret")
        jm.feedback = train
        jm.init_model()
        tm = port_from(jm, request.param, train)
        for _ in range(jm.num_iter):
            jm.iterate()
            tm.iterate()
        assert jm._bpr_plan is not None and jm._bpr_tiled is None
    return jm, tm, train, test


def test_echo_line_identical(trained):
    jm, tm, _, _ = trained
    assert str(tm) == str(jm)


def test_tables_match_after_three_epochs(trained):
    jm, tm, _, _ = trained
    for k in ("user_factors", "item_factors", "item_bias"):
        got, want = tm.params[k].numpy(), np.asarray(jm.params[k])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # training moved the tables
    assert np.abs(np.asarray(jm.params["item_bias"])).max() > 1e-3


def test_objective_matches_on_same_triples(trained):
    jm, _, train, _ = trained
    eq = port_from(jm, type(jm).__name__, train)
    eq._loss_sample = tuple(torch.from_numpy(np.asarray(t).astype(np.int64))
                            for t in jm._loss_sample)
    assert eq.compute_objective() == pytest.approx(jm.compute_objective(),
                                                   rel=1e-6)


PROTOCOLS = {
    "overlap": dict(),
    "union-n10": dict(candidate_item_mode="UNION", n=10),
    "training-repeated": dict(candidate_item_mode="TRAINING",
                              repeated_events=True),
    "explicit-users": dict(candidate_item_mode="EXPLICIT",
                           candidate_items=list(range(0, 1500, 3)),
                           test_users=list(range(0, 1200, 7))),
}


@pytest.mark.parametrize("protocol", list(PROTOCOLS))
def test_ranking_measures_equal_on_equal_tables(trained, protocol):
    jm, _, train, test = trained
    eq = port_from(jm, type(jm).__name__, train)
    kw = PROTOCOLS[protocol]
    ref = jax_evaluate(jm, test, train, **kw)
    got = evaluate_items(eq, test, train, **kw)
    assert got["num_users"] == ref["num_users"] > 0
    assert got["num_items"] == ref["num_items"]
    for m in MEASURES:
        assert abs(got[m] - ref[m]) <= 1e-6, m
    assert str(got) == str(ref)


@pytest.mark.parametrize("candidates", [None, range(0, 1500, 3)],
                         ids=["catalog", "candidates"])
def test_recommend_batch_matches_jax(trained, candidates):
    """Top-n lists on equal tables: the same items in the same order,
    training items and non-candidates excluded."""
    jm, _, train, _ = trained
    eq = port_from(jm, type(jm).__name__, train)
    users = np.arange(0, train.num_users, 5, dtype=np.int32)
    want_ids, want_s = jax_recommend_batch(jm, users, 10, training=train,
                                           candidates=candidates, block=64)
    got_ids, got_s = recommend_batch(eq, users, 10, training=train,
                                     candidates=candidates, block=64)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
    assert (got_ids >= 0).all()


def _probe(model, n=400):
    rng = np.random.default_rng(3)
    users = rng.integers(-2, model.num_users_trained + 3, n).astype(np.int32)
    items = rng.integers(-2, model.num_items_trained + 3, n).astype(np.int32)
    return users, items


def test_jax_model_loads_in_port(trained, tmp_path):
    jm, _, _, _ = trained
    path = str(tmp_path / "jax.model")
    jm.save_model(path)
    port = create_item_recommender(type(jm).__name__, "device=cpu")
    port.load_model(path)
    u, i = _probe(jm)
    np.testing.assert_allclose(port.predict_batch(u, i), jm.predict_batch(u, i),
                               rtol=0, atol=1e-6)


def test_port_model_loads_in_jax(trained, tmp_path):
    _, tm, _, _ = trained
    path = str(tmp_path / "port.model")
    tm.save_model(path)
    jm = getattr(jbpr, type(tm).__name__)()
    jm.load_model(path)
    u, i = _probe(tm)
    np.testing.assert_allclose(jm.predict_batch(u, i), tm.predict_batch(u, i),
                               rtol=0, atol=1e-6)
    other = create_item_recommender(type(tm).__name__, "device=cpu")
    other.load_model(path)
    np.testing.assert_array_equal(other.predict_batch(u, i),
                                  tm.predict_batch(u, i))


def test_load_then_iterate(trained, tmp_path):
    """A loaded model keeps training once feedback is set."""
    _, tm, train, _ = trained
    path = str(tmp_path / "m.model")
    tm.save_model(path)
    m = create_item_recommender(type(tm).__name__, "device=cpu")
    m.load_model(path)
    m.feedback = train
    m.iterate()
    assert np.isfinite(m.compute_objective())
    assert not torch.equal(m.params["user_factors"],
                           tm.params["user_factors"])


def test_most_popular_matches_jax(data, tmp_path):
    train, test = data
    for by_user in (False, True):
        jm = jbase.MostPopular()
        tm = create_item_recommender("MostPopular")
        jm.by_user = tm.by_user = by_user
        jm.feedback = tm.feedback = train
        jm.train()
        tm.train()
        np.testing.assert_array_equal(tm.view_count, jm.view_count)
        ref, got = jax_evaluate(jm, test, train), evaluate_items(tm, test,
                                                                 train)
        for m in MEASURES:
            assert abs(got[m] - ref[m]) <= 1e-6, m
    path = str(tmp_path / "mp.model")
    jm.save_model(path)
    loaded = create_item_recommender("MostPopular", "by_user=true")
    loaded.feedback = train
    loaded.load_model(path)
    u, i = _probe(jm)
    np.testing.assert_array_equal(loaded.predict_batch(u, i),
                                  jm.predict_batch(u, i))


def test_train_from_seeded_generator(data):
    """The port's own init and bits (torch.Generator from random_seed):
    deterministic, trains on the CPU without launching the kernel, and
    ranks held-out items well above chance (a random scorer gives AUC
    0.5)."""
    train, test = data
    models = []
    for _ in range(2):
        m = create_item_recommender("BPRMF", "num_factors=16 num_iter=12 "
                                    "learn_rate=0.1 device=cpu")
        m.feedback = train
        models.append(m)
    before = bpr_epoch.launches
    for m in models:
        m.train()
    assert bpr_epoch.launches == before
    a, b = models
    assert torch.equal(a.params["user_factors"], b.params["user_factors"])
    assert a.params["user_factors"].device.type == "cpu"
    assert evaluate_items(a, test, train)["AUC"] > 0.6


def test_tiled_catalog_trains(data, monkeypatch):
    """The setup that raised before the tiled schedule was ported: past
    the resident bound, BPRMF trains on the tiled path."""
    train, _ = data
    monkeypatch.setattr(tplan, "RESIDENT_ITEM_TABLE_BYTES", 256 * 1024)
    monkeypatch.setattr(tplan, "TILED_SLAB_BYTES", 256 * 1024)
    m = create_item_recommender("BPRMF", "num_factors=8 num_iter=2 "
                                "device=cpu")
    m.feedback = train
    m.train()
    assert m._tiled is not None and m._tiled["num_slabs"] == 2
    assert "subkeys_tbl" in m._neg_state
    assert "bitmask_tbl" not in m._neg_state
    assert torch.isfinite(m.params["item_factors"]).all()


def test_tiled_catalog_raises(data, monkeypatch):
    """Where neither the resident nor the tiled schedule applies (here a
    slab passes the shrunk resident bound) the JAX package runs its XLA
    epoch, and the port its minibatch epoch (``ops/bpr.py``): training
    raises no more, launches no kernel and keeps the tables finite."""
    train, _ = data
    monkeypatch.setattr(tplan, "RESIDENT_ITEM_TABLE_BYTES", 64 * 1024)
    m = create_item_recommender("BPRMF", "num_factors=8 num_iter=2 "
                                "device=cpu")
    m.feedback = train
    before = bpr_epoch.launches
    m.train()
    assert m._sampler is not None and bpr_epoch.launches == before
    assert all(torch.isfinite(t).all() for t in m.params.values())


def test_unported_paths_raise():
    """Every name resolves now: MultiCoreBPRMF is BPRMF's route with a
    max_threads knob, BPRSLIM the SLIM module's; only an unknown name
    raises."""
    from mymedialite_tpu_torch.models.slim import BPRSLIM
    multi = create_item_recommender("MultiCoreBPRMF", "max_threads=4")
    assert isinstance(multi, tbpr.BPRMF) and multi.max_threads == 4
    assert multi._setup_mesh() is None
    assert isinstance(create_item_recommender("BPRSLIM"), BPRSLIM)
    for name in ("Random", "Zero"):
        create_item_recommender(name)
    with pytest.raises(KeyError, match="Unknown recommender"):
        create_item_recommender("NoSuchModel")


def test_cuda_is_asked_for_never_assumed(monkeypatch, data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = tbpr.BPRMF()                       # default device: cuda
    m.feedback = data[0]
    with pytest.raises(RuntimeError, match="device=cpu"):
        m.train()


def test_multicore_bprmf_trains_as_bprmf(data):
    """MultiCoreBPRMF on one device is BPRMF's route: from the same
    tables and generator the plain epoch gives the same tables, its
    model file is headed MultiCoreBPRMF, and BPRMF's reader takes the
    tables back."""
    import tempfile
    models = []
    for name in ("BPRMF", "MultiCoreBPRMF"):
        m = create_item_recommender(name, "num_factors=6 num_iter=2 "
                                    "device=cpu")
        m.feedback = data[0]
        m.train()
        models.append(m)
    assert models[1].max_threads == 1
    for k in ("user_factors", "item_factors", "item_bias"):
        assert torch.equal(models[0].params[k], models[1].params[k]), k
    with tempfile.TemporaryDirectory() as d:
        models[1].save_model(f"{d}/m.model")
        with open(f"{d}/m.model") as f:
            assert f.readline().startswith("MultiCoreBPRMF")
        loaded = create_item_recommender("MultiCoreBPRMF", "device=cpu")
        loaded.load_model(f"{d}/m.model")
        assert torch.equal(loaded.params["item_bias"],
                           models[1].params["item_bias"])
