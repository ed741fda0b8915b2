"""The rating-prediction slice of the port (``mymedialite_tpu_torch``:
models/mf.py + ops + eval/rating.py) against the JAX package on the same
data, on the CPU.

The JAX models run their Pallas epoch in interpret mode with float32
operands (``MML_MXU=interpret``, ``mxu_dtype=f32``), and take their epoch
order from the host ``MxuPlan.epoch_order`` (the port's order) instead of
the device one. The port starts from the JAX tables after ``init_model``
(``convert.tables_from_jax``): the two packages draw their initial
factors from different generators. After 3 epochs the tables agree to
atol 1e-4, the metrics and the objective to 1e-5 relative, and model
files pass between the packages with predictions equal to 1e-6.
"""

import numpy as np
import pytest
import torch

from mymedialite_tpu.data.synthetic import split_ratings, synthetic_ratings
from mymedialite_tpu.eval.rating import evaluate_ratings as jax_evaluate
from mymedialite_tpu.models import mf as jmf
from mymedialite_tpu.ops import pallas_sgd as ps
from mymedialite_tpu.utils.params import configure
from mymedialite_tpu_torch.convert import tables_from_jax
from mymedialite_tpu_torch.device import resolve_device
from mymedialite_tpu_torch.eval.rating import compute_fit, evaluate_ratings
from mymedialite_tpu_torch.models import mf as tmf
from mymedialite_tpu_torch.models.registry import create_rating_predictor
from mymedialite_tpu_torch.ops.sgd_epoch import sgd_epoch
from torch_threads import one_torch_thread  # noqa: F401

KEYS = ("RMSE", "MAE", "NMAE", "CBD")

# (model name, shared options)
CONFIGS = [
    ("BiasedMatrixFactorization", "num_factors=8 num_iter=3 bold_driver=true"),
    ("BiasedMatrixFactorization", "num_factors=8 num_iter=3 loss=MAE "
                                  "learn_rate=0.05"),
    ("BiasedMatrixFactorization", "num_factors=8 num_iter=3 "
                                  "loss=LogisticLoss learn_rate_decay=0.9"),
    ("MatrixFactorization", "num_factors=8 num_iter=3 regularization=0.05"),
]


def jax_mode(mp):
    """The JAX package's resident Pallas epoch on the CPU, with the host
    epoch order; the package itself is not edited."""
    mp.setenv("MML_MXU", "interpret")
    mp.setattr(ps, "device_epoch_order",
               lambda plan, seed: plan.epoch_order(seed))


@pytest.fixture(scope="module")
def data():
    """200 x 300 x 6000 synthetic ratings, split 80/20; the training
    ratings of users 0-2 and items 1-3 move to the test set, so that the
    cold-start breakdown has new users, new items and both."""
    ratings = synthetic_ratings(num_users=200, num_items=300,
                                num_ratings=6000, seed=11)
    train, test = split_ratings(ratings, seed=12)
    cold = np.isin(train.users, [0, 1, 2]) | np.isin(train.items, [1, 2, 3])
    idx = np.arange(len(train))
    return train.select(idx[~cold]), test.concat(train.select(idx[cold]))


def make_pair(name, opts):
    jm = getattr(jmf, name)()
    configure(jm, opts + " mxu_dtype=f32")
    tm = create_rating_predictor(name)
    configure(tm, opts + " device=cpu")
    return jm, tm


@pytest.fixture(scope="module", params=range(len(CONFIGS)),
                ids=["biased-rmse-bold", "biased-mae", "biased-logistic",
                     "plain"])
def trained(request, data):
    train, test = data
    jm, tm = make_pair(*CONFIGS[request.param])
    with pytest.MonkeyPatch.context() as mp:
        jax_mode(mp)
        jm.ratings = train
        tm.ratings = train
        jm.init_model()
        tm.init_model(tables=tables_from_jax(jm))
        assert isinstance(jm._mxu_plan, ps.MxuPlan)
        for _ in range(jm.num_iter):
            jm.iterate()
            tm.iterate()
        return jm, tm, train, test


def test_echo_line_identical(trained):
    jm, tm, _, _ = trained
    assert str(tm) == str(jm)


def test_tables_match(trained):
    jm, tm, _, _ = trained
    assert tm.W_ext.shape == tuple(jm.W_ext.shape)
    np.testing.assert_allclose(tm.W_ext.numpy(), np.asarray(jm.W_ext),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.H_ext.numpy(), np.asarray(jm.H_ext),
                               rtol=0, atol=1e-4)
    assert tm.current_learnrate == pytest.approx(jm.current_learnrate,
                                                 rel=1e-12)


def test_metrics_match(trained):
    jm, tm, train, test = trained
    ref = jax_evaluate(jm, test, train)
    got = evaluate_ratings(tm, test, train)
    for k in KEYS:
        assert got[k] == pytest.approx(ref[k], rel=1e-5)
    pairs = ((got.new_user_results, ref.new_user_results),
             (got.new_item_results, ref.new_item_results),
             (got.new_user_new_item_results, ref.new_user_new_item_results))
    assert ref.new_user_results is not None
    for a, b in pairs:
        assert (a is None) == (b is None)
        if a is not None:
            for k in KEYS:
                assert a[k] == pytest.approx(b[k], rel=1e-5)
    plain = evaluate_ratings(tm, test)
    assert plain.new_user_results is None
    assert plain["RMSE"] == pytest.approx(got["RMSE"], rel=1e-6)
    assert compute_fit(tm) == pytest.approx(
        np.sqrt(np.mean((jm.predict_batch(train.users, train.items)
                         - train.values) ** 2)), rel=1e-5)


def test_objective_matches(trained):
    jm, tm, _, _ = trained
    assert tm.compute_objective() == pytest.approx(jm.compute_objective(),
                                                   rel=1e-5)
    if jm.BIASED and jm.bold_driver:
        assert tm._last_loss == pytest.approx(jm._last_loss, rel=1e-5)


def _probe_pairs(model, n=500):
    rng = np.random.default_rng(3)
    users = rng.integers(-2, model.num_users_trained + 3, n).astype(np.int32)
    items = rng.integers(-2, model.num_items_trained + 3, n).astype(np.int32)
    return users, items


def test_jax_model_loads_in_port(trained, tmp_path):
    jm, _, _, _ = trained
    path = str(tmp_path / "jax.model")
    jm.save_model(path)
    port = getattr(tmf, type(jm).__name__)()
    port.device = "cpu"
    port.load_model(path)
    u, i = _probe_pairs(jm)
    np.testing.assert_allclose(port.predict_batch(u, i),
                               jm.predict_batch(u, i), rtol=0, atol=1e-6)


def test_port_model_loads_in_jax(trained, tmp_path):
    _, tm, _, _ = trained
    path = str(tmp_path / "port.model")
    tm.save_model(path)
    jm = getattr(jmf, type(tm).__name__)()
    jm.load_model(path)
    u, i = _probe_pairs(tm)
    np.testing.assert_allclose(jm.predict_batch(u, i),
                               tm.predict_batch(u, i), rtol=0, atol=1e-6)


def test_port_round_trip_bit_identical(trained, tmp_path):
    _, tm, _, _ = trained
    path = str(tmp_path / "again.model")
    tm.save_model(path)
    other = create_rating_predictor(type(tm).__name__)
    other.device = "cpu"
    other.load_model(path)
    u, i = _probe_pairs(tm)
    np.testing.assert_array_equal(other.predict_batch(u, i),
                                  tm.predict_batch(u, i))


def test_train_from_seeded_generator(data):
    """The port's own init: torch.Generator draws seeded by random_seed,
    zero rows for entities without ratings; training stays on the CPU
    without launching the kernel and beats the global average."""
    train, test = data
    models = []
    for _ in range(2):
        m = tmf.BiasedMatrixFactorization()
        configure(m, "num_factors=8 num_iter=4 device=cpu")
        m.ratings = train
        m.init_model()
        models.append(m)
    a, b = models
    assert torch.equal(a.W_ext, b.W_ext) and torch.equal(a.H_ext, b.H_ext)
    cold = np.flatnonzero(train.count_by_item == 0)
    assert cold.size and not a.H_ext[cold, :8].any()
    before = sgd_epoch.launches
    a.train()
    assert sgd_epoch.launches == before
    assert a.W_ext.device.type == "cpu"
    rmse = evaluate_ratings(a, test)["RMSE"]
    baseline = np.sqrt(np.mean((test.values - train.values.mean()) ** 2))
    assert rmse < baseline


def test_unported_paths_raise(data):
    train, _ = data
    m = tmf.BiasedMatrixFactorization()
    configure(m, "num_factors=4 device=cpu frequency_regularization=true")
    m.ratings = train
    with pytest.raises(NotImplementedError, match="not yet ported"):
        m.train()
    for call in (lambda: m.add_ratings([0], [0], [3.0]),
                 lambda: m.retrain_user(0), lambda: m._retrain([0], [0])):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            call()
    with pytest.raises(KeyError, match="not yet ported"):
        create_rating_predictor("GSVDPlusPlus")
    with pytest.raises(KeyError, match="Unknown recommender"):
        create_rating_predictor("NoSuchModel")


def test_cuda_is_asked_for_never_assumed(monkeypatch, data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    m = tmf.MatrixFactorization()           # default device: cuda
    m.ratings = data[0]
    with pytest.raises(RuntimeError, match="device=cpu"):
        m.train()
