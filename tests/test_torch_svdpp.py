"""The SVD++ slice of the port (``mymedialite_tpu_torch/models/svdpp.py``
with ``ops/svdpp*.py`` and ``eval/rating.py``) against the JAX package's
five SVD++-family models on the same data, on the CPU.

The JAX models run their Pallas epoch in interpret mode
(``MML_MXU=interpret``) with float32 operands: the JAX package gives SVD++
no ``mxu_dtype`` option and calls ``svdpp_epoch_mxu`` at its bf16
default, so the test, and only the test, rebinds that function with
``mxu_dtype="f32"``. The two packages draw their initial tables from
different generators, so each JAX ``init_model`` records its tables
(``convert.svdpp_tables_from_jax``) and the port's next ``init_model``
starts from them; the user and combined models build their inner models
in the same order in both packages. The models are transductive: the
held-out pairs are their additional feedback. After 3 epochs the tables
agree to atol 1e-4, predictions and RMSE to 1e-4, and model files pass
between the packages with predictions equal to 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

from mymedialite_tpu.data.arrays import RatingData as JaxRatingData
from mymedialite_tpu.eval.rating import evaluate_ratings as jax_evaluate
from mymedialite_tpu.models import svdpp as jsv
from mymedialite_tpu.ops import pallas_svdpp as psv
from mymedialite_tpu.utils.params import configure as jax_configure
from mymedialite_tpu_torch.convert import svdpp_tables_from_jax
from mymedialite_tpu_torch.data.arrays import RatingData
from mymedialite_tpu_torch.eval.rating import evaluate_ratings
from mymedialite_tpu_torch.models import svdpp as tsv
from mymedialite_tpu_torch.models.registry import create_rating_predictor
from mymedialite_tpu_torch.ops.svdpp_epoch import svdpp_epoch
from mymedialite_tpu_torch.utils.params import configure
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ("SVDPlusPlus", "SigmoidSVDPlusPlus",
         "SigmoidItemAsymmetricFactorModel",
         "SigmoidUserAsymmetricFactorModel",
         "SigmoidCombinedAsymmetricFactorModel")
OPTS = "num_factors=6 num_iter=3 learn_rate=0.01"


@pytest.fixture(scope="module")
def data():
    """150 x 100 x 6000 planted ratings (the model-layer shape of
    tests/test_pallas_svdpp.py), the last 15% held out."""
    rng = np.random.default_rng(7)
    U, I, n = 150, 100, 6000
    users = rng.integers(0, U, n).astype(np.int32)
    items = rng.integers(0, I, n).astype(np.int32)
    wu, hi = rng.standard_normal((U, 4)), rng.standard_normal((I, 4))
    vals = np.clip(3 + (wu[users] * hi[items]).sum(1) * 0.5
                   + 0.3 * rng.standard_normal(n), 1, 5).astype(np.float32)
    cut = int(n * 0.85)
    parts = {}
    for name, sl in (("train", slice(None, cut)), ("test", slice(cut, None))):
        parts[name] = (users[sl], items[sl], vals[sl])
    return parts, U, I


def _ratings(cls, part, U, I):
    return cls(*part, num_users=U, num_items=I)


def jax_f32_interpret(mp):
    """The JAX package's SVD++ kernel on the CPU with float32 operands and
    a pass of 256 grid steps instead of 16,384 (a pass is padded to its
    length with empty steps, which interpret mode walks one by one; the
    split into passes changes no number, tests/test_pallas_svdpp.py); the
    package itself is not edited."""
    mp.setenv("MML_MXU", "interpret")
    mp.setattr(psv, "svdpp_epoch_mxu",
               functools.partial(psv.svdpp_epoch_mxu, mxu_dtype="f32"))
    mp.setattr(psv, "prepare_svdpp_mxu",
               functools.partial(psv.prepare_svdpp_mxu, pass_len=256))


def share_init_tables(mp):
    """Each JAX init_model records its tables; each port init_model
    without tables takes the oldest recorded ones."""
    stash = []
    jax_init = jsv.SVDPlusPlus.init_model
    port_init = tsv.SVDPlusPlus.init_model

    def record(self):
        jax_init(self)
        stash.append(svdpp_tables_from_jax(self))

    def replay(self, tables=None):
        port_init(self, stash.pop(0) if tables is None else tables)

    mp.setattr(jsv.SVDPlusPlus, "init_model", record)
    mp.setattr(tsv.SVDPlusPlus, "init_model", replay)


def make_pair(name, data):
    parts, U, I = data
    jm = getattr(jsv, name)()
    jax_configure(jm, OPTS)
    tm = create_rating_predictor(name, OPTS + " device=cpu")
    jm.ratings = _ratings(JaxRatingData, parts["train"], U, I)
    tm.ratings = _ratings(RatingData, parts["train"], U, I)
    test_pairs = parts["test"][:2]
    jm.additional_feedback = test_pairs
    tm.additional_feedback = test_pairs
    return jm, tm


@pytest.fixture(scope="module", params=NAMES)
def trained(request, data):
    jm, tm = make_pair(request.param, data)
    with pytest.MonkeyPatch.context() as mp:
        jax_f32_interpret(mp)
        share_init_tables(mp)
        jm.train()
        tm.train()
    return jm, tm


def _leaves(model):
    """The models that hold tables: the model itself, its inner item AFM
    (user AFM), or its two inner models' (combined)."""
    if hasattr(model, "_item_afm"):
        return _leaves(model._item_afm) + _leaves(model._user_afm)
    if hasattr(model, "_inner"):
        return [model._inner]
    return [model]


def _probe_pairs(model, n=400):
    rng = np.random.default_rng(3)
    users = rng.integers(-2, model.num_users_trained + 3, n).astype(np.int32)
    items = rng.integers(-2, model.num_items_trained + 3, n).astype(np.int32)
    return users, items


def test_echo_line_identical(trained):
    jm, tm = trained
    assert str(tm) == str(jm)


def test_tables_match(trained):
    jm, tm = trained
    for jl, tl in zip(_leaves(jm), _leaves(tm), strict=True):
        assert jl._svdpp_plan is not None      # the JAX Pallas epoch ran
        ref = svdpp_tables_from_jax(jl)
        got = tl.params
        assert set(got) == {"user_bias", "item_bias", "item_factors", "y"} \
            | ({"p"} if tl.USE_P else set())
        for k, v in got.items():
            assert v.shape == ref[k].shape, k
            np.testing.assert_allclose(v.numpy(), ref[k], rtol=0, atol=1e-4,
                                       err_msg=k)
        assert tl.global_bias == pytest.approx(ref["global_bias"], abs=1e-6)
        assert tl.num_users_trained == jl.num_users_trained
        assert tl.current_learnrate == pytest.approx(jl.current_learnrate,
                                                     rel=1e-12)


def test_predictions_and_metrics_match(trained, data):
    jm, tm = trained
    parts, U, I = data
    u, i = _probe_pairs(tm)
    np.testing.assert_allclose(tm.predict_batch(u, i), jm.predict_batch(u, i),
                               rtol=0, atol=1e-4)
    test_j = _ratings(JaxRatingData, parts["test"], U, I)
    test_t = _ratings(RatingData, parts["test"], U, I)
    train_j = _ratings(JaxRatingData, parts["train"], U, I)
    train_t = _ratings(RatingData, parts["train"], U, I)
    ref = jax_evaluate(jm, test_j, train_j)
    got = evaluate_ratings(tm, test_t, train_t)
    for k in ("RMSE", "MAE", "CBD"):
        assert got[k] == pytest.approx(ref[k], abs=1e-4)


def _load_both(path, jm, tm):
    """The file at ``path`` loaded by a fresh JAX model and a fresh port
    model, each given the trained model's ratings and feedback."""
    jax_loaded = getattr(jsv, type(jm).__name__)()
    port_loaded = create_rating_predictor(type(tm).__name__,
                                          OPTS + " device=cpu")
    for fresh, like in ((jax_loaded, jm), (port_loaded, tm)):
        fresh.ratings = like.ratings
        fresh.additional_feedback = like.additional_feedback
        fresh.load_model(path)
    return jax_loaded, port_loaded


def _own_tables(model):
    # the user and combined models keep their tables in inner models,
    # which load without the feedback in both packages
    return len(_leaves(model)) == 1 and _leaves(model)[0] is model


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_model_files_cross_packages(trained, tmp_path, saved_by):
    """A file saved by either package loads in both, with predictions
    equal to 1e-5; the header names the model (the user AFM's rewritten,
    the combined model's beside its -item and -user files)."""
    jm, tm = trained
    path = str(tmp_path / f"{saved_by}.model")
    (jm if saved_by == "jax" else tm).save_model(path)
    with open(path) as f:
        assert f.readline().strip() == type(tm).__name__
    jax_loaded, port_loaded = _load_both(path, jm, tm)
    u, i = _probe_pairs(tm)
    np.testing.assert_allclose(port_loaded.predict_batch(u, i),
                               jax_loaded.predict_batch(u, i), rtol=0,
                               atol=1e-5)
    if _own_tables(tm):
        saver = jm if saved_by == "jax" else tm
        np.testing.assert_allclose(port_loaded.predict_batch(u, i),
                                   saver.predict_batch(u, i), rtol=0,
                                   atol=1e-5)
        if saved_by == "port":
            # the port's own round trip is bit for bit
            np.testing.assert_array_equal(port_loaded.predict_batch(u, i),
                                          tm.predict_batch(u, i))


def test_iterate_continues_a_loaded_model(trained, tmp_path):
    """After load_model, iterate() builds the plan and trains on."""
    jm, tm = trained
    path = str(tmp_path / "m.model")
    tm.save_model(path)
    _, m = _load_both(path, jm, tm)
    before = [{k: v.clone() for k, v in leaf.params.items()}
              for leaf in _leaves(m)]
    m.iterate()
    for leaf, old in zip(_leaves(m), before):
        assert leaf._plan is not None
        assert any(not torch.equal(v, leaf.params[k]) for k, v in old.items())


def test_train_from_seeded_generator(data):
    """The port's own init: torch.Generator draws seeded by random_seed,
    zero rows for items and users without training ratings, zero biases;
    training stays on the CPU without launching the kernel and beats the
    global average."""
    parts, U, I = data
    train = _ratings(RatingData, parts["train"], U + 5, I + 5)
    models = []
    for _ in range(2):
        m = tsv.SVDPlusPlus()
        configure(m, "num_factors=6 num_iter=10 learn_rate=0.02 device=cpu")
        m.ratings = train
        m.init_model()
        models.append(m)
    a, b = models
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert not a.params["item_factors"][I:].any()
    assert not a.params["y"][I:].any() and not a.params["p"][U:].any()
    assert not a.params["user_bias"].any()
    before = svdpp_epoch.launches
    a.train()
    assert svdpp_epoch.launches == before
    assert a.params["y"].device.type == "cpu"
    test = _ratings(RatingData, parts["test"], U, I)
    rmse = evaluate_ratings(a, test)["RMSE"]
    assert rmse < np.sqrt(np.mean((test.values - train.values.mean()) ** 2))


def test_unported_paths_raise(data, monkeypatch, tmp_path):
    parts, U, I = data
    train = _ratings(RatingData, parts["train"], U, I)

    def model(opts=""):
        m = create_rating_predictor("SVDPlusPlus", "num_factors=4 device=cpu "
                                    + opts)
        m.ratings = train
        return m

    m = model()
    m.train()
    # every JAX name resolves in the port; an unknown one raises
    assert type(create_rating_predictor("SocialMF")).__name__ == "SocialMF"
    with pytest.raises(KeyError, match="Unknown recommender"):
        create_rating_predictor("NoSuchModel")
    path = str(tmp_path / "m.model")
    m.save_model(path)
    with pytest.raises(RuntimeError, match="ratings"):
        tsv.SVDPlusPlus().load_model(path)
