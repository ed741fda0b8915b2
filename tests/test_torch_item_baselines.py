"""The item baselines of the port (``models/item_baselines.py``: Zero,
Random, MostPopularByAttributes, BigramRules) against the JAX package's
on the same data, on the CPU.

Scores (the catalog of every user, and pairs with unknown ids) and the
ranking evaluation agree: RandomItem's exactly (the same numpy draws in
the same order), the others to 1e-6. BigramRules' model file is the JAX
package's text and loads in both packages; Zero and Random save and
load nothing, and MostPopularByAttributes refuses to, as in the JAX
package. The four names are served by the registry.
"""

import numpy as np
import pytest

from mymedialite_tpu.data.arrays import PosOnlyData as JaxPosOnly
from mymedialite_tpu.eval.ranking import evaluate_items as jax_evaluate
from mymedialite_tpu.models.registry import (
    create_item_recommender as jax_create,
)
from mymedialite_tpu_torch.data.arrays import PosOnlyData
from mymedialite_tpu_torch.eval.ranking import evaluate_items
from mymedialite_tpu_torch.models import item_baselines as tib
from mymedialite_tpu_torch.models.registry import (
    ITEM_RECOMMENDER_CLASSES, RATING_PREDICTOR_CLASSES,
    create_item_recommender,
)
from test_torch_incremental_item import jax_posonly, port_feedback
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ["Zero", "Random", "MostPopularByAttributes", "BigramRules"]


@pytest.fixture(scope="module")
def data():
    from mymedialite_tpu_torch.data.synthetic import split_posonly
    train, test = split_posonly(port_feedback(seed=12), seed=13)
    rng = np.random.default_rng(14)
    # item -> attribute lines over the catalog's 120 items, 9 attributes,
    # some items with none (past the catalog see the pinned fault below)
    items = rng.integers(0, 120, 200)
    attrs = rng.integers(0, 9, 200)
    return train, test, (items, attrs)


def pair(name, data):
    train, _, (items, attrs) = data
    j = jax_create(name)
    t = create_item_recommender(name, "device=cpu" if name == "BigramRules"
                                else "")
    if name == "MostPopularByAttributes":
        j.item_attributes = JaxPosOnly(items, attrs)
        t.item_attributes = PosOnlyData(items, attrs)
    j.feedback = jax_posonly(train)
    t.feedback = train
    j.train()
    t.train()
    return j, t


@pytest.mark.parametrize("name", NAMES)
def test_scores_match_jax(name, data):
    j, t = pair(name, data)
    users = np.arange(-1, 152)
    got, ref = t.score_catalog(np.arange(150)), j.score_catalog(
        np.arange(150))
    assert got.shape == ref.shape
    atol = 0 if name in ("Zero", "Random") else 1e-6
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    rng = np.random.default_rng(1)
    items = rng.integers(-1, t.num_items_trained + 2, users.size)
    np.testing.assert_allclose(t.predict_batch(users, items),
                               j.predict_batch(users, items), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("name", NAMES)
def test_ranking_evaluation_matches_jax(name, data):
    train, test, _ = data
    j, t = pair(name, data)
    ref = jax_evaluate(j, jax_posonly(test), jax_posonly(train))
    got = evaluate_items(t, test, train)
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k


def test_bigram_model_file_both_ways(data, tmp_path):
    train, _, _ = data
    j, t = pair("BigramRules", data)
    jp, tp = str(tmp_path / "j.model"), str(tmp_path / "t.model")
    j.save_model(jp)
    t.save_model(tp)
    assert open(jp).read() == open(tp).read()
    loaded = tib.BigramRules()
    loaded.feedback = train
    loaded.load_model(jp)
    j2 = jax_create("BigramRules")
    j2.feedback = jax_posonly(train)
    j2.load_model(tp)
    users = np.arange(150)
    np.testing.assert_allclose(loaded.score_catalog(users),
                               j2.score_catalog(users), rtol=0, atol=1e-6)


def test_model_files_of_the_others(data, tmp_path):
    for name in ("Zero", "Random"):
        _, t = pair(name, data)
        t.save_model(str(tmp_path / name))
        t.load_model(str(tmp_path / name))
    _, t = pair("MostPopularByAttributes", data)
    with pytest.raises(NotImplementedError):
        t.save_model(str(tmp_path / "mpba"))


def test_attributes_past_the_catalog_fail_in_both(data):
    """Pinned JAX-package fault, copied (ROADMAP §C): attributes of items
    past the feedback's catalog widen the attribute rows but not the
    popularity row, and scoring fails to broadcast, in both packages."""
    train, test, (items, attrs) = data
    wide = (np.append(items, 125), np.append(attrs, 3))
    for model in pair("MostPopularByAttributes", (train, test, wide)):
        with pytest.raises(ValueError, match="broadcast"):
            model.score_catalog(np.arange(3))


def test_bigram_counts_stay_exact(data):
    """Mᵀ·M in float32 with TF32 off: the co-occurrence counts are exact
    integers (checked against an int64 product)."""
    train, _, _ = data
    _, t = pair("BigramRules", data)
    M = t._M.astype(np.int64)
    C = M.T @ M
    np.fill_diagonal(C, 0)
    cnt = np.maximum(M.sum(axis=0), 1)
    R = (C.astype(np.float32) ** 2 / (cnt[:, None] * len(train)).astype(
        np.float32))
    np.testing.assert_array_equal(t._R, R.astype(np.float32))


def test_registry_serves_31_of_39_names():
    # every one of the 39 names since the last eight were ported
    assert len(RATING_PREDICTOR_CLASSES) + len(ITEM_RECOMMENDER_CLASSES) == 39
    for name in NAMES:
        model = create_item_recommender(name)
        assert not hasattr(model, "add_feedback")
    assert isinstance(create_item_recommender("Random"), tib.RandomItem)
