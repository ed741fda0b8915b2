"""The port's external recommenders (``mymedialite_tpu_torch/models/
external.py``) against the JAX package's, on the CPU: the last line of
a duplicated pair wins, unlisted pairs score the default, the trained
counts come from the file, the catalog row equals the plain per-pair
lookup, and both CLIs hand the program's ID mappings to the model and
print the JAX CLIs' lines."""

import re

import numpy as np
import pytest

from mymedialite_tpu.cli import item_recommendation as jax_item
from mymedialite_tpu.cli import rating_prediction as jax_rating
from mymedialite_tpu.data.mapping import Mapping as JMapping
from mymedialite_tpu.models.external import (
    ExternalItemRecommender as JItem, ExternalRatingPredictor as JRating,
)
from mymedialite_tpu_torch.cli import item_recommendation as port_item
from mymedialite_tpu_torch.cli import rating_prediction as port_rating
from mymedialite_tpu_torch.data.mapping import Mapping
from mymedialite_tpu_torch.data.synthetic import (
    split_posonly, split_ratings, synthetic_posonly, synthetic_ratings,
)
from mymedialite_tpu_torch.models.registry import (
    create_item_recommender, create_rating_predictor,
)

_TIMES = re.compile(r"(training_time|testing_time|loading_time) [0-9.]+ ?")

LINES = ["u1 i1 3.5", "u2 i1 1.25", "u1 i2 4", "u1 i1 2.75", "u3 i9 -1.5",
         "u2 i3 5e-1"]


@pytest.fixture
def small_file(tmp_path):
    path = tmp_path / "pred.txt"
    path.write_text("\n".join(LINES) + "\n")
    return str(path)


def both(cls_port, cls_jax, path):
    t = create_rating_predictor(cls_port, "device=cpu") \
        if cls_port == "ExternalRatingPredictor" else \
        create_item_recommender(cls_port, "device=cpu")
    j = cls_jax()
    for m, mapping in ((t, Mapping), (j, JMapping)):
        m.user_mapping, m.item_mapping = mapping(), mapping()
        m.user_mapping.to_internal("u0")      # ids the program knew
        m.prediction_file = path
        m.train()
    return t, j


@pytest.mark.parametrize("kind", ["rating", "item"])
def test_lookups_equal_the_dict(kind, small_file):
    if kind == "rating":
        t, j = both("ExternalRatingPredictor", JRating, small_file)
        default = 0.0
    else:
        t, j = both("ExternalItemRecommender", JItem, small_file)
        default = np.float32(-3.4e38)
    assert (t.num_users_trained, t.num_items_trained) == \
        (j.num_users_trained, j.num_items_trained) == (4, 4)
    users = np.array([1, 1, 2, 3, 2, 0, 7, -1, 1])
    items = np.array([0, 1, 0, 3, 2, 0, 0, 0, 9])
    got = t.predict_batch(users, items)
    np.testing.assert_array_equal(got, j.predict_batch(users, items))
    # the last line of (u1, i1) wins; unlisted pairs take the default
    assert got[0] == np.float32(2.75) and got[5] == default
    assert t.can_predict(1, 0) and not t.can_predict(0, 0)
    assert t.can_predict(3, 3) == j.can_predict(3, 3)


def test_catalog_rows_equal_the_plain_lookup(small_file):
    t, j = both("ExternalItemRecommender", JItem, small_file)
    users = np.array([0, 1, 2, 3, 3, 1])
    rows = t.score_catalog(users)
    assert rows.shape == (6, 4)
    np.testing.assert_array_equal(rows, j.score_catalog(users))
    n = t.num_items_trained
    for r, u in enumerate(users):
        np.testing.assert_array_equal(
            rows[r], t.predict_batch(np.full(n, u), np.arange(n)))


def test_save_and_load_keep_nothing(small_file, tmp_path):
    t, _ = both("ExternalRatingPredictor", JRating, small_file)
    t.save_model(str(tmp_path / "none"))
    t.load_model(str(tmp_path / "none"))
    assert not (tmp_path / "none").exists()


# --- through the CLIs -------------------------------------------------------

@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """Rating and item files with offset string ids, and prediction files
    that list test pairs twice (the second value wins), unknown users and
    items, and miss some test pairs."""
    d = tmp_path_factory.mktemp("external")
    rng = np.random.default_rng(4)
    ratings = split_ratings(synthetic_ratings(num_users=90, num_items=70,
                                              num_ratings=1800, seed=5))
    items = split_posonly(synthetic_posonly(num_users=90, num_items=70,
                                            num_events=1800, seed=6))
    paths = {}
    for kind, (train, test) in (("rating", ratings), ("item", items)):
        for name, part in (("train", train), ("test", test)):
            with open(d / f"{kind}_{name}.tsv", "w") as f:
                for k in range(len(part)):
                    line = f"{part.users[k] + 100}\t{part.items[k] + 7}"
                    if kind == "rating":
                        line += f"\t{part.values[k]:g}"
                    f.write(line + "\n")
            paths[f"{kind}_{name}"] = str(d / f"{kind}_{name}.tsv")
        with open(d / f"{kind}_pred.txt", "w") as f:
            for u, i in zip(test.users, test.items):
                if rng.random() < 0.1:
                    continue
                f.write(f"{u + 100} {i + 7} {rng.uniform(1, 5):.4f}\n")
                if rng.random() < 0.2:
                    f.write(f"{u + 100} {i + 7} {rng.uniform(1, 5):.4f}\n")
            for u in range(3):
                f.write(f"9{u}99 {rng.integers(7, 77)} 2.5\n")
                f.write(f"{u + 100} 8{u}88 4.5\n")
        paths[f"{kind}_pred"] = str(d / f"{kind}_pred.txt")
    return paths


def _run(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return _TIMES.sub("", capsys.readouterr().out)


@pytest.mark.parametrize("kind", ["rating", "item"])
def test_clis_hand_over_the_mappings(kind, cli_files, capsys, monkeypatch):
    monkeypatch.setenv("MMLT_COMPILE_CACHE", "0")
    jax_main, port_main = {"rating": (jax_rating.main, port_rating.main),
                           "item": (jax_item.main, port_item.main)}[kind]
    name = {"rating": "ExternalRatingPredictor",
            "item": "ExternalItemRecommender"}[kind]
    argv = ["--training-file", cli_files[f"{kind}_train"], "--test-file",
            cli_files[f"{kind}_test"], "--recommender", name]
    opts = f"prediction_file={cli_files[kind + '_pred']}"
    jax_out = _run(jax_main, argv + ["--recommender-options", opts], capsys)
    port_out = _run(port_main, argv + ["--recommender-options",
                                       opts + " device=cpu"], capsys)
    assert port_out == jax_out
    last = port_out.splitlines()[-1]
    assert last.startswith(f"{name} prediction_file=")
    assert ("RMSE" if kind == "rating" else "AUC") in last


def test_an_empty_file_predicts_the_defaults(tmp_path):
    path = tmp_path / "empty.txt"
    path.write_text("")
    for name, default in (("ExternalRatingPredictor", 0.0),
                          ("ExternalItemRecommender", np.float32(-3.4e38))):
        make = create_rating_predictor \
            if name == "ExternalRatingPredictor" else create_item_recommender
        m = make(name, f"prediction_file={path} device=cpu")
        m.train()
        assert (m.predict_batch([0, 1], [0, 2]) == default).all()
        assert not m.can_predict(0, 0)
