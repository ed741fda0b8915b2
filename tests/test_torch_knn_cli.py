"""The port's rating_prediction and item_recommendation CLIs with the
models of the WRMF / KNN slice, against the JAX package's CLIs, in
process, on synthetic files with attribute files.

The statistics block, which now carries the recommender's user or item
attributes as in the JAX CLIs, is identical. The result lines have the
same fields, with the numbers within 1e-4, for the models whose scores
the two packages compute alike: the baselines, the collaborative KNNs
and, from the JAX model's initial tables, WRMF. The attribute KNNs'
scores agree to 1e-5 (tests/test_torch_knn.py), but their many exactly
equal scores let the ranking measures move with an ulp, so their lines
are held to the same fields and to 5e-3. A model saved by the port's
CLI loads in it with the same result line.
"""

import re

import numpy as np
import pytest

from mymedialite_tpu.cli import item_recommendation as jax_item
from mymedialite_tpu.cli import rating_prediction as jax_rating
from mymedialite_tpu.data.synthetic import split_ratings, synthetic_ratings
from mymedialite_tpu.models import wrmf as jwrmf
from mymedialite_tpu_torch.cli import item_recommendation as port_item
from mymedialite_tpu_torch.cli import rating_prediction as port_rating
from mymedialite_tpu_torch.convert import wrmf_tables_from_jax
from mymedialite_tpu_torch.models import wrmf as twrmf
from torch_threads import one_torch_thread  # noqa: F401

_TIMES = re.compile(r"(training_time|testing_time|loading_time) [0-9.]+ ?")
_NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("knncli")
    train, test = split_ratings(synthetic_ratings(
        num_users=150, num_items=120, num_ratings=4000, seed=2))
    paths = {}
    for name, part in (("train", train), ("test", test)):
        paths[name] = str(d / f"{name}.tsv")
        with open(paths[name], "w") as f:
            for u, i, v in zip(part.users, part.items, part.values):
                f.write(f"{u + 10}\t{i + 3}\t{v:g}\n")
    rng = np.random.default_rng(3)
    for side, n, offset, attrs in (("user", 150, 10, 9), ("item", 120, 3, 7)):
        paths[side] = str(d / f"{side}_attributes.tsv")
        with open(paths[side], "w") as f:
            for e in range(n - 5):           # five entities without any
                for a in rng.choice(attrs, rng.integers(1, 4),
                                    replace=False):
                    f.write(f"{e + offset}\t{a}\n")
    paths["dir"] = d
    return paths


@pytest.fixture
def aligned(monkeypatch):
    """The port's WRMF starts from the tables of the JAX model's last
    init_model (the packages draw them from different generators)."""
    stash = {}
    jax_init, port_init = jwrmf.WRMF.init_model, twrmf.WRMF.init_model

    def record(self):
        jax_init(self)
        stash["tables"] = wrmf_tables_from_jax(self)

    def replay(self, tables=None):
        port_init(self, stash["tables"] if tables is None else tables)

    monkeypatch.setattr(jwrmf.WRMF, "init_model", record)
    monkeypatch.setattr(twrmf.WRMF, "init_model", replay)


def _run(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return _TIMES.sub("", capsys.readouterr().out).splitlines()


def run_both(cli, files, model, opts, extra, capsys):
    jax_main, port_main = {"rating": (jax_rating.main, port_rating.main),
                           "item": (jax_item.main, port_item.main)}[cli]
    argv = ["--training-file", files["train"], "--test-file", files["test"],
            "--recommender", model] + extra
    j = _run(jax_main, argv + (["--recommender-options", opts] if opts
                                else []), capsys)
    p = _run(port_main, argv + ["--recommender-options",
                                f"{opts} device=cpu"], capsys)
    return j, p


def assert_same_fields(port_line, jax_line, atol):
    assert _NUM.sub("#", port_line) == _NUM.sub("#", jax_line)
    np.testing.assert_allclose([float(x) for x in _NUM.findall(port_line)],
                               [float(x) for x in _NUM.findall(jax_line)],
                               rtol=0, atol=atol)


CASES = [
    ("rating", "UserItemBaseline", "", [], 1e-4),
    ("rating", "UserKNN", "k=400", [], 1e-4),
    ("rating", "ItemKNN", "k=400 correlation=RatingCosine", [], 1e-4),
    ("rating", "UserAttributeKNN", "k=400", ["--user-attributes"], 1e-4),
    ("rating", "ItemAttributeKNN", "k=400", ["--item-attributes"], 1e-4),
    ("item", "UserKNN", "k=20", [], 1e-4),
    ("item", "ItemKNN", "k=20 correlation=Jaccard", [], 1e-4),
    ("item", "WRMF", "num_factors=6 num_iter=2", [], 1e-4),
    ("item", "UserAttributeKNN", "k=20", ["--user-attributes"], 5e-3),
    ("item", "ItemAttributeKNN", "k=20", ["--item-attributes"], 5e-3),
]


@pytest.mark.parametrize("cli,model,opts,attr,atol", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_same_statistics_and_result(cli, model, opts, attr, atol, files,
                                    capsys, aligned):
    extra = []
    if attr:
        extra = [attr[0], files[attr[0].split("-")[2]]]
    j, p = run_both(cli, files, model, opts, extra, capsys)
    assert len(p) == len(j)
    assert p[:-1] == j[:-1]                 # the statistics block
    if attr:
        side = attr[0].split("-")[2]
        assert any(f"{side} attributes for" in line for line in p)
    assert_same_fields(p[-1], j[-1], atol)


@pytest.mark.parametrize("cli,model,opts,attr", [
    ("rating", "ItemKNN", "k=30", []),
    ("rating", "UserItemBaseline", "", []),
    ("item", "WRMF", "num_factors=6 num_iter=2", []),
    ("item", "ItemAttributeKNN", "k=20", ["--item-attributes"]),
])
def test_port_cli_save_load(cli, model, opts, attr, files, capsys):
    main = {"rating": port_rating.main, "item": port_item.main}[cli]
    path = str(files["dir"] / f"{cli}-{model}.model")
    argv = ["--training-file", files["train"], "--test-file", files["test"],
            "--recommender", model, "--recommender-options",
            f"{opts} device=cpu"]
    if attr:
        argv += [attr[0], files["item"]]
    trained = _run(main, argv + ["--save-model", path], capsys)
    loaded = _run(main, argv + ["--load-model", path], capsys)
    assert trained[-1] == loaded[-1]
