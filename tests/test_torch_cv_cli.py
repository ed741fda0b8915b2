"""The protocols of the XLA slice in the port's three CLIs against the
JAX package's CLIs, in process: ``--cross-validation=K`` in all three
(with ``--find-iter`` in the rating and item CLIs, refused by
rating_based_ranking in both packages) and ``--search-hp`` in the rating
CLI, on deterministic models (UserItemBaseline, MostPopular, ItemKNN;
WRMF for the iterative item form, its folds run in order and started
from the JAX folds' tables). Standard output is compared line by line,
timings removed, every number held to 1e-6. The search runs 15
iterations in both packages, to keep the test short
(``tests/test_torch_hyperopt.py`` holds the full search).
"""

import re

import numpy as np
import pytest

from mymedialite_tpu import hyperopt as jho
from mymedialite_tpu.cli import item_recommendation as jax_item
from mymedialite_tpu.cli import rating_based_ranking as jax_ranking
from mymedialite_tpu.cli import rating_prediction as jax_rating
from mymedialite_tpu.data.synthetic import split_ratings, synthetic_ratings
from mymedialite_tpu.models import wrmf as jwrmf
from mymedialite_tpu_torch import hyperopt as tho
from mymedialite_tpu_torch.cli import item_recommendation as port_item
from mymedialite_tpu_torch.cli import rating_based_ranking as port_ranking
from mymedialite_tpu_torch.cli import rating_prediction as port_rating
from mymedialite_tpu_torch.convert import wrmf_tables_from_jax
from mymedialite_tpu_torch.models import wrmf as twrmf
from torch_threads import one_torch_thread  # noqa: F401

_TIMES = re.compile(r"(training_time|testing_time|loading_time) [0-9.]+ ?")
_NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cv")
    data = synthetic_ratings(num_users=150, num_items=200, num_ratings=4000,
                             seed=8)
    train, test = split_ratings(data, seed=9)
    paths = {}
    for name, part in (("train", train), ("test", test)):
        path = d / f"{name}.tsv"
        with open(path, "w") as f:
            for u, i, v in zip(part.users, part.items, part.values):
                f.write(f"{u + 100}\t{i + 7}\t{v:g}\n")
        paths[name] = str(path)
    return paths


def run(main, argv, capsys):
    capsys.readouterr()
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def run_both(cli, argv, capsys, opts=""):
    """Both CLIs on ``argv``; the port's model takes ``device=cpu``
    (``opts`` None: a host model without options, MostPopular)."""
    jax_main, port_main = dict(rating=(jax_rating, port_rating),
                               item=(jax_item, port_item),
                               ranking=(jax_ranking, port_ranking))[cli]
    extra = ["--recommender-options", opts] if opts else []
    want = run(jax_main.main, argv + extra, capsys)
    if opts is not None:
        extra = ["--recommender-options", (opts + " device=cpu").strip()]
    got = run(port_main.main, argv + extra, capsys)
    return got, want


def assert_same_output(port_out, jax_out, atol=1e-6):
    a = _TIMES.sub("", port_out).splitlines()
    b = _TIMES.sub("", jax_out).splitlines()
    assert len(a) == len(b) > 0
    for la, lb in zip(a, b):
        assert _NUM.sub("#", la) == _NUM.sub("#", lb)
        np.testing.assert_allclose([float(x) for x in _NUM.findall(la)],
                                   [float(x) for x in _NUM.findall(lb)],
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("cli,name", [
    ("rating", "UserItemBaseline"), ("item", "MostPopular"),
    ("item", "ItemKNN"), ("ranking", "UserItemBaseline")])
def test_cross_validation(files, capsys, cli, name):
    argv = ["--training-file", files["train"], "--recommender", name,
            "--cross-validation", "3", "--show-fold-results"]
    (rc, out, _), (jrc, jout, _) = run_both(
        cli, argv, capsys, "k=20" if name == "ItemKNN" else
        (None if name == "MostPopular" else "num_iter=5"))
    assert rc == jrc == 0
    assert out.count("fold ") == 3
    assert_same_output(out, jout)


def test_cross_validation_find_iter(files, capsys):
    argv = ["--training-file", files["train"], "--recommender",
            "UserItemBaseline", "--cross-validation", "3", "--find-iter", "2",
            "--max-iter", "5"]
    (rc, out, _), (jrc, jout, _) = run_both("rating", argv, capsys,
                                            "num_iter=1")
    # a line each iteration, the folds evaluated each second one
    assert rc == jrc == 0 and out.count("iteration") == 5
    assert_same_output(out, jout)


def test_item_cross_validation_find_iter(files, capsys, monkeypatch):
    monkeypatch.setenv("MML_SEQUENTIAL_CV", "1")
    stash = []
    jax_init, port_init = jwrmf.WRMF.init_model, twrmf.WRMF.init_model

    def record(self):
        jax_init(self)
        stash.append(wrmf_tables_from_jax(self))

    monkeypatch.setattr(jwrmf.WRMF, "init_model", record)
    monkeypatch.setattr(twrmf.WRMF, "init_model",
                        lambda self, tables=None: port_init(
                            self, stash.pop(0) if tables is None else tables))
    argv = ["--training-file", files["train"], "--recommender", "WRMF",
            "--cross-validation", "2", "--find-iter", "1", "--max-iter", "2"]
    (rc, out, _), (jrc, jout, _) = run_both("item", argv, capsys,
                                            "num_factors=4 num_iter=1")
    assert rc == jrc == 0 and out.count("iteration") == 2 and not stash
    assert_same_output(out, jout)


def test_ranking_refuses_find_iter(files, capsys):
    argv = ["--training-file", files["train"], "--cross-validation", "3",
            "--find-iter", "1", "--recommender", "UserItemBaseline"]
    (rc, out, err), (jrc, jout, jerr) = run_both("ranking", argv, capsys)
    assert rc == jrc == 1 and err == jerr
    assert "--find-iter is not supported for rating-based ranking" in err
    assert_same_output(out, jout)


def test_search_hp(files, capsys, monkeypatch):
    monkeypatch.setattr(jho, "NUM_IT", 15)
    monkeypatch.setattr(tho, "NUM_IT", 15)
    argv = ["--training-file", files["train"], "--test-file", files["test"],
            "--recommender", "UserItemBaseline", "--search-hp"]
    (rc, out, err), (jrc, jout, jerr) = run_both("rating", argv, capsys)
    assert rc == jrc == 0
    assert "UserItemBaseline reg_u=" in out.splitlines()[-1]
    assert_same_output(out, jout)
    lines = [ln for ln in err.splitlines() if ln.startswith("Nelder-Mead")]
    jlines = [ln for ln in jerr.splitlines() if ln.startswith("Nelder-Mead")]
    assert len(lines) == len(jlines) > 15
    assert_same_output("\n".join(lines), "\n".join(jlines))
    assert "estimated quality (on split)" in err


def test_still_unported_flags_abort(files, capsys, tmp_path):
    """--profile, the last flag the port refused, traces a
    cross-validation run in both CLIs."""
    opts = {port_rating.main: ["--recommender-options",
                               "num_factors=4 num_iter=2 device=cpu"],
            port_item.main: []}
    for k, main in enumerate((port_rating.main, port_item.main)):
        trace = tmp_path / f"trace{k}"
        rc, _, err = run(main, ["--training-file", files["train"],
                                "--cross-validation", "2",
                                "--profile", str(trace)] + opts[main],
                         capsys)
        assert rc == 0 and f"profiling to {trace}" in err
        assert list(trace.glob("*.pt.trace.json"))
