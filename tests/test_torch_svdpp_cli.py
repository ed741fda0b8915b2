"""The port's rating_prediction CLI with the SVD++ family against the JAX
package's, in process, on synthetic files written to a temporary
directory.

With ``--test-file`` (and ratings in it) both CLIs make the model
transductive: the test pairs become its ``additional_feedback`` and join
the users' histories. The JAX models run their Pallas epoch in interpret
mode with float32 operands and short passes, as in
tests/test_torch_svdpp.py, and the port starts from the JAX model's
initial tables. Standard output is compared line by line, with the
timing fields removed and every number held to 1e-4.
"""

import functools
import re

import numpy as np
import pytest

from mymedialite_tpu.cli import rating_prediction as jax_cli
from mymedialite_tpu.data.synthetic import split_ratings, synthetic_ratings
from mymedialite_tpu.models import svdpp as jsv
from mymedialite_tpu.ops import pallas_svdpp as psv
from mymedialite_tpu_torch.cli import rating_prediction as port_cli
from mymedialite_tpu_torch.convert import svdpp_tables_from_jax
from mymedialite_tpu_torch.models import svdpp as tsv
from torch_threads import one_torch_thread  # noqa: F401

_TIMES = re.compile(r"(training_time|testing_time|loading_time) [0-9.]+ ?")
_NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")
OPTS = "num_factors=6 num_iter=3 learn_rate=0.01"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("svdpp_cli")
    data = synthetic_ratings(num_users=150, num_items=200, num_ratings=4000,
                             seed=8)
    train, test = split_ratings(data, seed=9)
    paths = {"dir": d}
    for name, part, with_values in (("train", train, True),
                                    ("test", test, True),
                                    ("pairs", test, False)):
        path = d / f"{name}.tsv"
        with open(path, "w") as f:
            for u, i, v in zip(part.users, part.items, part.values):
                f.write(f"{u + 100}\t{i + 7}" + (f"\t{v:g}\n" if with_values
                                                 else "\n"))
        paths[name] = str(path)
    return paths


@pytest.fixture
def aligned(monkeypatch):
    """The JAX package's SVD++ kernel in interpret mode with float32
    operands and passes of 256 steps; each port init_model starts from
    the tables of the oldest JAX init_model not yet replayed."""
    monkeypatch.setenv("MML_MXU", "interpret")
    monkeypatch.setenv("MMLT_COMPILE_CACHE", "0")
    monkeypatch.setattr(psv, "svdpp_epoch_mxu", functools.partial(
        psv.svdpp_epoch_mxu, mxu_dtype="f32"))
    monkeypatch.setattr(psv, "prepare_svdpp_mxu", functools.partial(
        psv.prepare_svdpp_mxu, pass_len=256))
    stash = []
    jax_init = jsv.SVDPlusPlus.init_model
    port_init = tsv.SVDPlusPlus.init_model

    def record(self):
        jax_init(self)
        stash.append(svdpp_tables_from_jax(self))

    def replay(self, tables=None):
        port_init(self, stash.pop(0) if tables is None else tables)

    monkeypatch.setattr(jsv.SVDPlusPlus, "init_model", record)
    monkeypatch.setattr(tsv.SVDPlusPlus, "init_model", replay)


def _run(cli, argv, opts, capsys):
    capsys.readouterr()
    assert cli.main(argv + ["--recommender-options", opts]) == 0
    return capsys.readouterr().out


def run_both(argv, capsys):
    jax_out = _run(jax_cli, argv, OPTS, capsys)
    port_out = _run(port_cli, argv, OPTS + " device=cpu", capsys)
    return jax_out, port_out


def assert_same_output(port_out, jax_out):
    a = _TIMES.sub("", port_out).splitlines()
    b = _TIMES.sub("", jax_out).splitlines()
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert _NUM.sub("#", la) == _NUM.sub("#", lb)
        na = [float(x) for x in _NUM.findall(la)]
        nb = [float(x) for x in _NUM.findall(lb)]
        np.testing.assert_allclose(na, nb, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["SVDPlusPlus",
                                  "SigmoidCombinedAsymmetricFactorModel"])
def test_transductive_test_file(files, aligned, capsys, name):
    jax_out, port_out = run_both(
        ["--training-file", files["train"], "--test-file", files["test"],
         "--recommender", name, "--compute-fit"], capsys)
    assert port_out.splitlines()[-2].startswith(f"{name} num_factors=6")
    assert "RMSE" in port_out and "\nfit " in port_out
    assert_same_output(port_out, jax_out)


def test_test_ratio_is_not_transductive(files, aligned, capsys):
    jax_out, port_out = run_both(
        ["--training-file", files["train"], "--test-ratio", "0.25",
         "--random-seed", "3", "--recommender", "SigmoidSVDPlusPlus"],
        capsys)
    assert port_out.splitlines()[-1].startswith("SigmoidSVDPlusPlus ")
    assert_same_output(port_out, jax_out)


def test_save_load_across_clis(files, aligned, capsys):
    d = files["dir"]
    common = ["--training-file", files["train"], "--test-file", files["test"],
              "--recommender", "SVDPlusPlus"]
    jax_out = _run(jax_cli, common + ["--save-model", str(d / "j.model")],
                   OPTS, capsys)
    port_out = _run(port_cli, common + ["--save-model", str(d / "t.model")],
                    OPTS + " device=cpu", capsys)
    assert_same_output(port_out, jax_out)
    # each CLI loads the other's model and reports the trained result line
    port_loaded = _run(port_cli, common + ["--load-model", str(d / "j.model")],
                       OPTS + " device=cpu", capsys)
    jax_loaded = _run(jax_cli, common + ["--load-model", str(d / "t.model")],
                      OPTS, capsys)
    trained = _TIMES.sub("", port_out).splitlines()[-1]
    for loaded in (port_loaded, jax_loaded):
        assert_same_output(trained, _TIMES.sub("", loaded).splitlines()[-1])
    # the port's own save -> load reproduces its result line exactly
    again = _run(port_cli, common + ["--load-model", str(d / "t.model")],
                 OPTS + " device=cpu", capsys)
    assert _TIMES.sub("", again).splitlines()[-1] == \
        _TIMES.sub("", port_out).splitlines()[-1]


@pytest.fixture
def created(monkeypatch):
    """The models the port's CLI creates, in order."""
    made = []
    real = port_cli.create_rating_predictor

    def create(name, options=""):
        made.append(real(name, options))
        return made[-1]

    monkeypatch.setattr(port_cli, "create_rating_predictor", create)
    return made


def test_additional_feedback_only_from_rated_test_file(files, created,
                                                       capsys):
    """--test-file with ratings makes the model transductive on the test
    pairs; --test-no-ratings and --test-ratio do not."""
    base = ["--training-file", files["train"], "--recommender", "SVDPlusPlus",
            "--recommender-options", "num_factors=4 num_iter=1 device=cpu"]
    d = files["dir"]
    runs = {"test-file": ["--test-file", files["test"]],
            "test-no-ratings": ["--test-file", files["pairs"],
                                "--test-no-ratings", "--prediction-file",
                                str(d / "pred.txt")],
            "test-ratio": ["--test-ratio", "0.2"]}
    for argv in runs.values():
        assert port_cli.main(base + argv) == 0
    transductive, no_ratings, ratio = created
    # the CLI numbers ids in the order it first reads them: the training
    # file, then the test file
    train = np.loadtxt(files["train"]).astype(int)
    test = np.loadtxt(files["test"]).astype(int)
    for col, got in enumerate(transductive.additional_feedback):
        ids = {}
        for x in np.concatenate([train[:, col], test[:, col]]):
            ids.setdefault(x, len(ids))
        np.testing.assert_array_equal(got, [ids[x] for x in test[:, col]])
    assert no_ratings.additional_feedback is None
    assert ratio.additional_feedback is None
    assert len(open(d / "pred.txt").read().splitlines()) == len(test)
    capsys.readouterr()
