"""The port's rating_prediction CLI against the JAX package's, in process,
on synthetic files written to a temporary directory.

Both CLIs get the same flags; the JAX model takes ``mxu_dtype=f32`` and
the port ``device=cpu``, neither of which the echo line shows. As in
tests/test_torch_mf.py the JAX epoch runs in interpret mode with the
host epoch order, and the port starts from the JAX model's initial
tables. Standard output is compared line by line, with the timing
fields removed and every number held to 1e-4.
"""

import re

import numpy as np
import pytest

from mymedialite_tpu.cli import rating_prediction as jax_cli
from mymedialite_tpu.data.synthetic import split_ratings, synthetic_ratings
from mymedialite_tpu.models import mf as jmf
from mymedialite_tpu.ops import pallas_sgd as ps
from mymedialite_tpu_torch.cli import rating_prediction as port_cli
from mymedialite_tpu_torch.convert import tables_from_jax
from mymedialite_tpu_torch.models import mf as tmf
from torch_threads import one_torch_thread  # noqa: F401

_TIMES = re.compile(r"(training_time|testing_time|loading_time) [0-9.]+ ?")
_NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
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
    paths["dir"] = d
    return paths


@pytest.fixture
def aligned(monkeypatch):
    """JAX runs its Pallas epoch in interpret mode with the host epoch
    order; the port's next init_model starts from the tables of the JAX
    model's last one."""
    monkeypatch.setenv("MML_MXU", "interpret")
    monkeypatch.setenv("MMLT_COMPILE_CACHE", "0")
    monkeypatch.setattr(ps, "device_epoch_order",
                        lambda plan, seed: plan.epoch_order(seed))
    stash = {}
    jax_init = jmf.MatrixFactorization.init_model
    port_init = tmf.MatrixFactorization.init_model

    def record(self):
        jax_init(self)
        stash["tables"] = tables_from_jax(self)

    def replay(self, tables=None):
        port_init(self, stash["tables"] if tables is None else tables)

    monkeypatch.setattr(jmf.MatrixFactorization, "init_model", record)
    monkeypatch.setattr(tmf.MatrixFactorization, "init_model", replay)


def _run(cli, argv, opts, capsys):
    capsys.readouterr()
    assert cli.main(argv + ["--recommender-options", opts]) == 0
    return capsys.readouterr().out


def run_both(argv, capsys, opts="num_factors=8 num_iter=3"):
    jax_out = _run(jax_cli, argv, opts + " mxu_dtype=f32", capsys)
    port_out = _run(port_cli, argv, opts + " device=cpu", capsys)
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


def test_standard_path(files, aligned, capsys):
    jax_out, port_out = run_both(
        ["--training-file", files["train"], "--test-file", files["test"],
         "--compute-fit"], capsys)
    assert "BiasedMatrixFactorization num_factors=8" in port_out
    assert "RMSE" in port_out and "\nfit " in port_out
    assert_same_output(port_out, jax_out)


def test_test_ratio_plain_mf(files, aligned, capsys):
    jax_out, port_out = run_both(
        ["--training-file", files["train"], "--test-ratio", "0.25",
         "--random-seed", "3", "--recommender", "MatrixFactorization"],
        capsys)
    assert port_out.splitlines()[-1].startswith("MatrixFactorization ")
    assert_same_output(port_out, jax_out)


def test_find_iter(files, aligned, capsys):
    jax_out, port_out = run_both(
        ["--training-file", files["train"], "--test-file", files["test"],
         "--find-iter", "1", "--max-iter", "4"],
        capsys, opts="num_factors=8 num_iter=2 bold_driver=true")
    assert "iteration 2" in port_out and "iteration 4" in port_out
    assert_same_output(port_out, jax_out)


def test_save_load_and_prediction_file(files, aligned, capsys):
    d = files["dir"]
    common = ["--training-file", files["train"], "--test-file", files["test"]]
    jax_out, port_out = run_both(
        common + ["--save-model", str(d / "m.model"),
                  "--prediction-file", str(d / "p.txt")], capsys)
    assert_same_output(port_out, jax_out)
    trained_pred = open(d / "p.txt").read().splitlines()
    # the port's own save -> load reproduces its result line
    port_out = _run(port_cli, common + ["--save-model", str(d / "t.model")],
                    "num_factors=8 num_iter=3 device=cpu", capsys)
    loaded = _run(port_cli, common + ["--load-model", str(d / "t.model")],
                  "num_factors=8 num_iter=3 device=cpu", capsys)
    assert _TIMES.sub("", loaded) == _TIMES.sub("", port_out)
    # a model saved by the JAX CLI loads in the port's CLI and predicts
    # what the port's own training predicted
    jax_loaded = _run(jax_cli, common + ["--load-model", str(d / "m.model")],
                      "num_factors=8 num_iter=3 mxu_dtype=f32", capsys)
    port_loaded = _run(port_cli, common + ["--load-model", str(d / "m.model"),
                                           "--prediction-file",
                                           str(d / "q.txt")],
                       "num_factors=8 num_iter=3 device=cpu", capsys)
    assert_same_output(port_loaded, jax_loaded)
    from_jax_pred = open(d / "q.txt").read().splitlines()
    assert len(trained_pred) == len(from_jax_pred) > 0
    for a, b in zip(trained_pred, from_jax_pred):
        ua, ia, pa = a.split("\t")
        ub, ib, pb = b.split("\t")
        assert (ua, ia) == (ub, ib)
        assert abs(float(pa) - float(pb)) <= 1e-4


def test_online_evaluation_user_item_baseline_identical(files, capsys):
    argv = ["--training-file", files["train"], "--test-file", files["test"],
            "--recommender", "UserItemBaseline", "--online-evaluation"]
    jax_out = _run(jax_cli, argv, "reg_u=5", capsys)
    port_out = _run(port_cli, argv, "reg_u=5 device=cpu", capsys)
    assert port_out.splitlines()[-1].startswith("UserItemBaseline ")
    assert _TIMES.sub("", port_out) == _TIMES.sub("", jax_out)


def test_online_evaluation_biased_mf(files, aligned, capsys):
    """At init_stdev=0 a refreshed row starts at init_mean in both
    packages, so the prequential results agree (1e-4)."""
    jax_out, port_out = run_both(
        ["--training-file", files["train"], "--test-file", files["test"],
         "--online-evaluation"], capsys,
        opts="num_factors=8 num_iter=3 init_stdev=0")
    assert "RMSE" in port_out.splitlines()[-1]
    assert_same_output(port_out, jax_out)


def write_trust(path, num_users=150, seed=4):
    """Each user of the rating files trusts three others (original ids)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for u in range(num_users):
            for v in rng.choice(num_users, 3, replace=False):
                f.write(f"{u + 100}\t{v + 100}\n")
    return str(path)


@pytest.mark.parametrize("argv", [
    ["--profile", "trace"], ["--recommender", "SocialMF"]],
    ids=["profile", "unported-model"])
def test_unported_flags_abort(files, argv, capsys, tmp_path, request):
    """What the port refused before: ``--profile DIR`` now writes a
    torch.profiler trace into DIR; SocialMF (with the --user-relations it
    requires) trains from the JAX model's tables and prints the JAX
    CLI's lines."""
    base = ["--training-file", files["train"], "--test-file", files["test"]]
    if argv[0] == "--profile":
        trace = tmp_path / "trace"
        capsys.readouterr()
        assert port_cli.main(base + ["--profile", str(trace),
                                     "--recommender-options",
                                     "num_factors=4 num_iter=1 device=cpu"]) \
            == 0
        out, err = capsys.readouterr()
        assert f"profiling to {trace}" in err and "RMSE" in out
        assert list(trace.glob("*.pt.trace.json"))
        return
    request.getfixturevalue("aligned")
    argv = base + argv + ["--user-relations",
                          write_trust(tmp_path / "trust.tsv")]
    jax_out, port_out = run_both(
        argv, capsys, opts="num_factors=6 num_iter=20 learn_rate=0.002 "
        "social_regularization=0.5")
    assert port_out.splitlines()[-1].startswith("SocialMF num_factors=6")
    assert_same_output(port_out, jax_out)


def test_version_flag(capsys):
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["--version"])
    assert exc.value.code == 0
    assert "rating_prediction" in capsys.readouterr().out
