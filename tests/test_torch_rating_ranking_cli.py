"""The port's rating_based_ranking CLI against the JAX package's, in
process, on synthetic rating files written to a temporary directory.

Both CLIs get the same flags; the JAX model takes ``mxu_dtype=f32`` and
the port ``device=cpu``, neither of which the echo line shows. As in
tests/test_torch_cli.py the JAX epoch runs in interpret mode with the
host epoch order and the port starts from the JAX model's initial
tables. Standard output is compared line by line, with the timing
fields removed and every number held to 1e-4 (the tables agree to about
1e-6 after 3 epochs; a ranking measure moves only where two scores swap).
"""

import re

import numpy as np
import pytest

from mymedialite_tpu.cli import rating_based_ranking as jax_cli
from mymedialite_tpu.data.synthetic import split_ratings, synthetic_ratings
from mymedialite_tpu.models import mf as jmf
from mymedialite_tpu.ops import pallas_sgd as ps
from mymedialite_tpu_torch.cli import rating_based_ranking as port_cli
from mymedialite_tpu_torch.convert import tables_from_jax
from mymedialite_tpu_torch.models import mf as tmf
from torch_threads import one_torch_thread  # noqa: F401

_TIMES = re.compile(r"(training_time|testing_time|loading_time) [0-9.]+ ?")
_NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")
OPTS = "num_factors=8 num_iter=3"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("rbr")
    data = synthetic_ratings(num_users=150, num_items=200, num_ratings=4000,
                             seed=18)
    train, test = split_ratings(data, seed=19)
    paths = {"dir": d}
    for name, part in (("train", train), ("test", test)):
        path = d / f"{name}.tsv"
        with open(path, "w") as f:
            for u, i, v in zip(part.users, part.items, part.values):
                f.write(f"{u + 100}\t{i + 7}\t{v:g}\n")
        paths[name] = str(path)
    with open(d / "cand.txt", "w") as f:
        f.writelines(f"{i + 7}\n" for i in range(0, 200, 3))
    with open(d / "users.txt", "w") as f:
        f.writelines(f"{u + 100}\n" for u in range(0, 150, 4))
    paths["cand"], paths["users"] = str(d / "cand.txt"), str(d / "users.txt")
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


def run_both(argv, capsys, opts=OPTS):
    jax_out = _run(jax_cli, argv, opts + " mxu_dtype=f32", capsys)
    port_out = _run(port_cli, argv, opts + " device=cpu", capsys)
    return jax_out, port_out


def assert_same_output(port_out, jax_out, atol=1e-4):
    a = _TIMES.sub("", port_out).splitlines()
    b = _TIMES.sub("", jax_out).splitlines()
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert _NUM.sub("#", la) == _NUM.sub("#", lb)
        np.testing.assert_allclose([float(x) for x in _NUM.findall(la)],
                                   [float(x) for x in _NUM.findall(lb)],
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("flags", [
    [], ["--overlap-items"], ["--in-training-items"], ["--in-test-items"],
    ["--all-items"], ["--candidate-items", "CAND"],
    ["--test-users", "USERS", "--overlap-items"]],
    ids=["union", "overlap", "training", "test", "all-items", "explicit",
         "test-users"])
def test_candidate_modes(files, aligned, capsys, flags):
    flags = [files["cand"] if f == "CAND" else files["users"]
             if f == "USERS" else f for f in flags]
    jax_out, port_out = run_both(
        ["--training-file", files["train"], "--test-file", files["test"]]
        + flags, capsys)
    last = port_out.splitlines()[-1]
    assert last.startswith("BiasedMatrixFactorization num_factors=8 ")
    assert "AUC" in last and "training data:" in port_out
    assert_same_output(port_out, jax_out)


def test_plain_mf_and_find_iter(files, aligned, capsys):
    jax_out, port_out = run_both(
        ["--training-file", files["train"], "--test-file", files["test"],
         "--recommender", "MatrixFactorization", "--find-iter", "1",
         "--max-iter", "3"], capsys, "num_factors=8 num_iter=1")
    assert "iteration 1" in port_out and "iteration 3" in port_out
    assert_same_output(port_out, jax_out)


def test_save_load(files, monkeypatch, capsys):
    monkeypatch.setenv("MMLT_COMPILE_CACHE", "0")
    d = files["dir"]
    common = ["--training-file", files["train"], "--test-file", files["test"]]
    port_opts = OPTS + " device=cpu"
    trained = _run(port_cli, common + ["--save-model", str(d / "p.model")],
                   port_opts, capsys)
    loaded = _run(port_cli, common + ["--load-model", str(d / "p.model")],
                  port_opts, capsys)
    strip = lambda text: _TIMES.sub("", text)  # noqa: E731
    assert strip(loaded) == strip(trained)
    # the JAX CLI ranks the same with the port's model file
    jax_loaded = _run(jax_cli, common + ["--load-model", str(d / "p.model")],
                      OPTS + " mxu_dtype=f32", capsys)
    assert_same_output(loaded, jax_loaded, atol=1e-6)


@pytest.mark.parametrize("argv", [["--profile", "trace"]], ids=["profile"])
def test_unported_flags_abort(files, argv, capsys, tmp_path):
    """--profile DIR, refused before, writes a torch.profiler trace into
    DIR and the run prints its result line."""
    trace = tmp_path / argv[1]
    capsys.readouterr()
    assert port_cli.main(["--training-file", files["train"], "--test-file",
                          files["test"], "--profile", str(trace),
                          "--recommender-options",
                          "num_factors=4 num_iter=1 device=cpu"]) == 0
    out, err = capsys.readouterr()
    assert "AUC" in out.splitlines()[-1] and "profiling to" in err
    assert list(trace.glob("*.pt.trace.json"))


def test_needs_a_test_file(files, capsys):
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["--training-file", files["train"]])
    assert exc.value.code == 1
    assert "--test-file" in capsys.readouterr().err


def test_version_flag(capsys):
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["--version"])
    assert exc.value.code == 0
    assert "rating_based_ranking" in capsys.readouterr().out
