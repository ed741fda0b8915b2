"""The port's item_recommendation CLI against the JAX package's, in
process, on synthetic positive-only files written to a temporary
directory.

Both CLIs get the same flags; the JAX model takes ``mxu_dtype=f32`` and
the port ``device=cpu``, neither of which the echo line shows. With
``MostPopular`` (the default recommender) standard output is identical
once the timing fields are removed. With ``BPRMF`` the JAX epoch runs in
interpret mode, the port starts from the JAX model's initial tables and
takes its random bits, and the lines have the same fields with every
number within 1e-3 (the tables agree to 1e-4, tests/test_torch_bpr.py).
"""

import re

import numpy as np
import pytest
import torch

import jax

from mymedialite_tpu.cli import item_recommendation as jax_cli
from mymedialite_tpu.data.synthetic import split_posonly, synthetic_posonly
from mymedialite_tpu.models import bpr as jbpr
from mymedialite_tpu.ops import pallas_bpr as pb
from mymedialite_tpu_torch.cli import item_recommendation as port_cli
from mymedialite_tpu_torch.convert import bpr_tables_from_jax
from mymedialite_tpu_torch.models import bpr as tbpr
from mymedialite_tpu_torch.ops.bpr_epoch import bpr_epoch
from torch_threads import one_torch_thread  # noqa: F401

_TIMES = re.compile(r"(training_time|testing_time|loading_time) [0-9.]+ ?")
_NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("itemcli")
    fb = synthetic_posonly(num_users=700, num_items=600, num_events=8000,
                           seed=21)
    train, test = split_posonly(fb, seed=22)
    paths = {"dir": d}
    for name, part in (("train", train), ("test", test)):
        path = d / f"{name}.tsv"
        with open(path, "w") as f:
            for u, i in zip(part.users, part.items):
                f.write(f"{u + 100}\t{i + 7}\n")
        paths[name] = str(path)
    with open(d / "cand.txt", "w") as f:
        f.writelines(f"{i + 7}\n" for i in range(0, 600, 4))
    with open(d / "users.txt", "w") as f:
        f.writelines(f"{u + 100}\n" for u in range(0, 700, 5))
    paths["cand"], paths["users"] = str(d / "cand.txt"), str(d / "users.txt")
    return paths


@pytest.fixture
def aligned(monkeypatch):
    """JAX runs its Pallas epoch in interpret mode; the port's next
    init_model starts from the tables of the JAX model's last one and
    its epochs take the JAX bits."""
    monkeypatch.setenv("MML_MXU", "interpret")
    monkeypatch.setenv("MMLT_COMPILE_CACHE", "0")
    stash = {}
    jax_init = jbpr.BPRMF.init_model
    port_init = tbpr.BPRMF.init_model

    def record(self):
        jax_init(self)
        stash["tables"] = bpr_tables_from_jax(self)

    def replay(self, tables=None):
        port_init(self, stash["tables"] if tables is None else tables)

    def bits(self, seed, nc, trials, C):
        key = jax.random.key(seed & 0x7FFFFFFF, impl="unsafe_rbg")
        return torch.from_numpy(np.array(
            pb.epoch_random_bits(key, nc=nc, trials=trials, C=C)))

    monkeypatch.setattr(jbpr.BPRMF, "init_model", record)
    monkeypatch.setattr(tbpr.BPRMF, "init_model", replay)
    monkeypatch.setattr(tbpr.BPRMF, "_epoch_bits", bits)


def _run(cli, argv, capsys):
    capsys.readouterr()
    assert cli.main(argv) == 0
    return capsys.readouterr().out


def run_both(argv, capsys, opts=None):
    jax_argv, port_argv = list(argv), list(argv)
    if opts is not None:
        jax_argv += ["--recommender-options", opts + " mxu_dtype=f32"]
        port_argv += ["--recommender-options", opts + " device=cpu"]
    return _run(jax_cli, jax_argv, capsys), _run(port_cli, port_argv, capsys)


def assert_same_output(port_out, jax_out, atol=0.0):
    a = _TIMES.sub("", port_out).splitlines()
    b = _TIMES.sub("", jax_out).splitlines()
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert _NUM.sub("#", la) == _NUM.sub("#", lb)
        np.testing.assert_allclose([float(x) for x in _NUM.findall(la)],
                                   [float(x) for x in _NUM.findall(lb)],
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("flags", [
    [], ["--all-items"], ["--in-training-items", "--predict-items-number",
                          "10"],
    ["--in-test-items"], ["--repeated-items"],
    ["--candidate-items", "CAND", "--test-users", "USERS"],
    ["--num-test-users", "50", "--random-seed", "4"]],
    ids=["overlap", "all-items", "training-n10", "test-items", "repeated",
         "explicit", "num-test-users"])
def test_most_popular_identical(files, capsys, flags):
    flags = [files["cand"] if f == "CAND" else files["users"]
             if f == "USERS" else f for f in flags]
    jax_out, port_out = run_both(
        ["--training-file", files["train"], "--test-file", files["test"]]
        + flags, capsys)
    assert "MostPopular by_user=False" in port_out and "AUC" in port_out
    assert _TIMES.sub("", port_out) == _TIMES.sub("", jax_out)


def test_test_ratio_and_prediction_file(files, capsys):
    d = files["dir"]
    argv = ["--training-file", files["train"], "--test-ratio", "0.2",
            "--random-seed", "3", "--predict-items-number", "5",
            "--recommender-options", "by_user=true"]
    jax_out = _run(jax_cli, argv + ["--prediction-file", str(d / "j.txt")],
                   capsys)
    port_out = _run(port_cli, argv + ["--prediction-file", str(d / "p.txt")],
                    capsys)
    assert _TIMES.sub("", port_out) == _TIMES.sub("", jax_out)
    got, want = open(d / "p.txt").read(), open(d / "j.txt").read()
    assert got.count("\n") > 600 and got == want


def test_bprmf_same_fields(files, aligned, capsys):
    before = bpr_epoch.launches
    jax_out, port_out = run_both(
        ["--training-file", files["train"], "--test-file", files["test"],
         "--recommender", "BPRMF"], capsys, "num_factors=8 num_iter=3")
    assert bpr_epoch.launches == before     # the CPU runs the plain epoch
    last = port_out.splitlines()[-1]
    assert last.startswith("BPRMF num_factors=8 ") and "AUC" in last
    assert_same_output(port_out, jax_out, atol=1e-3)


def test_bprmf_find_iter(files, aligned, capsys):
    jax_out, port_out = run_both(
        ["--training-file", files["train"], "--test-file", files["test"],
         "--recommender", "BPRMF", "--find-iter", "1", "--max-iter", "3"],
        capsys, "num_factors=8 num_iter=1")
    assert "iteration 1" in port_out and "iteration 3" in port_out
    assert_same_output(port_out, jax_out, atol=1e-3)


def test_bprmf_save_load(files, capsys):
    d = files["dir"]
    common = ["--training-file", files["train"], "--test-file", files["test"],
              "--recommender", "BPRMF", "--recommender-options",
              "num_factors=8 num_iter=2 device=cpu"]
    trained = _run(port_cli, common + ["--save-model", str(d / "b.model")],
                   capsys)
    loaded = _run(port_cli, common + ["--load-model", str(d / "b.model")],
                  capsys)
    assert _TIMES.sub("", loaded) == _TIMES.sub("", trained)
    # the JAX CLI reads the port's model file and ranks the same
    jax_loaded = _run(jax_cli, common[:-1] + [
        "num_factors=8 num_iter=2", "--load-model", str(d / "b.model")],
        capsys)
    assert_same_output(loaded, jax_loaded, atol=1e-6)


@pytest.mark.parametrize("flags", [
    [], ["--test-users", "CAND", "--candidate-items", "USERS"],
    ["--predict-items-number", "5", "--prediction-file", "PRED"]],
    ids=["all", "explicit", "prediction-file"])
def test_user_prediction_most_popular_identical(files, capsys, flags):
    """--user-prediction recommends users for items: the files and the
    mappings swap and the feedback is transposed, as in the JAX CLI."""
    d = files["dir"]
    out = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        argv = ["--training-file", files["train"], "--test-file",
                files["test"], "--user-prediction"] + [
            files["cand"] if f == "CAND" else files["users"] if f == "USERS"
            else str(d / f"{name}-users.txt") if f == "PRED" else f
            for f in flags]
        out[name] = _run(cli, argv, capsys)
    assert "AUC" in out["port"]
    assert _TIMES.sub("", out["port"]) == _TIMES.sub("", out["jax"])
    if "PRED" in flags:
        got = open(d / "port-users.txt").read()
        assert got.count("\n") > 500          # one line per item
        assert got == open(d / "jax-users.txt").read()


def test_user_prediction_bprmf_same_fields(files, aligned, capsys):
    jax_out, port_out = run_both(
        ["--training-file", files["train"], "--test-file", files["test"],
         "--recommender", "BPRMF", "--user-prediction"], capsys,
        "num_factors=8 num_iter=2")
    assert "AUC" in port_out.splitlines()[-1]
    assert_same_output(port_out, jax_out, atol=1e-3)


def test_online_evaluation_most_popular_identical(files, capsys):
    jax_out, port_out = run_both(
        ["--training-file", files["train"], "--test-file", files["test"],
         "--online-evaluation"], capsys)
    assert "AUC" in port_out
    assert _TIMES.sub("", port_out) == _TIMES.sub("", jax_out)


@pytest.mark.parametrize("flags", [[], ["--find-iter", "1", "--max-iter",
                                          "3"]], ids=["once", "find-iter"])
def test_online_evaluation_bprmf_runs(files, capsys, flags):
    """BPRMF's online refreshes draw from the port's generator, so its
    numbers are not the JAX package's (whose per-user refreshes take
    minutes on this data). Its result fields, the candidate items and the
    users evaluated are those of the JAX CLI's online MostPopular line."""
    argv = ["--training-file", files["train"], "--test-file", files["test"],
            "--online-evaluation"]
    ref = _run(jax_cli, argv, capsys).splitlines()[-1]
    out = _run(port_cli, argv + flags + [
        "--recommender", "BPRMF", "--recommender-options",
        "num_factors=8 num_iter=2 device=cpu"], capsys).splitlines()
    got = out[-1]
    if flags:
        assert got.endswith(" iteration 3")
        got = got.rsplit(" iteration", 1)[0]
    tail = got[got.index("AUC"):]
    assert _NUM.sub("#", _TIMES.sub("", tail)).strip() == \
        _NUM.sub("#", _TIMES.sub("", ref[ref.index("AUC"):])).strip()
    assert tail.split("num_items")[1].split()[:3] == \
        ref.split("num_items")[1].split()[:3]


def test_online_evaluation_needs_an_incremental_model(files, capsys):
    for cli in (port_cli, jax_cli):
        with pytest.raises(TypeError, match="incremental"):
            cli.main(["--training-file", files["train"], "--test-file",
                      files["test"], "--recommender", "Zero",
                      "--online-evaluation"])


@pytest.mark.parametrize("argv", [
    ["--profile", "trace"], ["--recommender", "BPRSLIM"]],
    ids=["profile", "unported-model"])
def test_unported_flags_abort(files, argv, capsys, tmp_path):
    """What the port refused before: ``--profile DIR`` now writes a
    torch.profiler trace into DIR, and BPRSLIM trains, ranks and prints
    the JAX CLI's fields (its triples come from another generator, so
    the measures are held to the JAX run's loosely)."""
    base = ["--training-file", files["train"], "--test-file", files["test"]]
    if argv[0] == "--profile":
        trace = tmp_path / "trace"
        port_out = _run(port_cli, base + ["--profile", str(trace)], capsys)
        assert "AUC" in port_out.splitlines()[-1]
        assert list(trace.glob("*.pt.trace.json"))
        return
    opts = ["--recommender-options", "num_iter=2 batch_size=512"]
    jax_out = _run(jax_cli, base + argv + opts, capsys)
    opts[1] += " device=cpu"
    port_out = _run(port_cli, base + argv + opts, capsys)
    assert port_out.splitlines()[-1].startswith("BPRSLIM reg_i=")
    assert_same_output(port_out, jax_out, atol=0.05)


def test_version_flag(capsys):
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["--version"])
    assert exc.value.code == 0
    assert "item_recommendation" in capsys.readouterr().out
