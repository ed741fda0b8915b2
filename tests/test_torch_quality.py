"""The port's quality driver (``mymedialite_tpu_torch/quality.py``)
against the JAX package's (the root ``quality.py``, read with ``ast``,
never imported), on the CPU: the same configurations, name for name and
option string for option string; at ``--small`` the same data arrays as
the JAX package's generators and splits at seeds 100/101, 110/111 and
102/103; the same trust graph on the JAX package's planted factors; and
a run of a few rows with ``--seeds 2 --runs 2 --json`` that gives
finite, parseable records with distinct seeds and a band line per row.
Without a card and without ``--device cpu`` the driver raises.
"""

import ast
import json
import math
import os

import numpy as np
import pytest

from mymedialite_tpu.data import synthetic as jsyn
from mymedialite_tpu_torch import quality
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.05


def jax_driver_lists():
    """(rating configs, time-aware configs, item configs) as the root
    quality.py's source spells them."""
    with open(os.path.join(REPO, "quality.py")) as f:
        tree = ast.parse(f.read())
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id in ("rating_configs", "item_configs"):
            found[node.targets[0].id] = ast.literal_eval(node.value)
        if isinstance(node, ast.For) and isinstance(node.iter, ast.List):
            found["time_aware"] = ast.literal_eval(node.iter)
    return found["rating_configs"], found["time_aware"], found["item_configs"]


def test_configurations_equal_the_jax_drivers():
    rating, time_aware, item = jax_driver_lists()
    assert [tuple(c) for c in rating] == quality.RATING_CONFIGS
    assert [tuple(c) for c in time_aware] == quality.TIME_AWARE_CONFIGS
    assert [tuple(c) for c in item] == quality.ITEM_CONFIGS
    assert len(rating) == 9 and len(time_aware) == 3 and len(item) == 10


def same_data(port, jax_data, fields):
    assert (port.num_users, port.num_items, len(port)) == \
        (jax_data.num_users, jax_data.num_items, len(jax_data))
    for name in fields:
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(jax_data, name), err_msg=name)


def n(full, floor):
    return quality.scaled(full, SCALE, floor)


def test_rating_data_equals_the_jax_packages():
    train, test, P = quality.rating_data(SCALE)
    data, (jP, _, _, _) = jsyn.synthetic_ratings(
        num_users=n(6040, 60), num_items=n(3706, 40),
        num_ratings=n(1_000_000, 5000), seed=100, return_factors=True)
    jtrain, jtest = jsyn.split_ratings(data, 0.1, seed=101)
    for port, jax_data in ((train, jtrain), (test, jtest)):
        same_data(port, jax_data, ("users", "items", "values"))
    np.testing.assert_array_equal(P, jP)


def test_timed_data_equals_the_jax_packages():
    train, test = quality.timed_data(SCALE)
    data = jsyn.synthetic_ratings(
        num_users=n(6040, 60), num_items=n(3706, 40),
        num_ratings=n(1_000_000, 5000), seed=110, with_times=True,
        time_drift=1.0)
    jtrain, jtest = jsyn.split_ratings(data, 0.1, seed=111)
    for port, jax_data in ((train, jtrain), (test, jtest)):
        same_data(port, jax_data, ("users", "items", "values", "times"))


def test_implicit_data_equals_the_jax_packages():
    train, test = quality.implicit_data(SCALE)
    pos = jsyn.synthetic_posonly(num_users=n(6040, 60), num_items=n(3706, 40),
                                 num_events=n(500_000, 4000), seed=102)
    jtrain, jtest = jsyn.split_posonly(pos, 0.2, seed=103)
    for port, jax_data in ((train, jtrain), (test, jtest)):
        same_data(port, jax_data, ("users", "items"))


@pytest.mark.parametrize("scale", [SCALE, 0.2])
def test_trust_graph_equals_the_jax_drivers(scale):
    _, (P_true, _, _, _) = jsyn.synthetic_ratings(
        num_users=quality.scaled(6040, scale, 60),
        num_items=quality.scaled(3706, scale, 40),
        num_ratings=quality.scaled(1_000_000, scale, 5000), seed=100,
        return_factors=True)
    # quality.py:57-69, line for line
    Pn = P_true / np.maximum(
        np.linalg.norm(P_true, axis=1, keepdims=True), 1e-9)
    sim = Pn @ Pn.T
    np.fill_diagonal(sim, -np.inf)
    k_trust = 10
    nbr = np.argpartition(-sim, k_trust, axis=1)[:, :k_trust]
    trust_u = np.repeat(np.arange(P_true.shape[0], dtype=np.int32), k_trust)
    trust_v = nbr.astype(np.int32).reshape(-1)
    got = quality.trust_graph(P_true)
    np.testing.assert_array_equal(got.users, trust_u)
    np.testing.assert_array_equal(got.items, trust_v)
    assert got.num_users == got.num_items == P_true.shape[0]
    assert not (got.users == got.items).any()


def test_a_few_rows_give_seed_bands(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(quality, "RATING_CONFIGS", [
        ("GlobalAverage", ""),
        ("BiasedMatrixFactorization", "num_factors=4 num_iter=3"),
        ("SocialMF", "num_factors=4 num_iter=5 learn_rate=0.0002")])
    monkeypatch.setattr(quality, "TIME_AWARE_CONFIGS",
                        [("TimeAwareBaseline", "num_iter=2")])
    monkeypatch.setattr(quality, "ITEM_CONFIGS", [
        ("MostPopular", ""), ("BPRMF", "num_factors=4 num_iter=3"),
        ("WRMF", "num_factors=4 num_iter=2")])
    path = tmp_path / "q.jsonl"
    records = quality.main(["--small", "--device", "cpu", "--seeds", "2",
                            "--runs", "2", "--json", str(path)])
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert lines == json.loads(json.dumps(records))
    # 2 rows without a seed x 2 runs, 5 seeded rows x 2 seeds x 2 runs
    assert len(lines) == 2 * 2 + 5 * 2 * 2
    by_row = {}
    for rec in lines:
        assert rec["device"] == "cpu" and rec["kernels"] == {}
        assert rec["train_s"] >= 0 and rec["eval_s"] >= 0
        assert all(math.isfinite(v) for v in rec["metrics"].values())
        by_row.setdefault((rec["section"], rec["name"]), []).append(rec)
    assert len(by_row) == 7
    for (section, name), recs in by_row.items():
        seeds = sorted({r["seed"] for r in recs}, key=str)
        assert sorted(r["run"] for r in recs) == [0] * len(seeds) + \
            [1] * len(seeds)
        if name in ("GlobalAverage", "MostPopular"):
            assert seeds == [None]
        else:
            assert seeds == [42, 43], (name, seeds)
        want = {"BiasedMatrixFactorization": "resident", "BPRMF": "resident"}
        assert {r["route"] for r in recs} == {want.get(name, "plain")}
        key = "AUC" if section == "item" else "RMSE"
        assert all(key in r["metrics"] for r in recs)
        # on the CPU two runs of one seed agree bit for bit
        for seed in seeds:
            runs = [r["metrics"] for r in recs if r["seed"] == seed]
            assert runs[0] == runs[1], (name, seed)
    a, b = (r["metrics"]["RMSE"] for r in by_row[
        ("rating", "BiasedMatrixFactorization")] if r["run"] == 0)
    assert a != b       # the seed moves the trajectory
    out = capsys.readouterr().out
    assert out.count("  band over ") == 7
    assert out.count("band over seeds 42-43 (2)") == 5
    assert "[resident; no kernel] seed 43 run 1" in out


def test_the_card_is_the_default(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        quality.main(["--small"])
    with pytest.raises(SystemExit):
        quality.main(["--small", "--device", "cpu", "--seeds", "0"])
