"""The generator: the same seed gives the same log, the distinct count is
the one asked for, and the distribution is data/synthetic.py's."""

import json
import os

import numpy as np
import pytest
import torch

from cfbench.traffic import synthetic_cf

MIX = json.load(open(os.path.join(os.path.dirname(__file__), "..",
                                  "traffic", "netflix.json")))


def small(users=2000, items=800, ratings=40000):
    return dict(MIX, num_users=users, num_items=items, num_ratings=ratings)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 33 + 1])
def test_same_seed_same_log(seed):
    a = synthetic_cf.generate(small(), seed, "cpu")
    b = synthetic_cf.generate(small(), seed, "cpu")
    for k in ("users", "items", "values"):
        assert torch.equal(a[k], b[k])
    c = synthetic_cf.generate(small(), seed + 1, "cpu")
    assert not torch.equal(a["users"], c["users"])


@pytest.mark.parametrize("ratings", [1000, 40000, 150000])
def test_distinct_count_is_the_one_asked_for(ratings):
    d = synthetic_cf.generate(small(ratings=ratings), 7, "cpu")
    keys = d["users"] * d["num_items"] + d["items"]
    assert d["users"].numel() == ratings
    assert keys.unique().numel() == ratings
    assert d["draws"] >= ratings
    assert int(d["users"].max()) < d["num_users"]
    assert int(d["items"].max()) < d["num_items"]


def test_refuses_a_log_past_half_the_matrix():
    with pytest.raises(ValueError):
        synthetic_cf.generate(small(users=100, items=100, ratings=6000), 1,
                              "cpu")


def test_distribution_matches_the_ports_synthetic_ratings():
    from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
    U, I, N = 4000, 1000, 200_000
    ours = synthetic_cf.generate(small(U, I, N), 11, "cpu")
    theirs = synthetic_ratings(U, I, int(N * 1.08), seed=11)
    n = min(len(theirs), N)
    a_items = ours["items"].numpy()[:n]
    b_items = theirs.items[:n]
    # item popularity: the top 1% and top 10% items' shares of the log
    for top in (10, 100):
        sa = np.sort(np.bincount(a_items, minlength=I))[::-1][:top].sum() / n
        sb = np.sort(np.bincount(b_items, minlength=I))[::-1][:top].sum() / n
        assert abs(sa - sb) < 0.02, (top, sa, sb)
    # user activity: the spread of ratings a user
    ca = np.bincount(ours["users"].numpy()[:n], minlength=U)
    cb = np.bincount(theirs.users[:n], minlength=U)
    assert abs(ca.std() / ca.mean() - cb.std() / cb.mean()) < 0.1
    # the half-star levels' shares and the mean rating
    va, vb = ours["values"].numpy()[:n], theirs.values[:n]
    assert abs(va.mean() - vb.mean()) < 0.05
    levels = np.arange(1.0, 5.01, 0.5)
    assert set(np.unique(va)) <= set(levels)
    ha = np.array([(va == x).mean() for x in levels])
    hb = np.array([(vb == x).mean() for x in levels])
    assert np.abs(ha - hb).max() < 0.02
