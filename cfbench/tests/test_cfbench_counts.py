"""The work counts against hand-computed cases."""

import numpy as np

from cfbench.counts import rating, triple


def log_of(users, items):
    return dict(users=np.array(users), items=np.array(items))


def test_rating_count_by_hand():
    # 5 ratings; users 0, 2, 3 touched (3); items 1, 4 (2); k = 4 -> 6
    # columns: rows 2 x 5 x 6 x 4 B = 240, ratings 5 x 16 = 80
    w = rating.work(log_of([0, 0, 2, 3, 3], [1, 4, 4, 1, 4]), 4)
    assert (w["examples"], w["users"], w["items"]) == (5, 3, 2)
    assert w["bytes"] == 240 + 80
    assert w["ops"] == 12.0 * 6 * 5


def test_triple_count_by_hand():
    # the same log: 5 columns; rows 2 x 5 x 5 x 4 B = 200; events 5 x 24
    w = triple.work(log_of([0, 0, 2, 3, 3], [1, 4, 4, 1, 4]), 4)
    assert w["bytes"] == 200 + 120
    assert w["ops"] == 18.0 * 5 * 5


def test_netflix_rating_epoch_is_bound_by_operations():
    from cfbench import harness as hz
    n, U, I = 100_480_507, 480_189, 17_770
    w = dict(bytes=2 * (U + I) * 42 * 4 + 16 * n, ops=12.0 * 42 * n)
    t, by = hz.least_time(w, "NVIDIA H100 80GB HBM3")
    assert by == "operations"
    assert abs(t - 12.0 * 42 * n / 67e12) < 1e-12
    assert hz.least_time(w, "an unknown card") is None
