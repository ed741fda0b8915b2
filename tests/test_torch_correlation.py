"""The correlations of the port (``mymedialite_tpu_torch/ops/
correlation.py``) against the JAX package's on the same data, on the CPU.

The fixture is tie-heavy: 70 entities over 12 features, so binary cosine
and Jaccard give many exactly equal values. Dense correlations agree to
1e-6; the neighbour lists (``nearest_neighbors`` on the dense matrix and
the streaming top-k) equal the JAX package's id for id, in the reference
order (value descending, then id ascending), with values to 1e-6. The
weighted measures sum float32 weights, whose order of summation moves a
value by an ulp, so there ids are compared outside near-ties (1e-6); so
are the rating measures' streaming lists, which the port maps in float64
and also holds to a float64 reference, ids exact.
Dense and streaming agree in both packages with ``DENSE_NMAX`` shrunk,
as ``tests/test_knn.py`` does it.
"""

import numpy as np
import pytest
import torch

from mymedialite_tpu.data.arrays import PosOnlyData, RatingData
from mymedialite_tpu.ops import correlation as J
from mymedialite_tpu_torch.ops import correlation as T
from torch_threads import one_torch_thread  # noqa: F401

KINDS = ["cosine", "jaccard", "conditional_probability",
         "bidirectional_conditional_probability", "cooccurrence"]
TOL = 1e-6
N, M, K = 70, 12, 10


@pytest.fixture(scope="module")
def coo():
    rng = np.random.default_rng(3)
    users = rng.integers(0, N, 500)
    items = rng.integers(0, M, 500)
    values = rng.choice([1.0, 1.5, 2, 2.5, 3, 3.5, 4, 4.5, 5], 500)
    return PosOnlyData(users, items, N, M), RatingData(users, items, values,
                                                       N, M)


def near_tie_free(vals, gap=TOL):
    """True where a value differs from both row neighbours by > gap."""
    d = np.abs(np.diff(vals.astype(np.float64), axis=1)) > gap
    ok = np.ones(vals.shape, bool)
    ok[:, 1:] &= d
    ok[:, :-1] &= d
    return ok


def check_topk(ids, vals, want_ids, want_vals, exact_ids=True):
    ids, vals = ids.numpy(), vals.numpy()
    np.testing.assert_allclose(vals, want_vals, atol=TOL, rtol=0)
    if exact_ids:
        np.testing.assert_array_equal(ids, want_ids)
    else:
        sure = near_tie_free(np.asarray(want_vals))
        assert not ((ids != want_ids) & sure).any()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_binary_dense_and_neighbors(kind, weighted, coo):
    d, _ = coo
    want = J.binary_correlation(d, N, M, kind=kind, alpha=0.3,
                                weighted=weighted)
    got = T.binary_correlation(d, N, M, kind=kind, alpha=0.3,
                               weighted=weighted, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # the neighbour order on the same matrix: exact
    np.testing.assert_array_equal(
        T.nearest_neighbors(torch.from_numpy(np.array(want)), K).numpy(),
        J.nearest_neighbors(want, K))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_binary_streaming_topk(kind, weighted, coo):
    d, _ = coo
    want_ids, want_vals = J.binary_correlation_topk(
        d, N, M, K, kind=kind, alpha=0.3, weighted=weighted, chunk=32)
    got = T.binary_correlation_topk(d, N, M, K, kind=kind, alpha=0.3,
                                    weighted=weighted, device="cpu")
    check_topk(*got, want_ids, want_vals, exact_ids=not weighted)


def test_fixture_is_tie_heavy(coo):
    """Most rows of the cosine top-k hold an exact tie, often at the
    k-th place, so the order rule is exercised."""
    d, _ = coo
    _, vals = J.binary_correlation_topk(d, N, M, K + 1, kind="cosine")
    ties = np.diff(vals, axis=1) == 0
    assert ties.any(axis=1).mean() > 0.8
    assert ties[:, K - 1].mean() > 0.2


@pytest.mark.parametrize("entity", ["user", "item"])
@pytest.mark.parametrize("kind", ["pearson", "cosine"])
def test_rating_dense_and_streaming(kind, entity, coo):
    """The dense matrix to 1e-6 of the JAX package's. The streaming top-k
    maps its exact int statistics in float64 (the JAX package in
    float32, whose rounding parts values that are equal in exact
    arithmetic by an ulp): values to 1e-6 of the JAX lists and ids equal
    outside their near-ties (1e-6); against ``rating_topk_f64``, values
    to 1e-7 and ids exact, in the order of the values rounded to
    float32."""
    _, r = coo
    want = J.rating_correlation(r, entity=entity, kind=kind, shrinkage=5.0)
    got = T.rating_correlation(r, entity=entity, kind=kind, shrinkage=5.0,
                               device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    want_ids, want_vals = J.rating_correlation_topk(
        r, K, entity=entity, kind=kind, shrinkage=5.0, chunk=32)
    got_ids, got_vals = T.rating_correlation_topk(
        r, K, entity=entity, kind=kind, shrinkage=5.0, device="cpu")
    check_topk(got_ids, got_vals, want_ids, want_vals, exact_ids=False)
    ref_ids, ref_vals = rating_topk_f64(r, K, entity, kind, 5.0)
    np.testing.assert_array_equal(got_ids.numpy(), ref_ids)
    np.testing.assert_allclose(got_vals.numpy(), ref_vals, atol=1e-7,
                               rtol=0)


def rating_topk_f64(r, k, entity, kind, shrinkage):
    """Reference streaming Pearson or RatingCosine top-k [N, k] in numpy
    float64 (last value of a duplicate pair), ordered by the values
    rounded to float32 desc, then id asc."""
    R = np.zeros((N, M))
    R[r.users, r.items] = r.values
    if entity == "item":
        R = R.T
    B = (R != 0).astype(np.float64)
    n, Sxy, Sx, Sxx = B @ B.T, R @ R.T, R @ B.T, (R * R) @ B.T
    if kind == "pearson":
        num = n * Sxy - Sx * Sx.T
        den = np.sqrt(np.maximum((n * Sxx - Sx * Sx) * (n * Sxx.T - Sx.T
                                                         * Sx.T), 0))
    else:
        num, den = Sxy, np.sqrt(np.maximum(Sxx * Sxx.T, 0))
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(den > 0, num / np.maximum(den, 1e-12), 0.0)
        c = c * ((n - 1) / (n - 1 + shrinkage))
    c = np.where(n < 2, 0.0, c)
    np.fill_diagonal(c, -np.inf)
    ids = np.argsort(-c.astype(np.float32), axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(c, ids, 1)


def pearson_topk_f64(r, k, shrinkage):
    """Reference streaming Pearson top-k [N, k] in numpy float64 (last
    value of a duplicate pair; value desc, id asc)."""
    R = np.zeros((N, M))
    R[r.users, r.items] = r.values
    B = (R != 0).astype(np.float64)
    n, Sxy, Sx, Sxx = B @ B.T, R @ R.T, R @ B.T, (R * R) @ B.T
    Sy, Syy = Sx.T, Sxx.T
    num = n * Sxy - Sx * Sy
    den = np.sqrt(np.maximum((n * Sxx - Sx * Sx) * (n * Syy - Sy * Sy), 0))
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(den > 0, num / np.maximum(den, 1e-12), 0.0)
        c = c * ((n - 1) / (n - 1 + shrinkage))
    c = np.where(n < 2, 0.0, c)
    np.fill_diagonal(c, -np.inf)
    ids = np.argsort(-c, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(c, ids, 1)


@pytest.mark.parametrize("levels", ["wide", "float"])
def test_rating_streaming_other_scales(levels, coo):
    """Levels past 11 take the hi/lo split of l^2 (exact: the JAX lists,
    id for id). Values off any equal spacing take the float products,
    which the port sums in float64, held to a float64 reference at 1e-6
    (ids outside near-ties): the JAX package's float32 sums cancel in
    n*Sxx - Sx^2 and stray from it by up to 1.1e-2 on this fixture (its
    own test holds that path to its dense one at 1e-3 only,
    tests/test_knn.py test_rating_f32_fallback)."""
    d, _ = coo
    rng = np.random.default_rng(9)
    vals = (rng.integers(1, 101, d.users.size).astype(np.float64)
            if levels == "wide" else rng.normal(3.0, 1.0, d.users.size))
    r = RatingData(d.users, d.items, vals, N, M)
    assert (T._quantize_levels(vals, True) is None) == (levels == "float")
    want_ids, want_vals = J.rating_correlation_topk(r, K, kind="pearson",
                                                    shrinkage=2.0, chunk=32)
    got = T.rating_correlation_topk(r, K, kind="pearson", shrinkage=2.0,
                                    device="cpu")
    if levels == "wide":
        check_topk(*got, want_ids, want_vals)
        return
    check_topk(*got, *pearson_topk_f64(r, K, 2.0), exact_ids=False)


def test_duplicates_keep_the_last_rating():
    users = np.array([0, 0, 1, 1, 2, 2, 0])
    items = np.array([0, 1, 0, 1, 0, 1, 0])
    values = np.array([1.0, 2, 3, 4, 5, 1, 4])
    r = RatingData(users, items, values, 3, 2)
    want = J.rating_correlation(r, kind="pearson")
    np.testing.assert_allclose(
        T.rating_correlation(r, kind="pearson", device="cpu").numpy(), want,
        atol=TOL)
    got_ids, got_vals = T.rating_correlation_topk(r, 2, kind="pearson",
                                                  device="cpu")
    want_ids, want_vals = J.rating_correlation_topk(r, 2, kind="pearson")
    check_topk(got_ids, got_vals, want_ids, want_vals)


@pytest.mark.parametrize("kind", ["cosine", "jaccard"])
def test_dense_and_streaming_agree_in_both_packages(kind, coo, monkeypatch):
    """With ``DENSE_NMAX`` shrunk (as tests/test_knn.py does), the
    streaming lists equal the neighbour lists of the dense matrix, in
    each package and across them."""
    d, _ = coo
    monkeypatch.setattr(J, "DENSE_NMAX", 8)
    monkeypatch.setattr(T, "DENSE_NMAX", 8)
    dense = T.binary_correlation(d, N, M, kind=kind, device="cpu")
    ids_dense = T.nearest_neighbors(dense, K).numpy()
    ids_stream, vals_stream = T.binary_correlation_topk(d, N, M, K, kind=kind,
                                                        device="cpu")
    np.testing.assert_array_equal(ids_stream.numpy(), ids_dense)
    np.testing.assert_array_equal(
        vals_stream.numpy(), np.take_along_axis(dense.numpy(), ids_dense, 1))
    np.testing.assert_array_equal(
        ids_dense, J.nearest_neighbors(J.binary_correlation(d, N, M,
                                                            kind=kind), K))


def test_order_keys_round_trip():
    vals = torch.tensor([[3.0, -0.0, 0.0, -1.5, -np.inf, 1e-30, -2.0, 7.5]])
    ids = torch.tensor([[5, 2, 1, 9, 0, 3, 4, 1 << 20]])
    keys = T._order_keys(vals, ids)
    got_ids, got_vals = T._decode_keys(keys)
    np.testing.assert_array_equal(got_ids.numpy(), ids.numpy())
    np.testing.assert_array_equal(got_vals.numpy(), vals.numpy() + 0.0)
    order = torch.argsort(keys, dim=1, descending=True)[0].numpy()
    # value descending; the two zeros tie and go by id ascending
    np.testing.assert_array_equal(ids[0].numpy()[order],
                                  [1 << 20, 5, 3, 1, 2, 9, 4, 0])


def test_tiles_and_empty_cases():
    R, C, n_pad = T._tiles(17_770, 480_000, 0)
    assert R % 32 == 0 and C % 8 == 0 and n_pad % R == 0
    assert n_pad - 17_770 < 32 * (n_pad // R)
    assert R * C <= T.TILE_ELEMS
    for nbytes in (4, 8):
        R, C, _ = T._tiles(17_770, 480_000, nbytes)
        assert (R + C) * 480_000 * nbytes <= T.FLOAT_TILE_BYTES
    d = PosOnlyData(np.array([0]), np.array([0]), 1, 1)
    ids, vals = T.binary_correlation_topk(d, 1, 1, 5, device="cpu")
    assert ids.shape == vals.shape == (1, 0)
    assert T.nearest_neighbors(torch.ones(1, 1), 3).shape == (1, 0)


def test_quantize_levels_and_incidence_are_the_jax_functions():
    rng = np.random.default_rng(4)
    for values in (rng.choice([1.0, 2, 3, 4, 5], 50),
                   rng.choice([0.5, 1.0, 1.5], 50), rng.normal(size=50),
                   np.full(5, 2.0), np.zeros(0)):
        for centered in (True, False):
            a = J._quantize_levels(values, centered)
            b = T._quantize_levels(values, centered)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    d = PosOnlyData(np.array([0, 2, 2]), np.array([1, 0, 1]), 3, 2)
    np.testing.assert_array_equal(T.incidence_dense(d, 3, 2),
                                  J.incidence_dense(d, 3, 2))
