"""The port's CSR build (``mymedialite_tpu_torch/data/arrays.py
build_csr``, a stable two-pass counting sort in ``native/fast_parser.cpp
mml_csr_order``) against ``np.lexsort`` and against the JAX package's
``build_csr``, on the CPU: ``indptr``, ``order`` and ``keys`` equal
element for element, and in dtype, with duplicate events, keys without
events and int32 or int64 ids; the keys the native sort leaves alone
(negative ids) take the lexsort path with the same result.
"""

import numpy as np
import pytest

from mymedialite_tpu.data.arrays import build_csr as jax_build_csr
from mymedialite_tpu_torch import native
from mymedialite_tpu_torch.data import arrays
from mymedialite_tpu_torch.data.arrays import PosOnlyData, build_csr


def lexsort_csr(primary, secondary, num_keys):
    order = np.lexsort((secondary, primary)).astype(np.int32)
    indptr = np.zeros(num_keys + 1, np.int64)
    np.cumsum(np.bincount(primary, minlength=num_keys), out=indptr[1:])
    return indptr, order, secondary[order]


def assert_same(csr, ref):
    for got, want, name in zip((csr.indptr, csr.order, csr.keys), ref,
                               ("indptr", "order", "keys")):
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def events(seed, n, num_primary, num_secondary, dtype):
    """Seeded events: ids drawn from the lower half of each range (the
    upper keys stay empty), every fourth event a copy of an earlier one."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, max(num_primary // 2, 1), n).astype(dtype)
    s = rng.integers(0, max(num_secondary // 2, 1), n).astype(dtype)
    dup = rng.integers(0, max(n, 1), n // 4)
    if len(dup):
        p[-len(dup):], s[-len(dup):] = p[dup], s[dup]
    return p, s


def test_native_library_sorts():
    assert native.get_lib() is not None
    p, s = events(0, 1000, 50, 40, np.int32)
    indptr, order = native.csr_order(p, s, 50)
    np.testing.assert_array_equal(order, np.lexsort((s, p)))
    assert indptr[-1] == 1000


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("seed,n,num_primary,num_secondary", [
    (1, 5000, 300, 120),      # many duplicates per key
    (2, 20000, 40, 3000),     # long segments
    (3, 777, 5000, 7),        # most keys empty, few secondary values
    (4, 1, 3, 3),
])
def test_counting_sort_equals_lexsort_and_jax(dtype, seed, n, num_primary,
                                              num_secondary):
    p, s = events(seed, n, num_primary, num_secondary, dtype)
    csr = build_csr(p, s, num_primary)
    assert_same(csr, lexsort_csr(p, s, num_primary))
    j = jax_build_csr(p, s, num_primary)
    assert_same(csr, (j.indptr, j.order, j.keys))
    # every segment holds its key's events, sorted, ties in event order
    for k in range(0, num_primary, max(num_primary // 7, 1)):
        seg = csr.segment(k)
        assert (p[seg] == k).all()
        assert np.all(np.diff(s[seg]) >= 0)


def test_empty_and_keyless():
    for dtype in (np.int32, np.int64):
        empty = np.zeros(0, dtype)
        csr = build_csr(empty, empty, 5)
        assert_same(csr, lexsort_csr(empty, empty, 5))
        csr = build_csr(empty, empty, 0)
        assert_same(csr, lexsort_csr(empty, empty, 0))


def test_the_keys_it_leaves_take_the_lexsort_path():
    p = np.array([2, 0, 2, 1, 0], np.int64)
    s = np.array([3, -1, 3, 0, -5], np.int64)
    assert native.csr_order(p, s, 3) is None
    assert_same(build_csr(p, s, 3), lexsort_csr(p, s, 3))
    with pytest.raises(ValueError):     # a primary key past num_keys
        build_csr(np.array([0, 4], np.int32), np.array([1, 1], np.int32), 3)
    with pytest.raises(ValueError):
        jax_build_csr(np.array([0, 4], np.int32), np.array([1, 1], np.int32),
                      3)


def test_without_the_library(monkeypatch):
    p, s = events(5, 3000, 200, 90, np.int32)
    want = build_csr(p, s, 200)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.csr_order(p, s, 200) is None
    assert_same(build_csr(p, s, 200), (want.indptr, want.order, want.keys))


def test_dataset_views_use_it(monkeypatch):
    calls = []
    real = native.csr_order

    def counted(*a):
        calls.append(len(a[0]))
        return real(*a)
    monkeypatch.setattr(native, "csr_order", counted)
    p, s = events(6, 4000, 100, 80, np.int32)
    data = PosOnlyData(p, s, num_users=100, num_items=80)
    by_user, by_item = data.by_user, data.by_item
    assert calls == [4000, 4000]
    assert_same(by_user, lexsort_csr(p, s, 100))
    assert_same(by_item, lexsort_csr(s, p, 80))
    assert arrays.build_csr is build_csr
