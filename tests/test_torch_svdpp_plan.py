"""The port's SVD++ plan and table layout (``mymedialite_tpu_torch/ops/
svdpp_plan.py``, ``ops/svdpp.py``, the ``item_perm`` path of
``ops/plan.py``) against the JAX package's (``ops/pallas_svdpp.py``,
``models/svdpp.py _history_edges``, ``ops/pallas_sgd.py``): the same
inputs give the JAX plan's real entries bit for bit, and the port raises
"not yet ported" where the JAX package leaves its kernel for the XLA
grouped epoch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mymedialite_tpu.data.arrays import RatingData as JaxRatingData
from mymedialite_tpu.models.svdpp import SVDPlusPlus as JaxSVDPlusPlus
from mymedialite_tpu.ops import pallas_sgd as ps
from mymedialite_tpu.ops import pallas_svdpp as psv
from mymedialite_tpu_torch import native
from mymedialite_tpu_torch.ops import plan as P
from mymedialite_tpu_torch.ops import svdpp_plan as SP
from mymedialite_tpu_torch.ops.svdpp import history_edges
from torch_threads import one_torch_thread  # noqa: F401

# (num_users, num_items, num_ratings, seed, planner keywords, JAX
# pass_len): the oracle shape of tests/test_pallas_svdpp.py, split into
# several JAX passes, and the models' blocks
SHAPES = [
    (60, 50, 800, 0, dict(user_block=8, item_block=8, chunk=8), 64),
    (40, 30, 400, 3, dict(user_block=8, item_block=8, chunk=8), 128),
    (200, 300, 6000, 11, dict(shuffle_seed=42), 16384),
]


def _events(U, I, n, seed):
    """Ratings (Zipf items, so chunks hold duplicates) and extra feedback
    pairs that overlap them, as (users, items, values, extra)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, n).astype(np.int32)
    i = (rng.zipf(1.5, n) % I).astype(np.int32)
    v = rng.uniform(1, 5, n).astype(np.float32)
    m = n // 5
    extra = (np.concatenate([u[:m // 2], rng.integers(0, U, m)]).astype(
        np.int32), np.concatenate([i[:m // 2], rng.integers(0, I, m)]).astype(
        np.int32))
    return u, i, v, extra


@pytest.fixture(scope="module", params=range(len(SHAPES)))
def plans(request):
    U, I, n, seed, kw, pass_len = SHAPES[request.param]
    u, i, v, extra = _events(U, I, n, seed)
    hu, hi = history_edges(u, i, I, extra)
    pj = psv.prepare_svdpp_mxu(u, i, v, hu, hi, U, I, pass_len=pass_len, **kw)
    pt = SP.prepare_svdpp_mxu(u, i, v, hu, hi, U, I, **kw)
    return pj, pt, U, I


def test_history_edges_match_jax_order():
    U, I, n, seed, _, _ = SHAPES[0]
    u, i, v, extra = _events(U, I, n, seed)
    jm = JaxSVDPlusPlus()
    jm.ratings = JaxRatingData(u, i, v, num_users=U, num_items=I)
    jm.additional_feedback = extra
    for a, b in zip(history_edges(u, i, I, extra), jm._history_edges()):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    jm.additional_feedback = None
    for a, b in zip(history_edges(u, i, I), jm._history_edges()):
        np.testing.assert_array_equal(a, b)


def test_plan_matches_jax_real_entries(plans):
    pj, pt, _, _ = plans
    packed = np.asarray(pj.packed)
    zero_row = packed.shape[0] - 1
    assert not packed[zero_row].any()
    assert pt.packed.dtype == torch.int32
    np.testing.assert_array_equal(pt.packed.numpy(), packed[:zero_row])
    row = np.asarray(pj.row).reshape(-1)
    real = row != zero_row
    for got, ref in zip(pt.schedule, (pj.ph, pj.ub, pj.ib, pj.row)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref).reshape(-1)[real])
    for name in ("inv_sqrt", "new_of_old", "old_of_new"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name))
    for name in ("chunk", "user_block", "item_block", "n_ublocks",
                 "n_iblocks", "num_users", "num_items", "n_ratings",
                 "n_edges", "u_pad", "i_pad"):
        assert getattr(pt, name) == getattr(pj, name), name
    ph = pt.schedule[0].numpy()
    assert (ph == 0).sum() == (ph == 2).sum() == pt.n_edge_chunks


def test_schedule_per_user_block(plans):
    """Each user block once, its steps contiguous: all its S steps, then
    its R steps, then its Y steps over the S steps' chunks again."""
    _, pt, _, _ = plans
    ph, ub, _, row = (t.numpy() for t in pt.schedule)
    assert (np.diff(ub) >= 0).all()
    for u in np.unique(ub):
        sel = ub == u
        assert (np.diff(ph[sel]) >= 0).all()
        np.testing.assert_array_equal(row[sel][ph[sel] == 0],
                                      row[sel][ph[sel] == 2])
        assert (row[sel][ph[sel] == 1] >= pt.n_edge_chunks).all()


@pytest.mark.parametrize("bucketizer", ["native", "numpy"])
def test_item_perm_path_matches_jax(bucketizer, monkeypatch):
    """prepare_mxu_data with a forced permutation, through the native
    counting sort and through the numpy path."""
    if bucketizer == "numpy":
        monkeypatch.setattr(native, "mxu_bucketize", lambda *a: None)
    U, I, n = 70, 90, 2000
    u, i, v, _ = _events(U, I, n, 5)
    perm = np.random.default_rng(6).permutation(96)[:I].astype(np.int32)
    kw = dict(user_block=16, item_block=32, chunk=16, shuffle_seed=3,
              item_perm=perm)
    pj = ps.prepare_mxu_data(u, i, v, U, I, **kw)
    pt = P.prepare_mxu_data(u, i, v, U, I, **kw)
    np.testing.assert_array_equal(pt.new_of_old, perm)
    np.testing.assert_array_equal(pt.packed.numpy(), np.asarray(pj.packed))
    for name in ("ub_c", "ib_c", "new_of_old", "old_of_new"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name))
    with pytest.raises(AssertionError):
        P.prepare_mxu_data(u, i, v, U, I, **dict(kw, item_perm=perm[:-1]))


def test_pass_len_selection_rule():
    """One user block past the pass length: both packages raise
    ValueError, and their models fall back to the grouped epoch."""
    rng = np.random.default_rng(1)
    u = np.zeros(2000, np.int32)
    i = rng.integers(0, 50, 2000).astype(np.int32)
    v = np.ones(2000, np.float32)
    kw = dict(user_block=8, item_block=8, chunk=8, pass_len=64)
    with pytest.raises(ValueError):
        psv.prepare_svdpp_mxu(u, i, v, u, i, 8, 50, **kw)
    with pytest.raises(ValueError, match="grouped epoch"):
        SP.prepare_svdpp_mxu(u, i, v, u, i, 8, 50, **kw)
    assert SP.prepare_svdpp_mxu(u, i, v, u, i, 8, 50,
                                **dict(kw, pass_len=1024)).num_steps > 64


def test_width_and_budget_match_jax():
    assert SP.SVDPP_TABLE_BYTES == psv.SVDPP_VMEM_TABLE_BYTES
    for f in (1, 5, 20, 29, 30, 40, 100, 200):
        assert SP.svdpp_fe(f) == psv.svdpp_fe(f)
        for items in (100, 17_770, 32_768, 40_000, 62_423, 200_000):
            assert SP.svdpp_mxu_supported(items, f) == \
                psv.svdpp_mxu_supported(items, f), (items, f)
    assert SP.svdpp_mxu_supported(17_770, 20)
    assert not SP.svdpp_mxu_supported(62_423, 20)


@pytest.mark.parametrize("use_p", [True, False])
def test_tables_round_trip_match_jax(plans, use_p):
    pj, pt, U, I = plans
    f = 6
    fe = SP.svdpp_fe(f)
    rng = np.random.default_rng(4)
    p = rng.standard_normal((U, f)).astype(np.float32) if use_p else \
        np.zeros((U, f), np.float32)
    bu, bi = (rng.standard_normal(n).astype(np.float32) for n in (U, I))
    q, y = (rng.standard_normal((I, f)).astype(np.float32) for _ in range(2))
    kw = dict(u_pad=pt.u_pad, i_pad=pt.i_pad, fe=fe)
    ref = psv.svdpp_tables_to_mxu(
        *(jnp.asarray(a) for a in (p, bu, pj.inv_sqrt, q, bi, y,
                                   pj.new_of_old)), **kw)
    noo = torch.from_numpy(pt.new_of_old.astype(np.int64))
    got = SP.svdpp_tables_to_mxu(*(torch.from_numpy(a) for a in (p, bu)),
                                 pt.inv_sqrt,
                                 *(torch.from_numpy(a) for a in (q, bi, y)),
                                 noo, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back_j = psv.svdpp_tables_from_mxu(*ref, jnp.asarray(pj.new_of_old),
                                       num_users=U, num_factors=f)
    back_t = SP.svdpp_tables_from_mxu(*got, noo, num_users=U, num_factors=f)
    for a, b, orig in zip(back_t, back_j, (p, bu, q, bi, y)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), orig)


@pytest.mark.parametrize("use_p", [True, False])
@pytest.mark.parametrize("sides", [(True, True), (True, False),
                                   (False, True)])
def test_rates_match_jax(use_p, sides):
    args = (20, 32, 0.003, 0.7, 0.015, 0.33, 0.02)
    kw = dict(use_p=use_p, update_user=sides[0], update_item=sides[1])
    np.testing.assert_array_equal(SP.svdpp_mxu_rates(*args, **kw).numpy(),
                                  np.asarray(psv.svdpp_mxu_rates(*args, **kw)))
