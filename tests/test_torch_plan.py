"""The port's chunk plan and table layouts (``mymedialite_tpu_torch/ops/
plan.py``, ``ops/sgd.py``) against the JAX package's
(``mymedialite_tpu/ops/pallas_sgd.py``, ``ops/sgd.py``): the same inputs
must give bit-identical plans, orders, tables and rates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mymedialite_tpu.ops import pallas_sgd as ps
from mymedialite_tpu.ops import sgd as jsgd
from mymedialite_tpu_torch.ops import plan as P
from mymedialite_tpu_torch.ops import sgd as S
from torch_threads import one_torch_thread  # noqa: F401

# (num_users, num_items, num_ratings, planner keywords)
SHAPES = [
    (50, 60, 700, dict(user_block=16, item_block=16, chunk=8,
                       shuffle_seed=1)),
    (200, 300, 6000, dict(user_block=512, item_block=1024, chunk=640,
                          shuffle_seed=42)),
    (300, 2500, 9000, dict(user_block=64, item_block=512, chunk=None,
                           shuffle_seed=None)),
]


def _ratings(U, I, n, seed=0):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, U, n).astype(np.int32)
    items = (rng.zipf(1.4, n) % I).astype(np.int32)
    values = (rng.integers(2, 11, n) / 2).astype(np.float32)
    return users, items, values


@pytest.fixture(scope="module", params=range(len(SHAPES)))
def plans(request):
    U, I, n, kw = SHAPES[request.param]
    users, items, values = _ratings(U, I, n, seed=request.param)
    return (ps.prepare_mxu_data(users, items, values, U, I, **kw),
            P.prepare_mxu_data(users, items, values, U, I, **kw), U, I)


def test_plan_bit_identical(plans):
    pj, pt, _, _ = plans
    assert pt.packed.dtype == torch.int32
    np.testing.assert_array_equal(pt.packed.numpy(), np.asarray(pj.packed))
    for name in ("ub_c", "ib_c", "new_of_old", "old_of_new"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name))
    for name in ("num_chunks", "chunk", "user_block", "item_block",
                 "n_ublocks", "n_iblocks", "num_users", "num_items",
                 "n_ratings", "u_pad", "i_pad"):
        assert getattr(pt, name) == getattr(pj, name), name


@pytest.mark.parametrize("seed", [None, 7, 1_000_004])
def test_epoch_order_identical(plans, seed):
    pj, pt, _, _ = plans
    for a, b in zip(pt.epoch_order(seed), pj.epoch_order(seed)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("biased", [True, False])
def test_extend_split_tables_mxu(plans, biased):
    pj, pt, U, I = plans
    rng = np.random.default_rng(5)
    W = rng.standard_normal((U, 6)).astype(np.float32)
    H = rng.standard_normal((I, 6)).astype(np.float32)
    bu = rng.standard_normal(U).astype(np.float32) if biased else None
    bi = rng.standard_normal(I).astype(np.float32) if biased else None
    Wj, Hj = ps.extend_tables_mxu(pj, W, H, bu, bi)
    Wt, Ht = P.extend_tables_mxu(pt, W, H, bu, bi)
    np.testing.assert_array_equal(Wt.numpy(), np.asarray(Wj))
    np.testing.assert_array_equal(Ht.numpy(), np.asarray(Hj))
    for a, b in zip(P.split_tables_mxu(pt, Wt, Ht, 6),
                    ps.split_tables_mxu(pj, Wj, Hj, 6)):
        np.testing.assert_array_equal(a, b)


def test_std_mxu_layout_round_trip(plans):
    pj, pt, U, I = plans
    rng = np.random.default_rng(6)
    Wj, Hj = jsgd.extend_tables(rng.standard_normal((U, 6)),
                                rng.standard_normal((I, 6)),
                                rng.standard_normal(U), rng.standard_normal(I),
                                group_users=32)
    Wt, Ht = S.extend_tables(np.asarray(Wj)[:U, :6], np.asarray(Hj)[:, :6],
                             np.asarray(Wj)[:U, 6], np.asarray(Hj)[:, 7],
                             group_users=32)
    np.testing.assert_array_equal(Wt.numpy(), np.asarray(Wj))
    np.testing.assert_array_equal(Ht.numpy(), np.asarray(Hj))
    for a, b in zip(S.split_tables(Wt, Ht, U), jsgd.split_tables(Wj, Hj, U)):
        np.testing.assert_array_equal(a, b)
    noo_j = jnp.asarray(pj.new_of_old)
    noo_t = torch.from_numpy(pt.new_of_old.astype(np.int64))
    Mj = ps.tables_std_to_mxu(Wj, Hj, noo_j, u_pad=pj.u_pad, i_pad=pj.i_pad,
                              fe_mxu=64)
    Mt = P.tables_std_to_mxu(Wt, Ht, noo_t, u_pad=pt.u_pad, i_pad=pt.i_pad,
                             fe_mxu=64)
    for a, b in zip(Mt, Mj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    Bj = ps.tables_mxu_to_std(*Mj, noo_j, num_users_pad=Wj.shape[0],
                              fe_std=8)
    Bt = P.tables_mxu_to_std(*Mt, noo_t, num_users_pad=Wt.shape[0], fe_std=8)
    for a, b in zip(Bt, Bj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("sides", [(True, True), (True, False),
                                   (False, True)])
def test_column_rates_identical(biased, sides):
    args = (40, 64, 0.013, 0.02, 0.03, 0.7, 0.11, biased, *sides)
    np.testing.assert_array_equal(P.mxu_column_rates(*args).numpy(),
                                  np.asarray(ps.mxu_column_rates(*args)))


def test_fused_width_matches_model():
    for f in (1, 10, 40, 62, 63, 100, 200):
        assert P.fused_width(f) == max(64, ((f + 2 + 7) // 8) * 8)
