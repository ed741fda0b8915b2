"""The SGD epoch kernel's cluster (kernels 1 and 2,
``mymedialite_tpu_torch/csrc/sgd_epoch.cu``) held on the CPU to numpy
oracles, and the port's epoch over the orders that exercise it held to
the JAX package's Pallas epoch (``ops/pallas_sgd.py sgd_epoch_mxu``,
interpret mode, float32 operands).

The kernel spreads a chunk's slots over a thread-block cluster
(``cluster_size``), its stage over the cluster's
shared memory. The orders: consecutive chunks on one (user block, item
block) cell, on one user block only, across user-block boundaries, one
chunk alone, and a Zipf duplicate-heavy epoch. On the CPU the wrapper
runs the plain version; ``tests/test_torch_cuda.py`` runs the kernel on
the same kinds of order on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mymedialite_tpu.ops import pallas_sgd as ps
from mymedialite_tpu_torch.ops import plan as P
from mymedialite_tpu_torch.ops import sgd as S
from mymedialite_tpu_torch.ops import sgd_epoch as se
from mymedialite_tpu_torch.ops.segments import round8, runs_length
from torch_threads import one_torch_thread  # noqa: F401

U, I, N, F = 90, 70, 1500, 6
UB, IB, C = 32, 32, 64
# the chunks the plans pick (128-640) and the CPU tests' 64
CHUNKS = (64, 128, 256, 384, 512, 640)


def _plans(zipf_a):
    rng = np.random.default_rng(31)
    users = rng.integers(0, U, N).astype(np.int32)
    items = (rng.zipf(zipf_a, N) % I).astype(np.int32)
    values = (rng.integers(2, 11, N) / 2).astype(np.float32)
    kw = dict(user_block=UB, item_block=IB, chunk=C, shuffle_seed=4)
    tabs = tuple(0.1 * rng.standard_normal(s).astype(np.float32)
                 for s in ((U, F), (I, F), (U,), (I,)))
    return (ps.prepare_mxu_data(users, items, values, U, I, **kw),
            P.prepare_mxu_data(users, items, values, U, I, **kw), tabs)


@pytest.fixture(scope="module")
def plans():
    return {"uniform": _plans(1.5), "zipf": _plans(1.2)}


def _order(plan, case):
    """(ub, ib, row) int32 numpy arrays of the case's order."""
    ub, ib = plan.ub_c, plan.ib_c
    rows = np.arange(ub.size)
    if case == "same-cell":
        cells = ub.astype(np.int64) * plan.n_iblocks + ib
        big = np.bincount(cells).argmax()
        sel = rows[cells == big]
        assert sel.size >= 2
    elif case == "same-ub":
        sel = rows[ub == ub[0]]
        sel = sel[np.argsort(ib[sel], kind="stable")]
    elif case == "ub-boundary":
        # the last chunk of each user block, then the next block's first,
        # with the item block kept across the boundary where it can be
        sel = np.lexsort((ib, ub))
    elif case == "one-chunk":
        sel = rows[:1]
    else:                                    # the epoch order itself
        sel = np.asarray(plan.epoch_order(7)[2])
    return tuple(np.ascontiguousarray(a, np.int32)
                 for a in (ub[sel], ib[sel], sel))


CASES = [("uniform", "same-cell"), ("uniform", "same-ub"),
         ("uniform", "ub-boundary"), ("uniform", "one-chunk"),
         ("zipf", "epoch"), ("zipf", "same-cell")]


@pytest.mark.parametrize("data,case", CASES)
@pytest.mark.parametrize("loss,biased", [(S.LOSS_RMSE, True),
                                         (S.LOSS_MAE, True),
                                         (S.LOSS_LOGISTIC, False)])
def test_epoch_over_the_order_matches_jax(plans, data, case, loss, biased):
    """The port's epoch over the case's order (on the CPU, the plain
    version) against the Pallas epoch over the same order, atol 1e-5 (the
    sums inside a chunk run in another order)."""
    plan_j, plan_t, tabs = plans[data]
    order = _order(plan_t, case)
    fe = 64
    args = (F, fe, 0.05, 0.03, 0.02, 0.8, 0.4, biased, True, True)
    hp = (0.2, 1.0, 4.0) if biased else (3.1, 1.0, 4.0)
    hp_j = np.zeros((1, 8), np.float32)
    hp_j[0, :3] = hp
    Wj, Hj = ps.extend_tables_mxu(plan_j, *tabs)
    Wj, Hj = ps.sgd_epoch_mxu(
        Wj, Hj, plan_j.packed, tuple(jnp.asarray(a) for a in order),
        jnp.asarray(hp_j), ps.mxu_column_rates(*args),
        meta=(len(order[0]), *plan_j.meta(fe)[1:]),
        loss=loss, biased=biased, mxu_dtype="f32", interpret=True)
    Wt, Ht = P.extend_tables_mxu(plan_t, *tabs)
    W0 = Wt.clone()
    se.sgd_epoch(Wt, Ht, plan_t.packed,
                 tuple(torch.from_numpy(a) for a in order), hp,
                 P.mxu_column_rates(*args), user_block=plan_t.user_block,
                 item_block=plan_t.item_block, loss=loss, biased=biased)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=0, atol=1e-5)
    assert not torch.equal(Wt, W0)


def _widths():
    return sorted({P.fused_width(f) for f in range(1, 255)})


@pytest.mark.parametrize("chunk", CHUNKS)
def test_cluster_splits_each_chunk_once(chunk):
    """Every chunk's cluster has 1 to 8 CTAs (the portable size), and the
    CTAs' slot ranges [r cs, (r + 1) cs), cs = ceil(C / N), cover the
    chunk's slots once each, none empty."""
    n = se.cluster_size(chunk)
    assert 1 <= n <= 8
    cs = -(-chunk // n)
    owner = np.arange(chunk) // cs
    assert owner.max() == n - 1
    np.testing.assert_array_equal(np.bincount(owner, minlength=n) > 0,
                                  np.ones(n, bool))
    assert np.bincount(owner).sum() == chunk


def _layout(fe, chunk):
    """The byte offsets of a CTA's dynamic shared memory as the kernel
    lays it out: rates, three packed rows, three segment tables, the live
    lists, then its part of the stage."""
    fe4 = fe // 4
    rk = runs_length(2 * chunk) + 2 * round8(chunk)
    sizes = [("rates", 4 * 4 * fe), ("packed", 3 * 4 * chunk * 4),
             ("segments", 3 * rk * 2), ("live", 4 * (-(-4 * fe4 // 4) * 4))]
    at, out = 0, {}
    for name, size in sizes:
        out[name] = (at, size)
        at += size
    out["stage"] = (at, None)
    return out


@pytest.mark.parametrize("chunk", CHUNKS)
def test_shared_memory_contract(chunk):
    """``shared_bytes`` is the kernel's layout up to its stage plus one
    stage row; every buffer starts on 16 bytes (cp.async and float4);
    every width takes the chunk within 227 KB less the static part, and
    the cluster the wrapper picks holds a chunk whose every entry is in
    a run with every float4 live on chip at the widths of up to 100
    factors (past them, a chunk may spill to the global scratch)."""
    for fe in _widths():
        lay = _layout(fe, chunk)
        assert all(at % 16 == 0 for at, _ in lay.values())
        assert se.shared_bytes(fe, chunk) == lay["stage"][0] + 4 * fe
        se.check_kernel_shape(fe, chunk)
        n = se.cluster_size(chunk)
        stage = se.DYNAMIC_SHARED_BYTES - lay["stage"][0]
        if fe <= P.fused_width(100):
            assert n * stage >= 16 * 2 * chunk * (fe // 4) or n == 1
    assert se.DYNAMIC_SHARED_BYTES == 227 * 1024 - 1024


def test_main_path_cluster_sizes():
    """BiasedMatrixFactorization at k=40 (fe 64): the resident schedule's
    chunks of 640 (kernel 1) spread over a cluster of 8, the tiled
    schedule's of 128 (kernel 2) run in one CTA, the sizes that measured
    fastest on the card (PERF.md section 6)."""
    fe = P.fused_width(40)
    assert fe == 64
    assert se.cluster_size(640) == 8
    assert se.cluster_size(128) == 1


@pytest.mark.parametrize("tiled", [False, True], ids=["resident", "tiled"])
def test_smoke_order_cases(plans, tiled):
    """``chip_smoke.py``'s orders for kernels 1 and 2 (its kernel check):
    each in the wrapper's form, its chunks on the blocks its name says,
    and the plain epoch over it equal to the one over the same chunks in
    the resident form."""
    import chip_smoke
    _, plan, tabs = plans["zipf"]
    if tiled:
        plan = P.MxuTiledPlan(
            slab_blocks=1, num_slabs=plan.n_iblocks, chunk=plan.chunk,
            user_block=plan.user_block, item_block=plan.item_block,
            n_ublocks=plan.n_ublocks, n_iblocks=plan.n_iblocks,
            num_users=plan.num_users, num_items=plan.num_items,
            n_ratings=plan.n_ratings, packed=plan.packed, ub_c=plan.ub_c,
            ib_c=plan.ib_c, new_of_old=plan.new_of_old,
            old_of_new=plan.old_of_new)
    cases = chip_smoke.sgd_order_cases(plan)
    assert set(cases) == {"same cell", "same user block",
                          "across user blocks", "one chunk", "epoch"}
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=S.LOSS_RMSE, biased=True)
    rates = P.mxu_column_rates(F, 64, 0.05, 0.03, 0.02, 0.8, 0.4, True,
                               True, True)
    for case, order in cases.items():
        assert len(order) == (4 if tiled else 3)
        ub, ib, row = order[0], order[-2], order[-1]
        if tiled:
            assert not order[1].any()
        np.testing.assert_array_equal(ub.numpy(), plan.ub_c[row.numpy()])
        np.testing.assert_array_equal(ib.numpy(), plan.ib_c[row.numpy()])
        n = row.numel()
        assert n == {"one chunk": 1, "epoch": plan.ub_c.size}.get(case, n)
        if case == "same cell":
            assert n >= 2 and (ub == ub[0]).all() and (ib == ib[0]).all()
        if case == "same user block":
            assert (ub == ub[0]).all() and (ib[1:] >= ib[:-1]).all()
        if case == "across user blocks":
            assert (ub[1:] >= ub[:-1]).all() and ub.unique().numel() > 1
        W, H = P.extend_tables_mxu(plan, *tabs)
        W2, H2 = W.clone(), H.clone()
        if tiled:
            se.sgd_epoch_tiled(W, H, plan.packed, order, (0.2, 1.0, 4.0),
                               rates, slab_blocks=1, **kw)
        else:
            se.sgd_epoch(W, H, plan.packed, order, (0.2, 1.0, 4.0), rates,
                         **kw)
        se.sgd_epoch_reference(W2, H2, plan.packed, (ub, ib, row),
                               (0.2, 1.0, 4.0), rates, **kw)
        assert torch.equal(W, W2) and torch.equal(H, H2)
