"""The port's SVD++ epoch (``mymedialite_tpu_torch/ops/svdpp_epoch.py``)
against the JAX package's Pallas epoch (``ops/pallas_svdpp.py
svdpp_epoch_mxu``), run here in interpret mode with float32 operands.

Both start from the same plan, tables, rates and hyperparameters, at the
oracle shape of tests/test_pallas_svdpp.py (60 x 50 x 800, blocks and
chunks of 8, several JAX passes), for the variants that test holds to
its numpy oracle: plain, sigmoid RMSE, sigmoid MAE and without p (the
asymmetric factor models). The sums inside a chunk run in another order,
so the tables agree to atol 2e-5 (the JAX test's tolerance). On CPU
tensors the wrapper runs the plain version and launches nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mymedialite_tpu.ops import pallas_svdpp as psv
from mymedialite_tpu_torch.ops import svdpp_plan as SP
from mymedialite_tpu_torch.ops.sgd import LOSS_MAE, LOSS_RMSE
from mymedialite_tpu_torch.ops.svdpp import history_edges
from mymedialite_tpu_torch.ops.svdpp_epoch import (
    svdpp_epoch, svdpp_epoch_reference,
)
from torch_threads import one_torch_thread  # noqa: F401

U, I, N, F = 60, 50, 800, 6
HP = (3.0, 1.0, 4.0)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    v = rng.uniform(1, 5, N).astype(np.float32)
    hu, hi = history_edges(u, i, I)
    kw = dict(user_block=8, item_block=8, chunk=8)
    pj = psv.prepare_svdpp_mxu(u, i, v, hu, hi, U, I, pass_len=64, **kw)
    assert pj.num_passes > 1
    pt = SP.prepare_svdpp_mxu(u, i, v, hu, hi, U, I, **kw)
    rng = np.random.default_rng(2)
    tabs = tuple((0.1 * rng.standard_normal(shape)).astype(np.float32)
                 for shape in ((U, F), (U,), (I, F), (I,), (I, F)))
    return pj, pt, tabs


def _tables(pt, tabs, use_p):
    p, bu, q, bi, y = (torch.from_numpy(a) for a in tabs)
    return SP.svdpp_tables_to_mxu(
        p if use_p else torch.zeros_like(p), bu, pt.inv_sqrt, q, bi, y,
        torch.from_numpy(pt.new_of_old.astype(np.int64)), u_pad=pt.u_pad,
        i_pad=pt.i_pad, fe=SP.svdpp_fe(F))


def _rates(use_p, module=SP):
    return module.svdpp_mxu_rates(F, SP.svdpp_fe(F), 0.01, 0.7, 0.015, 0.33,
                                  0.015, use_p=use_p, update_user=True,
                                  update_item=True)


def _kw(pt, loss, sigmoid):
    return dict(user_block=pt.user_block, item_block=pt.item_block,
                num_factors=F, loss=loss, sigmoid=sigmoid)


# (sigmoid, loss, use_p, epochs)
VARIANTS = [(False, LOSS_RMSE, True, 2), (True, LOSS_RMSE, True, 1),
            (True, LOSS_MAE, True, 1), (True, LOSS_RMSE, False, 1)]


@pytest.mark.parametrize("sigmoid,loss,use_p,epochs", VARIANTS,
                         ids=["plain", "sigmoid-rmse", "sigmoid-mae", "no-p"])
def test_epoch_matches_jax(setup, sigmoid, loss, use_p, epochs):
    pj, pt, tabs = setup
    W0, Q0, Y0 = _tables(pt, tabs, use_p)
    Wt, Qt, Yt = W0.clone(), Q0.clone(), Y0.clone()
    tabs_j = tuple(jnp.asarray(t.numpy()) for t in (W0, Q0, Y0))
    rates_j = _rates(use_p, psv)
    hp_j = np.zeros((1, 8), np.float32)
    hp_j[0, :3] = HP
    for _ in range(epochs):
        tabs_j = psv.svdpp_epoch_mxu(
            *tabs_j, pj.packed, pj.ph, pj.ub, pj.ib, pj.row, pj.first_flag,
            rates_j, jnp.asarray(hp_j), meta=pj.meta(SP.svdpp_fe(F)),
            num_factors=F, loss=loss, sigmoid=sigmoid, mxu_dtype="f32",
            interpret=True)
        svdpp_epoch(Wt, Qt, Yt, pt.packed, pt.schedule, HP, _rates(use_p),
                    **_kw(pt, loss, sigmoid))
    for got, ref in zip((Wt, Qt, Yt), tabs_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=2e-5)
    assert not torch.equal(Wt, W0) and not torch.equal(Qt, Q0) \
        and not torch.equal(Yt, Y0)
    if not use_p:
        assert not Wt[:, :F].any()      # p stays zero; the user bias moved
        assert not torch.equal(Wt[:, F], W0[:, F])
    # the constant columns never move: W's 1 and inv_sqrt, Q's 1
    for t0, t, cols in ((W0, Wt, [F + 1, F + 2]), (Q0, Qt, [F])):
        assert torch.equal(t[:, cols], t0[:, cols])


def test_cpu_wrapper_runs_reference_without_launch(setup):
    _, pt, tabs = setup
    tables = _tables(pt, tabs, True)
    copies = tuple(t.clone() for t in tables)
    kw = _kw(pt, LOSS_RMSE, True)
    before = svdpp_epoch.launches
    out = svdpp_epoch(*tables, pt.packed, pt.schedule, HP, _rates(True), **kw)
    assert all(a is b for a, b in zip(out, tables))        # in place
    svdpp_epoch_reference(*copies, pt.packed, pt.schedule, HP, _rates(True),
                          **kw)
    assert all(torch.equal(a, b) for a, b in zip(tables, copies))
    assert svdpp_epoch.launches == before == 0


def test_wrapper_rejects_bad_input(setup):
    _, pt, tabs = setup
    W, Q, Y = _tables(pt, tabs, True)
    rates = _rates(True)
    kw = _kw(pt, LOSS_RMSE, False)
    args = (pt.packed, pt.schedule, HP)
    with pytest.raises(TypeError):
        svdpp_epoch(W.double(), Q, Y, *args, rates, **kw)
    with pytest.raises(ValueError):
        svdpp_epoch(W, Q, Y[:, :16], *args, rates, **kw)
    with pytest.raises(ValueError):
        svdpp_epoch(W, Q, Y, *args, rates[:, :4].contiguous(), **kw)
    with pytest.raises(ValueError):
        svdpp_epoch(W.t(), Q, Y, *args, rates, **kw)
    with pytest.raises(ValueError):                    # fe < F + 3
        svdpp_epoch(W, Q, Y, *args, rates, **dict(kw, num_factors=30))
    with pytest.raises(ValueError):
        svdpp_epoch(W, Q, Y, pt.packed, pt.schedule[:3], HP, rates, **kw)
    with pytest.raises(ValueError, match="no kernel"):
        svdpp_epoch(*(t.to("meta") for t in (W, Q, Y)), pt.packed.to("meta"),
                    tuple(t.to("meta") for t in pt.schedule), HP,
                    rates.to("meta"), **kw)


def test_accumulator_variant_at_model_shapes():
    """R and Y read s, c and n from a copy in each CTA's shared memory
    where UB (Fp + 4) floats fit beside the rates, two chunks, their
    segment tables and the CTA's part of a step whose every entry lies in
    a run (``stage_need``; at most 512 list positions of the widest step,
    what one block kept) in 227 KB less 1 KB: at the models' plan (UB
    512, C 512, a cluster of 8) up to 64 factors, quality.py's k=20 and
    the k=50 width among them, and through L2 past that; a smaller block
    or chunk keeps the copy on chip longer."""
    from mymedialite_tpu_torch.ops import svdpp_epoch as se
    assert se.cluster_size(512) == 8
    for f in range(1, 254):
        want = "shared" if f <= 64 else "global"
        assert se.accumulator_variant(512, f, 512, SP.svdpp_fe(f)) == want
    # rates, packed rows, runs and codes [2, 1544 + 2 * 512], the live
    # float4 lists and their inverse, one row of the widest stage (W 32 +
    # c 20 + n 4 floats)
    base = 4 * (8 * 32 + 8 * 512) + 4 * (1544 + 1024) + 4 * 48
    assert se.shared_bytes(32, 512, 512, 20, "global") == base + 4 * 56
    assert se.shared_bytes(32, 512, 512, 20, "shared") == \
        base + 4 * 56 + 4 * 512 * 24
    assert se.accumulator_variant(256, 200, 512, SP.svdpp_fe(200)) == \
        "global"
    assert se.accumulator_variant(256, 20, 1024, SP.svdpp_fe(20)) == "shared"
    assert se.accumulator_variant(512, 20, 2048, SP.svdpp_fe(20)) == "global"


def test_kernel_shape_contract():
    """fe and the chunk multiples of 4, fe <= 256 (every ``svdpp_fe`` up to
    253 factors), the global variant's shared memory within 227 KB;
    the rest raise, with the contract in the message."""
    from mymedialite_tpu_torch.ops import svdpp_epoch as se
    for f in range(1, 254):
        for chunk in (8, 512):
            se.check_kernel_shape(SP.svdpp_fe(f), chunk)
    for fe, chunk in ((34, 512), (32, 510), (264, 512), (32, 8192)):
        with pytest.raises(ValueError, match="multiples of 4"):
            se.check_kernel_shape(fe, chunk)


def test_wrapper_checks_the_shape_before_the_device(setup):
    _, pt, tabs = setup
    meta = lambda ts: tuple(t.to("meta") for t in ts)  # noqa: E731
    tables = meta(_tables(pt, tabs, True))
    kw = _kw(pt, LOSS_RMSE, False)
    odd = torch.zeros((2, 4, 10), dtype=torch.int32, device="meta")
    before = svdpp_epoch.launches
    with pytest.raises(ValueError, match="multiples of 4"):
        svdpp_epoch(*tables, odd, meta(pt.schedule), HP,
                    _rates(True).to("meta"), **kw)
    with pytest.raises(ValueError, match="no kernel"):
        svdpp_epoch(*tables, pt.packed.to("meta"), meta(pt.schedule), HP,
                    _rates(True).to("meta"), **kw)
    assert svdpp_epoch.launches == before
