"""The port's SGD epoch (``mymedialite_tpu_torch/ops/sgd_epoch.py``)
against the JAX package's Pallas epoch (``ops/pallas_sgd.py
sgd_epoch_mxu``), run here in interpret mode with float32 operands.

Both start from the same plan, order, tables and rates. The sums inside
a chunk run in another order, so the tables agree to atol 1e-5. On CPU
tensors the wrapper runs the plain version and launches nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mymedialite_tpu.ops import pallas_sgd as ps
from mymedialite_tpu_torch.ops import plan as P
from mymedialite_tpu_torch.ops import sgd as S
from mymedialite_tpu_torch.ops.sgd_epoch import sgd_epoch, sgd_epoch_reference
from torch_threads import one_torch_thread  # noqa: F401

U, I, N, F = 90, 70, 1500, 6


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    users = rng.integers(0, U, N).astype(np.int32)
    # skewed items: duplicates within a chunk must sum
    items = (rng.zipf(1.5, N) % I).astype(np.int32)
    values = (rng.integers(2, 11, N) / 2).astype(np.float32)
    kw = dict(user_block=32, item_block=32, chunk=64, shuffle_seed=4)
    plan_j = ps.prepare_mxu_data(users, items, values, U, I, **kw)
    plan_t = P.prepare_mxu_data(users, items, values, U, I, **kw)
    W0 = 0.1 * rng.standard_normal((U, F)).astype(np.float32)
    H0 = 0.1 * rng.standard_normal((I, F)).astype(np.float32)
    bu = 0.1 * rng.standard_normal(U).astype(np.float32)
    bi = 0.1 * rng.standard_normal(I).astype(np.float32)
    return plan_j, plan_t, (W0, H0, bu, bi)


def _run_both(setup, loss, biased, sides, epochs):
    plan_j, plan_t, (W0, H0, bu, bi) = setup
    fe = 64
    args = (F, fe, 0.05, 0.03, 0.02, 0.8, 0.4, biased, *sides)
    rates_j = ps.mxu_column_rates(*args)
    rates_t = P.mxu_column_rates(*args)
    hp = (0.2, 1.0, 4.0) if biased else (3.1, 1.0, 4.0)
    hp_j = np.zeros((1, 8), np.float32)
    hp_j[0, :3] = hp
    Wj, Hj = ps.extend_tables_mxu(plan_j, W0, H0, bu, bi)
    Wt, Ht = P.extend_tables_mxu(plan_t, W0, H0, bu, bi)
    for e in range(epochs):
        seed = 100 + e
        Wj, Hj = ps.sgd_epoch_mxu(
            Wj, Hj, plan_j.packed, plan_j.epoch_order(seed),
            jnp.asarray(hp_j), rates_j, meta=plan_j.meta(fe), loss=loss,
            biased=biased, mxu_dtype="f32", interpret=True)
        sgd_epoch(Wt, Ht, plan_t.packed, plan_t.epoch_order(seed), hp,
                  rates_t, user_block=plan_t.user_block,
                  item_block=plan_t.item_block, loss=loss, biased=biased)
    return (np.asarray(Wj), np.asarray(Hj)), (Wt.numpy(), Ht.numpy())


LOSSES = (S.LOSS_RMSE, S.LOSS_MAE, S.LOSS_LOGISTIC)
SIDES = ((True, True), (True, False), (False, True))


@pytest.mark.parametrize("sides", SIDES)
@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("loss", LOSSES)
def test_epoch_matches_jax(setup, loss, biased, sides):
    for epochs in (1, 3):
        (Wj, Hj), (Wt, Ht) = _run_both(setup, loss, biased, sides, epochs)
        np.testing.assert_allclose(Wt, Wj, rtol=0, atol=1e-5)
        np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-5)
    W0, H0 = P.extend_tables_mxu(setup[1], *setup[2])
    assert (not np.array_equal(Wt, W0.numpy())) == sides[0]
    assert (not np.array_equal(Ht, H0.numpy())) == sides[1]


def test_cpu_wrapper_runs_reference_without_launch(setup):
    _, plan, tabs = setup
    W, H = P.extend_tables_mxu(plan, *tabs)
    W2, H2 = W.clone(), H.clone()
    rates = P.mxu_column_rates(F, 64, 0.05, 0.03, 0.02, 0.8, 0.4, True,
                               True, True)
    order = plan.epoch_order(3)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=S.LOSS_RMSE, biased=True)
    before = sgd_epoch.launches
    out = sgd_epoch(W, H, plan.packed, order, (0.2, 1.0, 4.0), rates, **kw)
    assert out[0] is W and out[1] is H          # in place
    sgd_epoch_reference(W2, H2, plan.packed, order, (0.2, 1.0, 4.0), rates,
                        **kw)
    assert torch.equal(W, W2) and torch.equal(H, H2)
    assert sgd_epoch.launches == before == 0


def test_wrapper_rejects_bad_input(setup):
    _, plan, tabs = setup
    W, H = P.extend_tables_mxu(plan, *tabs)
    rates = P.mxu_column_rates(F, 64, 0.05, 0.03, 0.02, 0.8, 0.4, True,
                               True, True)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=S.LOSS_RMSE, biased=True)
    order = plan.epoch_order(1)
    with pytest.raises(TypeError):
        sgd_epoch(W.double(), H, plan.packed, order, (0., 1., 4.), rates, **kw)
    with pytest.raises(ValueError):
        sgd_epoch(W, H[:, :32], plan.packed, order, (0., 1., 4.), rates, **kw)
    with pytest.raises(ValueError):
        sgd_epoch(W.t(), H, plan.packed, order, (0., 1., 4.), rates, **kw)


def test_kernel_shape_contract():
    """The kernel takes fe and the chunk in multiples of 4 (float4 rows,
    16-byte pieces of a chunk), fe <= 256, and two chunks, their segment
    tables, the rates and one row of the owner scatter's stage within 227
    KB of shared memory: every width ``fused_width`` gives up to 254
    factors at every chunk the plans pick (128-640, the CPU tests' 64)
    passes, and the rest raise before any launch."""
    from mymedialite_tpu_torch.ops import sgd_epoch as se
    for f in range(1, 255):
        for chunk in (64, 128, 256, 384, 512, 640):
            se.check_kernel_shape(P.fused_width(f), chunk)
    # rates, packed rows, runs and codes [2, 1928 + 2 * 640], the live
    # float4 lists and their inverse, a stage row
    assert se.shared_bytes(64, 640) == \
        4 * (4 * 64 + 8 * 640) + 4 * (1928 + 1280) + 4 * 64 + 4 * 64
    for fe, chunk in ((62, 640), (64, 642), (264, 640), (64, 8192)):
        with pytest.raises(ValueError, match="multiples of 4"):
            se.check_kernel_shape(fe, chunk)


def test_wrapper_checks_the_shape_before_the_device(setup):
    """Off the CPU the wrapper refuses a shape the kernel does not take
    before it asks for the kernel, and a device without one after."""
    _, plan, tabs = setup
    W, H = P.extend_tables_mxu(plan, *tabs)
    rates = P.mxu_column_rates(F, 64, 0.05, 0.03, 0.02, 0.8, 0.4, True,
                               True, True)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=S.LOSS_RMSE, biased=True)
    meta = lambda ts: tuple(t.to("meta") for t in ts)  # noqa: E731
    order = meta(plan.epoch_order(1))
    odd = torch.zeros((2, 4, 66), dtype=torch.int32, device="meta")
    before = sgd_epoch.launches
    with pytest.raises(ValueError, match="multiples of 4"):
        sgd_epoch(*meta((W, H)), odd, order, (0., 1., 4.), rates.to("meta"),
                  **kw)
    with pytest.raises(ValueError, match="no kernel"):
        sgd_epoch(*meta((W, H)), plan.packed.to("meta"), order, (0., 1., 4.),
                  rates.to("meta"), **kw)
    assert sgd_epoch.launches == before
