"""The port's BPR chunk plan and sampling state (``ops/bpr_plan.py``)
against the JAX package's (``ops/pallas_bpr.py``) on the same feedback:
every array is identical, the per-epoch negative plan is identical for
the same seeds, and the rates and the table layout round trip match."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mymedialite_tpu.data import PosOnlyData
from mymedialite_tpu.data.synthetic import synthetic_posonly
from mymedialite_tpu.ops import pallas_bpr as pb
from mymedialite_tpu_torch.ops import bpr_plan as tp
from torch_threads import one_torch_thread  # noqa: F401


def small_feedback():
    """30 users x 24 items, varied history sizes (tests/test_pallas_bpr.py)."""
    rng = np.random.default_rng(13)
    users, items = [], []
    for u in range(30):
        for i in rng.choice(24, size=int(rng.integers(2, 12)), replace=False):
            users.append(u)
            items.append(int(i))
    return PosOnlyData(users, items, num_users=30, num_items=24)


# (feedback, plan keyword arguments): toy blocks, and the models' own
# blocks on a catalog of two item blocks and three user blocks
CASES = {
    "toy": (small_feedback, dict(user_block=8, item_block=8, chunk=8,
                                 shuffle_seed=3)),
    "model-blocks": (lambda: synthetic_posonly(
        num_users=1200, num_items=1500, num_events=12000, seed=5),
        dict(shuffle_seed=42)),
}


@pytest.fixture(scope="module", params=[(c, uu) for c in CASES
                                        for uu in (True, False)],
                ids=lambda p: f"{p[0]}-{'uniform_user' if p[1] else 'pair'}")
def both(request):
    case, uniform_user = request.param
    make, kw = CASES[case]
    fb = make()
    jax_out = pb.prepare_bpr_mxu(fb, uniform_user=uniform_user,
                                 bitmask=True, **kw)
    port_out = tp.prepare_bpr_mxu(fb, uniform_user=uniform_user,
                                  bitmask=True, **kw)
    return fb, jax_out, port_out


def test_plan_identical(both):
    _, (jplan, _, jmeta), (tplan, _, tmeta) = both
    assert tmeta == jmeta
    np.testing.assert_array_equal(tplan.packed.numpy(),
                                  np.asarray(jplan.packed))
    for name in ("ub_c", "ib_c", "new_of_old", "old_of_new"):
        np.testing.assert_array_equal(getattr(tplan, name),
                                      getattr(jplan, name))
    assert (tplan.num_chunks, tplan.chunk, tplan.n_ublocks,
            tplan.n_iblocks) == (jplan.num_chunks, jplan.chunk,
                                 jplan.n_ublocks, jplan.n_iblocks)


def test_sampling_state_identical(both):
    _, (_, js, _), (_, ts, _) = both
    for name in ("keys_tbl", "cdf_tbl", "bitmask_tbl"):
        assert ts[name].dtype == torch.from_numpy(np.array(js[name])).dtype
        np.testing.assert_array_equal(ts[name].numpy(), np.asarray(js[name]))
    np.testing.assert_array_equal(ts["nvalid"], js["nvalid"])
    np.testing.assert_array_equal(ts["block_mass"], js["block_mass"])


def test_weights_in_packed(both):
    """Row 2 carries the base weight (the uniform-user importance weight
    or 1), row 3 the padding weight."""
    fb, _, (tplan, _, _) = both
    packed = tplan.packed.numpy()
    pad_w = packed[:, 3].view(np.float32)
    base_w = packed[:, 2].view(np.float32)
    assert set(np.unique(pad_w)) <= {0.0, 1.0}
    assert (pad_w > 0).sum() == len(fb)
    assert base_w[pad_w > 0].sum() == pytest.approx(len(fb), rel=1e-5)


@pytest.mark.parametrize("wbpr", [False, True], ids=["uniform", "wbpr"])
def test_epoch_negative_plan_identical(both, wbpr):
    fb, (jplan, js, _), (tplan, ts, _) = both
    for epoch in range(3):
        order = tplan.epoch_order(100 + epoch)
        ub_visit = order[0].numpy()
        jax_out = pb.epoch_negative_plan(
            jplan, js["nvalid"], ub_visit, fb.num_items, 7 + epoch,
            block_mass=js["block_mass"] if wbpr else None)
        port_out = tp.epoch_negative_plan(
            tplan, ts["nvalid"], ub_visit, fb.num_items, 7 + epoch,
            block_mass=ts["block_mass"] if wbpr else None)
        for a, b in zip(port_out, jax_out):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_rates_and_table_round_trip(both):
    fb, (jplan, _, _), (tplan, _, _) = both
    f, fe = 6, 64
    for update_j in (True, False):
        np.testing.assert_array_equal(
            tp.bpr_mxu_column_rates(f, fe, 0.05, 0.0025, 0.003, 0.00025,
                                    0.01, update_j).numpy(),
            np.asarray(pb.bpr_mxu_column_rates(f, fe, 0.05, 0.0025, 0.003,
                                               0.00025, 0.01, update_j)))
    rng = np.random.default_rng(1)
    W = rng.standard_normal((fb.num_users, f)).astype(np.float32)
    H = rng.standard_normal((fb.num_items, f)).astype(np.float32)
    bias = rng.standard_normal(fb.num_items).astype(np.float32)
    nof = torch.from_numpy(tplan.new_of_old.astype(np.int64))
    We, He = tp.bpr_tables_to_mxu(torch.from_numpy(W), torch.from_numpy(H),
                                  torch.from_numpy(bias), nof,
                                  u_pad=tplan.u_pad, i_pad=tplan.i_pad, fe=fe)
    jWe, jHe = pb.bpr_tables_to_mxu(
        jnp.asarray(W), jnp.asarray(H), jnp.asarray(bias),
        jnp.asarray(jplan.new_of_old), u_pad=jplan.u_pad, i_pad=jplan.i_pad,
        fe=fe)
    np.testing.assert_array_equal(We.numpy(), np.asarray(jWe))
    np.testing.assert_array_equal(He.numpy(), np.asarray(jHe))
    for got, want in zip(tp.bpr_tables_from_mxu(
            We, He, nof, num_users=fb.num_users, num_factors=f),
            (W, H, bias)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_resident_bound_matches_jax():
    from mymedialite_tpu.ops import pallas_sgd as ps
    for items in (1000, 17_770, 40_000, 41_000, 100_000):
        for f in (10, 40, 62, 100):
            assert tp.mxu_supported(items, f) == ps.mxu_supported(items, f)


def test_bitmask_auto_by_size(monkeypatch):
    fb = small_feedback()
    kw = dict(uniform_user=True, user_block=8, item_block=8, chunk=8)
    assert "bitmask_tbl" in tp.prepare_bpr_mxu(fb, **kw)[1]
    monkeypatch.setattr(tp, "BITMASK_HBM_BYTES", 16)
    assert "bitmask_tbl" not in tp.prepare_bpr_mxu(fb, **kw)[1]
