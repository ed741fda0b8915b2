"""The flat MF epoch of the port (``mymedialite_tpu_torch/ops/sgd.py``
``prepare_epoch_data`` / ``sgd_epoch``) and its data-parallel mesh form
(``sgd_epoch_sharded_flat``), against the JAX package's
``mymedialite_tpu.ops.sgd.sgd_epoch`` on the CPU.

The layout and dedup arrays are equal. One epoch from the same tables
and the JAX package's batch order (``jax.random.permutation(key,
num_batches)``, drawn on the JAX side and handed over) lands within
1e-6 of the JAX epoch for the RMSE, MAE and logistic losses, biased and
not, with and without frequency regularization, and with either side
frozen. The mesh form on 2, 4 and 8 CPU devices lands within 1e-6 of
the one-device form.
"""

import jax
import numpy as np
import pytest
import torch

from mymedialite_tpu.ops import sgd as jsgd
from mymedialite_tpu_torch.ops import sgd as tsgd
from mymedialite_tpu_torch.parallel.mesh import make_mesh
from torch_threads import one_torch_thread  # noqa: F401

U, I, N, F, B = 90, 70, 1500, 6, 128
HP = dict(learn_rate=0.05, reg_u=0.02, reg_i=0.03, bias_reg=0.1,
          bias_learn_rate=0.7, min_rating=1.0, rating_range=4.0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    v = rng.integers(1, 6, N).astype(np.float32)
    return u, i, v


def tables(biased: bool, seed: int = 1):
    rng = np.random.default_rng(seed)
    p = dict(global_bias=np.float32(3.1),
             user_factors=(0.1 * rng.standard_normal((U, F))).astype(
                 np.float32),
             item_factors=(0.1 * rng.standard_normal((I, F))).astype(
                 np.float32))
    if biased:
        p["user_bias"] = (0.1 * rng.standard_normal(U)).astype(np.float32)
        p["item_bias"] = (0.1 * rng.standard_normal(I)).astype(np.float32)
    return p


def inv_sqrt_counts(u, i):
    cu = np.maximum(np.bincount(u, minlength=U), 1).astype(np.float32)
    ci = np.maximum(np.bincount(i, minlength=I), 1).astype(np.float32)
    return 1.0 / np.sqrt(cu), 1.0 / np.sqrt(ci)


def torch_params(p):
    return {k: float(v) if k == "global_bias" else torch.from_numpy(v.copy())
            for k, v in p.items()}


def test_layout_equal(data):
    u, i, v = data
    jd = jsgd.prepare_epoch_data(u, i, v, B, shuffle_seed=3, num_users=U,
                                 num_items=I)
    td = tsgd.prepare_epoch_data(u, i, v, B, shuffle_seed=3, num_users=U,
                                 num_items=I)
    assert sorted(td) == sorted(jd)
    for k in jd:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]), k)
    assert td["users"].shape[0] % B == 0 and td["weights"].sum() == N


@pytest.mark.parametrize("loss", [jsgd.LOSS_RMSE, jsgd.LOSS_MAE,
                                  jsgd.LOSS_LOGISTIC])
@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("freq", [False, True])
def test_epoch_equals_jax(data, loss, biased, freq):
    u, i, v = data
    _check_epoch(u, i, v, loss=loss, biased=biased, freq=freq,
                 update_user=True, update_item=True)


@pytest.mark.parametrize("update_user,update_item", [(True, False),
                                                     (False, True)])
def test_frozen_side_equals_jax(data, update_user, update_item):
    u, i, v = data
    _check_epoch(u, i, v, loss=jsgd.LOSS_RMSE, biased=True, freq=False,
                 update_user=update_user, update_item=update_item)


def _check_epoch(u, i, v, *, loss, biased, freq, update_user, update_item):
    jd = jsgd.prepare_epoch_data(u, i, v, B, shuffle_seed=3, num_users=U,
                                 num_items=I)
    td = tsgd.prepare_epoch_data(u, i, v, B, shuffle_seed=3, num_users=U,
                                 num_items=I)
    if freq:
        cu, ci = inv_sqrt_counts(u, i)
        jd = dict(jd, inv_sqrt_count_user=cu, inv_sqrt_count_item=ci)
        td = dict(td, inv_sqrt_count_user=torch.from_numpy(cu),
                  inv_sqrt_count_item=torch.from_numpy(ci))
    key = jax.random.PRNGKey(7)
    nb = td["users"].shape[0] // B
    order = np.asarray(jax.random.permutation(key, nb))
    p = tables(biased)
    kw = dict(batch_size=B, loss=loss, biased=biased, update_user=update_user,
              update_item=update_item, frequency_regularization=freq)
    jout = jsgd.sgd_epoch({k: np.copy(a) for k, a in p.items()}, jd, key,
                          {k: np.float32(x) for k, x in HP.items()}, **kw)
    tout = tsgd.sgd_epoch(torch_params(p), td, order, HP, **kw)
    moved = 0.0
    for k in p:
        if k == "global_bias":
            continue
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=1e-6, err_msg=k)
        moved = max(moved, float(np.abs(tout[k].numpy() - p[k]).max()))
    assert moved > 1e-3


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("biased,freq", [(True, False), (False, True)])
def test_mesh_form_equals_one_device(data, D, biased, freq):
    u, i, v = data
    batch = 16 * D
    td = tsgd.prepare_epoch_data(u, i, v, batch, shuffle_seed=3,
                                 num_users=U, num_items=I)
    if freq:
        cu, ci = inv_sqrt_counts(u, i)
        td = dict(td, inv_sqrt_count_user=torch.from_numpy(cu),
                  inv_sqrt_count_item=torch.from_numpy(ci))
    order = np.random.default_rng(4).permutation(
        td["users"].shape[0] // batch)
    p = tables(biased, seed=2)
    kw = dict(batch_size=batch, loss=jsgd.LOSS_RMSE, biased=biased,
              update_user=True, update_item=True,
              frequency_regularization=freq)
    one = tsgd.sgd_epoch(torch_params(p), td, order, HP, **kw)
    many = tsgd.sgd_epoch_sharded_flat(make_mesh(devices=["cpu"] * D),
                                       torch_params(p), td, order, HP, **kw)
    for k in p:
        if k != "global_bias":
            np.testing.assert_allclose(many[k].numpy(), one[k].numpy(),
                                       atol=1e-6, err_msg=k)


def test_mesh_form_needs_whole_parts(data):
    u, i, v = data
    td = tsgd.prepare_epoch_data(u, i, v, 30, num_users=U, num_items=I)
    with pytest.raises(ValueError, match="multiple of the global devices"):
        tsgd.sgd_epoch_sharded_flat(
            make_mesh(devices=["cpu"] * 4), torch_params(tables(True)), td,
            [0], HP, batch_size=30, loss=0, biased=True, update_user=True,
            update_item=True, frequency_regularization=False)
