"""The blocked MF epoch of the port (``mymedialite_tpu_torch/ops/sgd.py``
``prepare_blocked_data`` / ``sgd_epoch_blocked``) and the MF family's
route to it, against the JAX package's XLA epoch on the CPU.

The layout arrays are equal. One epoch fed the JAX package's batch
orders (``jax.random.permutation(fold_in(key, g), nb)``) lands within
1e-5 of ``mymedialite_tpu.ops.sgd.sgd_epoch_blocked`` from the same
tables, for the plain and the biased model, every loss, with and without
frequency regularization and with either side frozen. BiasedMF and MF
with frequency regularization match the JAX models after 3 epochs from
the same initial tables (``convert.tables_from_jax``) and batch orders.
Past the tiled schedule's ``MAX_SLABS`` ``select_schedule`` names the
third route, and the models train on it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mymedialite_tpu.data.arrays import RatingData as JaxRatingData
from mymedialite_tpu.models import mf as jmf
from mymedialite_tpu.ops import sgd as jsgd
from mymedialite_tpu.utils.params import configure as jax_configure
from mymedialite_tpu_torch.convert import tables_from_jax
from mymedialite_tpu_torch.data.arrays import RatingData
from mymedialite_tpu_torch.models import mf as tmf
from mymedialite_tpu_torch.models.registry import create_rating_predictor
from mymedialite_tpu_torch.ops import plan as tplan
from mymedialite_tpu_torch.ops import sgd as tsgd
from torch_threads import one_torch_thread  # noqa: F401

U, I, N, F = 300, 120, 5000, 5
G, B = 64, 512


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    v = rng.integers(1, 6, N).astype(np.float32)
    return u, i, v


def test_layout_equal(data):
    u, i, v = data
    jd, jm = jsgd.prepare_blocked_data(u, i, v, U, batch_size=B,
                                       group_users=G, shuffle_seed=3)
    td, tm = tsgd.prepare_blocked_data(u, i, v, U, batch_size=B,
                                       group_users=G, shuffle_seed=3)
    assert tm == jm and tm["ngroups"] == 5 and tm["l_pad"] // B > 1
    for k in ("gu", "gi", "gv", "gw"):
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]), k)
    np.testing.assert_array_equal(td["count"], np.asarray(jd["gw"]).sum(1))
    args = (F, 0.05, 0.01, 0.02, 0.7, 0.1)
    for flags in ((True, True, True), (False, True, False),
                  (True, False, True)):
        for a, b in zip(tsgd.column_rates(*args, *flags),
                        jsgd.column_rates(*args, *flags)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def jax_orders(key, meta):
    nb = meta["l_pad"] // meta["batch"]
    return np.stack([np.asarray(jax.random.permutation(
        jax.random.fold_in(key, g), nb)) for g in range(meta["ngroups"])])


@pytest.mark.parametrize("biased,loss", [(True, 0), (True, 1), (True, 2),
                                         (False, 0)])
@pytest.mark.parametrize("freq", [False, True])
@pytest.mark.parametrize("sides", [(True, True), (False, True),
                                   (True, False)])
def test_epoch_matches_jax(data, biased, loss, freq, sides):
    u, i, v = data
    rng = np.random.default_rng(1)
    W = (0.1 * rng.standard_normal((U, F))).astype(np.float32)
    H = (0.1 * rng.standard_normal((I, F))).astype(np.float32)
    bu = (0.1 * rng.standard_normal(U)).astype(np.float32)
    bi = (0.1 * rng.standard_normal(I)).astype(np.float32)
    jd, meta = jsgd.prepare_blocked_data(u, i, v, U, batch_size=B,
                                         group_users=G, shuffle_seed=3)
    td, _ = tsgd.prepare_blocked_data(u, i, v, U, batch_size=B,
                                      group_users=G, shuffle_seed=3)
    args = (F, 0.05, 0.01, 0.02, 0.7, 0.1, biased, *sides)
    We, He = jsgd.extend_tables(W, H, bu, bi, group_users=G)
    count_u, count_i = np.bincount(u, minlength=U), np.bincount(i, minlength=I)
    tfreq = tsgd.blocked_freq(count_u, count_i, We.shape[0]) if freq else None
    jfreq = ((jnp.asarray(tfreq[0].numpy()), jnp.asarray(tfreq[1].numpy()))
             if freq else (jnp.zeros(0), jnp.zeros(0)))
    key = jax.random.PRNGKey(5)
    hp = dict(global_bias=jnp.float32(0.3), min_rating=jnp.float32(1.0),
              rating_range=jnp.float32(4.0))
    Wj, Hj = jsgd.sgd_epoch_blocked(
        We, He, jd, key, hp, jsgd.column_rates(*args), jfreq,
        meta=tuple(sorted(meta.items())), loss=loss, biased=biased,
        frequency_regularization=freq)
    Wt, Ht = tsgd.extend_tables(W, H, bu, bi, group_users=G)
    tsgd.sgd_epoch_blocked(Wt, Ht, td, torch.from_numpy(jax_orders(key, meta)),
                           (0.3, 1.0, 4.0), tsgd.column_rates(*args), tfreq,
                           meta=meta, loss=loss, biased=biased)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=0, atol=1e-5)
    assert not np.array_equal(Ht.numpy(), He) or not sides[1]


def test_freq_reg_objective_matches_jax(data):
    u, i, v = data
    rng = np.random.default_rng(2)
    p = dict(user_factors=rng.standard_normal((U, F)),
             item_factors=rng.standard_normal((I, F)),
             user_bias=rng.standard_normal(U), item_bias=rng.standard_normal(I))
    p = {k: a.astype(np.float32) for k, a in p.items()}
    counts = dict(count_user=np.bincount(u[:4000], minlength=U),
                  count_item=np.bincount(i, minlength=I))
    hp = dict(min_rating=1.0, rating_range=4.0, reg_u=0.02, reg_i=0.03,
              bias_reg=0.1)
    got = tsgd.mf_objective(
        {k: torch.from_numpy(a) for k, a in p.items()} | dict(global_bias=0.2),
        dict(users=torch.from_numpy(u.astype(np.int64)),
             items=torch.from_numpy(i.astype(np.int64)),
             values=torch.from_numpy(v)), hp,
        {k: torch.from_numpy(a) for k, a in counts.items()}, loss=0,
        biased=True, frequency_regularization=True)
    want = jsgd.mf_objective(
        {k: jnp.asarray(a) for k, a in p.items()} | dict(
            global_bias=jnp.float32(0.2)),
        dict(users=jnp.asarray(u), items=jnp.asarray(i), values=jnp.asarray(v),
             weights=jnp.ones(N)), {k: jnp.float32(x) for k, x in hp.items()},
        {k: jnp.asarray(a) for k, a in counts.items()}, loss=0, biased=True,
        frequency_regularization=True)
    assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.fixture
def shared_runs(monkeypatch):
    """Each JAX init_model records its tables and each JAX blocked epoch
    its key; the port's next init_model starts from the oldest recorded
    tables and its next epoch takes the batch orders of the oldest key."""
    tables, keys = [], []
    jax_init, port_init = jmf.MatrixFactorization.init_model, \
        tmf.MatrixFactorization.init_model
    jax_epoch = jsgd.sgd_epoch_blocked

    def record(self):
        jax_init(self)
        tables.append(tables_from_jax(self))

    def replay(self, tables_=None):
        port_init(self, tables.pop(0) if tables_ is None else tables_)

    def epoch(*a, **kw):
        keys.append(a[3])
        return jax_epoch(*a, **kw)

    def orders(self, ngroups, nb):
        meta = dict(ngroups=ngroups, l_pad=nb, batch=1)
        return torch.from_numpy(jax_orders(keys.pop(0), meta))

    monkeypatch.setattr(jmf.MatrixFactorization, "init_model", record)
    monkeypatch.setattr(tmf.MatrixFactorization, "init_model", replay)
    monkeypatch.setattr(jsgd, "sgd_epoch_blocked", epoch)
    monkeypatch.setattr(tmf.MatrixFactorization, "_batch_orders", orders)


@pytest.mark.parametrize("name,opts", [
    ("BiasedMatrixFactorization", "frequency_regularization=true"),
    ("BiasedMatrixFactorization",
     "frequency_regularization=true loss=MAE bold_driver=true"),
    ("MatrixFactorization", "")])
def test_models_match_jax(data, shared_runs, monkeypatch, name, opts):
    """Three epochs from the same tables and orders; the plain MF takes
    the blocked route past a shrunk tiled bound (its JAX twin on the CPU
    runs the blocked epoch anyway)."""
    monkeypatch.setattr(tplan, "RESIDENT_ITEM_TABLE_BYTES", 1024)
    u, i, v = data
    cut = 4000
    o = f"num_factors={F} num_iter=3 batch_size={B} group_users={G} {opts}"
    jm = getattr(jmf, name)()
    jax_configure(jm, o)
    tm = create_rating_predictor(name, o + " device=cpu")
    jm.ratings = JaxRatingData(u[:cut], i[:cut], v[:cut], num_users=U,
                               num_items=I)
    tm.ratings = RatingData(u[:cut], i[:cut], v[:cut], num_users=U,
                            num_items=I)
    jm.train()
    tm.train()
    assert tm._route() == "minibatch" and tm._blocked is not None
    np.testing.assert_allclose(tm.W_ext.numpy(), np.asarray(jm.W_ext),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.H_ext.numpy(), np.asarray(jm.H_ext),
                               rtol=0, atol=1e-5)
    assert tm.current_learnrate == pytest.approx(jm.current_learnrate)
    np.testing.assert_allclose(tm.predict_batch(u[cut:], i[cut:]),
                               jm.predict_batch(u[cut:], i[cut:]), atol=1e-5)
    assert tm.compute_objective() == pytest.approx(jm.compute_objective(),
                                                   rel=1e-5)


def test_schedule_past_max_slabs():
    assert tplan.select_schedule(17_770, 40) == "resident"
    assert tplan.select_schedule(62_423, 40) == "tiled"
    assert tplan.select_schedule(2_200_000, 40) == "minibatch"
    assert tplan.select_schedule(2_097_152, 40) == "tiled"
    assert tplan.select_schedule(2_097_153, 40) == "minibatch"


def test_loaded_model_grows_to_the_grid(data, tmp_path):
    """A saved model continues on the blocked route from its file, its
    user table grown to the epoch's padded grid; training from the file
    matches training on."""
    u, i, v = data
    ratings = RatingData(u, i, v, num_users=U, num_items=I)
    opts = (f"num_factors={F} num_iter=2 batch_size={B} group_users=50 "
            "frequency_regularization=true device=cpu")
    a = create_rating_predictor("BiasedMatrixFactorization", opts)
    a.ratings = ratings
    a.train()
    path = str(tmp_path / "m.model")
    a.save_model(path)
    b = create_rating_predictor("BiasedMatrixFactorization", opts)
    b.ratings = ratings
    b.load_model(path)
    b.group_users = 64
    b.iterate()
    assert b.W_ext.shape[0] == 320 and b._blocked[1]["group_users"] == 64
    assert np.isfinite(b.predict_batch(u, i)).all()
