"""The sharded grouped SVD++ epoch of the port (``ops/svdpp.py
svdpp_epoch_sharded``) and the SVD++ family's mesh route, against the
JAX package's ``svdpp_epoch_sharded`` on its virtual CPU mesh.

The port runs on meshes of D = 2, 4 and 8 CPU "devices" (``["cpu"] *
D``); the JAX package on ``make_mesh(D)``. One epoch from the same tables
lands within 1e-5 of JAX's with and without p and with the sigmoid,
groups padded to a multiple of D; on the disjoint-blocks fixture of
``tests/test_svdpp.py`` (each group on its own item block) it equals one
device's grouped epoch. SVDPlusPlus, SigmoidSVDPlusPlus and the three
asymmetric factor models with a CPU mesh take the "sharded" route and
match the JAX models (which shard over the suite's host devices) after two
epochs from the same tables; GSVDPlusPlus stays on one device, and says
so.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mymedialite_tpu.data.arrays import RatingData as JaxRatingData
from mymedialite_tpu.models import svdpp as jsv
from mymedialite_tpu.ops import svdpp as jops
from mymedialite_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mymedialite_tpu.parallel.mesh import (
    replicated, row_sharded, row_sharded_2d,
)
from mymedialite_tpu_torch.convert import svdpp_tables_from_jax
from mymedialite_tpu_torch.data.arrays import RatingData
from mymedialite_tpu_torch.models.registry import create_rating_predictor
from mymedialite_tpu_torch.ops import svdpp as tops
from mymedialite_tpu_torch.parallel.mesh import make_mesh
from torch_threads import one_torch_thread  # noqa: F401

U, I, N, F = 150, 100, 6000, 6
TOL = 1e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    v = rng.integers(1, 6, N).astype(np.float32)
    hu, hi = tops.history_edges(u, i, I, (rng.integers(0, U, 400),
                                          rng.integers(0, I, 400)))
    return u, i, v, hu, hi


def jax_sharded_epoch(D, jd, jm, tables, regs, hp, **kw):
    """JAX ``svdpp_epoch_sharded`` on ``make_mesh(D)``, the tables and
    data placed as ``SVDPlusPlus._iterate_sharded`` places them."""
    mesh = jax_make_mesh(D)
    rep, sh1, sh2 = replicated(mesh), row_sharded(mesh), row_sharded_2d(mesh)
    params = dict(global_bias=jax.device_put(jnp.float32(hp["global_bias"]),
                                             rep))
    for k, t in tables.items():
        sh = (sh2 if t.ndim == 2 else sh1) if k in ("p", "user_bias") \
            else rep
        params[k] = jax.device_put(t, sh)
    sd = {k: jax.device_put(np.asarray(jd[k]), sh2)
          for k in ("r_user", "r_item", "r_value", "r_mask", "e_user",
                    "e_item", "e_mask")}
    sd["inv_sqrt_hist"] = jax.device_put(np.asarray(jd["inv_sqrt_hist"]),
                                         sh1)
    jhp = {k: jnp.float32(hp[k]) for k in (
        "learn_rate", "bias_learn_rate", "bias_reg", "min_rating",
        "rating_range")}
    jhp.update(user_reg=jax.device_put(regs["user_reg"], sh1),
               item_reg=jax.device_put(regs["item_reg"], rep),
               y_reg=jax.device_put(regs["y_reg"], rep))
    out = jops.svdpp_epoch_sharded(mesh, params, sd, jhp,
                                   group_users=jm["group_users"],
                                   ngroups=jm["ngroups"], **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def random_tables(Up, use_p, seed=3):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    tables = dict(user_bias=normal(Up), item_bias=normal(I),
                  item_factors=normal(I, F), y=normal(I, F))
    if use_p:
        tables["p"] = normal(Up, F)
    regs = {k: rng.uniform(0.01, 0.05, n).astype(np.float32)
            for k, n in (("user_reg", Up), ("item_reg", I), ("y_reg", I))}
    return tables, regs


def port_epoch(D, tg, tables, regs, hp, inv, **kw):
    params = {k: torch.from_numpy(t.copy()) for k, t in tables.items()}
    tregs = {k: torch.from_numpy(r) for k, r in regs.items()}
    tops.svdpp_epoch_sharded(make_mesh(devices=["cpu"] * D), params, tg,
                             torch.from_numpy(inv), hp, tregs, **kw)
    return {k: v.numpy() for k, v in params.items()}


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("use_p,sigmoid,loss", [
    (True, False, 0), (False, False, 0), (True, True, 0), (False, True, 1)])
def test_sharded_epoch_matches_jax(data, D, use_p, sigmoid, loss):
    u, i, v, hu, hi = data
    G = 16                                  # 10 groups, padded to D's
    jd, jm = jops.prepare_groups(JaxRatingData(u, i, v, num_users=U,
                                               num_items=I),
                                 hu, hi, U, I, G, pad_groups_multiple=D)
    tg = tops.prepare_groups(u, i, v, hu, hi, U, G, pad_groups_multiple=D)
    assert tg.ngroups == jm["ngroups"] and tg.ngroups % D == 0
    Up = jm["ngroups"] * G
    tables, regs = random_tables(Up, use_p)
    hp = dict(global_bias=0.2, learn_rate=0.01, bias_learn_rate=0.7,
              bias_reg=0.33, min_rating=1.0, rating_range=4.0)
    kw = dict(loss=loss, sigmoid=sigmoid, use_p=use_p, update_user=True,
              update_item=True)
    want = jax_sharded_epoch(D, jd, jm, tables, regs, hp, **kw)
    inv = np.array(jd["inv_sqrt_hist"])
    got = port_epoch(D, tg, tables, regs, hp, inv, **kw)
    for k in tables:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, err_msg=k)


def test_sharded_order_differs_from_one_device(data):
    """Step g runs group d * groups_local + g on every device from the
    same item tables: a different trajectory from the one-device epoch,
    which the port keeps (it matches JAX's, above)."""
    u, i, v, hu, hi = data
    G, D = 16, 2
    tg = tops.prepare_groups(u, i, v, hu, hi, U, G, pad_groups_multiple=D)
    tables, regs = random_tables(tg.ngroups * G, True)
    hp = dict(global_bias=0.2, learn_rate=0.01, bias_learn_rate=0.7,
              bias_reg=0.33, min_rating=1.0, rating_range=4.0)
    inv = tops.inv_sqrt_counts(hu, tg.ngroups * G)
    kw = dict(loss=0, sigmoid=False, use_p=True)
    sharded = port_epoch(D, tg, tables, regs, hp, inv, **kw)
    params = {k: torch.from_numpy(t.copy()) for k, t in tables.items()}
    tops.svdpp_epoch_grouped(params, tg, torch.from_numpy(inv), hp,
                             {k: torch.from_numpy(r) for k, r in regs.items()},
                             **kw)
    assert np.abs(sharded["y"] - params["y"].numpy()).max() > 1e-6


@pytest.mark.parametrize("D", [2, 4, 8])
def test_disjoint_blocks_equal_one_device(D):
    """The fixture of ``tests/test_svdpp.py:113-190``: each group rates
    only its own item block, so the merge adds non-overlapping deltas
    and the sharded epoch equals the one-device grouped epoch."""
    G, IB, f = 8, 10, 4
    Ud, Id = G * D, IB * D
    rng = np.random.default_rng(1)
    users, items, values = [], [], []
    for uu in range(Ud):
        for _ in range(6):
            users.append(uu)
            items.append((uu // G) * IB + int(rng.integers(0, IB)))
            values.append(float(rng.uniform(1, 5)))
    users, items = np.asarray(users, np.int32), np.asarray(items, np.int32)
    values = np.asarray(values, np.float32)
    tg = tops.prepare_groups(users, items, values, users, items, Ud, G,
                             pad_groups_multiple=D)
    assert tg.ngroups == D
    q = (0.1 * rng.standard_normal((Id, f))).astype(np.float32)

    def fresh():
        return dict(user_bias=torch.zeros(Ud), item_bias=torch.zeros(Id),
                    item_factors=torch.from_numpy(q.copy()),
                    y=torch.full((Id, f), 0.05), p=torch.full((Ud, f), 0.1))
    regs = dict(user_reg=torch.full((Ud,), 0.015),
                item_reg=torch.full((Id,), 0.015),
                y_reg=torch.full((Id,), 0.015))
    hp = dict(global_bias=3.0, learn_rate=0.01, bias_learn_rate=1.0,
              bias_reg=0.33, min_rating=1.0, rating_range=4.0)
    inv = torch.from_numpy(tops.inv_sqrt_counts(users, Ud))
    kw = dict(loss=0, sigmoid=False, use_p=True)
    single = fresh()
    tops.svdpp_epoch_grouped(single, tg, inv, hp, regs, **kw)
    sharded = fresh()
    tops.svdpp_epoch_sharded(make_mesh(devices=["cpu"] * D), sharded, tg,
                             inv, hp, regs, **kw)
    for k in single:
        np.testing.assert_allclose(sharded[k].numpy(), single[k].numpy(),
                                   atol=1e-6, err_msg=k)


def test_sharded_epoch_frozen_sides(data):
    """With the item side frozen the item tables stay as they were; with
    the user side frozen the user tables do."""
    u, i, v, hu, hi = data
    G, D = 16, 4
    tg = tops.prepare_groups(u, i, v, hu, hi, U, G, pad_groups_multiple=D)
    tables, regs = random_tables(U, True)
    hp = dict(global_bias=0.2, learn_rate=0.01, bias_learn_rate=0.7,
              bias_reg=0.33, min_rating=1.0, rating_range=4.0)
    inv = tops.inv_sqrt_counts(hu, U)
    regs = dict(regs, user_reg=regs["user_reg"][:U])
    no_items = port_epoch(D, tg, tables, regs, hp, inv, loss=0,
                          sigmoid=False, use_p=True, update_item=False)
    for k in ("item_bias", "item_factors", "y"):
        np.testing.assert_array_equal(no_items[k], tables[k])
    assert np.abs(no_items["p"] - tables["p"]).max() > 0
    no_users = port_epoch(D, tg, tables, regs, hp, inv, loss=0,
                          sigmoid=False, use_p=True, update_user=False)
    for k in ("user_bias", "p"):
        np.testing.assert_array_equal(no_users[k], tables[k])


def ratings_pair(data):
    u, i, v, _, _ = data
    return (JaxRatingData(u, i, v, num_users=U, num_items=I),
            RatingData(u, i, v, num_users=U, num_items=I))


@pytest.mark.parametrize("name", [
    "SVDPlusPlus", "SigmoidSVDPlusPlus", "SigmoidItemAsymmetricFactorModel"])
@pytest.mark.parametrize("D", [2, 8])
def test_models_take_the_sharded_route(data, name, D, monkeypatch):
    jr, tr = ratings_pair(data)
    monkeypatch.setattr(jsv.SVDPlusPlus, "_setup_mesh",
                        lambda self: jax_make_mesh(D))
    j = getattr(jsv, name)()
    opts = dict(num_factors=F, num_iter=2, group_users=16,
                learn_rate=0.005)
    for k, val in opts.items():
        setattr(j, k, val)
    j.ratings = jr
    j.init_model()
    assert j._mesh is not None and j._meta["ngroups"] % D == 0
    t = create_rating_predictor(
        name, " ".join(f"{k}={val}" for k, val in opts.items())
        + " device=cpu")
    t.mesh = make_mesh(devices=["cpu"] * D)
    t.ratings = tr
    t.init_model(tables=svdpp_tables_from_jax(j))
    assert t.route() == "sharded"
    for _ in range(2):
        j.iterate()
        t.iterate()
    for k in ("user_bias", "item_bias", "item_factors", "y") + (
            ("p",) if t.USE_P else ()):
        want = np.asarray(j.params[k])[:t.params[k].shape[0]]
        np.testing.assert_allclose(t.params[k].numpy(), want, atol=TOL,
                                   err_msg=k)
    users = np.arange(U, dtype=np.int32)
    np.testing.assert_allclose(t.predict_batch(users, users % I),
                               j.predict_batch(users, users % I), atol=1e-4)


@pytest.mark.parametrize("name", ["SigmoidUserAsymmetricFactorModel",
                                  "SigmoidCombinedAsymmetricFactorModel"])
def test_inner_models_train_on_the_mesh(data, name):
    """The user and combined AFMs' inner models inherit the mesh
    (``_copy_hyperparameters``), so they take the sharded route."""
    _, tr = ratings_pair(data)
    t = create_rating_predictor(name, "num_factors=4 num_iter=1 "
                                "group_users=16 device=cpu")
    mesh = make_mesh(devices=["cpu"] * 2)
    t.mesh = mesh
    t.ratings = tr
    t.train()
    inners = [t._inner] if hasattr(t, "_inner") else [t._item_afm,
                                                      t._user_afm._inner]
    for inner in inners:
        assert inner.mesh is mesh and inner.route() == "sharded"
    assert np.isfinite(t.predict_batch(np.arange(10), np.arange(10))).all()


def test_gsvdpp_stays_on_one_device(data, caplog):
    from mymedialite_tpu_torch.data.arrays import InteractionData
    _, tr = ratings_pair(data)
    t = create_rating_predictor("GSVDPlusPlus",
                                "num_factors=4 num_iter=1 device=cpu")
    rng = np.random.default_rng(2)
    t.item_attributes = InteractionData(np.arange(I, dtype=np.int32),
                                        rng.integers(0, 5, I).astype(np.int32))
    t.mesh = make_mesh(devices=["cpu"] * 2)
    t.ratings = tr
    with caplog.at_level(logging.WARNING, logger="mymedialite_tpu_torch"):
        t.train()
    assert t.route() == "grouped"
    assert any("no sharded form" in r.message and "GSVDPlusPlus" in r.message
               for r in caplog.records)


def test_merged_y_step_diverges_where_one_device_does_not():
    """A fault of the JAX package, copied and pinned: the group size
    (``_auto_group_users``) bounds the ratings of one group's y step, but
    on a mesh D groups' y deltas merge in one step, so an item in every
    history takes D times the regularization step. Here lr x y_reg x the
    ratings of one group's users of item 0 is 1.0: one device keeps y
    bounded, the sharded epoch (D = 4) multiplies y_0 by about -3 a step,
    in both packages alike (relative 1e-4 after 6 epochs)."""
    D, G, Ld = 4, 16, 40
    Ud, Id = D * G, 50
    rng = np.random.default_rng(4)
    users = np.repeat(np.arange(Ud, dtype=np.int32), Ld)
    items = np.concatenate([np.concatenate([[0], rng.choice(
        np.arange(1, Id), Ld - 1, replace=False)]) for _ in range(Ud)]
    ).astype(np.int32)
    values = rng.integers(1, 6, users.size).astype(np.float32)
    jd, jm = jops.prepare_groups(JaxRatingData(users, items, values,
                                               num_users=Ud, num_items=Id),
                                 users, items, Ud, Id, G,
                                 pad_groups_multiple=D)
    tg = tops.prepare_groups(users, items, values, users, items, Ud, G,
                             pad_groups_multiple=D)
    q = (0.1 * rng.standard_normal((Id, F))).astype(np.float32)
    tables = dict(user_bias=np.zeros(Ud, np.float32),
                  item_bias=np.zeros(Id, np.float32), item_factors=q,
                  y=np.full((Id, F), 0.1, np.float32),
                  p=np.full((Ud, F), 0.1, np.float32))
    regs = dict(user_reg=np.full(Ud, 0.015, np.float32),
                item_reg=np.full(Id, 0.015, np.float32),
                y_reg=np.full(Id, 0.3125, np.float32))
    hp = dict(global_bias=3.0, learn_rate=0.005, bias_learn_rate=0.7,
              bias_reg=0.33, min_rating=1.0, rating_range=4.0)
    kw = dict(loss=0, sigmoid=False, use_p=True)
    inv = np.array(jd["inv_sqrt_hist"])
    one = {k: torch.from_numpy(t.copy()) for k, t in tables.items()}
    port, jax_t = dict(tables), dict(tables)
    for _ in range(6):
        tops.svdpp_epoch_grouped(one, tg, torch.from_numpy(inv), hp,
                                 {k: torch.from_numpy(r)
                                  for k, r in regs.items()}, **kw)
        port = port_epoch(D, tg, port, regs, hp, inv, **kw)
        jax_t = jax_sharded_epoch(D, jd, jm, jax_t, regs, hp,
                                  update_user=True, update_item=True, **kw)
        jax_t = {k: np.array(v) for k, v in jax_t.items()
                 if k in tables}
    assert float(one["y"].abs().max()) < 1.0
    assert np.abs(port["y"]).max() > 100.0
    np.testing.assert_allclose(port["y"], jax_t["y"],
                               rtol=1e-4, atol=1e-4 * np.abs(port["y"]).max())


def test_mesh_route_warns_past_the_y_step_bound(data, caplog):
    """On a mesh the automatic group size keeps the JAX package's, and
    the model warns that a step then merges D groups' y steps past the
    bound one group is sized to; a small ``group_users`` keeps quiet."""
    _, tr = ratings_pair(data)
    for group, warns in ((0, True), (16, False)):
        t = create_rating_predictor(
            "SVDPlusPlus", f"num_factors=4 num_iter=1 group_users={group} "
            "learn_rate=0.01 device=cpu")
        t.mesh = make_mesh(devices=["cpu"] * 4)
        t.ratings = tr
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="mymedialite_tpu_torch"):
            assert t.route() == "sharded"
        said = [r.message for r in caplog.records
                if "may diverge" in r.message]
        assert bool(said) is warns, said
        if warns:
            assert "merges 4 groups of 128 users" in said[0]
            assert "set group_users to at most 40" in said[0]
