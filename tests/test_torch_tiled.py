"""The big-catalog rating path of the port against the JAX package, on
the CPU: the slab-tiled plan (``ops/plan.py MxuTiledPlan``), the
schedule choice, the tiled SGD epoch (``ops/sgd_epoch.py
sgd_epoch_tiled``, its plain version on CPU tensors) and the MF models
past the resident bound, with their CLI.

The JAX side runs ``sgd_epoch_mxu_tiled`` in interpret mode with float32
operands. Plans and orders are compared array for array (the JAX order
without its pad entries and refetch flags); one tiled epoch agrees to
1e-5 (float32, the same order of operations per chunk); models after 3
epochs to 1e-4. The resident and slab budgets are shrunk in both
packages, as tests/test_pallas_sgd_tiled.py does, so that a 3,000-item
catalog takes the tiled schedule.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mymedialite_tpu.data.synthetic import split_ratings, synthetic_ratings
from mymedialite_tpu.models import mf as jmf
from mymedialite_tpu.ops import kernel_select
from mymedialite_tpu.ops import pallas_sgd as ps
from mymedialite_tpu.ops import sgd as jsgd
from mymedialite_tpu.utils.params import configure
from mymedialite_tpu_torch.cli import rating_prediction as port_cli
from mymedialite_tpu_torch.convert import tables_from_jax
from mymedialite_tpu_torch.models.registry import create_rating_predictor
from mymedialite_tpu_torch.ops import plan as tplan
from mymedialite_tpu_torch.ops.sgd_epoch import (
    sgd_epoch, sgd_epoch_tiled, sgd_epoch_tiled_reference,
)
from test_torch_cli import aligned, assert_same_output, run_both  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def _toy(seed=0, U=50, I=60, n=700):
    """tests/test_pallas_sgd_tiled.py's toy ratings and tables."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, U, n).astype(np.int32)
    items = rng.integers(0, I, n).astype(np.int32)
    values = rng.uniform(1, 5, n).astype(np.float32)
    W0 = 0.1 * rng.standard_normal((U, 6)).astype(np.float32)
    H0 = 0.1 * rng.standard_normal((I, 6)).astype(np.float32)
    bu = 0.01 * rng.standard_normal(U).astype(np.float32)
    bi = 0.01 * rng.standard_normal(I).astype(np.float32)
    return users, items, values, W0, H0, bu, bi


def _plans(chunk, slab_blocks, pass_len=8192, seed=3):
    users, items, values, *_ = _toy(seed)
    kw = dict(user_block=16, item_block=16, chunk=chunk,
              slab_blocks=slab_blocks, shuffle_seed=2)
    return (ps.prepare_mxu_tiled(users, items, values, 50, 60,
                                 pass_len=pass_len, **kw),
            tplan.prepare_mxu_tiled(users, items, values, 50, 60, **kw))


def shrink_budgets(mp):
    """A 3,000-item catalog passes the resident bound; one-block slabs
    fit the slab budget. In both packages."""
    mp.setattr(ps, "VMEM_ITEM_TABLE_BYTES", 512 * 1024)
    mp.setattr(ps, "TILED_SLAB_BYTES", 256 * 1024)
    mp.setattr(tplan, "RESIDENT_ITEM_TABLE_BYTES", 512 * 1024)
    mp.setattr(tplan, "TILED_SLAB_BYTES", 256 * 1024)


@pytest.mark.parametrize("chunk", [None, 8], ids=["chunk-auto", "chunk-8"])
@pytest.mark.parametrize("slab_blocks", [1, 2])
def test_tiled_plan_identical(chunk, slab_blocks):
    jp, tp_ = _plans(chunk, slab_blocks)
    np.testing.assert_array_equal(tp_.packed.numpy(),
                                  np.asarray(jp.packed)[:-1])
    assert not np.asarray(jp.packed)[-1].any()      # JAX's pad chunk
    for name in ("ub_c", "ib_c", "new_of_old", "old_of_new"):
        np.testing.assert_array_equal(getattr(tp_, name), getattr(jp, name))
    for name in ("num_slabs", "chunk", "user_block", "item_block",
                 "slab_blocks", "n_ublocks", "n_iblocks", "n_ratings"):
        assert getattr(tp_, name) == getattr(jp, name), name
    assert tp_.num_chunks == np.asarray(jp.packed).shape[0] - 1
    assert tp_.num_slabs > 1


@pytest.mark.parametrize("chunk", [None, 8], ids=["chunk-auto", "chunk-8"])
@pytest.mark.parametrize("seed", [None, 0, 9])
def test_tiled_order_identical(chunk, seed):
    """The port's order is the JAX order's real entries (the JAX order
    pads to whole passes with the zero chunk)."""
    for pass_len in (16, 8192):
        jp, tp_ = _plans(chunk, 1, pass_len=pass_len)
        nc = tp_.num_chunks
        jorder = [np.asarray(a).reshape(-1) for a in jp.epoch_order(seed)]
        torder = tp_.epoch_order(seed)
        assert len(torder) == 4
        for got, want in zip(torder, jorder[:4]):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want[:nc])
        assert (jorder[3][nc:] == nc).all()
        assert sorted(torder[3].tolist()) == list(range(nc))


def test_one_slab_order_is_the_resident_order():
    users, items, values, *_ = _toy(4)
    kw = dict(user_block=16, item_block=16, chunk=8, shuffle_seed=0)
    res = tplan.prepare_mxu_data(users, items, values, 50, 60, **kw)
    til = tplan.prepare_mxu_tiled(users, items, values, 50, 60,
                                  slab_blocks=8, **kw)
    assert til.num_slabs == 1
    ub, ib, row = res.epoch_order(5)
    tub, ibr, sl, trow = til.epoch_order(5)
    assert torch.equal(ub, tub) and torch.equal(row, trow)
    assert torch.equal(ib, sl * til.slab_blocks + ibr)


@pytest.mark.parametrize("pass_len", [16, 4096])
def test_tiled_epoch_matches_jax(pass_len):
    """The tiled epoch (plain version on the CPU) against the JAX tiled
    Pallas epoch in interpret mode on a multi-slab toy."""
    users, items, values, W0, H0, bu, bi = _toy(seed=3)
    jp, tp_ = _plans(8, 1, pass_len=pass_len)
    assert jp.num_slabs == jp.n_iblocks > 1
    base = ps.prepare_mxu_data(users, items, values, 50, 60, user_block=16,
                               item_block=16, chunk=8, shuffle_seed=2)
    We, He = ps.extend_tables_mxu(base, W0, H0, bu, bi, fe_pad=8)
    He = jnp.concatenate([He, jnp.zeros(
        (jp.i_pad - He.shape[0], He.shape[1]), jnp.float32)]) \
        if jp.i_pad > He.shape[0] else He
    fe = We.shape[1]
    jrates = ps.mxu_column_rates(6, fe, 0.01, 0.1, 0.08, 0.7, 0.33,
                                 True, True, True)
    hp = np.zeros((1, 8), np.float32)
    hp[0, :3] = [3.0, 1.0, 4.0]
    Wj, Hj = ps.sgd_epoch_mxu_tiled(
        jnp.array(We), jnp.array(He), jp.packed, jp.epoch_order(9),
        jnp.asarray(hp), jrates, meta=jp.meta(fe), num_slabs=jp.num_slabs,
        loss=jsgd.LOSS_RMSE, biased=True, mxu_dtype="f32", interpret=True)

    Wt, Ht = tplan.extend_tables_mxu(tp_, W0, H0, bu, bi, fe_pad=8)
    rates = tplan.mxu_column_rates(6, fe, 0.01, 0.1, 0.08, 0.7, 0.33,
                                   True, True, True)
    before = sgd_epoch_tiled.launches
    sgd_epoch_tiled(Wt, Ht, tp_.packed, tp_.epoch_order(9), (3.0, 1.0, 4.0),
                    rates, slab_blocks=tp_.slab_blocks,
                    user_block=tp_.user_block, item_block=tp_.item_block,
                    loss=jsgd.LOSS_RMSE, biased=True)
    assert sgd_epoch_tiled.launches == before      # CPU: the plain version
    assert np.abs(Wt.numpy() - np.asarray(Wj)).max() < 1e-5
    assert np.abs(Ht.numpy() - np.asarray(Hj)[:tp_.i_pad]).max() < 1e-5
    assert np.abs(Ht.numpy() - np.asarray(He)[:tp_.i_pad]).max() > 1e-4


def test_tiled_reference_is_the_resident_reference_reordered():
    users, items, values, W0, H0, bu, bi = _toy(seed=6)
    _, tp_ = _plans(8, 2)
    W, H = tplan.extend_tables_mxu(tp_, W0, H0, bu, bi, fe_pad=8)
    rates = tplan.mxu_column_rates(6, 8, 0.02, 0.1, 0.1, 1.0, 0.1,
                                   True, True, True)
    order = tp_.epoch_order(2)
    kw = dict(user_block=16, item_block=16, loss=jsgd.LOSS_MAE, biased=True)
    Wa, Ha = sgd_epoch_tiled_reference(W.clone(), H.clone(), tp_.packed,
                                       order, (3.0, 1.0, 4.0), rates,
                                       slab_blocks=2, **kw)
    ub, ibr, sl, row = order
    Wb, Hb = sgd_epoch(W.clone(), H.clone(), tp_.packed,
                       (ub, sl * 2 + ibr, row), (3.0, 1.0, 4.0), rates, **kw)
    assert torch.equal(Wa, Wb) and torch.equal(Ha, Hb)


SHAPES = [(1000, 10), (17_770, 40), (40_960, 40), (41_000, 40),
          (62_423, 40), (100_000, 100), (300_000, 200), (2_200_000, 40)]


@pytest.mark.parametrize("items,f", SHAPES)
def test_bounds_and_schedule_match_jax(items, f, monkeypatch):
    assert tplan.mxu_supported(items, f) == ps.mxu_supported(items, f)
    assert tplan.default_slab_blocks(f) == ps.default_slab_blocks(f)
    assert tplan.mxu_tiled_supported(items, f) == \
        ps.mxu_tiled_supported(items, f)
    monkeypatch.setenv("MML_MXU", "interpret")
    mode = kernel_select.select_mxu_mode(items, f, allow_sharded=False)
    want = {"interpret": "resident", "tiled-interpret": "tiled",
            "": "minibatch"}[mode]
    assert tplan.select_schedule(items, f) == want


def test_one_bound_decides_both_families(monkeypatch):
    from mymedialite_tpu_torch.ops import bpr_plan
    assert bpr_plan.mxu_supported is tplan.mxu_supported
    assert bpr_plan.mxu_supported(3000, 8)
    shrink_budgets(monkeypatch)
    assert not bpr_plan.mxu_supported(3000, 8)
    assert tplan.select_schedule(3000, 8) == "tiled"


@pytest.fixture(scope="module", params=[
    ("BiasedMatrixFactorization", "num_factors=4 num_iter=3"),
    ("BiasedMatrixFactorization", "num_factors=4 num_iter=3 loss=MAE "
                                  "learn_rate=0.05 bold_driver=true"),
    ("MatrixFactorization", "num_factors=4 num_iter=3 regularization=0.05")],
    ids=["biased", "biased-mae-bold", "plain"])
def tiled_pair(request):
    """A JAX model and a port model on a 3,000-item catalog past the
    (shrunk) resident bound, trained 3 epochs from the same tables."""
    name, opts = request.param
    data = synthetic_ratings(num_ratings=4000, num_users=80, num_items=3000,
                             seed=33)
    train, test = split_ratings(data, seed=34)
    jm = getattr(jmf, name)()
    configure(jm, opts + " mxu_dtype=f32")
    tm = create_rating_predictor(name, opts + " device=cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MML_MXU", "interpret")
        shrink_budgets(mp)
        jm.ratings = tm.ratings = train
        jm.init_model()
        tm.init_model(tables=tables_from_jax(jm))
        launches = sgd_epoch_tiled.launches
        for _ in range(3):
            jm.iterate()
            tm.iterate()
        assert sgd_epoch_tiled.launches == launches   # CPU tensors
    return jm, tm, train, test


def test_models_take_the_tiled_path(tiled_pair):
    jm, tm, _, _ = tiled_pair
    assert isinstance(jm._mxu_plan, ps.MxuTiledPlan)
    assert isinstance(tm._plan, tplan.MxuTiledPlan)
    assert tm._plan.num_slabs == jm._mxu_plan.num_slabs >= 2
    assert tm._plan.chunk == jm._mxu_plan.chunk


def test_tiled_models_match_after_three_epochs(tiled_pair):
    jm, tm, train, test = tiled_pair
    np.testing.assert_allclose(tm.W_ext.numpy(), np.asarray(jm.W_ext),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.H_ext.numpy(), np.asarray(jm.H_ext),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.predict_batch(test.users, test.items),
                               jm.predict_batch(test.users, test.items),
                               rtol=0, atol=1e-4)
    assert tm.current_learnrate == pytest.approx(jm.current_learnrate)


@pytest.fixture(scope="module")
def big_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiledcli")
    data = synthetic_ratings(num_users=80, num_items=5000, num_ratings=8000,
                             seed=35)
    train, test = split_ratings(data, seed=36)
    paths = {}
    for name, part in (("train", train), ("test", test)):
        paths[name] = str(d / f"{name}.tsv")
        with open(paths[name], "w") as f:
            for u, i, v in zip(part.users, part.items, part.values):
                f.write(f"{u + 100}\t{i + 7}\t{v:g}\n")
    return paths


def test_tiled_cli_matches_jax(big_files, aligned, capsys,  # noqa: F811
                               monkeypatch):
    """Both CLIs on the same files, whose 2,479 training items pass the
    (shrunk) resident bound: the same result lines."""
    shrink_budgets(monkeypatch)
    seen = []
    real = tplan.prepare_mxu_tiled

    def spy(*a, **kw):
        seen.append(kw["item_block"])
        return real(*a, **kw)

    monkeypatch.setattr(tplan, "prepare_mxu_tiled", spy)
    jax_out, port_out = run_both(
        ["--training-file", big_files["train"], "--test-file",
         big_files["test"], "--compute-fit"], capsys,
        opts="num_factors=4 num_iter=3")
    assert seen, "the port's CLI did not take the tiled schedule"
    assert_same_output(port_out, jax_out)
