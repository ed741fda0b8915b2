"""The port's BPR epoch (``ops/bpr_epoch.py``: the plain sampler and the
plain epoch that CPU tensors run) against the JAX package's Pallas epoch
in interpret mode with float32 operands, over the five (soft_margin,
wbpr, bitmask) cases of tests/test_pallas_bpr.py, on the same plan,
order, negative plan and random bits.

The sampled negatives are identical bit for bit (the plain sampler
against ``sample_negatives_from_bits`` and against the JAX kernel's
``neg_dbg``); the tables agree to 1e-5 after one epoch; the item-bias
column moves."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mymedialite_tpu.data.synthetic import synthetic_posonly
from mymedialite_tpu.ops import pallas_bpr as pb
from mymedialite_tpu_torch.ops import bpr_plan as tp
from mymedialite_tpu_torch.ops.bpr_epoch import (
    bpr_epoch, bpr_epoch_reference, sample_negatives_reference,
)
from test_torch_bpr_plan import small_feedback
from torch_threads import one_torch_thread  # noqa: F401

VARIANTS = [(False, False, False), (True, False, False), (False, True, False),
            (False, False, True), (False, True, True)]
IDS = ["bpr-keys", "hinge-keys", "wbpr-keys", "bpr-bitmask", "wbpr-bitmask"]
F, FE = 6, 8


def _inputs(fb, wbpr, plan_kw, seed=0):
    """Both packages' plans, tables, order, negative plan and bits."""
    jplan, js, meta = pb.prepare_bpr_mxu(fb, uniform_user=True, bitmask=True,
                                         **plan_kw)
    tplan, ts, _ = tp.prepare_bpr_mxu(fb, uniform_user=True, bitmask=True,
                                      **plan_kw)
    n_ib, Kcap, trials, I, IB = meta
    rng = np.random.default_rng(seed)
    W = 0.1 * rng.standard_normal((fb.num_users, F)).astype(np.float32)
    H = 0.1 * rng.standard_normal((fb.num_items, F)).astype(np.float32)
    bias = 0.01 * rng.standard_normal(fb.num_items).astype(np.float32)
    nof = torch.from_numpy(tplan.new_of_old.astype(np.int64))
    We, He = tp.bpr_tables_to_mxu(torch.from_numpy(W), torch.from_numpy(H),
                                  torch.from_numpy(bias), nof,
                                  u_pad=tplan.u_pad, i_pad=tplan.i_pad, fe=FE)
    order = tplan.epoch_order(11)
    jorder = jplan.epoch_order(11)
    jb, nval, bkt = tp.epoch_negative_plan(
        tplan, ts["nvalid"], order[0].numpy(), I, 17,
        block_mass=ts["block_mass"] if wbpr else None)
    bits = pb.epoch_random_bits(jax.random.PRNGKey(5), nc=tplan.num_chunks,
                                trials=trials, C=tplan.chunk)
    return dict(jplan=jplan, js=js, meta=meta, tplan=tplan, ts=ts, We=We,
                He=He, order=order, jorder=jorder, jb=jb, nval=nval, bkt=bkt,
                bits=bits, tbits=torch.from_numpy(np.array(bits)))


def _jax_tables(x):
    """Copies of the port's start tables for the JAX epoch: jnp.asarray
    may alias a tensor's memory on the CPU, the JAX epoch donates its
    tables and runs asynchronously, and the port's epoch then updates the
    same tensors in place."""
    return tuple(jnp.array(x[k].numpy(), copy=True) for k in ("We", "He"))


@pytest.fixture(scope="module")
def feedback():
    return small_feedback()


def _rates(update_j=True):
    return tp.bpr_mxu_column_rates(F, FE, 0.05, 0.0025, 0.0025, 0.00025,
                                   0.01, update_j)


@pytest.mark.parametrize("soft_margin,wbpr,bitmask", VARIANTS, ids=IDS)
def test_sampler_bit_exact(feedback, soft_margin, wbpr, bitmask):
    x = _inputs(feedback, wbpr, dict(user_block=8, item_block=8, chunk=8,
                                     shuffle_seed=3))
    IB = x["meta"][4]
    u_loc = x["tplan"].packed[x["order"][2].long()][:, 0]
    j_loc, ok = pb.sample_negatives_from_bits(
        x["js"]["keys_tbl"], x["bits"], jnp.asarray(x["jb"].numpy()),
        jnp.asarray(x["nval"].numpy()), jnp.asarray(x["bkt"].numpy()),
        jnp.asarray(u_loc.numpy()), meta=x["meta"], wbpr=wbpr,
        cdf_tbl=x["js"]["cdf_tbl"])
    tj, tok = sample_negatives_reference(
        x["tbits"], x["jb"], x["nval"], x["bkt"], u_loc, item_block=IB,
        keys_tbl=None if bitmask else x["ts"]["keys_tbl"],
        bitmask_tbl=x["ts"]["bitmask_tbl"] if bitmask else None,
        cdf_tbl=x["ts"]["cdf_tbl"], wbpr=wbpr)
    assert tj.dtype == torch.int32
    np.testing.assert_array_equal(tj.numpy(), np.asarray(j_loc))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ok))
    # some trials hit positives, so the rejection path is exercised
    assert tok.float().mean() > 0.9


@pytest.mark.parametrize("soft_margin,wbpr,bitmask", VARIANTS, ids=IDS)
def test_epoch_matches_jax_interpret(feedback, soft_margin, wbpr, bitmask):
    x = _inputs(feedback, wbpr, dict(user_block=8, item_block=8, chunk=8,
                                     shuffle_seed=3))
    n_ib, Kcap, trials, _, IB = x["meta"]
    rates = _rates()
    He0 = x["He"].clone()
    jW, jH, jneg = pb.bpr_epoch_mxu(
        *_jax_tables(x),
        x["jplan"].packed, x["js"]["keys_tbl"], x["js"]["cdf_tbl"], x["bits"],
        x["jorder"], jnp.asarray(x["jb"].numpy()),
        jnp.asarray(x["nval"].numpy()), jnp.asarray(x["bkt"].numpy()),
        jnp.asarray(rates.numpy()),
        meta=x["jplan"].meta(FE) + (Kcap, trials), soft_margin=soft_margin,
        wbpr=wbpr, mxu_dtype="f32", interpret=True,
        bm_tbl=x["js"]["bitmask_tbl"] if bitmask else None)
    W, H, neg = bpr_epoch(
        x["We"], x["He"], x["tplan"].packed, x["ts"]["keys_tbl"],
        x["ts"]["cdf_tbl"], x["tbits"], x["order"], x["jb"], x["nval"],
        x["bkt"], rates, user_block=8, item_block=8, soft_margin=soft_margin,
        wbpr=wbpr, bitmask_tbl=x["ts"]["bitmask_tbl"] if bitmask else None,
        return_negatives=True)
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
    assert np.abs(W.numpy() - np.asarray(jW)).max() <= 1e-5
    assert np.abs(H.numpy() - np.asarray(jH)).max() <= 1e-5
    # the item-bias column (column F) moves
    assert (H[:, F] - He0[:, F]).abs().max() > 0


def test_epoch_at_model_blocks_matches_jax():
    """The models' block sizes (UB 512, IB 1024, C 640) on 1,200 users x
    1,500 items: three user blocks, two item blocks, negatives drawn in
    the other block too."""
    fb = synthetic_posonly(num_users=1200, num_items=1500, num_events=6000,
                           seed=5)
    x = _inputs(fb, False, dict(shuffle_seed=42), seed=1)
    n_ib, Kcap, trials, _, IB = x["meta"]
    assert x["tplan"].n_ublocks == 3 and n_ib == 2
    assert (x["jb"] != x["order"][1]).any()
    rates = _rates()
    jW, jH, jneg = pb.bpr_epoch_mxu(
        *_jax_tables(x),
        x["jplan"].packed, x["js"]["keys_tbl"], x["js"]["cdf_tbl"], x["bits"],
        x["jorder"], jnp.asarray(x["jb"].numpy()),
        jnp.asarray(x["nval"].numpy()), jnp.asarray(x["bkt"].numpy()),
        jnp.asarray(rates.numpy()),
        meta=x["jplan"].meta(FE) + (Kcap, trials), mxu_dtype="f32",
        interpret=True, bm_tbl=x["js"]["bitmask_tbl"])
    W, H, neg = bpr_epoch(
        x["We"], x["He"], x["tplan"].packed, x["ts"]["keys_tbl"],
        x["ts"]["cdf_tbl"], x["tbits"], x["order"], x["jb"], x["nval"],
        x["bkt"], rates, user_block=512, item_block=1024,
        bitmask_tbl=x["ts"]["bitmask_tbl"], return_negatives=True)
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
    assert np.abs(W.numpy() - np.asarray(jW)).max() <= 1e-5
    assert np.abs(H.numpy() - np.asarray(jH)).max() <= 1e-5


def test_epoch_without_update_j_matches_jax(feedback):
    """update_j off: the negative rows' rates are zero in both packages."""
    x = _inputs(feedback, False, dict(user_block=8, item_block=8, chunk=8,
                                      shuffle_seed=3))
    n_ib, Kcap, trials, _, IB = x["meta"]
    rates = _rates(update_j=False)
    jW, jH, _ = pb.bpr_epoch_mxu(
        *_jax_tables(x),
        x["jplan"].packed, x["js"]["keys_tbl"], x["js"]["cdf_tbl"], x["bits"],
        x["jorder"], jnp.asarray(x["jb"].numpy()),
        jnp.asarray(x["nval"].numpy()), jnp.asarray(x["bkt"].numpy()),
        jnp.asarray(rates.numpy()),
        meta=x["jplan"].meta(FE) + (Kcap, trials), mxu_dtype="f32",
        interpret=True)
    W, H, neg = bpr_epoch_reference(
        x["We"], x["He"], x["tplan"].packed, x["ts"]["keys_tbl"], None,
        x["tbits"], x["order"], x["jb"], x["nval"], x["bkt"], rates,
        user_block=8, item_block=8)
    assert neg is None
    assert np.abs(W.numpy() - np.asarray(jW)).max() <= 1e-5
    assert np.abs(H.numpy() - np.asarray(jH)).max() <= 1e-5


def test_rejects_bad_input(feedback):
    x = _inputs(feedback, False, dict(user_block=8, item_block=8, chunk=8,
                                      shuffle_seed=3))
    args = [x["We"], x["He"], x["tplan"].packed, x["ts"]["keys_tbl"],
            x["ts"]["cdf_tbl"], x["tbits"], x["order"], x["jb"], x["nval"],
            x["bkt"], _rates()]
    kw = dict(user_block=8, item_block=8)
    bad = list(args)
    bad[0] = x["We"].double()
    with pytest.raises(TypeError):
        bpr_epoch(*bad, **kw)
    bad = list(args)
    bad[5] = x["tbits"][:, :, :4]
    with pytest.raises(ValueError, match="bits"):
        bpr_epoch(*bad, **kw)
    bad = list(args)
    bad[10] = _rates()[:, :4].contiguous()
    with pytest.raises(ValueError, match="rates"):
        bpr_epoch(*bad, **kw)
    bad = list(args)
    bad[3] = None
    with pytest.raises(ValueError, match="keys_tbl"):
        bpr_epoch(*bad, **kw)
