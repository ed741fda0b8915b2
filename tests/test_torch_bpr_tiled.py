"""The big-catalog item path of the port against the JAX package, on the
CPU: the tiled BPR plan (capped keys, sub-bucketed keys with the
corruption-bounded cap), the tiled epoch order and negative plan
(``ops/bpr_plan.py``), the subkeys sampler and the tiled BPR epoch
(``ops/bpr_epoch.py bpr_epoch_tiled``, its plain version on CPU
tensors), and the BPR models past the resident bound, with their CLI.

The JAX side runs ``bpr_epoch_mxu_tiled`` in interpret mode with float32
operands. Tables and order arrays are identical (the JAX order without
its pad entries and refetch flags); sampled negatives are identical bit
for bit; one tiled epoch agrees to 1e-5; models after 3 epochs to 1e-4,
the port starting from the JAX tables and taking the JAX random bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mymedialite_tpu.data import PosOnlyData
from mymedialite_tpu.data.synthetic import split_posonly, synthetic_posonly
from mymedialite_tpu.models import bpr as jbpr
from mymedialite_tpu.ops import pallas_bpr as pb
from mymedialite_tpu.ops import pallas_sgd as ps
from mymedialite_tpu.utils.params import configure
from mymedialite_tpu_torch.cli import item_recommendation as port_cli
from mymedialite_tpu_torch.convert import bpr_tables_from_jax
from mymedialite_tpu_torch.models.registry import create_item_recommender
from mymedialite_tpu_torch.ops import bpr_plan as tp
from mymedialite_tpu_torch.ops import plan as tplan
from mymedialite_tpu_torch.ops.bpr_epoch import (
    bpr_epoch_tiled, sample_negatives_reference,
)
from test_torch_bpr_plan import small_feedback
from test_torch_item_cli import aligned, assert_same_output, run_both  # noqa: F401
from test_torch_tiled import shrink_budgets
from torch_threads import one_torch_thread  # noqa: F401

TOY = dict(user_block=8, item_block=8, chunk=8, shuffle_seed=3,
           num_neg_trials=8)


def dense_feedback():
    """300 users x 200 items with 100 events each: the sub-buckets of
    its one item block hold thousands of keys."""
    rng = np.random.default_rng(4)
    users = np.repeat(np.arange(300), 100)
    items = np.concatenate([rng.choice(200, 100, replace=False)
                            for _ in range(300)])
    return PosOnlyData(users, items, num_users=300, num_items=200)


# (feedback, plan keyword arguments)
CASES = {
    "toy": (small_feedback, dict(TOY, bitmask=True)),
    "model-tiled": (lambda: synthetic_posonly(
        num_users=1200, num_items=3000, num_events=20000, seed=5),
        dict(shuffle_seed=42, chunk=None, kcap=128, ksub_cap=256,
             bitmask=False, chunk_overhead=256)),
    "cap-raised": (dense_feedback, dict(
        shuffle_seed=1, chunk=None, kcap=128, ksub_cap=128, bitmask=False,
        chunk_overhead=256)),
}


@pytest.fixture(scope="module", params=list(CASES))
def both(request):
    make, kw = CASES[request.param]
    fb = make()
    jax_out = pb.prepare_bpr_mxu(fb, uniform_user=True, subkeys=True, **kw)
    port_out = tp.prepare_bpr_mxu(fb, uniform_user=True, subkeys=True, **kw)
    return request.param, fb, jax_out, port_out


def test_capped_plan_and_subkeys_identical(both):
    case, _, (jplan, js, jmeta), (tplan_, ts, tmeta) = both
    assert tmeta == jmeta
    np.testing.assert_array_equal(tplan_.packed.numpy(),
                                  np.asarray(jplan.packed))
    assert tplan_.chunk == jplan.chunk
    for name in ("keys_tbl", "subkeys_tbl", "cdf_tbl"):
        np.testing.assert_array_equal(ts[name].numpy(), np.asarray(js[name]))
    for name in ("ksub", "key_truncation", "key_corruption",
                 "subkey_truncation", "subkey_corruption"):
        assert ts[name] == js[name], name
    assert ts["subkeys_tbl"].shape[0] == tplan_.n_ublocks \
        * tplan_.n_iblocks * tp.SUBKEY_BUCKETS
    if case == "cap-raised":
        # the cap was doubled until the corrupted-triple rate held
        assert 128 < ts["ksub"] and ts["key_truncation"] > 0
        assert ts["subkey_corruption"] <= 1e-3 < ts["key_corruption"]


def test_subkey_rows_ascending_and_padded(both):
    _, _, _, (_, ts, _) = both
    tbl = ts["subkeys_tbl"].numpy()
    for row in tbl:
        real = row[row >= 0]
        assert (row[:real.size] == real).all()     # -1 only at the end
        assert (np.diff(real) > 0).all()


def _tiled_inputs(case_out, fb, seed, wbpr, slab_blocks=1, pass_len=8192):
    jplan, js, jmeta = case_out[0]
    tplan_, ts, _ = case_out[1]
    packed_ext, S, n_pass, P, slab_items = pb.bpr_tiled_plan(
        jplan, js["nvalid"], slab_blocks=slab_blocks, pass_len=pass_len)
    B, tS, tslab_items = tp.bpr_tiled_plan(tplan_, ts["nvalid"],
                                           slab_blocks=slab_blocks)
    assert (tS, B) == (S, min(slab_blocks, jplan.n_iblocks))
    np.testing.assert_array_equal(tslab_items, slab_items)
    jorder = pb.bpr_tiled_epoch_order(
        jplan, js["nvalid"], slab_items, slab_blocks=slab_blocks,
        num_slabs=S, num_passes=n_pass, pass_len=P, num_items=fb.num_items,
        seed=seed, block_mass=js["block_mass"] if wbpr else None)
    torder = tp.bpr_tiled_epoch_order(
        tplan_, ts["nvalid"], tslab_items, slab_blocks=slab_blocks,
        num_slabs=tS, num_items=fb.num_items, seed=seed,
        block_mass=ts["block_mass"] if wbpr else None)
    return dict(packed_ext=packed_ext, S=S, n_pass=n_pass, P=P, jorder=jorder,
                torder=torder, jplan=jplan, js=js, jmeta=jmeta,
                tplan=tplan_, ts=ts)


@pytest.mark.parametrize("wbpr", [False, True], ids=["uniform", "wbpr"])
@pytest.mark.parametrize("pass_len", [16, 8192])
def test_tiled_order_identical(both, wbpr, pass_len):
    _, fb, jax_out, port_out = both
    for seed in (0, 21, 1_000_004):
        for sb in (1, 2):
            x = _tiled_inputs((jax_out, port_out), fb, seed, wbpr,
                              slab_blocks=sb, pass_len=pass_len)
            nc = x["tplan"].num_chunks
            assert len(x["torder"]) == 9
            for got, want in zip(x["torder"], x["jorder"][:9]):
                assert got.dtype == torch.int32 and got.numel() == nc
                np.testing.assert_array_equal(
                    got.numpy(), np.asarray(want).reshape(-1)[:nc])
            assert (np.asarray(x["jorder"][8]).reshape(-1)[nc:] == nc).all()


@pytest.mark.parametrize("wbpr", [False, True], ids=["uniform", "wbpr"])
def test_subkeys_negatives_identical(both, wbpr):
    """The plain sampler with subkeys against sample_negatives_from_bits
    (subkeys=True) over a whole tiled epoch."""
    _, fb, jax_out, port_out = both
    x = _tiled_inputs((jax_out, port_out), fb, 21, wbpr)
    ub, ibr, isl, jb, jbr, jsl, nval, bkt, row = x["torder"]
    nc, C = x["tplan"].num_chunks, x["tplan"].chunk
    trials = x["jmeta"][2]
    bits = pb.epoch_random_bits(jax.random.PRNGKey(9), nc=nc, trials=trials,
                                C=C)
    u_loc = x["tplan"].packed[row.long()][:, 0, :]
    jj, jok = pb.sample_negatives_from_bits(
        x["js"]["subkeys_tbl"], bits, jnp.asarray(jb.numpy()),
        jnp.asarray(nval.numpy()), jnp.asarray(bkt.numpy()),
        jnp.asarray(u_loc.numpy()), meta=x["jmeta"], wbpr=wbpr,
        cdf_tbl=x["js"]["cdf_tbl"], subkeys=True)
    tj, tok = sample_negatives_reference(
        torch.from_numpy(np.array(bits)), jb, nval, bkt, u_loc,
        item_block=x["tplan"].item_block, keys_tbl=x["ts"]["subkeys_tbl"],
        cdf_tbl=x["ts"]["cdf_tbl"], wbpr=wbpr, subkeys=True)
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.float().mean() > 0.5


# tests/test_pallas_bpr.py's tiled variants with sub-bucketed keys
VARIANTS = [(False, False, 16), (True, False, 16), (False, True, 16),
            (False, False, 4096)]


@pytest.mark.parametrize("soft_margin,wbpr,pass_len", VARIANTS,
                         ids=["bpr", "hinge", "wbpr", "bpr-one-pass"])
def test_tiled_epoch_matches_jax(soft_margin, wbpr, pass_len):
    fb = small_feedback()
    jax_out = pb.prepare_bpr_mxu(fb, uniform_user=True, bitmask=True,
                                 subkeys=True, **TOY)
    port_out = tp.prepare_bpr_mxu(fb, uniform_user=True, bitmask=True,
                                  subkeys=True, **TOY)
    x = _tiled_inputs((jax_out, port_out), fb, 21, wbpr, pass_len=pass_len)
    jplan, js, tplan_, ts = x["jplan"], x["js"], x["tplan"], x["ts"]
    assert x["S"] == jplan.n_iblocks > 1
    n_ib, _, trials, I, IB = x["jmeta"]
    f, fe, nc = 6, 8, tplan_.num_chunks
    rng = np.random.default_rng(0)
    W = 0.1 * rng.standard_normal((fb.num_users, f)).astype(np.float32)
    H = 0.1 * rng.standard_normal((fb.num_items, f)).astype(np.float32)
    bias = 0.01 * rng.standard_normal(fb.num_items).astype(np.float32)
    We, He = pb.bpr_tables_to_mxu(
        jnp.asarray(W), jnp.asarray(H), jnp.asarray(bias),
        jnp.asarray(jplan.new_of_old), u_pad=jplan.u_pad,
        i_pad=x["S"] * IB, fe=fe)
    rates = pb.bpr_mxu_column_rates(f, fe, 0.05, 0.0025, 0.0025, 0.00025,
                                    0.01, True)
    tot = x["n_pass"] * x["P"]
    bits = pb.epoch_random_bits(jax.random.PRNGKey(9), nc=tot, trials=trials,
                                C=jplan.chunk)
    Wj, Hj, neg_j = pb.bpr_epoch_mxu_tiled(
        jnp.array(We), jnp.array(He), x["packed_ext"], js["subkeys_tbl"],
        js["cdf_tbl"], bits.reshape(x["n_pass"], x["P"], trials, jplan.chunk),
        x["jorder"], rates,
        meta=(x["P"], jplan.chunk, jplan.user_block, IB, jplan.n_ublocks,
              IB, fe, js["ksub"], trials),
        num_slabs=x["S"], soft_margin=soft_margin, wbpr=wbpr, subkeys=True,
        mxu_dtype="f32", interpret=True)

    Wt = torch.from_numpy(np.array(We))
    Ht = torch.from_numpy(np.array(He))[:tplan_.i_pad].contiguous()
    before = bpr_epoch_tiled.launches
    _, _, neg_t = bpr_epoch_tiled(
        Wt, Ht, tplan_.packed, ts["subkeys_tbl"], ts["cdf_tbl"],
        torch.from_numpy(np.array(bits))[:nc].contiguous(), x["torder"],
        torch.from_numpy(np.array(rates)), slab_blocks=1,
        user_block=tplan_.user_block, item_block=IB,
        soft_margin=soft_margin, wbpr=wbpr, subkeys=True,
        return_negatives=True)
    assert bpr_epoch_tiled.launches == before       # CPU: the plain version
    np.testing.assert_array_equal(neg_t.numpy(), np.asarray(neg_j)[:nc])
    assert np.abs(Wt.numpy() - np.asarray(Wj)).max() < 1e-5
    assert np.abs(Ht.numpy() - np.asarray(Hj)[:tplan_.i_pad]).max() < 1e-5
    assert np.abs(Ht.numpy() - np.asarray(He)[:tplan_.i_pad]).max() > 1e-4


MODELS = ["BPRMF", "WeightedBPRMF", "SoftMarginRankingMF"]
OPTS = "num_factors=8 num_iter=3"


def jax_tiled_bits(jm):
    """The port's _epoch_bits replaced by the JAX model's tiled bits: JAX
    draws them for the padded schedule and the real chunks take the
    first rows."""
    def bits(seed, nc, trials, C):
        tl = jm._bpr_tiled
        key = jax.random.key(seed & 0x7FFFFFFF, impl="unsafe_rbg")
        tot = tl["num_passes"] * tl["pass_len"]
        return torch.from_numpy(np.array(pb.epoch_random_bits(
            key, nc=tot, trials=trials, C=C))[:nc]).contiguous()
    return bits


@pytest.fixture(scope="module", params=MODELS)
def tiled_pair(request):
    """Both packages' models on a 3,000-item catalog past the (shrunk)
    resident bound, 3 epochs from the same tables and bits."""
    fb = synthetic_posonly(num_users=80, num_items=3000, num_events=6000,
                           seed=41)
    train, test = split_posonly(fb, seed=42)
    jm = getattr(jbpr, request.param)()
    configure(jm, OPTS + " mxu_dtype=f32")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MML_MXU", "interpret")
        shrink_budgets(mp)
        jm.feedback = train
        jm.init_model()
        tm = create_item_recommender(request.param, OPTS + " device=cpu")
        tm.feedback = train
        tm.init_model(tables=bpr_tables_from_jax(jm))
        tm._epoch_bits = jax_tiled_bits(jm)
        launches = bpr_epoch_tiled.launches
        for _ in range(3):
            jm.iterate()
            tm.iterate()
        assert bpr_epoch_tiled.launches == launches   # CPU tensors
    return jm, tm, train, test


def test_models_take_the_tiled_path(tiled_pair):
    jm, tm, _, _ = tiled_pair
    assert jm._bpr_tiled is not None and tm._tiled is not None
    assert tm._tiled["num_slabs"] == jm._bpr_tiled["num_slabs"] >= 2
    assert tm._tiled["slab_blocks"] == min(jm._bpr_tiled["slab_blocks"],
                                           jm._bpr_plan.n_iblocks)
    assert tm._plan.chunk == jm._bpr_plan.chunk
    assert tm._neg_state["ksub"] == jm._bpr_neg_state["ksub"]


def test_tiled_models_match_after_three_epochs(tiled_pair):
    jm, tm, _, _ = tiled_pair
    for k in ("user_factors", "item_factors", "item_bias"):
        got, want = tm.params[k].numpy(), np.asarray(jm.params[k])
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(np.asarray(jm.params["item_bias"])).max() > 1e-3


@pytest.fixture(scope="module")
def big_item_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tileditemcli")
    fb = synthetic_posonly(num_users=80, num_items=5000, num_events=9000,
                           seed=43)
    train, test = split_posonly(fb, seed=44)
    paths = {}
    for name, part in (("train", train), ("test", test)):
        paths[name] = str(d / f"{name}.tsv")
        with open(paths[name], "w") as f:
            for u, i in zip(part.users, part.items):
                f.write(f"{u + 100}\t{i + 7}\n")
    return paths


def test_tiled_item_cli_matches_jax(big_item_files, aligned, capsys,  # noqa: F811
                                    monkeypatch):
    """Both item CLIs with BPRMF on a catalog past the (shrunk) resident
    bound: the same result lines, every number within 1e-3 (as the
    resident path's CLI test)."""
    shrink_budgets(monkeypatch)
    seen = []
    real = tp.bpr_tiled_plan

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(out[1])
        return out

    monkeypatch.setattr(tp, "bpr_tiled_plan", spy)
    jax_out, port_out = run_both(
        ["--training-file", big_item_files["train"], "--test-file",
         big_item_files["test"], "--recommender", "BPRMF"], capsys,
        opts="num_factors=8 num_iter=3")
    assert seen and seen[0] >= 2, "the port's CLI did not take the tiled path"
    assert_same_output(port_out, jax_out, atol=1e-3)


def test_tiled_models_train_from_own_generator():
    """The port's own init and bits on the tiled path: deterministic, and
    it ranks held-out items above chance."""
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, split_posonly as t_split, synthetic_ratings,
    )
    from mymedialite_tpu_torch.eval.ranking import evaluate_items
    fb = posonly_from_ratings(synthetic_ratings(
        num_users=300, num_items=3000, num_ratings=30000, seed=41))
    train, test = t_split(fb, seed=42)
    with pytest.MonkeyPatch.context() as mp:
        shrink_budgets(mp)
        models = []
        for _ in range(2):
            m = create_item_recommender("BPRMF", "num_factors=8 num_iter=10 "
                                        "device=cpu")
            m.feedback = train
            m.train()
            models.append(m)
    a, b = models
    assert a._tiled is not None
    assert torch.equal(a.params["user_factors"], b.params["user_factors"])
    assert evaluate_items(a, test, train)["AUC"] > 0.6
    assert tplan.select_schedule(3000, 8) == "resident"
