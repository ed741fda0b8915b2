"""The minibatch BPR epoch of the port (``mymedialite_tpu_torch/ops/
bpr.py``) and the BPR family's route to it, against the JAX package's
XLA epoch (``mymedialite_tpu/ops/bpr.py``) on the CPU.

The sampler state and the membership search are equal; from the same
candidate draws both packages pick the same negatives. The update step
fed the JAX package's triples (drawn from its keys, batch by batch)
lands within 1e-5 of ``bpr_epoch`` in every regime, with the hinge and
without the j update. The port's own draws follow each regime's
distribution (seeded chi-square tests); without replacement every event
comes once an epoch. Past the tiled schedule's ``MAX_SLABS`` the BPR
models train on this epoch and match the JAX models after 2 epochs from
the same tables and triples.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from mymedialite_tpu.data.arrays import PosOnlyData as JaxPosOnly
from mymedialite_tpu.models import bpr as jbpr
from mymedialite_tpu.ops import bpr as jb
from mymedialite_tpu.utils.params import configure as jax_configure
from mymedialite_tpu_torch.convert import bpr_tables_from_jax
from mymedialite_tpu_torch.data.arrays import PosOnlyData
from mymedialite_tpu_torch.models import bpr as tbpr
from mymedialite_tpu_torch.models.registry import create_item_recommender
from mymedialite_tpu_torch.ops import bpr as tb
from mymedialite_tpu_torch.ops import plan as tplan
from torch_threads import one_torch_thread  # noqa: F401

U, I, F = 80, 60, 6
HP = dict(learn_rate=0.05, reg_u=0.01, reg_i=0.02, reg_j=0.005, bias_reg=0.1)
REGIMES = [tb.UNIFORM_USER, tb.UNIFORM_PAIR, tb.UNIFORM_PAIR_WOR, tb.WBPR]


@pytest.fixture(scope="module")
def feedback():
    rng = np.random.default_rng(0)
    key = np.unique(rng.integers(0, U, 1500) * I
                    + (rng.zipf(1.3, 1500) % I))
    u, i = (key // I).astype(np.int32), (key % I).astype(np.int32)
    return (JaxPosOnly(u, i, num_users=U, num_items=I),
            PosOnlyData(u, i, num_users=U, num_items=I))


def ids(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_sampler_state_and_search(feedback):
    jf, tf = feedback
    js, jm = jb.make_sampler_data(jf, 8)
    ts, tm = tb.make_sampler_data(tf, 8)
    # the port searches sorted keys and needs no search depth
    assert tm == {k: v for k, v in jm.items() if k != "search_depth"}
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), k)
    pos = ts["pos_keys"]
    assert bool((pos[1:] >= pos[:-1]).all())
    np.testing.assert_array_equal(
        pos.numpy(), np.sort(tf.users.astype(np.int64) * I + tf.items))
    np.testing.assert_allclose(tb.popularity_cdf(tf.count_by_item).numpy(),
                               np.asarray(jb.popularity_cdf(jf)), rtol=0,
                               atol=0)
    users = jax.random.randint(jax.random.PRNGKey(2), (8, 500), 0, U,
                               dtype=jnp.int32)
    keys = jax.random.randint(jax.random.PRNGKey(3), (8, 500), 0, I,
                              dtype=jnp.int32)
    want = jax.vmap(lambda u, k: jb._segment_contains(
        js["hist_items"], js["indptr"], u, k, jm["search_depth"]))(users, keys)
    got = tb.segment_contains(ts, ids(users), ids(keys), I)
    assert bool(np.asarray(want).any()) and not bool(np.asarray(want).all())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wbpr", [False, True])
def test_same_negatives_from_the_same_candidates(feedback, wbpr):
    jf, tf = feedback
    js, jm = jb.make_sampler_data(jf, 3)
    ts, tm = tb.make_sampler_data(tf, 3)
    users = jax.random.randint(jax.random.PRNGKey(2), (700,), 0, U,
                               dtype=jnp.int32)
    key = jax.random.PRNGKey(4)
    pop = jb.popularity_cdf(jf) if wbpr else None
    neg, ok = jb._sample_negatives(key, js, users, I, 3, jm["search_depth"],
                                   pop_cdf=pop)
    # the same draws as _sample_negatives, made apart
    if wbpr:
        cand = jnp.minimum(jnp.searchsorted(
            pop, jax.random.uniform(key, (3, 700))), I - 1)
    else:
        cand = jax.random.randint(key, (3, 700), 0, I, dtype=jnp.int32)
    tneg, tok = tb.first_negatives(ts, ids(users), ids(cand), I)
    assert not bool(np.asarray(ok).all())
    np.testing.assert_array_equal(tneg.numpy(), np.asarray(neg))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ok))


def jax_triples(js, jm, key, batch, nb, regime, pop):
    """The JAX epoch's triples, batch by batch (as ``bpr_epoch`` draws
    them from ``key``)."""
    perm = None
    if regime == jb.UNIFORM_PAIR_WOR:
        perm = jax.random.permutation(jax.random.fold_in(key, 0x5eed),
                                      jnp.arange(nb * batch, dtype=jnp.int32))
    sample = _jit_sampler(tuple(sorted(jm.items())), batch, regime)
    for b in range(nb):
        u, i, j, w = sample(jax.random.fold_in(key, b), js, perm=perm,
                            batch_index=b,
                            pop_cdf=pop if regime == jb.WBPR else None)
        yield ids(u), ids(i), ids(j), torch.from_numpy(np.array(w))


@functools.lru_cache(maxsize=None)
def _jit_sampler(meta, batch, regime):
    return jax.jit(functools.partial(jb._sample_triples, meta=dict(meta),
                                     batch_size=batch, regime=regime))


@pytest.mark.parametrize("regime,soft_margin,update_j", [
    (tb.UNIFORM_USER, False, True), (tb.UNIFORM_PAIR, True, True),
    (tb.UNIFORM_PAIR_WOR, False, False), (tb.WBPR, False, True)])
def test_epoch_with_jax_triples(feedback, regime, soft_margin, update_j):
    jf, _ = feedback
    js, jm = jb.make_sampler_data(jf, 8)
    pop = jb.popularity_cdf(jf)
    rng = np.random.default_rng(1)
    tables = dict(user_factors=0.1 * rng.standard_normal((U, F)),
                  item_factors=0.1 * rng.standard_normal((I, F)),
                  item_bias=0.1 * rng.standard_normal(I))
    tables = {k: v.astype(np.float32) for k, v in tables.items()}
    batch, nb = tb.epoch_batches(len(jf), 256)
    key = jax.random.PRNGKey(3)
    want = jb.bpr_epoch(
        {k: jnp.asarray(v) for k, v in tables.items()}, js, key,
        {k: jnp.float32(v) for k, v in HP.items()}, pop, batch_size=batch,
        num_batches=nb, regime=regime, meta_static=tuple(sorted(jm.items())),
        update_j=update_j, soft_margin=soft_margin)
    got = {k: torch.from_numpy(v.copy()) for k, v in tables.items()}
    for u, i, j, w in jax_triples(js, jm, key, batch, nb, regime, pop):
        tb.bpr_step(got, u, i, j, w, HP, update_j=update_j,
                    soft_margin=soft_margin)
    for k in tables:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
        assert not np.array_equal(got[k].numpy(), tables[k])


@pytest.mark.parametrize("regime", REGIMES)
def test_own_draws_follow_the_regime(feedback, regime):
    """200,000 seeded triples of one regime: users (uniform over the valid
    users, or by activity), positives (uniform within the user's items,
    or by event) and negatives (uniform outside I_u, or by popularity)
    against their expected counts; p > 1e-3 for each."""
    _, tf = feedback
    ts, tm = tb.make_sampler_data(tf, 8)
    gen = torch.Generator()
    gen.manual_seed(5)
    n = 200_000
    pop = tb.popularity_cdf(tf.count_by_item)
    perm = torch.randperm(n, generator=gen) % len(tf)
    u, i, j, w = tb.sample_triples(gen, ts, tm, n, regime, perm=perm,
                                   pop_cdf=pop)
    u, i, j, w = u.numpy(), i.numpy(), j.numpy(), w.numpy()
    counts = np.bincount(tf.users, minlength=U)
    ok = w > 0
    pos = set(zip(tf.users.tolist(), tf.items.tolist()))
    assert all((a, b) in pos for a, b in zip(u[:2000], i[:2000]))
    assert not any((a, b) in pos for a, b, o in zip(u[:2000], j[:2000],
                                                    ok[:2000]) if o)
    if regime == tb.UNIFORM_USER:
        expect_u = (counts > 0).astype(float)
    else:
        expect_u = counts.astype(float)
    seen = expect_u > 0
    assert chisquare(np.bincount(u, minlength=U)[seen],
                     expect_u[seen] / expect_u.sum() * n).pvalue > 1e-3
    top = np.argmax(counts)
    sel = u == top
    assert chisquare(np.bincount(i[sel], minlength=I)[
        tf.items_by_user(top)]).pvalue > 1e-3
    # negatives of the busiest user: uniform outside I_u, or popularity
    neg = np.setdiff1d(np.arange(I), tf.items_by_user(top))
    got = np.bincount(j[sel & ok], minlength=I)[neg]
    if regime == tb.WBPR:
        mass = np.asarray(tf.count_by_item, float)[neg]
        keep = mass > 0
        assert got[~keep].sum() == 0
        assert chisquare(got[keep], mass[keep] / mass[keep].sum()
                         * got.sum()).pvalue > 1e-3
    else:
        assert chisquare(got).pvalue > 1e-3


def test_without_replacement_every_event_once(feedback):
    _, tf = feedback
    ts, tm = tb.make_sampler_data(tf, 8)
    gen = torch.Generator()
    gen.manual_seed(6)
    batch, nb = tb.epoch_batches(len(tf), 256)
    perm = torch.randperm(nb * batch, generator=gen)
    seen = []
    for b in range(nb):
        u, i, _, _ = tb.sample_triples(gen, ts, tm, batch,
                                       tb.UNIFORM_PAIR_WOR, perm=perm,
                                       batch_index=b)
        real = perm[b * batch:(b + 1) * batch] < len(tf)
        seen += list(zip(u[real].tolist(), i[real].tolist()))
    assert sorted(seen) == sorted(zip(tf.users.tolist(), tf.items.tolist()))
    assert nb * batch > len(tf)


@pytest.fixture
def shared_runs(monkeypatch):
    """The port's next init_model starts from the JAX model's tables; the
    port's epoch replays the JAX epoch's triples (recorded keys)."""
    tables, runs = [], []
    jax_init, port_init = jbpr.BPRMF.init_model, tbpr.BPRMF.init_model
    jax_epoch = jb.bpr_epoch

    def record(self):
        jax_init(self)
        tables.append(bpr_tables_from_jax(self))

    def replay(self, tables_=None):
        port_init(self, tables.pop(0) if tables_ is None else tables_)

    def epoch(params, sampler, key, hp, pop, **kw):
        runs.append((sampler, dict(kw["meta_static"]), key, pop,
                     kw["batch_size"], kw["num_batches"], kw["regime"]))
        return jax_epoch(params, sampler, key, hp, pop, **kw)

    def port_epoch(params, sampler, meta, generator, hp, pop_cdf=None, *,
                   batch_size, num_batches, regime, update_j, soft_margin):
        js, jm, key, jpop, batch, nb, jregime = runs.pop(0)
        assert (batch, nb, jregime) == (batch_size, num_batches, regime)
        for u, i, j, w in jax_triples(js, jm, key, batch, nb, regime, jpop):
            tb.bpr_step(params, u, i, j, w, hp, update_j=update_j,
                        soft_margin=soft_margin)

    monkeypatch.setattr(jbpr.BPRMF, "init_model", record)
    monkeypatch.setattr(tbpr.BPRMF, "init_model", replay)
    monkeypatch.setattr(jb, "bpr_epoch", epoch)
    monkeypatch.setattr(tb, "bpr_epoch", port_epoch)


@pytest.mark.parametrize("name,opts", [
    ("BPRMF", ""), ("WeightedBPRMF", ""),
    ("SoftMarginRankingMF", "uniform_user_sampling=false update_j=false")])
def test_models_past_the_tiled_bound_match_jax(feedback, shared_runs,
                                               monkeypatch, name, opts):
    monkeypatch.setattr(tplan, "RESIDENT_ITEM_TABLE_BYTES", 1024)
    assert tplan.select_schedule(I, F) == "minibatch"
    jf, tf = feedback
    o = f"num_factors={F} num_iter=2 batch_size=256 {opts}"
    jm = getattr(jbpr, name)()
    jax_configure(jm, o)
    tm = create_item_recommender(name, o + " device=cpu")
    jm.feedback, tm.feedback = jf, tf
    jm.train()
    tm.train()
    assert tm._sampler is not None and tm._plan is None
    for k in ("user_factors", "item_factors", "item_bias"):
        np.testing.assert_allclose(tm.params[k].numpy(),
                                   np.asarray(jm.params[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_models_train_from_own_generator(feedback, monkeypatch):
    """With its own draws the minibatch BPRMF learns the pairs: the
    objective on the fixed loss sample falls, and the tables stay
    finite."""
    monkeypatch.setattr(tplan, "RESIDENT_ITEM_TABLE_BYTES", 1024)
    _, tf = feedback
    m = create_item_recommender("BPRMF", f"num_factors={F} num_iter=1 "
                                "learn_rate=0.1 batch_size=64 device=cpu")
    m.feedback = tf
    m.train()
    before = m.compute_objective()
    for _ in range(10):
        m.iterate()
    assert m.compute_objective() < before
    assert all(torch.isfinite(t).all() for t in m.params.values())
