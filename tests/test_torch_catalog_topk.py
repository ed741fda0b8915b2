"""The port's fused top-k (``mymedialite_tpu_torch/ops/catalog_topk.py``,
on the CPU its plain version) against the JAX package's Pallas kernel in
interpret mode (``mymedialite_tpu/ops/pallas_topk.py catalog_topk``) on
the cases of ``tests/test_pallas_topk.py``, and the port's
``topk_from_factors`` against the JAX one.

Tolerances are those of ``tests/test_pallas_topk.py``: values to rtol
1e-4 and atol 1e-6, ids equal where the JAX kernel's neighbouring values
differ by more than 1e-5 (two summation orders can swap items whose
scores differ in the last bits), and equal everywhere in the tie case.
Slots scored -3e38 (masked items, k past the catalog) carry no id to
compare: the JAX kernel fills them from its initial list (id 0), the
port with the masked items in id order, as ``lax.top_k`` does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mymedialite_tpu.ops import pallas_topk as pt
from mymedialite_tpu.ops import topk as jtopk
from mymedialite_tpu_torch.ops import catalog_topk as ct
from mymedialite_tpu_torch.ops.topk import topk_from_factors
from torch_threads import one_torch_thread  # noqa: F401


def _inputs(B, N, f, mask_frac=None, seed=0):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(B, f)).astype(np.float32)
    H = rng.normal(size=(N, f)).astype(np.float32)
    mask = None if mask_frac is None else \
        (rng.random((B, N)) > mask_frac).astype(np.int8)
    return W, H, mask


def _both(W, H, mask, k, **jax_kw):
    """(port ids, port vals, JAX ids, JAX vals) as numpy."""
    before = ct.catalog_topk.launches
    got = ct.catalog_topk(torch.from_numpy(W), torch.from_numpy(H),
                          None if mask is None else torch.from_numpy(mask),
                          k=k)
    assert ct.catalog_topk.launches == before   # the CPU takes the plain one
    want = pt.catalog_topk(jnp.asarray(W), jnp.asarray(H),
                           None if mask is None else jnp.asarray(mask), k=k,
                           interpret=True, **jax_kw)
    gi, gv = (t.numpy() for t in got)
    wi, wv = (np.asarray(t) for t in want)
    assert gi.dtype == np.int32 and gv.dtype == np.float32
    assert gi.shape == wi.shape == (W.shape[0], k)
    return gi, gv, wi, wv


def _assert_agree(gi, gv, wi, wv):
    np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-6)
    real = wv > ct.NEG_INF / 2
    v = wv.astype(np.float64)
    gap = np.abs(np.diff(v, axis=1)) > 1e-5
    sure = real.copy()
    sure[:, 1:] &= gap
    sure[:, :-1] &= gap
    np.testing.assert_array_equal(gi[sure], wi[sure])
    return sure


@pytest.mark.parametrize("B,N,f,k,mask_frac,jax_kw", [
    (16, 1000, 24, 10, None, {}),
    (300, 1537, 17, 7, None, dict(block_users=128, tile_items=512)),
    (32, 700, 8, 5, 0.5, {})],
    ids=["basic", "users-and-tiles", "half-mask"])
def test_matches_pallas_kernel(B, N, f, k, mask_frac, jax_kw):
    sure = _assert_agree(*_both(*_inputs(B, N, f, mask_frac), k, **jax_kw))
    assert sure.mean() > 0.95


def test_nearly_all_masked():
    """Fewer candidates than k: the tail scores -3e38."""
    W, H, _ = _inputs(4, 50, 6, seed=3)
    mask = np.zeros((4, 50), np.int8)
    mask[0, [3, 10]] = 1
    mask[1, :] = 1
    gi, gv, wi, wv = _both(W, H, mask, 4)
    _assert_agree(gi, gv, wi, wv)
    assert (gv[0, 2:] <= ct.NEG_INF / 2).all()
    assert (gv[2:] <= ct.NEG_INF / 2).all()
    # the port's tail: the smallest masked ids, as a stable sort gives
    np.testing.assert_array_equal(gi[2], [0, 1, 2, 3])


def test_k_larger_than_catalog():
    gi, gv, wi, wv = _both(*_inputs(8, 6, 4), 10)
    _assert_agree(gi, gv, wi, wv)
    assert (gi[:, 6:] == 0).all() and (gv[:, 6:] == ct.NEG_INF).all()
    assert sorted(gi[0, :6]) == list(range(6))


def test_ties_go_to_the_smaller_id():
    W = np.ones((3, 4), np.float32)
    H = np.ones((600, 4), np.float32)
    gi, gv, wi, wv = _both(W, H, None, 5, tile_items=128)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gi[0], np.arange(5))


def test_k_guard():
    W, H, _ = _inputs(4, 100, 4)
    with pytest.raises(ValueError):
        ct.catalog_topk(torch.from_numpy(W), torch.from_numpy(H), k=65)
    with pytest.raises(ValueError):
        pt.catalog_topk(jnp.asarray(W), jnp.asarray(H), k=100,
                        interpret=True)


@pytest.mark.parametrize("bad", ["dtype", "width", "mask-shape",
                                 "mask-dtype", "empty", "no-users"])
def test_refuses_bad_input(bad):
    W, H, mask = (torch.from_numpy(a) for a in _inputs(4, 100, 4, 0.5))
    args = {"dtype": (W.double(), H, None),
            "width": (W, H[:, :3].contiguous(), None),
            "mask-shape": (W, H, mask[:, :50].contiguous()),
            "mask-dtype": (W, H, mask.float()),
            "empty": (W, H[:0], None),
            "no-users": (W[:0], H, None)}[bad]
    with pytest.raises((ValueError, TypeError)):
        ct.catalog_topk(*args, k=5)


def test_reference_is_the_stable_sort():
    """``topk_reference``: the first k of a stable descending sort of
    the masked scores, which is ``lax.top_k``'s order."""
    W, H, mask = _inputs(20, 300, 5, 0.3, seed=9)
    gi, gv = ct.topk_reference(torch.from_numpy(W), torch.from_numpy(H),
                               torch.from_numpy(mask), k=12)
    wi, wv = pt.topk_reference(jnp.asarray(W), jnp.asarray(H),
                               jnp.asarray(mask), k=12)
    _assert_agree(gi.numpy(), gv.numpy(), np.asarray(wi), np.asarray(wv))
    scores = np.where(mask != 0, W @ H.T, np.float32(ct.NEG_INF))
    order = np.argsort(-scores, axis=1, kind="stable")[:, :12]
    np.testing.assert_array_equal(gi.numpy(), order)


@pytest.mark.parametrize("with_ignore,with_cand", [
    (False, False), (True, False), (True, True)],
    ids=["plain", "ignore", "ignore-candidates"])
def test_topk_from_factors_matches_jax(with_ignore, with_cand):
    rng = np.random.default_rng(4)
    B, N, f, k = 24, 400, 9, 15
    W = rng.normal(size=(B, f)).astype(np.float32)
    H = rng.normal(size=(N, f)).astype(np.float32)
    P = 30 if with_ignore else 0
    ignore = np.full((B, P), N, np.int32)
    for r in range(B):
        n = int(rng.integers(0, P + 1))
        ignore[r, :n] = rng.choice(N, n, replace=False)
    cand = np.ones(N, np.float32)
    if with_cand:
        cand[rng.random(N) < 0.4] = 0
    gi, gv = topk_from_factors(torch.from_numpy(W), torch.from_numpy(H),
                               torch.from_numpy(ignore.astype(np.int64)),
                               torch.from_numpy(cand), k=k)
    wi, wv = jtopk.topk_from_factors(jnp.asarray(W), jnp.asarray(H),
                                     jnp.asarray(ignore), jnp.asarray(cand),
                                     k=k)
    assert gi.dtype == torch.int32
    sure = _assert_agree(gi.numpy(), gv.numpy(), np.asarray(wi),
                         np.asarray(wv))
    assert sure.mean() > 0.95
    for r in range(B):
        assert not set(gi[r].tolist()) & set(ignore[r].tolist())
        assert cand[gi[r].numpy()].all()


# --- kernel 6's split and merge, modelled in plain torch ------------------

NO_ID = 2 ** 31 - 1


def split_merge_topk(W, H, mask, k, split):
    """Plain model of the CUDA kernel's design (used only here): the
    catalog cut into splits of ``split`` items, the top-min(k, N) of each
    split under (value desc, id asc) with a short split padded by
    (-inf, INT_MAX), then the top of the union of the partial lists, padded
    to k as ``catalog_topk`` pads. Returns numpy (ids, vals)."""
    W, H = torch.from_numpy(W), torch.from_numpy(H)
    N, k_run = H.shape[0], min(k, H.shape[0])
    part_v, part_i = [], []
    for lo in range(0, N, split):
        hi = min(N, lo + split)
        s = W @ H[lo:hi].T
        if mask is not None:
            s = s.masked_fill(torch.from_numpy(mask[:, lo:hi]) == 0,
                              ct.NEG_INF)
        v, i = torch.sort(s, dim=1, descending=True, stable=True)
        v, i = v[:, :k_run], i[:, :k_run] + lo
        short = k_run - v.shape[1]
        part_v.append(torch.cat([v, v.new_full((v.shape[0], short),
                                               -float("inf"))], 1))
        part_i.append(torch.cat([i, i.new_full((i.shape[0], short), NO_ID)],
                                1))
    v, i = torch.cat(part_v, 1), torch.cat(part_i, 1)
    by_id = torch.argsort(i, dim=1, stable=True)
    v, i = v.gather(1, by_id), i.gather(1, by_id)
    by_v = torch.argsort(v, dim=1, descending=True, stable=True)
    v, i = v.gather(1, by_v)[:, :k_run], i.gather(1, by_v)[:, :k_run]
    assert (i < N).all()                     # no padding entry survives
    ids, vals = ct._pad(i.to(torch.int32), v, k)
    return ids.numpy(), vals.numpy()


def _jax_topk(W, H, mask, k):
    wi, wv = pt.catalog_topk(jnp.asarray(W), jnp.asarray(H),
                             None if mask is None else jnp.asarray(mask),
                             k=k, interpret=True)
    return np.asarray(wi), np.asarray(wv)


@pytest.mark.parametrize("case", [
    "ties-across-split-edges", "short-split", "k-past-split-size",
    "ragged-tile", "fully-masked-split", "the-split-rule"])
def test_split_and_merge_matches_pallas_kernel(case):
    """The split-and-merge design gives the JAX kernel's lists: ties
    across split edges exactly by id, a last split shorter than k, k
    larger than N / splits, N not a multiple of the 128-item tile, and a
    split whose items are all masked."""
    mask = None
    if case == "ties-across-split-edges":
        W, H, k, split = (np.ones((3, 4), np.float32),
                          np.ones((600, 4), np.float32), 64, 128)
    elif case == "short-split":
        (W, H, _), k, split = _inputs(8, 300, 6, seed=1), 64, 128
    elif case == "k-past-split-size":
        (W, H, _), k, split = _inputs(8, 100, 5, seed=2), 20, 16
    elif case == "ragged-tile":
        (W, H, mask), k, split = _inputs(16, 1537, 17, 0.3, seed=3), 10, 256
    elif case == "fully-masked-split":
        (W, H, _), k, split = _inputs(6, 700, 8, seed=4), 10, 128
        mask = np.ones((6, 700), np.int8)
        mask[:, 128:256] = 0
        W[:, :] = np.abs(W)
        H[128:256] = np.abs(H[128:256]) + 10   # the best scores, all masked
    else:
        (W, H, _), k = _inputs(32, 1537, 12, seed=5), 33
        split = ct.split_items(32, 1537, 132, 3)
        assert split % ct.TILE_ITEMS == 0 and -(-1537 // split) == 13
    gi, gv = split_merge_topk(W, H, mask, k, split)
    wi, wv = _jax_topk(W, H, mask, k)
    ri, rv = (t.numpy() for t in ct.topk_reference(
        torch.from_numpy(W), torch.from_numpy(H),
        None if mask is None else torch.from_numpy(mask), k=k))
    _assert_agree(gi, gv, wi, wv)
    _assert_agree(gi, gv, ri, rv)
    if case == "ties-across-split-edges":
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gi[0], np.arange(64))
    if case == "fully-masked-split":
        assert not ((gi >= 128) & (gi < 256)).any()


@pytest.mark.parametrize("per_sm", [2, 3])
@pytest.mark.parametrize("B,N", [(1024, 17_770), (1024, 62_423), (300, 1537),
                                 (16, 1000), (8, 6), (2000, 50),
                                 (20_000, 5000)])
def test_split_rule(B, N, per_sm):
    """Whole tiles per split, never more splits than tiles, a grid that
    one round of resident CTAs holds whenever it can, and at the serving
    shapes (1,024 users, the Netflix and ML-25M catalogs) with three CTAs
    per SM, a grid of at least two waves of 132 SMs."""
    per = ct.split_items(B, N, 132, per_sm)
    splits = -(-N // per)
    tiles = -(-N // ct.TILE_ITEMS)
    assert per % ct.TILE_ITEMS == 0 and 1 <= splits <= tiles
    assert (splits - 1) * per < N
    user_tiles = -(-B // ct.USERS_PER_CTA)
    grid = user_tiles * splits
    assert grid <= max(per_sm * 132, user_tiles)
    if B == 1024 and per_sm == 3:
        assert grid >= 2 * 132


def test_padded_columns_leave_scores_alone():
    """pad_columns appends zero columns up to a multiple of 4; the padded
    rows give the plain version's lists bit for bit."""
    W, H, mask = (torch.from_numpy(a) for a in _inputs(20, 300, 41, 0.2))
    Wp, Hp = ct.pad_columns(W), ct.pad_columns(H)
    assert Wp.shape == (20, 44) and Hp.shape == (300, 44)
    assert (Wp[:, 41:] == 0).all() and torch.equal(Wp[:, :41], W)
    assert ct.pad_columns(Wp) is Wp
    got, want = ct.topk_reference(Wp, Hp, mask, k=12), \
        ct.topk_reference(W, H, mask, k=12)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)
