"""The cluster walks of epoch kernels 3-5 (``csrc/bpr_epoch.cu``,
``csrc/svdpp_epoch.cu``, over ``csrc/cluster_scatter.cuh``) held on the
CPU to numpy oracles, and the port's BPR and SVD++ epochs over
duplicate-heavy Zipf orders held to the JAX package's Pallas epochs in
interpret mode (float32 operands).

A kernel spreads each chunk's (or step's) slots over a thread-block
cluster of N CTAs (``ops/cluster.py``), and the chunk's owner-scatter
stage over the CTAs' shared memory by compact index; CTA r sums the runs
whose first value lies in its part and reads a run's tail in the parts
after it. ``slot_ranges``, ``stage_split`` and ``sum_sources`` below
restate the kernels' index math in numpy; they are held to brute-force
oracles on the segment tables of the SVD++ plan (table 0 the users: s in S, W
and the cn row in R; table 1 the items: Q in R, Y in Y) and of the BPR
sampler (table 0 W, table 1 H with its i entries before its j entries),
including runs that cross a part between an i entry and a j entry and
runs of one heavy user that fill a chunk. The shared-memory layouts are
held at each cluster size. On the CPU the wrappers run the plain
versions; ``tests/test_torch_cuda.py`` holds the kernels to the
one-block kernels' digests on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mymedialite_tpu.ops import pallas_svdpp as psv
from mymedialite_tpu_torch.data.arrays import PosOnlyData
from mymedialite_tpu_torch.ops import bpr_epoch as BE
from mymedialite_tpu_torch.ops import bpr_plan as BP
from mymedialite_tpu_torch.ops import plan as P
from mymedialite_tpu_torch.ops import svdpp_epoch as SE
from mymedialite_tpu_torch.ops import svdpp_plan as SP
from mymedialite_tpu_torch.ops.segments import (
    ID_MASK, bpr_segments_reference, chunk_segments, round8, runs_length,
)
from mymedialite_tpu_torch.ops.sgd import LOSS_MAE, LOSS_RMSE
from mymedialite_tpu_torch.ops.svdpp import history_edges
from torch_threads import one_torch_thread  # noqa: F401

SIZES = (1, 2, 4, 8, 16)
# the chunks the plans pick (BPR 128-640, SVD++ 512) and a small one
CHUNKS = (64, 128, 256, 384, 512, 640)


def slot_ranges(chunk: int, n: int):
    """[(lo, hi)] of each of the n CTAs: the slots of a chunk it runs, as
    the kernels split them."""
    cs = -(-chunk // n)
    return [(min(chunk, r * cs), min(chunk, (r + 1) * cs)) for r in range(n)]


def stage_split(runs, sides: int, w0: int, w1: int, n: int):
    """A chunk's stage over n CTAs, from the runs block ``runs`` (int, the
    head of a segment table row: runs of table 0 and 1, their entries,
    then (first entry, first compact index, length) a run) for a step of
    ``sides`` (1: table 0, 2: table 1, 3: both) at w0 and w1 float4s an
    entry. Returns (S, first): S the float4s a CTA holds, first [n + 1]
    the runs [first[r], first[r + 1]) whose first value lies in CTA r's
    part, among the runs of the step's tables (table 0's first)."""
    runs = np.asarray(runs, np.int64) & 0xFFFF
    nr0, nr1, n0, n1 = (int(x) for x in runs[:4])
    off1 = n0 * w0 if sides & 1 else 0
    total = off1 + (n1 * w1 if sides & 2 else 0)
    S = max(1, -(-total // n))
    lo = 0 if sides & 1 else nr0
    hi = nr0 + nr1 if sides & 2 else nr0
    compact = runs[4:][1::3][:nr0 + nr1]
    off = np.where(compact < n0, compact * w0, off1 + (compact - n0) * w1)
    first = lo + np.searchsorted(off[lo:hi], np.arange(n + 1) * S,
                                 side="left")
    return S, np.minimum(first, hi)


def sum_sources(runs, sides: int, w0: int, w1: int, n: int, rank: int):
    """What CTA ``rank`` folds in phase 2, as the kernels' cluster_sums
    (csrc/cluster_scatter.cuh) reads it: {(run k, piece li): [(part q,
    float4 in part q)]} in list order for each of its runs
    (``stage_split``): its own part while the run's values lie there (the
    first ``nl`` of them), then the parts after it. Arguments as
    ``stage_split``."""
    S, first = stage_split(runs, sides, w0, w1, n)
    head = np.asarray(runs, np.int64) & 0xFFFF
    nr0, n0 = int(head[0]), int(head[2])
    off1 = n0 * w0 if sides & 1 else 0
    run = head[4:]
    lo, hi = rank * S, (rank + 1) * S
    out = {}
    for k in range(int(first[rank]), int(first[rank + 1])):
        compact, length = int(run[3 * k + 1]), int(run[3 * k + 2])
        w = w0 if k < nr0 else w1
        base = compact * w0 if compact < n0 else off1 + (compact - n0) * w1
        for li in range(w):
            o = base + li
            nl = 0 if o >= hi else \
                length if o + (length - 1) * w < hi else -(-(hi - o) // w)
            src = [(rank, o + c * w - lo) for c in range(nl)]
            src += [((o + c * w) // S, (o + c * w) % S)
                    for c in range(nl, length)]
            out[(k, li)] = src
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_each_slot_runs_once(chunk, n):
    """The CTAs' slot ranges [r cs, (r + 1) cs), cs = ceil(C / N), cover
    a chunk's slots once each, in order; at the size the wrappers pick
    none is empty."""
    owner = np.arange(chunk) // -(-chunk // n)
    got = slot_ranges(chunk, n)
    assert len(got) == n
    for r, (lo, hi) in enumerate(got):
        np.testing.assert_array_equal(np.arange(lo, hi),
                                      np.flatnonzero(owner == r))
    assert sum(hi - lo for lo, hi in got) == chunk
    if n in (BE.cluster_size(chunk), SE.cluster_size(chunk)):
        assert all(hi > lo for lo, hi in got)


def test_cluster_sizes_of_the_main_paths():
    """SVD++'s steps of 512 and BPR's chunks of 640 spread over a cluster
    of 8, and so do the chunks where each kernel measured a cluster of 8
    faster than one CTA: BPR's (the tiled schedule's too) from 128 slots,
    SVD++'s from 192 (at 128, 20 factors, one CTA was faster); smaller
    chunks run in one CTA."""
    assert SE.cluster_size(512) == BE.cluster_size(640) == 8
    for C in (192, 256, 384):
        assert SE.cluster_size(C) == BE.cluster_size(C) == 8
    assert BE.cluster_size(128) == 8 and SE.cluster_size(128) == 1
    assert SE.cluster_size(64) == BE.cluster_size(64) == 1


def _nlive(rates, col):
    """Live float4s of a rate column, as the kernels count them."""
    return int((rates[:, col].reshape(-1, 4) != 0).any(1).sum())


def _oracle(runs, sides, w0, w1, n):
    """(S, owner of each of the step's runs, every float4 of the stage
    with its CTA), by brute force from the runs block."""
    head = [int(x) & 0xFFFF for x in runs[:4]]
    nr0, nr1, n0, n1 = head
    off1 = n0 * w0 if sides & 1 else 0
    total = off1 + (n1 * w1 if sides & 2 else 0)
    S = max(1, -(-total // n))
    ks = range(0 if sides & 1 else nr0, nr0 + nr1 if sides & 2 else nr0)
    owner = {}
    for k in ks:
        compact = int(runs[4 + 3 * k + 1]) & 0xFFFF
        off = compact * w0 if compact < n0 else off1 + (compact - n0) * w1
        owner[k] = off // S
    return S, owner, total


def _check_step(runs, sides, w0, w1, n):
    """stage_split and sum_sources against the oracle on one step."""
    S, first = stage_split(runs, sides, w0, w1, n)
    S_o, owner, total = _oracle(runs, sides, w0, w1, n)
    assert S == S_o and n * S >= total
    ks = sorted(owner)
    assert first[0] == (ks[0] if ks else first[0])
    for r in range(n):
        mine = [k for k in ks if owner[k] == r]
        assert list(range(first[r], first[r + 1])) == mine
    head = [int(x) & 0xFFFF for x in runs[:4]]
    nr0, n0 = head[0], head[2]
    off1 = n0 * w0 if sides & 1 else 0
    crossing = 0
    seen = set()
    for r in range(n):
        for (k, li), src in sum_sources(runs, sides, w0, w1, n,
                                           r).items():
            compact = int(runs[4 + 3 * k + 1]) & 0xFFFF
            length = int(runs[4 + 3 * k + 2]) & 0xFFFF
            w = w0 if k < nr0 else w1
            o = (compact * w0 if compact < n0
                 else off1 + (compact - n0) * w1) + li
            want = [((o + c * w) // S, (o + c * w) % S)
                    for c in range(length)]
            assert src == want
            crossing += any(q != r for q, _ in src)
            seen.add((k, li))
    assert seen == {(k, li) for k in ks
                    for li in range(w0 if k < nr0 else w1)}
    return crossing


@pytest.fixture(scope="module")
def svdpp_steps():
    """The steps of an SVD++ plan over Zipf users and items (a few heavy
    users, a small catalog: runs of hundreds of slots), at the models'
    blocks and chunks of 512, with their segment tables and the widths
    of each phase at 20 factors."""
    rng = np.random.default_rng(8)
    U, I, n = 1100, 40, 24000
    users = (rng.zipf(1.2, n) % U).astype(np.int32)
    items = (rng.zipf(1.3, n) % I).astype(np.int32)
    values = rng.integers(1, 11, n).astype(np.float32) / 2
    hu, hi = history_edges(users, items, I)
    plan = SP.prepare_svdpp_mxu(users, items, values, hu, hi, U, I,
                                shuffle_seed=1)
    f = 20
    fe = SP.svdpp_fe(f)
    rates = SP.svdpp_mxu_rates(f, fe, 0.01, 0.7, 0.015, 0.33, 0.015,
                               use_p=True, update_user=True,
                               update_item=True)
    fq4 = ((f + 3) // 4 * 4 + 4) // 4
    widths = {0: (((f + 3) // 4 * 4) // 4, 0),
              1: (_nlive(rates, 0) + fq4, _nlive(rates, 2)),
              2: (0, _nlive(rates, 6))}
    segs = chunk_segments(plan.packed).numpy()
    ph, row = (t.numpy() for t in (plan.schedule[0], plan.schedule[3]))
    return plan, segs, ph, row, widths


SIDES = {0: 1, 1: 3, 2: 2}


@pytest.mark.parametrize("n", SIZES)
def test_svdpp_stage_over_the_cluster(svdpp_steps, n):
    """Every step of the plan, each phase with its sides and widths: the
    stage's parts, each CTA's runs and what it folds equal the oracle;
    at N > 1 some runs cross into the next part."""
    plan, segs, ph, row, widths = svdpp_steps
    crossing = 0
    for p, r in zip(ph.tolist(), row.tolist()):
        w0, w1 = widths[p]
        crossing += _check_step(segs[r], SIDES[p], w0, w1, n)
    assert crossing > 0 or n == 1


@pytest.mark.parametrize("n", SIZES)
def test_heavy_user_fills_a_step(n):
    """One user alone in its user block with a rating and an edge on
    each of the 1,024 items of one item block: its S and R steps hold it
    in every slot, one run of C entries of table 0 that spans every part
    of the stage. CTA 0 owns it and folds the values of its own part,
    then every other part's, each once in list order."""
    rng = np.random.default_rng(3)
    U, I = 600, 1024
    users = np.concatenate([np.zeros(I, np.int32),
                            rng.integers(512, U, 500).astype(np.int32)])
    items = np.concatenate([rng.permutation(I),
                            rng.integers(0, I, 500)]).astype(np.int32)
    values = rng.integers(1, 11, users.size).astype(np.float32) / 2
    hu, hi = history_edges(users, items, I)
    plan = SP.prepare_svdpp_mxu(users, items, values, hu, hi, U, I,
                                shuffle_seed=2)
    segs = chunk_segments(plan.packed).numpy()
    ph, row = (t.numpy() for t in (plan.schedule[0], plan.schedule[3]))
    full = 0
    for p, r in zip(ph.tolist(), row.tolist()):
        if p == 2:
            continue
        runs = segs[r]
        head = [int(x) & 0xFFFF for x in runs[:4]]
        if head[0] == 1 and head[2] == plan.chunk:
            # one run of the whole chunk in table 0
            full += 1
            w0 = 5 if p == 0 else 14
            S, first = stage_split(runs, SIDES[p], w0, 8, n)
            assert first[0] == 0 and all(f >= 1 for f in first[1:])
            src = sum_sources(runs, SIDES[p], w0, 8, n, 0)
            parts = {q for li in range(w0) for q, _ in src[(0, li)]}
            assert len(src[(0, 0)]) == plan.chunk
            assert parts == set(range(min(n, -(-(plan.chunk * w0) // S))))
        _check_step(runs, SIDES[p], 5 if p == 0 else 14, 8, n)
    assert full >= 2


@pytest.fixture(scope="module")
def bpr_chunks():
    """The BPR sampler's tables (the plain builder) of an epoch over a
    Zipf(1.3) catalog of 300 items at the models' blocks and chunks of
    640: runs that mix i and j entries of popular items."""
    rng = np.random.default_rng(0)
    U, I, n = 700, 300, 20000
    fb = PosOnlyData(rng.integers(0, U, n), rng.zipf(1.3, n) % I,
                     num_users=U, num_items=I)
    plan, state, meta = BP.prepare_bpr_mxu(fb, uniform_user=True,
                                           shuffle_seed=1, bitmask=True)
    order = plan.epoch_order(5)
    jb, nval, bkt = BP.epoch_negative_plan(plan, state["nvalid"],
                                           order[0].numpy(), meta[3], 6)
    bits = torch.from_numpy(np.random.default_rng(11).integers(
        0, 2 ** 31, (plan.num_chunks, meta[2], plan.chunk), dtype=np.int32))
    u_loc = plan.packed[order[2].long()][:, 0]
    j, ok = BE.sample_negatives_reference(
        bits, jb, nval, bkt, u_loc, item_block=plan.item_block,
        keys_tbl=state["keys_tbl"])
    neg = torch.stack([j, ok.to(torch.float32).view(torch.int32)], 1)
    lists, segs = bpr_segments_reference(
        plan.packed[order[2].long()], neg, order[1], jb,
        item_block=plan.item_block, lists=True)
    rates = BP.bpr_mxu_column_rates(40, P.fused_width(40), 0.05, 0.0025,
                                    0.0025, 0.00025, 0.01, True)
    w0 = _nlive(rates, 0)
    w1 = int(((rates[:, 2] != 0) | (rates[:, 4] != 0)).reshape(-1, 4)
             .any(1).sum())
    return plan, lists.numpy(), segs.numpy(), w0, w1


def _mixed_crossings(lists, runs, w0, w1, n, C):
    """Runs of H with an i entry followed by a j entry whose values lie in
    different parts of the stage (for some piece)."""
    head = [int(x) & 0xFFFF for x in runs[:4]]
    nr0, nr1, n0, n1 = head
    S = max(1, -(-(n0 * w0 + n1 * w1) // n))
    entries = [int(e) & 0xFFFF for e in lists]
    found = 0
    for k in range(nr0, nr0 + nr1):
        first, compact, length = (int(x) & 0xFFFF
                                  for x in runs[4 + 3 * k:7 + 3 * k])
        at = entries.index(first)
        ids = [e & ID_MASK for e in entries[at:at + length]]
        for c in range(length - 1):
            if ids[c] < C <= ids[c + 1]:
                o = n0 * w0 + (compact + c - n0) * w1
                found += any((o + li) // S != (o + w1 + li) // S
                             for li in range(w1))
    return found


@pytest.mark.parametrize("n", SIZES)
def test_bpr_stage_over_the_cluster(bpr_chunks, n):
    """Every chunk of the epoch (W and H, both sides): the stage's parts,
    each CTA's runs and what it folds equal the oracle; at N > 1 some H
    run crosses a part between an i entry and a j entry (the place where
    a run's first value and its piece's next values lie in two parts)."""
    plan, lists, segs, w0, w1 = bpr_chunks
    mixed = 0
    for k in range(segs.shape[0]):
        _check_step(segs[k], 3, w0, w1, n)
        if n > 1 and mixed == 0:
            mixed += _mixed_crossings(lists[k], segs[k], w0, w1, n,
                                      plan.chunk)
    assert mixed > 0 or n == 1


def _svdpp_layout(fe, chunk, user_block, f, shared):
    """A CTA's dynamic shared memory of the SVD++ walk, as the kernel lays
    it out: (name, offset, bytes) up to the stage."""
    rk = runs_length(2 * chunk) + 2 * round8(chunk)
    fq = (f + 3) // 4 * 4 + 4
    sizes = [("rates", 4 * 8 * fe), ("packed", 2 * 4 * chunk * 4),
             ("segments", 2 * rk * 2),
             ("live", 4 * ((6 * (fe // 4) + 3) // 4 * 4)),
             ("copy", 4 * user_block * fq if shared else 0)]
    at, out = 0, []
    for name, size in sizes:
        out.append((name, at, size))
        at += size
    return out, at


@pytest.mark.parametrize("n", SIZES)
def test_svdpp_shared_memory_contract(n):
    """At each cluster size: every buffer of the layout starts on 16
    bytes; ``shared_bytes`` is the layout up to the stage plus one row of
    the widest step; the "shared" variant leaves a CTA ``stage_need``
    bytes of stage (a worst-case step's part at N, at most 512 rows of
    the widest step); at the models' shape (UB = C = 512) and the size
    the wrapper picks, a worst-case step's part fits every width up to
    200 factors in the global variant."""
    C = UB = 512
    for f in range(1, 254):
        fe = SP.svdpp_fe(f)
        fq = (f + 3) // 4 * 4 + 4
        for shared in (False, True):
            lay, stage = _svdpp_layout(fe, C, UB, f, shared)
            assert all(at % 16 == 0 for _, at, _ in lay) and stage % 16 == 0
            variant = "shared" if shared else "global"
            assert SE.shared_bytes(fe, C, UB, f, variant) == \
                stage + 4 * (fe + fq)
        need = SE.stage_need(fe, C, f, n)
        assert need == 4 * min(-(-C * (2 * fe + fq) // n), 512 * (fe + fq))
        if n == SE.cluster_size(C):
            _, stage = _svdpp_layout(fe, C, UB, f, True)
            if SE.accumulator_variant(UB, f, C, fe) == "shared":
                assert SE.DYNAMIC_SHARED_BYTES - stage >= need
            _, stage = _svdpp_layout(fe, C, UB, f, False)
            if f <= 200:
                assert SE.DYNAMIC_SHARED_BYTES - stage >= \
                    4 * -(-C * (2 * fe + fq) // n)
    assert SE.DYNAMIC_SHARED_BYTES == 227 * 1024 - 1024


@pytest.mark.parametrize("n", SIZES)
def test_bpr_shared_memory_contract(n):
    """At each cluster size and chunk: the walk's three chunk buffers,
    their segment tables and the live lists start on 16 bytes;
    ``shared_bytes`` is the layout up to the stage plus one row; every
    width up to 256 takes the chunks up to 640; at the size the wrapper
    picks, a chunk whose three entries a slot all lie in runs with every
    float4 live fits on chip up to 100 factors."""
    widths = sorted({P.fused_width(f) for f in range(1, 255)})
    for chunk in CHUNKS:
        rk = runs_length(3 * chunk) + 3 * round8(chunk)
        for fe in widths:
            sizes = [4 * 6 * fe, 3 * 6 * chunk * 4, 3 * rk * 2,
                     4 * ((4 * (fe // 4) + 3) // 4 * 4)]
            offsets = np.cumsum([0] + sizes)
            assert all(o % 16 == 0 for o in offsets)
            assert BE.shared_bytes(fe, chunk) == offsets[-1] + 4 * fe
            assert BE.shared_bytes(fe, chunk) <= BE.DYNAMIC_SHARED_BYTES
            if n == BE.cluster_size(chunk) and fe <= P.fused_width(100):
                stage = BE.DYNAMIC_SHARED_BYTES - offsets[-1]
                assert n * stage >= 16 * 3 * chunk * (fe // 4) or n == 1
    assert BE.DYNAMIC_SHARED_BYTES == 227 * 1024 - 1024


# --- the epochs over duplicate-heavy Zipf orders against the JAX package

BPR_VARIANTS = [(False, False, False), (True, False, True),
                (False, True, False)]


@pytest.mark.parametrize("soft_margin,wbpr,bitmask", BPR_VARIANTS,
                         ids=["bpr-keys", "hinge-bitmask", "wbpr-keys"])
def test_bpr_zipf_epoch_matches_jax(soft_margin, wbpr, bitmask):
    """One epoch over a Zipf(1.2) catalog of 40 items (runs of dozens of
    i and j entries in a chunk of 64): the port's epoch (the plain
    version on the CPU) against the Pallas epoch in interpret mode on the
    same plan, order, negative plan and bits: negatives identical, tables
    within 1e-5."""
    import jax
    from mymedialite_tpu.ops import pallas_bpr as pb
    from test_torch_bpr_epoch import FE, _inputs, _jax_tables, _rates
    rng = np.random.default_rng(4)
    U, I, n = 90, 40, 1500
    fb = PosOnlyData(rng.integers(0, U, n), rng.zipf(1.2, n) % I,
                     num_users=U, num_items=I)
    x = _inputs(fb, wbpr, dict(user_block=32, item_block=32, chunk=64,
                               shuffle_seed=3))
    n_ib, Kcap, trials, _, IB = x["meta"]
    rates = _rates()
    jW, jH, jneg = pb.bpr_epoch_mxu(
        *_jax_tables(x),
        x["jplan"].packed, x["js"]["keys_tbl"], x["js"]["cdf_tbl"], x["bits"],
        x["jorder"], jnp.asarray(x["jb"].numpy()),
        jnp.asarray(x["nval"].numpy()), jnp.asarray(x["bkt"].numpy()),
        jnp.asarray(rates.numpy()),
        meta=x["jplan"].meta(FE) + (Kcap, trials), soft_margin=soft_margin,
        wbpr=wbpr, mxu_dtype="f32", interpret=True,
        bm_tbl=x["js"]["bitmask_tbl"] if bitmask else None)
    jax.block_until_ready(jW)
    W, H, neg = BE.bpr_epoch(
        x["We"], x["He"], x["tplan"].packed, x["ts"]["keys_tbl"],
        x["ts"]["cdf_tbl"], x["tbits"], x["order"], x["jb"], x["nval"],
        x["bkt"], rates, user_block=32, item_block=32,
        soft_margin=soft_margin, wbpr=wbpr,
        bitmask_tbl=x["ts"]["bitmask_tbl"] if bitmask else None,
        return_negatives=True)
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
    assert np.abs(W.numpy() - np.asarray(jW)).max() <= 1e-5
    assert np.abs(H.numpy() - np.asarray(jH)).max() <= 1e-5
    # duplicates: some chunk holds an item in ten or more of its slots
    i_loc = x["tplan"].packed[:, 1].numpy()
    assert max(np.bincount(r).max() for r in i_loc) >= 10


# (sigmoid, loss, use_p)
SVDPP_VARIANTS = [(False, LOSS_RMSE, True), (True, LOSS_RMSE, True),
                  (True, LOSS_MAE, True), (True, LOSS_RMSE, False)]


@pytest.mark.parametrize("sigmoid,loss,use_p", SVDPP_VARIANTS,
                         ids=["plain", "sigmoid-rmse", "sigmoid-mae", "no-p"])
def test_svdpp_zipf_epoch_matches_jax(sigmoid, loss, use_p):
    """One epoch over Zipf users and items (runs of dozens of one user's
    and one item's entries in a step of 32): the port's epoch (the plain
    version on the CPU) against the Pallas epoch in interpret mode from
    the same plan, tables and rates, within 2e-5 (the JAX test's
    tolerance)."""
    rng = np.random.default_rng(6)
    U, I, N, F = 60, 30, 900, 6
    u = (rng.zipf(1.3, N) % U).astype(np.int32)
    i = (rng.zipf(1.3, N) % I).astype(np.int32)
    v = rng.uniform(1, 5, N).astype(np.float32)
    hu, hi = history_edges(u, i, I)
    kw = dict(user_block=16, item_block=16, chunk=32)
    pj = psv.prepare_svdpp_mxu(u, i, v, hu, hi, U, I, pass_len=256, **kw)
    pt = SP.prepare_svdpp_mxu(u, i, v, hu, hi, U, I, **kw)
    tabs = tuple((0.1 * rng.standard_normal(s)).astype(np.float32)
                 for s in ((U, F), (U,), (I, F), (I,), (I, F)))
    p, bu, q, bi, y = (torch.from_numpy(a) for a in tabs)
    fe = SP.svdpp_fe(F)
    W0, Q0, Y0 = SP.svdpp_tables_to_mxu(
        p if use_p else torch.zeros_like(p), bu, pt.inv_sqrt, q, bi, y,
        torch.from_numpy(pt.new_of_old.astype(np.int64)), u_pad=pt.u_pad,
        i_pad=pt.i_pad, fe=fe)
    hp = (3.0, 1.0, 4.0)
    hp_j = np.zeros((1, 8), np.float32)
    hp_j[0, :3] = hp
    args = (F, fe, 0.01, 0.7, 0.015, 0.33, 0.015)
    rk = dict(use_p=use_p, update_user=True, update_item=True)
    got_j = psv.svdpp_epoch_mxu(
        *(jnp.asarray(t.numpy()) for t in (W0, Q0, Y0)), pj.packed, pj.ph,
        pj.ub, pj.ib, pj.row, pj.first_flag, psv.svdpp_mxu_rates(*args, **rk),
        jnp.asarray(hp_j), meta=pj.meta(fe), num_factors=F, loss=loss,
        sigmoid=sigmoid, mxu_dtype="f32", interpret=True)
    Wt, Qt, Yt = W0.clone(), Q0.clone(), Y0.clone()
    SE.svdpp_epoch(Wt, Qt, Yt, pt.packed, pt.schedule, hp,
                   SP.svdpp_mxu_rates(*args, **rk),
                   user_block=pt.user_block, item_block=pt.item_block,
                   num_factors=F, loss=loss, sigmoid=sigmoid)
    for got, ref in zip((Wt, Qt, Yt), got_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=2e-5)
    assert not torch.equal(Yt, Y0) and not torch.equal(Qt, Q0)
    # duplicates: some step holds a user and an item in four or more slots
    d = pt.packed.numpy()
    assert max(np.bincount(c[0]).max() for c in d) >= 4
    assert max(np.bincount(c[1]).max() for c in d) >= 4
