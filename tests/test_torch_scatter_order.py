"""The fixed order of the port's scatters, on the CPU.

Epoch kernels 1-5 add a chunk's duplicate rows through segment tables
(``mymedialite_tpu_torch/ops/segments.py``): the live entries sorted by
(table, row, entry id), one run a row, summed in list order by one
owner (``csrc/owner_scatter.cuh``); the plain training routes scatter
through ``ops/sgd.py add_rows`` (``exact_add`` on the card). Here:

- the tables of kernels 1-2 (MF plans, resident and tiled), 3-4 (the BPR
  sampler's per-epoch tables, with the sampled j, and with i and j rows
  that meet on the tiled schedule) and 5 (the SVD++ plan) hold every live
  slot once in each table, no slot of weight 0, sorted by (row, [i
  before j,] slot), with each run's start, the runs block and each
  slot's code right;
- the owner order (``owner_scatter_reference``: a run's row plus its
  deltas in list order, stored once) equals ``index_add_`` on the CPU
  bit for bit, on duplicate-heavy chunks drawn from fixed seeds, and
  so the kernels' sums are the plain versions' sums in the plain
  versions' order;
- every plain training route reaches ``add_rows``.

Two launches of each kernel giving equal tables, and ``exact_add``'s
kernel equal to its torch composition, are held on the card
(``tests/test_torch_cuda.py``, marker ``cuda``).
"""

import collections

import numpy as np
import pytest
import torch

from mymedialite_tpu_torch.ops import segments as SG
from torch_threads import one_torch_thread  # noqa: F401


def decoded(list_row, table_row, RL):
    """(entries, compact, codes) of one chunk's list and table: entries
    as (id, table, start) for the live list positions, compact indices by
    list position, codes as ints by (kind table, slot); the runs block is
    checked against the starts here."""
    lst = (list_row.long() & 0xFFFF).tolist()
    v = (table_row.long() & 0xFFFF).tolist()
    entries = []
    for e in lst:
        if e == 0xFFFF:
            break
        entries.append((e & SG.ID_MASK, (e >> 14) & 1, bool(e & SG.START)))
    assert all(e == 0xFFFF for e in lst[len(entries):])
    starts = [p for p, (_, _, s) in enumerate(entries) if s] + [len(entries)]
    runs = [(a, b - a) for a, b in zip(starts, starts[1:]) if b - a > 1]
    compact = {}
    for a, n in runs:
        for q in range(a, a + n):
            compact[q] = len(compact)
    head = [sum(1 for a, _ in runs if entries[a][1] == t) for t in (0, 1)]
    head += [sum(n for a, n in runs if entries[a][1] == t) for t in (0, 1)]
    want = head + [x for a, n in runs for x in (lst[a], compact[a], n)]
    assert v[:RL] == want + [0] * (RL - len(want))
    return entries, compact, v[RL:]


def check_tables(lists, tables, rows_of, live_of, kind_t_of, slot_of, C):
    """Every chunk's list and table against its entries: ``rows_of(k)`` [M] the
    row key of each entry (entry index = table * C + id: table 1's ids
    run past C in the BPR item table), ``live_of(k)`` [M] bool;
    ``kind_t_of`` and ``slot_of`` [M] the kind table and the slot of each
    entry."""
    M = len(kind_t_of)
    RL = SG.runs_length(M)
    Cw = SG.round8(C)
    assert tables.shape[1] == RL + len(set(kind_t_of.tolist())) * Cw
    for k in range(tables.shape[0]):
        entries, compact, codes = decoded(lists[k], tables[k], RL)
        rows, live = rows_of(k), live_of(k)
        want = sorted((t, int(rows[m]), i) for m, (t, i) in
                      enumerate(entry_index_pairs(len(rows), C)) if live[m])
        got = [(t, int(rows[index_of(t, i, C)]), i) for i, t, _ in entries]
        # every live entry once, none of weight 0, in (table, row, id) order
        assert got == want
        want_codes = [0xFFFF] * len(codes)
        for p, (i, t, start) in enumerate(entries):
            first = p == 0 or got[p - 1][:2] != got[p][:2]
            assert start == first
            m = index_of(t, i, C)
            if p in compact:
                want_codes[int(kind_t_of[m]) * Cw + int(slot_of[m])] = \
                    compact[p] | (0x8000 if start else 0)
        assert codes == want_codes


def entry_index_pairs(M, C):
    """(table, id) of entry index m: the first C entries are table 0's
    slots, the rest table 1's ids 0.. (the BPR item table's 2C)."""
    return [(0, m) if m < C else (1, m - C) for m in range(M)]


def index_of(t, i, C):
    return i if t == 0 else C + i


def mf_plan(tiled=False, seed=3):
    from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
    from mymedialite_tpu_torch.ops import plan as P
    d = synthetic_ratings(60, 90, 1500, seed=seed)
    args = (d.users, d.items, d.values, 60, 90)
    if tiled:
        return P.prepare_mxu_tiled(*args, user_block=16, item_block=16,
                                   chunk=None, slab_blocks=1, shuffle_seed=4)
    return P.prepare_mxu_data(*args, user_block=16, item_block=32, chunk=64,
                              shuffle_seed=4)


def check_chunk_segments(packed):
    lists, tables = SG.chunk_segments(packed, lists=True)
    C = packed.shape[2]
    assert tables.dtype == torch.int16
    assert tuple(tables.shape) == (packed.shape[0],
                                   SG.table_width(C, 2 * C, 2))
    assert tuple(lists.shape) == (packed.shape[0], SG.round8(2 * C))
    assert torch.equal(SG.chunk_segments(packed), tables)
    s = np.arange(C)
    check_tables(
        lists, tables,
        lambda k: torch.cat([packed[k, 0], packed[k, 1]]).numpy(),
        lambda k: np.tile(packed[k, 3].view(torch.float32).numpy() != 0, 2),
        np.r_[np.zeros(C, int), np.ones(C, int)], np.r_[s, s], C)
    return tables


@pytest.mark.parametrize("tiled", [False, True])
def test_mf_tables_hold_every_live_slot_once_in_slot_order(tiled):
    plan = mf_plan(tiled)
    tables = check_chunk_segments(plan.packed)
    # padding slots (weight 0) exist and are in no table
    assert (plan.packed[:, 3].view(torch.float32) == 0).any()
    # the cache serves the same tensor until packed changes in place
    assert SG.segments_of(plan.packed) is SG.segments_of(plan.packed)
    assert torch.equal(SG.segments_of(plan.packed), tables)
    packed = plan.packed.clone()
    first = SG.segments_of(packed)
    packed[0, 3] = 0
    again = SG.segments_of(packed)
    assert again is not first
    # chunk 0 has no live slot now: no runs, every code dead
    RL = SG.runs_length(2 * packed.shape[2])
    assert (again[0, :RL] == 0).all() and (again[0, RL:] == SG.DEAD).all()
    assert not torch.equal(again[0], first[0])


def test_svdpp_tables_hold_every_live_slot_once_in_slot_order():
    from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
    from mymedialite_tpu_torch.ops import svdpp as SV
    from mymedialite_tpu_torch.ops import svdpp_plan as SP
    d = synthetic_ratings(50, 70, 1200, seed=11)
    hu, hi = SV.history_edges(d.users, d.items, 70)
    plan = SP.prepare_svdpp_mxu(d.users, d.items, d.values, hu, hi, 50, 70,
                                user_block=16, item_block=16, chunk=32)
    check_chunk_segments(plan.packed)


def bpr_epoch_tables(tiled, seed=6):
    """A plain BPR epoch's tables (the sampler's per-epoch tables in visit
    order), with the visit order, the packed rows and the negatives."""
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.ops import bpr_epoch as BE
    from mymedialite_tpu_torch.ops import bpr_plan as BP
    fb = posonly_from_ratings(synthetic_ratings(40, 48, 900, seed=3))
    kw = dict(uniform_user=True, shuffle_seed=4, item_block=16,
              user_block=16)
    if tiled:
        plan, state, meta = BP.prepare_bpr_mxu(
            fb, chunk=None, kcap=128, subkeys=True, ksub_cap=64,
            bitmask=False, chunk_overhead=8, **kw)
        B, S, slab_items = BP.bpr_tiled_plan(plan, state["nvalid"],
                                             slab_blocks=1)
        order = BP.bpr_tiled_epoch_order(
            plan, state["nvalid"], slab_items, slab_blocks=B, num_slabs=S,
            num_items=meta[3], seed=seed)
        ib = order[2] * B + order[1]
        jb, row = order[3], order[8]
    else:
        plan, state, meta = BP.prepare_bpr_mxu(fb, chunk=32, bitmask=True,
                                               **kw)
        order = plan.epoch_order(seed)
        neg_plan = BP.epoch_negative_plan(
            plan, state["nvalid"], order[0].numpy(), meta[3], seed + 1)
        ib, row, jb = order[1], order[2], neg_plan[0]
    gen = torch.Generator().manual_seed(seed)
    bits = torch.randint(0, 2 ** 31, (plan.num_chunks, meta[2], plan.chunk),
                         dtype=torch.int32, generator=gen)
    rates = BP.bpr_mxu_column_rates(8, 16, 0.05, 0.0025, 0.0025, 0.00025,
                                    0.0, True)
    W = 0.1 * torch.randn((plan.u_pad, 16), generator=gen)
    H = 0.1 * torch.randn((plan.i_pad, 16), generator=gen)
    if tiled:
        _, _, neg = BE.bpr_epoch_tiled_reference(
            W, H, plan.packed, state["subkeys_tbl"], state["cdf_tbl"], bits,
            order, rates, slab_blocks=B, user_block=plan.user_block,
            item_block=plan.item_block, subkeys=True, return_negatives=True)
    else:
        _, _, neg = BE.bpr_epoch_reference(
            W, H, plan.packed, state["keys_tbl"], state["cdf_tbl"], bits,
            order, *neg_plan, rates, user_block=plan.user_block,
            item_block=plan.item_block, bitmask_tbl=state["bitmask_tbl"],
            return_negatives=True)
    packed_rows = plan.packed[row.long()]
    lists, tables = SG.bpr_segments_reference(
        packed_rows, neg, ib, jb, item_block=plan.item_block, lists=True)
    return plan, lists, tables, packed_rows, neg, ib.long(), jb.long()


def bpr_rows_live(packed_rows, neg, ib, jb, IB, k):
    """Entry rows (W u_loc; H absolute rows of i, then j) and liveness of
    visited chunk k, entry index = the table's id (W 0..C-1, H C + id)."""
    p, ng = packed_rows[k], neg[k]
    i_abs = ib[k] * IB + p[1].long()
    j_abs = jb[k] * IB + ng[0].long()
    live = (p[2].view(torch.float32) * p[3].view(torch.float32)
            * ng[1].view(torch.float32)) != 0
    rows = torch.cat([p[0].long(), i_abs, j_abs]).numpy()
    return rows, np.tile(live.numpy(), 3)


@pytest.mark.parametrize("tiled", [False, True])
def test_bpr_tables_hold_every_live_slot_once_i_before_j(tiled):
    plan, lists, tables, packed_rows, neg, ib, jb = bpr_epoch_tables(tiled)
    C, IB = plan.chunk, plan.item_block
    RL = SG.runs_length(3 * C)
    assert torch.equal(SG.bpr_segments_reference(
        packed_rows, neg, ib, jb, item_block=IB), tables)
    assert tuple(tables.shape) == (packed_rows.shape[0],
                                   SG.table_width(C, 3 * C, 3))
    s = np.arange(C)
    # entry index: W slot s at s, H i of slot s at C + s, j at 2C + s;
    # table 1's ids are i: s, j: C + s, so index_of(1, id) = C + id
    check_tables(lists, tables,
                 lambda k: bpr_rows_live(packed_rows, neg, ib, jb, IB, k)[0],
                 lambda k: bpr_rows_live(packed_rows, neg, ib, jb, IB, k)[1],
                 np.r_[np.zeros(C, int), np.ones(C, int), 2 * np.ones(C, int)],
                 np.r_[s, s, s], C)
    # failed samples (ok = 0) leave their slot out of every table
    failed = (neg[:, 1] == 0) & (packed_rows[:, 3].view(torch.float32) != 0)
    if failed.any():
        k = int(torch.nonzero(failed)[0, 0])
        slot = int(torch.nonzero(failed[k])[0, 0])
        entries, _, _ = decoded(lists[k], tables[k], RL)
        assert all((i % C if t else i) != slot for i, t, _ in entries)
    if tiled:
        # the tiled order's chunks whose two blocks meet hold runs that mix
        # i and j entries, i first
        mixed = 0
        for k in torch.nonzero(ib == jb)[:, 0].tolist():
            entries, _, _ = decoded(lists[k], tables[k], RL)
            runs, cur = [], None
            for i, t, start in entries:
                if start:
                    cur = []
                    runs.append((t, cur))
                cur.append(i)
            for t, ids in runs:
                if t == 1 and min(ids) < C <= max(ids):
                    mixed += 1
                    assert ids == sorted(ids)
        assert mixed > 0


def test_bpr_tables_key_rows_absolutely_across_two_blocks():
    """Two chunks of one user block: the positive and negative blocks
    equal (rows meet) and apart (they never do, whatever their local
    ids)."""
    C, IB = 8, 4
    f32 = torch.tensor([1.0]).view(torch.int32)[0]
    packed = torch.zeros((2, 4, C), dtype=torch.int32)
    packed[:, 0] = torch.tensor([0, 1, 0, 2, 1, 0, 3, 3])
    packed[:, 1] = torch.tensor([1, 1, 2, 3, 0, 1, 2, 2])
    packed[:, 2:] = f32
    neg = torch.zeros((2, 2, C), dtype=torch.int32)
    neg[:, 0] = torch.tensor([2, 3, 1, 1, 2, 0, 1, 3])
    neg[:, 1] = f32
    neg[1, 1, 5] = 0                                   # a failed sample
    lists, tables = SG.bpr_segments_reference(
        packed, neg, torch.tensor([3, 3]), torch.tensor([3, 5]),
        item_block=IB, lists=True)
    RL = SG.runs_length(3 * C)
    runs = []
    for k in range(2):
        entries, _, _ = decoded(lists[k], tables[k], RL)
        h = [(i, start) for i, t, start in entries if t == 1]
        runs.append(sum(s for _, s in h))
    # chunk 0: rows 0, 1, 2, 3 of block 3 (i and j meet); chunk 1: i rows
    # 0, 1, 2, 3 of block 3, j rows 1, 2, 3 of block 5 apart (its slot 5
    # failed: no entry)
    assert runs == [4, 7]
    entries, _, _ = decoded(lists[0], tables[0], RL)
    row1 = [i for i, t, _ in entries if t == 1 and
            (packed[0, 1, i] if i < C else neg[0, 0, i - C]) == 1]
    assert row1 == [0, 1, 5, C + 2, C + 3, C + 6]      # i slots, then j
    entries, _, _ = decoded(lists[1], tables[1], RL)
    assert all(i != 5 and i != C + 5 for i, t, _ in entries)


def test_owner_order_equals_index_add_bit_for_bit():
    """Chunks of 2-24 slots over 1-6 rows a side (duplicate-heavy), up
    to half of the slots of weight 0, from 60 fixed seeds: each table's
    owner sums equal ``index_add_`` of its live slots on the CPU, bit for
    bit (float32 deltas of mixed magnitudes, so the order of a sum shows
    in its bits)."""
    for seed in range(60):
        rng = np.random.default_rng(seed)
        C, n_rows = int(rng.integers(2, 25)), int(rng.integers(1, 7))
        owner_order_case(rng, C, n_rows, rng.uniform(0.0, 0.5))


def owner_order_case(rng, C, n_rows, p_dead):
    u = rng.integers(0, n_rows, C)
    i = rng.integers(0, n_rows, C)
    w = np.where(rng.random(C) < p_dead, 0.0, 1.0).astype(np.float32)
    packed = torch.zeros((1, 4, C), dtype=torch.int32)
    packed[0, 0] = torch.from_numpy(u.astype(np.int32))
    packed[0, 1] = torch.from_numpy(i.astype(np.int32))
    packed[0, 3] = torch.from_numpy(w).view(torch.int32)
    seg = SG.chunk_segments(packed, lists=True)[0][0]
    live = torch.from_numpy(w != 0)
    for side, rows in ((0, u), (1, i)):
        table = torch.from_numpy(rng.standard_normal((n_rows, 3))
                                 .astype(np.float32))
        delta = torch.from_numpy((rng.standard_normal((C, 3)) * 10.0 **
                                  rng.integers(-6, 3, (C, 1)))
                                 .astype(np.float32))
        r = torch.from_numpy(rows)
        want = table.clone().index_add_(0, r[live], delta[live])
        got = SG.owner_scatter_reference(table.clone(), r, delta, seg,
                                         side=side)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_owner_order_of_the_bpr_item_table():
    """The BPR item table: H.index_add_ at i, then at j (the plain
    epoch's order) equals the owner sums over the table's runs, bit for
    bit, where i and j rows meet (one block) and where they do not:
    chunks of 2-16 slots on blocks of 1-5 rows from 40 fixed seeds."""
    for seed in range(40):
        rng = np.random.default_rng(seed)
        bpr_order_case(rng, int(rng.integers(2, 17)),
                       int(rng.integers(1, 6)), seed % 2 == 0)


def bpr_order_case(rng, C, n_rows, meet):
    IB = n_rows
    f32 = torch.tensor([1.0]).view(torch.int32)[0]
    packed = torch.zeros((1, 4, C), dtype=torch.int32)
    packed[0, 1] = torch.from_numpy(rng.integers(0, IB, C).astype(np.int32))
    packed[0, 2:] = f32
    neg = torch.zeros((1, 2, C), dtype=torch.int32)
    neg[0, 0] = torch.from_numpy(rng.integers(0, IB, C).astype(np.int32))
    ok = rng.random(C) < 0.8
    neg[0, 1] = torch.from_numpy(np.where(ok, 1.0, 0.0).astype(np.float32)) \
        .view(torch.int32)
    ib, jb = 1, 1 if meet else 2
    seg = SG.bpr_segments_reference(packed, neg, torch.tensor([ib]),
                                    torch.tensor([jb]), item_block=IB,
                                    lists=True)[0][0]
    H = torch.from_numpy(rng.standard_normal((3 * IB, 2)).astype(np.float32))
    d = torch.from_numpy((rng.standard_normal((2 * C, 2)) * 10.0 **
                          rng.integers(-6, 3, (2 * C, 1))).astype(np.float32))
    i_abs = ib * IB + packed[0, 1].long()
    j_abs = jb * IB + neg[0, 0].long()
    live = torch.from_numpy(ok)
    want = H.clone().index_add_(0, i_abs[live], d[:C][live]) \
        .index_add_(0, j_abs[live], d[C:][live])
    got = SG.owner_scatter_reference(H.clone(), torch.cat([i_abs, j_abs]), d,
                                     seg, side=1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# --- every plain training route reaches add_rows ----------------------------


@pytest.fixture
def counted(monkeypatch):
    """Count add_rows calls through every module that binds it."""
    from mymedialite_tpu_torch.models import slim, time_aware
    from mymedialite_tpu_torch.ops import bpr, sgd, svdpp
    calls = collections.Counter()
    real = sgd.add_rows

    def counting(table, ids, delta):
        calls["add_rows"] += 1
        return real(table, ids, delta)
    for mod in (sgd, bpr, svdpp, slim, time_aware):
        monkeypatch.setattr(mod, "add_rows", counting)
    return calls


def _gen():
    return torch.Generator().manual_seed(0)


def _on(device, *tensors):
    return tuple(t.to(device) for t in tensors)


def route_bpr_minibatch(device="cpu"):
    from mymedialite_tpu_torch.ops import bpr
    g = _gen()
    params = dict(zip(("user_factors", "item_factors", "item_bias"), _on(
        device, torch.randn((50, 8), generator=g),
        torch.randn((30, 8), generator=g), torch.randn(30, generator=g))))
    hp = dict(learn_rate=0.05, reg_u=0.01, reg_i=0.01, reg_j=0.01,
              bias_reg=0.1)
    u, i, j = _on(device, *(torch.randint(0, n, (4096,), generator=g)
                            for n in (50, 30, 30)))
    bpr.bpr_step(params, u, i, j, torch.ones(4096, device=device), hp,
                 update_j=True)
    return tuple(params.values())


def route_bpr_sharded(device="cpu"):
    from mymedialite_tpu_torch.ops import bpr
    g = _gen()
    W, H, bias = _on(device, torch.randn((50, 8), generator=g),
                     torch.randn((30, 8), generator=g),
                     torch.randn(30, generator=g))
    hp = dict(learn_rate=0.05, reg_u=0.01, reg_i=0.01, reg_j=0.01,
              bias_reg=0.1)
    u, i, j = _on(device, *(torch.randint(0, n, (4096,), generator=g)
                            for n in (50, 30, 30)))
    rows, dH, db = bpr._device_update(
        W, H, bias, u, i, j, torch.ones(4096, device=device), hp,
        update_j=True, soft_margin=False)
    return W, rows, dH, db


def _svdpp_inputs(device, pad=1):
    from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
    from mymedialite_tpu_torch.ops import svdpp as SV
    d = synthetic_ratings(12, 10, 80, seed=2)
    hu, hi = SV.history_edges(d.users, d.items, 10)
    groups = SV.prepare_groups(d.users, d.items, d.values, hu, hi, 12, 4,
                               device=device, pad_groups_multiple=pad)
    g = _gen()
    params = dict(zip(("user_bias", "item_bias", "item_factors", "y", "p"),
                      _on(device, torch.zeros(12), torch.zeros(10),
                          0.1 * torch.randn((10, 3), generator=g),
                          0.1 * torch.randn((10, 3), generator=g),
                          0.1 * torch.randn((12, 3), generator=g))))
    inv = torch.from_numpy(SV.inv_sqrt_counts(hu, 12)).to(device)
    hp = dict(global_bias=3.5, learn_rate=0.01, bias_learn_rate=1.0,
              bias_reg=0.1, min_rating=1.0, rating_range=4.0)
    regs = dict(zip(("user_reg", "item_reg", "y_reg"), _on(
        device, torch.full((12,), 0.01), torch.full((10,), 0.01),
        torch.full((10,), 0.01))))
    return params, groups, inv, hp, regs


def route_svdpp_grouped(device="cpu"):
    from mymedialite_tpu_torch.ops import svdpp as SV
    params = SV.svdpp_epoch_grouped(*_svdpp_inputs(device), loss=0,
                                    sigmoid=False, use_p=True)
    return tuple(params.values())


def route_svdpp_sharded(device="cpu"):
    from mymedialite_tpu_torch.ops import svdpp as SV
    from mymedialite_tpu_torch.parallel.mesh import make_mesh
    inputs = _svdpp_inputs(device, pad=2)
    SV.svdpp_epoch_sharded(make_mesh(devices=[str(device)] * 2), *inputs,
                           loss=0, sigmoid=False, use_p=True)
    return tuple(inputs[0].values())


def route_social_mf(device="cpu"):
    from mymedialite_tpu_torch.models import social_mf as SM
    g = _gen()
    W, H = _on(device, torch.randn((40, 5), generator=g),
               torch.randn((16, 5), generator=g))
    data = dict(zip(("users", "items", "values"), _on(
        device, torch.randint(0, 40, (3000,), generator=g),
        torch.randint(0, 16, (3000,), generator=g),
        torch.randint(1, 6, (3000,), generator=g).float())))
    trust = SM.trust_matrices([0, 1, 5], [1, 3, 7], 40, device)
    hp = collections.defaultdict(lambda: 0.01, global_bias=0.5,
                                 min_rating=1.0, rating_range=4.0)
    return SM.social_mf_step(W, H, data, trust, hp, num_users=40,
                             num_factors=3, loss=0)


def route_time_aware(device="cpu"):
    from mymedialite_tpu_torch.models import time_aware as TA
    g = _gen()
    U, I, nd, nb, nf, n = 30, 20, 5, 2, 3, 3000
    p = dict(zip(("alpha", "user_bias", "user_bias_by_day", "item_bias",
                  "item_bias_by_time_bin", "user_scaling",
                  "user_scaling_by_day", "item_bias_at_frequency"),
                 _on(device, torch.zeros(U), torch.zeros(U),
                     torch.zeros((U, nd)), torch.zeros(I),
                     torch.zeros((I, nb)), torch.ones(U),
                     torch.zeros((U, nd)), torch.zeros((I, nf)))))
    batch = dict(zip(("users", "items", "values", "weights", "days", "bins",
                      "dev", "freqs"), _on(
        device, torch.randint(0, U, (n,), generator=g),
        torch.randint(0, I, (n,), generator=g),
        torch.randint(1, 6, (n,), generator=g).float(), torch.ones(n),
        torch.randint(0, nd, (n,), generator=g),
        torch.randint(0, nb, (n,), generator=g), torch.randn(n, generator=g),
        torch.randint(0, nf, (n,), generator=g))))
    hp = collections.defaultdict(lambda: 0.01, global_average=3.5)
    TA.time_aware_step(p, batch, hp, with_freq=True)
    return tuple(p.values())


def route_bpr_slim(device="cpu"):
    from mymedialite_tpu_torch.models import slim
    g = _gen()
    W = torch.randn((12, 12), generator=g).to(device)
    hist = torch.randint(0, 12, (40, 6), generator=g, dtype=torch.int32)
    u, i, j = (torch.randint(0, n, (512,), generator=g) for n in (40, 12, 12))
    slim.bpr_slim_step(W, *_on(device, hist, torch.full((40,), 6), u, i, j,
                               torch.ones(512)),
                       0.1, 0.01, 0.01, update_j=True)
    return (W,)


# the plain training routes that scatter through add_rows (the card tests
# run them twice and hold the tables equal)
ROUTES = [route_bpr_minibatch, route_bpr_sharded, route_svdpp_grouped,
          route_svdpp_sharded, route_social_mf, route_time_aware,
          route_bpr_slim]


@pytest.mark.parametrize("route", ROUTES,
                         ids=lambda f: f.__name__[len("route_"):])
def test_plain_route_scatters_through_add_rows(counted, route):
    route()
    assert counted["add_rows"] > 0
