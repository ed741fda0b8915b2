"""Segment tables of the epoch kernels' owner scatter.

Epoch kernels 1-5 (``csrc/{sgd,bpr,svdpp}_epoch.cu``) add a chunk's
duplicate rows without atomics: one group of lanes owns each run of
equal rows and adds the run's deltas in a fixed order, so that two runs
of one seed give the same tables bit for bit
(``csrc/owner_scatter.cuh``). The order is the plain versions'
``index_add_`` on the CPU: a table's deltas in slot order, and in the BPR
item table every i delta of a row before its j deltas.

A chunk's entries (M of them: its slots once a table, and in the BPR
item table its sampled j too) make its list: the live entries sorted by
(table, row, entry id), each ``id | table << 14 | start << 15`` (start:
the first entry of a run of one row). The table is built from the list
and does not store it: one int16 row ``[RL + T * Cw]``:

- the runs ``[RL]`` (RL = 4 + 3 (M // 2), rounded up to 8): the count of
  runs of two or more entries of table 0 and of table 1, the count of
  entries in those runs in table 0 and in table 1, then each run's first
  list entry, its first entry's compact index and its length, in list
  order, then 0. An entry in a run of two or more has a compact index:
  its rank among such entries in list order (the kernels keep those
  entries' values there, a run's in a row);
- the codes ``[T, Cw]`` (C rounded up to 8) by kind table t and slot:
  0xFFFF for a slot alone in its run (or of weight 0), else its entry's
  compact index, with bit 15 set where it starts its run.

With ``lists=True`` the builders also return the lists ``[L]`` (L = M
rounded up to 8, padded with ``DEAD``, -1 or 0xFFFF), which only the
plain owner order (``owner_scatter_reference``) and the tests read.

``chunk_segments`` builds the table of a rating-style plan (MF, SVD++:
table 0 the user rows ``u_loc``, table 1 the item rows ``i_loc``, a slot
live where its weight is not 0; T = 2) on the plan's device, once per
``packed`` tensor (``segments_of`` caches it). ``bpr_segments_reference``
is the plain version of the BPR sampler's per-epoch tables (table 0 W,
table 1 H, whose i entries have ids 0..C-1 and j entries C..2C-1; kind
tables 0 W, 1 i, 2 j: T = 3), which the kernel builds on the card after
sampling.
"""

from __future__ import annotations

import torch

from mymedialite_tpu_torch import trace

DEAD = -1
START = 0x8000
ID_MASK = 0x3FFF
_DEAD_KEY = torch.iinfo(torch.int64).max
# chunks per sort: bounds the int64 keys' memory
_SLICE = 4096


def round8(n: int) -> int:
    return (n + 7) // 8 * 8


def runs_length(entries: int) -> int:
    """RL: the runs block of a table of ``entries`` list entries."""
    return round8(4 + 3 * (entries // 2))


def table_width(chunk: int, entries: int, kinds: int) -> int:
    """RL + T * Cw: a chunk's table row."""
    return runs_length(entries) + kinds * round8(chunk)


def _int16(t):
    return torch.where(t >= 0x8000, t - 0x10000, t).to(torch.int16)


def _tables(row, live, table, ids, kind_t, slot, chunk: int, kinds: int):
    """The lists [n, L] and tables [n, RL + T Cw] of a slice of chunks:
    ``row`` [n, M] int64 (>= 0) and ``live`` [n, M] bool per entry;
    ``table``, ``ids``, ``kind_t`` and ``slot`` [M] int64, the same for
    every chunk."""
    n, M = row.shape
    L, RL, Cw = round8(M), runs_length(M), round8(chunk)
    dev = row.device
    pos = torch.arange(M, device=dev)
    key = (table << 62) | (row << 20) | ids
    key = torch.where(live, key, torch.full_like(key, _DEAD_KEY))
    key, order = torch.sort(key, dim=1)
    alive = key != _DEAD_KEY
    rk = key >> 20
    start = alive.clone()
    start[:, 1:] &= rk[:, 1:] != rk[:, :-1]
    # a run's length: the next start (or the end of the live entries)
    # less its own position, by a reversed running minimum
    nxt = torch.where(start | ~alive, pos, torch.full_like(pos, M))
    nxt = torch.cat([nxt[:, 1:], torch.full_like(nxt[:, :1], M)], dim=1)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values, [1])
    single = start & (nxt - pos == 1)
    multi = alive & ~(start & single)               # in a run of two or more
    side = key >> 62
    entry = (key & 0xFFFFF) | (side << 14) | (start.long() << 15)
    entry = torch.where(alive, entry, torch.full_like(entry, 0xFFFF))
    compact = torch.cumsum(multi.long(), dim=1) - 1
    lists = torch.full((n, L), 0xFFFF, dtype=torch.int64, device=dev)
    lists[:, :M] = entry
    out = torch.zeros((n, RL + kinds * Cw), dtype=torch.int64, device=dev)
    # the runs: counts, then (first entry, its compact index, length) in
    # list order, gathered by a stable sort of the runs' starts
    first = start & multi
    out[:, 0] = (first & (side == 0)).sum(1)
    out[:, 1] = (first & (side == 1)).sum(1)
    out[:, 2] = (multi & (side == 0)).sum(1)
    out[:, 3] = (multi & (side == 1)).sum(1)
    at = torch.sort(torch.where(first, pos, torch.full_like(pos, M)),
                    dim=1).values[:, :M // 2]
    has = at < M
    atc = at.clamp(max=M - 1)
    for j, vals in enumerate((entry.gather(1, atc), compact.gather(1, atc),
                              nxt.gather(1, atc) - at)):
        out[:, 4 + j:4 + 3 * at.shape[1]:3] = vals * has
    # the codes: per (kind table, slot), 0xFFFF unless in a run of two or
    # more, then the compact index and the start bit
    code = torch.where(multi, compact | (start.long() << 15),
                       torch.full_like(compact, 0xFFFF))
    codes = torch.full((n, kinds * Cw + 1), 0xFFFF, dtype=torch.int64,
                       device=dev)                  # the last: dead entries
    t = kind_t[order]
    codes.scatter_(1, torch.where(alive, t * Cw + slot[order],
                                  torch.full_like(t, kinds * Cw)), code)
    out[:, RL:] = codes[:, :-1]
    return _int16(lists), _int16(out)


def _joined(parts, lists, widths, dev):
    """The slices' tables (with ``lists``, their lists and tables): each
    part is (lists, tables), or (tables,) where the lists were dropped."""
    if not parts:
        parts = [tuple(torch.zeros((0, w), dtype=torch.int16, device=dev)
                       for w in widths)]
    got = tuple(torch.cat(p) for p in zip(*parts))
    return got if lists else got[-1]


def chunk_segments(packed, *, lists: bool = False):
    """The segment tables [nc, table_width(C, 2C, 2)] int16 of a
    rating-style plan's ``packed`` [nc, 4, C] (rows u_loc, i_loc, value
    bits, weight bits), on its device: table 0 by u_loc, table 1 by i_loc,
    entry id = slot. With ``lists``, (the lists [nc, round8(2C)], the
    tables)."""
    nc, _, C = packed.shape
    dev = packed.device
    s = torch.arange(C, device=dev)
    table = torch.cat([torch.zeros_like(s), torch.ones_like(s)])
    ids = torch.cat([s, s])
    parts = []
    for k0 in range(0, nc, _SLICE):
        p = packed[k0:k0 + _SLICE]
        live = p[:, 3].view(torch.float32) != 0
        row = torch.cat([p[:, 0], p[:, 1]], dim=1).long()
        got = _tables(row, torch.cat([live, live], dim=1), table, ids,
                      table, ids, C, 2)
        parts.append(got if lists else got[1:])
    return _joined(parts, lists, (round8(2 * C), table_width(C, 2 * C, 2)),
                   dev)


_CACHE = None


def segments_of(packed):
    """``chunk_segments(packed)``, built once per ``packed`` tensor (and
    again if it is changed in place): the chunks are fixed for a fit, and
    an epoch order only reorders whole chunks."""
    global _CACHE
    if _CACHE is None:
        from torch.utils.weak import WeakTensorKeyDictionary
        _CACHE = WeakTensorKeyDictionary()
    hit = _CACHE.get(packed)
    if hit is None or hit[0] != packed._version:
        with trace.span("kernel.segments"):
            hit = (packed._version, chunk_segments(packed))
        _CACHE[packed] = hit
    return hit[1]


def bpr_segments_reference(packed_rows, neg, ib, jb, *, item_block: int,
                           lists: bool = False):
    """The BPR sampler's tables [nc, table_width(C, 3C, 3)] int16 in visit
    order (with ``lists``, (the lists [nc, round8(3C)], the tables)): ``packed_rows`` [nc, 4, C] (each visited chunk's
    packed row: u_loc, i_loc, base weight bits, pad weight bits), ``neg``
    [nc, 2, C] (j_loc, ok bits), ``ib`` / ``jb`` [nc] the absolute
    positive and negative item blocks. A slot is live where base * pad *
    ok is not 0; an H entry's row is its absolute row, relative to the
    lower of the chunk's two blocks (so i and j rows that meet share a
    run)."""
    nc, _, C = packed_rows.shape
    dev = packed_rows.device
    s = torch.arange(C, device=dev)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    table = torch.cat([zero, one, one])
    ids = torch.cat([s, s, s + C])
    kind_t = torch.cat([zero, one, 2 * one])
    slot = torch.cat([s, s, s])
    IB = item_block
    parts = []
    for k0 in range(0, nc, _SLICE):
        p, ng = packed_rows[k0:k0 + _SLICE], neg[k0:k0 + _SLICE]
        ibk, jbk = ib[k0:k0 + _SLICE].long(), jb[k0:k0 + _SLICE].long()
        lo = torch.minimum(ibk, jbk)[:, None]
        wgt = p[:, 2].view(torch.float32) * p[:, 3].view(torch.float32) * \
            ng[:, 1].view(torch.float32)
        live = wgt != 0
        rel_i = torch.where(ibk[:, None] == lo, 0, IB) + p[:, 1].long()
        rel_j = torch.where(jbk[:, None] == lo, 0, IB) + ng[:, 0].long()
        row = torch.cat([p[:, 0].long(), rel_i, rel_j], dim=1)
        got = _tables(row, torch.cat([live, live, live], dim=1), table, ids,
                      kind_t, slot, C, 3)
        parts.append(got if lists else got[1:])
    return _joined(parts, lists, (round8(3 * C), table_width(C, 3 * C, 3)),
                   dev)


def owner_scatter_reference(table, rows, delta, segments, *, side: int):
    """The owner order on the host, as the kernels sum one chunk's table
    ``side``: for each run of the list, row + its deltas in list order,
    stored once. ``rows`` [M] are the table rows of entry ids 0..M-1,
    ``delta`` [M, ...] their deltas, ``segments`` one chunk's int16 list
    (``chunk_segments`` / ``bpr_segments_reference`` with ``lists``).
    In place; returns ``table``. On the CPU it equals ``index_add_`` of
    the live entries bit for bit (``tests/test_torch_scatter_order.py``)."""
    seg = segments.long() & 0xFFFF
    acc, row = None, None
    for e in seg.tolist():
        if e == 0xFFFF:
            break
        if (e >> 14) & 1 != side:
            continue
        r = int(rows[e & ID_MASK])
        if e & START:
            if acc is not None:
                table[row] = acc
            acc, row = table[r].clone(), r
        acc = acc + delta[e & ID_MASK]
    if acc is not None:
        table[row] = acc
    return table
