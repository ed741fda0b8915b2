"""Chunk plan and negative-sampling state for the BPR epoch kernels.

Port of the host-side half of ``mymedialite_tpu/ops/pallas_bpr.py``
(``prepare_bpr_mxu``, ``epoch_negative_plan``, ``bpr_tiled_plan``,
``bpr_tiled_epoch_order``, ``bpr_mxu_column_rates``,
``bpr_tables_to_mxu`` / ``bpr_tables_from_mxu``). The positive events are bucketed like ratings
(``ops/plan.py prepare_mxu_data``); row 2 of ``packed`` carries the
per-event base weight (the uniform-user importance weight, or 1) and
row 3 the padding weight (1 real, 0 pad). The outputs are bit-identical
to the JAX package's for the same inputs; the tables live on a torch
device.

Negative sampling state (see ``ops/bpr_epoch.py`` for how the epoch
uses it):

- ``keys_tbl`` [round8(n_bkt), Kcap] int32: per (user block, item
  block) bucket, the unique keys ``u_loc * IB + i_loc`` of its events,
  ascending, -1 padded at the end (truncated at ``kcap`` when given);
- ``subkeys_tbl`` [n_bkt * 8, Ksub] int32 (``subkeys=True``, the tiled
  sampler's table): each bucket's keys split into 8 sub-buckets by
  ``u_loc & 7``, each row ascending and -1 padded, so a slot tests only
  the keys of users that share its ``u_loc & 7``;
- ``bitmask_tbl`` [n_bkt, UB, IB/8] int8 (when it fits 2 GiB): the same
  predicate as packed bits, bit ``i_loc & 7`` of byte ``i_loc >> 3``;
- ``cdf_tbl`` [round8(n_ib), IB] float32: per item block the popularity
  CDF over its local slots (padding slots 1.0), nondecreasing;
- ``nvalid`` [n_ib] and ``block_mass`` [n_ib] on the host.

Big catalogs (past ``plan.RESIDENT_ITEM_TABLE_BYTES``) take the
slab-tiled schedule: ``bpr_tiled_plan`` groups the item blocks into
slabs and ``bpr_tiled_epoch_order`` draws each epoch's visit order and
negative blocks, array for array the JAX package's, without its pad
entries, pass split and refetch flags (TPU-only: they bound scalar
memory and stand in for buffer aliasing under interpret mode).

On a device mesh, ``prepare_bpr_mxu_sharded`` / ``_tiled`` group the
chunks into the DSGD cells (``plan.shard_plan``) and
``bpr_sharded_epoch_order`` / ``bpr_sharded_tiled_epoch_order`` draw
each epoch's order and negative blocks within the partition a device
holds, equal to the JAX package's ``[D, D, nc_pad]`` arrays
(``pallas_bpr.py:1421-1475``, ``:1715-1795``); the membership and CDF
tables stay global.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mymedialite_tpu_torch.ops.plan import (  # noqa: F401  (re-exported)
    MxuPlan, MxuShardedPlan, MxuShardedTiledPlan, _round_up, mxu_supported,
    prepare_mxu_data, shard_plan,
)

BITMASK_HBM_BYTES = 2 * 1024 ** 3
# sub-buckets per (user block, item block) bucket, split by u_loc & 7
SUBKEY_BUCKETS = 8
# the bound on the expected fraction of corrupted triples (a truncated
# positive drawn as a negative) below which key tables may be capped
MAX_KEY_CORRUPTION = 1e-3


def prepare_bpr_mxu(feedback, *, uniform_user: bool, user_block: int = 512,
                    item_block: int = 1024, chunk=640, shuffle_seed=0,
                    num_neg_trials: int = 8, kcap=None,
                    chunk_overhead: int = 0, bitmask="auto",
                    subkeys: bool = False, ksub_cap=None, device="cpu"):
    """Bucket the positive events and build the negative-sampling state.

    ``chunk=None`` picks the histogram-optimal chunk with
    ``chunk_overhead`` slots of fixed cost per chunk. ``kcap`` caps the
    flat key rows (keys past it are dropped; a warning names the
    expected corrupted-triple rate when it passes 1e-3). ``subkeys``
    also builds the sub-bucketed table, its rows capped at ``ksub_cap``
    and the cap doubled until the corrupted-triple rate is at most 1e-3.

    Returns (plan, neg_state, neg_meta) as the JAX function does:
    ``plan.packed`` on ``device``, ``neg_state`` with the tables above on
    ``device`` (``bitmask_tbl`` only when built, ``subkeys_tbl`` and
    ``ksub`` only with ``subkeys``), ``neg_meta`` = (n_ib, Kcap,
    num_neg_trials, num_items, IB)."""
    users = np.asarray(feedback.users, dtype=np.int32)
    items = np.asarray(feedback.items, dtype=np.int32)
    U, I = feedback.num_users, feedback.num_items
    counts = np.asarray(feedback.count_by_user)

    if uniform_user:
        # importance weight |events| / (n_valid * |I_u|): the expected
        # visits of event (u, i) in one uniform-user epoch
        valid = (counts > 0) & (counts < I)
        n_valid = max(int(valid.sum()), 1)
        w_user = np.where(valid, len(users) / (n_valid *
                                               np.maximum(counts, 1.0)), 0.0)
        weights = w_user[users].astype(np.float32)
    else:
        weights = np.ones(len(users), np.float32)

    # built on the host: the membership tables read the packed chunks
    plan = prepare_mxu_data(users, items, weights, U, I,
                            user_block=user_block, item_block=item_block,
                            chunk=chunk, shuffle_seed=shuffle_seed,
                            chunk_overhead=chunk_overhead, device="cpu")
    n_ib, IB, UB = plan.n_iblocks, plan.item_block, plan.user_block
    # real items per block: the popularity round robin fills block b's
    # first nvalid_b slots
    b_of_new = np.arange(plan.i_pad) // IB
    nvalid = np.bincount(b_of_new, weights=(plan.old_of_new >= 0),
                         minlength=n_ib).astype(np.int32)

    packed = plan.packed.numpy()                          # [nc, 4, C]
    u_loc, i_loc = packed[:, 0], packed[:, 1]
    real = packed[:, 3].view(np.float32) > 0
    bkt_c = plan.ub_c.astype(np.int64) * n_ib + plan.ib_c
    n_bkt = plan.n_ublocks * n_ib
    keys = (u_loc.astype(np.int64) * IB + i_loc)[real].astype(np.int32)
    bkt_raw = np.broadcast_to(bkt_c[:, None], u_loc.shape)[real]
    # membership is a set test: one key per distinct (bucket, key), in
    # np.unique's order. One sort and a mask: np.unique hashes before it
    # sorts since numpy 2.3, several times slower on 10^7 keys
    uniq = np.sort(bkt_raw * (UB * IB) + keys)
    uniq = uniq[np.r_[True, uniq[1:] != uniq[:-1]]]
    bkt_r = uniq // (UB * IB)
    keys = (uniq % (UB * IB)).astype(np.int32)
    cnt = np.bincount(bkt_r, minlength=n_bkt)
    Kcap = _round_up(max(int(cnt.max()) if cnt.size else 1, 1), 128)
    if kcap is not None and Kcap > kcap:
        Kcap = _round_up(kcap, 128)
    # uniq is sorted, so each bucket's keys are one ascending run
    within = np.arange(keys.size) - np.concatenate([[0], np.cumsum(cnt)])[bkt_r]
    keep = within < Kcap
    keys_tbl = np.full((_round_up(n_bkt, 8), Kcap), -1, np.int32)
    keys_tbl[bkt_r[keep], within[keep]] = keys[keep]

    def corruption_rate(dropped_keys, dropped_bkt):
        """Expected fraction of triples whose negative is a dropped key:
        sum over users of |events_u| * dropped(u) / (|events| * I)."""
        if dropped_keys.size == 0:
            return 0.0
        g_user = (dropped_bkt // n_ib) * UB + dropped_keys // IB
        du = np.bincount(g_user, minlength=max(U, 1))
        ev = np.zeros(max(U, 1), np.float64)
        ev[:counts.shape[0]] = counts
        return float((ev * du[:ev.shape[0]]).sum()) / (
            max(len(users), 1) * max(I, 1))

    dropped = 1.0 - float(keep.sum()) / max(keys.size, 1)
    corrupt = corruption_rate(keys[~keep], bkt_r[~keep])
    if corrupt > MAX_KEY_CORRUPTION and not subkeys:
        import warnings
        warnings.warn(
            f"prepare_bpr_mxu: membership-key cap Kcap={Kcap} drops "
            f"{dropped:.2%} of unique keys; estimated corrupted-triple "
            f"rate {corrupt:.2e} exceeds 1e-3 — raise kcap",
            RuntimeWarning)

    # per-block popularity CDF over local slots; padding slots get 1.0 so
    # the inverse CDF never lands on them
    cnt_new = np.zeros(plan.i_pad, np.float64)
    valid_slots = plan.old_of_new >= 0
    cnt_new[valid_slots] = np.asarray(feedback.count_by_item,
                                      dtype=np.float64)[
        plan.old_of_new[valid_slots]]
    cnt_blk = cnt_new.reshape(n_ib, IB)
    block_mass = cnt_blk.sum(axis=1)
    cdf = np.ones((_round_up(n_ib, 8), IB), np.float32)
    nz = block_mass > 0
    cdf[:n_ib][nz] = (np.cumsum(cnt_blk[nz], axis=1)
                      / block_mass[nz, None]).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    neg_state = dict(keys_tbl=dev(keys_tbl), nvalid=nvalid,
                     cdf_tbl=dev(cdf), block_mass=block_mass,
                     key_truncation=dropped, key_corruption=corrupt)
    if subkeys:
        S = SUBKEY_BUCKETS
        skey = bkt_r * S + ((keys // IB) & (S - 1))
        scnt = np.bincount(skey, minlength=n_bkt * S)
        Kmax = _round_up(max(int(scnt.max()) if scnt.size else 1, 1), 128)
        Ksub = min(Kmax, _round_up(ksub_cap, 128)) if ksub_cap else Kmax
        order2 = np.argsort(skey, kind="stable")
        sk, skeys = skey[order2], keys[order2]
        within2 = np.arange(keys.size) - np.concatenate(
            [[0], np.cumsum(scnt)])[sk]
        while True:
            keep2 = within2 < Ksub
            sub_dropped = 1.0 - float(keep2.sum()) / max(keys.size, 1)
            sub_corrupt = corruption_rate(skeys[~keep2], sk[~keep2] // S)
            if sub_corrupt <= MAX_KEY_CORRUPTION or Ksub >= Kmax:
                break
            # the cap bounds the compare cost; sampling bias is not traded
            Ksub = min(Ksub * 2, Kmax)
        sub_tbl = np.full((n_bkt * S, Ksub), -1, np.int32)
        sub_tbl[sk[keep2], within2[keep2]] = skeys[keep2]
        neg_state.update(subkeys_tbl=dev(sub_tbl), ksub=Ksub,
                         subkey_truncation=sub_dropped,
                         subkey_corruption=sub_corrupt)
    if bitmask == "auto":
        bitmask = n_bkt * UB * (IB // 8) <= BITMASK_HBM_BYTES
    if bitmask:
        # the unique keys sorted by (bucket, u_loc, i_loc) give byte
        # offsets in nondecreasing order: OR the bits of each byte's run
        bm = np.zeros(n_bkt * UB * (IB // 8), np.uint8)
        byte = (bkt_r * UB + keys // IB) * (IB // 8) + (keys % IB >> 3)
        bit = (1 << (keys % IB & 7)).astype(np.uint8)
        if byte.size:
            first = np.flatnonzero(np.r_[True, byte[1:] != byte[:-1]])
            bm[byte[first]] = np.bitwise_or.reduceat(bit, first)
        neg_state["bitmask_tbl"] = dev(
            bm.view(np.int8).reshape(n_bkt, UB, IB // 8))
    plan = dataclasses.replace(plan, packed=plan.packed.to(device))
    return plan, neg_state, (n_ib, Kcap, num_neg_trials, I, IB)


def epoch_negative_plan(plan: MxuPlan, nvalid: np.ndarray,
                        ub_visit: np.ndarray, num_items: int, seed,
                        block_mass=None):
    """Per-epoch negative block of every chunk, in visit order: uniform
    regimes draw jb = r % n_ib with r ~ U[0, num_items) (P(block b) =
    nvalid_b / num_items), WBPR draws jb by popularity mass. Returns
    int32 tensors (jb, nval, bkt) on the plan's device; bkt indexes the
    membership tables."""
    rng = np.random.default_rng(seed)
    nc = plan.num_chunks
    if block_mass is not None:
        p = np.asarray(block_mass, dtype=np.float64)
        p = p / p.sum()
        jb = rng.choice(plan.n_iblocks, size=nc, p=p).astype(np.int32)
    else:
        r = rng.integers(0, max(num_items, 1), nc)
        jb = (r % plan.n_iblocks).astype(np.int32)
    nval = np.maximum(nvalid[jb], 1).astype(np.int32)
    bkt = (np.asarray(ub_visit, dtype=np.int64)
           * plan.n_iblocks + jb).astype(np.int32)
    dev = plan.packed.device
    return tuple(torch.from_numpy(a).to(dev) for a in (jb, nval, bkt))


def bpr_tiled_plan(plan: MxuPlan, nvalid: np.ndarray, *, slab_blocks: int):
    """Static geometry of the slab-tiled schedule: (B, num_slabs,
    slab_items), B = slab_blocks capped at the block count and
    slab_items [num_slabs] the real items of each slab
    (``pallas_bpr.bpr_tiled_plan`` without its pad chunk and pass
    split)."""
    B = min(slab_blocks, plan.n_iblocks)
    S = (plan.n_iblocks + B - 1) // B
    slab_items = np.concatenate([
        nvalid.astype(np.int64),
        np.zeros(S * B - plan.n_iblocks, np.int64)]).reshape(S, B).sum(axis=1)
    return B, S, slab_items


def bpr_tiled_epoch_order(plan: MxuPlan, nvalid: np.ndarray,
                          slab_items: np.ndarray, *, slab_blocks: int,
                          num_slabs: int, num_items: int, seed,
                          block_mass=None):
    """One epoch of the tiled schedule: (ub, ibr, isl, jb, jbr, jsl,
    nval, bkt, row) int32 tensors [nc] on the plan's device, in visit
    order, equal to the real entries of ``pallas_bpr.
    bpr_tiled_epoch_order``. Chunks are sorted by (positive slab isl,
    negative slab jsl, user block) and shuffled within each cell. One
    negative slab is drawn per (isl, user block) group with P(slab) =
    slab_items / num_items, then one negative block per chunk within it,
    uniform by item count, so P(block b) = nvalid_b / num_items as on the
    resident path; WBPR draws both by popularity mass. The chunk's
    positive block is isl * B + ibr, its negative block jb = jsl * B +
    jbr, and bkt = ub * n_ib + jb its membership bucket."""
    rng = np.random.default_rng(seed)
    nc = plan.num_chunks
    B = min(slab_blocks, plan.n_iblocks)
    n_ib, n_ub = plan.n_iblocks, plan.n_ublocks
    isl_c = (plan.ib_c // B).astype(np.int32)
    ibr_c = (plan.ib_c - isl_c * B).astype(np.int32)

    # one negative slab per (isl, user block) group
    gid = isl_c.astype(np.int64) * n_ub + plan.ub_c
    uniq, inv = np.unique(gid, return_inverse=True)
    if block_mass is not None:
        pm = np.concatenate([np.asarray(block_mass, dtype=np.float64),
                             np.zeros(num_slabs * B - n_ib)])
        sm = pm.reshape(num_slabs, B).sum(axis=1)
        jsl_g = rng.choice(num_slabs, size=uniq.size,
                           p=sm / sm.sum()).astype(np.int32)
    else:
        r = rng.integers(0, max(num_items, 1), uniq.size)
        jsl_g = ((r % n_ib) // B).astype(np.int32)
    jsl_c = jsl_g[inv]

    # one negative block per chunk within its group's slab
    if block_mass is not None:
        jbr_c = np.zeros(nc, np.int32)
        for s in range(num_slabs):
            sel = np.nonzero(jsl_c == s)[0]
            if sel.size == 0:
                continue
            lo, hi = s * B, min((s + 1) * B, n_ib)
            m = np.asarray(block_mass[lo:hi], dtype=np.float64)
            jbr_c[sel] = rng.choice(hi - lo, size=sel.size,
                                    p=m / m.sum()).astype(np.int32)
    else:
        si = np.maximum(slab_items[jsl_c], 1)
        r2 = (rng.random(nc) * si).astype(np.int64)
        n_blocks_of = np.minimum((jsl_c + 1) * B, n_ib) - jsl_c * B
        jbr_c = (r2 % n_blocks_of).astype(np.int32)
    jb_c = (jsl_c * B + jbr_c).astype(np.int32)

    perm = np.argsort(
        isl_c.astype(np.float64) * (2.0 * num_slabs * n_ub)
        + jsl_c * (2.0 * n_ub) + plan.ub_c * 2.0 + rng.random(nc),
        kind="stable")
    nval_c = np.maximum(nvalid[jb_c], 1).astype(np.int32)
    bkt_c = (plan.ub_c.astype(np.int64) * n_ib + jb_c).astype(np.int32)
    dev = plan.packed.device
    return tuple(torch.from_numpy(np.ascontiguousarray(a[perm], np.int32))
                 .to(dev)
                 for a in (plan.ub_c, ibr_c, isl_c, jb_c, jbr_c, jsl_c,
                           nval_c, bkt_c, np.arange(nc)))


def prepare_bpr_mxu_sharded(feedback, num_devices: int, *, uniform_user: bool,
                            user_block: int = 512, item_block: int = 1024,
                            chunk=640, shuffle_seed=0,
                            num_neg_trials: int = 8, bitmask="auto",
                            device="cpu"):
    """``prepare_bpr_mxu``, then its chunks grouped into the DSGD cells of
    ``num_devices`` devices (``pallas_bpr.py:1477
    prepare_bpr_mxu_sharded``). Returns (plan, neg_state, neg_meta), the
    plan a ``plan.MxuShardedPlan``; the membership and CDF tables stay
    global (every device reads them whole)."""
    plan, neg_state, neg_meta = prepare_bpr_mxu(
        feedback, uniform_user=uniform_user, user_block=user_block,
        item_block=item_block, chunk=chunk, shuffle_seed=shuffle_seed,
        num_neg_trials=num_neg_trials, bitmask=bitmask, device=device)
    return shard_plan(plan, num_devices), neg_state, neg_meta


def prepare_bpr_mxu_sharded_tiled(feedback, num_devices: int, *,
                                  uniform_user: bool, user_block: int = 512,
                                  item_block: int = 1024, chunk=None,
                                  slab_blocks: int = 8, shuffle_seed=0,
                                  num_neg_trials: int = 8,
                                  chunk_overhead: int = 256,
                                  ksub_cap: int = 256, device="cpu"):
    """``prepare_bpr_mxu`` with the sub-bucketed keys of the tiled
    sampler, then its chunks grouped into diagonal cells whose partitions
    are whole slabs (``pallas_bpr.py:1797
    prepare_bpr_mxu_sharded_tiled``). Returns (plan, neg_state,
    neg_meta), the plan a ``plan.MxuShardedTiledPlan``."""
    plan, neg_state, neg_meta = prepare_bpr_mxu(
        feedback, uniform_user=uniform_user, user_block=user_block,
        item_block=item_block, chunk=chunk, shuffle_seed=shuffle_seed,
        num_neg_trials=num_neg_trials, kcap=128, subkeys=True,
        ksub_cap=ksub_cap, bitmask=False, chunk_overhead=chunk_overhead,
        device=device)
    return (shard_plan(plan, num_devices, slab_blocks=slab_blocks),
            neg_state, neg_meta)


def bpr_sharded_epoch_order(plan: MxuShardedPlan, nvalid: np.ndarray, seed,
                            block_mass=None) -> tuple:
    """One epoch of the sharded schedule: [D, D, nc_pad] int32 numpy
    arrays (ub, ib, jb, jbg, nval, bkt, row), equal to
    ``pallas_bpr.BprShardedPlan.epoch_order`` (:1421-1475). ub is
    relative to the device, ib and the negative block jb to the
    partition, jbg = jb + the partition's first block is global, and so
    is the membership bucket bkt = ub_global * n_ib + jbg. A chunk's
    negative block is drawn within the partition its device holds:
    P(block b) = nvalid_b / (the partition's items), or WBPR
    (``block_mass``) by popularity mass within it. Each cell's chunks
    grouped by user block, shuffled within each group; pads as in
    ``MxuShardedPlan.epoch_order``."""
    D, nc_pad = plan.num_devices, plan.nc_pad
    PB, n_ib = plan.part_blocks, plan.n_iblocks
    rng = np.random.default_rng(seed)
    shape = (D, D, nc_pad)
    ub, ib, jbr, jbg, bkt = (np.zeros(shape, np.int32) for _ in range(5))
    nval = np.ones(shape, np.int32)
    row = np.full(shape, plan.num_chunks, np.int32)
    for d in range(D):
        for k in range(D):
            rows = plan.cells[d][k]
            if rows.size == 0:
                continue
            perm = np.argsort(plan.ub_c[rows].astype(np.float64) * 2.0
                              + rng.random(rows.size), kind="stable")
            r = rows[perm]
            n = r.size
            lo = ((d + k) % D) * PB
            hi = min(lo + PB, n_ib)
            nb = max(hi - lo, 1)
            if block_mass is not None:
                m = np.asarray(block_mass[lo:hi], dtype=np.float64)
                tot = m.sum()
                jl = rng.choice(nb, size=n, p=m / tot).astype(np.int32) \
                    if tot > 0 else np.zeros(n, np.int32)
            else:
                items_p = int(nvalid[lo:hi].sum())
                jl = (rng.integers(0, max(items_p, 1), n) % nb).astype(
                    np.int32)
            ub[d, k, :n] = plan.ub_c[r] - d * plan.ub_per_dev
            ib[d, k, :n] = plan.ib_c[r] - lo
            jbr[d, k, :n] = jl
            jbg[d, k, :n] = lo + jl
            nval[d, k, :n] = np.maximum(nvalid[lo + jl], 1)
            bkt[d, k, :n] = (plan.ub_c[r].astype(np.int64) * n_ib
                             + lo + jl).astype(np.int32)
            row[d, k, :n] = r
            ub[d, k, n:] = ub[d, k, n - 1]
    return ub, ib, jbr, jbg, nval, bkt, row


def bpr_sharded_tiled_epoch_order(plan: MxuShardedTiledPlan,
                                  nvalid: np.ndarray, seed,
                                  block_mass=None) -> tuple:
    """One epoch of the sharded slab-tiled schedule: [D, D, nc_pad] int32
    numpy arrays (ub, ibr, isl, jb, jbr, jsl, nval, bkt, row), equal to
    ``pallas_bpr.BprShardedTiledPlan.epoch_order`` (:1715-1795) without
    its refetch flags. isl and jsl are slabs relative to the partition,
    ibr and jbr blocks relative to their slab, jb the global negative
    block and bkt = ub_global * n_ib + jb. One negative slab is drawn per
    (isl, user block) group within the partition (P(slab) = its items /
    the partition's), then one negative block per chunk within that slab,
    uniform by item count, so P(block b) = nvalid_b / (the partition's
    items) as on the sharded resident schedule; WBPR draws both by
    popularity mass. Each cell's chunks sorted by (isl, jsl, user block)
    and shuffled within each group; pads as in
    ``MxuShardedPlan.epoch_order``."""
    D, nc_pad, B = plan.num_devices, plan.nc_pad, plan.slab_blocks
    PB, n_ib, n_ub = plan.part_blocks, plan.n_iblocks, plan.n_ublocks
    SP = plan.slabs_per_part
    rng = np.random.default_rng(seed)
    shape = (D, D, nc_pad)
    ub, ibr, isl, jb, jbr, jsl, bkt = (np.zeros(shape, np.int32)
                                       for _ in range(7))
    nval = np.ones(shape, np.int32)
    row = np.full(shape, plan.num_chunks, np.int32)
    for d in range(D):
        for k in range(D):
            rows = plan.cells[d][k]
            if rows.size == 0:
                continue
            lo = ((d + k) % D) * PB
            hi = min(lo + PB, n_ib)
            n = rows.size
            ib_rel = plan.ib_c[rows] - lo
            sl = ib_rel // B
            # one negative slab per (isl, user block) group
            gid = sl.astype(np.int64) * n_ub + plan.ub_c[rows]
            uniq, inv = np.unique(gid, return_inverse=True)
            pad_b = np.zeros(SP * B - (hi - lo), np.int64)
            nv_p = np.concatenate([nvalid[lo:hi].astype(np.int64), pad_b])
            if block_mass is not None:
                m_p = np.concatenate([
                    np.asarray(block_mass[lo:hi], np.float64),
                    pad_b.astype(np.float64)])
                sm = m_p.reshape(SP, B).sum(axis=1)
                tot = sm.sum()
                jsl_g = (rng.choice(SP, size=uniq.size, p=sm / tot)
                         .astype(np.int32) if tot > 0
                         else np.zeros(uniq.size, np.int32))
            else:
                items_p = max(int(nv_p.sum()), 1)
                rr = rng.integers(0, items_p, uniq.size)
                jsl_g = ((rr % max(hi - lo, 1)) // B).astype(np.int32)
            jsl_c = jsl_g[inv]
            # one negative block per chunk within its group's slab
            nb_of = np.maximum(np.minimum((jsl_c + 1) * B, hi - lo)
                               - jsl_c * B, 1)
            if block_mass is not None:
                jl = np.zeros(n, np.int32)
                for s in np.unique(jsl_c):
                    sel = np.nonzero(jsl_c == s)[0]
                    l2 = lo + s * B
                    h2 = min(l2 + B, hi)
                    m = np.asarray(block_mass[l2:h2], np.float64)
                    tot = m.sum()
                    if tot > 0:
                        jl[sel] = rng.choice(h2 - l2, size=sel.size,
                                             p=m / tot).astype(np.int32)
            else:
                si = np.maximum(nv_p.reshape(SP, B).sum(axis=1)[jsl_c], 1)
                r2 = (rng.random(n) * si).astype(np.int64)
                jl = (r2 % nb_of).astype(np.int32)
            jb_c = (lo + jsl_c * B + jl).astype(np.int32)
            perm = np.argsort(
                sl.astype(np.float64) * (2.0 * SP * n_ub)
                + jsl_c * (2.0 * n_ub) + plan.ub_c[rows] * 2.0
                + rng.random(n), kind="stable")
            r = rows[perm]
            ub[d, k, :n] = plan.ub_c[r] - d * plan.ub_per_dev
            isl[d, k, :n] = sl[perm]
            ibr[d, k, :n] = ib_rel[perm] - sl[perm] * B
            jsl[d, k, :n] = jsl_c[perm]
            jbr[d, k, :n] = jl[perm]
            jb[d, k, :n] = jb_c[perm]
            nval[d, k, :n] = np.maximum(nvalid[jb_c[perm]], 1)
            bkt[d, k, :n] = (plan.ub_c[r].astype(np.int64) * n_ib
                             + jb_c[perm]).astype(np.int32)
            row[d, k, :n] = r
            for a in (ub, isl, ibr, jsl, jbr, jb, nval, bkt):
                a[d, k, n:] = a[d, k, n - 1]
    return ub, ibr, isl, jb, jbr, jsl, nval, bkt, row


def bpr_mxu_column_rates(num_factors: int, fe: int, learn_rate, reg_u,
                         reg_i, reg_j, bias_reg, update_j: bool,
                         device="cpu") -> torch.Tensor:
    """[fe, 6] per-column (w_lr, w_reg, i_lr, i_reg, j_lr, j_reg). Users
    are [factors | 1 | 0...], items [factors | bias | 1 | 0...], so the
    item bias column f moves by the reference bias rule against the
    users' constant column."""
    f = num_factors
    lr = float(learn_rate)
    out = np.zeros((fe, 6), np.float32)
    out[:f, 0] = lr
    out[:f, 1] = float(reg_u)
    out[:f, 2] = lr
    out[f, 2] = lr
    out[:f, 3] = float(reg_i)
    out[f, 3] = float(bias_reg)
    if update_j:
        out[:f, 4] = lr
        out[f, 4] = lr
        out[:f, 5] = float(reg_j)
        out[f, 5] = float(bias_reg)
    return torch.from_numpy(out).to(device)


def bpr_tables_to_mxu(user_factors, item_factors, item_bias, new_of_old, *,
                      u_pad: int, i_pad: int, fe: int):
    """(user_factors, item_factors, item_bias) tensors to the kernel
    layout, on their device: user rows padded to the user-block grid,
    item rows permuted onto the item-block grid."""
    U, f = user_factors.shape
    dev = user_factors.device
    W = torch.zeros((u_pad, fe), dtype=torch.float32, device=dev)
    W[:U, :f] = user_factors
    W[:U, f] = 1.0
    H = torch.zeros((i_pad, fe), dtype=torch.float32, device=dev)
    H[new_of_old, :f] = item_factors
    H[new_of_old, f] = item_bias
    H[new_of_old, f + 1] = 1.0
    return W, H


def bpr_tables_from_mxu(W, H, new_of_old, *, num_users: int,
                        num_factors: int):
    """Inverse of bpr_tables_to_mxu: (user_factors, item_factors,
    item_bias)."""
    f = num_factors
    Hr = H[new_of_old]
    return (W[:num_users, :f].contiguous(), Hr[:, :f].contiguous(),
            Hr[:, f].contiguous())
