"""Chunk plan and negative-sampling state for the BPR epoch kernel.

Port of the host-side half of ``mymedialite_tpu/ops/pallas_bpr.py``
(``prepare_bpr_mxu``, ``epoch_negative_plan``, ``bpr_mxu_column_rates``,
``bpr_tables_to_mxu`` / ``bpr_tables_from_mxu``) for the resident path:
the item table is one array, the chunk size is fixed, membership keys
are uncapped. The positive events are bucketed like ratings
(``ops/plan.py prepare_mxu_data``); row 2 of ``packed`` carries the
per-event base weight (the uniform-user importance weight, or 1) and
row 3 the padding weight (1 real, 0 pad). The outputs are bit-identical
to the JAX package's for the same inputs; the tables live on a torch
device.

Negative sampling state (see ``ops/bpr_epoch.py`` for how the epoch
uses it):

- ``keys_tbl`` [round8(n_bkt), Kcap] int32: per (user block, item
  block) bucket, the unique keys ``u_loc * IB + i_loc`` of its events,
  ascending, -1 padded at the end;
- ``bitmask_tbl`` [n_bkt, UB, IB/8] int8 (when it fits 2 GiB): the same
  predicate as packed bits, bit ``i_loc & 7`` of byte ``i_loc >> 3``;
- ``cdf_tbl`` [round8(n_ib), IB] float32: per item block the popularity
  CDF over its local slots (padding slots 1.0), nondecreasing;
- ``nvalid`` [n_ib] and ``block_mass`` [n_ib] on the host.

The slab-tiled plan (sub-bucketed keys, capped key tables) belongs to
the tiled kernel and is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mymedialite_tpu_torch.ops.plan import MxuPlan, _round_up, prepare_mxu_data

BITMASK_HBM_BYTES = 2 * 1024 ** 3
# the JAX package keeps the whole item table resident up to this size and
# switches to the slab-tiled kernel past it (pallas_sgd.mxu_supported)
RESIDENT_ITEM_TABLE_BYTES = 10 * 1024 * 1024


def mxu_supported(num_items: int, num_factors: int,
                  item_block: int = 1024) -> bool:
    """Whether the JAX package runs the resident BPR kernel at this shape
    (``pallas_sgd.mxu_supported``); past it, it runs the tiled kernel."""
    fe = max(64, _round_up(num_factors + 2, 8))
    n_ib = max((num_items + item_block - 1) // item_block, 1)
    return n_ib * item_block * fe * 4 <= RESIDENT_ITEM_TABLE_BYTES


def prepare_bpr_mxu(feedback, *, uniform_user: bool, user_block: int = 512,
                    item_block: int = 1024, chunk: int = 640,
                    shuffle_seed=0, num_neg_trials: int = 8,
                    bitmask="auto", device="cpu"):
    """Bucket the positive events and build the negative-sampling state.

    Returns (plan, neg_state, neg_meta) as the JAX function does:
    ``plan.packed`` on ``device``, ``neg_state`` with the tables above on
    ``device`` (``bitmask_tbl`` only when built), ``neg_meta`` =
    (n_ib, Kcap, num_neg_trials, num_items, IB)."""
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
                            device="cpu")
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
    keys_tbl = np.full((_round_up(n_bkt, 8), Kcap), -1, np.int32)
    order = np.argsort(bkt_r, kind="stable")
    off = np.concatenate([[0], np.cumsum(cnt)])
    sb = bkt_r[order]
    keys_tbl[sb, np.arange(keys.size) - off[sb]] = keys[order]

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
                     cdf_tbl=dev(cdf), block_mass=block_mass)
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
