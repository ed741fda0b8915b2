"""The chunks of one epoch and their visit order, worked out again.

A frozen copy of the semantics of the port's chunk plan (
``ops/plan.py`` ``prepare_mxu_data``, ``MxuPlan.epoch_order``,
``MxuTiledPlan.epoch_order``, ``select_schedule``) written in NumPy and
plain PyTorch from the log alone: the ratings shuffled by
``default_rng(shuffle_seed).permutation``, items renumbered by
popularity round robin over the item blocks, bucketed by (user block,
item block) cell in shuffled order, each cell cut into chunks of ``C``
slots (one chunk is one minibatch step), and each epoch's chunks
visited grouped by user block (resident) or by (item slab, user block)
(tiled), shuffled within each group by ``default_rng(epoch_seed)``.
A change to any of these in the program changes what an epoch computes
and needs this file to follow it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

USER_BLOCK, ITEM_BLOCK = 512, 1024
# the item table stays resident up to this many bytes; past it the slab-
# tiled schedule; past MAX_SLABS slabs no kernel schedule
RESIDENT_ITEM_TABLE_BYTES = 10 * 1024 * 1024
TILED_SLAB_BYTES = 4 * 1024 * 1024
MAX_SLABS = 128
CHUNK_CANDIDATES = (128, 256, 384, 512, 640)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def fused_width(k: int) -> int:
    return max(64, _round_up(k + 2, 8))


def slab_blocks(k: int) -> int:
    return max(TILED_SLAB_BYTES // (ITEM_BLOCK * fused_width(k) * 4), 1)


def schedule(num_items: int, k: int) -> str:
    """"resident" or "tiled" on one card, from the catalog and width."""
    n_ib = max((num_items + ITEM_BLOCK - 1) // ITEM_BLOCK, 1)
    if n_ib * ITEM_BLOCK * fused_width(k) * 4 <= RESIDENT_ITEM_TABLE_BYTES:
        return "resident"
    B = slab_blocks(k)
    if B * ITEM_BLOCK * fused_width(k) * 4 <= RESIDENT_ITEM_TABLE_BYTES \
            and (n_ib + B - 1) // B <= MAX_SLABS:
        return "tiled"
    raise ValueError(f"no kernel schedule for {num_items} items at k={k}")


@dataclass
class Chunks:
    rows: torch.Tensor        # [nc, C] int64: the log's row of each slot, -1 pad
    ub: np.ndarray            # [nc] user block of each chunk, layout order
    ib: np.ndarray            # [nc] item block
    chunk: int
    n_ublocks: int
    n_iblocks: int
    user_block: int
    item_block: int
    new_of_old: np.ndarray    # [num_items] the renumbered item ids
    old_of_new: np.ndarray    # [n_iblocks * item_block], -1 where empty

    @property
    def num_chunks(self) -> int:
        return int(self.ub.size)


def item_renumbering(items: np.ndarray, num_items: int, n_ib: int, IB: int):
    """Popularity round robin: the j-th most rated item (stable ties) to
    block j % n_ib, slot j // n_ib."""
    counts = np.bincount(items, minlength=num_items)
    rank = np.argsort(-counts, kind="stable")
    j = np.arange(num_items)
    new_of_old = np.empty(num_items, np.int64)
    new_of_old[rank] = (j % n_ib) * IB + j // n_ib
    old_of_new = np.full(n_ib * IB, -1, np.int64)
    old_of_new[new_of_old] = np.arange(num_items)
    return new_of_old, old_of_new


def pick_chunk(bcount: np.ndarray, overhead: int) -> int:
    """The candidate with the fewest padded slots plus ``overhead`` slots
    a chunk, the largest within 3% of the fewest."""
    tots = [int((((bcount + c - 1) // c) * c).sum())
            + int(((bcount + c - 1) // c).sum()) * overhead
            for c in CHUNK_CANDIDATES]
    lo = min(tots)
    return max(c for c, t in zip(CHUNK_CANDIDATES, tots) if t <= 1.03 * lo)


def make_chunks(users: np.ndarray, items: np.ndarray, num_users: int,
                num_items: int, *, chunk, shuffle_seed: int,
                chunk_overhead: int = 0, device="cpu") -> Chunks:
    """The chunks of the log (``chunk`` None: picked by ``pick_chunk``)."""
    n = users.size
    UB = min(USER_BLOCK, _round_up(max(num_users, 1), 8))
    IB = min(ITEM_BLOCK, _round_up(max(num_items, 1), 8))
    n_ub = max((num_users + UB - 1) // UB, 1)
    n_ib = max((num_items + IB - 1) // IB, 1)
    nbkt = n_ub * n_ib
    new_of_old, old_of_new = item_renumbering(items, num_items, n_ib, IB)
    perm = torch.from_numpy(
        np.random.default_rng(shuffle_seed).permutation(n)).to(device)
    u = torch.from_numpy(users).to(device)[perm]
    i_new = torch.from_numpy(new_of_old).to(device)[
        torch.from_numpy(items).to(device)[perm]]
    bucket = (u // UB) * n_ib + i_new // IB
    del u, i_new
    bsorted, order = torch.sort(bucket, stable=True)
    del bucket
    in_order = perm[order]                     # the log's rows, bucket-major
    del perm, order
    bcount = torch.bincount(bsorted, minlength=nbkt).cpu().numpy()
    del bsorted
    C = chunk if chunk is not None else pick_chunk(bcount, chunk_overhead)
    per_bucket = (bcount + C - 1) // C
    nc = max(int(per_bucket.sum()), 1)
    bkt = np.repeat(np.arange(nbkt), per_bucket)
    if bkt.size == 0:
        bkt = np.zeros(1, np.int64)
    boff = np.concatenate([[0], np.cumsum(bcount)])
    coff = np.concatenate([[0], np.cumsum(per_bucket)])
    q = np.arange(bkt.size) - coff[bkt]
    start = torch.from_numpy(boff[bkt] + q * C).to(device)
    length = torch.from_numpy(np.minimum(bcount[bkt] - q * C, C)).to(device)
    slot = torch.arange(C, device=device)
    pos = (start[:, None] + slot).clamp_(max=max(n - 1, 0))
    rows = torch.where(slot < length[:, None], in_order[pos],
                       torch.full_like(pos, -1))
    return Chunks(rows=rows, ub=bkt // n_ib, ib=bkt % n_ib, chunk=C,
                  n_ublocks=n_ub, n_iblocks=n_ib, user_block=UB,
                  item_block=IB, new_of_old=new_of_old,
                  old_of_new=old_of_new)


def resident_order(ch: Chunks, seed: int) -> np.ndarray:
    """The chunks' visit order of one resident epoch."""
    rng = np.random.default_rng(seed)
    return np.argsort(ch.ub.astype(np.float64) * 2.0
                      + rng.random(ch.num_chunks), kind="stable")


def tiled_order(ch: Chunks, seed: int, blocks: int) -> np.ndarray:
    """The chunks' visit order of one slab-tiled epoch (slabs of
    ``blocks`` item blocks)."""
    B = min(blocks, ch.n_iblocks)
    sl = ch.ib // B
    key = sl.astype(np.float64) * (2.0 * ch.n_ublocks) + ch.ub * 2.0
    key = key + np.random.default_rng(seed).random(ch.num_chunks)
    return np.argsort(key, kind="stable")


def epoch_seed(random_seed: int, epoch: int) -> int:
    """The seed of epoch ``epoch`` (1 for the first) of a model seeded
    with ``random_seed``."""
    return (random_seed + 1) * 1_000_003 + epoch
