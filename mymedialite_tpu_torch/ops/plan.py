"""Chunk plan for the rating-SGD epoch kernel.

Port of the host-side half of ``mymedialite_tpu/ops/pallas_sgd.py``
(``MxuPlan``, ``prepare_mxu_data``, ``extend_tables_mxu``,
``split_tables_mxu``, ``mxu_column_rates``, ``tables_std_to_mxu`` /
``tables_mxu_to_std``). The rating stream is bucketed into
(user block x item block) cells and each cell is padded to whole chunks
of ``C`` slots; one chunk is one minibatch SGD step. Item ids are
permuted popularity-round-robin so every item block carries similar
rating mass. The plan is bit-identical to the JAX package's for the
same inputs; only ``packed`` lives on a torch device instead of a jax
one.

The epoch order is the host ``MxuPlan.epoch_order`` (numpy
``default_rng``): chunks stay grouped by user block and are shuffled
within each group.

Catalogs whose item table passes ``RESIDENT_ITEM_TABLE_BYTES`` take the
slab-tiled schedule instead (``MxuTiledPlan``, ``prepare_mxu_tiled``;
JAX: ``pallas_sgd.py:534-742``): the same chunks, visited slab-major —
sorted by item slab, grouped by user block within the slab, shuffled
within each (slab, user block) cell. On the TPU that order lets one
slab and one user block stay in VMEM; on the H100 the kernels gather
rows from device memory and the order keeps one slab hot in L2. The
TPU-only parts of the JAX plan stay behind: the all-zero pad chunk, the
pass split (``pass_len``, a scalar-memory bound), the refetch flags and
the table padding to whole slabs. ``select_schedule`` is the port of
``ops/kernel_select.py:53-114``, for both model families.

On a device mesh (``parallel/mesh.py``) the same chunks are regrouped
into the cells of Gemulla's DSGD diagonal (``MxuShardedPlan``,
``MxuShardedTiledPlan``, ``shard_plan``; JAX: ``pallas_sgd.py
:1017-1124``, ``:1212-1353``): device d owns a contiguous range of user
blocks, the item table splits into one partition per device, and at
sub-epoch k device d visits the chunks of its users on partition (d + k)
% D. The orders are the JAX package's ``[D, D, nc_pad]`` arrays, pads
included, and the port visits only each cell's real chunks.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np
import torch

log = logging.getLogger("mymedialite_tpu_torch")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# the JAX package keeps the whole item table resident (in VMEM) up to this
# size and runs the slab-tiled schedule past it (pallas_sgd.py:53,508-513);
# the port keeps the bound so that both packages pick the same schedule
RESIDENT_ITEM_TABLE_BYTES = 10 * 1024 * 1024
# one item slab of the tiled schedule (pallas_sgd.py:657)
TILED_SLAB_BYTES = 4 * 1024 * 1024
# the tiled schedule covers catalogs of up to this many slabs
MAX_SLABS = 128


def fused_width(num_factors: int) -> int:
    """Column count of the kernel-layout tables: factors, the bias
    column, the constant-one column, padded to 8 and to at least 64."""
    return max(64, _round_up(num_factors + 2, 8))


@dataclass
class MxuPlan:
    """Host-side layout of one training set for the SGD epoch kernel."""
    num_chunks: int
    chunk: int
    user_block: int
    item_block: int
    n_ublocks: int
    n_iblocks: int
    num_users: int
    num_items: int
    n_ratings: int
    # [nc, 4, C] int32 on the model's device — rows (u_loc, i_loc,
    # bits of v, bits of w); read the last two with .view(torch.float32)
    packed: torch.Tensor = field(repr=False)
    # per-chunk (ublock, iblock) in layout order (host)
    ub_c: np.ndarray = field(repr=False)
    ib_c: np.ndarray = field(repr=False)
    # item id permutation (host): new_of_old [num_items], old_of_new [I_pad]
    new_of_old: np.ndarray = field(repr=False)
    old_of_new: np.ndarray = field(repr=False)

    @property
    def u_pad(self) -> int:
        return self.n_ublocks * self.user_block

    @property
    def i_pad(self) -> int:
        return self.n_iblocks * self.item_block

    def epoch_order(self, seed) -> tuple:
        """Per-epoch chunk visit order: chunks grouped by user block,
        shuffled within each group. Returns (ub, ib, row) int32 tensors
        of length num_chunks on the device of ``packed``."""
        nc = self.num_chunks
        if seed is None:
            perm = np.arange(nc)
        else:
            rng = np.random.default_rng(seed)
            perm = np.argsort(self.ub_c.astype(np.float64) * 2.0
                              + rng.random(nc), kind="stable")
        dev = self.packed.device
        return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                     for a in (self.ub_c[perm], self.ib_c[perm], perm))


def prepare_mxu_data(users, items, values, num_users: int, num_items: int, *,
                     user_block: int = 512, item_block: int = 1024,
                     chunk=256, shuffle_seed=0, chunk_overhead: int = 0,
                     item_perm=None, device="cpu") -> MxuPlan:
    """Bucket the rating stream by (user_block x item_block) cells with
    popularity-balanced item blocks; pad each cell to chunk multiples.
    ``chunk=None`` picks the histogram-optimal chunk size: the candidate
    with the fewest padded slots plus ``chunk_overhead`` slots per chunk
    (a fixed per-chunk cost), preferring larger chunks on near-ties.
    ``item_perm`` (the ``new_of_old`` of another plan over the same
    items and item block) replaces the popularity permutation, so that
    two event streams address one permuted item table (SVD++: ratings and
    history edges)."""
    from mymedialite_tpu_torch import native

    n = len(users)
    users = np.asarray(users, dtype=np.int32)
    items = np.asarray(items, dtype=np.int32)
    values = np.asarray(values, dtype=np.float32)
    perm = (np.random.default_rng(shuffle_seed).permutation(n)
            if shuffle_seed is not None and n > 1 else None)

    UB = min(user_block, _round_up(max(num_users, 1), 8))
    IB = min(item_block, _round_up(max(num_items, 1), 8))
    n_ub = max((num_users + UB - 1) // UB, 1)
    n_ib = max((num_items + IB - 1) // IB, 1)

    if item_perm is not None:
        new_of_old = np.asarray(item_perm, dtype=np.int32)
        assert new_of_old.shape[0] == num_items
    else:
        # popularity round-robin: the j-th most rated item goes to block
        # j % n_ib, so every item block gets about equal rating mass
        counts = native.count_items(items, num_items) if n else None
        if counts is None:
            counts = np.bincount(items, minlength=num_items) if n else \
                np.zeros(num_items, np.int64)
        rank = np.argsort(-counts, kind="stable")
        j = np.arange(num_items)
        new_of_old = np.empty(num_items, np.int32)
        new_of_old[rank] = ((j % n_ib) * IB + j // n_ib).astype(np.int32)
    old_of_new = np.full(n_ib * IB, -1, np.int32)
    old_of_new[new_of_old] = np.arange(num_items, dtype=np.int32)

    nbkt = n_ub * n_ib

    def pick_chunk(bcount):
        if chunk is not None:
            return chunk
        cands = (128, 256, 384, 512, 640)
        tots = [int((((bcount + c - 1) // c) * c).sum())
                + int(((bcount + c - 1) // c).sum()) * chunk_overhead
                for c in cands]
        lo = min(tots)
        return max(c for c, t in zip(cands, tots) if t <= 1.03 * lo)

    nat = native.mxu_bucketize(users, items, values, perm, new_of_old,
                               UB, IB, n_ib, nbkt, pick_chunk) if n else None
    if nat is not None:
        packed_np, bcount, pcount, chunk = nat
        nc = packed_np.shape[0]
    else:
        if perm is not None:
            users, items, values = users[perm], items[perm], values[perm]
        i_new = new_of_old[items]
        bucket = (users // UB).astype(np.int64) * n_ib + i_new // IB
        order = np.argsort(bucket, kind="stable")
        users, i_new, values = users[order], i_new[order], values[order]
        bucket = bucket[order]

        bcount = np.bincount(bucket, minlength=nbkt) if n else \
            np.zeros(nbkt, np.int64)
        chunk = pick_chunk(bcount)
        pcount = ((bcount + chunk - 1) // chunk) * chunk
        poff = np.concatenate([[0], np.cumsum(pcount)])
        nc = max(int(poff[-1]) // chunk, 1)
        total = nc * chunk

        u_loc = np.zeros(total, np.int32)
        i_loc = np.zeros(total, np.int32)
        v = np.zeros(total, np.float32)
        w = np.zeros(total, np.float32)
        if n:
            boff = np.concatenate([[0], np.cumsum(bcount)])
            out_idx = poff[bucket] + np.arange(n) - boff[bucket]
            u_loc[out_idx] = users % UB
            i_loc[out_idx] = i_new % IB
            v[out_idx] = values
            w[out_idx] = 1.0
        packed_np = np.stack([
            u_loc.reshape(nc, chunk), i_loc.reshape(nc, chunk),
            v.reshape(nc, chunk).view(np.int32),
            w.reshape(nc, chunk).view(np.int32)], axis=1)

    chunks_per_bucket = (pcount // chunk).astype(np.int64)
    bkt_of_chunk = np.repeat(np.arange(nbkt), chunks_per_bucket)
    if bkt_of_chunk.size == 0:
        bkt_of_chunk = np.zeros(1, np.int64)
    ub_c = (bkt_of_chunk // n_ib).astype(np.int32)
    ib_c = (bkt_of_chunk % n_ib).astype(np.int32)

    return MxuPlan(
        num_chunks=nc, chunk=chunk, user_block=UB, item_block=IB,
        n_ublocks=n_ub, n_iblocks=n_ib, num_users=num_users,
        num_items=num_items, n_ratings=n,
        packed=torch.from_numpy(np.ascontiguousarray(packed_np)).to(device),
        ub_c=ub_c, ib_c=ib_c, new_of_old=new_of_old, old_of_new=old_of_new)


def mxu_supported(num_items: int, num_factors: int,
                  item_block: int = 1024) -> bool:
    """Whether the item table fits ``RESIDENT_ITEM_TABLE_BYTES``: the
    resident schedule (``pallas_sgd.mxu_supported``)."""
    n_ib = max((num_items + item_block - 1) // item_block, 1)
    return (n_ib * item_block * fused_width(num_factors) * 4
            <= RESIDENT_ITEM_TABLE_BYTES)


def default_slab_blocks(num_factors: int, item_block: int = 1024) -> int:
    """Item blocks per slab of the tiled schedule: the largest slab within
    ``TILED_SLAB_BYTES`` (``pallas_sgd.default_slab_blocks``)."""
    return max(TILED_SLAB_BYTES // (item_block * fused_width(num_factors)
                                    * 4), 1)


def mxu_tiled_supported(num_items: int, num_factors: int,
                        item_block: int = 1024) -> bool:
    """Whether the tiled schedule applies: a default slab within the
    resident bound, the catalog within ``MAX_SLABS`` slabs
    (``pallas_sgd.mxu_tiled_supported``)."""
    slab_blocks = default_slab_blocks(num_factors, item_block)
    if (slab_blocks * item_block * fused_width(num_factors) * 4
            > RESIDENT_ITEM_TABLE_BYTES):
        return False
    n_ib = max((num_items + item_block - 1) // item_block, 1)
    return (n_ib + slab_blocks - 1) // slab_blocks <= MAX_SLABS


def mxu_sharded_supported(num_items: int, num_factors: int,
                          num_devices: int, item_block: int = 1024) -> bool:
    """Whether the sharded schedule applies: each of ``num_devices``
    item partitions within ``RESIDENT_ITEM_TABLE_BYTES``
    (``pallas_sgd.mxu_sharded_supported``)."""
    if num_devices < 2:
        return False
    n_ib = max((num_items + item_block - 1) // item_block, 1)
    part_blocks = max((n_ib + num_devices - 1) // num_devices, 1)
    return (part_blocks * item_block * fused_width(num_factors) * 4
            <= RESIDENT_ITEM_TABLE_BYTES)


def mxu_sharded_tiled_supported(num_items: int, num_factors: int,
                                num_devices: int,
                                item_block: int = 1024) -> bool:
    """Whether the sharded slab-tiled schedule applies: a default slab
    within the resident bound, each device's partition within
    ``MAX_SLABS`` slabs (``pallas_sgd.mxu_sharded_tiled_supported``)."""
    if num_devices < 2:
        return False
    slab_blocks = default_slab_blocks(num_factors, item_block)
    if (slab_blocks * item_block * fused_width(num_factors) * 4
            > RESIDENT_ITEM_TABLE_BYTES):
        return False
    n_ib = max((num_items + item_block - 1) // item_block, 1)
    part_blocks = _round_up(max((n_ib + num_devices - 1) // num_devices, 1),
                            slab_blocks)
    return part_blocks // slab_blocks <= MAX_SLABS


def xla_epochs_forced() -> bool:
    """``MML_MXU=0``: the XLA epochs everywhere, as in the JAX package
    (``ops/kernel_select.py``, ``models/svdpp.py``): "minibatch" for the
    MF and BPR families, the grouped epoch for SVD++. The JAX variable's
    other values (``interpret`` and its sharded forms) run Pallas kernels
    in interpret mode, a TPU idiom the port does not read."""
    return os.environ.get("MML_MXU") == "0"


def select_schedule(num_items: int, num_factors: int,
                    num_devices: int = 1) -> str:
    """The epoch schedule of the MF and BPR families
    (``ops/kernel_select.py:53-114``). On one device: "resident" while
    the item table fits the resident bound, "tiled" past it, "minibatch"
    past the tiled schedule's ``MAX_SLABS`` slabs: there the JAX package
    runs its XLA epochs, which the port runs as plain PyTorch minibatch
    epochs (``ops/sgd.py sgd_epoch_blocked``, ``ops/bpr.py bpr_epoch``).
    On a mesh of ``num_devices`` > 1: "sharded" while each device's item
    partition fits the resident bound, "sharded-tiled" while it fits
    ``MAX_SLABS`` slabs, else a logged warning and "minibatch".
    ``MML_MXU=0`` gives "minibatch" everywhere (``xla_epochs_forced``)."""
    if xla_epochs_forced():
        return "minibatch"
    if num_devices > 1:
        if mxu_sharded_supported(num_items, num_factors, num_devices):
            return "sharded"
        if mxu_sharded_tiled_supported(num_items, num_factors, num_devices):
            return "sharded-tiled"
        fe = fused_width(num_factors)
        log.warning(
            "select_schedule: no kernel schedule for num_items=%d "
            "num_factors=%d on a %d-device mesh (per-device partition "
            "%.1f MB against the %.0f MB resident bound; the partition "
            "passes %d slabs): the minibatch epoch instead",
            num_items, num_factors, num_devices,
            ((num_items + num_devices - 1) // num_devices) * fe * 4 / 2**20,
            RESIDENT_ITEM_TABLE_BYTES / 2**20, MAX_SLABS)
        return "minibatch"
    if mxu_supported(num_items, num_factors):
        return "resident"
    if mxu_tiled_supported(num_items, num_factors):
        return "tiled"
    return "minibatch"


@dataclass
class MxuTiledPlan:
    """Host-side layout of the slab-tiled schedule: the resident plan's
    chunks, visited slab-major. A slab is ``slab_blocks`` consecutive
    item blocks; slab ``s`` holds item blocks [s*B, (s+1)*B)."""
    num_slabs: int
    chunk: int
    user_block: int
    item_block: int
    slab_blocks: int         # item blocks per slab
    n_ublocks: int
    n_iblocks: int
    num_users: int
    num_items: int
    n_ratings: int
    # [nc, 4, C] int32 on the model's device, as MxuPlan.packed
    packed: torch.Tensor = field(repr=False)
    ub_c: np.ndarray = field(repr=False)      # [nc] layout order (host)
    ib_c: np.ndarray = field(repr=False)
    new_of_old: np.ndarray = field(repr=False)
    old_of_new: np.ndarray = field(repr=False)

    @property
    def num_chunks(self) -> int:
        return int(self.ub_c.size)

    @property
    def u_pad(self) -> int:
        return self.n_ublocks * self.user_block

    @property
    def i_pad(self) -> int:
        return self.n_iblocks * self.item_block

    def epoch_order(self, seed) -> tuple:
        """Per-epoch visit order (``pallas_sgd.MxuTiledPlan.epoch_order``
        without its pad entries): chunks sorted by slab, grouped by user
        block within the slab, shuffled within each (slab, user block)
        cell. Returns (ub, ibr, sl, row) int32 tensors of length
        num_chunks on the device of ``packed``; the chunk's item block
        is sl * slab_blocks + ibr. With one slab the order is the
        resident plan's."""
        nc = self.num_chunks
        sl_c = (self.ib_c // self.slab_blocks).astype(np.int32)
        key = sl_c.astype(np.float64) * (2.0 * self.n_ublocks) \
            + self.ub_c * 2.0
        if seed is not None:
            key = key + np.random.default_rng(seed).random(nc)
        perm = np.argsort(key, kind="stable")
        sl = sl_c[perm]
        cols = (self.ub_c[perm], self.ib_c[perm] - sl * self.slab_blocks,
                sl, perm)
        dev = self.packed.device
        return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                     .to(dev) for a in cols)


def prepare_mxu_tiled(users, items, values, num_users: int, num_items: int,
                      *, user_block: int = 512, item_block: int = 1024,
                      chunk=None, slab_blocks: int = 8, shuffle_seed=0,
                      device="cpu") -> MxuTiledPlan:
    """``prepare_mxu_data``, then the chunks grouped into slabs of
    ``slab_blocks`` item blocks (``pallas_sgd.prepare_mxu_tiled``)."""
    plan = prepare_mxu_data(users, items, values, num_users, num_items,
                            user_block=user_block, item_block=item_block,
                            chunk=chunk, shuffle_seed=shuffle_seed,
                            device=device)
    B = min(slab_blocks, plan.n_iblocks)
    return MxuTiledPlan(
        num_slabs=(plan.n_iblocks + B - 1) // B, chunk=plan.chunk,
        user_block=plan.user_block, item_block=plan.item_block,
        slab_blocks=B, n_ublocks=plan.n_ublocks, n_iblocks=plan.n_iblocks,
        num_users=num_users, num_items=num_items, n_ratings=plan.n_ratings,
        packed=plan.packed, ub_c=plan.ub_c, ib_c=plan.ib_c,
        new_of_old=plan.new_of_old, old_of_new=plan.old_of_new)


@dataclass
class MxuShardedPlan:
    """Host-side layout of the sharded schedule, Gemulla's DSGD diagonal
    over a mesh of D devices (``pallas_sgd.MxuShardedPlan``): device d
    owns the user blocks [d * ub_per_dev, (d + 1) * ub_per_dev) (its W
    shard of ``u_pad_dev`` rows), the item table splits into D
    partitions of ``part_blocks`` blocks (``part_rows`` rows), and at
    sub-epoch k device d visits the chunks of its users on partition
    (d + k) % D: cell (d, k), ``cells[d][k]`` (rows of ``packed``, the
    one-device plan's chunks). ``packed`` holds the real chunks only: a
    cell is launched over its own chunks, and an empty cell not at all.
    """
    num_devices: int
    chunk: int
    user_block: int
    item_block: int
    ub_per_dev: int          # user blocks per device
    part_blocks: int         # item blocks per partition
    n_ublocks: int
    n_iblocks: int
    num_users: int
    num_items: int
    n_ratings: int
    # [nc, 4, C] int32, as MxuPlan.packed
    packed: torch.Tensor = field(repr=False)
    ub_c: np.ndarray = field(repr=False)
    ib_c: np.ndarray = field(repr=False)
    cells: list = field(repr=False)           # [d][k] -> chunk rows
    new_of_old: np.ndarray = field(repr=False)
    old_of_new: np.ndarray = field(repr=False)

    @property
    def num_chunks(self) -> int:
        return int(self.ub_c.size)

    @property
    def cell_counts(self) -> np.ndarray:
        """[D, D] chunks of cell (device, sub-epoch)."""
        return np.array([[r.size for r in row] for row in self.cells],
                        np.int64)

    @property
    def nc_pad(self) -> int:
        """The largest cell: the JAX package pads every cell to it."""
        return max(int(self.cell_counts.max()), 1)

    @property
    def u_pad_dev(self) -> int:
        return self.ub_per_dev * self.user_block

    @property
    def u_pad(self) -> int:
        return self.num_devices * self.u_pad_dev

    @property
    def part_rows(self) -> int:
        return self.part_blocks * self.item_block

    @property
    def i_pad(self) -> int:
        return self.num_devices * self.part_rows

    def epoch_order(self, seed) -> tuple:
        """[D, D, nc_pad] int32 numpy arrays (ub, ib, row), axis 0 the
        device, axis 1 the sub-epoch, equal to
        ``pallas_sgd.MxuShardedPlan.epoch_order``: ub relative to the
        device's first user block, ib to the partition's first item
        block; each cell's chunks grouped by user block, shuffled within
        each group. The first ``cell_counts[d, k]`` entries of a cell are
        its chunks; the rest are the JAX package's pads (the last user
        block again, row ``num_chunks``), which the port never visits."""
        D, nc_pad = self.num_devices, self.nc_pad
        rng = None if seed is None else np.random.default_rng(seed)
        ub = np.zeros((D, D, nc_pad), np.int32)
        ib = np.zeros((D, D, nc_pad), np.int32)
        row = np.full((D, D, nc_pad), self.num_chunks, np.int32)
        for d in range(D):
            for k in range(D):
                rows = self.cells[d][k]
                if rows.size == 0:
                    continue
                if rng is None:
                    perm = np.arange(rows.size)
                else:
                    perm = np.argsort(self.ub_c[rows].astype(np.float64) * 2.0
                                      + rng.random(rows.size), kind="stable")
                r = rows[perm]
                p = (d + k) % D
                ub[d, k, :r.size] = self.ub_c[r] - d * self.ub_per_dev
                ib[d, k, :r.size] = self.ib_c[r] - p * self.part_blocks
                row[d, k, :r.size] = r
                ub[d, k, r.size:] = ub[d, k, r.size - 1]
        return ub, ib, row


@dataclass
class MxuShardedTiledPlan(MxuShardedPlan):
    """The sharded schedule with slab-tiled partitions
    (``pallas_sgd.MxuShardedTiledPlan``): each partition is a whole
    number of slabs of ``slab_blocks`` item blocks, and a cell's chunks
    are visited slab-major within the partition."""
    slab_blocks: int = 1

    @property
    def slabs_per_part(self) -> int:
        return self.part_blocks // self.slab_blocks

    @property
    def slab_rows(self) -> int:
        return self.slab_blocks * self.item_block

    def epoch_order(self, seed) -> tuple:
        """[D, D, nc_pad] int32 numpy arrays (ub, ibr, isl, row), equal
        to ``pallas_sgd.MxuShardedTiledPlan.epoch_order`` without its
        refetch flags: isl the slab relative to the partition, ibr the
        block relative to the slab; each cell's chunks sorted by (slab,
        user block), shuffled within each (slab, user block) group; pads
        as in ``MxuShardedPlan.epoch_order`` (the last real ids again)."""
        D, nc_pad, B = self.num_devices, self.nc_pad, self.slab_blocks
        rng = None if seed is None else np.random.default_rng(seed)
        ub = np.zeros((D, D, nc_pad), np.int32)
        ibr = np.zeros((D, D, nc_pad), np.int32)
        isl = np.zeros((D, D, nc_pad), np.int32)
        row = np.full((D, D, nc_pad), self.num_chunks, np.int32)
        for d in range(D):
            for k in range(D):
                rows = self.cells[d][k]
                if rows.size == 0:
                    continue
                p = (d + k) % D
                ib_rel = self.ib_c[rows] - p * self.part_blocks
                sl = ib_rel // B
                key = (sl.astype(np.float64) * (2.0 * self.n_ublocks)
                       + self.ub_c[rows] * 2.0)
                if rng is not None:
                    key = key + rng.random(rows.size)
                perm = np.argsort(key, kind="stable")
                r = rows[perm]
                n = r.size
                ub[d, k, :n] = self.ub_c[r] - d * self.ub_per_dev
                isl[d, k, :n] = sl[perm]
                ibr[d, k, :n] = ib_rel[perm] - sl[perm] * B
                row[d, k, :n] = r
                for a in (ub, isl, ibr):
                    a[d, k, n:] = a[d, k, n - 1]
        return ub, ibr, isl, row


def shard_plan(plan: MxuPlan, num_devices: int, *, slab_blocks=None):
    """The one-device plan's chunks regrouped into the DSGD cells of
    ``num_devices`` devices: an ``MxuShardedPlan``, or with
    ``slab_blocks`` an ``MxuShardedTiledPlan`` whose partitions are
    rounded up to whole slabs of min(slab_blocks, partition) blocks
    (``pallas_sgd.prepare_mxu_sharded`` / ``_tiled``, also the BPR ones,
    after their one-device plan)."""
    D = num_devices
    ub_per_dev = max((plan.n_ublocks + D - 1) // D, 1)
    part_blocks = max((plan.n_iblocks + D - 1) // D, 1)
    extra = {}
    cls = MxuShardedPlan
    if slab_blocks is not None:
        B = max(min(slab_blocks, part_blocks), 1)
        part_blocks = _round_up(part_blocks, B)
        extra = dict(slab_blocks=B)
        cls = MxuShardedTiledPlan
    dev_of = plan.ub_c // ub_per_dev
    part_of = plan.ib_c // part_blocks
    cells = [[np.nonzero((dev_of == d) & (part_of == (d + k) % D))[0]
              for k in range(D)] for d in range(D)]
    return cls(
        num_devices=D, chunk=plan.chunk, user_block=plan.user_block,
        item_block=plan.item_block, ub_per_dev=ub_per_dev,
        part_blocks=part_blocks, n_ublocks=plan.n_ublocks,
        n_iblocks=plan.n_iblocks, num_users=plan.num_users,
        num_items=plan.num_items, n_ratings=plan.n_ratings,
        packed=plan.packed, ub_c=plan.ub_c, ib_c=plan.ib_c, cells=cells,
        new_of_old=plan.new_of_old, old_of_new=plan.old_of_new, **extra)


def prepare_mxu_sharded(users, items, values, num_users: int, num_items: int,
                        num_devices: int, *, user_block: int = 512,
                        item_block: int = 1024, chunk=640, shuffle_seed=0,
                        device="cpu") -> MxuShardedPlan:
    """``prepare_mxu_data``, then its chunks grouped into the diagonal
    cells (``pallas_sgd.prepare_mxu_sharded``)."""
    return shard_plan(prepare_mxu_data(
        users, items, values, num_users, num_items, user_block=user_block,
        item_block=item_block, chunk=chunk, shuffle_seed=shuffle_seed,
        device=device), num_devices)


def prepare_mxu_sharded_tiled(users, items, values, num_users: int,
                              num_items: int, num_devices: int, *,
                              user_block: int = 512, item_block: int = 1024,
                              chunk=None, slab_blocks: int = 8,
                              shuffle_seed=0,
                              device="cpu") -> MxuShardedTiledPlan:
    """``prepare_mxu_data``, then its chunks grouped into diagonal cells
    whose partitions are whole slabs
    (``pallas_sgd.prepare_mxu_sharded_tiled``)."""
    return shard_plan(prepare_mxu_data(
        users, items, values, num_users, num_items, user_block=user_block,
        item_block=item_block, chunk=chunk, shuffle_seed=shuffle_seed,
        device=device), num_devices, slab_blocks=slab_blocks)


def extend_tables_mxu(plan: MxuPlan, user_factors, item_factors,
                      user_bias=None, item_bias=None, fe_pad: int = 64):
    """Fused [factors | bias | one] tables in the kernel's layout: users
    padded to n_ublocks*UB rows; items permuted and padded to
    n_iblocks*IB rows; columns zero-padded to ``fe_pad``. Returns
    float32 tensors on the plan's device."""
    W = np.asarray(user_factors, dtype=np.float32)
    H = np.asarray(item_factors, dtype=np.float32)
    U, f = W.shape
    fe = max(fe_pad, _round_up(f + 2, 8))
    bu = np.zeros(U, np.float32) if user_bias is None else \
        np.asarray(user_bias, np.float32)
    bi = np.zeros(H.shape[0], np.float32) if item_bias is None else \
        np.asarray(item_bias, np.float32)
    We = np.zeros((plan.u_pad, fe), np.float32)
    We[:U, :f] = W
    We[:U, f] = bu
    We[:U, f + 1] = 1.0
    He = np.zeros((plan.i_pad, fe), np.float32)
    He[plan.new_of_old, :f] = H
    He[plan.new_of_old, f] = 1.0
    He[plan.new_of_old, f + 1] = bi
    dev = plan.packed.device
    return torch.from_numpy(We).to(dev), torch.from_numpy(He).to(dev)


def split_tables_mxu(plan: MxuPlan, W_ext, H_ext, num_factors: int):
    """Inverse of extend_tables_mxu (unpermutes the item rows); numpy."""
    We = W_ext.detach().cpu().numpy()[:plan.num_users]
    He = H_ext.detach().cpu().numpy()[plan.new_of_old]
    f = num_factors
    return We[:, :f], He[:, :f], We[:, f], He[:, f + 1]


def mxu_column_rates(num_factors: int, fe: int, learn_rate, reg_u, reg_i,
                     bias_learn_rate, bias_reg, biased: bool,
                     update_user: bool, update_item: bool,
                     device="cpu") -> torch.Tensor:
    """[fe, 4] column-stacked (w_lr, w_reg, h_lr, h_reg), scaled by the
    current learn rate; constant and padding columns get rate 0."""
    f = num_factors
    lr, blr = float(learn_rate), float(bias_learn_rate)
    out = np.zeros((fe, 4), np.float32)
    out[:f, 0] = lr
    out[f, 0] = blr * lr if biased else 0.0
    out[:f, 1] = float(reg_u)
    out[f, 1] = float(bias_reg) * float(reg_u) if biased else 0.0
    out[:f, 2] = lr
    out[f + 1, 2] = blr * lr if biased else 0.0
    out[:f, 3] = float(reg_i)
    out[f + 1, 3] = float(bias_reg) * float(reg_i) if biased else 0.0
    if not update_user:
        out[:, 0] = 0.0
    if not update_item:
        out[:, 2] = 0.0
    return torch.from_numpy(out).to(device)


def tables_std_to_mxu(W_std, H_std, new_of_old, *, u_pad: int, i_pad: int,
                      fe_mxu: int):
    """Std-layout fused tables ([factors|b_u|1] / [factors|1|b_i], user
    rows padded to group_users multiples) to the kernel layout: user rows
    padded to the user-block grid, item rows permuted and padded to the
    item-block grid, columns zero-padded to ``fe_mxu``. On device."""
    fe = W_std.shape[1]
    W = torch.zeros((u_pad, fe_mxu), dtype=torch.float32, device=W_std.device)
    # rows past min() are padding in both layouts
    rows = min(W_std.shape[0], u_pad)
    W[:rows, :fe] = W_std[:rows]
    H = torch.zeros((i_pad, fe_mxu), dtype=torch.float32, device=H_std.device)
    H[new_of_old, :fe] = H_std
    return W, H


def tables_mxu_to_std(W_mxu, H_mxu, new_of_old, *, num_users_pad: int,
                      fe_std: int):
    """Inverse of tables_std_to_mxu, on device."""
    W = W_mxu[:num_users_pad, :fe_std]
    if num_users_pad > W_mxu.shape[0]:
        pad = torch.zeros((num_users_pad - W_mxu.shape[0], fe_std),
                          dtype=torch.float32, device=W_mxu.device)
        pad[:, fe_std - 1] = 1.0
        W = torch.cat([W, pad])
    return W.contiguous(), H_mxu[new_of_old, :fe_std].contiguous()
