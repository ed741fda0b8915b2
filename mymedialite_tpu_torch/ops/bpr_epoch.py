"""One BPR epoch over the chunk plan, negatives sampled inside: the CUDA
kernel's wrappers and their plain PyTorch versions.

``bpr_epoch`` replaces ``mymedialite_tpu/ops/pallas_bpr.py:691
bpr_epoch_mxu`` (kernel body ``_mxu_bpr_kernel`` :451), the resident
schedule; ``bpr_epoch_tiled`` replaces ``bpr_epoch_mxu_tiled`` :1220
(kernel body ``_mxu_bpr_tiled_kernel`` :979), the slab-tiled schedule of
big catalogs. Both update the kernel-layout tables ``W`` [n_ub*UB, fe]
and ``H`` [n_ib*IB, fe] in place, where the JAX versions alias their
outputs to their inputs. On CUDA tensors they call ``csrc/bpr_epoch.cu``
(one call per epoch: a kernel that samples every slot's negative over
the whole card, then the walk of the chunks, one thread-block cluster of
``cluster_size`` CTAs that splits each chunk's slots, ``ops/cluster.py``;
the tiled wrapper passes the absolute positive blocks isl * slab_blocks
+ ibr and the order's absolute negative blocks jb) or raise, also where
the card cannot place the cluster; on CPU tensors they run
``bpr_epoch_reference`` / ``bpr_epoch_tiled_reference``. Each counts its
own calls. ``bpr_epoch_sharded`` / ``bpr_epoch_sharded_tiled``
(``pallas_bpr.py:1519``, ``:1860``) run one epoch over a device mesh: the
same wrapper once for each non-empty (device, sub-epoch) cell of this
process, its negatives drawn within the item partition the device holds
(across processes too: ``parallel/mesh.py diagonal_epoch``).

Arguments shared by both (``ops/bpr_plan.py`` builds them):

- ``packed`` [nc, 4, C] int32: per chunk u_loc, i_loc, the bits of the
  event's base weight and the bits of the padding weight;
- the membership table: ``keys_tbl`` [*, Kcap] int32 (one ascending,
  -1 padded key row per bucket), with ``subkeys=True`` the sub-bucketed
  ``subkeys_tbl`` [n_bkt * 8, Ksub] (row bkt * 8 + (u_loc & 7)), or
  ``bitmask_tbl`` [n_bkt, UB, IB/8] int8 (used when given);
- ``cdf_tbl`` [*, IB] float32: per-block popularity CDF (WBPR only);
- ``bits`` [nc, T, C] int32: the epoch's random bits, in visit order;
- ``rates`` [fe, 6] float32: (w_lr, w_reg, i_lr, i_reg, j_lr, j_reg);
- the visit order. Resident: ``order`` = (ub, ib, row) and ``jb``,
  ``nval``, ``bkt``, int32 [nc] each (the negative block of each visited
  chunk, its real item count, its membership bucket). Tiled: ``order``
  = (ub, ibr, isl, jb, jbr, jsl, nval, bkt, row) from
  ``bpr_plan.bpr_tiled_epoch_order``, the positive block being
  isl * slab_blocks + ibr and the negative one jb = jsl * slab_blocks +
  jbr.

With ``return_negatives`` the epoch also returns ``neg`` [nc, 2, C]
int32 in visit order: the sampled local negative of every slot and the
bits of its 0/1 success weight, as the JAX kernels' ``neg_dbg``. On the
card this is the buffer that the sampling kernel fills and the walk
reads (about 173 MB at the Netflix and ML-25M shapes), made every epoch.

On the card the sampling kernel also builds each chunk's segment table
(``ops/segments.py``: the runs and the codes, 2 (RL + 3 Cw) bytes a
chunk, about 324 MB at the Netflix shape's 33,750 chunks of 640), and
the walk adds each row's deltas in the plain version's order from it:
W's in slot order, H's i deltas before its j deltas, each in slot order.
Two runs from the same tables, order and bits give the same tables bit
for bit. ``sampler_tables`` runs the sampling kernel alone and returns
its negatives and tables, which ``chip_smoke.py`` and the card tests
hold to ``bpr_segments_reference``.
"""

from __future__ import annotations

import torch

from mymedialite_tpu_torch.ops import cluster as _cluster
from mymedialite_tpu_torch.ops.bpr_plan import SUBKEY_BUCKETS
from mymedialite_tpu_torch.ops.cluster import (
    DYNAMIC_SHARED_BYTES, MAX_SHARED_BYTES, check_cluster_launch,
)
from mymedialite_tpu_torch.ops.segments import (
    round8, runs_length, table_width,
)

# the walk keeps up to two float4s of a row per lane in registers
MAX_FE = 256
# the walk stages the rates, three chunks' rows and segment tables and its
# part of the owner scatter's values in DYNAMIC_SHARED_BYTES of shared
# memory (ops/cluster.py)
# membership forms of the kernel (csrc/bpr_epoch.cu)
_KEYS, _BITMASK, _SUBKEYS = 0, 1, 2


def cluster_size(chunk: int) -> int:
    """N, the CTAs of the cluster that runs a chunk of ``chunk`` slots
    (kernels 3-4; ``ops/cluster.py``)."""
    return _cluster.cluster_size(chunk, "bpr")


def sample_negatives_reference(bits, jb, nval, bkt, u_loc, *, item_block,
                               keys_tbl=None, bitmask_tbl=None, cdf_tbl=None,
                               wbpr=False, subkeys=False):
    """Plain sampler, vectorized over chunks: bits [nc, T, C], jb / nval
    / bkt [nc], u_loc [nc, C]. With ``subkeys`` the keys table is the
    sub-bucketed one and each slot tests its own u_loc & 7 row. Returns
    (j_loc [nc, C] int32, ok [nc, C] bool), bit for bit what the kernel
    samples."""
    IB = item_block
    r = bits & 0x7FFFFFFF                                   # [nc, T, C]
    if wbpr:
        u01 = r.to(torch.float32) * (1.0 / 2147483648.0)
        cdf = cdf_tbl[jb.long()]                           # [nc, IB]
        cand = (cdf[:, None, None, :] < u01[..., None]).sum(-1)
    else:
        cand = r % nval[:, None, None]
    cand = cand.to(torch.int32)
    u = u_loc[:, None, :].long()
    if bitmask_tbl is not None:
        byte = bitmask_tbl[bkt.long()[:, None, None], u,
                           (cand >> 3).long().clamp(max=IB // 8 - 1)]
        is_pos = (((byte.to(torch.int32) & 255) >> (cand & 7)) & 1) != 0
        is_pos &= (cand >> 3) < IB // 8
    elif subkeys:
        rows = bkt.long()[:, None] * SUBKEY_BUCKETS \
            + (u_loc.long() & (SUBKEY_BUCKETS - 1))         # [nc, C]
        keys = keys_tbl[rows]                               # [nc, C, Ksub]
        ckey = u * IB + cand                                # [nc, T, C]
        is_pos = (keys[:, None] == ckey[..., None]).any(-1)
    else:
        keys = keys_tbl[bkt.long()]                         # [nc, Kcap]
        ckey = u * IB + cand
        is_pos = (keys[:, None, None, :] == ckey[..., None]).any(-1)
    good = ~is_pos
    ok = good.any(1)
    first = good.to(torch.uint8).argmax(1, keepdim=True)  # first success
    j = cand.gather(1, first).squeeze(1)
    return torch.where(ok, j, torch.zeros_like(j)), ok


def _reference_loop(W, H, packed, keys_tbl, cdf_tbl, bits, ub, ib, row, jb,
                    nval, bkt, rates, *, user_block, item_block, soft_margin,
                    wbpr, bitmask_tbl, subkeys, return_negatives):
    """The plain epoch over visited chunks given by absolute blocks."""
    ubs, ibs, rows, jbs = (t.tolist() for t in (ub, ib, row, jb))
    w_lr, w_reg, i_lr, i_reg, j_lr, j_reg = rates.unbind(1)
    nc, C = len(rows), packed.shape[2]
    neg = torch.empty((nc, 2, C), dtype=torch.int32, device=W.device) \
        if return_negatives else None
    for k in range(nc):
        d = packed[rows[k]]
        j_loc, ok = sample_negatives_reference(
            bits[k:k + 1], jb[k:k + 1], nval[k:k + 1], bkt[k:k + 1], d[0:1],
            item_block=item_block, keys_tbl=keys_tbl, bitmask_tbl=bitmask_tbl,
            cdf_tbl=cdf_tbl, wbpr=wbpr, subkeys=subkeys)
        okf = ok[0].to(torch.float32)
        if neg is not None:
            neg[k, 0] = j_loc[0]
            neg[k, 1] = okf.view(torch.int32)
        wgt = d[2].view(torch.float32) * d[3].view(torch.float32) * okf
        u = d[0].long() + ubs[k] * user_block
        i = d[1].long() + ibs[k] * item_block
        j = j_loc[0].long() + jbs[k] * item_block
        wu, hi, hj = W[u], H[i], H[j]
        x = (wu * (hi - hj)).sum(dim=1)
        if soft_margin:
            g = (x < 1.0).to(torch.float32) * wgt
        else:
            g = torch.sigmoid(-x) * wgt
        g, wgt = g[:, None], wgt[:, None]
        W.index_add_(0, u, w_lr * (g * (hi - hj) - wgt * w_reg * wu))
        H.index_add_(0, i, i_lr * (g * wu - wgt * i_reg * hi))
        H.index_add_(0, j, j_lr * (-g * wu - wgt * j_reg * hj))
    return W, H, neg


def bpr_epoch_reference(W, H, packed, keys_tbl, cdf_tbl, bits, order, jb,
                        nval, bkt, rates, *, user_block: int, item_block: int,
                        soft_margin: bool = False, wbpr: bool = False,
                        bitmask_tbl=None, subkeys: bool = False,
                        return_negatives: bool = False):
    """Plain PyTorch epoch of the resident schedule: a Python loop over
    the chunks, the plain sampler per chunk, gathers by indexing and
    scatter-adds with ``index_add_`` (W, then H at i, then H at j, each in
    slot order on the CPU: the kernel's order). In place on W and H."""
    ub, ib, row = order
    return _reference_loop(
        W, H, packed, keys_tbl, cdf_tbl, bits, ub, ib, row, jb, nval, bkt,
        rates, user_block=user_block, item_block=item_block,
        soft_margin=soft_margin, wbpr=wbpr, bitmask_tbl=bitmask_tbl,
        subkeys=subkeys, return_negatives=return_negatives)


def bpr_epoch_tiled_reference(W, H, packed, keys_tbl, cdf_tbl, bits, order,
                              rates, *, slab_blocks: int, user_block: int,
                              item_block: int, soft_margin: bool = False,
                              wbpr: bool = False, bitmask_tbl=None,
                              subkeys: bool = False,
                              return_negatives: bool = False):
    """Plain PyTorch epoch of the slab-tiled schedule: the resident loop
    with the absolute blocks isl * B + ibr and jb = jsl * B + jbr."""
    ub, ib, row, jb, nval, bkt = tiled_cols(order, slab_blocks)
    return _reference_loop(
        W, H, packed, keys_tbl, cdf_tbl, bits, ub, ib, row, jb, nval, bkt,
        rates, user_block=user_block, item_block=item_block,
        soft_margin=soft_margin, wbpr=wbpr, bitmask_tbl=bitmask_tbl,
        subkeys=subkeys, return_negatives=return_negatives)


def tiled_cols(order, slab_blocks: int):
    """The tiled order (ub, ibr, isl, jb, jbr, jsl, nval, bkt, row) as the
    kernel's visit-order columns (ub, ib, row, jb, nval, bkt), the
    positive block absolute: isl * slab_blocks + ibr."""
    ub, ibr, isl, jb, _jbr, _jsl, nval, bkt, row = order
    return ub, isl * slab_blocks + ibr, row, jb, nval, bkt


def _check(W, H, packed, keys_tbl, bitmask_tbl, cdf_tbl, bits, order, rates,
           item_block, wbpr, subkeys):
    dev = W.device
    named = [("W", W, torch.float32), ("H", H, torch.float32),
             ("packed", packed, torch.int32), ("bits", bits, torch.int32),
             ("rates", rates, torch.float32)]
    named += [(f"order[{n}]", t, torch.int32) for n, t in enumerate(order)]
    if bitmask_tbl is None:
        named.append(("keys_tbl", keys_tbl, torch.int32))
    else:
        named.append(("bitmask_tbl", bitmask_tbl, torch.int8))
    if wbpr:
        named.append(("cdf_tbl", cdf_tbl, torch.float32))
    for name, t, dtype in named:
        if t is None:
            raise ValueError(f"bpr_epoch: {name} is required")
        if t.device != dev:
            raise ValueError(f"bpr_epoch: {name} is on {t.device}, W on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"bpr_epoch: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"bpr_epoch: {name} must be contiguous")
    fe = W.shape[1]
    if W.dim() != 2 or H.dim() != 2 or H.shape[1] != fe:
        raise ValueError("bpr_epoch: W and H must be 2-D with equal widths")
    if tuple(rates.shape) != (fe, 6):
        raise ValueError(f"bpr_epoch: rates must be [{fe}, 6]")
    if packed.dim() != 3 or packed.shape[1] != 4:
        raise ValueError("bpr_epoch: packed must be [nc, 4, C]")
    nc, C = order[0].numel(), packed.shape[2]
    if not all(t.dim() == 1 and t.numel() == nc for t in order):
        raise ValueError("bpr_epoch: the order, jb, nval and bkt must be "
                         "equal 1-D tensors")
    if bits.dim() != 3 or bits.shape[0] != nc or bits.shape[2] != C:
        raise ValueError(f"bpr_epoch: bits must be [{nc}, T, {C}]")
    if bitmask_tbl is not None and (bitmask_tbl.dim() != 3
                                    or bitmask_tbl.shape[2] * 8 != item_block):
        raise ValueError("bpr_epoch: bitmask_tbl must be [n_bkt, UB, IB/8]")
    if bitmask_tbl is not None and subkeys:
        raise ValueError("bpr_epoch: subkeys and bitmask_tbl exclude each "
                         "other")
    if wbpr and (cdf_tbl.dim() != 2 or cdf_tbl.shape[1] != item_block):
        raise ValueError("bpr_epoch: cdf_tbl must be [*, IB]")


def shared_bytes(fe: int, chunk: int) -> int:
    """A CTA's shared memory of the walk before its stage: the rates [6,
    fe], three chunks' packed and neg rows [3, 6, C] and the runs and
    codes of their segment tables [3, RL + 3 Cw], the live float4 lists
    and their inverse, and one row of the stage (the rest of the CTA's
    shared memory is its part of the stage)."""
    runs_codes = runs_length(3 * chunk) + 3 * round8(chunk)
    return 24 * fe + 72 * chunk + 6 * runs_codes + 4 * ((fe + 3) // 4 * 4) \
        + 4 * fe


def sample_shared_bytes(chunk: int) -> int:
    """Shared memory of the sampling kernel: the sort's keys (a power of
    two >= 3C, 8 bytes each)."""
    n = 1
    while n < round8(3 * chunk):
        n *= 2
    return 8 * n


def _check_launch(packed, user_block, item_block, fe=None):
    """Raise unless the sampling kernel takes the chunk and the blocks,
    and the walk (where ``fe`` is given) the width."""
    C = packed.shape[2]
    if packed.device.type != "cuda":
        raise ValueError(f"bpr_epoch: no kernel for device {packed.device}")
    walk = fe is not None and (fe > MAX_FE or fe % 4 or shared_bytes(fe, C)
                               > DYNAMIC_SHARED_BYTES)
    if walk or C % 4 or C > 4096 \
            or sample_shared_bytes(C) > DYNAMIC_SHARED_BYTES:
        raise ValueError(f"bpr_epoch: kernel takes fe <= {MAX_FE}, fe and "
                         f"the chunk multiples of 4, the chunk <= 4096, and "
                         f"{MAX_SHARED_BYTES} B of shared memory, got fe={fe} "
                         f"chunk={C}")
    if 2 * item_block > 1 << 40 or user_block > 1 << 40:
        raise ValueError("bpr_epoch: blocks past the sort key's 41 bits")


def _sampler_args(packed, keys_tbl, cdf_tbl, bits, cols, *, bitmask_tbl,
                  subkeys, wbpr):
    """The sampling kernel's outputs, every slot's negative ``neg`` [nc,
    2, C] and every chunk's segment table, and its table arguments."""
    nc, C = cols[0].numel(), packed.shape[2]
    neg = torch.empty((nc, 2, C), dtype=torch.int32, device=packed.device)
    segs = torch.empty((nc, table_width(C, 3 * C, 3)), dtype=torch.int16,
                       device=packed.device)
    if bitmask_tbl is not None:
        membership, keys = _BITMASK, bits       # keys unread
    else:
        membership, keys = (_SUBKEYS if subkeys else _KEYS), keys_tbl
    tables = (keys.data_ptr(),
              bitmask_tbl.data_ptr() if bitmask_tbl is not None else None,
              cdf_tbl.data_ptr() if wbpr else None, bits.data_ptr())
    kcap = keys.shape[1] if membership != _BITMASK else 0
    return neg, segs, tables, kcap, membership


def _launch(W, H, packed, keys_tbl, cdf_tbl, bits, cols, rates, *,
            user_block, item_block, soft_margin, wbpr, bitmask_tbl, subkeys,
            return_negatives):
    """Launch mml_bpr_epoch on W's stream over the visit-order columns
    ``cols`` = (ub, ib, row, jb, nval, bkt), blocks absolute; returns
    ``neg`` or None."""
    _check_launch(packed, user_block, item_block, W.shape[1])
    nc, C = cols[0].numel(), packed.shape[2]
    fe = W.shape[1]
    cluster = cluster_size(C)
    from mymedialite_tpu_torch.ops._build import load_library
    fn = load_library().lib.mml_bpr_epoch
    scratch = torch.empty(3 * C * fe, dtype=torch.float32, device=W.device)
    # every slot's sampled negative and every chunk's segment table: the
    # walk reads them
    neg, segs, tables, kcap, membership = _sampler_args(
        packed, keys_tbl, cdf_tbl, bits, cols, bitmask_tbl=bitmask_tbl,
        subkeys=subkeys, wbpr=wbpr)
    # the kernels launch on the current device: make it W's
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = fn(
            W.data_ptr(), H.data_ptr(), packed.data_ptr(),
            *(t.data_ptr() for t in cols), *tables, rates.data_ptr(),
            scratch.data_ptr(), neg.data_ptr(), segs.data_ptr(), nc, C,
            runs_length(3 * C), user_block, item_block, fe, bits.shape[1],
            kcap, int(bool(soft_margin)), int(bool(wbpr)), membership,
            DYNAMIC_SHARED_BYTES, cluster, stream)
    check_cluster_launch("bpr_epoch", err, cluster, DYNAMIC_SHARED_BYTES)
    return neg if return_negatives else None


def sampler_tables(packed, keys_tbl, cdf_tbl, bits, cols, *, user_block: int,
                   item_block: int, wbpr: bool = False, bitmask_tbl=None,
                   subkeys: bool = False):
    """The sampling kernel of an epoch alone, on the card: returns (neg
    [nc, 2, C], the segment tables [nc, table_width(C, 3C, 3)] int16) in
    visit order, what the walk of ``bpr_epoch`` / ``bpr_epoch_tiled`` on
    the same inputs reads. ``cols`` = (ub, ib, row, jb, nval, bkt), blocks
    absolute: the resident (*order, jb, nval, bkt), or ``tiled_cols``.
    Its launches are not counted: it is the check of what the walk reads
    (``ops/segments.py bpr_segments_reference`` is its plain version), not
    a route."""
    _check_launch(packed, user_block, item_block)
    nc, C = cols[0].numel(), packed.shape[2]
    from mymedialite_tpu_torch.ops._build import load_library
    fn = load_library().lib.mml_bpr_sample
    neg, segs, tables, kcap, membership = _sampler_args(
        packed, keys_tbl, cdf_tbl, bits, cols, bitmask_tbl=bitmask_tbl,
        subkeys=subkeys, wbpr=wbpr)
    ub, ib, row, jb, nval, bkt = cols
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = fn(packed.data_ptr(), ib.data_ptr(), row.data_ptr(),
                 jb.data_ptr(), nval.data_ptr(), bkt.data_ptr(), *tables,
                 neg.data_ptr(), segs.data_ptr(), nc, C, runs_length(3 * C),
                 user_block, item_block, bits.shape[1], kcap,
                 int(bool(wbpr)), membership, stream)
    if err != 0:
        raise RuntimeError(f"bpr_epoch: sampling kernel launch failed, CUDA "
                           f"error {err}")
    return neg, segs


def bpr_epoch(W, H, packed, keys_tbl, cdf_tbl, bits, order, jb, nval, bkt,
              rates, *, user_block: int, item_block: int,
              soft_margin: bool = False, wbpr: bool = False,
              bitmask_tbl=None, subkeys: bool = False,
              return_negatives: bool = False):
    """One epoch of the resident schedule, in place on ``W`` and ``H``;
    returns (W, H, neg), neg None unless ``return_negatives``."""
    _check(W, H, packed, keys_tbl, bitmask_tbl, cdf_tbl, bits,
           (*order, jb, nval, bkt), rates, item_block, wbpr, subkeys)
    kw = dict(soft_margin=soft_margin, wbpr=wbpr, bitmask_tbl=bitmask_tbl,
              subkeys=subkeys, return_negatives=return_negatives)
    if W.device.type == "cpu":
        return bpr_epoch_reference(W, H, packed, keys_tbl, cdf_tbl, bits,
                                   order, jb, nval, bkt, rates,
                                   user_block=user_block,
                                   item_block=item_block, **kw)
    neg = _launch(W, H, packed, keys_tbl, cdf_tbl, bits,
                  (*order, jb, nval, bkt), rates, user_block=user_block,
                  item_block=item_block, **kw)
    bpr_epoch.launches += 1
    return W, H, neg


def bpr_epoch_tiled(W, H, packed, keys_tbl, cdf_tbl, bits, order, rates, *,
                    slab_blocks: int, user_block: int, item_block: int,
                    soft_margin: bool = False, wbpr: bool = False,
                    bitmask_tbl=None, subkeys: bool = False,
                    return_negatives: bool = False):
    """One epoch of the slab-tiled schedule, in place on ``W`` and ``H``;
    returns (W, H, neg), neg None unless ``return_negatives``."""
    _check(W, H, packed, keys_tbl, bitmask_tbl, cdf_tbl, bits, order, rates,
           item_block, wbpr, subkeys)
    kw = dict(soft_margin=soft_margin, wbpr=wbpr, bitmask_tbl=bitmask_tbl,
              subkeys=subkeys, return_negatives=return_negatives)
    if W.device.type == "cpu":
        return bpr_epoch_tiled_reference(
            W, H, packed, keys_tbl, cdf_tbl, bits, order, rates,
            slab_blocks=slab_blocks, user_block=user_block,
            item_block=item_block, **kw)
    neg = _launch(W, H, packed, keys_tbl, cdf_tbl, bits,
                  tiled_cols(order, slab_blocks), rates,
                  user_block=user_block, item_block=item_block, **kw)
    bpr_epoch_tiled.launches += 1
    return W, H, neg


def _sharded(mesh, W_shards, H_parts, packed, keys_tbl, cdf_tbl, bits,
             order, counts, rates, run_cell, *, part_blocks, bitmask_tbl,
             return_negatives):
    """The diagonal epoch over this process's BPR cells: ``run_cell(W, H,
    packed, keys, cdf, bits, cols, rates, bitmask_tbl)`` on each, with
    the rows of ``cdf_tbl`` of the partition that its global device g
    holds (the cell's negative blocks are relative to the partition) and
    the bits ``bits[g][k]``. Returns (W_shards, H_parts, negs), negs
    [d][k] the negatives of local device d's cells, or None."""
    from mymedialite_tpu_torch.parallel.mesh import diagonal_epoch
    L, D, g0 = mesh.size, mesh.global_size, mesh.first_device
    packed, keys, cdf, rates = (mesh.replicate(t) for t in (
        packed, keys_tbl, cdf_tbl, rates))
    masks = (mesh.replicate(bitmask_tbl) if bitmask_tbl is not None
             else [None] * L)
    negs = [[None] * D for _ in range(L)]

    def cell(d, k, H, cols):
        dev = W_shards[d].device
        g = g0 + d
        lo = ((g + k) % D) * part_blocks
        part_cdf = cdf[d][lo:lo + part_blocks]
        cell_bits = bits[g][k][:cols[0].numel()].to(dev)
        negs[d][k] = run_cell(W_shards[d], H, packed[d], keys[d], part_cdf,
                              cell_bits, cols, rates[d], masks[d])[2]

    H_parts[:] = diagonal_epoch(mesh, H_parts, order, counts, cell)
    return W_shards, H_parts, negs if return_negatives else None


def bpr_epoch_sharded(mesh, W_shards, H_parts, packed, keys_tbl, cdf_tbl,
                      bits, order, counts, rates, *, part_blocks: int,
                      user_block: int, item_block: int,
                      soft_margin: bool = False, wbpr: bool = False,
                      bitmask_tbl=None, return_negatives: bool = False,
                      plain: bool = False):
    """One BPR epoch of the sharded schedule (``pallas_bpr.py:1519
    bpr_epoch_mxu_sharded``) over the mesh: ``bpr_epoch`` once for each
    non-empty cell (global device g, sub-epoch k) of this process, on
    its W shard and the partition that device g holds, over the order (ub, ib, jb, jbg, nval,
    bkt, row) of ``bpr_plan.bpr_sharded_epoch_order`` (``counts`` its
    cells' chunks): blocks ub, ib and the negative block jb relative to
    the shard and the partition, so that the kernel reads H and the
    partition's rows of ``cdf_tbl`` at jb; the membership buckets bkt
    index the global ``keys_tbl`` / ``bitmask_tbl``, which every device
    reads whole (jbg is not read: the JAX kernel's CDF row). ``order``
    and ``counts`` hold every global device's rows; ``bits[g][k]`` holds
    at least the cell's [n, T, C] random bits (None, or absent rows,
    for another process's devices). ``packed`` and the
    tables may each be one tensor or its copies on the mesh devices
    (``Mesh.replicate``), which a caller keeps across epochs. The partitions
    ring-shift between sub-epochs (``parallel/mesh.py diagonal_epoch``).
    This process's W shards update in place and its ``H_parts`` are
    refilled. ``plain``
    selects the reference: each cell runs ``bpr_epoch_reference``, on any
    device, over the same cells, ring and CDF rows (what ``chip_smoke.py``
    and the tests hold the kernel to; no model sets it). Returns
    (W_shards, H_parts, negs), negs[d][k] local device d's cell's [n, 2,
    C] negatives with ``return_negatives`` (None for an empty cell), else
    None."""
    epoch = bpr_epoch_reference if plain else bpr_epoch

    def run_cell(W, H, pk, keys, cdf, cell_bits, cols, rt, mask):
        ub, ib, jb, _jbg, nval, bkt, row = cols
        return epoch(W, H, pk, keys, cdf, cell_bits, (ub, ib, row), jb, nval,
                     bkt, rt, user_block=user_block, item_block=item_block,
                     soft_margin=soft_margin, wbpr=wbpr, bitmask_tbl=mask,
                     return_negatives=return_negatives)

    return _sharded(mesh, W_shards, H_parts, packed, keys_tbl, cdf_tbl, bits,
                    order, counts, rates, run_cell, part_blocks=part_blocks,
                    bitmask_tbl=bitmask_tbl,
                    return_negatives=return_negatives)


def bpr_epoch_sharded_tiled(mesh, W_shards, H_parts, packed, keys_tbl,
                            cdf_tbl, bits, order, counts, rates, *,
                            part_blocks: int, slab_blocks: int,
                            user_block: int, item_block: int,
                            soft_margin: bool = False, wbpr: bool = False,
                            subkeys: bool = True,
                            return_negatives: bool = False,
                            plain: bool = False):
    """``bpr_epoch_sharded`` over slab-tiled partitions (``pallas_bpr.py
    :1860 bpr_epoch_mxu_sharded_tiled``): ``bpr_epoch_tiled`` once for
    each non-empty cell over the order (ub, ibr, isl, jb, jbr, jsl, nval,
    bkt, row) of ``bpr_plan.bpr_sharded_tiled_epoch_order``, its global
    negative block jb handed to the kernel as jsl * slab_blocks + jbr,
    relative to the partition (the H row and the partition's CDF row);
    ``keys_tbl`` the sub-bucketed keys with ``subkeys``. ``plain``
    selects the reference, ``bpr_epoch_tiled_reference``, as in
    ``bpr_epoch_sharded``."""
    epoch = bpr_epoch_tiled_reference if plain else bpr_epoch_tiled

    def run_cell(W, H, pk, keys, cdf, cell_bits, cols, rt, _mask):
        ub, ibr, isl, _jb, jbr, jsl, nval, bkt, row = cols
        jb_rel = jsl * slab_blocks + jbr
        return epoch(W, H, pk, keys, cdf, cell_bits,
                     (ub, ibr, isl, jb_rel, jbr, jsl, nval, bkt, row), rt,
                     slab_blocks=slab_blocks, user_block=user_block,
                     item_block=item_block, soft_margin=soft_margin,
                     wbpr=wbpr, subkeys=subkeys,
                     return_negatives=return_negatives)

    return _sharded(mesh, W_shards, H_parts, packed, keys_tbl, cdf_tbl, bits,
                    order, counts, rates, run_cell, part_blocks=part_blocks,
                    bitmask_tbl=None, return_negatives=return_negatives)


bpr_epoch.launches = 0
bpr_epoch_tiled.launches = 0
