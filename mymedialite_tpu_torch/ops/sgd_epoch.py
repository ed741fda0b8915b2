"""One rating-SGD epoch over the chunk plan: the CUDA kernel's wrappers
and their plain PyTorch versions.

``sgd_epoch`` replaces ``mymedialite_tpu/ops/pallas_sgd.py:461
sgd_epoch_mxu`` (kernel body ``_mxu_sgd_kernel`` :324), the resident
schedule; ``sgd_epoch_tiled`` replaces ``sgd_epoch_mxu_tiled`` :939
(kernel body ``_mxu_sgd_tiled_kernel`` :745), the slab-tiled schedule of
big catalogs. Both update the kernel-layout tables ``W`` [n_ub*UB, fe]
and ``H`` [n_ib*IB, fe] in place, where the JAX versions alias their
outputs to their inputs. On CUDA tensors they launch
``csrc/sgd_epoch.cu`` (one launch per epoch, of one thread-block
cluster of ``cluster_size`` CTAs that splits each chunk's slots; the
tiled wrapper first forms the absolute item blocks; ``ops/cluster.py``)
or raise, also where the kernel does not take the shape (``check_kernel_shape``: fe and the
chunk multiples of 4, fe <= 256, three chunks, their segment tables and
the rates within 227 KB of shared memory, beside at least one row of the
owner scatter's stage) and where the card cannot place the cluster.
The kernel adds each row's deltas in slot order, as
``index_add_`` does on the CPU, from the segment tables of
``ops/segments.py`` (built on the card once per ``packed``), so two runs
give the same tables bit for bit, whatever the cluster.
On CPU tensors they run ``sgd_epoch_reference`` /
``sgd_epoch_tiled_reference``. Each counts its own launches.
``sgd_epoch_sharded`` / ``sgd_epoch_sharded_tiled`` (``pallas_sgd.py
:1126``, ``:1354``) run one epoch over a device mesh: the same wrapper
once for each non-empty (device, sub-epoch) cell of this process, on
that device's W shard and the item partition it holds, the partitions
passed between processes too (``parallel/mesh.py diagonal_epoch``);
each cell's launch counts once, in the process that runs it.

Arguments shared by both:

- ``packed`` [nc, 4, C] int32: per chunk, rows u_loc, i_loc, the bits
  of the rating and the bits of the slot weight (``ops/plan.py``);
- ``order`` = (ub, ib, row) int32 [nc]: the epoch's chunk visit order;
  for the tiled schedule (ub, ibr, sl, row), the chunk's item block
  being ``sl * slab_blocks + ibr`` (``MxuTiledPlan.epoch_order``);
- ``hp`` = (global_bias, min_rating, rating_range) floats;
- ``rates`` [fe, 4] float32: per-column (w_lr, w_reg, h_lr, h_reg),
  already scaled by the current learn rate;
- ``user_block`` / ``item_block``: the plan's UB / IB, so that chunk k
  touches W rows ub[k]*UB + u_loc and H rows ib[k]*IB + i_loc.
"""

from __future__ import annotations

import torch

from mymedialite_tpu_torch.ops import cluster as _cluster
from mymedialite_tpu_torch.ops.cluster import (
    DYNAMIC_SHARED_BYTES, MAX_SHARED_BYTES, check_cluster_launch,
)
from mymedialite_tpu_torch.ops.segments import (
    round8, runs_length, segments_of,
)
from mymedialite_tpu_torch.ops.sgd import gradient_common

# the kernel keeps up to two float4s of a row per lane in registers
MAX_FE = 256
# the kernel stages the rates, three chunks' rows and segment tables and
# its part of the owner scatter's values in DYNAMIC_SHARED_BYTES of shared
# memory (ops/cluster.py)


def cluster_size(chunk: int) -> int:
    """N, the CTAs of the cluster that runs a chunk of ``chunk`` slots
    (kernels 1-2; ``ops/cluster.py``)."""
    return _cluster.cluster_size(chunk, "sgd")


def shared_bytes(fe: int, chunk: int) -> int:
    """A CTA's dynamic shared memory before its stage: the rates [4, fe],
    three chunks' packed rows [3, 4, C] and the runs and codes of their
    segment tables [3, RL + 2 Cw], the live float4 lists and their
    inverse, and one row of the stage (the rest of the CTA's shared
    memory is its part of the stage)."""
    runs_codes = runs_length(2 * chunk) + 2 * round8(chunk)
    return 16 * fe + 48 * chunk + 6 * runs_codes \
        + 4 * ((fe + 3) // 4 * 4) + 4 * fe


def check_kernel_shape(fe: int, chunk: int):
    """Raise ValueError unless the kernel takes the width ``fe`` and the
    chunk: both multiples of 4 (float4 rows, 16-byte pieces of each
    chunk), fe <= MAX_FE, and the shared memory within
    MAX_SHARED_BYTES."""
    if fe > MAX_FE or fe % 4 or chunk % 4 \
            or shared_bytes(fe, chunk) > DYNAMIC_SHARED_BYTES:
        raise ValueError(f"sgd_epoch: kernel takes fe <= {MAX_FE}, fe and "
                         f"the chunk multiples of 4, and {MAX_SHARED_BYTES} B "
                         f"of shared memory, got fe={fe} chunk={chunk}")


def sgd_epoch_reference(W, H, packed, order, hp, rates, *, user_block: int,
                        item_block: int, loss: int, biased: bool):
    """Plain PyTorch epoch: a Python loop over the chunks, gathers by
    indexing and scatter-adds with ``index_add_`` (in slot order on the
    CPU, the kernel's order). In place."""
    ub, ib, row = (t.tolist() for t in order)
    gb, min_rating, rating_range = (float(x) for x in hp)
    w_lr, w_reg, h_lr, h_reg = rates.unbind(1)
    for k in range(len(row)):
        d = packed[row[k]]
        u = d[0].long() + ub[k] * user_block
        i = d[1].long() + ib[k] * item_block
        v = d[2].view(torch.float32)
        wt = d[3].view(torch.float32)
        wu, hi = W[u], H[i]
        score = (wu * hi).sum(dim=1)
        if biased:
            sig = torch.sigmoid(score + gb)
            err = v - (min_rating + sig * rating_range)
            g = gradient_common(loss, err, sig, rating_range) * wt
        else:
            g = (v - (score + gb)) * wt
        W.index_add_(0, u, w_lr * (g[:, None] * hi - wt[:, None] * w_reg * wu))
        H.index_add_(0, i, h_lr * (g[:, None] * wu - wt[:, None] * h_reg * hi))
    return W, H


def sgd_epoch_tiled_reference(W, H, packed, order, hp, rates, *,
                              slab_blocks: int, user_block: int,
                              item_block: int, loss: int, biased: bool):
    """Plain PyTorch epoch over the slab-tiled order (ub, ibr, sl, row):
    ``sgd_epoch_reference`` with the absolute item block sl * B + ibr."""
    ub, ibr, sl, row = order
    return sgd_epoch_reference(W, H, packed, (ub, sl * slab_blocks + ibr, row),
                               hp, rates, user_block=user_block,
                               item_block=item_block, loss=loss, biased=biased)


def _check(W, H, packed, order, rates):
    dev = W.device
    names = ("ub", "ib", "row") if len(order) == 3 else \
        ("ub", "ibr", "sl", "row")
    for name, t, dtype in (("W", W, torch.float32), ("H", H, torch.float32),
                           ("packed", packed, torch.int32),
                           ("rates", rates, torch.float32),
                           *((f"order.{n}", o, torch.int32)
                             for n, o in zip(names, order))):
        if t.device != dev:
            raise ValueError(f"sgd_epoch: {name} is on {t.device}, W on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"sgd_epoch: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sgd_epoch: {name} must be contiguous")
    fe = W.shape[1]
    if W.dim() != 2 or H.dim() != 2 or H.shape[1] != fe:
        raise ValueError("sgd_epoch: W and H must be 2-D with equal widths")
    if tuple(rates.shape) != (fe, 4):
        raise ValueError(f"sgd_epoch: rates must be [{fe}, 4]")
    if packed.dim() != 3 or packed.shape[1] != 4:
        raise ValueError("sgd_epoch: packed must be [nc, 4, C]")
    if not all(t.dim() == 1 and t.numel() == order[0].numel()
               for t in order):
        raise ValueError("sgd_epoch: order must be equal 1-D tensors")


def _launch(W, H, packed, order, hp, rates, *, user_block: int,
            item_block: int, loss: int, biased: bool):
    """Launch mml_sgd_epoch over the order (ub, ib, row), ib absolute, on
    W's stream."""
    C, fe = packed.shape[2], W.shape[1]
    check_kernel_shape(fe, C)
    if W.device.type != "cuda":
        raise ValueError(f"sgd_epoch: no kernel for device {W.device}")
    from mymedialite_tpu_torch.ops._build import load_library
    fn = load_library().lib.mml_sgd_epoch
    cluster = cluster_size(C)
    segs = segments_of(packed)
    scratch = torch.empty(2 * C * fe, dtype=torch.float32, device=W.device)
    gb, min_rating, rating_range = (float(x) for x in hp)
    # the kernel launches on the current device: make it W's
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = fn(W.data_ptr(), H.data_ptr(), packed.data_ptr(),
                 segs.data_ptr(), *(o.data_ptr() for o in order),
                 rates.data_ptr(), scratch.data_ptr(), order[0].numel(), C,
                 runs_length(2 * C), user_block, item_block, fe,
                 DYNAMIC_SHARED_BYTES, cluster, gb, min_rating,
                 rating_range, int(loss), int(bool(biased)), stream)
    check_cluster_launch("sgd_epoch", err, cluster, DYNAMIC_SHARED_BYTES)


def sgd_epoch(W, H, packed, order, hp, rates, *, user_block: int,
              item_block: int, loss: int, biased: bool):
    """One epoch of the resident schedule, in place on ``W`` and ``H``;
    returns them."""
    _check(W, H, packed, order, rates)
    kw = dict(user_block=user_block, item_block=item_block, loss=loss,
              biased=biased)
    if W.device.type == "cpu":
        return sgd_epoch_reference(W, H, packed, order, hp, rates, **kw)
    _launch(W, H, packed, order, hp, rates, **kw)
    sgd_epoch.launches += 1
    return W, H


def sgd_epoch_tiled(W, H, packed, order, hp, rates, *, slab_blocks: int,
                    user_block: int, item_block: int, loss: int,
                    biased: bool):
    """One epoch of the slab-tiled schedule, in place on ``W`` and ``H``;
    returns them."""
    _check(W, H, packed, order, rates)
    kw = dict(user_block=user_block, item_block=item_block, loss=loss,
              biased=biased)
    if W.device.type == "cpu":
        return sgd_epoch_tiled_reference(W, H, packed, order, hp, rates,
                                         slab_blocks=slab_blocks, **kw)
    ub, ibr, sl, row = order
    _launch(W, H, packed, (ub, sl * slab_blocks + ibr, row), hp, rates, **kw)
    sgd_epoch_tiled.launches += 1
    return W, H


def _sharded(mesh, W_shards, H_parts, packed, order, counts, hp, rates,
             run, **kw):
    """The diagonal epoch with ``run`` on each of this process's cells:
    the cell's W shard and partition, the chunks of ``packed`` on its
    device, its order."""
    from mymedialite_tpu_torch.parallel.mesh import diagonal_epoch
    packed, rates = mesh.replicate(packed), mesh.replicate(rates)

    def cell(d, k, H, cols):
        run(W_shards[d], H, packed[d], cols, hp, rates[d], **kw)

    H_parts[:] = diagonal_epoch(mesh, H_parts, order, counts, cell)
    return W_shards, H_parts


def sgd_epoch_sharded(mesh, W_shards, H_parts, packed, order, counts, hp,
                      rates, *, user_block: int, item_block: int, loss: int,
                      biased: bool, plain: bool = False):
    """One epoch of the sharded schedule (``pallas_sgd.py:1126
    sgd_epoch_mxu_sharded``) over the mesh: ``sgd_epoch`` once for each
    non-empty cell (global device g, sub-epoch k) of this process, on
    its W shard [u_pad_dev, fe] (``W_shards[d]``, g = ``first_device`` +
    d) and the partition [part_rows, fe] that device g holds, the order
    (ub, ib, row) of ``MxuShardedPlan.epoch_order`` relative to both
    (every global device's rows; ``counts`` its cells' chunks); the
    partitions ring-shift between sub-epochs, across processes too
    (``parallel/mesh.py diagonal_epoch``). ``packed`` is the
    plan's chunks, or their copies on the mesh devices
    (``Mesh.replicate``), which a caller keeps across epochs. W shards
    update in place; ``H_parts`` (partition g on global device g, this
    process's) is refilled with the partitions after the epoch. ``plain`` selects the
    reference: every cell runs ``sgd_epoch_reference`` instead, on any
    device, over the same cells and ring (what ``chip_smoke.py`` and the
    tests hold the kernel to; no model sets it). Returns (W_shards,
    H_parts)."""
    return _sharded(mesh, W_shards, H_parts, packed, order, counts, hp, rates,
                    sgd_epoch_reference if plain else sgd_epoch,
                    user_block=user_block, item_block=item_block, loss=loss,
                    biased=biased)


def sgd_epoch_sharded_tiled(mesh, W_shards, H_parts, packed, order, counts,
                            hp, rates, *, slab_blocks: int, user_block: int,
                            item_block: int, loss: int, biased: bool,
                            plain: bool = False):
    """``sgd_epoch_sharded`` over the slab-tiled partitions
    (``pallas_sgd.py:1354 sgd_epoch_mxu_sharded_tiled``): ``sgd_epoch_tiled``
    once for each non-empty cell, on the order (ub, ibr, isl, row) of
    ``MxuShardedTiledPlan.epoch_order`` (isl relative to the partition);
    ``plain`` selects the reference, ``sgd_epoch_tiled_reference``, as
    in ``sgd_epoch_sharded``."""
    return _sharded(mesh, W_shards, H_parts, packed, order, counts, hp, rates,
                    sgd_epoch_tiled_reference if plain else sgd_epoch_tiled,
                    slab_blocks=slab_blocks, user_block=user_block,
                    item_block=item_block, loss=loss, biased=biased)


sgd_epoch.launches = 0
sgd_epoch_tiled.launches = 0
