"""One rating-SGD epoch over the chunk plan: the CUDA kernel's wrapper
and its plain PyTorch version.

``sgd_epoch`` replaces ``mymedialite_tpu/ops/pallas_sgd.py:461
sgd_epoch_mxu`` (kernel body ``_mxu_sgd_kernel`` :324). It updates the
kernel-layout tables ``W`` [n_ub*UB, fe] and ``H`` [n_ib*IB, fe] in
place, where the JAX version aliases its outputs to its inputs. On CUDA
tensors it launches ``csrc/sgd_epoch.cu`` (one launch per epoch) or
raises; on CPU tensors it runs ``sgd_epoch_reference``.

Arguments shared by both:

- ``packed`` [nc, 4, C] int32: per chunk, rows u_loc, i_loc, the bits
  of the rating and the bits of the slot weight (``ops/plan.py``);
- ``order`` = (ub, ib, row) int32 [nc]: the epoch's chunk visit order;
- ``hp`` = (global_bias, min_rating, rating_range) floats;
- ``rates`` [fe, 4] float32: per-column (w_lr, w_reg, h_lr, h_reg),
  already scaled by the current learn rate;
- ``user_block`` / ``item_block``: the plan's UB / IB, so that chunk k
  touches W rows ub[k]*UB + u_loc and H rows ib[k]*IB + i_loc.
"""

from __future__ import annotations

import torch

from mymedialite_tpu_torch.ops.sgd import gradient_common

# the kernel keeps up to 8 columns per lane in registers
MAX_FE = 256
# the chunk and the rates are staged in the default 48 KB of shared memory
MAX_CHUNK = 2048


def sgd_epoch_reference(W, H, packed, order, hp, rates, *, user_block: int,
                        item_block: int, loss: int, biased: bool):
    """Plain PyTorch epoch: a Python loop over the chunks, gathers by
    indexing and scatter-adds with ``index_add_``. In place."""
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


def _check(W, H, packed, order, rates):
    dev = W.device
    for name, t, dtype in (("W", W, torch.float32), ("H", H, torch.float32),
                           ("packed", packed, torch.int32),
                           ("rates", rates, torch.float32),
                           ("order.ub", order[0], torch.int32),
                           ("order.ib", order[1], torch.int32),
                           ("order.row", order[2], torch.int32)):
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
        raise ValueError("sgd_epoch: order must be three equal 1-D tensors")


def sgd_epoch(W, H, packed, order, hp, rates, *, user_block: int,
              item_block: int, loss: int, biased: bool):
    """One epoch, in place on ``W`` and ``H``; returns them."""
    _check(W, H, packed, order, rates)
    if W.device.type == "cpu":
        return sgd_epoch_reference(W, H, packed, order, hp, rates,
                                   user_block=user_block,
                                   item_block=item_block, loss=loss,
                                   biased=biased)
    if W.device.type != "cuda":
        raise ValueError(f"sgd_epoch: no kernel for device {W.device}")
    C = packed.shape[2]
    fe = W.shape[1]
    if fe > MAX_FE or C > MAX_CHUNK:
        raise ValueError(f"sgd_epoch: kernel takes fe <= {MAX_FE} and "
                         f"chunk <= {MAX_CHUNK}, got fe={fe} chunk={C}")
    from mymedialite_tpu_torch.ops._build import load_library
    lib = load_library().lib
    scratch = torch.empty(2 * C * fe, dtype=torch.float32, device=W.device)
    ub, ib, row = order
    gb, min_rating, rating_range = (float(x) for x in hp)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    err = lib.mml_sgd_epoch(
        W.data_ptr(), H.data_ptr(), packed.data_ptr(), ub.data_ptr(),
        ib.data_ptr(), row.data_ptr(), rates.data_ptr(), scratch.data_ptr(),
        order[0].numel(), C, user_block, item_block, fe, gb, min_rating,
        rating_range, int(loss), int(bool(biased)), stream)
    if err != 0:
        raise RuntimeError(f"sgd_epoch: kernel launch failed, CUDA error {err}")
    sgd_epoch.launches += 1
    return W, H


sgd_epoch.launches = 0
