"""One SVD++ epoch over the static S/R/Y schedule: the CUDA kernel's
wrapper and its plain PyTorch version.

``svdpp_epoch`` replaces ``mymedialite_tpu/ops/pallas_svdpp.py:460
svdpp_epoch_mxu`` (kernel body ``_svdpp_kernel`` :308). It updates the
kernel-layout tables ``W`` [u_pad, fe], ``Q`` and ``Y`` [i_pad, fe]
(``ops/svdpp_plan.py``) in place, where the JAX version aliases its
outputs to its inputs. On CUDA tensors it launches
``csrc/svdpp_epoch.cu`` (one launch per epoch) or raises; on CPU tensors
it runs ``svdpp_epoch_reference``. It counts its own launches.

Per user block (the schedule visits each once, its chunks contiguous),
with s and c [UB, fe] set to zero when the block starts:

- S, per edge chunk: s[u] += wt * Y[i];
- R, per rating chunk, from the rows as they stood before the chunk:
  su = W[u] + mf * s[u] * inv_u (inv_u = W[u, f+2]), the score
  <su, Q[i]>, the plain or sigmoid gradient g (times wt), then
  W[u] += w_lr * (g * Q[i] - wt * w_reg * W[u]),
  Q[i] += q_lr * (g * su - wt * q_reg * Q[i]),
  c[u] += mf * g * inv_u * Q[i], and c[u, f] += wt (the rating count);
- Y, per edge chunk: Y[i] += y_lr * wt * (mf * c[u] - c[u, f] * y_reg *
  Y[i]), again from the rows before the chunk.

Duplicate rows within a chunk sum. Arguments: ``packed`` [nc, 4, C]
int32 (rows u_loc, i_loc, bits of the rating, bits of the slot weight);
``schedule`` = (ph, ub, ib, row) int32 [steps]; ``hp`` = (global_bias,
min_rating, rating_range) floats; ``rates`` [fe, 8] float32
(``svdpp_mxu_rates``); ``user_block`` / ``item_block``, so that a chunk
touches W rows ub*UB + u_loc and Q/Y rows ib*IB + i_loc.
"""

from __future__ import annotations

import torch

from mymedialite_tpu_torch.ops.sgd import gradient_common

# the kernel keeps up to 8 columns per lane in registers
MAX_FE = 256
# the chunk and the rates are staged in the default 48 KB of shared memory
MAX_CHUNK = 2048


def svdpp_epoch_reference(W, Q, Y, packed, schedule, hp, rates, *,
                          user_block: int, item_block: int, num_factors: int,
                          loss: int, sigmoid: bool):
    """Plain PyTorch epoch: a Python loop over the schedule, gathers by
    indexing and scatter-adds with ``index_add_``. In place."""
    ph, ub, ib, row = (t.tolist() for t in schedule)
    gb, min_rating, rating_range = (float(x) for x in hp)
    f = num_factors
    w_lr, w_reg, q_lr, q_reg, mf, _, y_lr, y_reg = rates.unbind(1)
    s = torch.zeros((user_block, W.shape[1]), dtype=W.dtype, device=W.device)
    c = torch.zeros_like(s)
    prev = None
    for k in range(len(row)):
        if ub[k] != prev:
            s.zero_()
            c.zero_()
            prev = ub[k]
        d = packed[row[k]]
        u = d[0].long()
        i = d[1].long() + ib[k] * item_block
        wt = d[3].view(torch.float32)
        if ph[k] == 0:
            s.index_add_(0, u, Y[i] * wt[:, None])
        elif ph[k] == 1:
            gu = u + ub[k] * user_block
            v = d[2].view(torch.float32)
            wu, qi = W[gu], Q[i]
            inv = wu[:, f + 2]
            su = wu + mf * (s[u] * inv[:, None])
            score = (su * qi).sum(dim=1)
            if sigmoid:
                sig = torch.sigmoid(score + gb)
                err = v - (min_rating + sig * rating_range)
                g = gradient_common(loss, err, sig, rating_range) * wt
            else:
                g = (v - (score + gb)) * wt
            W.index_add_(0, gu, w_lr * (g[:, None] * qi
                                        - wt[:, None] * w_reg * wu))
            Q.index_add_(0, i, q_lr * (g[:, None] * su
                                       - wt[:, None] * q_reg * qi))
            c_del = mf * (g * inv)[:, None] * qi
            c_del[:, f] += wt
            c.index_add_(0, u, c_del)
        else:
            cg = c[u]
            yj = Y[i]
            Y.index_add_(0, i, y_lr * wt[:, None]
                         * (mf * cg - cg[:, f:f + 1] * y_reg * yj))
    return W, Q, Y


def _check(W, Q, Y, packed, schedule, rates, num_factors):
    dev = W.device
    for name, t, dtype in (("W", W, torch.float32), ("Q", Q, torch.float32),
                           ("Y", Y, torch.float32),
                           ("packed", packed, torch.int32),
                           ("rates", rates, torch.float32),
                           *((f"schedule.{n}", o, torch.int32)
                             for n, o in zip(("ph", "ub", "ib", "row"),
                                             schedule))):
        if t.device != dev:
            raise ValueError(f"svdpp_epoch: {name} is on {t.device}, W on "
                             f"{dev}")
        if t.dtype != dtype:
            raise TypeError(f"svdpp_epoch: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"svdpp_epoch: {name} must be contiguous")
    fe = W.shape[1]
    if W.dim() != 2 or Q.dim() != 2 or Q.shape != Y.shape or Q.shape[1] != fe:
        raise ValueError("svdpp_epoch: W, Q and Y must be 2-D with equal "
                         "widths, Q and Y of one shape")
    if fe < num_factors + 3:
        raise ValueError(f"svdpp_epoch: width {fe} < num_factors + 3")
    if tuple(rates.shape) != (fe, 8):
        raise ValueError(f"svdpp_epoch: rates must be [{fe}, 8]")
    if packed.dim() != 3 or packed.shape[1] != 4:
        raise ValueError("svdpp_epoch: packed must be [nc, 4, C]")
    if len(schedule) != 4 or not all(
            t.dim() == 1 and t.numel() == schedule[0].numel()
            for t in schedule):
        raise ValueError("svdpp_epoch: schedule must be four equal 1-D "
                         "tensors (ph, ub, ib, row)")


def _launch(W, Q, Y, packed, schedule, hp, rates, *, user_block: int,
            item_block: int, num_factors: int, loss: int, sigmoid: bool):
    """Launch mml_svdpp_epoch over the schedule on W's stream."""
    if W.device.type != "cuda":
        raise ValueError(f"svdpp_epoch: no kernel for device {W.device}")
    C = packed.shape[2]
    fe = W.shape[1]
    if fe > MAX_FE or C > MAX_CHUNK:
        raise ValueError(f"svdpp_epoch: kernel takes fe <= {MAX_FE} and "
                         f"chunk <= {MAX_CHUNK}, got fe={fe} chunk={C}")
    from mymedialite_tpu_torch.ops._build import load_library
    fn = load_library().lib.mml_svdpp_epoch
    # s and c [UB, fe], then two [C, fe] delta stages
    scratch = torch.empty(2 * (user_block + C) * fe, dtype=torch.float32,
                          device=W.device)
    gb, min_rating, rating_range = (float(x) for x in hp)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    err = fn(W.data_ptr(), Q.data_ptr(), Y.data_ptr(), packed.data_ptr(),
             *(t.data_ptr() for t in schedule), rates.data_ptr(),
             scratch.data_ptr(), schedule[0].numel(), C, user_block,
             item_block, fe, num_factors, gb, min_rating, rating_range,
             int(loss), int(bool(sigmoid)), stream)
    if err != 0:
        raise RuntimeError(f"svdpp_epoch: kernel launch failed, CUDA error "
                           f"{err}")


def svdpp_epoch(W, Q, Y, packed, schedule, hp, rates, *, user_block: int,
                item_block: int, num_factors: int, loss: int, sigmoid: bool):
    """One SVD++ epoch, in place on ``W``, ``Q`` and ``Y``; returns them."""
    _check(W, Q, Y, packed, schedule, rates, num_factors)
    kw = dict(user_block=user_block, item_block=item_block,
              num_factors=num_factors, loss=loss, sigmoid=sigmoid)
    if W.device.type == "cpu":
        return svdpp_epoch_reference(W, Q, Y, packed, schedule, hp, rates,
                                     **kw)
    _launch(W, Q, Y, packed, schedule, hp, rates, **kw)
    svdpp_epoch.launches += 1
    return W, Q, Y


svdpp_epoch.launches = 0
