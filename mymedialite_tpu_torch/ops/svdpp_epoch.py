"""One SVD++ epoch over the static S/R/Y schedule: the CUDA kernel's
wrapper and its plain PyTorch version.

``svdpp_epoch`` replaces ``mymedialite_tpu/ops/pallas_svdpp.py:460
svdpp_epoch_mxu`` (kernel body ``_svdpp_kernel`` :308). It updates the
kernel-layout tables ``W`` [u_pad, fe], ``Q`` and ``Y`` [i_pad, fe]
(``ops/svdpp_plan.py``) in place, where the JAX version aliases its
outputs to its inputs. On CUDA tensors it launches
``csrc/svdpp_epoch.cu`` (one launch per epoch, of one thread-block
cluster of ``cluster_size`` CTAs that splits each step's slots,
``ops/cluster.py``) or raises, also where the kernel does not take the
shape (``check_kernel_shape``: fe and the chunk multiples of 4, fe <=
256, two chunks, their segment tables and the rates within 227 KB of
shared memory, beside the owner scatter's stage) and where the card
cannot place the cluster; the kernel sums s, c and n in a global scratch
and, where a copy fits in each CTA's shared memory, reads them from there
(``accumulator_variant``, from the shape). Every sum, of s, W, c, n, Q and Y, adds a row's deltas in slot
order, as ``index_add_`` does on the CPU, from the segment tables of
``ops/segments.py`` (built on the card once per ``packed``), so two runs
give the same tables bit for bit. On CPU tensors it runs
``svdpp_epoch_reference``. It counts its own launches.

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
# the kernel stages the rates, two chunks' rows and segment tables, a copy
# of the sums R and Y read where it fits, and its part of the owner
# scatter's values in DYNAMIC_SHARED_BYTES of shared memory
# (ops/cluster.py)
# the "shared" variant leaves the owner scatter at most this many list
# positions of its widest step (R: W's float4s and c's and n's) a window,
# what a block kept beside the copy; a cluster needs less (stage_need)
MIN_STAGE_ENTRIES = 512


def cluster_size(chunk: int) -> int:
    """N, the CTAs of the cluster that runs a step of ``chunk`` slots
    (kernel 5; ``ops/cluster.py``)."""
    return _cluster.cluster_size(chunk, "svdpp")


def _row(num_factors: int) -> int:
    """An s or c row of the kernel: the factor columns, rounded up to 4."""
    return (num_factors + 3) // 4 * 4


def shared_bytes(fe: int, chunk: int, user_block: int, num_factors: int,
                 variant: str, stage_entries: int = 1) -> int:
    """Shared memory of the kernel: the rates [8, fe], two chunks' packed
    rows [2, 4, C] and the runs and codes of their segment tables [2, RL
    + 2 Cw], the live float4 lists and their inverse, in the "shared"
    variant the on-chip copy of the sums, one [UB, Fp + 4] (s in R, c and
    n in Y; Fp = num_factors rounded up to 4), and ``stage_entries`` rows
    of the owner scatter's stage at its widest (the rest of the block's
    shared memory is the stage)."""
    runs_codes = runs_length(2 * chunk) + 2 * round8(chunk)
    acc = user_block * (_row(num_factors) + 4) if variant == "shared" else 0
    widest = fe + _row(num_factors) + 4
    return 32 * fe + 32 * chunk + 4 * runs_codes \
        + 4 * ((6 * fe // 4 + 3) // 4 * 4) + 4 * acc \
        + 4 * widest * stage_entries


def stage_need(fe: int, chunk: int, num_factors: int, cluster: int) -> int:
    """Bytes of the owner scatter's stage that the "shared" variant keeps
    free in each CTA beside the copy: the CTA's part of a step whose every
    slot's user and item entries lie in runs with every float4 live (C (2
    fe + Fp + 4) floats over the cluster's N CTAs), at most
    MIN_STAGE_ENTRIES list positions of the widest step (fe + Fp + 4
    floats each), what one block kept."""
    fq = _row(num_factors) + 4
    worst = -(-chunk * (2 * fe + fq) // cluster)
    return 4 * min(worst, MIN_STAGE_ENTRIES * (fe + fq))


def accumulator_variant(user_block: int, num_factors: int, chunk: int,
                        fe: int) -> str:
    """Where the kernel's R and Y steps read the per-user-block sums s, c
    and n, which it sums in a global scratch: "shared" (a copy in each
    CTA's shared memory, made once when the phase starts) where it fits
    beside the rates, the chunk buffers and ``stage_need`` bytes of the
    owner scatter's stage in DYNAMIC_SHARED_BYTES, else "global" (through
    L2). At UB = 512 and C = 512 (a cluster of 8) that is "shared" up to
    64 factors, quality.py's k=20 among them."""
    n = cluster_size(chunk)
    fits = shared_bytes(fe, chunk, user_block, num_factors, "shared", 0) \
        + stage_need(fe, chunk, num_factors, n) <= DYNAMIC_SHARED_BYTES
    return "shared" if fits else "global"


def check_kernel_shape(fe: int, chunk: int):
    """Raise ValueError unless the kernel takes the width ``fe`` and the
    chunk: both multiples of 4 (float4 rows, 16-byte pieces of each
    chunk), fe <= MAX_FE, and the global variant's shared memory within
    MAX_SHARED_BYTES."""
    if fe > MAX_FE or fe % 4 or chunk % 4 \
            or shared_bytes(fe, chunk, 0, fe, "global") \
            > DYNAMIC_SHARED_BYTES:
        raise ValueError(f"svdpp_epoch: kernel takes fe <= {MAX_FE}, fe and "
                         f"the chunk multiples of 4, and {MAX_SHARED_BYTES} B "
                         f"of shared memory, got fe={fe} chunk={chunk}")


def svdpp_epoch_reference(W, Q, Y, packed, schedule, hp, rates, *,
                          user_block: int, item_block: int, num_factors: int,
                          loss: int, sigmoid: bool):
    """Plain PyTorch epoch: a Python loop over the schedule, gathers by
    indexing and scatter-adds with ``index_add_`` (in slot order on the
    CPU, the kernel's order). In place."""
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
    C, fe = packed.shape[2], W.shape[1]
    check_kernel_shape(fe, C)
    if W.device.type != "cuda":
        raise ValueError(f"svdpp_epoch: no kernel for device {W.device}")
    variant = accumulator_variant(user_block, num_factors, C, fe)
    from mymedialite_tpu_torch.ops._build import load_library
    fn = load_library().lib.mml_svdpp_epoch
    cluster = cluster_size(C)
    segs = segments_of(packed)
    # two [C, fe] stages and a [C, Fp + 4] one, then s [UB, Fp] and cn
    # [UB, Fp + 4]
    fp = _row(num_factors)
    scratch = torch.empty((2 * fe + fp + 4) * C
                          + user_block * (2 * fp + 4), dtype=torch.float32,
                          device=W.device)
    gb, min_rating, rating_range = (float(x) for x in hp)
    # the kernel launches on the current device: make it W's
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = fn(W.data_ptr(), Q.data_ptr(), Y.data_ptr(), packed.data_ptr(),
                 segs.data_ptr(), *(t.data_ptr() for t in schedule),
                 rates.data_ptr(), scratch.data_ptr(), schedule[0].numel(),
                 C, runs_length(2 * C), user_block, item_block, fe,
                 num_factors, DYNAMIC_SHARED_BYTES, cluster, gb, min_rating,
                 rating_range, int(loss), int(bool(sigmoid)),
                 int(variant == "shared"), stream)
    check_cluster_launch("svdpp_epoch", err, cluster, DYNAMIC_SHARED_BYTES)


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
