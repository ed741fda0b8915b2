"""Chip smoke test of the PyTorch / CUDA port (mymedialite_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the CUDA kernels from ``mymedialite_tpu_torch/csrc`` with nvcc;
3. the SGD-epoch kernel against its plain PyTorch version on the card,
   2,000 users x 3,000 items x 100k ratings, k=40, one epoch from the same
   tables and order, for every loss x biased combination, on the resident
   schedule and on the slab-tiled one (one-block slabs, so three slabs);
4. the BPR-epoch kernel against its plain PyTorch version on the card
   at the same shape (the rated pairs as positive-only feedback), one
   epoch from the same tables, order, negative plan and bits: on the
   resident schedule for every (hinge, WBPR) variant and both membership
   tables, on the tiled schedule (three slabs) for every (hinge, WBPR)
   variant with the sub-bucketed keys; identical sampled negatives,
   tables within the tolerance;
5. Netflix-shaped synthetic ratings (480,000 users x 17,770 items x 20M
   draws), split 80/20, shared by phases 6 and 7;
6. the rating main path on the resident schedule: BiasedMatrixFactorization
   (k=40, 3 epochs) trained through the registry and evaluated; the SGD
   kernel against the plain version at this shape, both timed;
7. the item-recommendation main path on the resident schedule: BPRMF (k=40,
   3 epochs) on the same pairs as positive-only feedback; the BPR kernel
   against the plain version at this shape, both timed; ranking
   evaluation of 4,096 seeded test users against MostPopular;
8. MovieLens-25M-shaped synthetic ratings (162,541 users x 62,423 items x
   25,000,095 draws, the published ml-25m catalog), split 80/20: 61 item
   blocks at k=40, past the resident bound of 40, so both model families
   take the slab-tiled schedule; phases 9 and 10 share them;
9. the rating main path on the tiled schedule: BiasedMatrixFactorization
   as in phase 6, through the tiled SGD kernel, compared with its plain
   version at this shape on the shortest prefix of an epoch's order that
   crosses three slab boundaries (plus 256 chunks);
10. the item main path on the tiled schedule: BPRMF as in phase 7, through
    the tiled BPR kernel with sub-bucketed keys, compared with its plain
    version at this shape on such a prefix (identical negatives), ranked
    against MostPopular;
11. the rating_prediction CLI in process at 6,040 x 3,706 x 1M ratings,
    then its model saved and loaded through the CLI;
12. the item_recommendation CLI at the same size with BPRMF, then its
    model saved and loaded through the CLI.

Before each main path every kernel's launch count is set to 0, and after
it the path's kernel must have run once per epoch and the other
schedule's kernel never. The line before the last is one JSON object
describing the kernels; the last line is ``{"ok": true, "device":
{...}}``. Imports nothing of jax and nothing of the JAX package: only the
port, numpy and torch.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KERNEL_TOL = 1e-4   # atomics add in a run-dependent order
_TIMES = re.compile(r"(training_time|testing_time|loading_time) [0-9.]+ ?")
# published peaks of one H100 SXM (data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores; every kernel here computes in float32
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def epoch_functions():
    from mymedialite_tpu_torch.ops.bpr_epoch import bpr_epoch, bpr_epoch_tiled
    from mymedialite_tpu_torch.ops.sgd_epoch import sgd_epoch, sgd_epoch_tiled
    return dict(sgd_epoch=sgd_epoch, sgd_epoch_tiled=sgd_epoch_tiled,
                bpr_epoch=bpr_epoch, bpr_epoch_tiled=bpr_epoch_tiled)


@contextlib.contextmanager
def counted_path(kernel: str, epochs: int):
    """Set every kernel's launch count to 0, drive the path inside the
    block, then require ``epochs`` launches of ``kernel`` and none of any
    other. Yields a dict that holds the launches afterwards."""
    fns = epoch_functions()
    for fn in fns.values():
        fn.launches = 0
    out = {}
    yield out
    counts = {name: fn.launches for name, fn in fns.items()}
    out["launches"] = counts[kernel]
    want = {name: epochs if name == kernel else 0 for name in fns}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")


def bound_ms(nbytes: float, flops: float):
    """The least time the card could take: bytes over the HBM rate or
    float32 operations over the peak rate, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def distinct_rows(blocks, locs, mask, block_size: int):
    """The absolute rows blocks[k] * block_size + locs[k, s] at the slots
    where ``mask`` holds, each once (a 1-D tensor)."""
    rows = blocks.long()[:, None] * block_size + locs.long()
    return torch.unique(rows[mask])


def sgd_bound(plan, ub, ib, row, num_factors: int):
    """The least an SGD epoch over the visited chunks ``row`` (absolute
    blocks ``ub``, ``ib``) needs: each user and item row that a real
    rating touches read and written once at num_factors + 2 columns (the
    factors and the two fused bias columns), each real rating's (u, i,
    value, weight) and the order (3 int32 per chunk) read once, and per
    real rating the dot product, the loss gradient and the two row
    updates, about 12 float32 operations per column."""
    d = plan.packed[row.long()]                       # [nc, 4, C]
    real = d[:, 3] != 0
    n_real = int(real.sum())
    cols = num_factors + 2
    rows = (distinct_rows(ub, d[:, 0], real, plan.user_block).numel()
            + distinct_rows(ib, d[:, 1], real, plan.item_block).numel())
    moved = 2 * rows * cols * 4 + n_real * 16 + 3 * row.numel() * 4
    return bound_ms(moved, 12.0 * cols * n_real)


def bpr_bound(plan, ub, ib, row, jb, neg, num_factors: int, *,
              probe_bytes: int, table_bytes: int):
    """The least a uniform-sampling BPR epoch over the visited chunks
    ``row`` (absolute blocks ``ub``, ``ib``, negative blocks ``jb``) needs,
    from the negatives ``neg`` [nc, 2, C] the kernel drew: each user row
    and each positive or sampled negative item row that an update touches
    read and written once at num_factors + 1 columns (the factors and the
    item bias); per real slot its (u, i, weights), one trial of random
    bits and one membership probe of ``probe_bytes`` (the probes at most
    ``table_bytes`` in all); the order (6 int32 per chunk); and per slot
    that found a negative the dot product and three row updates, about 18
    float32 operations per column."""
    d = plan.packed[row.long()]                       # [nc, 4, C]
    real = d[:, 3] != 0
    upd = real & (neg[:, 1] != 0)
    n_real, n_upd = int(real.sum()), int(upd.sum())
    cols = num_factors + 1
    IB = plan.item_block
    items = torch.unique(torch.cat([
        distinct_rows(ib, d[:, 1], upd, IB),
        distinct_rows(jb, neg[:, 0], upd, IB)]))
    rows = distinct_rows(ub, d[:, 0], upd, plan.user_block).numel() \
        + items.numel()
    moved = 2 * rows * cols * 4 + n_real * (16 + 4) \
        + min(n_real * probe_bytes, table_bytes) + 6 * row.numel() * 4
    return bound_ms(moved, 18.0 * cols * n_upd)


def slab_prefix(slabs, crossings: int = 3, extra: int = 256) -> int:
    """Length of the shortest prefix of a slab-major order (its chunks'
    item slabs ``slabs``) that crosses ``crossings`` slab boundaries, plus
    ``extra`` chunks of the slab it then enters."""
    change = torch.nonzero(slabs[1:] != slabs[:-1]).flatten()
    if change.numel() < crossings:
        raise AssertionError(f"the order crosses {change.numel()} slab "
                             f"boundaries, fewer than {crossings}")
    return min(int(change[crossings - 1]) + 1 + extra, slabs.numel())


def time_kernel_and_plain(kernel, plain):
    """Run ``kernel()`` timed with CUDA events, then ``plain()`` on the
    host clock. Returns (kernel's result, plain's result, kernel ms,
    plain ms)."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    k_out = kernel()
    end.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_out = plain()
    torch.cuda.synchronize()
    return (k_out, p_out, start.elapsed_time(end),
            (time.perf_counter() - t0) * 1e3)


def table_error(kernel_tables, plain_tables) -> float:
    """Max |kernel - plain| over the tables; raises on non-finite ones."""
    for t in kernel_tables:
        if not torch.isfinite(t).all():
            raise AssertionError("kernel produced non-finite tables")
    return max((k - p).abs().max().item()
               for k, p in zip(kernel_tables, plain_tables))


def check(err, what):
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{what}: kernel disagrees with the plain "
                             f"version, {err} > {KERNEL_TOL}")


@contextlib.contextmanager
def timed_training(prepare, epoch):
    """Time the plan builder (host clock) and each epoch (CUDA events) as
    the model calls them, without changing the entry point: ``prepare``
    and ``epoch`` are (module, name) pairs patched inside the block.
    Yields {"plan_s": [...], "epoch_ms": [...]}."""
    timings = {"plan_s": [], "epoch_ms": []}
    real_prepare, real_epoch = getattr(*prepare), getattr(*epoch)

    def timed_prepare(*a, **kw):
        t = time.perf_counter()
        out = real_prepare(*a, **kw)
        torch.cuda.synchronize()
        timings["plan_s"].append(time.perf_counter() - t)
        return out

    def timed_epoch(*a, **kw):
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        out = real_epoch(*a, **kw)
        e.record()
        e.synchronize()
        timings["epoch_ms"].append(s.elapsed_time(e))
        return out

    setattr(*prepare, timed_prepare)
    setattr(*epoch, timed_epoch)
    try:
        yield timings
    finally:
        setattr(*prepare, real_prepare)
        setattr(*epoch, real_epoch)


def kernel_vs_plain(plan, W, H, order, hp, rates, *, loss, biased):
    """One epoch of the kernel and of the plain version from the same
    tables and order, on the plan's schedule. Returns (max |diff|, kernel
    ms, plain ms)."""
    from mymedialite_tpu_torch.ops import plan as mxu
    from mymedialite_tpu_torch.ops import sgd_epoch as se
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=loss, biased=biased)
    if isinstance(plan, mxu.MxuTiledPlan):
        kernel, plain = se.sgd_epoch_tiled, se.sgd_epoch_tiled_reference
        kw["slab_blocks"] = plan.slab_blocks
    else:
        kernel, plain = se.sgd_epoch, se.sgd_epoch_reference
    Wk, Hk, Wr, Hr = W.clone(), H.clone(), W.clone(), H.clone()
    _, _, kernel_ms, plain_ms = time_kernel_and_plain(
        lambda: kernel(Wk, Hk, plan.packed, order, hp, rates, **kw),
        lambda: plain(Wr, Hr, plan.packed, order, hp, rates, **kw))
    return table_error((Wk, Hk), (Wr, Hr)), kernel_ms, plain_ms


def phase_kernel_check(dev):
    from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
    from mymedialite_tpu_torch.ops import plan as mxu
    from mymedialite_tpu_torch.ops import sgd
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=3)
    args = (data.users, data.items, data.values, 2000, 3000)
    plans = {
        "resident": mxu.prepare_mxu_data(
            *args, user_block=512, item_block=1024, chunk=640,
            shuffle_seed=4, device=dev),
        "tiled": mxu.prepare_mxu_tiled(
            *args, user_block=512, item_block=1024, chunk=None,
            slab_blocks=1, shuffle_seed=4, device=dev)}
    if plans["tiled"].num_slabs != 3:
        raise AssertionError("the tiled check wants three slabs")
    rng = np.random.default_rng(5)
    tabs = (0.1 * rng.standard_normal((2000, 40)),
            0.1 * rng.standard_normal((3000, 40)),
            0.1 * rng.standard_normal(2000), 0.1 * rng.standard_normal(3000))
    worst = {}
    for schedule, plan in plans.items():
        W, H = mxu.extend_tables_mxu(plan, *tabs)
        order = plan.epoch_order(6)
        for biased in (True, False):
            for loss in (sgd.LOSS_RMSE, sgd.LOSS_MAE, sgd.LOSS_LOGISTIC):
                # the models' default rates (BiasedMatrixFactorization.cs)
                rates = mxu.mxu_column_rates(40, W.shape[1], 0.01, 0.015,
                                             0.015, 1.0, 0.01, biased, True,
                                             True, device=dev)
                hp = (0.6, 1.0, 4.0) if biased else (3.6, 1.0, 4.0)
                err, k_ms, p_ms = kernel_vs_plain(
                    plan, W, H, order, hp, rates, loss=loss, biased=biased)
                log(f"sgd {schedule} kernel check loss={loss} "
                    f"biased={biased}: max_abs_err {err:.3e} (tol "
                    f"{KERNEL_TOL}) kernel {k_ms:.2f} ms plain {p_ms:.1f} ms "
                    f"({plan.num_chunks} chunks of {plan.chunk})")
                check(err, f"sgd {schedule} loss={loss} biased={biased}")
                worst[schedule] = max(worst.get(schedule, 0.0), err)
    return worst


def bpr_kernel_vs_plain(plan, state, W, H, order, neg_plan, bits, rates, *,
                        soft_margin, wbpr, bitmask):
    """One resident BPR epoch of the kernel and of the plain version from
    the same tables, order, negative plan and bits. Returns (max |diff|,
    kernel ms, plain ms, the kernel's negatives); raises unless the
    sampled negatives are identical."""
    from mymedialite_tpu_torch.ops.bpr_epoch import (
        bpr_epoch, bpr_epoch_reference,
    )
    args = (plan.packed, state["keys_tbl"], state["cdf_tbl"], bits, order,
            *neg_plan, rates)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              soft_margin=soft_margin, wbpr=wbpr,
              bitmask_tbl=state["bitmask_tbl"] if bitmask else None,
              return_negatives=True)
    Wk, Hk, Wr, Hr = W.clone(), H.clone(), W.clone(), H.clone()
    (_, _, neg_k), (_, _, neg_r), kernel_ms, plain_ms = time_kernel_and_plain(
        lambda: bpr_epoch(Wk, Hk, *args, **kw),
        lambda: bpr_epoch_reference(Wr, Hr, *args, **kw))
    if not torch.equal(neg_k, neg_r):
        bad = (neg_k != neg_r).sum().item()
        raise AssertionError(f"sampled negatives differ in {bad} entries")
    return table_error((Wk, Hk), (Wr, Hr)), kernel_ms, plain_ms, neg_k


def bpr_tiled_kernel_vs_plain(plan, state, tl, W, H, order, bits, rates, *,
                              soft_margin, wbpr):
    """bpr_kernel_vs_plain for the tiled schedule, sub-bucketed keys."""
    from mymedialite_tpu_torch.ops.bpr_epoch import (
        bpr_epoch_tiled, bpr_epoch_tiled_reference,
    )
    args = (plan.packed, state["subkeys_tbl"], state["cdf_tbl"], bits, order,
            rates)
    kw = dict(slab_blocks=tl["slab_blocks"], user_block=plan.user_block,
              item_block=plan.item_block, soft_margin=soft_margin, wbpr=wbpr,
              subkeys=True, return_negatives=True)
    Wk, Hk, Wr, Hr = W.clone(), H.clone(), W.clone(), H.clone()
    (_, _, neg_k), (_, _, neg_r), kernel_ms, plain_ms = time_kernel_and_plain(
        lambda: bpr_epoch_tiled(Wk, Hk, *args, **kw),
        lambda: bpr_epoch_tiled_reference(Wr, Hr, *args, **kw))
    if not torch.equal(neg_k, neg_r):
        bad = (neg_k != neg_r).sum().item()
        raise AssertionError(f"sampled negatives differ in {bad} entries")
    return table_error((Wk, Hk), (Wr, Hr)), kernel_ms, plain_ms, neg_k


def epoch_bits(plan, trials, seed):
    gen = torch.Generator(device=plan.packed.device)
    gen.manual_seed(seed)
    return torch.randint(0, 2 ** 31, (plan.num_chunks, trials, plan.chunk),
                         dtype=torch.int32, generator=gen,
                         device=plan.packed.device)


def bpr_epoch_inputs(plan, state, meta, seed, block_mass=None):
    """Order, negative plan and bits of one resident epoch, as BPRMF draws
    them."""
    from mymedialite_tpu_torch.ops import bpr_plan
    order = plan.epoch_order(seed)
    neg_plan = bpr_plan.epoch_negative_plan(
        plan, state["nvalid"], order[0].cpu().numpy(), meta[3], seed + 1,
        block_mass=block_mass)
    return order, neg_plan, epoch_bits(plan, meta[2], seed)


def bpr_tiled_epoch_inputs(plan, state, meta, tl, seed, block_mass=None):
    """Order and bits of one tiled epoch, as BPRMF draws them."""
    from mymedialite_tpu_torch.ops import bpr_plan
    order = bpr_plan.bpr_tiled_epoch_order(
        plan, state["nvalid"], tl["slab_items"],
        slab_blocks=tl["slab_blocks"], num_slabs=tl["num_slabs"],
        num_items=meta[3], seed=seed, block_mass=block_mass)
    return order, epoch_bits(plan, meta[2], seed)


def bpr_tables(dev, plan, U, I, seed):
    from mymedialite_tpu_torch.ops import bpr_plan
    rng = np.random.default_rng(seed)
    return bpr_plan.bpr_tables_to_mxu(
        *(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            0.1 * rng.standard_normal((U, 40)),
            0.1 * rng.standard_normal((I, 40)),
            0.1 * rng.standard_normal(I))),
        torch.from_numpy(plan.new_of_old.astype(np.int64)).to(dev),
        u_pad=plan.u_pad, i_pad=plan.i_pad, fe=64)


def phase_bpr_kernel_check(dev):
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.ops import bpr_plan
    feedback = posonly_from_ratings(synthetic_ratings(
        num_users=2000, num_items=3000, num_ratings=100_000, seed=3))
    U, I = feedback.num_users, feedback.num_items
    # BPRMF's default rates (reference BPRMF.cs)
    rates = bpr_plan.bpr_mxu_column_rates(40, 64, 0.05, 0.0025, 0.0025,
                                          0.00025, 0.0, True, device=dev)
    worst = {}
    plan, state, meta = bpr_plan.prepare_bpr_mxu(
        feedback, uniform_user=True, shuffle_seed=4, bitmask=True,
        device=dev)
    W, H = bpr_tables(dev, plan, U, I, 5)
    for soft_margin, wbpr in ((False, False), (True, False), (False, True)):
        order, neg_plan, bits = bpr_epoch_inputs(
            plan, state, meta, 6 + wbpr,
            block_mass=state["block_mass"] if wbpr else None)
        for bitmask in (False, True):
            err, k_ms, p_ms, _ = bpr_kernel_vs_plain(
                plan, state, W, H, order, neg_plan, bits, rates,
                soft_margin=soft_margin, wbpr=wbpr, bitmask=bitmask)
            log(f"bpr resident kernel check soft_margin={soft_margin} "
                f"wbpr={wbpr} membership={'bitmask' if bitmask else 'keys'}: "
                f"negatives identical, max_abs_err {err:.3e} (tol "
                f"{KERNEL_TOL}) kernel {k_ms:.2f} ms plain {p_ms:.1f} ms "
                f"({plan.num_chunks} chunks)")
            check(err, f"bpr soft_margin={soft_margin} wbpr={wbpr}")
            worst["resident"] = max(worst.get("resident", 0.0), err)

    # the tiled schedule with BPRMF's tiled plan options, one-block slabs
    plan, state, meta = bpr_plan.prepare_bpr_mxu(
        feedback, uniform_user=True, shuffle_seed=4, chunk=None, kcap=128,
        subkeys=True, ksub_cap=256, bitmask=False, chunk_overhead=256,
        device=dev)
    B, S, slab_items = bpr_plan.bpr_tiled_plan(plan, state["nvalid"],
                                               slab_blocks=1)
    if S != 3:
        raise AssertionError("the tiled check wants three slabs")
    tl = dict(slab_blocks=B, num_slabs=S, slab_items=slab_items)
    W, H = bpr_tables(dev, plan, U, I, 5)
    for soft_margin in (False, True):
        for wbpr in (False, True):
            order, bits = bpr_tiled_epoch_inputs(
                plan, state, meta, tl, 8 + wbpr,
                block_mass=state["block_mass"] if wbpr else None)
            err, k_ms, p_ms, _ = bpr_tiled_kernel_vs_plain(
                plan, state, tl, W, H, order, bits, rates,
                soft_margin=soft_margin, wbpr=wbpr)
            log(f"bpr tiled kernel check soft_margin={soft_margin} "
                f"wbpr={wbpr} membership=subkeys (Ksub {state['ksub']}): "
                f"negatives identical, max_abs_err {err:.3e} (tol "
                f"{KERNEL_TOL}) kernel {k_ms:.2f} ms plain {p_ms:.1f} ms "
                f"({plan.num_chunks} chunks of {plan.chunk}, {S} slabs)")
            check(err, f"bpr tiled soft_margin={soft_margin} wbpr={wbpr}")
            worst["tiled"] = max(worst.get("tiled", 0.0), err)
    return worst


def shaped_ratings(name, **shape):
    """Synthetic ratings of the given shape, split 80/20."""
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    t0 = time.perf_counter()
    data = synthetic_ratings(**shape)
    train, test = split_ratings(data, 0.2, seed=2)
    log(f"{name} data: {data.num_users} users x {data.num_items} items, "
        f"{len(data)} pairs, {len(train)} train / {len(test)} test, "
        f"{time.perf_counter() - t0:.1f} s")
    return train, test


def phase_mf_path(dev, train, test, *, tiled: bool):
    """BiasedMatrixFactorization at k=40 for 3 epochs through the
    registry on the schedule the catalog selects; the epoch kernel
    against its plain version at this shape; RMSE against the global
    average. Returns the kernel's numbers for the kernels line."""
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models import mf as mf_module
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    from mymedialite_tpu_torch.ops import plan as mxu

    name = "sgd_epoch_tiled" if tiled else "sgd_epoch"
    model = create_rating_predictor(
        "BiasedMatrixFactorization",
        f"num_factors=40 num_iter=3 device={dev.type}")
    model.ratings = train
    if (mxu.select_schedule(train.num_items, 40) == "tiled") != tiled:
        raise AssertionError(f"{train.num_items} items do not select the "
                             f"{'tiled' if tiled else 'resident'} schedule")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prepare = "prepare_mxu_tiled" if tiled else "prepare_mxu_data"
    with timed_training((mxu, prepare), (mf_module, name)) as timings, \
            counted_path(name, model.num_iter) as counted:
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    We, He = model._mxu_tables
    if We.device.type != dev.type or He.device.type != dev.type:
        raise AssertionError("kernel-layout tables are not on the card")
    plan = model._plan
    epoch_ms = float(np.mean(timings["epoch_ms"]))
    slabs = f", {plan.num_slabs} slabs of {plan.slab_blocks}" if tiled else ""
    log(f"mf {'tiled' if tiled else 'resident'} train: {train_s:.2f} s; "
        f"plan prep {timings['plan_s'][0]:.2f} s ({plan.num_chunks} chunks "
        f"of {plan.chunk}, {plan.n_ublocks} x {plan.n_iblocks} blocks{slabs}); "
        f"{name} launches {counted['launches']}; epochs "
        f"{', '.join(f'{t:.1f}' for t in timings['epoch_ms'])} ms; "
        f"{len(train) / (epoch_ms / 1e3):.4g} real-rating updates/s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the kernel against the plain version at the main path's shape, from
    # the trained tables (one more epoch each; on the tiled schedule the
    # prefix of the order that crosses three slab boundaries)
    rates = model._epoch_rates(True, True)
    hp = (model.global_bias, model.min_rating, model._rating_range())
    order = plan.epoch_order(12345)
    if tiled:
        n = slab_prefix(order[2])
        order = tuple(t[:n].contiguous() for t in order)
        ub, ibr, sl, row = order
        ib = sl * plan.slab_blocks + ibr
        span = f"prefix of {n} of {plan.num_chunks} chunks, 3 slab boundaries"
    else:
        ub, ib, row = order
        span = f"all {plan.num_chunks} chunks"
    err, kernel_ms, plain_ms = kernel_vs_plain(
        plan, We, He, order, hp, rates, loss=model.loss_id, biased=True)
    b_ms, b_by = sgd_bound(plan, ub, ib, row, model.num_factors)
    log(f"full-shape {name} ({span}): kernel {kernel_ms:.1f} ms, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), max_abs_err "
        f"{err:.3e} (tol {KERNEL_TOL})")
    check(err, f"{name} at full shape")

    t0 = time.perf_counter()
    res = evaluate_ratings(model, test, train)
    eval_s = time.perf_counter() - t0
    baseline = float(np.sqrt(np.mean(
        (test.values.astype(np.float64) - train.values.mean()) ** 2)))
    log(f"eval: {res} ({eval_s:.2f} s); global-average RMSE {baseline:.5f}")
    if not (math.isfinite(res["RMSE"]) and res["RMSE"] < baseline):
        raise AssertionError("RMSE does not beat the global average")
    return dict(launches=counted["launches"], max_abs_err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def phase_bpr_path(dev, train, test, *, tiled: bool):
    """BPRMF at k=40 for 3 epochs through the registry on the same pairs
    as positive-only feedback; the epoch kernel against its plain version
    at this shape; ranking evaluation against MostPopular. Returns the
    kernel's numbers for the kernels line."""
    from mymedialite_tpu_torch.data.synthetic import posonly_from_ratings
    from mymedialite_tpu_torch.eval.ranking import evaluate_items
    from mymedialite_tpu_torch.models import bpr as bpr_module
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    from mymedialite_tpu_torch.ops import bpr_plan

    name = "bpr_epoch_tiled" if tiled else "bpr_epoch"
    train, test = posonly_from_ratings(train), posonly_from_ratings(test)
    model = create_item_recommender(
        "BPRMF", f"num_factors=40 num_iter=3 device={dev.type}")
    model.feedback = train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed_training((bpr_plan, "prepare_bpr_mxu"),
                        (bpr_module, name)) as timings, \
            counted_path(name, model.num_iter) as counted:
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    We, He = model._mxu_tables
    if We.device.type != dev.type or He.device.type != dev.type:
        raise AssertionError("kernel-layout tables are not on the card")
    plan, state, tl = model._plan, model._neg_state, model._tiled
    if (tl is not None) != tiled:
        raise AssertionError("BPRMF took the other schedule")
    epoch_ms = float(np.mean(timings["epoch_ms"]))
    if tiled:
        membership = (f"subkeys (Ksub {state['ksub']}, corrupted-triple "
                      f"rate {state['subkey_corruption']:.2e}), "
                      f"{tl['num_slabs']} slabs of {tl['slab_blocks']}")
    else:
        membership = "bitmask" if "bitmask_tbl" in state else "keys"
    log(f"bpr {'tiled' if tiled else 'resident'} train: {train_s:.2f} s; "
        f"plan prep {timings['plan_s'][0]:.2f} s ({plan.num_chunks} chunks "
        f"of {plan.chunk}, {plan.n_ublocks} x {plan.n_iblocks} blocks, "
        f"membership {membership}); {name} launches {counted['launches']}; "
        f"epochs {', '.join(f'{t:.1f}' for t in timings['epoch_ms'])} ms; "
        f"{len(train) / (epoch_ms / 1e3):.4g} training triples/s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the kernel against the plain version at the main path's shape, from
    # the trained tables (one more epoch each; on the tiled schedule the
    # prefix of the order that crosses three slab boundaries)
    rates = bpr_plan.bpr_mxu_column_rates(
        40, We.shape[1], model.learn_rate, model.reg_u, model.reg_i,
        model.reg_j, model.bias_reg, model.update_j, device=dev)
    if tiled:
        order, bits = bpr_tiled_epoch_inputs(plan, state, model._neg_meta,
                                             tl, 12345)
        n = slab_prefix(order[2])
        order = tuple(t[:n].contiguous() for t in order)
        bits = bits[:n].contiguous()
        err, kernel_ms, plain_ms, neg = bpr_tiled_kernel_vs_plain(
            plan, state, tl, We, He, order, bits, rates, soft_margin=False,
            wbpr=False)
        ub, ibr, isl, jb, _, _, _, _, row = order
        ib = isl * tl["slab_blocks"] + ibr
        table = state["subkeys_tbl"]
        span = f"prefix of {n} of {plan.num_chunks} chunks, 3 slab boundaries"
    else:
        order, neg_plan, bits = bpr_epoch_inputs(plan, state,
                                                 model._neg_meta, 12345)
        bitmask = "bitmask_tbl" in state
        err, kernel_ms, plain_ms, neg = bpr_kernel_vs_plain(
            plan, state, We, He, order, neg_plan, bits, rates,
            soft_margin=False, wbpr=False, bitmask=bitmask)
        (ub, ib, row), jb = order, neg_plan[0]
        table = state["bitmask_tbl" if bitmask else "keys_tbl"]
        span = f"all {plan.num_chunks} chunks"
    b_ms, b_by = bpr_bound(
        plan, ub, ib, row, jb, neg, model.num_factors,
        probe_bytes=table.element_size(),
        table_bytes=table.numel() * table.element_size())
    log(f"full-shape {name} ({span}): kernel {kernel_ms:.1f} ms, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), negatives "
        f"identical, max_abs_err {err:.3e} (tol {KERNEL_TOL})")
    check(err, f"{name} at full shape")

    rng = np.random.default_rng(9)
    users = np.sort(rng.choice(test.all_users, 4096, replace=False))
    t0 = time.perf_counter()
    train.by_user, test.by_user   # the host CSR indexes both evaluations read
    log(f"ranking eval set-up (host CSR of train and test): "
        f"{time.perf_counter() - t0:.2f} s")
    results = {}
    popular = create_item_recommender("MostPopular")
    popular.feedback = train
    popular.train()
    for label, m in (("BPRMF", model), ("MostPopular", popular)):
        t0 = time.perf_counter()
        res = evaluate_items(m, test, train, test_users=users)
        log(f"ranking eval {label}, {res['num_users']} users: {res} "
            f"({time.perf_counter() - t0:.2f} s)")
        for k in ("AUC", "prec@5", "NDCG"):
            if not math.isfinite(res[k]):
                raise AssertionError(f"{label} {k} is not finite")
        results[label] = res
    if not results["BPRMF"]["AUC"] > 0.6:
        raise AssertionError(f"BPRMF AUC {results['BPRMF']['AUC']} <= 0.6")
    return dict(launches=counted["launches"], max_abs_err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    text = out.getvalue()
    log(text.rstrip())
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    return text


def save_load_same(main, argv, model_path):
    """Train with --save-model, then --load-model: the result lines must
    agree apart from the times. Returns the first run's output."""
    trained = run_cli(main, argv + ["--save-model", model_path])
    loaded = run_cli(main, argv + ["--load-model", model_path])
    last = lambda text: _TIMES.sub("", text.strip().splitlines()[-1])  # noqa: E731
    if last(loaded) != last(trained):
        raise AssertionError("save -> load through the CLI changed the "
                             f"result line:\n{trained}\n{loaded}")
    return trained


def result_value(text, key):
    tokens = text.strip().splitlines()[-1].split()
    return float(tokens[tokens.index(key) + 1])


def phase_cli(dev, tmp):
    from mymedialite_tpu_torch.cli import rating_prediction
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )

    data = synthetic_ratings(num_users=6040, num_items=3706,
                             num_ratings=1_000_000, seed=4)
    train, test = split_ratings(data, 0.1, seed=5)
    paths = []
    for name, part in (("train", train), ("test", test)):
        path = os.path.join(tmp, f"{name}.tsv")
        np.savetxt(path, np.column_stack([part.users, part.items,
                                          part.values]),
                   fmt=("%d", "%d", "%g"), delimiter="\t")
        paths.append(path)
    argv = ["--training-file", paths[0], "--test-file", paths[1],
            "--recommender-options",
            f"num_factors=40 num_iter=3 device={dev.type}"]
    with counted_path("sgd_epoch", 3):
        text = save_load_same(rating_prediction.main, argv,
                              os.path.join(tmp, "biasedmf.model"))
    rmse = result_value(text, "RMSE")
    if not (math.isfinite(rmse) and 0 < rmse < 2):
        raise AssertionError(f"bad CLI result: RMSE {rmse}")


def phase_item_cli(dev, tmp):
    from mymedialite_tpu_torch.cli import item_recommendation
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, split_posonly, synthetic_ratings,
    )

    data = posonly_from_ratings(synthetic_ratings(
        num_users=6040, num_items=3706, num_ratings=1_000_000, seed=4))
    train, test = split_posonly(data, 0.1, seed=5)
    paths = []
    for name, part in (("items_train", train), ("items_test", test)):
        path = os.path.join(tmp, f"{name}.tsv")
        np.savetxt(path, np.column_stack([part.users, part.items]),
                   fmt="%d", delimiter="\t")
        paths.append(path)
    argv = ["--training-file", paths[0], "--test-file", paths[1],
            "--recommender", "BPRMF", "--recommender-options",
            f"num_factors=40 num_iter=3 device={dev.type}"]
    with counted_path("bpr_epoch", 3):
        text = save_load_same(item_recommendation.main, argv,
                              os.path.join(tmp, "bprmf.model"))
    auc = result_value(text, "AUC")
    if not (math.isfinite(auc) and 0.5 < auc <= 1):
        raise AssertionError(f"bad item CLI result: AUC {auc}")


KERNELS = {
    "sgd_epoch": ("mymedialite_tpu_torch/csrc/sgd_epoch.cu",
                  "mymedialite_tpu/ops/pallas_sgd.py:324"),
    "sgd_epoch_tiled": ("mymedialite_tpu_torch/csrc/sgd_epoch.cu",
                        "mymedialite_tpu/ops/pallas_sgd.py:745"),
    "bpr_epoch": ("mymedialite_tpu_torch/csrc/bpr_epoch.cu",
                  "mymedialite_tpu/ops/pallas_bpr.py:451"),
    "bpr_epoch_tiled": ("mymedialite_tpu_torch/csrc/bpr_epoch.cu",
                        "mymedialite_tpu/ops/pallas_bpr.py:979"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} numpy "
        f"{np.__version__} python {sys.version.split()[0]}")

    from mymedialite_tpu_torch.ops._build import load_library
    lib = load_library()
    log(f"build: {lib.build_seconds:.1f} s -> {os.path.relpath(lib.path)}")
    for line in lib.compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  {line.strip()}")

    t_start = time.perf_counter()
    sgd_worst = phase_kernel_check(dev)
    bpr_worst = phase_bpr_kernel_check(dev)
    worst = {"sgd_epoch": sgd_worst["resident"],
             "sgd_epoch_tiled": sgd_worst["tiled"],
             "bpr_epoch": bpr_worst["resident"],
             "bpr_epoch_tiled": bpr_worst["tiled"]}
    log(f"kernel checks: {time.perf_counter() - t_start:.1f} s")
    runs = {}
    train, test = shaped_ratings("Netflix-shaped", num_users=480_000,
                                 num_items=17_770,
                                 num_ratings=20_000_000, seed=1)
    runs["sgd_epoch"] = phase_mf_path(dev, train, test, tiled=False)
    runs["bpr_epoch"] = phase_bpr_path(dev, train, test, tiled=False)
    del train, test
    torch.cuda.empty_cache()
    log(f"resident paths: {time.perf_counter() - t_start:.1f} s")
    # the published ml-25m catalog (GroupLens' README): 162,541 users,
    # 62,423 movies, 25,000,095 ratings
    train, test = shaped_ratings("MovieLens-25M-shaped", num_users=162_541,
                                 num_items=62_423, num_ratings=25_000_095,
                                 seed=25)
    runs["sgd_epoch_tiled"] = phase_mf_path(dev, train, test, tiled=True)
    runs["bpr_epoch_tiled"] = phase_bpr_path(dev, train, test, tiled=True)
    del train, test
    torch.cuda.empty_cache()
    log(f"tiled paths: {time.perf_counter() - t_start:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(dev, tmp)
        phase_item_cli(dev, tmp)
    log(f"all phases: {time.perf_counter() - t_start:.1f} s after the build")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = runs[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=r["launches"],
            max_abs_err=max(worst[name], r["max_abs_err"]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"],
            # a sequential epoch of dependent minibatch steps is no single
            # PyTorch call
            library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
