"""Chip smoke test of the PyTorch / CUDA port (mymedialite_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the CUDA kernels from ``mymedialite_tpu_torch/csrc`` with nvcc;
3. the SGD-epoch kernel against its plain PyTorch version on the card,
   2,000 users x 3,000 items x 100k ratings, k=40, one epoch from the same
   tables and order, for every loss x biased combination;
4. the BPR-epoch kernel against its plain PyTorch version on the card
   at the same shape (the rated pairs as positive-only feedback), one
   epoch from the same tables, order, negative plan and bits, for every
   (hinge, WBPR) variant and both membership tables: identical sampled
   negatives, tables within the tolerance;
5. Netflix-shaped synthetic ratings (480,000 users x 17,770 items x 20M
   draws, 18.68M distinct pairs), split 80/20, shared by phases 6 and 7;
6. the rating main path at full width: BiasedMatrixFactorization (k=40,
   3 epochs) trained through the registry, evaluated, saved and loaded;
   the SGD kernel against the plain version at this shape, both timed;
7. the item-recommendation main path at full width: BPRMF (k=40, 3
   epochs) trained through the registry on the same pairs as
   positive-only feedback; the BPR kernel against the plain version at
   this shape, both timed; ranking evaluation of 4,096 seeded test users
   against MostPopular on the same users;
8. the rating_prediction CLI in process at 6,040 x 3,706 x 1M ratings;
9. the item_recommendation CLI in process at the same size with BPRMF,
   then its model saved and loaded through the CLI.

The line before the last is one JSON object describing the kernels; the
last line is ``{"ok": true, "device": {...}}``. Imports nothing of jax
and nothing of the JAX package: only the port, numpy and torch.
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


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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
    tables and order. Returns (max |diff|, kernel ms, plain ms)."""
    from mymedialite_tpu_torch.ops.sgd_epoch import (
        sgd_epoch, sgd_epoch_reference,
    )
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=loss, biased=biased)
    Wk, Hk, Wr, Hr = W.clone(), H.clone(), W.clone(), H.clone()
    _, _, kernel_ms, plain_ms = time_kernel_and_plain(
        lambda: sgd_epoch(Wk, Hk, plan.packed, order, hp, rates, **kw),
        lambda: sgd_epoch_reference(Wr, Hr, plan.packed, order, hp, rates,
                                    **kw))
    return table_error((Wk, Hk), (Wr, Hr)), kernel_ms, plain_ms


def phase_kernel_check(dev):
    from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
    from mymedialite_tpu_torch.ops import plan as mxu
    from mymedialite_tpu_torch.ops import sgd
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=3)
    plan = mxu.prepare_mxu_data(data.users, data.items, data.values, 2000,
                                3000, user_block=512, item_block=1024,
                                chunk=640, shuffle_seed=4, device=dev)
    rng = np.random.default_rng(5)
    tabs = (0.1 * rng.standard_normal((2000, 40)),
            0.1 * rng.standard_normal((3000, 40)),
            0.1 * rng.standard_normal(2000), 0.1 * rng.standard_normal(3000))
    W, H = mxu.extend_tables_mxu(plan, *tabs)
    order = plan.epoch_order(6)
    worst = 0.0
    for biased in (True, False):
        for loss in (sgd.LOSS_RMSE, sgd.LOSS_MAE, sgd.LOSS_LOGISTIC):
            # the models' default rates (BiasedMatrixFactorization.cs)
            rates = mxu.mxu_column_rates(40, W.shape[1], 0.01, 0.015, 0.015,
                                         1.0, 0.01, biased, True, True,
                                         device=dev)
            hp = (0.6, 1.0, 4.0) if biased else (3.6, 1.0, 4.0)
            err, k_ms, p_ms = kernel_vs_plain(plan, W, H, order, hp, rates,
                                              loss=loss, biased=biased)
            log(f"kernel check loss={loss} biased={biased}: max_abs_err "
                f"{err:.3e} (tol {KERNEL_TOL}) kernel {k_ms:.2f} ms "
                f"plain {p_ms:.1f} ms ({plan.num_chunks} chunks)")
            if not err <= KERNEL_TOL:
                raise AssertionError(f"kernel disagrees: {err} > {KERNEL_TOL}")
            worst = max(worst, err)
    return worst


def bpr_kernel_vs_plain(plan, state, W, H, order, neg_plan, bits, rates, *,
                        soft_margin, wbpr, bitmask):
    """One BPR epoch of the kernel and of the plain version from the
    same tables, order, negative plan and bits. Returns (max |diff|,
    kernel ms, plain ms); raises unless the sampled negatives are
    identical."""
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
    return table_error((Wk, Hk), (Wr, Hr)), kernel_ms, plain_ms


def bpr_epoch_inputs(plan, state, meta, seed):
    """Order, negative plan and bits of one epoch, as BPRMF draws them."""
    from mymedialite_tpu_torch.ops import bpr_plan
    order = plan.epoch_order(seed)
    neg_plan = bpr_plan.epoch_negative_plan(
        plan, state["nvalid"], order[0].cpu().numpy(), meta[3], seed + 1)
    gen = torch.Generator(device=plan.packed.device)
    gen.manual_seed(seed)
    bits = torch.randint(0, 2 ** 31, (plan.num_chunks, meta[2], plan.chunk),
                         dtype=torch.int32, generator=gen,
                         device=plan.packed.device)
    return order, neg_plan, bits


def phase_bpr_kernel_check(dev):
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.ops import bpr_plan
    feedback = posonly_from_ratings(synthetic_ratings(
        num_users=2000, num_items=3000, num_ratings=100_000, seed=3))
    plan, state, meta = bpr_plan.prepare_bpr_mxu(
        feedback, uniform_user=True, shuffle_seed=4, bitmask=True,
        device=dev)
    rng = np.random.default_rng(5)
    U, I = feedback.num_users, feedback.num_items
    W, H = bpr_plan.bpr_tables_to_mxu(
        *(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            0.1 * rng.standard_normal((U, 40)),
            0.1 * rng.standard_normal((I, 40)),
            0.1 * rng.standard_normal(I))),
        torch.from_numpy(plan.new_of_old.astype(np.int64)).to(dev),
        u_pad=plan.u_pad, i_pad=plan.i_pad, fe=64)
    # BPRMF's default rates (reference BPRMF.cs)
    rates = bpr_plan.bpr_mxu_column_rates(40, 64, 0.05, 0.0025, 0.0025,
                                          0.00025, 0.0, True, device=dev)
    order, neg_plan, bits = bpr_epoch_inputs(plan, state, meta, 6)
    worst = 0.0
    for soft_margin, wbpr in ((False, False), (True, False), (False, True)):
        if wbpr:
            neg_plan = bpr_plan.epoch_negative_plan(
                plan, state["nvalid"], order[0].cpu().numpy(), meta[3], 7,
                block_mass=state["block_mass"])
        for bitmask in (False, True):
            err, k_ms, p_ms = bpr_kernel_vs_plain(
                plan, state, W, H, order, neg_plan, bits, rates,
                soft_margin=soft_margin, wbpr=wbpr, bitmask=bitmask)
            log(f"bpr kernel check soft_margin={soft_margin} wbpr={wbpr} "
                f"membership={'bitmask' if bitmask else 'keys'}: negatives "
                f"identical, max_abs_err {err:.3e} (tol {KERNEL_TOL}) kernel "
                f"{k_ms:.2f} ms plain {p_ms:.1f} ms ({plan.num_chunks} chunks)")
            if not err <= KERNEL_TOL:
                raise AssertionError(f"bpr kernel disagrees: {err}")
            worst = max(worst, err)
    return worst


def netflix_shaped():
    """Netflix-shaped ratings, split 80/20 (phases 6 and 7 share them)."""
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    t0 = time.perf_counter()
    data = synthetic_ratings(num_users=480_000, num_items=17_770,
                             num_ratings=20_000_000, seed=1)
    train, test = split_ratings(data, 0.2, seed=2)
    log(f"data: {len(data)} pairs, {len(train)} train / {len(test)} test, "
        f"{time.perf_counter() - t0:.1f} s")
    return data, train, test


def phase_main_path(dev, tmp, train, test):
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models import mf as mf_module
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    from mymedialite_tpu_torch.ops import plan as mxu
    from mymedialite_tpu_torch.ops.sgd_epoch import sgd_epoch

    model = create_rating_predictor(
        "BiasedMatrixFactorization",
        f"num_factors=40 num_iter=3 device={dev.type}")
    model.ratings = train

    torch.cuda.reset_peak_memory_stats()
    with timed_training((mxu, "prepare_mxu_data"),
                        (mf_module, "sgd_epoch")) as timings:
        sgd_epoch.launches = 0
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = sgd_epoch.launches
    if launches != model.num_iter:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{model.num_iter} epochs")
    We, He = model._mxu_tables
    if We.device.type != dev.type or He.device.type != dev.type:
        raise AssertionError("kernel-layout tables are not on the card")
    plan = model._plan
    epoch_ms = float(np.mean(timings["epoch_ms"]))
    log(f"train: {train_s:.2f} s; plan prep {timings['plan_s'][0]:.2f} s "
        f"({plan.num_chunks} chunks of {plan.chunk}, {plan.n_ublocks} x "
        f"{plan.n_iblocks} blocks); epochs "
        f"{', '.join(f'{t:.1f}' for t in timings['epoch_ms'])} ms; "
        f"{len(train) / (epoch_ms / 1e3):.4g} real-rating updates/s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the kernel against the plain version at the main path's shape, from
    # the trained tables (one more epoch each)
    rates = model._epoch_rates(True, True)
    hp = (model.global_bias, model.min_rating, model._rating_range())
    err, kernel_ms, plain_ms = kernel_vs_plain(
        plan, We, He, plan.epoch_order(12345), hp, rates,
        loss=model.loss_id, biased=True)
    log(f"full-shape epoch: kernel {kernel_ms:.1f} ms, plain "
        f"{plain_ms:.1f} ms, max_abs_err {err:.3e} (tol {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"kernel disagrees at full shape: {err}")

    t0 = time.perf_counter()
    res = evaluate_ratings(model, test, train)
    eval_s = time.perf_counter() - t0
    baseline = float(np.sqrt(np.mean(
        (test.values.astype(np.float64) - train.values.mean()) ** 2)))
    log(f"eval: {res} ({eval_s:.2f} s); global-average RMSE {baseline:.5f}")
    if not (math.isfinite(res["RMSE"]) and res["RMSE"] < baseline):
        raise AssertionError("RMSE does not beat the global average")

    rng = np.random.default_rng(7)
    users = rng.integers(0, train.num_users, 10_000).astype(np.int32)
    items = rng.integers(0, train.num_items, 10_000).astype(np.int32)
    before = model.predict_batch(users, items)
    path = os.path.join(tmp, "biasedmf.model")
    t0 = time.perf_counter()
    model.save_model(path)
    loaded = create_rating_predictor("BiasedMatrixFactorization",
                                     f"device={dev.type}")
    loaded.load_model(path)
    after = loaded.predict_batch(users, items)
    log(f"save+load: {time.perf_counter() - t0:.1f} s")
    if before.shape != (10_000,) or not np.isfinite(before).all():
        raise AssertionError("bad predictions")
    if not np.array_equal(before, after):
        raise AssertionError("save -> load changed the predictions: max "
                             f"{np.abs(before - after).max()}")
    return launches, err, kernel_ms, plain_ms


def phase_item_main_path(dev, train, test):
    from mymedialite_tpu_torch.data.synthetic import posonly_from_ratings
    from mymedialite_tpu_torch.eval.ranking import evaluate_items
    from mymedialite_tpu_torch.models import bpr as bpr_module
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    from mymedialite_tpu_torch.ops import bpr_plan
    from mymedialite_tpu_torch.ops.bpr_epoch import bpr_epoch

    train, test = posonly_from_ratings(train), posonly_from_ratings(test)
    model = create_item_recommender(
        "BPRMF", f"num_factors=40 num_iter=3 device={dev.type}")
    model.feedback = train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed_training((bpr_plan, "prepare_bpr_mxu"),
                        (bpr_module, "bpr_epoch")) as timings:
        bpr_epoch.launches = 0
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = bpr_epoch.launches
    if launches != model.num_iter:
        raise AssertionError(f"{launches} BPR kernel launches for "
                             f"{model.num_iter} epochs")
    We, He = model._mxu_tables
    if We.device.type != dev.type or He.device.type != dev.type:
        raise AssertionError("kernel-layout tables are not on the card")
    plan, state = model._plan, model._neg_state
    epoch_ms = float(np.mean(timings["epoch_ms"]))
    log(f"bpr train: {train_s:.2f} s; plan prep {timings['plan_s'][0]:.2f} s "
        f"({plan.num_chunks} chunks of {plan.chunk}, {plan.n_ublocks} x "
        f"{plan.n_iblocks} blocks, membership "
        f"{'bitmask' if 'bitmask_tbl' in state else 'keys'}); epochs "
        f"{', '.join(f'{t:.1f}' for t in timings['epoch_ms'])} ms; "
        f"{len(train) / (epoch_ms / 1e3):.4g} training triples/s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the kernel against the plain version at the main path's shape, from
    # the trained tables (one more epoch each)
    rates = bpr_plan.bpr_mxu_column_rates(
        40, We.shape[1], model.learn_rate, model.reg_u, model.reg_i,
        model.reg_j, model.bias_reg, model.update_j, device=dev)
    order, neg_plan, bits = bpr_epoch_inputs(plan, state, model._neg_meta,
                                             12345)
    err, kernel_ms, plain_ms = bpr_kernel_vs_plain(
        plan, state, We, He, order, neg_plan, bits, rates, soft_margin=False,
        wbpr=False, bitmask="bitmask_tbl" in state)
    log(f"full-shape bpr epoch: kernel {kernel_ms:.1f} ms, plain "
        f"{plain_ms:.1f} ms, negatives identical, max_abs_err {err:.3e} "
        f"(tol {KERNEL_TOL})")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"bpr kernel disagrees at full shape: {err}")

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
    for name, m in (("BPRMF", model), ("MostPopular", popular)):
        t0 = time.perf_counter()
        res = evaluate_items(m, test, train, test_users=users)
        log(f"ranking eval {name}, {res['num_users']} users: {res} "
            f"({time.perf_counter() - t0:.2f} s)")
        for k in ("AUC", "prec@5", "NDCG"):
            if not math.isfinite(res[k]):
                raise AssertionError(f"{name} {k} is not finite")
        results[name] = res
    if not results["BPRMF"]["AUC"] > 0.6:
        raise AssertionError(f"BPRMF AUC {results['BPRMF']['AUC']} <= 0.6")
    return launches, err, kernel_ms, plain_ms


def phase_cli(dev, tmp):
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.cli import rating_prediction
    from mymedialite_tpu_torch.ops.sgd_epoch import sgd_epoch

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
    before = sgd_epoch.launches
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = rating_prediction.main([
            "--training-file", paths[0], "--test-file", paths[1],
            "--recommender-options",
            f"num_factors=40 num_iter=3 device={dev.type}"])
    text = out.getvalue()
    log(text.rstrip())
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    line = text.strip().splitlines()[-1]
    tokens = line.split()
    rmse = float(tokens[tokens.index("RMSE") + 1])
    if not (math.isfinite(rmse) and 0 < rmse < 2):
        raise AssertionError(f"bad CLI result line: {line}")
    if sgd_epoch.launches - before != 3:
        raise AssertionError("the CLI did not run the kernel")


def phase_item_cli(dev, tmp):
    from mymedialite_tpu_torch.cli import item_recommendation
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, split_posonly, synthetic_ratings,
    )
    from mymedialite_tpu_torch.ops.bpr_epoch import bpr_epoch

    data = posonly_from_ratings(synthetic_ratings(
        num_users=6040, num_items=3706, num_ratings=1_000_000, seed=4))
    train, test = split_posonly(data, 0.1, seed=5)
    paths = []
    for name, part in (("items_train", train), ("items_test", test)):
        path = os.path.join(tmp, f"{name}.tsv")
        np.savetxt(path, np.column_stack([part.users, part.items]),
                   fmt="%d", delimiter="\t")
        paths.append(path)
    model_path = os.path.join(tmp, "bprmf.model")
    argv = ["--training-file", paths[0], "--test-file", paths[1],
            "--recommender", "BPRMF", "--recommender-options",
            f"num_factors=40 num_iter=3 device={dev.type}"]

    def run(extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = item_recommendation.main(argv + extra)
        text = out.getvalue()
        log(text.rstrip())
        if rc != 0:
            raise AssertionError(f"item CLI returned {rc}")
        return text

    bpr_epoch.launches = 0
    trained = run(["--save-model", model_path])
    if bpr_epoch.launches != 3:
        raise AssertionError(f"the item CLI launched the BPR kernel "
                             f"{bpr_epoch.launches} times, not 3")
    line = trained.strip().splitlines()[-1]
    tokens = line.split()
    auc = float(tokens[tokens.index("AUC") + 1])
    if not (math.isfinite(auc) and 0.5 < auc <= 1):
        raise AssertionError(f"bad item CLI result line: {line}")
    loaded = run(["--load-model", model_path])
    if _TIMES.sub("", loaded) != _TIMES.sub("", trained):
        raise AssertionError("save -> load through the CLI changed the "
                             f"result line:\n{trained}\n{loaded}")
    return auc


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
    worst = phase_kernel_check(dev)
    worst_bpr = phase_bpr_kernel_check(dev)
    _, train, test = netflix_shaped()
    with tempfile.TemporaryDirectory() as tmp:
        launches, err_full, kernel_ms, plain_ms = phase_main_path(
            dev, tmp, train, test)
        torch.cuda.empty_cache()
        b_launches, b_err, b_ms, b_plain_ms = phase_item_main_path(
            dev, train, test)
        torch.cuda.empty_cache()
        phase_cli(dev, tmp)
        phase_item_cli(dev, tmp)
    log(f"all phases: {time.perf_counter() - t_start:.1f} s after the build")

    print(json.dumps({"kernels": [{
        "name": "sgd_epoch",
        "route": "cuda",
        "source": "mymedialite_tpu_torch/csrc/sgd_epoch.cu",
        "replaces": "mymedialite_tpu/ops/pallas_sgd.py:324",
        "launches": launches,
        "max_abs_err": max(worst, err_full),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "bpr_epoch",
        "route": "cuda",
        "source": "mymedialite_tpu_torch/csrc/bpr_epoch.cu",
        "replaces": "mymedialite_tpu/ops/pallas_bpr.py:451",
        "launches": b_launches,
        "max_abs_err": max(worst_bpr, b_err),
        "ms": b_ms,
        "plain_ms": b_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
