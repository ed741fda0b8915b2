"""Chip smoke test of the PyTorch / CUDA port (mymedialite_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the CUDA kernels from ``mymedialite_tpu_torch/csrc`` with nvcc;
3. the SGD-epoch kernel against its plain PyTorch version on the card,
   2,000 users x 3,000 items x 100k ratings, k=40, one epoch from the same
   tables and order, for every loss x biased combination;
4. the main path at full width: BiasedMatrixFactorization (k=40, 3
   epochs) trained through the registry on Netflix-shaped synthetic
   ratings (480,000 users x 17,770 items x 20M ratings, split 80/20),
   evaluated, saved and loaded; the kernel against the plain version at
   this shape, and both timed;
5. the rating_prediction CLI in process at 6,040 x 3,706 x 1M ratings.

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
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KERNEL_TOL = 1e-4   # atomics add in a run-dependent order


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_vs_plain(plan, W, H, order, hp, rates, *, loss, biased):
    """One epoch of the kernel and of the plain version from the same
    tables and order. Returns (max |diff|, kernel ms, plain ms)."""
    from mymedialite_tpu_torch.ops.sgd_epoch import (
        sgd_epoch, sgd_epoch_reference,
    )
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=loss, biased=biased)
    Wk, Hk, Wr, Hr = W.clone(), H.clone(), W.clone(), H.clone()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    sgd_epoch(Wk, Hk, plan.packed, order, hp, rates, **kw)
    end.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(end)
    t0 = time.perf_counter()
    sgd_epoch_reference(Wr, Hr, plan.packed, order, hp, rates, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for t in (Wk, Hk):
        if not torch.isfinite(t).all():
            raise AssertionError("kernel produced non-finite tables")
    err = max((Wk - Wr).abs().max().item(), (Hk - Hr).abs().max().item())
    return err, kernel_ms, plain_ms


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


def phase_main_path(dev, tmp):
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models import mf as mf_module
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    from mymedialite_tpu_torch.ops import plan as mxu
    from mymedialite_tpu_torch.ops.sgd_epoch import sgd_epoch

    t0 = time.perf_counter()
    data = synthetic_ratings(num_users=480_000, num_items=17_770,
                             num_ratings=20_000_000, seed=1)
    train, test = split_ratings(data, 0.2, seed=2)
    log(f"data: {len(train)} train / {len(test)} test ratings, "
        f"{time.perf_counter() - t0:.1f} s")

    model = create_rating_predictor(
        "BiasedMatrixFactorization",
        f"num_factors=40 num_iter=3 device={dev.type}")
    model.ratings = train

    # time the plan and each epoch without changing the entry point
    timings = {"plan_s": [], "epoch_ms": []}
    real_prepare, real_epoch = mxu.prepare_mxu_data, mf_module.sgd_epoch

    def timed_prepare(*a, **kw):
        t = time.perf_counter()
        out = real_prepare(*a, **kw)
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

    mxu.prepare_mxu_data, mf_module.sgd_epoch = timed_prepare, timed_epoch
    torch.cuda.reset_peak_memory_stats()
    try:
        sgd_epoch.launches = 0
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = sgd_epoch.launches
    finally:
        mxu.prepare_mxu_data, mf_module.sgd_epoch = real_prepare, real_epoch
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
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from mymedialite_tpu_torch.ops._build import load_library
    lib = load_library()
    log(f"build: {lib.build_seconds:.1f} s -> {os.path.relpath(lib.path)}")
    for line in lib.compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  {line.strip()}")

    worst = phase_kernel_check(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches, err_full, kernel_ms, plain_ms = phase_main_path(dev, tmp)
        phase_cli(dev, tmp)

    print(json.dumps({"kernels": [{
        "name": "sgd_epoch",
        "route": "cuda",
        "source": "mymedialite_tpu_torch/csrc/sgd_epoch.cu",
        "replaces": "mymedialite_tpu/ops/pallas_sgd.py:324",
        "launches": launches,
        "max_abs_err": max(worst, err_full),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
