"""Seed bands of the quality driver's kernel rows at ``--small``, in the
JAX package and in the port, on the CPU, on the same data.

    JAX_PLATFORMS=cpu python3 exp_torch_quality_bands.py [--seeds 3]
        [--rows NAME,...] [--json PATH]

The rows are those of ``quality.py`` that run a Pallas kernel on a TPU:
BiasedMatrixFactorization, MatrixFactorization, the three SVD++ rows and
the four BPR rows. Each trains with ``random_seed`` at the model's
default (42), +1, ..., +N-1 on the data of ``quality.py --small``
(``mymedialite_tpu_torch/quality.py``'s, which the tests hold equal to
the JAX package's). The JAX package runs its kernels in interpret mode
(``MML_MXU=interpret``) with float32 operands (``mxu_dtype="f32"``; SVD++,
which has no such option, through ``svdpp_epoch_mxu`` bound to it, with a
pass of 256 grid steps, as ``tests/test_torch_svdpp.py`` runs it); the
port runs its kernels' plain versions (``--device cpu``). Neither package
is edited.

For each row it prints the JAX band and the port's (median [min, max]
of RMSE or AUC over the seeds) and how they sit: overlapping, or apart
by the gap between them; a gap wider than the wider band is marked a
divergence. ``--json`` writes one record per (package, row, seed).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import time

KERNEL_ROWS = ("BiasedMatrixFactorization", "MatrixFactorization",
               "SVDPlusPlus", "SigmoidSVDPlusPlus",
               "SigmoidItemAsymmetricFactorModel", "BPRMF", "WeightedBPRMF",
               "SoftMarginRankingMF")
SCALE = 0.05


def band(values):
    return statistics.median(values), min(values), max(values)


def relation(a, b) -> str:
    """How two bands (median, lo, hi) sit: overlapping, or apart by the
    gap between them (a divergence where the gap passes the wider
    band)."""
    gap = max(a[1] - b[2], b[1] - a[2], 0.0)
    if gap == 0.0:
        return "overlapping"
    wider = max(a[2] - a[1], b[2] - b[1])
    return f"apart by {gap:.5f}" + (" (divergence: wider than both bands)"
                                    if gap > wider else "")


def jax_row(section, name, opts, data, seed):
    """One JAX row at ``seed``: (metrics, train s)."""
    from mymedialite_tpu.eval import evaluate_items, evaluate_ratings
    from mymedialite_tpu.models.registry import (
        create_item_recommender, create_rating_predictor,
    )
    from mymedialite_tpu.utils.params import configure
    model = (create_item_recommender if section == "item"
             else create_rating_predictor)(name)
    configure(model, opts)
    model.random_seed = seed
    if hasattr(model, "mxu_dtype"):
        model.mxu_dtype = "f32"
    train, test = data
    if section == "item":
        model.feedback = train
    else:
        model.ratings = train
    t0 = time.perf_counter()
    model.train()
    train_s = time.perf_counter() - t0
    res = evaluate_items(model, test, train) if section == "item" \
        else evaluate_ratings(model, test)
    return {k: float(v) for k, v in res.items()}, train_s


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--rows", default=",".join(KERNEL_ROWS))
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    rows = args.rows.split(",")

    os.environ["MML_MXU"] = "interpret"
    import jax
    import torch
    jax.config.update("jax_platforms", "cpu")
    from mymedialite_tpu.data.arrays import PosOnlyData as JPos
    from mymedialite_tpu.data.arrays import RatingData as JRatings
    from mymedialite_tpu.ops import pallas_svdpp as psv
    from mymedialite_tpu_torch import quality
    psv.svdpp_epoch_mxu = functools.partial(psv.svdpp_epoch_mxu,
                                            mxu_dtype="f32")
    psv.prepare_svdpp_mxu = functools.partial(psv.prepare_svdpp_mxu,
                                              pass_len=256)

    train, test, _ = quality.rating_data(SCALE)
    ptrain, ptest = quality.implicit_data(SCALE)

    def jax_ratings(d):
        return JRatings(d.users, d.items, d.values, num_users=d.num_users,
                        num_items=d.num_items)

    def jax_pos(d):
        return JPos(d.users, d.items, num_users=d.num_users,
                    num_items=d.num_items)
    jdata = {"rating": (jax_ratings(train), jax_ratings(test)),
             "item": (jax_pos(ptrain), jax_pos(ptest))}
    pdata = {"rating": dict(train=train, test=test),
             "item": dict(train=ptrain, test=ptest)}
    configs = [("rating", n, o) for n, o in quality.RATING_CONFIGS] + \
        [("item", n, o) for n, o in quality.ITEM_CONFIGS]
    out = open(args.json, "w") if args.json else None
    summary = []
    for section, name, opts in configs:
        if name not in rows:
            continue
        metric = "AUC" if section == "item" else "RMSE"
        seeds = [42 + k for k in range(args.seeds)]
        found = {}
        for package in ("jax", "port"):
            values = []
            for seed in seeds:
                if package == "jax":
                    metrics, train_s = jax_row(section, name, opts,
                                               jdata[section], seed)
                else:
                    rec = quality.run_row(section, name, opts,
                                          pdata[section],
                                          torch.device("cpu"), seed=seed)
                    metrics, train_s = rec["metrics"], rec["train_s"]
                values.append(metrics[metric])
                line = dict(package=package, section=section, name=name,
                            options=opts, seed=seed, metrics=metrics,
                            train_s=train_s)
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                    out.flush()
            found[package] = band(values)
        j, p = found["jax"], found["port"]
        summary.append(
            f"{name:34s} ({opts}) {metric}: JAX {j[0]:.5f} [{j[1]:.5f}, "
            f"{j[2]:.5f}], port {p[0]:.5f} [{p[1]:.5f}, {p[2]:.5f}]; "
            f"{relation(j, p)}")
        print(summary[-1], flush=True)
    print(f"# {args.seeds} seeds from 42, --small, the CPU; the JAX package "
          "in interpret mode with float32 operands, the port's plain "
          "versions")
    for line in summary:
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
