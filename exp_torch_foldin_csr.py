"""Seconds a user of the port's incremental fold-in protocol
(``eval/foldin.py evaluate_fold_in_incremental_training``: add a user's
ratings, predict, remove them) with the CSR views of each added or
reduced dataset derived from its parent's (``data/arrays.py``), and with
every view rebuilt from scratch by ``build_csr`` (a lexsort of every
rating), as before the derivation.

    python3 exp_torch_foldin_csr.py [--users 3] [--device cuda] \
        [--num-users 480000] [--num-items 17770] [--num-ratings 20000000]

BiasedMatrixFactorization (k=40, one epoch, then 30 steps a row refresh)
on the 80/20 split of ``synthetic_ratings(480_000, 17_770, 20_000_000,
seed=1)``, the shape of ``chip_smoke.py``'s phase 6, at the learn rate
0.5 / the longest history, as phase 22 runs the protocol. The protocol
runs over ``--users`` seeded test users of at least 4 test ratings,
split 50/50 into update and evaluation (a user whose ratings all fall
on one side is skipped, as the protocol skips it), three times:
derived, rebuilt, derived. Each run is timed on the host clock with the device
synchronised around it and counts the ``build_csr`` calls. Prints one
line per run and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-users", type=int, default=480_000)
    ap.add_argument("--num-items", type=int, default=17_770)
    ap.add_argument("--num-ratings", type=int, default=20_000_000)
    args = ap.parse_args()

    from mymedialite_tpu_torch.data import arrays
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.eval.foldin import (
        evaluate_fold_in_incremental_training,
    )
    from mymedialite_tpu_torch.models.registry import create_rating_predictor

    sync = (torch.cuda.synchronize if args.device == "cuda"
            else (lambda: None))
    train, test = split_ratings(synthetic_ratings(
        args.num_users, args.num_items, args.num_ratings, seed=1), 0.2,
        seed=2)
    model = create_rating_predictor(
        "BiasedMatrixFactorization",
        f"num_factors=40 num_iter=1 device={args.device}")
    model.ratings = train
    model.train()
    model.num_iter = 30
    longest = max(int(np.bincount(train.items).max()),
                  int(np.bincount(train.users).max()))
    model.learn_rate = min(model.learn_rate, 0.5 / longest)

    rng = np.random.default_rng(24)
    counts = np.bincount(test.users, minlength=test.num_users)
    users = np.sort(rng.choice(np.flatnonzero(counts >= 4), args.users,
                               replace=False))
    idx = np.nonzero(np.isin(test.users, users))[0]
    half = np.random.default_rng(25).random(idx.size) < 0.5
    update, held = test.select(idx[half]), test.select(idx[~half])
    update.by_user, held.by_user  # noqa: B018 (built before the runs)
    n = np.intersect1d(update.users, held.users).size  # users evaluated

    real_build = arrays.build_csr
    real_derive = arrays.InteractionData._derived_from
    builds = [0]

    def counted_build(*a, **kw):
        builds[0] += 1
        return real_build(*a, **kw)
    arrays.build_csr = counted_build
    model.ratings.by_user, model.ratings.by_item  # noqa: B018 (built once)
    out = {"device": args.device, "users": int(n),
           "ratings": len(train), "learn_rate": model.learn_rate}
    for run, mode in enumerate(("derived", "rebuilt", "derived")):
        arrays.InteractionData._derived_from = (
            real_derive if mode == "derived"
            else (lambda self, parent, kind, info: self))
        builds[0] = 0
        sync()
        t0 = time.perf_counter()
        res = evaluate_fold_in_incremental_training(model, update, held)
        sync()
        seconds = time.perf_counter() - t0
        print(f"run {run} ({mode}): {seconds:.3f} s, "
              f"{seconds / n:.3f} s a user, {builds[0]} build_csr calls; "
              f"RMSE {res['RMSE']:.5f}", flush=True)
        out.setdefault(mode, []).append(
            {"seconds_a_user": seconds / n,
             "build_csr_calls": builds[0], "rmse": res["RMSE"]})
    arrays.InteractionData._derived_from = real_derive
    arrays.build_csr = real_build
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
