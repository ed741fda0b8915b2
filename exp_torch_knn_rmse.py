"""RMSE of rating ItemKNN (Pearson, k=40) beside UserItemBaseline's, in the
JAX package and in the port, on the same synthetic ratings, on the CPU.

    JAX_PLATFORMS=cpu python3 exp_torch_knn_rmse.py \
        [--users 60000] [--items 3000] [--ratings 1500000] [--pairs 20000]

Both packages train on the same 80/20 split of ``synthetic_ratings(users,
items, ratings, seed=1)`` and predict the same ``--pairs`` test pairs,
drawn from a seed: UserItemBaseline, then ItemKNN (Pearson, k=40) with
shrinkage (``alpha``) 0, the default, and 100, each with the dense
correlation and with the top-k store (128 neighbours a row; the dense
bound ``DENSE_NMAX`` shrunk in both packages to force it, as the tests
do). The JAX package predicts pair by pair on the host, hence the
sample. Prints one line per model and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def rmse(pred, truth):
    d = np.asarray(pred, np.float64) - truth
    return float(np.sqrt(np.mean(d * d)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=60_000)
    ap.add_argument("--items", type=int, default=3_000)
    ap.add_argument("--ratings", type=int, default=1_500_000)
    ap.add_argument("--pairs", type=int, default=20_000)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from mymedialite_tpu.data.arrays import RatingData as JaxRatingData
    from mymedialite_tpu.models.registry import (
        create_rating_predictor as jax_create,
    )
    from mymedialite_tpu.ops import correlation as jax_corr
    from mymedialite_tpu.utils.params import configure as jax_configure
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.models.registry import (
        create_rating_predictor as torch_create,
    )
    from mymedialite_tpu_torch.ops import correlation as torch_corr
    from mymedialite_tpu_torch.utils.params import configure as torch_configure

    train, test = split_ratings(synthetic_ratings(
        args.users, args.items, args.ratings, seed=1), 0.2, seed=2)
    pick = np.sort(np.random.default_rng(3).choice(
        len(test), min(args.pairs, len(test)), replace=False))
    users, items = test.users[pick], test.items[pick]
    truth = test.values[pick].astype(np.float64)
    jax_train = JaxRatingData(train.users, train.items, train.values,
                              num_users=train.num_users,
                              num_items=train.num_items)
    print(f"{train.num_users} users x {train.num_items} items, "
          f"{len(train)} train ratings, {len(pick)} of {len(test)} test "
          f"pairs", flush=True)

    packages = (("jax", jax_create, jax_configure, jax_corr, jax_train),
                ("torch", torch_create, torch_configure, torch_corr, train))
    configs = [("UserItemBaseline", "", None)]
    for alpha in (0, 100):
        for store, limit in (("dense", 16_384), ("top-k", 8)):
            configs.append(("ItemKNN", f"k=40 correlation=Pearson "
                            f"alpha={alpha}", (store, limit)))
    out = []
    for name, opts, storage in configs:
        row = dict(model=name, options=opts,
                   storage=storage[0] if storage else None)
        for pkg, create, configure, corr, data in packages:
            saved = corr.DENSE_NMAX
            if storage:
                corr.DENSE_NMAX = storage[1]
            try:
                model = create(name)
                configure(model, opts + (" device=cpu" if pkg == "torch"
                                         else ""))
                model.ratings = data
                t0 = time.perf_counter()
                model.train()
                row[pkg] = rmse(model.predict_batch(users, items), truth)
                row[f"{pkg}_s"] = time.perf_counter() - t0
            finally:
                corr.DENSE_NMAX = saved
        print(f"{name} {opts} {row['storage'] or ''}: RMSE jax "
              f"{row['jax']:.5f}, torch {row['torch']:.5f}", flush=True)
        out.append(row)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
