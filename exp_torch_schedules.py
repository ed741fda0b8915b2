"""The resident and the slab-tiled schedule of the port on one catalog.

Run on a machine with one CUDA card, from the repository root:

    python3 exp_torch_schedules.py

On the MovieLens-25M-shaped ratings of ``chip_smoke.py`` (the same
generator, seed and split) it trains BiasedMatrixFactorization and BPRMF
(k=40) through the registry for 3 and for 10 epochs on each schedule:
the tiled one, which the catalog selects, and the resident one, forced
by raising the resident item-table bound past the catalog; and, for
BPRMF, the tiled schedule with each epoch's visit order shuffled
("tiled-shuffled": the same chunks, negative blocks and bits, no longer
slab-major). Both variants patch the port for the duration of their runs
only, as the tests patch its constants. It prints, per run, the
schedule, the epoch kernel's launches, the median epoch time (CUDA events
around ``model.iterate()``) and the held-out quality (RMSE; AUC and
prec@5 on 4,096 seeded test users), then MostPopular's on the same users,
and one JSON line with all of it. It answers whether the tiled schedule
trains as well as the resident one: the two visit the same chunks in
another order and draw negatives per slab group instead of per chunk;
the shuffled variant separates the order from the draws.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

EPOCHS = (3, 10)


def train_timed(model, epochs):
    model.init_model()
    times = []
    for _ in range(epochs):
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        model.iterate()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def variant(schedule):
    """The patch under which ``schedule`` runs."""
    from mymedialite_tpu_torch.ops import bpr_plan, plan
    if schedule == "resident":
        # the bound lifted past the 16 MB item table
        return mock.patch.object(plan, "RESIDENT_ITEM_TABLE_BYTES",
                                 64 * 1024 * 1024)
    if schedule == "tiled-shuffled":
        slab_major = bpr_plan.bpr_tiled_epoch_order

        def shuffled_order(*args, seed, **kw):
            order = slab_major(*args, seed=seed, **kw)
            perm = torch.from_numpy(np.random.default_rng(seed).permutation(
                order[0].numel())).to(order[0].device)
            return tuple(t[perm].contiguous() for t in order)
        return mock.patch.object(bpr_plan, "bpr_tiled_epoch_order",
                                 shuffled_order)
    return contextlib.nullcontext()


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, split_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.eval.ranking import evaluate_items
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models.registry import (
        create_item_recommender, create_rating_predictor,
    )
    from mymedialite_tpu_torch.ops import plan
    from mymedialite_tpu_torch.ops.bpr_epoch import bpr_epoch, bpr_epoch_tiled
    from mymedialite_tpu_torch.ops.sgd_epoch import sgd_epoch, sgd_epoch_tiled

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    data = synthetic_ratings(num_users=162_541, num_items=62_423,
                             num_ratings=25_000_095, seed=25)
    train, test = split_ratings(data, 0.2, seed=2)
    ptrain, ptest = posonly_from_ratings(train), posonly_from_ratings(test)
    users = np.sort(np.random.default_rng(9).choice(ptest.all_users, 4096,
                                                    replace=False))
    ptrain.by_user, ptest.by_user
    print(f"data {len(train)} train / {len(test)} test, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    counters = (sgd_epoch, sgd_epoch_tiled, bpr_epoch, bpr_epoch_tiled)
    runs = [(schedule, epochs, name)
            for schedule in ("tiled", "resident", "tiled-shuffled")
            for epochs in EPOCHS
            for name in ("BiasedMatrixFactorization", "BPRMF")
            if schedule != "tiled-shuffled" or name == "BPRMF"]
    rows = []
    for schedule, epochs, name in runs:
        with variant(schedule):
            assert plan.select_schedule(train.num_items, 40) == \
                schedule.split("-")[0]
            for fn in counters:
                fn.launches = 0
            if name == "BPRMF":
                m = create_item_recommender(
                    name, f"num_factors=40 num_iter={epochs} device=cuda")
                m.feedback = ptrain
            else:
                m = create_rating_predictor(
                    name, f"num_factors=40 num_iter={epochs} device=cuda")
                m.ratings = train
            epoch_ms = train_timed(m, epochs)
            if name == "BPRMF":
                res = evaluate_items(m, ptest, ptrain, test_users=users)
                quality = dict(AUC=res["AUC"], prec5=res["prec@5"])
            else:
                quality = dict(RMSE=evaluate_ratings(m, test, train)["RMSE"])
        row = dict(model=name, schedule=schedule, epochs=epochs,
                   launches={fn.__name__: fn.launches
                             for fn in counters if fn.launches},
                   epoch_ms=epoch_ms, **quality)
        print(row, flush=True)
        rows.append(row)
        del m
        torch.cuda.empty_cache()
    pop = create_item_recommender("MostPopular")
    pop.feedback = ptrain
    pop.train()
    res = evaluate_items(pop, ptest, ptrain, test_users=users)
    base = float(np.sqrt(np.mean((test.values.astype(np.float64)
                                  - train.values.mean()) ** 2)))
    print(json.dumps(dict(card=card, runs=rows, most_popular=dict(
        AUC=res["AUC"], prec5=res["prec@5"]), global_average_rmse=base)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
