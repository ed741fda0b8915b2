"""Quality driver of the port: the flagship models on ML-1M-shaped
synthetic data, with seed bands.

The counterpart of the repository's ``quality.py`` (the JAX package's):
the same data, seeds and configurations. Rating prediction on
``synthetic_ratings(6040, 3706, 1_000_000, seed=100)`` split 0.1 with
seed 101 (SocialMF with a 10-NN trust graph of the planted user
factors, ``trust_graph``); the time-aware baselines on drifting timed
data (seed 110, split with 111); item recommendation on
``synthetic_posonly(6040, 3706, 500_000, seed=102)`` split 0.2 with seed
103. ``--small`` scales every shape by 0.05.

Each result line is the JAX driver's: the name, the result, the train
and eval seconds, then a tag of the route the model took
(``_route()`` for the MF and BPR families, SVD++'s ``route()``, "plain"
otherwise) and the launches of each kernel of ``csrc/`` across the row,
read from the wrappers' counters.

For seed bands:

- ``--seeds N`` runs each row with ``random_seed`` at the model's
  default, +1, ..., +N-1 (the data stays fixed) and prints, for each
  metric, the min, the median and the max over the seeds. A model
  without a ``random_seed`` runs once.
- ``--runs R`` runs each seed R times and prints the largest difference
  of a metric between runs of one seed.
- ``--large`` adds the routes the ML-1M shape never takes, for
  ``LARGE_EPOCHS`` epochs each: BiasedMF and BPRMF on the slab-tiled
  kernels at the ML-25M shape, and frequency-regularized BiasedMF on the
  blocked epoch at the Netflix shape (both split 80/20 with seed 2, the
  item rows ranked over ``LARGE_EVAL_USERS`` seeded test users).
- ``--json PATH`` writes one JSON record per (row, seed, run) line.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for the card
where there is none raises.

    python -m mymedialite_tpu_torch.quality [--small] [--large]
        [--device cpu] [--seeds N] [--runs R] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

RATING_CONFIGS = [
    ("GlobalAverage", ""),
    ("UserItemBaseline", ""),
    ("BiasedMatrixFactorization",
     "num_factors=40 num_iter=40 bold_driver=true"),
    ("MatrixFactorization", "num_factors=40 num_iter=40"),
    ("SVDPlusPlus", "num_factors=20 num_iter=25 learn_rate=0.003"),
    ("SigmoidSVDPlusPlus", "num_factors=20 num_iter=25 learn_rate=0.003"),
    ("SigmoidItemAsymmetricFactorModel",
     "num_factors=20 num_iter=25 learn_rate=0.003"),
    # full-batch gradient descent: a batch-scale learn rate and depth
    ("SocialMF", "num_factors=40 num_iter=400 learn_rate=0.0002"
                 " social_regularization=0.5"),
    ("ItemKNN", "k=40"),
]
TIME_AWARE_CONFIGS = [
    ("UserItemBaseline", ""),
    ("TimeAwareBaseline", "num_iter=30"),
    ("TimeAwareBaselineWithFrequencies", "num_iter=30"),
]
_TUNED = "num_factors=16 num_iter=100 learn_rate=0.02 reg_u=0.01 reg_i=0.01"
ITEM_CONFIGS = [
    ("Random", ""),
    ("MostPopular", ""),
    ("ItemKNN", "k=80"),
    ("BPRMF", "num_factors=32 num_iter=50"),
    ("BPRMF", f"{_TUNED} reg_j=0.001"),
    ("WeightedBPRMF", f"{_TUNED} reg_j=0.001"),
    ("SoftMarginRankingMF", f"{_TUNED} reg_j=0.001"),
    ("WRMF", "num_factors=32 num_iter=15"),
    ("LeastSquareSLIM", "num_iter=10 reg_l1=0.0001 k=100"),
    ("BPRSLIM", "num_iter=30"),
]
LARGE_EPOCHS = 10
LARGE_EVAL_USERS = 4096
# (section, shape, name, options): the tiled kernels at the published
# ml-25m catalog, the blocked epoch at the Netflix shape with
# chip_smoke.py's options for that phase
LARGE_CONFIGS = [
    ("rating", "MovieLens-25M", "BiasedMatrixFactorization",
     f"num_factors=40 num_iter={LARGE_EPOCHS}"),
    ("item", "MovieLens-25M", "BPRMF",
     f"num_factors=40 num_iter={LARGE_EPOCHS}"),
    ("rating", "Netflix", "BiasedMatrixFactorization",
     f"num_factors=40 num_iter={LARGE_EPOCHS} frequency_regularization=true"),
]
LARGE_SHAPES = {
    "MovieLens-25M": dict(num_users=162_541, num_items=62_423,
                          num_ratings=25_000_095, seed=25),
    "Netflix": dict(num_users=480_000, num_items=17_770,
                    num_ratings=20_000_000, seed=1),
}
BAND_METRICS = {"rating": ("RMSE", "MAE", "CBD"),
                "item": ("AUC", "prec@5", "NDCG", "MAP")}


def scaled(n: int, scale: float, floor: int) -> int:
    return int(n * scale) or floor


def trust_graph(P_true, k: int = 10):
    """Each user trusts its ``k`` nearest users by cosine in the planted
    factor space ``P_true`` [U, rank] (Jamali & Ester 2010: trusted users
    share preferences), as ``quality.py`` builds it: a PosOnlyData of U
    x U edges, k a user."""
    from mymedialite_tpu_torch.data.arrays import PosOnlyData
    P_true = np.asarray(P_true)
    Pn = P_true / np.maximum(
        np.linalg.norm(P_true, axis=1, keepdims=True), 1e-9)
    sim = Pn @ Pn.T
    np.fill_diagonal(sim, -np.inf)
    nbr = np.argpartition(-sim, k, axis=1)[:, :k]
    trust_u = np.repeat(np.arange(P_true.shape[0], dtype=np.int32), k)
    trust_v = nbr.astype(np.int32).reshape(-1)
    return PosOnlyData(trust_u, trust_v, num_users=P_true.shape[0],
                       num_items=P_true.shape[0])


def rating_data(scale: float, device="cpu"):
    """(train, test, P_true): the ML-1M-shaped ratings split 0.1."""
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    data, (P_true, _, _, _) = synthetic_ratings(
        num_users=scaled(6040, scale, 60), num_items=scaled(3706, scale, 40),
        num_ratings=scaled(1_000_000, scale, 5000), seed=100,
        return_factors=True, device=device)
    train, test = split_ratings(data, 0.1, seed=101)
    return train, test, P_true


def timed_data(scale: float, device="cpu"):
    """(train, test): the same shape with times and a per-item drift."""
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    data = synthetic_ratings(
        num_users=scaled(6040, scale, 60), num_items=scaled(3706, scale, 40),
        num_ratings=scaled(1_000_000, scale, 5000), seed=110,
        with_times=True, time_drift=1.0, device=device)
    return split_ratings(data, 0.1, seed=111)


def implicit_data(scale: float):
    """(train, test): the implicit ML-1M-shaped feedback split 0.2."""
    from mymedialite_tpu_torch.data.synthetic import (
        split_posonly, synthetic_posonly,
    )
    pos = synthetic_posonly(
        num_users=scaled(6040, scale, 60), num_items=scaled(3706, scale, 40),
        num_events=scaled(500_000, scale, 4000), seed=102)
    return split_posonly(pos, 0.2, seed=103)


def large_data(shape: str, scale: float, device="cpu"):
    """(train, test): a ``LARGE_SHAPES`` shape split 80/20 with seed 2."""
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    s = LARGE_SHAPES[shape]
    data = synthetic_ratings(
        num_users=scaled(s["num_users"], scale, 60),
        num_items=scaled(s["num_items"], scale, 40),
        num_ratings=scaled(s["num_ratings"], scale, 5000), seed=s["seed"],
        device=device)
    return split_ratings(data, 0.2, seed=2)


def kernel_launches() -> dict:
    """Each kernel wrapper's launch counter."""
    from mymedialite_tpu_torch.ops import (
        bpr_epoch, catalog_topk, sgd_epoch, svdpp_epoch,
    )
    fns = (sgd_epoch.sgd_epoch, sgd_epoch.sgd_epoch_tiled,
           bpr_epoch.bpr_epoch, bpr_epoch.bpr_epoch_tiled,
           svdpp_epoch.svdpp_epoch, catalog_topk.catalog_topk)
    return {fn.__name__: fn.launches for fn in fns}


def route_of(model) -> str:
    """The route a trained model took: ``_route()`` for the MF and BPR
    families, SVD++'s ``route()``, "plain" otherwise (SocialMF, an MF by
    class, takes its own full-batch step)."""
    from mymedialite_tpu_torch.models.social_mf import SocialMF
    if isinstance(model, SocialMF):
        return "plain"
    if hasattr(model, "_route"):
        return model._route()
    if hasattr(model, "route"):
        return model.route()
    return "plain"


def tag(route: str, kernels: dict) -> str:
    launched = ", ".join(f"{k} {n}" for k, n in kernels.items() if n)
    return f"[{route}; {launched or 'no kernel'}]"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_row(section: str, name: str, opts: str, data: dict, device, *,
            seed=None, run: int = 0, shape=None) -> dict:
    """Train and evaluate one configuration: its record (name, options,
    shape, route, kernel launches, seed, run, metrics, seconds)."""
    from mymedialite_tpu_torch.eval.ranking import evaluate_items
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models.registry import (
        create_item_recommender, create_rating_predictor,
    )
    train, test = data["train"], data["test"]
    create = create_item_recommender if section == "item" \
        else create_rating_predictor
    model = create(name, opts)
    if hasattr(model, "device"):
        model.device = str(device)
    if seed is not None:
        model.random_seed = seed
    if name == "SocialMF":
        model.user_relation = data["trust"]
    if section == "item":
        model.feedback = train
    else:
        model.ratings = train
    before = kernel_launches()
    _sync(device)
    t0 = time.perf_counter()
    model.train()
    _sync(device)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if section == "item":
        res = evaluate_items(model, test, train,
                             test_users=data.get("test_users"))
    else:
        res = evaluate_ratings(model, test)
    _sync(device)
    eval_s = time.perf_counter() - t0
    kernels = {k: n - before[k] for k, n in kernel_launches().items()}
    return dict(section=section, name=name, options=opts,
                shape=shape or [train.num_users, train.num_items, len(train),
                                len(test)],
                device=str(device), route=route_of(model),
                kernels={k: n for k, n in kernels.items() if n},
                seed=seed, run=run,
                metrics={k: float(v) for k, v in res.items()},
                result=str(res), train_s=train_s, eval_s=eval_s)


def result_line(rec: dict) -> str:
    seed = "" if rec["seed"] is None else f" seed {rec['seed']}"
    run = f" run {rec['run']}" if rec["run"] else ""
    return (f"{rec['name']:30s} {rec['result']}  train {rec['train_s']:6.1f}s "
            f"eval {rec['eval_s']:5.1f}s {tag(rec['route'], rec['kernels'])}"
            f"{seed}{run}")


def band_line(records: list) -> str:
    """Min, median and max of each metric over the seeds (each seed's
    first run), and the largest difference between runs of one seed."""
    first = [r for r in records if r["run"] == 0]
    metrics = BAND_METRICS["item" if records[0]["section"] == "item"
                           else "rating"]
    parts = []
    for m in metrics:
        vals = [r["metrics"][m] for r in first]
        parts.append(f"{m} {statistics.median(vals):.5f} "
                     f"[{min(vals):.5f}, {max(vals):.5f}]")
    gap = 0.0
    for r in records:
        base = next(f for f in first if f["seed"] == r["seed"])
        gap = max([gap] + [abs(r["metrics"][m] - base["metrics"][m])
                           for m in metrics])
    seeds = [r["seed"] for r in first]
    over = "1 run (no random_seed)" if seeds == [None] else \
        f"seeds {seeds[0]}-{seeds[-1]} ({len(seeds)})"
    runs = max(r["run"] for r in records) + 1
    train = statistics.median(r["train_s"] for r in records)
    return (f"  band over {over}: {'; '.join(parts)}; median train "
            f"{train:.2f}s; largest difference between {runs} runs of one "
            f"seed {gap:.3g}")


def run_rows(section, configs, data, device, args, out, *, shape=None):
    """Every configuration of a section over the seeds and runs: its
    lines printed, its records appended to ``out``."""
    from mymedialite_tpu_torch.models.registry import (
        create_item_recommender, create_rating_predictor,
    )
    create = create_item_recommender if section == "item" \
        else create_rating_predictor
    for name, opts in configs:
        default = getattr(create(name), "random_seed", None)
        seeds = [None] if default is None else \
            [default + k for k in range(args.seeds)]
        records = []
        for seed in seeds:
            for run in range(args.runs):
                rec = run_row(section, name, opts, data, device, seed=seed,
                              run=run, shape=shape)
                records.append(rec)
                print(result_line(rec), flush=True)
                if args.json:
                    with open(args.json, "a") as f:
                        f.write(json.dumps(rec) + "\n")
        if len(records) > 1:
            print(band_line(records), flush=True)
        out.extend(records)


def main(argv=None) -> list:
    """Run the driver; returns its records."""
    from mymedialite_tpu_torch.device import resolve_device
    p = argparse.ArgumentParser(prog="python -m mymedialite_tpu_torch.quality",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--small", action="store_true",
                   help="every shape scaled by 0.05")
    p.add_argument("--large", action="store_true",
                   help="add the tiled and blocked routes at the ML-25M "
                        "and Netflix shapes")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seeds", type=int, default=1)
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--json", default=None,
                   help="append one JSON record per (row, seed, run)")
    args = p.parse_args(argv)
    if args.seeds < 1 or args.runs < 1:
        p.error("--seeds and --runs take a count of at least 1")
    device = resolve_device(args.device)
    scale = 0.05 if args.small else 1.0
    if args.json:
        open(args.json, "w").close()
    records = []

    train, test, P_true = rating_data(scale, device)
    print(f"# rating data: {len(train)} train / {len(test)} test, "
          f"{train.num_users} users x {train.num_items} items", flush=True)
    run_rows("rating", RATING_CONFIGS,
             dict(train=train, test=test, trust=trust_graph(P_true)),
             device, args, records)

    ttrain, ttest = timed_data(scale, device)
    print(f"# timed rating data (per-item drift 1.0): {len(ttrain)} "
          f"train / {len(ttest)} test", flush=True)
    run_rows("time", TIME_AWARE_CONFIGS, dict(train=ttrain, test=ttest),
             device, args, records)

    ptrain, ptest = implicit_data(scale)
    print(f"# implicit data: {len(ptrain)} train / {len(ptest)} test",
          flush=True)
    run_rows("item", ITEM_CONFIGS, dict(train=ptrain, test=ptest), device,
             args, records)

    if args.large:
        from mymedialite_tpu_torch.data.synthetic import posonly_from_ratings
        for shape in LARGE_SHAPES:
            train, test = large_data(shape, scale, device)
            print(f"# {shape}-shaped data: {len(train)} train / {len(test)} "
                  f"test, {train.num_users} users x {train.num_items} items",
                  flush=True)
            ptrain, ptest = posonly_from_ratings(train), \
                posonly_from_ratings(test)
            users = ptest.all_users
            rng = np.random.default_rng(9)
            sample = np.sort(rng.choice(
                users, min(LARGE_EVAL_USERS, len(users)), replace=False))
            for section, at, name, opts in LARGE_CONFIGS:
                if at != shape:
                    continue
                data = dict(train=ptrain, test=ptest, test_users=sample) \
                    if section == "item" else dict(train=train, test=test)
                run_rows(section, [(name, opts)], data, device, args,
                         records, shape=[train.num_users, train.num_items,
                                         len(train), len(test)])
            del train, test, ptrain, ptest
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
