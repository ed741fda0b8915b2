"""The blocked MF epoch, timed, and two runs of one seed compared, for
the tree at ROOT (this checkout, or a parent's unpacked beside it).

    python3 exp_torch_blocked_repeat.py ROOT LABEL

On the card: BiasedMatrixFactorization (k=40, 3 epochs) on the blocked
epoch at the Netflix shape with frequency regularization and at the big
catalog (``synthetic_ratings(500_000, 2_200_000, 10_000_000, seed=7)``),
each split 80/20 and trained twice from the same seed (the second run on
the first's host layout); each epoch timed with CUDA events. Prints one
line ``PROBE {json}``: per shape the epochs' ms, the train seconds, the
RMSEs, whether the tables are equal bit for bit and their largest gap.
To compare two trees, run them in turns in one call (parent, change,
change, parent).
"""
import json
import sys
import time

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import torch  # noqa: E402

from mymedialite_tpu_torch.data.synthetic import (  # noqa: E402
    split_ratings, synthetic_ratings)
from mymedialite_tpu_torch.eval.rating import evaluate_ratings  # noqa: E402
from mymedialite_tpu_torch.models.registry import (  # noqa: E402
    create_rating_predictor)
from mymedialite_tpu_torch.ops import sgd  # noqa: E402

assert sgd.__file__.startswith(root), sgd.__file__
out = dict(label=label, root=root)
for shape, kw, opts in (
        ("netflix", dict(num_users=480_000, num_items=17_770,
                         num_ratings=20_000_000, seed=1),
         "frequency_regularization=true"),
        ("big", dict(num_users=500_000, num_items=2_200_000,
                     num_ratings=10_000_000, seed=7), "")):
    data = synthetic_ratings(**kw, device="cuda")
    train, test = split_ratings(data, 0.2, seed=2)
    runs, layout = [], None
    real_prep, real_epoch = sgd.prepare_blocked_data, sgd.sgd_epoch_blocked
    for run in range(2):
        ms = []

        def epoch(*a, **k):
            s, e = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            s.record()
            r = real_epoch(*a, **k)
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
            return r
        sgd.sgd_epoch_blocked = epoch
        if layout is not None:
            sgd.prepare_blocked_data = lambda *a, **k: layout
        m = create_rating_predictor(
            "BiasedMatrixFactorization",
            f"num_factors=40 num_iter=3 {opts} device=cuda")
        m.ratings = train
        t0 = time.perf_counter()
        m.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        sgd.sgd_epoch_blocked, sgd.prepare_blocked_data = real_epoch, \
            real_prep
        layout = m._blocked[:2]
        res = evaluate_ratings(m, test, train)
        runs.append(dict(ms=ms, train_s=train_s, rmse=res["RMSE"],
                         W=m._W_ext.clone(), H=m._H_ext.clone()))
    a, b = runs
    out[shape] = dict(
        epoch_ms=[r["ms"] for r in runs], train_s=[r["train_s"] for r in runs],
        rmse=[r["rmse"] for r in runs],
        tables_equal=bool(torch.equal(a["W"], b["W"])
                          and torch.equal(a["H"], b["H"])),
        max_gap=max((a["W"] - b["W"]).abs().max().item(),
                    (a["H"] - b["H"]).abs().max().item()))
    del data, train, test, runs, a, b, m, layout
    torch.cuda.empty_cache()
print("PROBE " + json.dumps(out), flush=True)
