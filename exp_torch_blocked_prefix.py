"""Group by group, how far float32 runs of the blocked MF epoch
(``ops/sgd.py sgd_epoch_blocked``) part from a float64 run of the same
function from the same tables, on the card and on the CPU.

Run on a machine with one CUDA card, from the repository root:

    python3 exp_torch_blocked_prefix.py [--cells netflix-freq,big-catalog]
        [--batches 131072,16384] [--groups 0] [--trained-groups 8]
        [--out FILE]

Cells, as ``chip_smoke.py``'s blocked-MF phases: BiasedMatrixFactorization
(k=40) on the Netflix shape with frequency regularization
(``synthetic_ratings(480_000, 17_770, 20_000_000, seed=1)``) and without
it on the big catalog (``synthetic_ratings(500_000, 2_200_000,
10_000_000, seed=7)``), each split 80/20 (seed 2). The big catalog runs
at the first batch size only. For each cell and batch size, two starting
states: the init tables (epoch 1) and the tables after 3 epochs on the
card (epoch 4). From each, the first ``--groups`` user groups (0: all;
``--trained-groups`` from the trained tables) run one group at a time
with the model's batch orders, four ways: on the card (float32), on the
CPU in float32, on the CPU in float64, and on the CPU in float64 from
the tables moved by 1e-7 N(0, 1) where they are nonzero (what the
function itself makes of a difference of float32's size). After each
group it prints each run's distance from the float64 run (the largest
|.| over W and H), where the CPU float32 run's largest difference sits
(table, column, row and that row's rating count) and the largest |item
bias| of the float64 run; then one JSON line, also written to ``--out``
when it is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

CELLS = {
    "netflix-freq": (dict(num_users=480_000, num_items=17_770,
                          num_ratings=20_000_000, seed=1),
                     "frequency_regularization=true"),
    "big-catalog": (dict(num_users=500_000, num_items=2_200_000,
                         num_ratings=10_000_000, seed=7), ""),
}
EPOCHS_BEFORE = 3


def log(msg):
    print(msg, flush=True)


def walk(model, train, groups: int):
    """The first ``groups`` groups (0: all) of the model's next blocked
    epoch from its current tables, four ways; one record per group."""
    from mymedialite_tpu_torch.ops import sgd
    data, meta, freq = model._blocked
    f = model.num_factors
    orders = model._batch_orders(meta["ngroups"],
                                 meta["l_pad"] // meta["batch"])
    args = (f, model.current_learnrate, model.reg_u, model.reg_i,
            model.bias_learn_rate, model.bias_reg, True, True, True)
    hp = (model.global_bias, model.min_rating, model._rating_range())
    host_data = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                 for k, v in data.items()}
    W0, H0 = model._W_ext, model._H_ext
    gen = torch.Generator().manual_seed(5)

    def host(dtype, moved=False):
        t = [x.detach().to("cpu", dtype).clone() for x in (W0, H0)]
        if moved:
            t = [x + 1e-7 * torch.randn(x.shape, generator=gen,
                                        dtype=dtype) * (x != 0) for x in t]
        fr = None if freq is None else tuple(x.to("cpu", dtype) for x in freq)
        return dict(W=t[0], H=t[1], data=host_data, freq=fr,
                    rates=sgd.column_rates(*args))
    runs = {"card": dict(W=W0.clone(), H=H0.clone(), data=data, freq=freq,
                         rates=sgd.column_rates(*args, device=W0.device)),
            "cpu32": host(torch.float32), "cpu64": host(torch.float64),
            "cpu64_moved": host(torch.float64, moved=True)}
    count_u = np.asarray(train.count_by_user)
    count_i = np.asarray(train.count_by_item)
    n = meta["ngroups"] if groups <= 0 else min(groups, meta["ngroups"])
    records = []
    for g in range(n):
        t0 = time.perf_counter()
        for r in runs.values():
            sgd.sgd_epoch_blocked(r["W"], r["H"], r["data"], orders, hp,
                                  r["rates"], r["freq"], meta=meta,
                                  loss=model.loss_id, biased=True,
                                  groups=[g])
        torch.cuda.synchronize()
        ref = runs["cpu64"]
        rec = dict(group=g, seconds=time.perf_counter() - t0)
        for name in ("card", "cpu32", "cpu64_moved"):
            rec[name] = max(
                (runs[name][k].double().cpu() - ref[k]).abs().max().item()
                for k in ("W", "H"))
        # where the CPU float32 run's largest difference sits
        best = None
        for k in ("W", "H"):
            d = (runs["cpu32"][k].double() - ref[k]).abs()
            at = int(d.argmax())
            row, col = divmod(at, d.shape[1])
            if best is None or d.flatten()[at] > best[0]:
                cnt = (count_i[row] if k == "H" else
                       (count_u[row] if row < len(count_u) else 0))
                column = ("bias" if (k, col) in (("W", f), ("H", f + 1))
                          else "one" if col in (f, f + 1) else "factor")
                best = (float(d.flatten()[at]), k, column, row, int(cnt))
        rec["at"] = dict(table=best[1], column=best[2], row=best[3],
                         ratings=best[4])
        rec["max_item_bias"] = ref["H"][:, f + 1].abs().max().item()
        rec["max_user_bias"] = ref["W"][:, f].abs().max().item()
        log(f"  group {g}: card {rec['card']:.3e}, cpu float32 "
            f"{rec['cpu32']:.3e}, cpu float64 moved 1e-7 "
            f"{rec['cpu64_moved']:.3e} from cpu float64; cpu float32's "
            f"largest difference at {best[1]}[{best[3]}] {best[2]} "
            f"({best[4]} ratings); max |item bias| "
            f"{rec['max_item_bias']:.4g}, |user bias| "
            f"{rec['max_user_bias']:.4g} ({rec['seconds']:.1f} s)")
        records.append(rec)
    return records


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="netflix-freq,big-catalog")
    ap.add_argument("--batches", default="131072,16384")
    ap.add_argument("--groups", type=int, default=0)
    ap.add_argument("--trained-groups", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("exp_torch_blocked_prefix: no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    batches = [int(b) for b in args.batches.split(",")]
    out = dict(card=card, cells={})
    for cell in args.cells.split(","):
        shape, opts = CELLS[cell]
        train, _ = split_ratings(synthetic_ratings(**shape), 0.2, seed=2)
        for batch in (batches if cell == "netflix-freq" else batches[:1]):
            model = create_rating_predictor(
                "BiasedMatrixFactorization",
                f"num_factors=40 batch_size={batch} {opts} device=cuda")
            model.ratings = train
            model.init_model()
            meta = model._blocked[1]
            log(f"{cell}, batch {meta['batch']}: {meta['ngroups']} groups "
                f"of {meta['group_users']} users; epoch 1 from the init "
                "tables")
            first = walk(model, train, args.groups)
            model.init_model()
            for _ in range(EPOCHS_BEFORE):
                model.iterate()
            log(f"{cell}, batch {meta['batch']}: epoch {EPOCHS_BEFORE + 1} "
                f"from the tables after {EPOCHS_BEFORE} epochs on the card")
            trained = walk(model, train, args.trained_groups)
            out["cells"][f"{cell}/{meta['batch']}"] = dict(
                init=first, trained=trained)
            del model
            torch.cuda.empty_cache()
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    log(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
