"""Epoch kernels 1 and 2 on the card at every cluster size N, swept at
the main path's shapes.

    python3 exp_torch_sgd_cluster.py [--cases a,b] [--sizes 1,2,4,8,16]

For each case (the shape as ``chip_smoke.py`` and
``exp_torch_scatter_split.py`` build it, tables drawn from N(0, 0.1) with
numpy seed 0, the rates of BiasedMatrixFactorization's defaults) and
each N, one epoch of BiasedMF (k=40) through the wrapper with
``ops/sgd_epoch.py cluster_size`` replaced by N: the best of three
launches after a first, in microseconds a chunk, and the sha256 of the
tables after the last launch. Every N must give the same digest (the
kernel's tables do not depend on its cluster); the script exits 1 where
they differ. The N the wrapper picks itself is marked. Cases:

- ``netflix_scaled``: ``synthetic_ratings(48_000, 17_770, 2_000_000,
  seed=1)``, resident, chunks of 640 (kernel 1);
- ``netflix_scaled_256``, ``netflix_scaled_384``: the same, chunks of
  256 and 384 (sizes the histogram may pick);
- ``netflix_scaled_tiled``: the same ratings tiled with one-block slabs,
  the histogram's chunk (kernel 2);
- ``netflix``: ``(480_000, 17_770, 20_000_000, seed=1)``, resident, 640;
- ``ml25m``: ``(162_541, 62_423, 25_000_095, seed=25)``, tiled as the
  model tiles it (``default_slab_blocks(40)`` blocks a slab).

Prints the card and one line ``SWEEP {json}`` a case. Run on the card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

CASES = {
    "netflix_scaled": ((48_000, 17_770, 2_000_000, 1), False),
    "netflix_scaled_256": ((48_000, 17_770, 2_000_000, 1), False),
    "netflix_scaled_384": ((48_000, 17_770, 2_000_000, 1), False),
    "netflix_scaled_tiled": ((48_000, 17_770, 2_000_000, 1), True),
    "netflix": ((480_000, 17_770, 20_000_000, 1), False),
    "ml25m": ((162_541, 62_423, 25_000_095, 25), True),
}


def digest(tables):
    h = hashlib.sha256()
    for t in tables:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def case_inputs(name):
    from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
    from mymedialite_tpu_torch.ops import plan as P
    (U, I, n, seed), tiled = CASES[name]
    dev = torch.device("cuda")
    d = synthetic_ratings(U, I, n, seed=seed, device="cuda")
    if tiled:
        slabs = 1 if name.startswith("netflix") else P.default_slab_blocks(40)
        plan = P.prepare_mxu_tiled(d.users, d.items, d.values, U, I,
                                   user_block=512, item_block=1024,
                                   chunk=None, slab_blocks=slabs,
                                   shuffle_seed=1, device=dev)
    else:
        chunk = int(name.split("_")[-1]) if name[-1].isdigit() else 640
        plan = P.prepare_mxu_data(d.users, d.items, d.values, U, I,
                                  user_block=512, item_block=1024,
                                  chunk=chunk, shuffle_seed=1, device=dev)
    rng = np.random.default_rng(0)
    W, H = P.extend_tables_mxu(
        plan, 0.1 * rng.standard_normal((U, 40)),
        0.1 * rng.standard_normal((I, 40)), 0.1 * rng.standard_normal(U),
        0.1 * rng.standard_normal(I))
    rates = P.mxu_column_rates(40, W.shape[1], 0.01, 0.015, 0.015, 1.0, 0.01,
                               True, True, True, device=dev)
    return plan, W, H, rates, plan.epoch_order(3), tiled


def sweep(name, sizes):
    from mymedialite_tpu_torch.ops import sgd_epoch as se
    plan, W, H, rates, order, tiled = case_inputs(name)
    fe, C = W.shape[1], plan.chunk
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=0, biased=True)
    fn = se.sgd_epoch_tiled if tiled else se.sgd_epoch
    if tiled:
        kw["slab_blocks"] = plan.slab_blocks
    own = se.cluster_size(C)
    real = se.cluster_size
    rows = []
    for n in sizes:
        se.cluster_size = lambda c_, n=n: n
        try:
            ms, tables = [], None
            for _ in range(4):
                Wk, Hk = W.clone(), H.clone()
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                fn(Wk, Hk, plan.packed, order, (0.6, 1.0, 4.0), rates, **kw)
                e.record()
                e.synchronize()
                ms.append(s.elapsed_time(e))
                tables = (Wk, Hk)
            rows.append(dict(cluster=n, own=n == own,
                             us=min(ms[1:]) * 1e3 / plan.num_chunks,
                             ms=min(ms[1:]), sha256=digest(tables)))
        except RuntimeError as err:
            rows.append(dict(cluster=n, error=str(err)))
        finally:
            se.cluster_size = real
    return dict(case=name, chunks=plan.num_chunks, C=C, fe=fe, rows=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--sizes", default="1,2,4,8,16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("exp_torch_sgd_cluster: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sizes = [int(x) for x in args.sizes.split(",")]
    ok = True
    for name in args.cases.split(","):
        res = sweep(name, sizes)
        shas = {r["sha256"] for r in res["rows"] if "sha256" in r}
        res["equal"] = len(shas) == 1
        ok &= res["equal"]
        print("SWEEP " + json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
