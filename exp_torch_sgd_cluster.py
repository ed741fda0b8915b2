"""Epoch kernels 1-5 on the card at every cluster size N, swept at the
main path's shapes.

    python3 exp_torch_sgd_cluster.py [--cases a,b] [--sizes 1,2,4,8,16]

For each case (the shape as ``chip_smoke.py`` and
``exp_torch_scatter_split.py`` build it, tables drawn from N(0, 0.1) with
numpy seed 0, the rates of the models' defaults) and each N, one epoch
through the wrapper with its module's ``cluster_size``
(``ops/cluster.py``) replaced by N: the best of three launches after a
first, in microseconds a chunk or a step, and the sha256 of the tables
after the last launch. Every N must give the same digest (the kernels'
tables do not depend on their cluster); the script exits 1 where they
differ. The N the wrapper picks itself is marked; a tree whose kernel
takes no cluster size (an older commit, with the script copied into its
root) runs its own launch. ``--cases`` defaults to the scaled cases.
Cases of kernels 1-2, BiasedMF (k=40):

- ``netflix_scaled``: ``synthetic_ratings(48_000, 17_770, 2_000_000,
  seed=1)``, resident, chunks of 640 (kernel 1);
- ``netflix_scaled_256``, ``netflix_scaled_384``: the same, chunks of
  256 and 384 (sizes the histogram may pick);
- ``netflix_scaled_tiled``: the same ratings tiled with one-block slabs,
  the histogram's chunk (kernel 2);
- ``netflix``: ``(480_000, 17_770, 20_000_000, seed=1)``, resident, 640;
- ``ml25m``: ``(162_541, 62_423, 25_000_095, seed=25)``, tiled as the
  model tiles it (``default_slab_blocks(40)`` blocks a slab).

Cases of kernels 3-4, BPRMF (k=40) on the rated pairs, bits from a
``torch.Generator`` seeded 3: ``bpr_scaled`` (the scaled ratings,
resident, chunks of 640, bitmask membership), ``bpr_scaled_tiled`` (the
same tiled with one-block slabs, sub-bucketed keys), ``bpr_netflix``
(the Netflix shape, resident), ``bpr_ml25m`` (the MovieLens-25M shape
tiled as BPRMF tiles it). Cases of kernel 5, SVDPlusPlus (chunks of 512,
the rated pairs as the histories, sigmoid RMSE): ``svdpp_scaled_k20``,
``svdpp_scaled_k50``, ``svdpp_scaled_k100`` (the scaled ratings at 20,
50 and 100 factors) and ``svdpp_netflix`` (the Netflix shape, k=20).
A case of kernels 3-5 with the suffix ``_c<C>`` (``bpr_scaled_c256``,
``bpr_scaled_tiled_c128``, ``svdpp_scaled_k20_c192``) runs its plan at
chunks of C slots: the sizes where ``ops/cluster.py``'s threshold lies.

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

SCALED = (48_000, 17_770, 2_000_000, 1)
NETFLIX = (480_000, 17_770, 20_000_000, 1)
ML25M = (162_541, 62_423, 25_000_095, 25)
CASES = {
    "netflix_scaled": (SCALED, False),
    "netflix_scaled_256": (SCALED, False),
    "netflix_scaled_384": (SCALED, False),
    "netflix_scaled_tiled": (SCALED, True),
    "netflix": (NETFLIX, False),
    "ml25m": (ML25M, True),
    "bpr_scaled": (SCALED, False),
    "bpr_scaled_tiled": (SCALED, True),
    "bpr_netflix": (NETFLIX, False),
    "bpr_ml25m": (ML25M, True),
    "svdpp_scaled_k20": (SCALED, False),
    "svdpp_scaled_k50": (SCALED, False),
    "svdpp_scaled_k100": (SCALED, False),
    "svdpp_netflix": (NETFLIX, False),
}


def case_chunk(name):
    """(the case without its ``_c<C>`` suffix, C or None)."""
    base, sep, c = name.rpartition("_c")
    return (base, int(c)) if sep and c.isdigit() else (name, None)


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


def bpr_case(name):
    """(module, run, steps, C, fe) of a BPR case: run() launches one
    epoch on fresh copies of its tables and returns them."""
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, synthetic_ratings)
    from mymedialite_tpu_torch.ops import bpr_epoch as BE
    from mymedialite_tpu_torch.ops import bpr_plan as BP
    from mymedialite_tpu_torch.ops import plan as P
    name, chunk = case_chunk(name)
    (U, I, n, seed), tiled = CASES[name]
    dev = torch.device("cuda")
    fb = posonly_from_ratings(synthetic_ratings(U, I, n, seed=seed,
                                                device="cuda"))
    rng = np.random.default_rng(0)
    tabs = [torch.from_numpy((0.1 * rng.standard_normal(s))
                             .astype(np.float32)).to(dev)
            for s in ((U, 40), (I, 40), (I,))]
    gen = torch.Generator(device=dev).manual_seed(3)
    if tiled:
        plan, state, meta = BP.prepare_bpr_mxu(
            fb, uniform_user=True, shuffle_seed=1, chunk=chunk, kcap=128,
            subkeys=True, ksub_cap=256, bitmask=False, chunk_overhead=256,
            device=dev)
        slabs = 1 if name == "bpr_scaled_tiled" else \
            max(P.default_slab_blocks(40) // 2, 1)
        B, S_, slab_items = BP.bpr_tiled_plan(plan, state["nvalid"],
                                              slab_blocks=slabs)
        order = BP.bpr_tiled_epoch_order(plan, state["nvalid"], slab_items,
                                         slab_blocks=B, num_slabs=S_,
                                         num_items=meta[3], seed=3)
        args = (state["subkeys_tbl"], state["cdf_tbl"])
        kw = dict(slab_blocks=B, subkeys=True)
        fn = BE.bpr_epoch_tiled
    else:
        plan, state, meta = BP.prepare_bpr_mxu(
            fb, uniform_user=True, shuffle_seed=1, bitmask=True,
            chunk=chunk or 640, device=dev)
        order = plan.epoch_order(3)
        neg_plan = BP.epoch_negative_plan(plan, state["nvalid"],
                                          order[0].cpu().numpy(), meta[3], 4)
        args = (state["keys_tbl"], state["cdf_tbl"])
        kw = dict(bitmask_tbl=state["bitmask_tbl"])
        fn = BE.bpr_epoch
    bits = torch.randint(0, 2 ** 31, (plan.num_chunks, meta[2], plan.chunk),
                         dtype=torch.int32, generator=gen, device=dev)
    nof = torch.from_numpy(plan.new_of_old.astype(np.int64)).to(dev)
    W, H = BP.bpr_tables_to_mxu(*tabs, nof, u_pad=plan.u_pad,
                                i_pad=plan.i_pad, fe=P.fused_width(40))
    rates = BP.bpr_mxu_column_rates(40, W.shape[1], 0.05, 0.0025, 0.0025,
                                    0.00025, 0.0, True, device=dev)
    kw.update(user_block=plan.user_block, item_block=plan.item_block)

    def run():
        Wk, Hk = W.clone(), H.clone()
        if tiled:
            fn(Wk, Hk, plan.packed, *args, bits, order, rates, **kw)
        else:
            fn(Wk, Hk, plan.packed, *args, bits, order, *neg_plan, rates,
               **kw)
        return Wk, Hk
    return BE, run, plan.num_chunks, plan.chunk, W.shape[1]


def svdpp_case(name):
    """(module, run, steps, C, fe) of an SVD++ case."""
    from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
    from mymedialite_tpu_torch.ops import svdpp_epoch as SE
    from mymedialite_tpu_torch.ops import svdpp_plan as SP
    from mymedialite_tpu_torch.ops.svdpp import history_edges
    name, chunk = case_chunk(name)
    (U, I, n, seed), _ = CASES[name]
    f = int(name.rsplit("_k", 1)[1]) if "_k" in name else 20
    dev = torch.device("cuda")
    d = synthetic_ratings(U, I, n, seed=seed, device="cuda")
    hu, hi = history_edges(d.users, d.items, I)
    sp = SP.prepare_svdpp_mxu(d.users, d.items, d.values, hu, hi, U, I,
                              shuffle_seed=4, chunk=chunk or 512,
                              device=dev)
    fe = SP.svdpp_fe(f)
    rng = np.random.default_rng(0)
    nof = torch.from_numpy(sp.new_of_old.astype(np.int64)).to(dev)
    p, bu, q, bi, y = (torch.from_numpy(
        (0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)
        for s in ((U, f), (U,), (I, f), (I,), (I, f)))
    tabs = SP.svdpp_tables_to_mxu(p, bu, sp.inv_sqrt, q, bi, y, nof,
                                  u_pad=sp.u_pad, i_pad=sp.i_pad, fe=fe)
    rates = SP.svdpp_mxu_rates(f, fe, 0.003, 0.7, 0.015, 0.33, 0.015,
                               use_p=True, update_user=True,
                               update_item=True, device=dev)

    def run():
        out = tuple(t.clone() for t in tabs)
        SE.svdpp_epoch(*out, sp.packed, sp.schedule, (0.6, 1.0, 4.0), rates,
                       user_block=sp.user_block, item_block=sp.item_block,
                       num_factors=f, loss=0, sigmoid=True)
        return out
    return SE, run, sp.num_steps, sp.chunk, fe


def sgd_case(name):
    """(module, run, steps, C, fe) of a BiasedMF case."""
    from mymedialite_tpu_torch.ops import sgd_epoch as se
    plan, W, H, rates, order, tiled = case_inputs(name)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=0, biased=True)
    fn = se.sgd_epoch_tiled if tiled else se.sgd_epoch
    if tiled:
        kw["slab_blocks"] = plan.slab_blocks

    def run():
        Wk, Hk = W.clone(), H.clone()
        fn(Wk, Hk, plan.packed, order, (0.6, 1.0, 4.0), rates, **kw)
        return Wk, Hk
    return se, run, plan.num_chunks, plan.chunk, W.shape[1]


def sweep(name, sizes):
    build = (bpr_case if name.startswith("bpr") else
             svdpp_case if name.startswith("svdpp") else sgd_case)
    module, run, steps, C, fe = build(name)
    # a tree whose kernel has no cluster runs its one launch, once
    real = getattr(module, "cluster_size", None)
    own = real(C) if real else None
    rows = []
    for n in sizes if real else [None]:
        if real:
            module.cluster_size = lambda c_, n=n: n
        try:
            ms, tables = [], None
            for _ in range(4):
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                tables = run()
                e.record()
                e.synchronize()
                ms.append(s.elapsed_time(e))
            rows.append(dict(cluster=n, own=n == own,
                             us=min(ms[1:]) * 1e3 / steps,
                             ms=min(ms[1:]), sha256=digest(tables)))
        except RuntimeError as err:
            rows.append(dict(cluster=n, error=str(err)))
        finally:
            if real:
                module.cluster_size = real
    return dict(case=name, chunks=steps, C=C, fe=fe, rows=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(
        c for c in CASES if "netflix" not in c.split("_")[1:]
        and c not in ("netflix", "ml25m", "bpr_ml25m")))
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
