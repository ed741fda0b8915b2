"""Where the owner scatter's time goes: epoch kernels 1-5 timed on the
card for a tree and for copies of it with phase 2 cut.

    python3 exp_torch_scatter_split.py OUT ROOT [ROOT ...] [--split]

For each ROOT (this checkout, or a parent unpacked beside it) the script
times, at the Netflix shape scaled to 48,000 users x 17,770 items x 2M
draws (``synthetic_ratings(48_000, 17_770, 2_000_000, seed=1)``; chunks
of 640 on the resident schedule, as the full shape's, and about 128 on
the slab-tiled one with one-block slabs): one epoch of kernel 1
(BiasedMF, k=40), kernel 2 (the same data tiled), kernel 3 (BPRMF, k=40,
bitmask, plain and hinge), kernel 4 (the same events tiled with
one-block slabs, sub-bucketed keys, plain and hinge) and kernel 5
(SVDPlusPlus, k=20; S, R and Y steps apart), in microseconds a chunk or
a step (the best of three launches after a first), with a sha256 of the
tables after the last launch (each from the same inputs: equal digests
for two ROOTs show their kernels give the same tables bit for bit).
With ``--split`` it also writes under OUT two copies of the first ROOT's
package whose owner scatter (``csrc/owner_scatter.cuh``) returns right
after its first barrier ("no phase 2") or skips its sums ("no sums"),
and whose cluster sums (``csrc/cluster_scatter.cuh``) return at once,
and times those: they give wrong tables, and only their times are read.
Prints one line ``SPLIT {json}`` a tree. Run on the card: each tree
builds its kernels once.
"""
import json
import os
import shutil
import subprocess
import sys

TIMER = r'''
import hashlib, json, sys
root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np, torch
from mymedialite_tpu_torch.data.synthetic import (
    posonly_from_ratings, synthetic_ratings)
from mymedialite_tpu_torch.ops import (
    bpr_epoch as BE, bpr_plan as BP, plan as P, sgd_epoch as se,
    svdpp_epoch as SE, svdpp_plan as SP)
from mymedialite_tpu_torch.ops.svdpp import history_edges
assert se.__file__.startswith(root), se.__file__
dev = torch.device("cuda")
U, I = 48_000, 17_770
d = synthetic_ratings(U, I, 2_000_000, seed=1, device="cuda")
out = dict(label=label, card=torch.cuda.get_device_name(0))
rng = np.random.default_rng(0)


def digest(tables):
    h = hashlib.sha256()
    for t in tables:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def best_us(fn, n):
    """(the best us a chunk of three launches after a first, the sha256 of
    the tables the last launch gave): fn() runs one launch on fresh
    copies of its tables and returns them."""
    ms = []
    for _ in range(4):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        tables = fn()
        e.record()
        e.synchronize()
        ms.append(s.elapsed_time(e))
    return min(ms[1:]) * 1e3 / n, digest(tables)


def clones(*tables):
    return tuple(t.clone() for t in tables)


for sched in ("resident", "tiled"):
    if sched == "resident":
        plan = P.prepare_mxu_data(d.users, d.items, d.values, U, I,
                                  user_block=512, item_block=1024, chunk=640,
                                  shuffle_seed=1, device=dev)
        fn, kw = se.sgd_epoch, {}
    else:
        plan = P.prepare_mxu_tiled(d.users, d.items, d.values, U, I,
                                   user_block=512, item_block=1024,
                                   chunk=None, slab_blocks=1, shuffle_seed=1,
                                   device=dev)
        fn, kw = se.sgd_epoch_tiled, dict(slab_blocks=plan.slab_blocks)
    W, H = P.extend_tables_mxu(
        plan, 0.1 * rng.standard_normal((U, 40)),
        0.1 * rng.standard_normal((I, 40)), 0.1 * rng.standard_normal(U),
        0.1 * rng.standard_normal(I))
    rates = P.mxu_column_rates(40, W.shape[1], 0.01, 0.015, 0.015, 1.0, 0.01,
                               True, True, True, device=dev)
    order = plan.epoch_order(3)
    us, sha = best_us(
        lambda: fn(*clones(W, H), plan.packed, order, (0.6, 1.0, 4.0),
                   rates, user_block=plan.user_block,
                   item_block=plan.item_block, loss=0, biased=True, **kw),
        plan.num_chunks)
    out["mf_" + sched] = dict(chunks=plan.num_chunks, C=plan.chunk, us=us,
                              sha256=sha)
plan, state, meta = BP.prepare_bpr_mxu(posonly_from_ratings(d),
                                       uniform_user=True, shuffle_seed=1,
                                       bitmask=True, device=dev)
nof = torch.from_numpy(plan.new_of_old.astype(np.int64)).to(dev)
W, H = BP.bpr_tables_to_mxu(*(torch.from_numpy(
    (0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)
    for s in ((U, 40), (I, 40), (I,))), nof, u_pad=plan.u_pad,
    i_pad=plan.i_pad, fe=P.fused_width(40))
rates = BP.bpr_mxu_column_rates(40, W.shape[1], 0.05, 0.0025, 0.0025,
                                0.00025, 0.0, True, device=dev)
order = plan.epoch_order(3)
neg_plan = BP.epoch_negative_plan(plan, state["nvalid"],
                                  order[0].cpu().numpy(), meta[3], 4)
gen = torch.Generator(device=dev).manual_seed(3)
bits = torch.randint(0, 2 ** 31, (plan.num_chunks, meta[2], plan.chunk),
                     dtype=torch.int32, generator=gen, device=dev)
for sm in (False, True):
    us, sha = best_us(
        lambda: BE.bpr_epoch(
            *clones(W, H), plan.packed, state["keys_tbl"],
            state["cdf_tbl"], bits, order, *neg_plan, rates,
            user_block=plan.user_block, item_block=plan.item_block,
            soft_margin=sm, bitmask_tbl=state["bitmask_tbl"])[:2],
        plan.num_chunks)
    out["bpr" + ("_hinge" if sm else "")] = dict(
        chunks=plan.num_chunks, C=plan.chunk, us=us, sha256=sha)
tplan, tstate, tmeta = BP.prepare_bpr_mxu(
    posonly_from_ratings(d), uniform_user=True, shuffle_seed=1, chunk=None,
    kcap=128, subkeys=True, ksub_cap=256, bitmask=False, chunk_overhead=256,
    device=dev)
B, S_, slab_items = BP.bpr_tiled_plan(tplan, tstate["nvalid"], slab_blocks=1)
torder = BP.bpr_tiled_epoch_order(tplan, tstate["nvalid"], slab_items,
                                  slab_blocks=B, num_slabs=S_,
                                  num_items=tmeta[3], seed=3)
nof = torch.from_numpy(tplan.new_of_old.astype(np.int64)).to(dev)
tW, tH = BP.bpr_tables_to_mxu(*(torch.from_numpy(
    (0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)
    for s in ((U, 40), (I, 40), (I,))), nof, u_pad=tplan.u_pad,
    i_pad=tplan.i_pad, fe=P.fused_width(40))
tbits = torch.randint(0, 2 ** 31, (tplan.num_chunks, tmeta[2], tplan.chunk),
                      dtype=torch.int32, generator=gen, device=dev)
for sm in (False, True):
    us, sha = best_us(
        lambda: BE.bpr_epoch_tiled(
            *clones(tW, tH), tplan.packed, tstate["subkeys_tbl"],
            tstate["cdf_tbl"], tbits, torder, rates, slab_blocks=B,
            user_block=tplan.user_block, item_block=tplan.item_block,
            soft_margin=sm, subkeys=True)[:2],
        tplan.num_chunks)
    out["bpr_tiled" + ("_hinge" if sm else "")] = dict(
        chunks=tplan.num_chunks, C=tplan.chunk, us=us, sha256=sha)
hu, hi = history_edges(d.users, d.items, I)
sp = SP.prepare_svdpp_mxu(d.users, d.items, d.values, hu, hi, U, I,
                          shuffle_seed=4, device=dev)
f = 20
fe = SP.svdpp_fe(f)
nof = torch.from_numpy(sp.new_of_old.astype(np.int64)).to(dev)
p, bu, q, bi, y = (torch.from_numpy(
    (0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)
    for s in ((U, f), (U,), (I, f), (I,), (I, f)))
tabs = SP.svdpp_tables_to_mxu(p, bu, sp.inv_sqrt, q, bi, y, nof,
                              u_pad=sp.u_pad, i_pad=sp.i_pad, fe=fe)
rates = SP.svdpp_mxu_rates(f, fe, 0.003, 0.7, 0.015, 0.33, 0.015, use_p=True,
                           update_user=True, update_item=True, device=dev)
ph = sp.schedule[0]
for name, sel in (("all", None), ("S", 0), ("R", 1), ("Y", 2)):
    sched = sp.schedule if sel is None else \
        tuple(t[ph == sel].contiguous() for t in sp.schedule)
    n = int(sched[0].numel())
    us, sha = best_us(
        lambda: SE.svdpp_epoch(
            *clones(*tabs), sp.packed, sched, (0.6, 1.0, 4.0),
            rates, user_block=sp.user_block, item_block=sp.item_block,
            num_factors=f, loss=0, sigmoid=True), n)
    out["svdpp_" + name] = dict(steps=n, us=us, sha256=sha)
print("SPLIT " + json.dumps(out), flush=True)
'''

CSRC = "mymedialite_tpu_torch/csrc"
# the cluster's phase 2 (cluster_sums) is cut in both copies
CLUSTER_CUT = ("cluster_scatter.cuh",
               "                                             int k1, const "
               "Pieces& pc) {\n",
               "                                             int k1, const "
               "Pieces& pc) {\n  return;\n")
CUTS = {
    "no phase 2": [("owner_scatter.cuh", "  const int nr0 = runs[0];\n",
                    "  return;\n  const int nr0 = runs[0];\n"),
                   CLUSTER_CUT],
    "no sums": [("owner_scatter.cuh",
                 "  auto sums = [&](int k0, int k1, const float4* base, "
                 "int from) {\n",
                 "  auto sums = [&](int k0, int k1, const float4* base, "
                 "int from) {\n    return;\n"),
                CLUSTER_CUT],
}


def cut_copy(out, root, name, edits):
    """A copy of ROOT's package under OUT with the headers edited."""
    dst = os.path.join(out, name.replace(" ", "_"))
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(os.path.join(root, "mymedialite_tpu_torch"),
                    os.path.join(dst, "mymedialite_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for header, old, new in edits:
        path = os.path.join(dst, CSRC, header)
        if not os.path.exists(path):       # a tree before the cluster walks
            continue
        with open(path) as f:
            text = f.read()
        assert text.count(old) == 1, (name, header)
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def main(argv):
    split = "--split" in argv
    argv = [a for a in argv if a != "--split"]
    out, roots = os.path.abspath(argv[0]), [os.path.abspath(r)
                                            for r in argv[1:]]
    os.makedirs(out, exist_ok=True)
    timer = os.path.join(out, "timer.py")
    with open(timer, "w") as f:
        f.write(TIMER)
    trees = [(r, os.path.basename(r) or r) for r in roots]
    if split:
        trees += [(cut_copy(out, roots[0], name, edit), name)
                  for name, edit in CUTS.items()]
    for root, label in trees:
        res = subprocess.run([sys.executable, timer, root, label],
                             capture_output=True, text=True)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("SPLIT ")]
        failed = dict(label=label, error=res.stderr[-2000:])
        print(lines[-1] if lines else "SPLIT " + json.dumps(failed),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
