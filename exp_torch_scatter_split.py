"""Where the owner scatter's time goes: epoch kernels 1, 2, 3 and 5
timed on the card for a tree and for copies of it with phase 2 cut.

    python3 exp_torch_scatter_split.py OUT ROOT [ROOT ...]

For each ROOT (this checkout, or a parent unpacked beside it) the script
times, at the Netflix shape scaled to 48,000 users x 17,770 items x 2M
draws (``synthetic_ratings(48_000, 17_770, 2_000_000, seed=1)``; chunks
of 640 on the resident schedule, as the full shape's, and about 128 on
the slab-tiled one with one-block slabs): one epoch of kernel 1
(BiasedMF, k=40), kernel 2 (the same data tiled), kernel 3 (BPRMF, k=40,
bitmask, plain and hinge) and kernel 5 (SVDPlusPlus, k=20; S, R and Y
steps apart), in microseconds a chunk or a step (the best of three
launches after a first). With ``--split`` it also writes under OUT two
copies of the first ROOT's package whose owner scatter
(``csrc/owner_scatter.cuh``) returns right after its first barrier
("no phase 2") or skips its sums ("no sums"), and times those: they give
wrong tables, and only their times are read. Prints one line ``SPLIT
{json}`` a tree. Run on the card: each tree builds its kernels once.
"""
import json
import os
import shutil
import subprocess
import sys

TIMER = r'''
import json, sys
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


def best_us(fn, n):
    ms = []
    for _ in range(4):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        ms.append(s.elapsed_time(e))
    return min(ms[1:]) * 1e3 / n


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
    out["mf_" + sched] = dict(chunks=plan.num_chunks, C=plan.chunk, us=best_us(
        lambda: fn(W.clone(), H.clone(), plan.packed, order, (0.6, 1.0, 4.0),
                   rates, user_block=plan.user_block,
                   item_block=plan.item_block, loss=0, biased=True, **kw),
        plan.num_chunks))
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
    out["bpr" + ("_hinge" if sm else "")] = dict(
        chunks=plan.num_chunks, C=plan.chunk, us=best_us(
            lambda: BE.bpr_epoch(
                W.clone(), H.clone(), plan.packed, state["keys_tbl"],
                state["cdf_tbl"], bits, order, *neg_plan, rates,
                user_block=plan.user_block, item_block=plan.item_block,
                soft_margin=sm, bitmask_tbl=state["bitmask_tbl"]),
            plan.num_chunks))
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
    out["svdpp_" + name] = dict(steps=n, us=best_us(
        lambda: SE.svdpp_epoch(
            *(t.clone() for t in tabs), sp.packed, sched, (0.6, 1.0, 4.0),
            rates, user_block=sp.user_block, item_block=sp.item_block,
            num_factors=f, loss=0, sigmoid=True), n))
print("SPLIT " + json.dumps(out), flush=True)
'''

HEADER = "mymedialite_tpu_torch/csrc/owner_scatter.cuh"
CUTS = {
    "no phase 2": ("  const int nr0 = runs[0];\n",
                   "  return;\n  const int nr0 = runs[0];\n"),
    "no sums": ("  auto sums = [&](int k0, int k1, const float4* base, int from) {\n",
                "  auto sums = [&](int k0, int k1, const float4* base, int from) {\n"
                "    return;\n"),
}


def cut_copy(out, root, name, edit):
    """A copy of ROOT's package under OUT with one edit of the header."""
    dst = os.path.join(out, name.replace(" ", "_"))
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(os.path.join(root, "mymedialite_tpu_torch"),
                    os.path.join(dst, "mymedialite_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = os.path.join(dst, HEADER)
    with open(path) as f:
        text = f.read()
    old, new = edit
    assert text.count(old) == 1, name
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
