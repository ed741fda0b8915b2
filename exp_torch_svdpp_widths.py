"""SVD++'s kernel 5 at several factor counts, for trees: the accumulator
variant that the wrapper picks and one epoch's time.

    python3 exp_torch_svdpp_widths.py OUT ROOT [ROOT ...] [--small-stage]

For each ROOT (this checkout, or a parent unpacked beside it) the script
times, at the Netflix shape scaled as in ``exp_torch_scatter_split.py``
(``synthetic_ratings(48_000, 17_770, 2_000_000, seed=1)``, the models'
plan: user blocks of 512, chunks of 512), one epoch of
``svdpp_epoch`` (sigmoid, p updated) at 20, 50 and 100 factors: the
variant ("shared": the sums s, c and n read from a copy in shared
memory; "global": through L2), the best of three launches after a first
in ms and in microseconds a step, and a digest of the tables after one
epoch (the sum of their float32 bit patterns as integers, weighted by
position). With ``--small-stage`` it also times a copy of the last
ROOT's package under OUT whose ``MIN_STAGE_ENTRIES`` is 1, so that the
"shared" variant is picked wherever the copy of the sums fits beside a
one-entry stage of the owner scatter (up to 92 factors at this plan):
whether a shared copy with a small stage beats the global variant with a
large one. Both variants sum in one order, so the copy's digests must
equal the last ROOT's. Prints one line ``WIDTHS {json}`` a tree. Run on
the card: each tree builds its kernels once.
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
from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
from mymedialite_tpu_torch.ops import svdpp_epoch as SE, svdpp_plan as SP
from mymedialite_tpu_torch.ops.svdpp import history_edges
assert SE.__file__.startswith(root), SE.__file__
dev = torch.device("cuda")
U, I = 48_000, 17_770
d = synthetic_ratings(U, I, 2_000_000, seed=1, device="cuda")
hu, hi = history_edges(d.users, d.items, I)
sp = SP.prepare_svdpp_mxu(d.users, d.items, d.values, hu, hi, U, I,
                          shuffle_seed=4, device=dev)
nof = torch.from_numpy(sp.new_of_old.astype(np.int64)).to(dev)
n = int(sp.schedule[0].numel())
out = dict(label=label, card=torch.cuda.get_device_name(0), steps=n,
           user_block=sp.user_block, chunk=sp.chunk)


def digest(tables):
    total = 0
    for t in tables:
        b = t.contiguous().view(torch.int32).view(-1).long()
        w = torch.arange(b.numel(), device=b.device) % 1_000_003 + 1
        total += int((b * w).sum())
    return total


for f in (20, 50, 100):
    rng = np.random.default_rng(f)
    fe = SP.svdpp_fe(f)
    p, bu, q, bi, y = (torch.from_numpy(
        (0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)
        for s in ((U, f), (U,), (I, f), (I,), (I, f)))
    tabs = SP.svdpp_tables_to_mxu(p, bu, sp.inv_sqrt, q, bi, y, nof,
                                  u_pad=sp.u_pad, i_pad=sp.i_pad, fe=fe)
    rates = SP.svdpp_mxu_rates(f, fe, 0.003, 0.7, 0.015, 0.33, 0.015,
                               use_p=True, update_user=True,
                               update_item=True, device=dev)

    def epoch(tables):
        SE.svdpp_epoch(*tables, sp.packed, sp.schedule, (0.6, 1.0, 4.0),
                       rates, user_block=sp.user_block,
                       item_block=sp.item_block, num_factors=f, loss=0,
                       sigmoid=True)
        return tables

    first = epoch(tuple(t.clone() for t in tabs))
    torch.cuda.synchronize()
    ms = []
    for _ in range(4):
        tables = tuple(t.clone() for t in tabs)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        epoch(tables)
        e.record()
        e.synchronize()
        ms.append(s.elapsed_time(e))
    out[f"k{f}"] = dict(
        variant=SE.accumulator_variant(sp.user_block, f, sp.chunk, fe),
        ms=min(ms[1:]), us=min(ms[1:]) * 1e3 / n, digest=digest(first))
print("WIDTHS " + json.dumps(out), flush=True)
'''

EDIT = ("MIN_STAGE_ENTRIES = 512\n", "MIN_STAGE_ENTRIES = 1\n")


def small_stage_copy(out, root):
    """A copy of ROOT's package under OUT with MIN_STAGE_ENTRIES = 1."""
    dst = os.path.join(out, "small_stage")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(os.path.join(root, "mymedialite_tpu_torch"),
                    os.path.join(dst, "mymedialite_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = os.path.join(dst, "mymedialite_tpu_torch/ops/svdpp_epoch.py")
    with open(path) as f:
        text = f.read()
    assert text.count(EDIT[0]) == 1
    with open(path, "w") as f:
        f.write(text.replace(*EDIT))
    return dst


def main(argv):
    small = "--small-stage" in argv
    argv = [a for a in argv if a != "--small-stage"]
    out, roots = os.path.abspath(argv[0]), [os.path.abspath(r)
                                            for r in argv[1:]]
    os.makedirs(out, exist_ok=True)
    timer = os.path.join(out, "timer.py")
    with open(timer, "w") as f:
        f.write(TIMER)
    trees = [(r, os.path.basename(r) or r) for r in roots]
    if small:
        trees.append((small_stage_copy(out, roots[-1]), "small stage"))
    for root, label in trees:
        res = subprocess.run([sys.executable, timer, root, label],
                             capture_output=True, text=True)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("WIDTHS ")]
        failed = dict(label=label, error=res.stderr[-2000:])
        print(lines[-1] if lines else "WIDTHS " + json.dumps(failed),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
