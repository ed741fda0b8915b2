"""Where one epoch of the SVD++ and of the rating-SGD kernel spends its
time, on the card.

Run on a machine with one CUDA card, from the repository root:

    python3 exp_torch_epoch_split.py [--root DIR]

``--root`` names the repository root whose ``mymedialite_tpu_torch`` is
measured (default: this one), so that an older commit unpacked beside
this one is measured by the same script. On the Netflix-shaped ratings
of ``chip_smoke.py`` (the same generator, seed and split):

1. SVDPlusPlus (k=20, learn rate 0.003, transductive on the test pairs)
   trained one epoch through the registry; then its kernel over the
   whole schedule and over the schedule's S, R and Y steps alone
   (``chip_smoke.svdpp_phase_split``), from the trained tables: as the
   wrapper picks the variant, with the variant forced to "global" (the
   sums read through L2), and with the W, Q and Y learning rates set to
   0, which the kernel scatters nothing for ("no table scatter").
2. BiasedMatrixFactorization (k=40) trained one epoch through the
   registry, on the Netflix-shaped ratings (the resident schedule,
   kernel 1) and, unless ``--parts`` leaves it out, on the
   MovieLens-25M-shaped ratings of ``chip_smoke.py`` (the slab-tiled
   schedule, kernel 2); then one epoch of an instrumented build of
   ``csrc/sgd_epoch.cu`` (with ``csrc/owner_scatter.cuh`` inlined): thread
   0 of the first thread block reads ``clock64()`` after every barrier
   (``__syncthreads()``, ``cluster_arrive(ncta)``, ``cluster_wait(ncta)``;
   before and after ``cluster_barrier(ncta)``), before
   and after every wait for copies in flight (``cp_async_wait_all()``)
   and at the end of
   every pass of phase 1 (the first loop closed at four spaces' indent
   after the comment ``// phase 1: gather``), and adds the cycles since the mark before to this
   mark's counter. A mark's share is the share of the walk spent in the
   code that ends at it (at a barrier, with the wait there for the
   slowest warp); a pass mark counts the passes of thread 0's warp, so
   its count over the chunks is the rounds of phase-1 loads a chunk.
   The instrumented build lives only in this script's temporary
   directory; the wrapper's launch runs it by patching the loaded
   library for the call, with 2 KB less dynamic shared memory (the
   marks' counters take static shared memory). Then one epoch with every learning rate 0 ("no
   scatter": the kernel stores and sends no delta).

``--parts`` picks among ``svdpp``, ``mf`` and ``mf_tiled`` (default: all).
It prints the card, each part's ms and share, and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

import chip_smoke as smoke

MARKS = 20
PRELUDE = """
__device__ unsigned long long mml_seg[%d];
__device__ unsigned long long mml_hits[%d];
__shared__ unsigned long long mml_acc_[%d], mml_n_[%d], mml_last_;
#define MML_MARK(n)                                                    \\
  do {                                                                 \\
    if (threadIdx.x == 0 && blockIdx.x == 0) {                         \\
      const unsigned long long t_ = clock64();                        \\
      if (mml_last_) {                                                 \\
        mml_acc_[n] += t_ - mml_last_;                                 \\
        mml_n_[n] += 1;                                                \\
        mml_seg[n] = mml_acc_[n];                                      \\
        mml_hits[n] = mml_n_[n];                                       \\
      }                                                                \\
      mml_last_ = t_;                                                  \\
    }                                                                  \\
  } while (0)
""" % (MARKS, MARKS, MARKS, MARKS)
KERNEL_START = ("  if (threadIdx.x == 0) {\n"
                "    for (int q_ = 0; q_ < %d; ++q_) mml_acc_[q_] = mml_n_[q_] = 0;\n"
                "    mml_last_ = 0;\n"
                "  }\n" % MARKS)
READER = """
extern "C" int mml_seg_reset() {
  unsigned long long zero[%d] = {0};
  cudaError_t e = cudaMemcpyToSymbol(mml_seg, zero, sizeof(zero));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(mml_hits, zero, sizeof(zero));
}

extern "C" int mml_seg_read(unsigned long long* out, unsigned long long* hits) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyFromSymbol(out, mml_seg, sizeof(mml_seg));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(hits, mml_hits, sizeof(mml_hits));
}
""" % MARKS
# what a mark is placed beside: (pattern, replacement with {m} for a
# mark, or {a} and {b} for one before and one after)
BARRIER = re.compile(
    r"(__syncthreads\(\)|cluster_(barrier|arrive|wait)\(ncta\));")
WAIT = re.compile(r"cp_async_wait_all\(\);")
PASS_END = re.compile(r"(    // phase 1: gather.*?\n      }\n)(    }\n)", re.S)


def instrument(src: str, header: str):
    """The source, with ``header`` (owner_scatter.cuh) inlined in place of
    its include and a clock mark at every barrier, around every wait for
    copies in flight and at the end of every phase-1 pass; returns
    (source, a label for each mark)."""
    include = '#include "owner_scatter.cuh"\n'
    if src.count(include) != 1:
        raise ValueError("want the one include of owner_scatter.cuh")
    src = src.replace(include, header.replace("#pragma once\n", ""))
    head, inc, body = src.partition("#include <stdint.h>\n")
    if not inc:
        raise ValueError("no #include <stdint.h> to anchor the prelude")
    shared = "extern __shared__ __align__(16) unsigned char smem[];\n"
    if body.count(shared) != 1:
        raise ValueError("want exactly one kernel with dynamic shared memory")
    body = body.replace(shared, shared + KERNEL_START)
    labels = []

    def new_mark(where, label):
        n = len(labels)
        if n >= MARKS:
            raise ValueError(f"more than {MARKS} marks")
        before = body[:where].rstrip().splitlines()
        labels.append(label or " | ".join(s.strip() for s in before[-2:]))
        return n

    def barrier(m):
        if not m.group(0).startswith("cluster_barrier"):
            n = new_mark(m.start(), None)
            if m.group(0).startswith("cluster_"):
                labels[n] = f"{m.group(0)} after: {labels[n]}"
            return f"{m.group(0)} MML_MARK({n});"
        a = new_mark(m.start(), None)
        labels[a] = "before the cluster barrier after: " + labels[a]
        b = new_mark(m.start(), None)
        labels[b] = "the cluster barrier after: " + labels[b]
        return f"MML_MARK({a}); {m.group(0)} MML_MARK({b});"

    def wait(m):
        a = new_mark(m.start(), "before the wait for copies in flight "
                     "(the previous chunk's tail)")
        b = new_mark(m.start(), "the wait for copies in flight")
        return f"MML_MARK({a}); {m.group(0)} MML_MARK({b});"

    def pass_end(m):
        n = new_mark(m.start(), "a phase-1 pass of thread 0's warp")
        return f"{m.group(1)}      MML_MARK({n});\n{m.group(2)}"

    body = WAIT.sub(wait, body)
    body = PASS_END.sub(pass_end, body, count=1)
    body = BARRIER.sub(barrier, body)
    return head + inc + PRELUDE + body + READER, labels


def build_instrumented(root: str, tmp: str):
    from mymedialite_tpu_torch.ops import _build
    csrc = os.path.join(root, "mymedialite_tpu_torch", "csrc")
    with open(os.path.join(csrc, "sgd_epoch.cu")) as f, \
            open(os.path.join(csrc, "owner_scatter.cuh")) as g:
        src, labels = instrument(f.read(), g.read())
    cu = os.path.join(tmp, "sgd_epoch_marked.cu")
    so = os.path.join(tmp, "libsgd_marked.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", so, cu], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on the instrumented source:\n"
                           f"{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(so)
    lib.mml_sgd_epoch.restype = ctypes.c_int
    lib.mml_sgd_epoch.argtypes = \
        _build.load_library().lib.mml_sgd_epoch.argtypes
    lib.mml_seg_reset.restype = ctypes.c_int
    lib.mml_seg_read.restype = ctypes.c_int
    lib.mml_seg_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib, labels


class _Loaded:
    def __init__(self, lib):
        self.lib = lib


def mf_step_split(dev, train, root, tmp, cluster=None):
    """One instrumented epoch of the SGD kernel on the schedule the
    registry picks for ``train`` (resident: kernel 1, tiled: kernel 2),
    at the cluster size ``cluster`` where given (else the wrapper's
    own)."""
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    from mymedialite_tpu_torch.ops import _build
    from mymedialite_tpu_torch.ops import sgd_epoch as se
    model = create_rating_predictor(
        "BiasedMatrixFactorization",
        f"num_factors=40 num_iter=1 device={dev.type}")
    model.ratings = train
    model.train()
    plan = model._plan
    We, He = model._mxu_tables
    rates = model._epoch_rates(True, True)
    hp = (model.global_bias, model.min_rating, model._rating_range())
    order = plan.epoch_order(12345)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=model.loss_id, biased=True)
    tiled = hasattr(plan, "slab_blocks")
    epoch = se.sgd_epoch_tiled if tiled else se.sgd_epoch
    if tiled:
        kw["slab_blocks"] = plan.slab_blocks
    lib, labels = build_instrumented(root, tmp)
    times = {}
    for name in ("plain build", "instrumented", "no scatter"):
        W, H = We.clone(), He.clone()
        real = _build.load_library, se.DYNAMIC_SHARED_BYTES
        real_cluster = getattr(se, "cluster_size", None)
        if cluster is not None:
            se.cluster_size = lambda c: cluster
        if name == "instrumented":
            # the marks' static shared memory comes out of the dynamic
            if lib.mml_seg_reset():
                raise RuntimeError("resetting the clock marks failed")
            _build.load_library = lambda: _Loaded(lib)
            se.DYNAMIC_SHARED_BYTES -= 2048
        try:
            start, end = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            epoch(W, H, plan.packed, order, hp,
                  rates * 0 if name == "no scatter" else rates, **kw)
            end.record()
            torch.cuda.synchronize()
        except RuntimeError as err:
            raise RuntimeError(f"the {name} epoch: {err}") from err
        finally:
            _build.load_library, se.DYNAMIC_SHARED_BYTES = real
            if cluster is not None:
                se.cluster_size = real_cluster
        times[name] = start.elapsed_time(end)
    seg = (ctypes.c_ulonglong * MARKS)()
    hits = (ctypes.c_ulonglong * MARKS)()
    err = lib.mml_seg_read(ctypes.addressof(seg), ctypes.addressof(hits))
    if err:
        raise RuntimeError(f"reading the clock marks failed: CUDA error {err}")
    cycles = [int(seg[n]) for n in range(len(labels))]
    total = max(sum(cycles), 1)
    steps = plan.num_chunks
    parts = [dict(mark=n, at=labels[n], share=c / total,
                  per_chunk=int(hits[n]) / steps,
                  us_per_step=c / total * times["instrumented"] * 1e3 / steps)
             for n, c in enumerate(cycles)]
    return dict(schedule="tiled" if tiled else "resident", cluster=cluster,
                chunks=steps,
                chunk=plan.chunk, epoch_ms=times["plain build"],
                instrumented_epoch_ms=times["instrumented"],
                no_scatter_epoch_ms=times["no scatter"], parts=parts)


def svdpp_split(dev, train, test, variant=None, scatter=True):
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    model = create_rating_predictor(
        "SVDPlusPlus",
        f"num_factors=20 num_iter=1 learn_rate=0.003 device={dev.type}")
    model.ratings = train
    model.additional_feedback = (test.users, test.items)
    model.train()
    plan = model._plan
    hp, rates = model._epoch_args()
    if not scatter:
        rates = rates.clone()
        rates[:, [0, 2, 6]] = 0                   # w_lr, q_lr, y_lr
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              num_factors=model.num_factors, loss=0, sigmoid=False)
    from mymedialite_tpu_torch.ops import svdpp_epoch as se
    real = getattr(se, "accumulator_variant", None)
    if variant is not None:
        se.accumulator_variant = lambda *a: variant
    try:
        split = smoke.svdpp_phase_split(plan, model._mxu_tables,
                                        plan.schedule, hp, rates, **kw)
    finally:
        if real is not None:
            se.accumulator_variant = real
    return {name: dict(ms=ms, steps=n, us_per_step=ms * 1e3 / max(n, 1))
            for name, (ms, n) in split.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--parts", default="svdpp,mf,mf_tiled")
    ap.add_argument("--clusters", default="",
                    help="cluster sizes to measure the SGD kernel at too, "
                         "comma-separated (always: the wrapper's own)")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    if not torch.cuda.is_available():
        print("exp_torch_epoch_split: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import mymedialite_tpu_torch
    if os.path.dirname(os.path.dirname(
            os.path.abspath(mymedialite_tpu_torch.__file__))) != root:
        raise RuntimeError(f"imported {mymedialite_tpu_torch.__file__}, not "
                           f"the package under {root}")
    dev = torch.device("cuda")
    smoke.log(smoke.card_line())
    smoke.log(f"measuring {root}")
    out = {"card": smoke.card_line(), "root": root}
    if parts & {"svdpp", "mf"}:
        train, test = smoke.shaped_ratings(
            "Netflix-shaped", num_users=480_000, num_items=17_770,
            num_ratings=20_000_000, seed=1)
    if "svdpp" in parts:
        out["svdpp"] = svdpp_split(dev, train, test)
        from mymedialite_tpu_torch.ops import svdpp_epoch as se
        if hasattr(se, "accumulator_variant"):
            out["svdpp_global"] = svdpp_split(dev, train, test, "global")
        out["svdpp_no_table_scatter"] = svdpp_split(dev, train, test,
                                                    scatter=False)
        for key in ("svdpp", "svdpp_global", "svdpp_no_table_scatter"):
            for name, r in out.get(key, {}).items():
                smoke.log(f"{key} {name}: {r['ms']:.1f} ms over "
                          f"{r['steps']} steps, {r['us_per_step']:.2f} us "
                          "per step")
    shapes = [None] + [int(a) for a in args.clusters.split(",") if a]
    with tempfile.TemporaryDirectory() as tmp:
        for part in ("mf", "mf_tiled"):
            if part not in parts:
                continue
            if part == "mf_tiled":
                train, _ = smoke.shaped_ratings(
                    "MovieLens-25M-shaped", num_users=162_541,
                    num_items=62_423, num_ratings=25_000_095, seed=25)
            for shape in shapes:
                key = part + ("" if shape is None else f"_{shape}")
                try:
                    out[key] = mf_step_split(dev, train, root, tmp, shape)
                except RuntimeError as err:
                    smoke.log(f"{key}: {err}")
                    out.setdefault("failed", {})[key] = str(err)
    for key, mf in out.items():
        if not key.startswith("mf"):
            continue
        smoke.log(f"{key} epoch {mf['epoch_ms']:.1f} ms ({mf['chunks']} "
                  f"chunks of {mf['chunk']}, {mf['schedule']}, cluster "
                  f"{mf['cluster'] or 'own'}), instrumented "
                  f"{mf['instrumented_epoch_ms']:.1f} ms, no scatter "
                  f"{mf['no_scatter_epoch_ms']:.1f} ms")
        for p in mf["parts"]:
            smoke.log(f"  mark {p['mark']} ({p['at']}): "
                      f"{100 * p['share']:.1f}%, {p['us_per_step']:.3f} us "
                      f"per chunk, {p['per_chunk']:.2f} a chunk")
    print(json.dumps(out))
    return 1 if "failed" in out else 0


if __name__ == "__main__":
    sys.exit(main())
