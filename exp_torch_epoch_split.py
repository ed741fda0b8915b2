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

MARKS = 32
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
# what a mark is placed beside
BARRIER = re.compile(
    r"(__syncthreads\(\)|cluster_(barrier|arrive|wait)\(ncta\));")
WAIT = re.compile(r"cp_async_wait_all\(\);")
INCLUDE = re.compile(r'#include "([^"]+)"\n')
PASS = "for (int p0 = warp * SPW;"


def _close(text, at):
    """The index of the brace that closes the first ``{`` at or after
    ``at``."""
    i = text.index("{", at)
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return j
    raise ValueError("unbalanced braces")


class _Marks:
    """Clock marks placed in CUDA source text, numbered in order."""

    def __init__(self):
        self.labels = []

    def new(self, label):
        if len(self.labels) >= MARKS:
            raise ValueError(f"more than {MARKS} marks")
        self.labels.append(label)
        return len(self.labels) - 1

    def barriers(self, text, where):
        """A mark at every barrier and around every wait for copies in
        flight of ``text`` (labelled with the two lines before it and
        ``where``)."""
        def before(m):
            lines = text[:m.start()].rstrip().splitlines()
            return " | ".join(s.strip() for s in lines[-2:]) + where

        def barrier(m):
            if not m.group(0).startswith("cluster_barrier"):
                n = self.new(before(m))
                if m.group(0).startswith("cluster_"):
                    self.labels[n] = f"{m.group(0)} after: {self.labels[n]}"
                return f"{m.group(0)} MML_MARK({n});"
            a = self.new("before the cluster barrier after: " + before(m))
            b = self.new("the cluster barrier after: " + before(m))
            return f"MML_MARK({a}); {m.group(0)} MML_MARK({b});"

        def wait(m):
            a = self.new("before the wait for copies in flight (the "
                         "previous chunk's tail)" + where)
            b = self.new("the wait for copies in flight" + where)
            return f"MML_MARK({a}); {m.group(0)} MML_MARK({b});"
        text = WAIT.sub(wait, text)
        return BARRIER.sub(barrier, text)

    def passes(self, body):
        """A mark at the end of every phase-1 pass loop of ``body`` (a pass
        of thread 0's warp)."""
        at = 0
        while True:
            at = body.find(PASS, at)
            if at < 0:
                return body
            close = _close(body, at)
            lines = body[:at].rstrip().splitlines()
            n = self.new("a phase-1 pass of thread 0's warp, after: "
                         + lines[-1].strip())
            mark = f"  MML_MARK({n});\n    "
            body = body[:close] + mark + body[close:]
            at = close + len(mark) + 1


def instrument(src: str, csrc: str, kernel: str):
    """The source, with the headers it includes from ``csrc`` inlined
    (each once, marked at their barriers), a clock mark at every barrier
    of ``kernel``, around every wait for copies in flight and at the end
    of every phase-1 pass; returns (source, a label for each mark)."""
    marks = _Marks()
    done = set()

    def inline(text):
        def header(m):
            if m.group(1) in done:
                return ""
            done.add(m.group(1))
            with open(os.path.join(csrc, m.group(1))) as f:
                inner = f.read().replace("#pragma once\n", "")
            return inline(marks.barriers(inner, f" ({m.group(1)})"))
        return INCLUDE.sub(header, text)

    head, inc, body = src.partition("#include <stdint.h>\n")
    if not inc:
        raise ValueError("no #include <stdint.h> to anchor the prelude")
    body = inline(body)
    m = re.search(rf"^{kernel}\(", body, re.M)
    if not m:
        raise ValueError(f"no definition of {kernel}")
    a = body.index("{", m.end())
    b = _close(body, a)
    kern = body[a:b]
    shared = "extern __shared__ __align__(16) unsigned char smem[];\n"
    if kern.count(shared) != 1:
        raise ValueError(f"want one dynamic shared memory line in {kernel}")
    kern = kern.replace(shared, shared + KERNEL_START)
    kern = marks.passes(kern)
    kern = marks.barriers(kern, "")
    body = body[:a] + kern + body[b:]
    return head + inc + PRELUDE + body + READER, marks.labels


# the instrumented kernels: source, kernel, C entry point
KERNELS = {"sgd": ("sgd_epoch.cu", "sgd_epoch_kernel", "mml_sgd_epoch"),
           "bpr": ("bpr_epoch.cu", "bpr_walk_kernel", "mml_bpr_epoch"),
           "svdpp": ("svdpp_epoch.cu", "svdpp_epoch_kernel",
                     "mml_svdpp_epoch")}


def build_instrumented(root: str, tmp: str, which: str = "sgd"):
    from mymedialite_tpu_torch.ops import _build
    source, kernel, entry = KERNELS[which]
    csrc = os.path.join(root, "mymedialite_tpu_torch", "csrc")
    with open(os.path.join(csrc, source)) as f:
        src, labels = instrument(f.read(), csrc, kernel)
    cu = os.path.join(tmp, f"{which}_marked.cu")
    so = os.path.join(tmp, f"lib{which}_marked.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", so, cu], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on the instrumented source:\n"
                           f"{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(so)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = getattr(_build.load_library().lib, entry).argtypes
    lib.mml_seg_reset.restype = ctypes.c_int
    lib.mml_seg_read.restype = ctypes.c_int
    lib.mml_seg_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib, labels


class _Loaded:
    def __init__(self, lib):
        self.lib = lib


def split_epoch(lib, labels, module, run, steps, cluster=None):
    """Three launches of one epoch through a wrapper of ``module``:
    ``run(True)`` with the plain build, with the instrumented one
    (``lib``, its clock marks read after), and ``run(False)`` ("no
    scatter"), at the cluster size ``cluster`` where given. Returns the
    times and each mark's share, per step of the ``steps``."""
    from mymedialite_tpu_torch.ops import _build
    times = {}
    for name in ("plain build", "instrumented", "no scatter"):
        real = _build.load_library, module.DYNAMIC_SHARED_BYTES
        real_cluster = getattr(module, "cluster_size", None)
        if cluster is not None:
            module.cluster_size = lambda *a: cluster
        if name == "instrumented":
            # the marks' static shared memory comes out of the dynamic
            if lib.mml_seg_reset():
                raise RuntimeError("resetting the clock marks failed")
            _build.load_library = lambda: _Loaded(lib)
            module.DYNAMIC_SHARED_BYTES -= 2048
        try:
            start, end = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            run(name != "no scatter")
            end.record()
            torch.cuda.synchronize()
        except RuntimeError as err:
            raise RuntimeError(f"the {name} epoch: {err}") from err
        finally:
            _build.load_library, module.DYNAMIC_SHARED_BYTES = real
            if cluster is not None:
                module.cluster_size = real_cluster
        times[name] = start.elapsed_time(end)
    seg = (ctypes.c_ulonglong * MARKS)()
    hits = (ctypes.c_ulonglong * MARKS)()
    err = lib.mml_seg_read(ctypes.addressof(seg), ctypes.addressof(hits))
    if err:
        raise RuntimeError(f"reading the clock marks failed: CUDA error {err}")
    cycles = [int(seg[n]) for n in range(len(labels))]
    total = max(sum(cycles), 1)
    parts = [dict(mark=n, at=labels[n], share=c / total,
                  per_chunk=int(hits[n]) / steps,
                  us_per_step=c / total * times["instrumented"] * 1e3 / steps)
             for n, c in enumerate(cycles)]
    return dict(cluster=cluster, chunks=steps, epoch_ms=times["plain build"],
                instrumented_epoch_ms=times["instrumented"],
                no_scatter_epoch_ms=times["no scatter"], parts=parts)


def mf_step_split(dev, train, root, tmp, cluster=None):
    """One instrumented epoch of the SGD kernel on the schedule the
    registry picks for ``train`` (resident: kernel 1, tiled: kernel 2),
    at the cluster size ``cluster`` where given (else the wrapper's
    own)."""
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
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
    lib, labels = build_instrumented(root, tmp, "sgd")

    def run(scatter):
        epoch(We.clone(), He.clone(), plan.packed, order, hp,
              rates if scatter else rates * 0, **kw)
    out = split_epoch(lib, labels, se, run, plan.num_chunks, cluster)
    return dict(out, schedule="tiled" if tiled else "resident",
                chunk=plan.chunk)


def svdpp_model(dev, train, test, k):
    """SVDPlusPlus at k factors (learn rate 0.003, transductive on the
    test pairs), trained one epoch through the registry."""
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    model = create_rating_predictor(
        "SVDPlusPlus",
        f"num_factors={k} num_iter=1 learn_rate=0.003 device={dev.type}")
    model.ratings = train
    model.additional_feedback = (test.users, test.items)
    model.train()
    return model


def svdpp_step_split(dev, model, root, tmp, cluster=None):
    """The SVD++ kernel instrumented (``build_instrumented(.., "svdpp")``)
    over the trained model's whole schedule and over its S, R and Y steps
    alone, from its tables; "no scatter": the W, Q and Y learning rates
    0 (s, c and n are still summed)."""
    from mymedialite_tpu_torch.ops import svdpp_epoch as se
    plan = model._plan
    hp, rates = model._epoch_args()
    quiet = rates.clone()
    quiet[:, [0, 2, 6]] = 0                       # w_lr, q_lr, y_lr
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              num_factors=model.num_factors, loss=0, sigmoid=False)
    lib, labels = build_instrumented(root, tmp, "svdpp")
    out = {}
    parts = {"epoch": plan.schedule, **smoke.phase_schedules(plan.schedule)}
    for name, sched in parts.items():
        def run(scatter, sched=sched):
            se.svdpp_epoch(*(t.clone() for t in model._mxu_tables),
                           plan.packed, sched, hp,
                           rates if scatter else quiet, **kw)
        out[name] = split_epoch(lib, labels, se, run,
                                int(sched[0].numel()), cluster)
        out[name]["chunk"] = plan.chunk
    return out


def bpr_step_split(dev, train, root, tmp, cluster=None):
    """BPRMF (k=40, the main path's) trained one epoch through the
    registry, its epoch's arguments recorded; then the BPR walk
    instrumented (``build_instrumented(.., "bpr")``) over one epoch from
    the same inputs; "no scatter": every learning rate 0."""
    from mymedialite_tpu_torch.data.synthetic import posonly_from_ratings
    from mymedialite_tpu_torch.models import bpr as bpr_model
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    from mymedialite_tpu_torch.ops import bpr_epoch as be
    calls = []
    real = bpr_model.bpr_epoch

    def record(W, H, *args, **kw):
        calls.append((W.clone(), H.clone(), args, kw))
        return real(W, H, *args, **kw)
    bpr_model.bpr_epoch = record
    try:
        model = create_item_recommender(
            "BPRMF", f"num_factors=40 num_iter=1 device={dev.type}")
        model.feedback = posonly_from_ratings(train)
        model.train()
    finally:
        bpr_model.bpr_epoch = real
    W, H, args, kw = calls[-1]
    rates = args[-1]
    lib, labels = build_instrumented(root, tmp, "bpr")

    def run(scatter):
        be.bpr_epoch(W.clone(), H.clone(), *args[:-1],
                     rates if scatter else rates * 0, **kw)
    out = split_epoch(lib, labels, be, run, int(args[4][0].numel()), cluster)
    return dict(out, chunk=int(args[0].shape[2]))


def svdpp_split(model, variant=None, scatter=True):
    """The SVD++ kernel's ms over the trained model's schedule and over its
    S, R and Y steps alone (``chip_smoke.svdpp_phase_split``), the
    accumulator variant forced where given, the W, Q and Y learning
    rates 0 without ``scatter``."""
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
        se.accumulator_variant = lambda *a, **k: variant
    try:
        split = smoke.svdpp_phase_split(plan, model._mxu_tables,
                                        plan.schedule, hp, rates, **kw)
    finally:
        if real is not None:
            se.accumulator_variant = real
    return {name: dict(ms=ms, steps=n, us_per_step=ms * 1e3 / max(n, 1))
            for name, (ms, n) in split.items()}


def log_marks(key, r):
    smoke.log(f"{key} epoch {r['epoch_ms']:.1f} ms ({r['chunks']} steps of "
              f"{r['chunk']}, {r.get('schedule', '')} cluster "
              f"{r['cluster'] or 'own'}), instrumented "
              f"{r['instrumented_epoch_ms']:.1f} ms, no scatter "
              f"{r['no_scatter_epoch_ms']:.1f} ms")
    for p in r["parts"]:
        smoke.log(f"  mark {p['mark']} ({p['at']}): "
                  f"{100 * p['share']:.1f}%, {p['us_per_step']:.3f} us "
                  f"per step, {p['per_chunk']:.2f} a step")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--parts", default="svdpp,svdpp_marks,mf,mf_tiled,bpr")
    ap.add_argument("--clusters", default="",
                    help="cluster sizes to measure the instrumented kernels "
                         "at too, comma-separated (always: the wrapper's "
                         "own)")
    ap.add_argument("--widths", default="20,50",
                    help="SVD++ factors of the svdpp_marks part")
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
    shapes = [None] + [int(a) for a in args.clusters.split(",") if a]

    def attempt(key, fn, *a):
        try:
            out[key] = fn(*a)
        except (RuntimeError, ValueError) as err:
            smoke.log(f"{key}: {err}")
            out.setdefault("failed", {})[key] = str(err)

    if parts & {"svdpp", "svdpp_marks", "mf", "bpr"}:
        train, test = smoke.shaped_ratings(
            "Netflix-shaped", num_users=480_000, num_items=17_770,
            num_ratings=20_000_000, seed=1)
    with tempfile.TemporaryDirectory() as tmp:
        if parts & {"svdpp", "svdpp_marks"}:
            for k in sorted({20} | {int(w) for w in args.widths.split(",")}):
                if k != 20 and "svdpp_marks" not in parts:
                    continue
                model = svdpp_model(dev, train, test, k)
                if "svdpp" in parts and k == 20:
                    out["svdpp"] = svdpp_split(model)
                    from mymedialite_tpu_torch.ops import svdpp_epoch as se
                    if hasattr(se, "accumulator_variant"):
                        out["svdpp_global"] = svdpp_split(model, "global")
                    out["svdpp_no_table_scatter"] = svdpp_split(
                        model, scatter=False)
                if "svdpp_marks" in parts and \
                        str(k) in args.widths.split(","):
                    for shape in shapes:
                        attempt(f"svdpp_marks_k{k}"
                                + ("" if shape is None else f"_{shape}"),
                                svdpp_step_split, dev, model, root, tmp,
                                shape)
                del model
            for key in ("svdpp", "svdpp_global", "svdpp_no_table_scatter"):
                for name, r in out.get(key, {}).items():
                    smoke.log(f"{key} {name}: {r['ms']:.1f} ms over "
                              f"{r['steps']} steps, {r['us_per_step']:.2f} "
                              "us per step")
        if "bpr" in parts:
            for shape in shapes:
                attempt("bpr" + ("" if shape is None else f"_{shape}"),
                        bpr_step_split, dev, train, root, tmp, shape)
        for part in ("mf", "mf_tiled"):
            if part not in parts:
                continue
            if part == "mf_tiled":
                train, _ = smoke.shaped_ratings(
                    "MovieLens-25M-shaped", num_users=162_541,
                    num_items=62_423, num_ratings=25_000_095, seed=25)
            for shape in shapes:
                attempt(part + ("" if shape is None else f"_{shape}"),
                        mf_step_split, dev, train, root, tmp, shape)
    for key, r in out.items():
        if key.startswith(("mf", "bpr")):
            log_marks(key, r)
        elif key.startswith("svdpp_marks"):
            for name, rr in r.items():
                log_marks(f"{key} {name}", rr)
    print(json.dumps(out))
    return 1 if "failed" in out else 0


if __name__ == "__main__":
    sys.exit(main())
