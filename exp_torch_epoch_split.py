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
2. BiasedMatrixFactorization (k=40, resident schedule) trained one epoch
   through the registry; then one epoch of an instrumented build of
   ``csrc/sgd_epoch.cu``: after every ``__syncthreads()`` in the kernel,
   thread 0 reads ``clock64()`` and adds the cycles since the barrier
   before to this barrier's counter. A barrier's share is the share of
   the walk spent in the code that ends at it (with the wait there for
   the slowest warp). The instrumented build lives only in this script's
   temporary directory; the wrapper's launch runs it by patching the
   loaded library for the call. Then one epoch with every learning rate
   0 ("no scatter": the kernel stores and sends no delta).

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

MARKS = 8
PRELUDE = """
__device__ unsigned long long mml_seg[%d];
#define MML_MARK(n)                                                    \\
  do {                                                                 \\
    if (threadIdx.x == 0) {                                            \\
      const unsigned long long t_ = clock64();                        \\
      if (mml_last_) mml_acc_[n] += t_ - mml_last_;                    \\
      mml_last_ = t_;                                                  \\
    }                                                                  \\
  } while (0)
""" % MARKS
KERNEL_START = ("  unsigned long long mml_acc_[%d] = {0}, mml_last_ = 0;\n"
                % MARKS)
KERNEL_END = ("  if (threadIdx.x == 0)\n"
              "#pragma unroll\n"
              "    for (int q_ = 0; q_ < %d; ++q_) mml_seg[q_] = mml_acc_[q_];\n"
              % MARKS)
READER = """
extern "C" int mml_seg_read(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(out, mml_seg, sizeof(mml_seg));
}
"""


def instrument(src: str):
    """The source with a clock mark after every __syncthreads() of the
    file's one kernel in its anonymous namespace; returns (source, the
    source line before each mark)."""
    head, inc, tail = src.partition("#include <stdint.h>\n")
    if not inc:
        raise ValueError("no #include <stdint.h> to anchor the prelude")
    body, ns_end, rest = tail.partition("\n}  // namespace")
    if not ns_end:
        raise ValueError("no anonymous namespace end")
    shared = "extern __shared__ __align__(16) unsigned char smem[];\n"
    if body.count(shared) != 1:
        raise ValueError("want exactly one kernel with dynamic shared memory")
    body = body.replace(shared, shared + KERNEL_START)
    end = body.rstrip().rfind("}")            # the kernel's closing brace
    body = body[:end] + KERNEL_END + body[end:]
    labels = []

    def mark(m):
        n = len(labels)
        if n >= MARKS:
            raise ValueError(f"more than {MARKS} barriers")
        before = body[:m.start()].rstrip().splitlines()
        labels.append(" | ".join(s.strip() for s in before[-2:]))
        return f"__syncthreads(); MML_MARK({n});"

    body = re.sub(r"__syncthreads\(\);", mark, body)
    return head + inc + PRELUDE + body + ns_end + rest + READER, labels


def build_instrumented(root: str, tmp: str):
    from mymedialite_tpu_torch.ops import _build
    src_path = os.path.join(root, "mymedialite_tpu_torch", "csrc",
                            "sgd_epoch.cu")
    src, labels = instrument(open(src_path).read())
    cu = os.path.join(tmp, "sgd_epoch_marked.cu")
    so = os.path.join(tmp, "libsgd_marked.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
                    cu], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.mml_sgd_epoch.restype = ctypes.c_int
    lib.mml_sgd_epoch.argtypes = \
        _build.load_library().lib.mml_sgd_epoch.argtypes
    lib.mml_seg_read.restype = ctypes.c_int
    lib.mml_seg_read.argtypes = [ctypes.c_void_p]
    return lib, labels


class _Loaded:
    def __init__(self, lib):
        self.lib = lib


def mf_step_split(dev, train, root, tmp):
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
    lib, labels = build_instrumented(root, tmp)
    times = {}
    for name in ("plain build", "instrumented", "no scatter"):
        W, H = We.clone(), He.clone()
        real = _build.load_library
        if name == "instrumented":
            _build.load_library = lambda: _Loaded(lib)
        try:
            start, end = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            se.sgd_epoch(W, H, plan.packed, order, hp,
                         rates * 0 if name == "no scatter" else rates, **kw)
            end.record()
            torch.cuda.synchronize()
        finally:
            _build.load_library = real
        times[name] = start.elapsed_time(end)
    seg = (ctypes.c_ulonglong * MARKS)()
    err = lib.mml_seg_read(ctypes.addressof(seg))
    if err:
        raise RuntimeError(f"reading the clock marks failed: CUDA error {err}")
    cycles = [int(seg[n]) for n in range(len(labels))]
    total = sum(cycles)
    steps = plan.num_chunks
    parts = [dict(barrier=n, after=labels[n], share=c / total,
                  us_per_step=c / total * times["instrumented"] * 1e3 / steps)
             for n, c in enumerate(cycles)]
    return dict(chunks=steps, chunk=plan.chunk, epoch_ms=times["plain build"],
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
    args = ap.parse_args()
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
    train, test = smoke.shaped_ratings("Netflix-shaped", num_users=480_000,
                                       num_items=17_770,
                                       num_ratings=20_000_000, seed=1)
    out = {"card": smoke.card_line(), "root": root}
    out["svdpp"] = svdpp_split(dev, train, test)
    from mymedialite_tpu_torch.ops import svdpp_epoch as se
    if hasattr(se, "accumulator_variant"):
        out["svdpp_global"] = svdpp_split(dev, train, test, "global")
    out["svdpp_no_table_scatter"] = svdpp_split(dev, train, test,
                                                scatter=False)
    for key in ("svdpp", "svdpp_global", "svdpp_no_table_scatter"):
        for name, r in out.get(key, {}).items():
            smoke.log(f"{key} {name}: {r['ms']:.1f} ms over {r['steps']} "
                      f"steps, {r['us_per_step']:.2f} us per step")
    with tempfile.TemporaryDirectory() as tmp:
        out["mf"] = mf_step_split(dev, train, root, tmp)
    mf = out["mf"]
    smoke.log(f"mf epoch {mf['epoch_ms']:.1f} ms ({mf['chunks']} chunks of "
              f"{mf['chunk']}), instrumented {mf['instrumented_epoch_ms']:.1f}"
              f" ms, no scatter {mf['no_scatter_epoch_ms']:.1f} ms")
    for p in mf["parts"]:
        smoke.log(f"  code ending at barrier {p['barrier']} ({p['after']}): "
                  f"{100 * p['share']:.1f}%, {p['us_per_step']:.2f} us per "
                  "step")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
