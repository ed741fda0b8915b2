"""Whether a ``--profile`` trace of the port's rating CLI holds the CUDA
events of kernel 1 (``sgd_epoch_kernel``), in a process that opened
other torch.profiler sessions before, and in a process of its own.

    python3 exp_torch_profile_sessions.py [--rounds 6] [--processes 4]

The CLI trains BiasedMatrixFactorization (k=40, 3 epochs: kernel 1
three times) on the 90/10 split of ``synthetic_ratings(6040, 3706,
1_000_000, seed=110)``, the ML-1M shape of ``chip_smoke.py``'s phase
23 (f). In-process: ``--rounds`` rounds of a CUDA-only session (as
``chip_smoke.py device_ms`` opens), a CPU + CUDA session (as its
busy-share traces open), then the CLI with ``--profile``. In processes
of their own: ``--processes`` runs through ``chip_smoke.py
--counted-cli``, as phase 23 (f) runs it. Prints one line per run (the
trace's kernel events, and those of kernel 1) and one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import tempfile

import numpy as np
import torch


def cuda_only_session():
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (a @ a).sum().item()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages())


def cpu_cuda_session():
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(4096, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(200):
            a = a * 1.0001
        torch.cuda.synchronize()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--processes", type=int, default=4)
    args = ap.parse_args()
    import chip_smoke as smoke
    from mymedialite_tpu_torch.cli import rating_prediction
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke.log(smoke.card_line())
    out = {"in_process": [], "own_process": []}
    with tempfile.TemporaryDirectory() as tmp:
        train, test = split_ratings(synthetic_ratings(6040, 3706, 1_000_000,
                                                      seed=110), 0.1, seed=111)
        files = []
        for name, part in (("training", train), ("test", test)):
            path = os.path.join(tmp, f"{name}.tsv")
            np.savetxt(path, np.column_stack([part.users, part.items,
                                              part.values]),
                       fmt=("%d", "%d", "%g"), delimiter="\t")
            files += [f"--{name}-file", path]
        argv = files + ["--recommender-options",
                        "num_factors=40 num_iter=3 device=cuda"]
        for r in range(args.rounds):
            device_us = cuda_only_session()
            cpu_cuda_session()
            trace_dir = os.path.join(tmp, f"in_{r}")
            with smoke.counted_path({"sgd_epoch": 3}), \
                    contextlib.redirect_stdout(io.StringIO()):
                rc = rating_prediction.main(argv + ["--profile", trace_dir])
            events = smoke.trace_kernels(trace_dir)
            row = dict(rc=rc, events=len(events), kernel1=sum(
                "sgd_epoch_kernel" in e for e in events),
                session_device_us=device_us)
            out["in_process"].append(row)
            smoke.log(f"in-process round {r}: {row}")
        for r in range(args.processes):
            trace_dir = os.path.join(tmp, f"own_{r}")
            smoke.counted_clis([({"sgd_epoch": 3}, "rating_prediction",
                                 argv + ["--profile", trace_dir])])
            events = smoke.trace_kernels(trace_dir)
            row = dict(events=len(events), kernel1=sum(
                "sgd_epoch_kernel" in e for e in events))
            out["own_process"].append(row)
            smoke.log(f"own process {r}: {row}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
