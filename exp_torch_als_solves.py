"""The two batched SPD solves that were measured for WRMF's ALS sides, on
the card.

Run on a machine with one CUDA card, from the repository root:

    python3 exp_torch_als_solves.py

On the Netflix-shaped ratings of ``chip_smoke.py`` (the same generator,
seed and split) taken as positive-only feedback, WRMF (k=40,
regularization 100) is trained one alternation through the registry.
Every user's system (480,000 of 40 x 40) is then assembled from the
trained item factors by ``ops/als.py row_systems`` and solved by

1. ``ops/als.py solve_cholesky`` (``torch.linalg.cholesky_ex`` +
   ``torch.cholesky_solve``), the route WRMF takes;
2. ``solve_unrolled`` below: a plain-torch port of the JAX package's
   right-looking Cholesky unrolled over f, with its two substitutions
   (``mymedialite_tpu/ops/als.py _batched_spd_solve``).

Each route runs once on 1,024 systems to warm up and is then timed three
times with CUDA events; each is held against a float64 solve of the same
systems (the largest |x32 - x64| over the largest |x64|). Prints the
card, the times and errors, and one JSON line.
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F


def solve_unrolled(M, b):
    """The JAX package's ``_batched_spd_solve``: factor by a right-looking
    Cholesky unrolled over f (S is the trailing Schur complement after j
    steps), then forward and back substitution. Returns x."""
    f = M.shape[1]
    cols = []
    S = M
    for j in range(f):
        d = torch.sqrt(S[:, 0, 0])
        col = S[:, :, 0] / d[:, None]                  # [C, f-j], col[0]=d
        cols.append(F.pad(col, (j, 0)))
        if j + 1 < f:
            S = S[:, 1:, 1:] - col[:, 1:, None] * col[:, None, 1:]
    L = torch.stack(cols, dim=2)                       # [C, f, f] lower

    ys = []                                            # L y = b
    r = b
    for j in range(f):
        yj = r[:, 0] / L[:, j, j]
        ys.append(yj)
        r = r[:, 1:] - yj[:, None] * L[:, j + 1:, j]
    y = torch.stack(ys, dim=1)

    xs = []                                            # L^T x = y
    r = y.flip(1)
    for jr in range(f):
        j = f - 1 - jr
        xj = r[:, 0] / L[:, j, j]
        xs.append(xj)
        r = r[:, 1:] - xj[:, None] * L[:, j, :j].flip(1)
    return torch.stack(xs[::-1], dim=1)


def user_systems(model):
    """Every user's system (M [U, f, f], b [U, f]) from the model's item
    factors, in bucket order, through ``ops/als.py row_systems``."""
    from mymedialite_tpu_torch.ops import als
    H = model.params["item_factors"]
    HH = als.gram(H)
    Ms, bs = [], []
    for _, hist, lens, chunk in model._user_hist:
        for r0 in range(0, hist.shape[0], chunk):
            M, b = als.row_systems(H, HH, hist[r0:r0 + chunk],
                                   lens[r0:r0 + chunk], model.alpha,
                                   model.regularization)
            Ms.append(M)
            bs.append(b)
    return torch.cat(Ms), torch.cat(bs)


def timed(fn, reps=3):
    """(ms of each of ``reps`` calls by CUDA events, the last result)."""
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return times, out


def main() -> int:
    import chip_smoke as smoke
    from mymedialite_tpu_torch.data.synthetic import posonly_from_ratings
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    from mymedialite_tpu_torch.ops import als

    torch.backends.cuda.matmul.allow_tf32 = False
    smoke.log(smoke.card_line())
    train, _ = smoke.shaped_ratings("Netflix-shaped", num_users=480_000,
                                    num_items=17_770,
                                    num_ratings=20_000_000, seed=1)
    model = create_item_recommender(
        "WRMF", "num_factors=40 num_iter=1 regularization=100 device=cuda")
    model.feedback = posonly_from_ratings(train)
    model.train()
    M, b = user_systems(model)
    x64, info = als.solve_cholesky(M.double(), b.double())
    if bool((info != 0).any()):
        raise AssertionError("float64: a system is not positive definite")
    scale = float(x64.abs().max())

    def cholesky(M, b):
        x, info = als.solve_cholesky(M, b)
        if bool((info != 0).any()):
            raise AssertionError("a system is not positive definite")
        return x

    out = {}
    for route, solve in (("cholesky_ex", cholesky),
                         ("unrolled", solve_unrolled)):
        solve(M[:1024], b[:1024])
        times, x = timed(lambda: solve(M, b))
        err = float((x.double() - x64).abs().max()) / scale
        out[route] = dict(ms=times, max_rel_err=err)
        smoke.log(f"{route}: {M.shape[0]} systems of {M.shape[1]} x "
                  f"{M.shape[2]}: {', '.join(f'{t:.1f}' for t in times)} ms; "
                  f"max error {err:.3e} of the largest |x| against float64")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
