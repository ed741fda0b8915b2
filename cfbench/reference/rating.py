"""The plain reference of the rating family: biased matrix factorisation
trained by minibatch SGD over the chunks of ``reference/chunks.py``.

Prediction min + sigmoid(global + b_u + b_i + <p_u, q_i>) * range, the
RMSE loss's gradient, the per-column learn rates and regularisation of
MyMediaLite's BiasedMatrixFactorization (bias_learn_rate, bias_reg),
each chunk one step: every slot's gradient from the tables as the chunk
starts, the deltas added with ``index_add_``. The tables are held fused,
[p_u | b_u | 1] and [q_i | 1 | b_i], so one dot product gives the score.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cfbench.reference import chunks as ck
from cfbench.reference import loop

LEAVES = ("user_factors", "user_bias", "item_factors", "item_bias")


def hyper(config: dict) -> dict:
    return config["hyperparameters"]


def route(num_items: int, config: dict) -> str:
    return ck.schedule(num_items, hyper(config)["num_factors"])


def scale(values: np.ndarray):
    """(min, range, global bias) of the log, as BiasedMF takes them:
    the rating scale's ends, and the logit of the normalised mean."""
    lo, hi = float(values.min()), float(values.max())
    rng = max(hi - lo, 1e-9)
    avg = (float(values.mean()) - lo) / rng
    avg = min(max(avg, 1e-6), 1 - 1e-6)
    return lo, rng, math.log(avg / (1 - avg))


def initial_tables(log: dict, config: dict, seed: int, device, dtype):
    """(W, H) fused [U, k+2] / [I, k+2]: N(init_mean, init_stdev)
    factors from a generator seeded with ``seed`` (users then items),
    zero rows for entities without ratings, zero biases."""
    hp = hyper(config)
    U, I, k = log["num_users"], log["num_items"], hp["num_factors"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    wu = hp["init_mean"] + hp["init_stdev"] * torch.randn(
        (U, k), generator=gen, device=device)
    hi = hp["init_mean"] + hp["init_stdev"] * torch.randn(
        (I, k), generator=gen, device=device)
    cu = np.bincount(log["users"], minlength=U)
    ci = np.bincount(log["items"], minlength=I)
    wu[torch.from_numpy(cu == 0).to(device)] = 0.0
    hi[torch.from_numpy(ci == 0).to(device)] = 0.0
    W = torch.zeros((U, k + 2), dtype=torch.float32, device=device)
    W[:, :k] = wu
    W[:, k + 1] = 1.0
    H = torch.zeros((I, k + 2), dtype=torch.float32, device=device)
    H[:, :k] = hi
    H[:, k] = 1.0
    return W.to(dtype), H.to(dtype)


def column_rates(config: dict, device, dtype, epoch: int = 1):
    """[k+2] each: (w_lr, w_reg, h_lr, h_reg) over the fused columns, at
    epoch ``epoch``'s learn rate (learn_rate_decay once an epoch)."""
    hp = hyper(config)
    k, blr = hp["num_factors"], hp["bias_learn_rate"]
    lr = hp["learn_rate"] * hp["learn_rate_decay"] ** (epoch - 1)
    reg, breg = hp["regularization"], hp["bias_reg"]
    out = np.zeros((4, k + 2), np.float32)
    out[0, :k], out[0, k] = lr, blr * lr
    out[1, :k], out[1, k] = reg, breg * reg
    out[2, :k], out[2, k + 1] = lr, blr * lr
    out[3, :k], out[3, k + 1] = reg, breg * reg
    return torch.from_numpy(out).to(device=device, dtype=dtype).unbind(0)


def leaves(W, H) -> dict:
    k = W.shape[1] - 2
    return dict(user_factors=W[:, :k], user_bias=W[:, k],
                item_factors=H[:, :k], item_bias=H[:, k + 1])


def fused(tables: dict, dtype):
    """(W, H) fused from the four leaves."""
    P, Q = tables["user_factors"], tables["item_factors"]
    k = P.shape[1]
    W = torch.zeros((P.shape[0], k + 2), dtype=torch.float32,
                    device=P.device)
    W[:, :k], W[:, k], W[:, k + 1] = P, tables["user_bias"], 1.0
    H = torch.zeros((Q.shape[0], k + 2), dtype=torch.float32,
                    device=Q.device)
    H[:, :k], H[:, k], H[:, k + 1] = Q, 1.0, tables["item_bias"]
    return W.to(dtype), H.to(dtype)


def prepare(log: dict, config: dict, seed: int, device) -> dict:
    """What every epoch of the model shares: its chunks and schedule."""
    tiled = route(log["num_items"], config) == "tiled"
    return {"tiled": tiled, "chunks": ck.make_chunks(
        log["users"], log["items"], log["num_users"], log["num_items"],
        chunk=None if tiled else 640, shuffle_seed=seed,
        device=torch.device(device))}


def epoch_order(prep: dict, config: dict, seed: int, epoch: int):
    """The chunks' visit order of epoch ``epoch``."""
    ch, es = prep["chunks"], ck.epoch_seed(seed, epoch)
    if prep["tiled"]:
        return ck.tiled_order(ch, es,
                              ck.slab_blocks(hyper(config)["num_factors"]))
    return ck.resident_order(ch, es)


def epoch(log: dict, config: dict, seed: int, device, prep: dict, *,
              epoch: int = 1, tables=None, dtype=torch.float32,
              fault: str = ""):
    """Epoch ``epoch`` in ``dtype``, ready for ``loop.run_many``: from
    ``tables`` (the leaves the epoch starts from), or from the initial
    tables where None.

    ``fault`` plants a fault for the control's readings: "half" leaves
    out every other slot of each chunk and doubles the weight of the
    rest (half the batch, the mean over the rest)."""
    device = torch.device(device)
    lo, rng, gb = scale(log["values"])
    W, H = (initial_tables(log, config, seed, device, dtype)
            if tables is None else fused(tables, dtype))
    start = {n: t.float().clone() for n, t in leaves(W, H).items()}
    order = epoch_order(prep, config, seed, epoch)
    rows = prep["chunks"].rows[torch.from_numpy(order).to(device)]
    wt = (rows >= 0).to(dtype)
    if fault == "half":
        wt[:, 1::2] = 0
        wt *= 2
    rows.clamp_(min=0)
    users = torch.from_numpy(log["users"]).to(device)[rows]
    items = torch.from_numpy(log["items"]).to(device)[rows]
    values = torch.from_numpy(log["values"]).to(device)[rows].to(dtype)
    del rows
    w_lr, w_reg, h_lr, h_reg = column_rates(config, device, dtype, epoch)

    def step(u, i, v, w):
        wu, hi = W[u], H[i]
        sig = torch.sigmoid((wu * hi).sum(1) + gb)
        err = v - (lo + sig * rng)
        g = (err * sig * (1.0 - sig) * rng * w)[:, None]
        w = w[:, None]
        W.index_add_(0, u, w_lr * (g * hi - w * w_reg * wu))
        H.index_add_(0, i, h_lr * (g * wu - w * h_reg * hi))

    return loop.Epoch(start, step, (users, items, values, wt),
                      lambda: {n: t.float() for n, t in leaves(W, H).items()})


def loss(tables: dict, log: dict, device) -> float:
    """The training RMSE of BiasedMF's prediction from ``tables`` (the
    four leaves), over every rating of the log, in float64 sums."""
    lo, rng, gb = scale(log["values"])
    P, bu = tables["user_factors"], tables["user_bias"]
    Q, bi = tables["item_factors"], tables["item_bias"]
    total, n = 0.0, log["users"].size
    block = 1 << 23
    for s in range(0, n, block):
        u = torch.from_numpy(log["users"][s:s + block]).to(device)
        i = torch.from_numpy(log["items"][s:s + block]).to(device)
        v = torch.from_numpy(log["values"][s:s + block]).to(device)
        score = (P[u] * Q[i]).sum(1) + bu[u] + bi[i] + gb
        err = v.double() - (lo + torch.sigmoid(score).double() * rng)
        total += float((err * err).sum())
    return math.sqrt(total / max(n, 1))
