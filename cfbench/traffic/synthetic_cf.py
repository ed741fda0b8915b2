"""The synthetic collaborative-filtering log: one general generator that
every traffic mix (``cfbench/traffic/<mix>.json``) parameterises.

The distribution of ``mymedialite_tpu_torch/data/synthetic.py``
``synthetic_ratings``, drawn on the device from one ``torch.Generator``
seeded with the run's seed: Zipf item popularity (``item_zipf``),
log-normal user activity (``user_lognormal_sigma``), and a planted
rank-``rank`` score plus user and item biases and Gaussian noise
(``noise``), rounded to the half-star scale ``levels`` = [lo, hi, step].
Draws continue until the distinct (user, item) pairs reach
``num_ratings``; the first that many distinct pairs in draw order are
kept. The same seed on the same device gives the same log.
"""

from __future__ import annotations

import math

import torch


def _draw(gen, cdf, size: int, device):
    u = torch.rand(size, generator=gen, device=device, dtype=torch.float64)
    idx = torch.searchsorted(cdf, u, right=True)
    return idx.clamp_(max=cdf.numel() - 1)


def _first_distinct(keys):
    """Indices of each distinct key's first draw, ascending."""
    sorted_keys, perm = torch.sort(keys, stable=True)
    head = torch.ones_like(sorted_keys, dtype=torch.bool)
    head[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return torch.sort(perm[head]).values


def generate(mix: dict, seed: int, device="cuda") -> dict:
    """The log of ``mix`` for ``seed``: a dict of device tensors
    ``users`` / ``items`` int64 and ``values`` float32 [N], with
    ``num_users``, ``num_items``, ``num_ratings`` and ``draws`` (the draws
    it took)."""
    device = torch.device(device)
    U, I, N = mix["num_users"], mix["num_items"], mix["num_ratings"]
    if N > U * I // 2:
        raise ValueError(f"{N} distinct pairs of {U} x {I}: past half the "
                         "matrix, the draws would not end")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ranks = torch.arange(1, I + 1, dtype=torch.float64, device=device)
    item_cdf = torch.cumsum(ranks ** -float(mix["item_zipf"]), 0)
    item_cdf /= item_cdf[-1].clone()
    user_w = torch.exp(float(mix["user_lognormal_sigma"]) * torch.randn(
        U, generator=gen, device=device, dtype=torch.float64))
    user_cdf = torch.cumsum(user_w, 0)
    user_cdf /= user_cdf[-1].clone()
    keys = torch.empty(0, dtype=torch.int64, device=device)
    want = math.ceil(N * float(mix["draw_factor"]))
    while True:
        users = _draw(gen, user_cdf, want, device)
        items = _draw(gen, item_cdf, want, device)
        keys = torch.cat([keys, users * I + items])
        del users, items
        first = _first_distinct(keys)
        if first.numel() >= N:
            break
        # short: draw the missing pairs again, with the same margin
        want = math.ceil((N - first.numel()) * float(mix["draw_factor"])) \
            + 1024
    draws = keys.numel()
    keys = keys[first[:N]]
    del first
    users, items = keys // I, keys % I
    del keys
    r = int(mix["rank"])
    P = torch.randn((U, r), generator=gen, device=device) / math.sqrt(r)
    Q = torch.randn((I, r), generator=gen, device=device) / math.sqrt(r)
    bu = 0.35 * torch.randn(U, generator=gen, device=device)
    bi = 0.35 * torch.randn(I, generator=gen, device=device)
    noise = float(mix["noise"]) * torch.randn(N, generator=gen,
                                              device=device)
    values = torch.empty(N, dtype=torch.float32, device=device)
    lo, hi, step = (float(x) for x in mix["levels"])
    block = 1 << 24
    for s in range(0, N, block):
        u, i = users[s:s + block], items[s:s + block]
        raw = 3.6 + bu[u] + bi[i] + 1.2 * (P[u] * Q[i]).sum(1) \
            + noise[s:s + block]
        values[s:s + block] = torch.clamp(torch.round(raw / step) * step,
                                          lo, hi)
    return dict(users=users, items=items, values=values, num_users=U,
                num_items=I, num_ratings=N, draws=draws)
