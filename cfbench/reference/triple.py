"""The plain reference of the triple family: BPRMF (Rendle et al., UAI
2009) trained by minibatch SGD over the chunks of
``reference/chunks.py``, negatives drawn as the epoch draws them.

Uniform-user importance weights |events| / (n_valid |I_u|) on the
positive events (weight 1 under uniform pair sampling); per epoch one negative item block per chunk
(``default_rng``), and per slot up to ``num_neg_trials`` candidates, the
first that is not a positive of the slot's user taken (a slot with none
moves nothing), from random bits that a ``torch.Generator`` on the
device draws for the whole epoch. Each chunk is one step: x = <p_u, q_i
- q_j> + b_i - b_j, g = sigmoid(-x) times the weight, every slot's
deltas from the tables as the chunk starts, added with ``index_add_``
(the user rows, then the positives, then the negatives). Tables are
held fused, [p_u | 1] and [q_i | b_i].
"""

from __future__ import annotations

import numpy as np
import torch

from cfbench.reference import chunks as ck
from cfbench.reference import loop

LEAVES = ("user_factors", "item_factors", "item_bias")


def hyper(config: dict) -> dict:
    return config["hyperparameters"]


def route(num_items: int, config: dict) -> str:
    return ck.schedule(num_items, hyper(config)["num_factors"])


def event_weights(users: np.ndarray, num_users: int, num_items: int):
    """Uniform-user importance weight of each event, float32."""
    counts = np.bincount(users, minlength=num_users)
    valid = (counts > 0) & (counts < num_items)
    n_valid = max(int(valid.sum()), 1)
    w_user = np.where(valid, len(users) / (n_valid * np.maximum(counts, 1.0)),
                      0.0)
    return w_user[users].astype(np.float32)


def initial_tables(log: dict, config: dict, seed: int, device, dtype):
    """(W, H) fused [U, k+1] / [I, k+1]: N(init_mean, init_stdev) factors
    from a generator seeded with ``seed`` (users then items), zero item
    biases."""
    hp = hyper(config)
    U, I, k = log["num_users"], log["num_items"], hp["num_factors"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    W = torch.ones((U, k + 1), dtype=torch.float32, device=device)
    W[:, :k] = hp["init_mean"] + hp["init_stdev"] * torch.randn(
        (U, k), generator=gen, device=device)
    H = torch.zeros((I, k + 1), dtype=torch.float32, device=device)
    H[:, :k] = hp["init_mean"] + hp["init_stdev"] * torch.randn(
        (I, k), generator=gen, device=device)
    return W.to(dtype), H.to(dtype)


def column_rates(config: dict, device, dtype):
    """[k+1] each: (w_lr, w_reg, i_lr, i_reg, j_lr, j_reg)."""
    hp = hyper(config)
    k, lr = hp["num_factors"], hp["learn_rate"]
    out = np.zeros((6, k + 1), np.float32)
    out[0, :k], out[1, :k] = lr, hp["reg_u"]
    out[2, :] = lr
    out[3, :k], out[3, k] = hp["reg_i"], hp["bias_reg"]
    if hp["update_j"]:
        out[4, :] = lr
        out[5, :k], out[5, k] = hp["reg_j"], hp["bias_reg"]
    return torch.from_numpy(out).to(device=device, dtype=dtype).unbind(0)


def leaves(W, H) -> dict:
    k = W.shape[1] - 1
    return dict(user_factors=W[:, :k], item_factors=H[:, :k],
                item_bias=H[:, k])


def nvalid_of(ch) -> np.ndarray:
    """The real items of each item block."""
    return (ch.old_of_new.reshape(ch.n_iblocks, ch.item_block) >= 0).sum(1)


def resident_negative_blocks(ch, order, seed: int, num_items: int,
                             epoch: int = 1):
    """(visit order, negative block of each visited chunk) of resident
    epoch ``epoch``: one block a chunk, r % n_ib for r uniform over the
    catalog."""
    rng = np.random.default_rng((seed + 7) * 999_983 + epoch)
    return order, rng.integers(0, max(num_items, 1),
                               ch.num_chunks) % ch.n_iblocks


def tiled_negative_blocks(ch, seed: int, num_items: int, blocks: int,
                          epoch: int = 1):
    """(visit order, negative block of each visited chunk) of slab-tiled
    epoch ``epoch``: one negative slab per (positive slab, user block)
    group, with P(slab) its share of the catalog, then one block a chunk
    within it; chunks sorted by (positive slab, negative slab, user
    block), shuffled within each."""
    rng = np.random.default_rng(ck.epoch_seed(seed, epoch))
    nc, n_ib, n_ub = ch.num_chunks, ch.n_iblocks, ch.n_ublocks
    B = min(blocks, n_ib)
    S = (n_ib + B - 1) // B
    slab_items = np.concatenate([nvalid_of(ch).astype(np.int64),
                                 np.zeros(S * B - n_ib, np.int64)]
                                ).reshape(S, B).sum(1)
    isl = ch.ib // B
    _, inv = np.unique(isl.astype(np.int64) * n_ub + ch.ub,
                       return_inverse=True)
    r = rng.integers(0, max(num_items, 1), int(inv.max()) + 1)
    jsl = ((r % n_ib) // B)[inv]
    r2 = (rng.random(nc) * np.maximum(slab_items[jsl], 1)).astype(np.int64)
    jb = jsl * B + r2 % (np.minimum((jsl + 1) * B, n_ib) - jsl * B)
    order = np.argsort(isl.astype(np.float64) * (2.0 * S * n_ub)
                       + jsl * (2.0 * n_ub) + ch.ub * 2.0 + rng.random(nc),
                       kind="stable")
    return order, jb[order]


def negatives(log: dict, config: dict, ch, order: np.ndarray, jb, seed: int,
              device, positives, epoch: int = 1, block: int = 2048):
    """(j, ok) [nc, C] in visit order: each slot's negative item (old id)
    and whether one of its trials found an item that ``positives`` (the
    sorted keys user * num_items + item the sampler holds as rated) does
    not hold for its user; ``jb`` the visited chunks' negative blocks."""
    hp = hyper(config)
    T, I = hp["num_neg_trials"], log["num_items"]
    nc, C, IB = ch.num_chunks, ch.chunk, ch.item_block
    nval = torch.from_numpy(np.maximum(nvalid_of(ch)[jb], 1)).to(device)
    base = torch.from_numpy(jb * IB).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(ck.epoch_seed(seed, epoch) & 0x7FFFFFFF)
    bits = torch.randint(0, 2 ** 31, (nc, T, C), dtype=torch.int32,
                         generator=gen, device=device)
    users = torch.from_numpy(log["users"]).to(device)
    keys = positives
    old_of_new = torch.from_numpy(ch.old_of_new).to(device)
    rows = ch.rows[torch.from_numpy(order).to(device)]
    j = torch.empty((nc, C), dtype=torch.int64, device=device)
    ok = torch.empty((nc, C), dtype=torch.bool, device=device)
    for s in range(0, nc, block):
        e = min(s + block, nc)
        cand = (bits[s:e].long() & 0x7FFFFFFF) % nval[s:e, None, None]
        item = old_of_new[base[s:e, None, None] + cand]     # [b, T, C]
        q = users[rows[s:e].clamp(min=0)][:, None, :] * I + item
        at = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
        good = keys[at] != q
        first = good.to(torch.uint8).argmax(1, keepdim=True)
        j[s:e] = item.gather(1, first).squeeze(1)
        ok[s:e] = good.any(1)
    return j, ok


def capped_positives(log: dict, ch, device, cap: int = 256):
    """The positives that the slab-tiled sampler holds, as sorted keys
    user * num_items + item: in each (user block, item block) cell the
    events split into 8 sub-buckets by user slot & 7, each keeping its
    ``cap`` smallest keys (slot * IB + item slot), the cap doubled (up to
    the largest sub-bucket) until the expected share of triples whose
    negative is a dropped positive is at most 1e-3."""
    users, I = log["users"], log["num_items"]
    UB, IB, n_ib = ch.user_block, ch.item_block, ch.n_iblocks
    i_new = ch.new_of_old[log["items"]]
    key = (users % UB) * IB + i_new % IB
    sub = ((users // UB) * n_ib + i_new // IB) * 8 + (users % UB) % 8
    order = np.lexsort((key, sub))
    sub_s = sub[order]
    cnt = np.bincount(sub_s)
    rank = np.arange(sub_s.size) - np.concatenate([[0], np.cumsum(cnt)])[sub_s]
    kmax = ck._round_up(max(int(cnt.max()), 1), 128)
    ksub = min(kmax, ck._round_up(cap, 128))
    counts = np.bincount(users, minlength=log["num_users"]).astype(np.float64)
    while True:
        dropped = order[rank >= ksub]
        du = np.bincount(users[dropped], minlength=log["num_users"])
        corrupt = float((counts * du).sum()) / (max(users.size, 1) * max(I, 1))
        if corrupt <= 1e-3 or ksub >= kmax:
            break
        ksub = min(ksub * 2, kmax)
    kept = order[rank < ksub]
    keys = torch.from_numpy(users[kept].astype(np.int64) * I
                            + log["items"][kept]).to(device)
    return torch.sort(keys)[0]


def fused(tables: dict, dtype):
    """(W, H) fused from the three leaves."""
    P, Q = tables["user_factors"], tables["item_factors"]
    k = P.shape[1]
    W = torch.ones((P.shape[0], k + 1), dtype=torch.float32,
                   device=P.device)
    W[:, :k] = P
    H = torch.empty((Q.shape[0], k + 1), dtype=torch.float32,
                    device=Q.device)
    H[:, :k], H[:, k] = Q, tables["item_bias"]
    return W.to(dtype), H.to(dtype)


def prepare(log: dict, config: dict, seed: int, device) -> dict:
    """What every epoch of the model shares: its chunks, the positives
    its sampler holds and the events' weights."""
    device = torch.device(device)
    hp = hyper(config)
    tiled = route(log["num_items"], config) == "tiled"
    I = log["num_items"]
    # tiled: the histogram-optimal chunk at 256 slots of fixed cost a
    # chunk, slabs of half the rating schedule's blocks
    ch = ck.make_chunks(log["users"], log["items"], log["num_users"], I,
                        chunk=None if tiled else 640,
                        chunk_overhead=256 if tiled else 0,
                        shuffle_seed=seed, device=device)
    if tiled:
        positives = capped_positives(log, ch, device)
    else:
        positives = torch.sort(
            torch.from_numpy(log["users"]).to(device) * I
            + torch.from_numpy(log["items"]).to(device))[0]
    weights = torch.from_numpy(event_weights(
        log["users"], log["num_users"], log["num_items"])
        if hp["uniform_user_sampling"] else
        np.ones(log["users"].size, np.float32)).to(device)
    return {"tiled": tiled, "chunks": ch, "positives": positives,
            "weights": weights}


def epoch(log: dict, config: dict, seed: int, device, prep: dict, *,
              epoch: int = 1, tables=None, dtype=torch.float32,
              fault: str = ""):
    """Epoch ``epoch`` in ``dtype``, ready for ``loop.run_many``, from
    ``tables`` or the initial tables; ``fault`` "half" as in
    ``reference/rating.py``."""
    device = torch.device(device)
    hp = hyper(config)
    W, H = (initial_tables(log, config, seed, device, dtype)
            if tables is None else fused(tables, dtype))
    start = {n: t.float().clone() for n, t in leaves(W, H).items()}
    I = log["num_items"]
    ch = prep["chunks"]
    if prep["tiled"]:
        order, jb = tiled_negative_blocks(
            ch, seed, I, max(ck.slab_blocks(hp["num_factors"]) // 2, 1),
            epoch)
    else:
        order, jb = resident_negative_blocks(
            ch, ck.resident_order(ch, ck.epoch_seed(seed, epoch)), seed, I,
            epoch)
    negs, ok = negatives(log, config, ch, order, jb, seed, device,
                         prep["positives"], epoch)
    rows = ch.rows[torch.from_numpy(order).to(device)]
    weights = prep["weights"]
    wt = torch.where(rows >= 0, weights[rows.clamp(min=0)], 0.0)
    wt = (wt * ok).to(dtype)
    del ok
    if fault == "half":
        wt[:, 1::2] = 0
        wt *= 2
    rows.clamp_(min=0)
    users = torch.from_numpy(log["users"]).to(device)[rows]
    items = torch.from_numpy(log["items"]).to(device)[rows]
    del rows
    w_lr, w_reg, i_lr, i_reg, j_lr, j_reg = column_rates(config, device,
                                                         dtype)

    def step(u, i, j, w):
        wu, hi, hj = W[u], H[i], H[j]
        d = hi - hj
        g = (torch.sigmoid(-(wu * d).sum(1)) * w)[:, None]
        w = w[:, None]
        W.index_add_(0, u, w_lr * (g * d - w * w_reg * wu))
        H.index_add_(0, i, i_lr * (g * wu - w * i_reg * hi))
        H.index_add_(0, j, j_lr * (-g * wu - w * j_reg * hj))

    return loop.Epoch(start, step, (users, items, negs, wt),
                      lambda: {n: t.float() for n, t in leaves(W, H).items()})


def loss(tables: dict, log: dict, device, sample: int = 1 << 20,
         seed: int = 0) -> float:
    """BPR's loss, the mean of softplus(-x_uij), over a fixed sample of
    triples: positive events drawn from the log and items drawn
    uniformly, both by ``default_rng(seed)``; float64 sums."""
    rng = np.random.default_rng(seed)
    n, I = log["users"].size, log["num_items"]
    rows = rng.integers(0, n, min(sample, n))
    u = torch.from_numpy(log["users"][rows]).to(device)
    i = torch.from_numpy(log["items"][rows]).to(device)
    j = torch.from_numpy(rng.integers(0, I, rows.size)).to(device)
    P, Q, b = (tables[k] for k in LEAVES)
    x = (P[u] * (Q[i] - Q[j])).sum(1) + b[i] - b[j]
    return float(torch.nn.functional.softplus(-x.double()).mean())
