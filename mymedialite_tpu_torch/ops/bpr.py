"""BPR objective, samplers and the minibatch BPR epoch of the port.

Counterparts of ``mymedialite_tpu/ops/bpr.py``: ``bpr_objective`` and
the minibatch epoch (``make_sampler_data``, ``segment_contains``,
``first_negatives``, ``sample_triples``, ``bpr_step``, ``bpr_epoch``)
that the BPR family trains on past the tiled schedule's catalog bound,
where the JAX package runs the same epoch as an XLA scan. On every route
the models draw their fixed convergence-loss sample (reference
``BPRMF.cs:135-150``) with ``sample_triples`` in the uniform-user
regime. The four sampling regimes (reference BPRMF.cs:183-321,
WeightedBPRMF.cs:55-66):

- uniform user: user ~ Uniform(users with 0 < |I_u| < I), positive ~
  Uniform(I_u);
- uniform pair, with replacement: (u, i) ~ Uniform(events);
- uniform pair, without replacement: a per-epoch permutation of the
  events, padded to whole batches (the pad slots weigh 0);
- WBPR: (u, i) ~ Uniform(events), negatives by item popularity.

Negatives: ``trials`` candidates per triple, the first one outside I_u
(one ``torch.searchsorted`` in the sorted user * num_items + item
keys); a triple whose candidates all hit positives weighs 0. Sampling is split from the
update step, so a test can feed the JAX package's triples to
``bpr_step``. Draws come from a ``torch.Generator``, so the port samples
other triples than the JAX package's threefry draws from the same seed;
the regimes are the same. Plain PyTorch: gathers and ``ops/sgd.py
add_rows`` (duplicate ids within a batch sum, on the card to the same
bits in any order, so two runs of one seed give the same tables).

The mesh form (JAX ``ops/bpr.py:246-452``, reference MultiCoreBPRMF):
``make_sampler_data_sharded`` splits the users into one contiguous range
per device, array for array as the JAX package does; each device draws
its triples for its own users (``sample_triples_sharded``), its W rows
are its own, and ``bpr_step_sharded`` merges the devices' item updates
after every minibatch as start + the sum of their touched-row deltas. A
device's j bias reads its own bias after its i updates, as in the JAX
package, so a sharded step is not one ``bpr_step`` over the devices'
concatenated triples.
"""

from __future__ import annotations

import numpy as np
import torch

from mymedialite_tpu_torch.ops.sgd import add_rows


def bpr_objective(params, hp, loss_u, loss_i, loss_j) -> torch.Tensor:
    """BPR-Opt on a fixed triple sample: sum of ln(1 + e^-x) plus the L2
    complexity of the touched rows (JAX ``ops/bpr.py:204``)."""
    wu = params["user_factors"][loss_u]
    hi = params["item_factors"][loss_i]
    hj = params["item_factors"][loss_j]
    bi, bj = params["item_bias"][loss_i], params["item_bias"][loss_j]
    x = bi - bj + (wu * (hi - hj)).sum(dim=-1)
    ranking_loss = torch.log1p(torch.exp(-x)).sum()
    complexity = (hp["reg_u"] * (wu ** 2).sum()
                  + hp["reg_i"] * (hi ** 2).sum()
                  + hp["reg_j"] * (hj ** 2).sum()
                  + hp["bias_reg"] * (bi ** 2).sum()
                  + hp["bias_reg"] * (bj ** 2).sum())
    return ranking_loss + complexity


UNIFORM_USER = 0
UNIFORM_PAIR = 1
UNIFORM_PAIR_WOR = 2   # without replacement: a permutation of the events
WBPR = 3


def make_sampler_data(feedback, num_neg_trials: int = 8, device="cpu"):
    """The sampling state of a PosOnlyData (JAX: ``make_sampler_data``),
    built on ``device`` by one sort of the user * num_items + item keys:
    (tensors, meta). tensors: hist_items [nnz] (each user's items,
    sorted), indptr [U+1], counts [U], valid_users (0 < |I_u| < I; user
    0 when there is none), users / items [events] (the COO pairs) and
    pos_keys [nnz] (the sorted keys), int64. meta: num_items, num_users,
    num_events and num_neg_trials."""
    num_items, num_users = feedback.num_items, feedback.num_users

    def dev(a):
        # int32 across (half the bytes of int64), widened on the device
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
            device).long()
    users, items = dev(feedback.users), dev(feedback.items)
    pos_keys = torch.sort(users * num_items + items).values
    counts = torch.bincount(users, minlength=num_users)
    indptr = torch.zeros(num_users + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(counts, 0)
    valid = torch.nonzero((counts > 0) & (counts < num_items)).flatten()
    if valid.numel() == 0:
        valid = torch.zeros(1, dtype=torch.int64, device=device)
    return dict(hist_items=pos_keys % num_items, indptr=indptr,
                counts=counts, valid_users=valid, users=users, items=items,
                pos_keys=pos_keys), \
        dict(num_items=num_items, num_users=num_users,
             num_events=len(feedback), num_neg_trials=num_neg_trials)


def segment_contains(sampler, users, keys, num_items: int):
    """Is keys[k] among the items of users[k]? One ``torch.searchsorted``
    in the sorted ``pos_keys`` (JAX: ``_segment_contains``, a binary
    search of fixed depth in the user's history); users and keys
    broadcast."""
    pos = sampler["pos_keys"]
    key = users * num_items + keys
    if pos.numel() == 0:
        return torch.zeros_like(key, dtype=torch.bool)
    at = torch.searchsorted(pos, key).clamp(max=pos.numel() - 1)
    return pos[at] == key


def first_negatives(sampler, users, cand, num_items: int):
    """The first of the candidates ``cand`` [T, B] outside each user's
    history, and whether there was one (JAX: ``_sample_negatives`` after
    its draws); with none the first candidate, weight 0."""
    good = ~segment_contains(sampler, users[None, :], cand, num_items)
    first = good.to(torch.uint8).argmax(0, keepdim=True)
    return cand.gather(0, first).squeeze(0), good.any(0)


def negative_candidates(generator, num_items: int, trials: int, n: int,
                        device, pop_cdf=None):
    """[trials, n] candidate negatives: uniform ids, or by popularity
    (the inverse ``pop_cdf`` of uniform draws, clipped to the catalog)."""
    if pop_cdf is None:
        return torch.randint(0, num_items, (trials, n), generator=generator,
                             device=device)
    u01 = torch.rand((trials, n), generator=generator, device=device,
                     dtype=pop_cdf.dtype)
    cand = torch.searchsorted(pop_cdf, u01)
    return cand.clamp(max=num_items - 1)


def sample_triples(generator, sampler, meta, batch_size: int, regime: int,
                   perm=None, batch_index: int = 0, pop_cdf=None):
    """One batch of (u, i, j, w) BPR triples drawn with ``generator`` (a
    generator of the sampler's device); JAX: ``_sample_triples``. The
    without-replacement regime reads its slice of ``perm`` (a permutation
    of the padded event slots) and weighs the pad slots 0."""
    device = sampler["users"].device
    num_items = meta["num_items"]

    def randint(high, n):
        return torch.randint(0, max(int(high), 1), (n,), generator=generator,
                             device=device)
    if regime == UNIFORM_USER:
        valid = sampler["valid_users"]
        u = valid[randint(valid.numel(), batch_size)]
        r = randint(2 ** 31 - 1, batch_size)
        pos_off = r % sampler["counts"][u].clamp(min=1)
        i = sampler["hist_items"][(sampler["indptr"][u] + pos_off).clamp(
            max=max(sampler["hist_items"].numel() - 1, 0))]
        w_base = None
    elif regime in (UNIFORM_PAIR, WBPR):
        eidx = randint(meta["num_events"], batch_size)
        u, i = sampler["users"][eidx], sampler["items"][eidx]
        w_base = None
    else:
        eidx = perm[batch_index * batch_size:(batch_index + 1) * batch_size]
        real = eidx < meta["num_events"]
        eidx = eidx.clamp(max=max(meta["num_events"] - 1, 0))
        u, i = sampler["users"][eidx], sampler["items"][eidx]
        w_base = real
    cand = negative_candidates(
        generator, num_items, meta["num_neg_trials"], batch_size, device,
        pop_cdf if regime == WBPR else None)
    j, ok = first_negatives(sampler, u, cand, num_items)
    w = ok if w_base is None else ok & w_base
    return u, i, j, w.to(torch.float32)


def bpr_step(params, u, i, j, w, hp, *, update_j: bool,
             soft_margin: bool = False, update_u: bool = True,
             update_i: bool = True):
    """One minibatch update of the triples (u, i, j) with weights w, in
    place on params (user_factors [U, f], item_factors [I, f], item_bias
    [I]); JAX: the body of ``bpr_epoch``, and with ``update_u`` /
    ``update_i`` the online retrains' ``BPRMF._pairwise_updates``. Every
    delta reads the rows as they were at the start, so duplicate ids sum.
    The sigmoid gradient of BPR, or the hinge's
    (SoftMarginRankingMF.cs:52-110). As in the JAX package the j bias's
    regularization reads the bias after the i update."""
    W, H, bias = params["user_factors"], params["item_factors"], \
        params["item_bias"]
    dtype = W.dtype
    w = w.to(dtype)
    lr = hp["learn_rate"]
    wu, hi, hj = W[u], H[i], H[j]
    bi = bias[i]
    x_uij = bi - bias[j] + (wu * (hi - hj)).sum(dim=-1)
    if soft_margin:
        g = (x_uij < 1.0).to(dtype) * w
    else:
        g = torch.sigmoid(-x_uij) * w
    if update_u:
        add_rows(W, u, lr * (g[:, None] * (hi - hj)
                             - (w * hp["reg_u"])[:, None] * wu))
    if update_i:
        add_rows(H, i, lr * (g[:, None] * wu
                             - (w * hp["reg_i"])[:, None] * hi))
        add_rows(bias, i, lr * (g - hp["bias_reg"] * w * bi))
    if update_j:
        add_rows(H, j, lr * (-g[:, None] * wu
                             - (w * hp["reg_j"])[:, None] * hj))
        add_rows(bias, j, lr * (-g - hp["bias_reg"] * w * bias[j]))


def epoch_batches(num_events: int, batch_size: int):
    """(batch, num_batches) of one epoch: |events| triples in batches of
    at most ``batch_size`` (JAX: ``BPRMF.iterate``)."""
    batch = min(batch_size, max(num_events, 1))
    return batch, max((num_events + batch - 1) // batch, 1)


def bpr_epoch(params, sampler, meta, generator, hp, pop_cdf=None, *,
              batch_size: int, num_batches: int, regime: int,
              update_j: bool, soft_margin: bool = False):
    """One epoch of ``num_batches`` minibatches of sampled triples, in
    place on params (JAX: ``bpr_epoch``). hp: learn_rate, reg_u, reg_i,
    reg_j, bias_reg. The without-replacement regime draws one
    permutation of the padded event slots per epoch."""
    perm = None
    if regime == UNIFORM_PAIR_WOR:
        perm = torch.randperm(num_batches * batch_size, generator=generator,
                              device=sampler["users"].device)
    for b in range(num_batches):
        u, i, j, w = sample_triples(generator, sampler, meta, batch_size,
                                    regime, perm=perm, batch_index=b,
                                    pop_cdf=pop_cdf)
        bpr_step(params, u, i, j, w, hp, update_j=update_j,
                 soft_margin=soft_margin)


def popularity_cdf(count_by_item, device="cpu") -> torch.Tensor:
    """Cumulative item-popularity distribution (float32) for WBPR
    negatives (JAX: ``popularity_cdf``)."""
    counts = np.asarray(count_by_item, dtype=np.float64)
    total = counts.sum()
    if total == 0:
        counts = np.ones_like(counts)
        total = counts.sum()
    return torch.from_numpy(np.cumsum(counts / total).astype(
        np.float32)).to(device)


def make_sampler_data_sharded(feedback, n_devices: int,
                              num_neg_trials: int = 8):
    """Per-device sampling state, stacked on a leading device axis, as
    the JAX package builds it (``make_sampler_data_sharded``): the users
    split into ``n_devices`` contiguous ranges of u_loc = ceil(U / D)
    users; ragged arrays padded to the longest (histories with zeros,
    valid-user and event lists by cycling their real entries). Returns
    (data, meta): data holds int32 numpy arrays hist_items [D, Lh],
    indptr [D, u_loc + 1], counts [D, u_loc], valid_users [D, Lv],
    valid_count [D], ev_user [D, Le] (device-local user ids), ev_item
    [D, Le], ev_count [D]; meta num_items, num_users, u_loc, e_loc,
    num_events, num_neg_trials and search_depth."""
    csr = feedback.by_user
    counts_g = csr.counts()
    U, I = feedback.num_users, feedback.num_items
    U_loc = max(-(-U // n_devices), 1)
    users_g = np.asarray(feedback.users)
    items_g = np.asarray(feedback.items)
    order = np.argsort(users_g, kind="stable")
    users_s, items_s = users_g[order], items_g[order]
    bounds = np.searchsorted(users_s, np.arange(n_devices + 1) * U_loc)
    hist, indptrs, cnts, valid, ev_u, ev_i = [], [], [], [], [], []
    for d in range(n_devices):
        lo_u, hi_u = d * U_loc, min((d + 1) * U_loc, U)
        n_u = max(hi_u - lo_u, 0)
        cnt = np.zeros(U_loc, dtype=np.int32)
        if n_u > 0:
            cnt[:n_u] = counts_g[lo_u:hi_u]
        indptr = np.zeros(U_loc + 1, dtype=np.int32)
        np.cumsum(cnt, out=indptr[1:])
        seg = csr.keys[csr.indptr[lo_u]:csr.indptr[hi_u]] if n_u > 0 \
            else np.zeros(0, dtype=np.int32)
        hist.append(np.asarray(seg, dtype=np.int32))
        indptrs.append(indptr)
        cnts.append(cnt)
        valid.append(np.nonzero((cnt > 0) & (cnt < I))[0].astype(np.int32))
        lo_e, hi_e = bounds[d], bounds[d + 1]
        ev_u.append((users_s[lo_e:hi_e] - lo_u).astype(np.int32))
        ev_i.append(items_s[lo_e:hi_e].astype(np.int32))

    def stack(arrs, cycle: bool):
        L = max([1] + [a.size for a in arrs])
        out = np.zeros((n_devices, L), dtype=np.int32)
        for d, a in enumerate(arrs):
            if a.size:
                out[d] = np.tile(a, -(-L // a.size))[:L] if cycle else \
                    np.pad(a, (0, L - a.size))
        return out

    max_count = int(counts_g.max()) if counts_g.size else 1
    depth = max(int(np.ceil(np.log2(max(max_count, 1) + 1))) + 1, 1)
    data = dict(
        hist_items=stack(hist, False), indptr=np.stack(indptrs),
        counts=np.stack(cnts), valid_users=stack(valid, True),
        valid_count=np.array([v.size for v in valid], dtype=np.int32),
        ev_user=stack(ev_u, True), ev_item=stack(ev_i, True),
        ev_count=np.array([a.size for a in ev_u], dtype=np.int32))
    meta = dict(num_items=I, num_users=U, u_loc=U_loc,
                e_loc=int(data["ev_user"].shape[1]), num_events=len(feedback),
                num_neg_trials=num_neg_trials, search_depth=depth)
    return data, meta


def device_samplers(mesh, data, meta) -> list:
    """Global device g's row of each ``make_sampler_data_sharded`` array
    (built for ``mesh.global_size`` devices) as int64 tensors on local
    device d = g - ``first_device``, for each device of this process,
    with the sorted keys u_local * num_items + item of its histories
    (``pos_keys``, for ``segment_contains``) and its real valid and
    event counts."""
    I = meta["num_items"]
    out = []
    for d, dev in enumerate(mesh.devices):
        g = mesh.first_device + d
        indptr = data["indptr"][g].astype(np.int64)
        nnz = int(indptr[-1])
        users = np.repeat(np.arange(meta["u_loc"], dtype=np.int64),
                          np.diff(indptr))
        keys = users * I + data["hist_items"][g][:nnz]
        t = {k: torch.from_numpy(np.ascontiguousarray(
            data[k][g], dtype=np.int64)).to(dev) for k in (
            "hist_items", "indptr", "counts", "valid_users", "ev_user",
            "ev_item")}
        t["pos_keys"] = torch.from_numpy(keys).to(dev)
        t["valid_count"] = int(data["valid_count"][g])
        t["ev_count"] = int(data["ev_count"][g])
        out.append(t)
    return out


def sample_triples_sharded(generator, sampler, meta, batch_size: int,
                           regime: int, perm=None, batch_index: int = 0,
                           pop_cdf=None):
    """One batch of (u, i, j, w) triples for one device's users (u
    device-local), drawn with ``generator`` from its ``device_samplers``
    entry, as the JAX package's ``device_fn`` draws them: uniform users
    over the padded valid list, events over the padded event list (or
    its slice ``perm`` of a permutation of num_batches x batch slots,
    taken modulo the real events), weight 0 for pad slots and a device
    without users or events."""
    device = sampler["hist_items"].device
    num_items = meta["num_items"]

    def randint(high, n):
        return torch.randint(0, max(int(high), 1), (n,), generator=generator,
                             device=device)
    if regime == UNIFORM_USER:
        valid, counts = sampler["valid_users"], sampler["counts"]
        u = valid[randint(valid.numel(), batch_size)]
        r = randint(2 ** 31 - 1, batch_size)
        pos_off = r % counts[u].clamp(min=1)
        hist = sampler["hist_items"]
        i = hist[(sampler["indptr"][u] + pos_off).clamp(max=hist.numel() - 1)]
        base = (counts[u] > 0) & (sampler["valid_count"] > 0)
    elif regime == UNIFORM_PAIR_WOR:
        raw = perm[batch_index * batch_size:(batch_index + 1) * batch_size]
        ecount = sampler["ev_count"]
        eidx = raw % max(ecount, 1)
        u, i = sampler["ev_user"][eidx], sampler["ev_item"][eidx]
        base = (raw < ecount) & (ecount > 0)
    else:
        eidx = randint(sampler["ev_user"].numel(), batch_size)
        u, i = sampler["ev_user"][eidx], sampler["ev_item"][eidx]
        base = torch.full_like(u, sampler["ev_count"] > 0, dtype=torch.bool)
    cand = negative_candidates(
        generator, num_items, meta["num_neg_trials"], batch_size, device,
        pop_cdf if regime == WBPR else None)
    j, ok = first_negatives(sampler, u, cand, num_items)
    return u, i, j, (ok & base).to(torch.float32)


def _device_update(W, H, bias, u, i, j, w, hp, *, update_j: bool,
                   soft_margin: bool):
    """One device's part of a sharded step: its W rows in place, and its
    item updates as touched-row deltas against the start tables H and
    bias: (rows, dH [n, f], dbias [n]). The j bias reads the device's
    bias after its i updates (JAX ``device_fn``)."""
    dtype = W.dtype
    w = w.to(dtype)
    lr = hp["learn_rate"]
    wu, hi, hj = W[u], H[i], H[j]
    bi = bias[i]
    x_uij = bi - bias[j] + (wu * (hi - hj)).sum(dim=-1)
    if soft_margin:
        g = (x_uij < 1.0).to(dtype) * w
    else:
        g = torch.sigmoid(-x_uij) * w
    add_rows(W, u, lr * (g[:, None] * (hi - hj)
                         - (w * hp["reg_u"])[:, None] * wu))
    B = i.numel()
    rows, inv = torch.unique(torch.cat([i, j]) if update_j else i,
                             return_inverse=True)
    dH = torch.zeros((rows.numel(), H.shape[1]), dtype=dtype,
                     device=H.device)
    db = torch.zeros(rows.numel(), dtype=dtype, device=H.device)
    add_rows(dH, inv[:B], lr * (g[:, None] * wu
                                - (w * hp["reg_i"])[:, None] * hi))
    add_rows(db, inv[:B], lr * (g - hp["bias_reg"] * w * bi))
    if update_j:
        bj = bias[j] + db[inv[B:]]
        add_rows(dH, inv[B:], lr * (-g[:, None] * wu
                                    - (w * hp["reg_j"])[:, None] * hj))
        add_rows(db, inv[B:], lr * (-g - hp["bias_reg"] * w * bj))
    return rows, dH, db


def bpr_step_sharded(mesh, W_shards, H_reps, bias_reps, triples, hp, *,
                     update_j: bool, soft_margin: bool = False):
    """One sharded minibatch: ``triples[d]`` = (u, i, j, w) of local
    device d (u local to its shard ``W_shards[d]``, updated in place)
    read the start tables ``H_reps[d]`` / ``bias_reps[d]``
    (``Mesh.replicate`` copies); then every global device's touched-row
    deltas are added to each distinct copy in global device order
    (``Mesh.merge_rows``, across the processes too), the JAX package's
    start + psum(deltas). Returns the merged (H_reps, bias_reps)."""
    parts = [_device_update(W_shards[d], H_reps[d], bias_reps[d], *t, hp,
                            update_j=update_j, soft_margin=soft_margin)
             for d, t in enumerate(triples)]
    H_reps = mesh.merge_rows(H_reps, [(r, dH) for r, dH, _ in parts])
    bias_reps = mesh.merge_rows(bias_reps, [(r, db) for r, _, db in parts])
    return H_reps, bias_reps


def sharded_epoch_batches(num_events: int, batch_size: int, D: int):
    """(batch per device, num_batches) of a sharded epoch: |events|
    triples over the mesh (JAX ``MultiCoreBPRMF.iterate``)."""
    events = max(num_events, 1)
    batch = min(batch_size, max(events // D, 1))
    return batch, max((events + D * batch - 1) // (D * batch), 1)


def bpr_epoch_sharded(mesh, params, samplers, meta, generators, hp,
                      pop_cdf=None, *, batch_size: int, num_batches: int,
                      regime: int, update_j: bool, soft_margin: bool = False):
    """One sharded epoch (JAX ``bpr_epoch_sharded``): num_batches steps,
    each device of this process drawing ``batch_size`` triples for its
    own users with its generator (``generators[d]``, one a local device,
    keyed by the caller by the global device) and ``samplers[d]``
    (``device_samplers``); params: user_factors, a list of this
    process's row shards [u_loc, f] (updated in place), item_factors and
    item_bias, tensors updated in place with the merged deltas of every
    process. The without-replacement regime draws one permutation of the
    padded slots per device per epoch. ``pop_cdf``: a list, one per local
    device, for WBPR."""
    H_reps = mesh.replicate(params["item_factors"])
    b_reps = mesh.replicate(params["item_bias"])
    perms = [None] * mesh.size
    if regime == UNIFORM_PAIR_WOR:
        perms = [torch.randperm(num_batches * batch_size, generator=gen,
                                device=dev)
                 for gen, dev in zip(generators, mesh.devices)]
    for b in range(num_batches):
        triples = [sample_triples_sharded(
            generators[d], samplers[d], meta, batch_size, regime,
            perm=perms[d], batch_index=b,
            pop_cdf=pop_cdf[d] if pop_cdf is not None else None)
            for d in range(mesh.size)]
        H_reps, b_reps = bpr_step_sharded(
            mesh, params["user_factors"], H_reps, b_reps, triples, hp,
            update_j=update_j, soft_margin=soft_margin)
    for k, reps in (("item_factors", H_reps), ("item_bias", b_reps)):
        if reps[0] is not params[k]:
            params[k].copy_(reps[0].to(params[k].device))
    return params
