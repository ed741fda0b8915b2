"""Loss ids, the fused-table layout and the training objective of the
matrix-factorization family.

Port of ``mymedialite_tpu/ops/sgd.py``: ``_gradient_common``
(reference SetupLoss, BiasedMatrixFactorization.cs:246-261),
``extend_tables`` / ``split_tables``, ``mf_objective`` (reference
ComputeObjective, BiasedMatrixFactorization.cs:515-552), which the bold
driver reads, and the blocked minibatch epoch (``prepare_blocked_data``,
``column_rates``, ``sgd_epoch_blocked``) that the MF family runs with
frequency regularization and past the tiled schedule's catalog bound.
The blocked epoch is plain PyTorch (gathers and ``add_rows``, a
scatter-add whose sums do not depend on their order): the JAX package
runs it as an XLA scan, with no Pallas kernel.

``sgd_epoch_blocked_sharded`` is its mesh form (JAX ``ops/sgd.py:
428-532``): the user groups split over the devices, each device's
groups in one contiguous range (a process's range of a mesh of several
processes), the item table merged after every group step as start +
the sum of the devices' deltas, across the processes too.

The flat epoch (JAX ``ops/sgd.py:48-200``: ``prepare_epoch_data``, its
per-batch dedup structures, ``sgd_epoch``) is a pass over the ratings
shuffled once, in minibatches visited in a given order; each minibatch
segment-sums its per-example updates by row and adds them once per
distinct row. ``sgd_epoch_sharded_flat`` is its data-parallel mesh form
(the JAX dry run's flat epoch under XLA's SPMD partitioner): each batch
split into one equal part a global device, the parts' deltas merged in
global device order before the next batch. No model calls either, as in
the JAX package (its MF models read only the layout, for the objective).
"""

from __future__ import annotations

import numpy as np
import torch

# Loss ids (reference OptimizationTarget enum, BiasedMatrixFactorization)
LOSS_RMSE = 0
LOSS_MAE = 1
LOSS_LOGISTIC = 2


def gradient_common(loss: int, err, sig, rating_range):
    """The per-example common gradient factor of the biased model."""
    if loss == LOSS_RMSE:
        return err * sig * (1.0 - sig) * rating_range
    if loss == LOSS_MAE:
        return torch.sign(err) * sig * (1.0 - sig) * rating_range
    if loss == LOSS_LOGISTIC:
        return err
    raise ValueError(f"unknown loss {loss}")


def _f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def extend_tables(user_factors, item_factors, user_bias=None, item_bias=None,
                  group_users: int = 16_384, device=None):
    """Build the fused [factors | b_u | 1] x [factors | 1 | b_i] tables
    from arrays or tensors, on ``device`` (default: where
    ``user_factors`` lies). The user table is padded to a multiple of
    group_users (the JAX package's std layout, kept so that tables pass
    between the two packages unchanged)."""
    W = _f32(user_factors, device)
    H = _f32(item_factors, W.device)
    U, f = W.shape
    G = min(group_users, max(U, 1))
    U_pad = max((U + G - 1) // G, 1) * G
    We = torch.zeros((U_pad, f + 2), dtype=torch.float32, device=W.device)
    We[:U, :f] = W
    if user_bias is not None:
        We[:U, f] = _f32(user_bias, W.device)
    We[:, f + 1] = 1.0
    He = torch.zeros((H.shape[0], f + 2), dtype=torch.float32,
                     device=W.device)
    He[:, :f] = H
    He[:, f] = 1.0
    if item_bias is not None:
        He[:, f + 1] = _f32(item_bias, W.device)
    return We, He


def split_tables(W_ext, H_ext, num_users: int):
    """Inverse of extend_tables; numpy (wu, hi, bu, bi)."""
    We = W_ext.detach().cpu().numpy()[:num_users]
    He = H_ext.detach().cpu().numpy()
    f = We.shape[1] - 2
    return We[:, :f], He[:, :f], We[:, f], He[:, f + 1]


def mf_objective(params: dict, data: dict, hp: dict, counts: dict, *,
                 loss: int, biased: bool,
                 frequency_regularization: bool = False) -> torch.Tensor:
    """Training objective = loss sum + count-weighted L2 complexity
    (reg / sqrt(count) per entity with frequency regularization, 0 for
    entities without ratings).

    params: user_factors [U, f], item_factors [I, f], global_bias, and
    if biased user_bias [U], item_bias [I]. data: users, items, values
    (every rating once). hp: min_rating, rating_range, reg_u, reg_i,
    bias_reg. counts: count_user [U], count_item [I]."""
    u, i, v = data["users"], data["items"], data["values"]
    wu = params["user_factors"][u]
    hi = params["item_factors"][i]
    dot = (wu * hi).sum(dim=-1)
    if biased:
        score = params["global_bias"] + params["user_bias"][u] + \
            params["item_bias"][i] + dot
        pred = hp["min_rating"] + torch.sigmoid(score) * hp["rating_range"]
    else:
        pred = params["global_bias"] + dot

    if loss == LOSS_RMSE:
        loss_sum = ((v - pred) ** 2).sum()
    elif loss == LOSS_MAE:
        loss_sum = (v - pred).abs().sum()
    else:  # logistic, on [0,1]-normalized values
        a = (v - hp["min_rating"]) / hp["rating_range"]
        p01 = ((pred - hp["min_rating"]) / hp["rating_range"]).clamp(
            1e-15, 1 - 1e-15)
        loss_sum = -(a * torch.log(p01) + (1 - a) * torch.log1p(-p01)).sum()

    cu = counts["count_user"].to(torch.float32)
    ci = counts["count_item"].to(torch.float32)
    if frequency_regularization:
        zero = torch.zeros((), dtype=torch.float32, device=cu.device)
        wu_reg = torch.where(cu > 0, hp["reg_u"] / cu.clamp(min=1.0).sqrt(),
                             zero)
        wi_reg = torch.where(ci > 0, hp["reg_i"] / ci.clamp(min=1.0).sqrt(),
                             zero)
    else:
        wu_reg = cu * hp["reg_u"]
        wi_reg = ci * hp["reg_i"]
    complexity = (wu_reg * (params["user_factors"] ** 2).sum(-1)).sum()
    complexity = complexity + \
        (wi_reg * (params["item_factors"] ** 2).sum(-1)).sum()
    if biased:
        complexity = complexity + \
            (wu_reg * hp["bias_reg"] * params["user_bias"] ** 2).sum()
        complexity = complexity + \
            (wi_reg * hp["bias_reg"] * params["item_bias"] ** 2).sum()
    return loss_sum + complexity


# ---------------------------------------------------------------------------
# the blocked epoch (JAX: ``sgd_epoch_blocked``)
# ---------------------------------------------------------------------------
#
# The route of the MF family where the chunk kernels do not go: frequency
# regularization (per-entity rates, which the kernels' per-column rates
# cannot express) and catalogs past the tiled schedule's MAX_SLABS. Ratings
# are grouped by contiguous user-id ranges of ``group_users`` rows, shuffled
# once within the groups; an epoch walks the groups in order and each
# group's minibatches in a per-epoch permuted order. A minibatch gathers
# its user and item rows, computes the loss gradient and scatter-adds into
# both tables (``add_rows``: duplicate ids within a batch sum).


def add_rows(table, ids, delta):
    """``table.index_add_(0, ids, delta)`` with a result that does not
    depend on the order of the sum, so that two runs of one seed give the
    same bits: on the CPU ``index_add_`` itself (it adds the batch in
    order), elsewhere ``exact_add``, where CUDA's float ``index_add_``
    adds by atomics in whatever order its threads run. Every plain
    training route of the port scatters through it. Duplicate ids sum.
    In place; returns ``table``."""
    if table.device.type == "cpu":
        return table.index_add_(0, ids, delta)
    return exact_add(table, ids, delta)


def exact_add(table, ids, delta):
    """The scatter-add of ``add_rows`` as an exact sum: the deltas scaled
    by 2**e into int64 fixed point (rounded to a multiple of 2**-e, e the
    largest integer, at most 100, that keeps the batch's largest |delta|
    times its slots under 2**61), summed per distinct row by integer
    additions, which give the same bits in any order, and rounded once
    back to the table's dtype. Non-finite deltas make every row the batch
    touches non-finite. In place; returns ``table``.

    On CUDA tensors it launches ``csrc/exact_add.cu`` (float32 or
    float64 tables, contiguous, int32 or int64 ids, kept int64 in the
    kernel) or raises; on CPU tensors it runs
    ``exact_add_reference``, the torch composition the kernel equals bit
    for bit. It counts its own launches."""
    if table.device.type == "cpu":
        return exact_add_reference(table, ids, delta)
    _launch_exact_add(table, ids, delta)
    exact_add.launches += 1
    return table


def exact_add_reference(table, ids, delta):
    """The plain version of ``exact_add``: ``torch.unique``, the scale
    from the batch's largest |delta|, an int64 ``index_add_`` and one
    rounding back, on any device."""
    if delta.numel() == 0:
        return table
    rows, inv = torch.unique(ids.long(), return_inverse=True)
    top = delta.abs().max().double()
    e = torch.clamp(torch.floor(61.0 - torch.log2(top * ids.numel())),
                    max=100.0)
    scale = torch.exp2(e).to(delta.dtype)
    fixed = torch.round(delta * scale).to(torch.int64)
    sums = torch.zeros((rows.numel(),) + tuple(delta.shape[1:]),
                       dtype=torch.int64, device=delta.device)
    sums.index_add_(0, inv, fixed)
    back = sums.to(delta.dtype) / scale
    back = torch.where(torch.isfinite(top), back, top.to(delta.dtype))
    return table.index_add_(0, rows, back)


def _launch_exact_add(table, ids, delta):
    """Launch mml_exact_add on the table's stream."""
    if table.device.type != "cuda":
        raise ValueError(f"exact_add: no kernel for device {table.device}")
    if table.dtype not in (torch.float32, torch.float64) \
            or delta.dtype != table.dtype:
        raise TypeError("exact_add: the kernel takes float32 or float64 "
                        "tables and deltas of the same type, got "
                        f"{table.dtype} and {delta.dtype}")
    if ids.dtype not in (torch.int32, torch.int64) or ids.dim() != 1:
        raise TypeError("exact_add: ids must be 1-D int32 or int64")
    if not table.is_contiguous():
        raise ValueError("exact_add: the table must be contiguous")
    n = ids.numel()
    if delta.shape[0] != n or tuple(delta.shape[1:]) != \
            tuple(table.shape[1:]):
        raise ValueError(f"exact_add: delta {tuple(delta.shape)} does not "
                         f"match ids [{n}] and table {tuple(table.shape)}")
    if delta.device != table.device or ids.device != table.device:
        raise ValueError("exact_add: table, ids and delta on one device")
    if n == 0:
        return
    d = delta[0].numel()
    cap = 1 << max(1, (2 * n - 1).bit_length())
    if cap >= 1 << 31 or n * d >= 1 << 62:
        raise ValueError(f"exact_add: batch of {n} x {d} past the kernel")
    ids, delta = ids.contiguous(), delta.contiguous()
    from mymedialite_tpu_torch.ops._build import load_library
    fn = load_library().lib.mml_exact_add
    # meta [2], the sums [n, d], the keys [cap] and rows [n] as int64, then
    # dense_of [cap] and slot_of [n] as int32
    work = torch.empty(2 + n * d + cap + n + (cap + n + 1) // 2,
                       dtype=torch.int64, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), ids.data_ptr(), delta.data_ptr(),
                 work.data_ptr(), table.shape[0], n, d, cap,
                 int(ids.dtype == torch.int64),
                 int(table.dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError(f"exact_add: kernel launch failed, CUDA error "
                           f"{err}")


exact_add.launches = 0


def pad_to_batches(n: int, batch_size: int) -> int:
    return ((max(n, 1) + batch_size - 1) // batch_size) * batch_size


def prepare_blocked_data(users, items, values, num_users: int,
                         batch_size: int, group_users: int = 16_384,
                         shuffle_seed=0, device="cpu"):
    """The JAX package's grouped layout (``prepare_blocked_data``): the
    ratings shuffled once with ``numpy.random.default_rng(shuffle_seed)``,
    stably sorted by user group, each group's row padded to ``l_pad``
    slots (a multiple of the batch). Returns (data, meta): data holds gu
    (group-local user ids), gi, gv, gw [ngroups, l_pad] tensors on
    ``device`` and ``count`` [ngroups] (numpy) the real slots of each
    group; meta holds ngroups, group_users, batch and l_pad."""
    n = len(users)
    users = np.asarray(users, dtype=np.int32)
    items = np.asarray(items, dtype=np.int32)
    values = np.asarray(values, dtype=np.float32)
    if shuffle_seed is not None and n > 1:
        perm = np.random.default_rng(shuffle_seed).permutation(n)
        users, items, values = users[perm], items[perm], values[perm]
    G = min(group_users, max(num_users, 1))
    ngroups = max((num_users + G - 1) // G, 1)
    group_of = users // G
    order = np.argsort(group_of, kind="stable")
    users, items, values = users[order], items[order], values[order]
    counts = np.bincount(group_of, minlength=ngroups)
    B = min(batch_size, pad_to_batches(int(counts.max()), 1))
    Lpad = pad_to_batches(int(counts.max()), B)
    slot = np.arange(n) - np.repeat(np.concatenate(
        [[0], np.cumsum(counts)[:-1]]), counts)
    g = np.repeat(np.arange(ngroups), counts)
    gu = np.zeros((ngroups, Lpad), np.int32)
    gi = np.zeros((ngroups, Lpad), np.int32)
    gv = np.zeros((ngroups, Lpad), np.float32)
    gw = np.zeros((ngroups, Lpad), np.float32)
    gu[g, slot] = users - g * G
    gi[g, slot] = items
    gv[g, slot] = values
    gw[g, slot] = 1.0

    def dev(a):
        return torch.from_numpy(a).to(device)
    data = dict(gu=dev(gu), gi=dev(gi), gv=dev(gv), gw=dev(gw),
                count=counts.astype(np.int64))
    return data, dict(ngroups=ngroups, group_users=G, batch=B, l_pad=Lpad)


def column_rates(num_factors: int, learn_rate, reg_u, reg_i, bias_learn_rate,
                 bias_reg, biased: bool, update_user: bool, update_item: bool,
                 device="cpu"):
    """(w_lr, w_reg, h_lr, h_reg): per-column learn-rate and
    regularization vectors [f+2] of the fused std tables; the constant
    columns (and a frozen side) get rate 0 (JAX: ``column_rates``)."""
    f = num_factors
    lr, blr = float(learn_rate), float(bias_learn_rate)
    w_lr = np.array([lr] * f + [blr * lr if biased else 0.0, 0.0], np.float32)
    h_lr = np.array([lr] * f + [0.0, blr * lr if biased else 0.0], np.float32)
    w_reg = np.array([float(reg_u)] * f +
                     [float(bias_reg) * float(reg_u) if biased else 0.0, 0.0],
                     np.float32)
    h_reg = np.array([float(reg_i)] * f +
                     [0.0, float(bias_reg) * float(reg_i) if biased else 0.0],
                     np.float32)
    if not update_user:
        w_lr[:] = 0.0
    if not update_item:
        h_lr[:] = 0.0
    return tuple(torch.from_numpy(a).to(device)
                 for a in (w_lr, w_reg, h_lr, h_reg))


def blocked_freq(count_by_user, count_by_item, rows: int, device="cpu"):
    """(1/sqrt(count per user) on ``rows`` rows, 1/sqrt(count per item)),
    counts below 1 taken as 1: the per-entity rate factors of frequency
    regularization (JAX: ``MatrixFactorization._prepare_epoch_data``)."""
    cu = np.zeros(rows, np.float32)
    cu[:len(count_by_user)] = count_by_user
    ci = np.maximum(np.asarray(count_by_item), 1).astype(np.float32)
    return (torch.from_numpy(1.0 / np.sqrt(np.maximum(cu, 1.0))).to(device),
            torch.from_numpy(1.0 / np.sqrt(ci)).to(device))


def real_batches(count: int, batch: int) -> int:
    """How many batches of a group hold at least one real rating; the
    rest are all padding."""
    return (int(count) + batch - 1) // batch


def sgd_epoch_blocked(W_ext, H_ext, data, batch_orders, hp, rates,
                      freq=None, *, meta, loss: int, biased: bool,
                      groups=None):
    """One blocked pass, in place on the fused std tables ``W_ext``
    [ngroups * group_users, f+2] and ``H_ext`` [I, f+2] (JAX:
    ``sgd_epoch_blocked``). ``batch_orders`` [ngroups, nb] holds each
    group's batch permutation (the model draws it; the JAX package's is
    ``jax.random.permutation(fold_in(key, g), nb)``); the batches past a
    group's ratings are all padding and skipped, which changes no number.
    hp: (global_bias, min_rating, rating_range). rates: ``column_rates``
    at the current learn rate. freq: ``blocked_freq`` with frequency
    regularization, else None. ``groups`` (default all) runs a subset of
    the groups, in the order given. Computes in the tables' dtype."""
    G = meta["group_users"]
    orders = batch_orders.tolist() if isinstance(batch_orders, torch.Tensor) \
        else [list(o) for o in batch_orders]
    if groups is None:
        groups = range(meta["ngroups"])
    for g in groups:
        _blocked_group(W_ext[g * G:(g + 1) * G], H_ext, data, g, orders[g],
                       hp, rates, None if freq is None else
                       (freq[0][g * G:(g + 1) * G], freq[1]),
                       batch=meta["batch"], loss=loss, biased=biased)
    return W_ext, H_ext


def _blocked_group(slab, H_ext, data, g: int, order, hp, rates, freq, *,
                   batch: int, loss: int, biased: bool):
    """Group g of ``data``: its batches in ``order``, each one minibatch
    step on the user ``slab`` (its G rows) and ``H_ext``, in place.
    ``freq``: (the slab's users' rate factors, the items'), or None."""
    B = batch
    dtype = slab.dtype
    w_lr, w_reg, h_lr, h_reg = (r.to(dtype) for r in rates)
    global_bias, min_rating, rating_range = hp
    nreal = real_batches(data["count"][g], B)
    for b in order:
        if b >= nreal:
            continue
        sl = slice(b * B, (b + 1) * B)
        u = data["gu"][g, sl]
        i = data["gi"][g, sl]
        v = data["gv"][g, sl].to(dtype)
        w = data["gw"][g, sl].to(dtype)
        wu = slab.index_select(0, u)
        hi = H_ext.index_select(0, i)
        score = (wu * hi).sum(dim=-1)   # includes b_u + b_i
        if biased:
            sig = torch.sigmoid(score + global_bias)
            pred = min_rating + sig * rating_range
            g_com = gradient_common(loss, v - pred, sig, rating_range) * w
        else:
            g_com = (v - (score + global_bias)) * w
        if freq is not None:
            ru = freq[0].to(dtype)[u.long()] * w
            ri = freq[1].to(dtype)[i] * w
        else:
            ru = ri = w
        add_rows(slab, u, w_lr * (
            g_com[:, None] * hi - (w * ru)[:, None] * w_reg * wu))
        add_rows(H_ext, i, h_lr * (
            g_com[:, None] * wu - (w * ri)[:, None] * h_reg * hi))


def sgd_epoch_blocked_sharded(mesh, W_ext, H_ext, data, batch_orders, hp,
                              rates, freq=None, *, meta, loss: int,
                              biased: bool):
    """One blocked pass over the mesh (JAX ``sgd_epoch_blocked_sharded``).

    ``data``: this process's groups (``prepare_blocked_data``'s arrays,
    ``count`` included; all groups in one process), a multiple of its
    devices; device d runs groups [d * gl, (d + 1) * gl) of them. W_ext:
    the matching rows [groups * G, f+2], a tensor or the devices' row
    shards (``Mesh.split_local``), updated in place; H_ext [I, f+2] the
    replicated item table, updated in place. Local step g runs every
    device's g-th group from the same H on a private copy of it; the
    copies merge as start + the sum of the deltas over the devices and
    the processes. ``batch_orders`` [gl, nb]: the batch permutation of
    each device's g-th group, the same on every device (the JAX package
    draws it from ``fold_in(key, g)`` with the local g). With frequency
    regularization a user's factor is read at its global row (the JAX
    package reads ``inv_cu`` at the slab-relative row, a fault of its
    own that this port does not copy). Returns (W_ext, H_ext)."""
    G = meta["group_users"]
    D = mesh.size
    groups = data["gu"].shape[0]
    if groups % D:
        raise ValueError("the groups must be a multiple of the device "
                         "count (pad with empty groups)")
    gl = groups // D
    shards = W_ext if isinstance(W_ext, (list, tuple)) else \
        mesh.split_local(W_ext)
    orders = batch_orders.tolist() if isinstance(batch_orders, torch.Tensor) \
        else [list(o) for o in batch_orders]
    local = [{k: data[k][d * gl:(d + 1) * gl].to(dev) if k != "count"
              else data[k][d * gl:(d + 1) * gl] for k in data}
             for d, dev in enumerate(mesh.devices)]
    dev_rates = [tuple(r.to(dev) for r in rates) for dev in mesh.devices]
    home = H_ext
    reps = mesh.replicate(H_ext)
    for g in range(gl):
        private = []
        for d, dev in enumerate(mesh.devices):
            H_d = reps[d].clone()
            f = None
            if freq is not None:
                row = ((mesh.first_device + d) * gl + g) * G
                f = (freq[0][row:row + G].to(dev), freq[1].to(dev))
            _blocked_group(shards[d][g * G:(g + 1) * G], H_d, local[d], g,
                           orders[g], hp, dev_rates[d], f,
                           batch=meta["batch"], loss=loss, biased=biased)
            private.append(H_d)
        reps = mesh.merge_deltas(reps[0], private)
    home.copy_(reps[0].to(home.device))
    if not isinstance(W_ext, (list, tuple)):
        W_ext.copy_(torch.cat([s.to(W_ext.device) for s in shards]))
    return W_ext, home


# ---------------------------------------------------------------------------
# the flat epoch (JAX: ``prepare_epoch_data`` / ``sgd_epoch``)
# ---------------------------------------------------------------------------


def _dedup_per_batch(ids: np.ndarray, batch_size: int, num_rows: int):
    """Per batch: the sorted unique target rows, padded with
    out-of-range sentinels (num_rows, num_rows + 1, ...; dropped by the
    scatter), and each example's slot among them (JAX
    ``_dedup_per_batch``)."""
    n = ids.shape[0]
    slots = np.empty(n, dtype=np.int32)
    unique_ids = np.empty(n, dtype=np.int32)
    for b in range(n // batch_size):
        s = slice(b * batch_size, (b + 1) * batch_size)
        uniq, inv = np.unique(ids[s], return_inverse=True)
        k = uniq.shape[0]
        slots[s] = inv
        unique_ids[s][:k] = uniq
        unique_ids[s][k:] = num_rows + np.arange(batch_size - k)
    return slots, unique_ids


def prepare_epoch_data(users, items, values, batch_size: int,
                       shuffle_seed=0, num_users=None, num_items=None,
                       device="cpu") -> dict:
    """The flat layout (JAX ``prepare_epoch_data``): the ratings shuffled
    once with ``numpy.random.default_rng(shuffle_seed)``, padded with
    weight-0 entries to a multiple of the batch, and each batch's dedup
    structures. Returns int32 / float32 tensors on ``device``: users,
    items, values, weights, user_slot, user_uniq, item_slot, item_uniq."""
    n = len(users)
    users = np.asarray(users, dtype=np.int32)
    items = np.asarray(items, dtype=np.int32)
    values = np.asarray(values, dtype=np.float32)
    if shuffle_seed is not None and n > 1:
        perm = np.random.default_rng(shuffle_seed).permutation(n)
        users, items, values = users[perm], items[perm], values[perm]
    pad = pad_to_batches(n, batch_size) - n
    users = np.concatenate([users, np.zeros(pad, np.int32)])
    items = np.concatenate([items, np.zeros(pad, np.int32)])
    values = np.concatenate([values, np.zeros(pad, np.float32)])
    weights = np.concatenate([np.ones(n, np.float32),
                              np.zeros(pad, np.float32)])
    U = num_users if num_users is not None else int(users.max()) + 1
    I = num_items if num_items is not None else int(items.max()) + 1
    u_slot, u_uniq = _dedup_per_batch(users, batch_size, U)
    i_slot, i_uniq = _dedup_per_batch(items, batch_size, I)
    arrays = dict(users=users, items=items, values=values, weights=weights,
                  user_slot=u_slot, user_uniq=u_uniq, item_slot=i_slot,
                  item_uniq=i_uniq)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _flat_deltas(W, H, u, i, v, w, hp, inv_u, inv_i, *, loss: int,
                 biased: bool):
    """The per-example updates of one minibatch (JAX ``sgd_epoch``'s
    ``batch_step``) from the user rows W [U, f(+1)] and item rows H [I,
    f(+1)], the bias in the last column where ``biased``: (dW, dH), each
    [B, f(+1)], the learn rate applied."""
    lr = hp["learn_rate"]
    wu, hi = W[u], H[i]
    f = wu.shape[1] - 1 if biased else wu.shape[1]
    dot = (wu[:, :f] * hi[:, :f]).sum(dim=-1)
    if biased:
        bu, bi = wu[:, f], hi[:, f]
        sig = torch.sigmoid(hp["global_bias"] + bu + bi + dot)
        pred = hp["min_rating"] + sig * hp["rating_range"]
        g = gradient_common(loss, v - pred, sig, hp["rating_range"]) * w
    else:
        g = (v - (hp["global_bias"] + dot)) * w
    reg_u = hp["reg_u"] * inv_u[u] if inv_u is not None else \
        torch.full_like(g, hp["reg_u"])
    reg_i = hp["reg_i"] * inv_i[i] if inv_i is not None else \
        torch.full_like(g, hp["reg_i"])
    dW = lr * (g[:, None] * hi[:, :f] - (w * reg_u)[:, None] * wu[:, :f])
    dH = lr * (g[:, None] * wu[:, :f] - (w * reg_i)[:, None] * hi[:, :f])
    if biased:
        blr = hp["bias_learn_rate"] * lr
        dW = torch.cat([dW, (blr * (g - hp["bias_reg"] * reg_u * w * bu))
                        [:, None]], 1)
        dH = torch.cat([dH, (blr * (g - hp["bias_reg"] * reg_i * w * bi))
                        [:, None]], 1)
    return dW, dH


def _fused(params: dict, biased: bool):
    """(W, H): the factor tables with the biases as a last column."""
    if not biased:
        return params["user_factors"].clone(), params["item_factors"].clone()
    return (torch.cat([params["user_factors"],
                       params["user_bias"][:, None]], 1),
            torch.cat([params["item_factors"],
                       params["item_bias"][:, None]], 1))


def _unfuse(params: dict, W, H, biased: bool):
    """Write the fused tables back into ``params``, in place."""
    f = params["user_factors"].shape[1]
    params["user_factors"].copy_(W[:, :f])
    params["item_factors"].copy_(H[:, :f])
    if biased:
        params["user_bias"].copy_(W[:, f])
        params["item_bias"].copy_(H[:, f])
    return params


def sgd_epoch(params, data, batch_order, hp, *, batch_size: int, loss: int,
              biased: bool, update_user: bool, update_item: bool,
              frequency_regularization: bool):
    """One pass over the pre-shuffled ratings, in place on ``params``
    (JAX ``sgd_epoch``): user_factors [U, f], item_factors [I, f],
    global_bias, and where ``biased`` user_bias [U] and item_bias [I].
    ``data``: ``prepare_epoch_data``'s, plus inv_sqrt_count_user [U] and
    inv_sqrt_count_item [I] with frequency regularization. ``hp``:
    learn_rate, reg_u, reg_i, bias_reg, bias_learn_rate, min_rating,
    rating_range (floats). ``batch_order``: the batch-visit permutation
    (the JAX package draws ``jax.random.permutation(key, num_batches)``).
    Each batch's updates are segment-summed by the dedup slots and added
    once a distinct row; the sentinel rows drop. Returns params."""
    hp = dict(hp, global_bias=params["global_bias"])
    W, H = _fused(params, biased)
    inv_u = data["inv_sqrt_count_user"] if frequency_regularization else None
    inv_i = data["inv_sqrt_count_item"] if frequency_regularization else None
    B = batch_size
    for b in [int(x) for x in batch_order]:
        sl = slice(b * B, (b + 1) * B)
        u, i = data["users"][sl].long(), data["items"][sl].long()
        dW, dH = _flat_deltas(W, H, u, i, data["values"][sl],
                              data["weights"][sl], hp, inv_u, inv_i,
                              loss=loss, biased=biased)
        for on, table, delta, side in ((update_user, W, dW, "user"),
                                       (update_item, H, dH, "item")):
            if not on:
                continue
            seg = add_rows(delta.new_zeros(delta.shape),
                           data[f"{side}_slot"][sl].long(), delta)
            uniq = data[f"{side}_uniq"][sl].long()
            keep = uniq < table.shape[0]
            table.index_add_(0, uniq[keep], seg[keep])  # distinct rows
    return _unfuse(params, W, H, biased)


def sgd_epoch_sharded_flat(mesh, params, data, batch_order, hp, *,
                           batch_size: int, loss: int, biased: bool,
                           update_user: bool, update_item: bool,
                           frequency_regularization: bool):
    """``sgd_epoch`` over the mesh, data-parallel (the JAX dry run's flat
    epoch under XLA's SPMD partitioner): each batch of ``batch_size`` (a
    multiple of the global devices) splits into one equal part a global
    device; each device of this process computes its part's per-example
    deltas against its replica of the current tables, sums them by row
    (``torch.unique``), and the parts merge into every replica in global
    device order (``Mesh.merge_rows``, across the processes too) before
    the next batch. The same arguments as ``sgd_epoch`` (the dedup
    structures unread); every process passes the whole ``data`` and
    reads its devices' parts. Equal to ``sgd_epoch`` to float rounding.
    Returns params, updated in place on every process."""
    D, g0 = mesh.global_size, mesh.first_device
    if batch_size % D:
        raise ValueError(f"the batch ({batch_size}) must be a multiple of "
                         f"the global devices ({D})")
    part = batch_size // D
    nb = data["users"].shape[0] // batch_size
    hp = dict(hp, global_bias=params["global_bias"])
    W, H = _fused(params, biased)
    W_reps, H_reps = mesh.replicate(W), mesh.replicate(H)
    keys = ("users", "items", "values", "weights")
    local = [{k: data[k].reshape(nb, D, part)[:, g0 + d].to(dev)
              for k in keys} for d, dev in enumerate(mesh.devices)]
    inv = [(mesh.replicate(data["inv_sqrt_count_user"])[d],
            mesh.replicate(data["inv_sqrt_count_item"])[d])
           if frequency_regularization else (None, None)
           for d in range(mesh.size)]
    for b in [int(x) for x in batch_order]:
        parts_w, parts_h = [], []
        for d in range(mesh.size):
            x = {k: v[b] for k, v in local[d].items()}
            u, i = x["users"].long(), x["items"].long()
            dW, dH = _flat_deltas(W_reps[d], H_reps[d], u, i, x["values"],
                                  x["weights"], hp, *inv[d], loss=loss,
                                  biased=biased)
            for ids, delta, out in ((u, dW, parts_w), (i, dH, parts_h)):
                rows, slot = torch.unique(ids, return_inverse=True)
                out.append((rows, add_rows(delta.new_zeros(
                    (rows.numel(),) + tuple(delta.shape[1:])), slot, delta)))
        if update_user:
            W_reps = mesh.merge_rows(W_reps, parts_w)
        if update_item:
            H_reps = mesh.merge_rows(H_reps, parts_h)
    return _unfuse(params, W_reps[0].to(W.device), H_reps[0].to(H.device),
                   biased)
