"""History edges, user factors and the grouped epoch of the SVD++ family.

Port of the parts of ``mymedialite_tpu/models/svdpp.py`` and
``mymedialite_tpu/ops/svdpp.py`` that the epochs and prediction need:
the edges I_u (training pairs plus any test feedback, each pair once,
``SVDPlusPlus._history_edges``), 1/sqrt(|I_u|),
``precompute_user_factors`` (reference PrecomputeUserFactors,
SVDPlusPlus.cs:216-245) as one segmented sum over the edges, and the
grouped epoch (``prepare_groups``, ``svdpp_epoch_grouped``) that the
family trains on where the kernel of ``csrc/svdpp_epoch.cu`` does not
go: frequency regularization, Q and Y past the kernel's table budget, a
user block past the pass length, and GSVDPlusPlus. The JAX package runs
that epoch as an XLA scan; here it is plain PyTorch (gathers,
``index_add_`` and, for gSVD++, two float32 matmuls).

The grouped epoch walks contiguous user-id groups of ``group_users``
users. Per group the implicit vectors s_u = |I_u|^-1/2 sum_{j in I_u}
y_j are computed once from the group's edges; the group's ratings are
then processed in chunks of ``chunk`` = min(4096, L) slots, L the
largest group's rating count, each one minibatch step on p, q and the
biases (and x for gSVD++), while s stays fixed; y moves once per group,
through the edges, from the accumulated c_u = sum err * q_i /
sqrt(|I_u|). The JAX package pads every group to L; the port keeps each
group's own ratings and skips the padding slots and the all-padding
chunks, which changes no number.

``svdpp_epoch_sharded`` is the mesh form (JAX ``ops/svdpp.py:234-420``):
the groups split into one contiguous range per mesh device, ``ngroups``
a multiple of the devices (``prepare_groups(pad_groups_multiple=D)``
adds empty groups). Step g runs group d * groups_local + g on every
device d from the same item tables; each device's chunks read the
item_bias, q and y that its own earlier chunks updated, on a private
copy taken at the start of the step, and the copies merge as start +
the sum of the devices' deltas (the JAX package's psum). The user
tables are row-sharded: a device owns its groups' users.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from mymedialite_tpu_torch.device import exact_float32
from mymedialite_tpu_torch.ops.sgd import gradient_common

# the most ratings of one chunk of the grouped epoch (JAX: svdpp_epoch)
GROUP_CHUNK = 4096


def history_edges(users, items, num_items: int, extra=None):
    """I_u: the (user, item) pairs of the ratings plus ``extra`` (a
    (users, items) pair of arrays or None), each pair once, sorted by
    user * num_items + item with the first occurrence kept (the order of
    the JAX package). Returns int32 numpy (users, items)."""
    u = [np.asarray(users, dtype=np.int32)]
    i = [np.asarray(items, dtype=np.int32)]
    if extra is not None:
        u.append(np.asarray(extra[0], dtype=np.int32))
        i.append(np.asarray(extra[1], dtype=np.int32))
    u, i = np.concatenate(u), np.concatenate(i)
    key = u.astype(np.int64) * max(num_items, 1) + i
    _, first = np.unique(key, return_index=True)
    return u[first], i[first]


def inv_sqrt_counts(h_users, num_rows: int) -> np.ndarray:
    """[num_rows] float32: 1 / sqrt(|I_u|), 0 for users without edges."""
    count = np.bincount(np.asarray(h_users), minlength=num_rows)
    return np.where(count > 0, 1.0 / np.sqrt(np.maximum(count, 1.0)),
                    0.0).astype(np.float32)


def precompute_user_factors(y, h_users, h_items, inv_sqrt, num_users: int,
                            p=None):
    """[num_users, f]: p_u + 1/sqrt(|I_u|) * sum_{j in I_u} y_j, from the
    edges (int64 tensors on the device of ``y``, sorted by user, as
    ``history_edges`` gives them) and ``inv_sqrt`` (at least num_users
    rows, on that device too). The sums run per user in edge order, so
    the result is the same in every run (a scatter-add on the card adds
    in a run-dependent order) and a saved and reloaded model predicts
    bit for bit what it predicted before."""
    lengths = torch.bincount(h_users, minlength=num_users)
    s = torch.segment_reduce(y[h_items], "sum", lengths=lengths, axis=0)
    s = s * inv_sqrt[:num_users, None]
    return s if p is None else s + p


@dataclass
class SvdppGroups:
    """The grouped epoch's layout: the ratings and the edges stably
    sorted by user group (``user // group_users``), with each group's
    range in the host offsets ``r_off`` / ``e_off`` [ngroups + 1]."""
    ngroups: int
    group_users: int
    chunk: int
    length: int             # L: the largest group's rating count
    first_group: int        # the global index of group 0 (a device's slice)
    r_off: np.ndarray = field(repr=False)
    e_off: np.ndarray = field(repr=False)
    # on the model's device: int64 ids, float32 values
    r_user: torch.Tensor = field(repr=False)
    r_item: torch.Tensor = field(repr=False)
    r_value: torch.Tensor = field(repr=False)
    e_user: torch.Tensor = field(repr=False)
    e_item: torch.Tensor = field(repr=False)

    def chunks(self, g: int):
        """The group's chunks that hold real ratings, as (start, stop)
        ranges of the flat rating arrays. As in the JAX package, chunk c
        of the padded row [0, L) starts at min(c * chunk, L - chunk) (a
        dynamic_slice clamps its start so that the slice fits), so when
        ``chunk`` does not divide L the last chunk repeats the tail of the
        one before it; the padding slots, past the group's count, drop
        out."""
        lo, hi = int(self.r_off[g]), int(self.r_off[g + 1])
        C = self.chunk
        out = []
        for c in range(-(-self.length // C)):
            start = min(c * C, self.length - C)
            if start < hi - lo:
                out.append((lo + start, lo + min(start + C, hi - lo)))
        return out

    def to(self, device) -> "SvdppGroups":
        """The same layout with its tensors on ``device``."""
        return replace(self, **{k: getattr(self, k).to(device) for k in (
            "r_user", "r_item", "r_value", "e_user", "e_item")})

    def slice(self, g0: int, g1: int, device) -> "SvdppGroups":
        """Groups [g0, g1) as a layout of their own on ``device``: the same
        chunk and L (the largest group's count over all groups), offsets
        rebased, ``first_group`` the global index of g0."""
        r0, r1 = int(self.r_off[g0]), int(self.r_off[g1])
        e0, e1 = int(self.e_off[g0]), int(self.e_off[g1])
        parts = {k: getattr(self, k)[r0:r1].to(device)
                 for k in ("r_user", "r_item", "r_value")}
        parts.update({k: getattr(self, k)[e0:e1].to(device)
                      for k in ("e_user", "e_item")})
        return replace(self, ngroups=g1 - g0,
                       first_group=self.first_group + g0,
                       r_off=self.r_off[g0:g1 + 1] - r0,
                       e_off=self.e_off[g0:g1 + 1] - e0, **parts)

    @property
    def num_chunks(self) -> int:
        return sum(len(self.chunks(g)) for g in range(self.ngroups))


def prepare_groups(r_users, r_items, r_values, h_users, h_items,
                   num_users: int, group_users: int, device="cpu",
                   pad_groups_multiple: int = 1) -> SvdppGroups:
    """Group the ratings and the history edges by contiguous user-id
    ranges of ``group_users`` users, each stably, in the order of the
    JAX package's ``prepare_groups``; ``pad_groups_multiple`` rounds
    ngroups up with empty groups, so that the groups divide evenly over
    a mesh."""
    G = group_users
    ngroups = max((num_users + G - 1) // G, 1)
    m = max(pad_groups_multiple, 1)
    ngroups = -(-ngroups // m) * m

    def grouped(users, *arrays):
        users = np.asarray(users, dtype=np.int64)
        order = np.argsort(users // G, kind="stable")
        off = np.concatenate([[0], np.cumsum(
            np.bincount(users // G, minlength=ngroups))]).astype(np.int64)
        return off, [np.asarray(a)[order] for a in (users,) + arrays]

    r_off, (ru, ri, rv) = grouped(r_users, r_items, r_values)
    e_off, (eu, ei) = grouped(h_users, h_items)

    def ids(a):
        return torch.from_numpy(a.astype(np.int64)).to(device)
    L = max(int(np.diff(r_off).max()), 1)
    return SvdppGroups(
        ngroups=ngroups, group_users=G, chunk=min(GROUP_CHUNK, L), length=L,
        first_group=0, r_off=r_off, e_off=e_off, r_user=ids(ru), r_item=ids(ri),
        r_value=torch.from_numpy(rv.astype(np.float32)).to(device),
        e_user=ids(eu), e_item=ids(ei))


def svdpp_epoch_grouped(params, groups: SvdppGroups, inv_sqrt, hp, regs, *,
                        loss: int, sigmoid: bool, use_p: bool,
                        update_user: bool = True, update_item: bool = True,
                        attr_norm=None, group_ids=None):
    """One pass over the user groups, in place on ``params`` (JAX:
    ``svdpp_epoch``): user_bias [U], item_bias [I], item_factors (q)
    [I, f], y [I, f], p [U, f] with ``use_p``, x [A, f] for gSVD++ (with
    ``attr_norm`` [I, A], the items' attribute rows each summing to 1).
    U may stop inside the last group. ``inv_sqrt`` [U]: 1/sqrt(|I_u|).
    hp: global_bias, learn_rate, bias_learn_rate, bias_reg, min_rating,
    rating_range. regs: user_reg [U], item_reg [I], y_reg [I] and x_reg
    [A] for gSVD++. ``group_ids`` (default all) runs a subset of the
    groups, in the order given. Computes in the tables' dtype; the
    gSVD++ matmuls in full float32 (no TF32)."""
    bias_u = params["user_bias"]
    p_mat = params.get("p") if use_p else None
    dtype = params["item_factors"].dtype
    U = bias_u.shape[0]
    G = groups.group_users
    user_reg = regs["user_reg"].to(dtype)
    inv_sqrt = inv_sqrt.to(dtype)
    item = _item_side(params, regs, dtype, attr_norm)
    if group_ids is None:
        group_ids = range(groups.ngroups)
    with exact_float32():
        for g in group_ids:
            u0 = g * G
            rows = min(G, U - u0)
            if rows <= 0:
                continue
            user = dict(bias=bias_u[u0:u0 + rows],            # views
                        p=p_mat[u0:u0 + rows] if p_mat is not None else None,
                        reg=user_reg[u0:u0 + rows], inv=inv_sqrt[u0:u0 + rows])
            _group_step(groups, g, user, item, hp, loss=loss,
                        sigmoid=sigmoid, update_user=update_user,
                        update_item=update_item)
    return params


def _item_side(params, regs, dtype, attr_norm=None) -> dict:
    """The item-side tables a group step reads and updates in place, and
    their regularization: item_bias, q, y, item_reg, y_reg (and x,
    attr_norm, x_reg for gSVD++)."""
    item = dict(bias=params["item_bias"], q=params["item_factors"],
                y=params["y"], reg=regs["item_reg"].to(dtype),
                y_reg=regs["y_reg"].to(dtype), x=None)
    if attr_norm is not None:
        item.update(x=params["x"], attr=attr_norm.to(dtype),
                    x_reg=regs["x_reg"].to(dtype))
    return item


def _group_step(groups: SvdppGroups, g: int, user: dict, item: dict, hp, *,
                loss: int, sigmoid: bool, update_user: bool,
                update_item: bool):
    """Group g of ``groups``: its users' implicit vectors s from y, fixed
    for the group; its ratings in chunks, each one minibatch step on the
    user slab (``user``: bias, p, reg and inv, views of the group's
    rows) and on the item tables (``item``, in place); then y once,
    through the group's edges."""
    q, y, bias_i, x = item["q"], item["y"], item["bias"], item["x"]
    item_reg, y_reg = item["reg"], item["y_reg"]
    bu_slab, p_slab, u_reg_slab, inv = (user[k] for k in
                                        ("bias", "p", "reg", "inv"))
    rows, f = bu_slab.shape[0], q.shape[1]
    dtype = q.dtype
    u0 = (groups.first_group + g) * groups.group_users
    lr = hp["learn_rate"]
    blr, bias_reg = hp["bias_learn_rate"], hp["bias_reg"]
    gb, min_rating, rng = hp["global_bias"], hp["min_rating"], \
        hp["rating_range"]
    e_lo, e_hi = int(groups.e_off[g]), int(groups.e_off[g + 1])
    e_u = groups.e_user[e_lo:e_hi] - u0
    e_i = groups.e_item[e_lo:e_hi]
    # the implicit vectors s of the group's users, fixed for the group
    s = torch.zeros((rows, f), dtype=dtype, device=q.device)
    s.index_add_(0, e_u, y[e_i])
    s = s * inv[:, None]
    c_acc = torch.zeros((rows, f), dtype=dtype, device=q.device)
    n_acc = torch.zeros(rows, dtype=dtype, device=q.device)
    for a, b in groups.chunks(g):
        ru = groups.r_user[a:b] - u0
        ri = groups.r_item[a:b]
        rv = groups.r_value[a:b].to(dtype)
        su = s[ru] + p_slab[ru] if p_slab is not None else s[ru]
        qi_raw = q[ri]
        if x is not None:
            # gSVD++ (GSVDPlusPlus.cs:115-128): q_i plus the mean of the
            # item's attribute factors
            a_rows = item["attr"][ri]
            qi = qi_raw + a_rows @ x
        else:
            qi = qi_raw
        bu, bi = bu_slab[ru], bias_i[ri]
        score = gb + bu + bi + (su * qi).sum(dim=-1)
        if sigmoid:
            sig = torch.sigmoid(score)
            gcom = gradient_common(loss, rv - (min_rating + sig * rng),
                                   sig, rng)
        else:
            gcom = rv - score
        u_reg, i_reg = u_reg_slab[ru], item_reg[ri]
        if update_user:
            bu_slab.index_add_(0, ru, blr * lr * (
                gcom - bias_reg * u_reg * bu))
        if update_item:
            bias_i.index_add_(0, ri, blr * lr * (
                gcom - bias_reg * i_reg * bi))
        if p_slab is not None and update_user:
            d_p = gcom[:, None] * qi - u_reg[:, None] * p_slab[ru]
            seg = torch.zeros_like(p_slab).index_add_(0, ru, d_p)
            p_slab.add_(lr * seg)
        if update_item:
            # the reg term reads the raw q row (GSVDPlusPlus.cs:159)
            d_q = gcom[:, None] * su - i_reg[:, None] * qi_raw
            q.index_add_(0, ri, lr * d_q)
            if x is not None:
                # x update (GSVDPlusPlus.cs:163-174)
                d_x = a_rows.T @ (gcom[:, None] * su)
                occ = torch.sign(a_rows).sum(dim=0)
                d_x = d_x - (occ * item["x_reg"])[:, None] * x
                x.add_(lr * d_x)
            c_acc.index_add_(0, ru, (gcom * inv[ru])[:, None] * qi)
            n_acc.index_add_(0, ru, torch.ones_like(gcom))
    if update_item:
        # y moves once per group, through the edges
        d_y = c_acc[e_u] - (n_acc[e_u] * y_reg[e_i])[:, None] * y[e_i]
        y.index_add_(0, e_i, lr * d_y)


def shard_groups(mesh, groups: SvdppGroups) -> list:
    """Each of this process's devices' contiguous range of groups, the
    range of its global device, as a layout on that device
    (``SvdppGroups.slice``)."""
    D, g0 = mesh.global_size, mesh.first_device
    if groups.ngroups % D:
        raise ValueError("ngroups must be a multiple of the mesh devices "
                         "(prepare_groups(pad_groups_multiple=D))")
    gl = groups.ngroups // D
    return [groups.slice((g0 + d) * gl, (g0 + d + 1) * gl, dev)
            for d, dev in enumerate(mesh.devices)]


def svdpp_epoch_sharded(mesh, params, groups, inv_sqrt, hp, regs, *,
                        loss: int, sigmoid: bool, use_p: bool,
                        update_user: bool = True, update_item: bool = True):
    """One pass over the user groups on the mesh, in place on ``params``
    (the tables of ``svdpp_epoch_grouped``, without gSVD++; JAX:
    ``svdpp_epoch_sharded``). ``groups``: a layout whose ngroups the
    global devices divide, or ``shard_groups``' list (this process's).
    Global device d owns groups [d * groups_local, (d + 1) *
    groups_local) and their users' rows; step g runs group d *
    groups_local + g on every device d from the same item tables, each
    device on private copies of item_bias, q and y, which merge as start
    + the sum of the devices' deltas at the end of the step, across the
    processes too: there every step merges, with a zero delta where a
    process's groups are empty, so that every process calls the
    collective. The user rows are gathered from every process at the
    end."""
    shards = groups if isinstance(groups, list) else \
        shard_groups(mesh, groups)
    gl = shards[0].ngroups
    G = shards[0].group_users
    D = mesh.global_size
    dtype = params["item_factors"].dtype
    U = params["user_bias"].shape[0]
    rows = D * gl * G

    def user_shards(t):
        t = t.to(dtype)
        pad = rows - t.shape[0]
        if pad > 0:
            t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
        return mesh.shard_rows(t[:rows])
    keys = ("user_bias", "p") if use_p else ("user_bias",)
    u_sh = {k: user_shards(params[k]) for k in keys}
    reg_sh = user_shards(regs["user_reg"])
    inv_sh = user_shards(inv_sqrt)
    start = {k: params[k] for k in ("item_bias", "item_factors", "y")}
    reps = {k: mesh.replicate(v) for k, v in start.items()}
    item_regs = {k: mesh.replicate(regs[k].to(dtype))
                 for k in ("item_reg", "y_reg")}
    with exact_float32():
        for g in range(gl):
            private = []
            for d in range(mesh.size):
                lg = shards[d]
                if lg.r_off[g + 1] == lg.r_off[g] and \
                        lg.e_off[g + 1] == lg.e_off[g]:
                    private.append(None)
                    continue
                sl = slice(g * G, (g + 1) * G)
                user = dict(bias=u_sh["user_bias"][d][sl],
                            p=u_sh["p"][d][sl] if use_p else None,
                            reg=reg_sh[d][sl], inv=inv_sh[d][sl])
                mine = {k: reps[k][d].clone() for k in reps}
                item = dict(bias=mine["item_bias"], q=mine["item_factors"],
                            y=mine["y"], reg=item_regs["item_reg"][d],
                            y_reg=item_regs["y_reg"][d], x=None)
                _group_step(lg, g, user, item, hp, loss=loss,
                            sigmoid=sigmoid, update_user=update_user,
                            update_item=update_item)
                private.append(mine)
            if update_item and (mesh.process_count > 1 or any(
                    p is not None for p in private)):
                for k in reps:
                    reps[k] = mesh.merge_deltas(
                        reps[k][0], [p[k] for p in private if p is not None])
    for k in reps:
        params[k].copy_(reps[k][0].to(params[k].device))
    for k in keys:
        params[k].copy_(mesh.gather_rows(u_sh[k], params[k].device)[:U])
    return params
