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

    @property
    def num_chunks(self) -> int:
        return sum(len(self.chunks(g)) for g in range(self.ngroups))


def prepare_groups(r_users, r_items, r_values, h_users, h_items,
                   num_users: int, group_users: int,
                   device="cpu") -> SvdppGroups:
    """Group the ratings and the history edges by contiguous user-id
    ranges of ``group_users`` users, each stably, in the order of the
    JAX package's ``prepare_groups``."""
    G = group_users
    ngroups = max((num_users + G - 1) // G, 1)

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
        r_off=r_off, e_off=e_off, r_user=ids(ru), r_item=ids(ri),
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
    q, y, bias_i = params["item_factors"], params["y"], params["item_bias"]
    bias_u = params["user_bias"]
    p_mat = params.get("p") if use_p else None
    x = params.get("x") if attr_norm is not None else None
    dtype = q.dtype
    U, f = bias_u.shape[0], q.shape[1]
    G = groups.group_users
    lr = hp["learn_rate"]
    blr, bias_reg = hp["bias_learn_rate"], hp["bias_reg"]
    gb, min_rating, rng = hp["global_bias"], hp["min_rating"], \
        hp["rating_range"]
    user_reg, item_reg, y_reg = (regs[k].to(dtype)
                                 for k in ("user_reg", "item_reg", "y_reg"))
    inv_sqrt = inv_sqrt.to(dtype)
    if x is not None:
        x_reg = regs["x_reg"].to(dtype)
        attr_norm = attr_norm.to(dtype)
    if group_ids is None:
        group_ids = range(groups.ngroups)
    with exact_float32():
        for g in group_ids:
            u0 = g * G
            rows = min(G, U - u0)
            if rows <= 0:
                continue
            e_lo, e_hi = int(groups.e_off[g]), int(groups.e_off[g + 1])
            e_u = groups.e_user[e_lo:e_hi] - u0
            e_i = groups.e_item[e_lo:e_hi]
            # the implicit vectors s of the group's users, fixed for the
            # group
            inv = inv_sqrt[u0:u0 + rows]
            s = torch.zeros((rows, f), dtype=dtype, device=q.device)
            s.index_add_(0, e_u, y[e_i])
            s = s * inv[:, None]
            bu_slab = bias_u[u0:u0 + rows]           # views: in place
            p_slab = p_mat[u0:u0 + rows] if p_mat is not None else None
            u_reg_slab = user_reg[u0:u0 + rows]
            c_acc = torch.zeros((rows, f), dtype=dtype, device=q.device)
            n_acc = torch.zeros(rows, dtype=dtype, device=q.device)
            for a, b in groups.chunks(g):
                ru = groups.r_user[a:b] - u0
                ri = groups.r_item[a:b]
                rv = groups.r_value[a:b].to(dtype)
                su = s[ru] + p_slab[ru] if p_slab is not None else s[ru]
                qi_raw = q[ri]
                if x is not None:
                    # gSVD++ (GSVDPlusPlus.cs:115-128): q_i plus the mean
                    # of the item's attribute factors
                    a_rows = attr_norm[ri]
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
                        d_x = d_x - (occ * x_reg)[:, None] * x
                        x.add_(lr * d_x)
                    c_acc.index_add_(0, ru, (gcom * inv[ru])[:, None] * qi)
                    n_acc.index_add_(0, ru, torch.ones_like(gcom))
            if update_item:
                # y moves once per group, through the edges
                d_y = c_acc[e_u] - (n_acc[e_u] * y_reg[e_i])[:, None] * y[e_i]
                y.index_add_(0, e_i, lr * d_y)
    return params
