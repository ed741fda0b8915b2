"""Chunk plan and table layout of the SVD++ epoch kernel.

Port of the host-side half of ``mymedialite_tpu/ops/pallas_svdpp.py``
(``svdpp_fe``, ``svdpp_mxu_supported``, ``prepare_svdpp_mxu``,
``svdpp_tables_to_mxu`` / ``svdpp_tables_from_mxu``,
``svdpp_mxu_rates``). Two chunk plans share one item permutation: one
over the history edges (I_u, the training items plus any test feedback)
and one over the ratings. The epoch is a STATIC schedule of chunks in
three phases, contiguous per user block: S (every edge chunk of the
block: the implicit sums s_u), R (every rating chunk: prediction and the
W/Q updates) and Y (the edge chunks again: the y updates).

The schedule's entries are the JAX plan's real entries in the same
order. The TPU-only parts stay behind: the split into passes (a bound of
the TPU's scalar memory), the all-zero pad chunk and the refetch flags.
The JAX package's pass length survives as a selection rule: a user block
that needs more than ``PASS_LEN`` chunks sends the JAX package to its XLA
grouped epoch (``ops/svdpp.py``), which the port does not have yet, so
the port raises there.

Tables keep rows (the TPU kernel's are transposed, ``[fe, rows]``):
W [u_pad, fe] = [p | b_u | 1 | inv_sqrt | 0...], Q [i_pad, fe] =
[q | 1 | b_i | 0...] and Y [i_pad, fe] = [y | 0...], item rows permuted.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from mymedialite_tpu_torch.ops.plan import _round_up, prepare_mxu_data
from mymedialite_tpu_torch.ops.svdpp import inv_sqrt_counts

# the JAX package keeps Q and Y resident in VMEM up to this size
# (pallas_svdpp.py:71); the port keeps the bound so that both packages
# pick the same epoch
SVDPP_TABLE_BYTES = 8 * 1024 * 1024
# the JAX package's pass length (pallas_svdpp.py:133): the most chunks one
# user block may take on its kernel path
PASS_LEN = 16384

XLA_EPOCH_NOT_PORTED = (
    "the XLA grouped SVD++ epoch (mymedialite_tpu/ops/svdpp.py) that the "
    "JAX package runs there is not yet ported to mymedialite_tpu_torch")


def svdpp_fe(num_factors: int) -> int:
    """Column count of the kernel-layout tables: the factors, three
    columns (b_u / 1 / inv_sqrt in W, 1 / b_i / 0 in Q), padded to 8 and
    to at least 32."""
    return max(32, _round_up(num_factors + 3, 8))


def svdpp_mxu_supported(num_items: int, num_factors: int,
                        item_block: int = 1024) -> bool:
    """Whether Q and Y together fit ``SVDPP_TABLE_BYTES``: the kernel
    path (``pallas_svdpp.svdpp_mxu_supported``)."""
    n_ib = max((num_items + item_block - 1) // item_block, 1)
    return 2 * n_ib * item_block * svdpp_fe(num_factors) * 4 \
        <= SVDPP_TABLE_BYTES


def require_kernel_path(num_items: int, num_factors: int):
    """Raise "not yet ported" where the JAX package leaves its kernel for
    the XLA grouped epoch because Q and Y pass the budget."""
    if not svdpp_mxu_supported(num_items, num_factors):
        raise NotImplementedError(
            f"{num_items} items x {num_factors} factors pass the SVD++ "
            f"kernel's {SVDPP_TABLE_BYTES} table bytes: "
            f"{XLA_EPOCH_NOT_PORTED}")


@dataclass
class SvdppPlan:
    """Host-side layout of the SVD++ epoch: edge chunks then rating chunks
    in ``packed``, and the flat S/R/Y schedule over them."""
    chunk: int
    user_block: int
    item_block: int
    n_ublocks: int
    n_iblocks: int
    num_users: int
    num_items: int
    n_ratings: int
    n_edges: int
    n_edge_chunks: int
    # [nc_e + nc_r, 4, C] int32 on the model's device: rows (u_loc,
    # i_loc, bits of the rating, bits of the slot weight)
    packed: torch.Tensor = field(repr=False)
    # the schedule (ph, ub, ib, row): [steps] int32 on the device of
    # packed; ph 0 = S, 1 = R, 2 = Y
    schedule: tuple = field(repr=False)
    inv_sqrt: np.ndarray = field(repr=False)       # [u_pad] host float32
    new_of_old: np.ndarray = field(repr=False)
    old_of_new: np.ndarray = field(repr=False)

    @property
    def u_pad(self) -> int:
        return self.n_ublocks * self.user_block

    @property
    def i_pad(self) -> int:
        return self.n_iblocks * self.item_block

    @property
    def num_steps(self) -> int:
        return int(self.schedule[0].numel())


def prepare_svdpp_mxu(r_users, r_items, r_values, h_users, h_items,
                      num_users: int, num_items: int, *,
                      user_block: int = 512, item_block: int = 1024,
                      chunk: int = 512, pass_len: int = PASS_LEN,
                      shuffle_seed=0, device="cpu") -> SvdppPlan:
    """Bucket the edges and the ratings (one item permutation, from the
    edges), then build the static S/R/Y schedule. Raises
    NotImplementedError where one user block needs more than
    ``pass_len`` chunks (the JAX package's XLA epoch)."""
    h_users = np.asarray(h_users, dtype=np.int32)
    h_items = np.asarray(h_items, dtype=np.int32)
    kw = dict(user_block=user_block, item_block=item_block, chunk=chunk,
              shuffle_seed=shuffle_seed, device=device)
    plan_e = prepare_mxu_data(h_users, h_items,
                              np.zeros(len(h_users), np.float32),
                              num_users, num_items, **kw)
    plan_r = prepare_mxu_data(r_users, r_items, r_values, num_users,
                              num_items, item_perm=plan_e.new_of_old, **kw)
    nc_e = plan_e.num_chunks
    n_ub = plan_e.n_ublocks

    # chunks are bucket-major, so each user block's chunks are one range
    def offsets(ub_c):
        return np.concatenate([[0], np.cumsum(np.bincount(ub_c,
                                                          minlength=n_ub))])

    e_off, r_off = offsets(plan_e.ub_c), offsets(plan_r.ub_c)
    parts = []
    for u in range(n_ub):
        e = np.arange(e_off[u], e_off[u + 1])
        r = np.arange(r_off[u], r_off[u + 1])
        n = 2 * e.size + r.size
        if n == 0:
            continue
        if n > pass_len:
            raise NotImplementedError(
                f"user block {u} needs {n} chunks > pass_len {pass_len}: "
                f"{XLA_EPOCH_NOT_PORTED}")
        parts.append((np.repeat(np.arange(3), [e.size, r.size, e.size]),
                      np.full(n, u),
                      np.concatenate([plan_e.ib_c[e], plan_r.ib_c[r],
                                      plan_e.ib_c[e]]),
                      np.concatenate([e, nc_e + r, e])))
    schedule = tuple(
        torch.from_numpy(np.ascontiguousarray(
            np.concatenate([p[k] for p in parts]) if parts
            else np.zeros(0), dtype=np.int32)).to(device)
        for k in range(4))

    return SvdppPlan(
        chunk=plan_e.chunk, user_block=plan_e.user_block,
        item_block=plan_e.item_block, n_ublocks=n_ub,
        n_iblocks=plan_e.n_iblocks, num_users=num_users, num_items=num_items,
        n_ratings=len(np.asarray(r_users)), n_edges=len(h_users),
        n_edge_chunks=nc_e,
        packed=torch.cat([plan_e.packed, plan_r.packed]), schedule=schedule,
        # 1 / sqrt(|I_u|) on the kernel's padded user grid
        inv_sqrt=inv_sqrt_counts(h_users, plan_e.u_pad),
        new_of_old=plan_e.new_of_old,
        old_of_new=plan_e.old_of_new)


def svdpp_tables_to_mxu(p, user_bias, inv_sqrt, q, item_bias, y, new_of_old,
                        *, u_pad: int, i_pad: int, fe: int):
    """Model tables (float32 tensors; p [U, f], item rows in id order) to
    the kernel layout, on the device of ``q``: W = [p | b_u | 1 |
    inv_sqrt], Q = [q | 1 | b_i], Y = [y | 0...], items permuted by
    ``new_of_old`` (an int64 tensor)."""
    dev = q.device
    U, f = p.shape
    rows = min(U, u_pad)
    W = torch.zeros((u_pad, fe), dtype=torch.float32, device=dev)
    W[:rows, :f] = p[:rows]
    W[:rows, f] = user_bias[:rows]
    W[:rows, f + 1] = 1.0
    W[:, f + 2] = torch.as_tensor(inv_sqrt[:u_pad], device=dev)
    Q = torch.zeros((i_pad, fe), dtype=torch.float32, device=dev)
    Q[new_of_old, :f] = q
    Q[new_of_old, f] = 1.0
    Q[new_of_old, f + 1] = item_bias
    Y = torch.zeros((i_pad, fe), dtype=torch.float32, device=dev)
    Y[new_of_old, :f] = y
    return W, Q, Y


def svdpp_tables_from_mxu(W, Q, Y, new_of_old, *, num_users: int,
                          num_factors: int):
    """Inverse of svdpp_tables_to_mxu: (p [num_users, f], b_u, q, b_i, y),
    tensors on the device of W."""
    f = num_factors
    Qr = Q[new_of_old]
    return (W[:num_users, :f], W[:num_users, f], Qr[:, :f], Qr[:, f + 1],
            Y[new_of_old, :f])


def svdpp_mxu_rates(num_factors: int, fe: int, learn_rate, bias_learn_rate,
                    reg, bias_reg, y_reg, *, use_p: bool, update_user: bool,
                    update_item: bool, device="cpu") -> torch.Tensor:
    """[fe, 8] per-column rates: 0 w_lr, 1 w_reg, 2 q_lr, 3 q_reg, 4 mf
    (1 on the factor columns), 5 unused, 6 y_lr, 7 y_reg."""
    f = num_factors
    lr, blr = float(learn_rate), float(bias_learn_rate)
    out = np.zeros((fe, 8), np.float32)
    if use_p and update_user:
        out[:f, 0] = lr
    if update_user:
        out[f, 0] = blr * lr
    out[:f, 1] = float(reg)
    out[f, 1] = float(bias_reg) * float(reg)
    if update_item:
        out[:f, 2] = lr
        out[f + 1, 2] = blr * lr
    out[:f, 3] = float(reg)
    out[f + 1, 3] = float(bias_reg) * float(reg)
    out[:f, 4] = 1.0
    if update_item:
        out[:f, 6] = lr
    out[:f, 7] = float(y_reg)
    return torch.from_numpy(out).to(device)
