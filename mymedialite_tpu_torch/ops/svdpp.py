"""History edges and the user factors of the SVD++ family.

Port of the parts of ``mymedialite_tpu/models/svdpp.py`` and
``mymedialite_tpu/ops/svdpp.py`` that the kernel path and prediction
need: the edges I_u (training pairs plus any test feedback, each pair
once, ``SVDPlusPlus._history_edges``), 1/sqrt(|I_u|), and
``precompute_user_factors`` (reference PrecomputeUserFactors,
SVDPlusPlus.cs:216-245) as one segmented sum over the edges. The JAX
package's padded per-group layout (``prepare_groups``) serves its XLA
grouped epoch and its TPU gathers; the port needs neither.
"""

from __future__ import annotations

import numpy as np
import torch


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
