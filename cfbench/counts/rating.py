"""One rating-SGD epoch's least work: each user and item row that a
rating touches read and written once at k + 2 columns (factors and the
two fused bias columns, float32), each rating's (u, i, value, weight)
read once (16 B), and per rating the dot product, the loss gradient and
the two row updates, about 12 float32 operations per column."""

from __future__ import annotations

import numpy as np


def work(log: dict, k: int) -> dict:
    n = int(log["users"].size)
    users = int(np.count_nonzero(np.bincount(log["users"])))
    items = int(np.count_nonzero(np.bincount(log["items"])))
    cols = k + 2
    return dict(examples=n, users=users, items=items, width=k,
                bytes=2 * (users + items) * cols * 4 + 16 * n,
                ops=12.0 * cols * n)
