"""One BPR epoch's least work: each user and item row that a triple
touches read and written once at k + 1 columns (factors and the item
bias, float32), each positive event's (u, i, weights) read once (16 B),
one trial of random bits (4 B) and one membership probe of a 4-byte key
(the probes at most the positive set's keys, 4 B an event), and per
triple the dot product and three row updates, about 18 float32
operations per column."""

from __future__ import annotations

import numpy as np


def work(log: dict, k: int) -> dict:
    n = int(log["users"].size)
    users = int(np.count_nonzero(np.bincount(log["users"])))
    items = int(np.count_nonzero(np.bincount(log["items"])))
    cols = k + 1
    return dict(examples=n, users=users, items=items, width=k,
                bytes=2 * (users + items) * cols * 4 + (16 + 4 + 4) * n,
                ops=18.0 * cols * n)
