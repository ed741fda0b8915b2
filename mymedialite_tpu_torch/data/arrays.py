"""Interaction datasets as packed arrays.

Counterpart of the reference's object-based data layer
(``Data/DataSet.cs:32-285``, ``Data/Ratings.cs:32-337``,
``Data/PosOnlyFeedback.cs:32-207``, ``Data/TimedRatings.cs``).

Design: everything is a flat numpy COO array (int32 user ids, int32 item
ids, float32 values) plus *lazily built, cached* CSR views sorted by
(user, item) and (item, user) — the array analog of the reference's lazy
``ByUser``/``ByItem`` index lists (``DataSet.cs:48-97``). The CSR segments
are sorted by the secondary key so membership tests are binary searches
(used by on-device BPR negative sampling).

Datasets are immutable; incremental updates (the reference's
``Ratings.Add``/``RemoveUser`` etc.) return new datasets sharing no
mutable state, which keeps them safe to capture in jitted closures.

The port's own copy of ``mymedialite_tpu/data/arrays.py``:
the same behaviour, and no import of the JAX package. One addition: a
dataset made by ``add`` (an append) or by a ``remove*`` method from one
whose CSR views are built derives its views from them in one merge or
filter pass, instead of a lexsort of every event; the result equals
``build_csr``'s. This keeps the per-event online protocols (add, then
remove) linear in the events per step.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional

import numpy as np

from mymedialite_tpu_torch.data.scale import RatingScale


def _as_i32(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.int32))


def _as_f32(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


@dataclasses.dataclass(frozen=True)
class Csr:
    """A grouping of interaction indices: ``order[indptr[k]:indptr[k+1]]``
    are the COO indices whose primary key equals k, sorted by secondary key."""

    indptr: np.ndarray  # int64 [num_keys + 1]
    order: np.ndarray   # int32 [nnz] — permutation into the COO arrays
    keys: np.ndarray    # int32 [nnz] — secondary key, already permuted & sorted per segment

    def segment(self, k: int) -> np.ndarray:
        """COO indices for primary key k."""
        return self.order[self.indptr[k]:self.indptr[k + 1]]

    def secondary(self, k: int) -> np.ndarray:
        """Sorted secondary keys for primary key k (e.g. items rated by user k)."""
        return self.keys[self.indptr[k]:self.indptr[k + 1]]

    def counts(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    def contains(self, k: int, secondary_key: int) -> bool:
        seg = self.secondary(k)
        j = np.searchsorted(seg, secondary_key)
        return j < seg.size and seg[j] == secondary_key


def build_csr(primary: np.ndarray, secondary: np.ndarray, num_keys: int) -> Csr:
    """The CSR view of events keyed (``primary``, ``secondary``), ties in
    event order: the native two-pass counting sort (``native.csr_order``),
    else ``np.lexsort``; both give the same arrays."""
    from mymedialite_tpu_torch import native
    counted = native.csr_order(primary, secondary, num_keys)
    if counted is not None:
        indptr, order = counted
        return Csr(indptr=indptr, order=order, keys=secondary[order])
    order = np.lexsort((secondary, primary)).astype(np.int32)
    indptr = np.zeros(num_keys + 1, dtype=np.int64)
    indptr[1:] = np.bincount(primary, minlength=num_keys)
    np.cumsum(indptr, out=indptr)
    return Csr(indptr=indptr, order=order, keys=secondary[order])


def _indptr(old: np.ndarray, delta: np.ndarray, num_keys: int) -> np.ndarray:
    """An indptr of ``num_keys`` keys: the old counts (zero for new keys)
    plus ``delta``."""
    counts = np.zeros(num_keys, dtype=np.int64)
    counts[:old.size - 1] = np.diff(old)
    counts += delta
    indptr = np.zeros(num_keys + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr


def _csr_after_append(csr: Csr, primary, secondary, n_old: int,
                      num_keys: int) -> Csr:
    """``build_csr(primary, secondary, num_keys)`` from the CSR of the
    first ``n_old`` events: each appended event goes after the old events
    of its primary key whose secondary key is not larger, as the stable
    lexsort places it (a vectorised binary search in each segment)."""
    p_new, s_new = primary[n_old:], secondary[n_old:]
    o = np.lexsort((s_new, p_new))
    p_new, s_new = p_new[o].astype(np.int64), s_new[o]
    ends = np.append(csr.indptr, np.full(max(num_keys + 1 - csr.indptr.size,
                                             0), csr.indptr[-1]))
    lo, hi = ends[p_new], ends[p_new + 1]
    while True:
        open_ = lo < hi
        if not open_.any():
            break
        mid = (lo + hi) // 2
        right = open_ & (csr.keys[np.minimum(mid, csr.keys.size - 1)]
                         <= s_new)
        lo = np.where(right, mid + 1, lo)
        hi = np.where(open_ & ~right, mid, hi)
    return Csr(indptr=_indptr(csr.indptr,
                              np.bincount(p_new, minlength=num_keys),
                              num_keys),
               order=np.insert(csr.order, lo, (n_old + o).astype(np.int32)),
               keys=np.insert(csr.keys, lo, s_new))


def _csr_after_removal(csr: Csr, keep: np.ndarray, primary,
                       num_keys: int) -> Csr:
    """``build_csr`` of the dataset that keeps the parent's events where
    ``keep`` is set, from the parent's CSR ``csr`` (one filter pass);
    ``primary`` is the kept events' keys."""
    new = np.cumsum(keep, dtype=np.int64) - 1
    at = keep[csr.order]
    indptr = np.zeros(num_keys + 1, dtype=np.int64)
    np.cumsum(np.bincount(primary, minlength=num_keys), out=indptr[1:])
    return Csr(indptr=indptr, order=new[csr.order[at]].astype(np.int32),
               keys=csr.keys[at])


class InteractionData:
    """Base COO container; subclassed by RatingData / PosOnlyData."""

    # the built CSR views of the dataset this one came from, and how it
    # came: ("append", views, n_old) or ("remove", views, keep mask)
    _csr_source = None

    def __init__(self, users, items, num_users: Optional[int] = None,
                 num_items: Optional[int] = None):
        self.users = _as_i32(users)
        self.items = _as_i32(items)
        if self.users.shape != self.items.shape or self.users.ndim != 1:
            raise ValueError("users/items must be equal-length 1-D arrays")
        n_u = int(self.users.max()) + 1 if self.users.size else 0
        n_i = int(self.items.max()) + 1 if self.items.size else 0
        self.num_users = max(num_users or 0, n_u)
        self.num_items = max(num_items or 0, n_i)

    def __len__(self):
        return int(self.users.size)

    @property
    def count(self):
        return len(self)

    # reference DataSet.MaxUserID/MaxItemID
    @property
    def max_user_id(self):
        return self.num_users - 1

    @property
    def max_item_id(self):
        return self.num_items - 1

    def _derived_from(self, parent, kind: str, info):
        """Remember the parent's built CSR views (not the parent), to
        derive this dataset's from them."""
        views = {name: parent.__dict__[name] for name in ("by_user", "by_item")
                 if name in parent.__dict__}
        if views:
            self._csr_source = (kind, views, info)
        return self

    def _csr(self, name: str, primary, secondary, num_keys: int) -> Csr:
        source = self._csr_source
        if source is None or name not in source[1]:
            return build_csr(primary, secondary, num_keys)
        kind, views, info = source
        parent = views.pop(name)
        if not views:
            self._csr_source = None
        if kind == "append":
            return _csr_after_append(parent, primary, secondary, info,
                                     num_keys)
        return _csr_after_removal(parent, info, primary, num_keys)

    def _kept(self, keep: np.ndarray):
        """The dataset of the events where ``keep`` is set, its CSR views
        derived from this one's."""
        return self.select(np.flatnonzero(keep))._derived_from(
            self, "remove", keep)

    @cached_property
    def by_user(self) -> Csr:
        """Per-user CSR over interaction indices (reference DataSet.ByUser)."""
        return self._csr("by_user", self.users, self.items, self.num_users)

    @cached_property
    def by_item(self) -> Csr:
        """Per-item CSR (reference DataSet.ByItem)."""
        return self._csr("by_item", self.items, self.users, self.num_items)

    @cached_property
    def all_users(self) -> np.ndarray:
        return np.unique(self.users)

    @cached_property
    def all_items(self) -> np.ndarray:
        return np.unique(self.items)

    @cached_property
    def count_by_user(self) -> np.ndarray:
        # plain bincount: building the full by_user CSR just for counts
        # was 2 x (20M lexsort + add.at) ~= 21 s at the Netflix shape
        return np.bincount(self.users, minlength=self.num_users).astype(
            np.int32)

    @cached_property
    def count_by_item(self) -> np.ndarray:
        return np.bincount(self.items, minlength=self.num_items).astype(
            np.int32)

    def items_by_user(self, u: int) -> np.ndarray:
        """Sorted item ids interacted with by user u."""
        return self.by_user.secondary(u)

    def users_by_item(self, i: int) -> np.ndarray:
        return self.by_item.secondary(i)


class RatingData(InteractionData):
    """Explicit-feedback ratings (reference Data/Ratings.cs).

    ``values`` is float32; ``times`` (optional) is int64 unix seconds —
    the reference's TimedRatings (``Data/TimedRatings.cs``).
    """

    def __init__(self, users, items, values, num_users=None, num_items=None,
                 scale: Optional[RatingScale] = None, times=None):
        super().__init__(users, items, num_users, num_items)
        self.values = _as_f32(values)
        if self.values.shape != self.users.shape:
            raise ValueError("values must match users/items length")
        self.scale = scale or RatingScale.from_values(self.values)
        self.times = None if times is None else np.asarray(times, dtype=np.int64)
        if self.times is not None and self.times.shape != self.users.shape:
            raise ValueError("times must match users/items length")

    # --- reference Ratings.Average (Ratings.cs:76-84) ---
    @cached_property
    def average(self) -> float:
        return float(self.values.mean()) if len(self) else 0.0

    @property
    def min_rating(self):
        return self.scale.min

    @property
    def max_rating(self):
        return self.scale.max

    def select(self, idx: np.ndarray, num_users=None, num_items=None) -> "RatingData":
        """Index-view split (reference RatingsProxy.cs) — materialized as arrays."""
        return RatingData(
            self.users[idx], self.items[idx], self.values[idx],
            num_users=num_users if num_users is not None else self.num_users,
            num_items=num_items if num_items is not None else self.num_items,
            scale=self.scale,
            times=None if self.times is None else self.times[idx],
        )

    def concat(self, other: "RatingData") -> "RatingData":
        """Reference CombinedRatings.cs."""
        times = None
        if self.times is not None and other.times is not None:
            times = np.concatenate([self.times, other.times])
        return RatingData(
            np.concatenate([self.users, other.users]),
            np.concatenate([self.items, other.items]),
            np.concatenate([self.values, other.values]),
            num_users=max(self.num_users, other.num_users),
            num_items=max(self.num_items, other.num_items),
            scale=RatingScale.from_values(
                np.concatenate([np.asarray(self.scale.levels),
                                np.asarray(other.scale.levels)])),
            times=times,
        )

    # --- incremental updates (reference Ratings.cs:150-190, 255-298) ---

    def add(self, users, items, values, times=None) -> "RatingData":
        new_times = None
        if self.times is not None:
            add_t = (np.zeros(len(_as_i32(users)), dtype=np.int64)
                     if times is None else np.asarray(times, dtype=np.int64))
            new_times = np.concatenate([self.times, add_t])
        return RatingData(
            np.concatenate([self.users, _as_i32(users)]),
            np.concatenate([self.items, _as_i32(items)]),
            np.concatenate([self.values, _as_f32(values)]),
            num_users=self.num_users, num_items=self.num_items,
            scale=self.scale, times=new_times)._derived_from(
                self, "append", len(self))

    def remove_indices(self, idx) -> "RatingData":
        mask = np.ones(len(self), dtype=bool)
        mask[np.asarray(idx, dtype=np.int64)] = False
        return self._kept(mask)

    def remove_user(self, u: int) -> "RatingData":
        return self._kept(self.users != u)

    def remove_item(self, i: int) -> "RatingData":
        return self._kept(self.items != i)

    def update(self, users, items, values) -> "RatingData":
        """Overwrite the value of existing (u,i) pairs (reference UpdateRatings)."""
        new_values = self.values.copy()
        for u, i, v in zip(_as_i32(users), _as_i32(items), _as_f32(values)):
            seg = self.by_user.segment(u)
            hit = seg[self.items[seg] == i]
            if hit.size == 0:
                raise KeyError(f"no rating for user {u}, item {i}")
            new_values[hit] = v
        return RatingData(self.users, self.items, new_values,
                          num_users=self.num_users, num_items=self.num_items,
                          scale=self.scale, times=self.times)

    def try_get(self, u: int, i: int):
        """Reference DataSet.TryGetIndex — but O(log) via CSR."""
        if u < 0 or u >= self.num_users:
            return None
        seg = self.by_user.segment(u)
        hit = seg[self.items[seg] == i]
        return float(self.values[hit[0]]) if hit.size else None


class PosOnlyData(InteractionData):
    """Positive-only implicit feedback (reference Data/PosOnlyFeedback.cs)."""

    def select(self, idx: np.ndarray, num_users=None, num_items=None) -> "PosOnlyData":
        return PosOnlyData(
            self.users[idx], self.items[idx],
            num_users=num_users if num_users is not None else self.num_users,
            num_items=num_items if num_items is not None else self.num_items)

    def add(self, users, items) -> "PosOnlyData":
        return PosOnlyData(
            np.concatenate([self.users, _as_i32(users)]),
            np.concatenate([self.items, _as_i32(items)]),
            num_users=self.num_users, num_items=self.num_items)._derived_from(
                self, "append", len(self))

    def remove(self, users, items) -> "PosOnlyData":
        users, items = _as_i32(users), _as_i32(items)
        mask = np.ones(len(self), dtype=bool)
        for u, i in zip(users, items):
            mask &= ~((self.users == u) & (self.items == i))
        return self._kept(mask)

    def remove_user(self, u: int) -> "PosOnlyData":
        return self._kept(self.users != u)

    def remove_item(self, i: int) -> "PosOnlyData":
        return self._kept(self.items != i)

    def transpose(self) -> "PosOnlyData":
        """Reference PosOnlyFeedback.Transpose (:198-205)."""
        return PosOnlyData(self.items, self.users,
                           num_users=self.num_items, num_items=self.num_users)

    def contains(self, u: int, i: int) -> bool:
        return 0 <= u < self.num_users and self.by_user.contains(u, i)

    @cached_property
    def dedup_count_by_item(self) -> np.ndarray:
        """Per-item count of *distinct* users (MostPopular's ByUser mode)."""
        pairs = np.unique(np.stack([self.users, self.items], axis=1), axis=0)
        counts = np.zeros(self.num_items, dtype=np.int64)
        np.add.at(counts, pairs[:, 1], 1)
        return counts


def padded_history(csr: Csr, max_len: Optional[int] = None, pad: int = -1):
    """Densify ragged per-key histories into a padded [num_keys, L] int32 matrix
    plus a length vector. The fixed-shape form of the reference's per-user
    item lists (used by SVD++-family segment sums and BPR sampling).
    One scatter of every kept entry, no loop over the keys."""
    counts = csr.counts()
    L = int(max_len if max_len is not None else (counts.max() if counts.size else 0))
    L = max(L, 1)
    num_keys = csr.indptr.size - 1
    out = np.full((num_keys, L), pad, dtype=np.int32)
    rows = np.repeat(np.arange(num_keys, dtype=np.int64), counts)
    pos = np.arange(rows.size, dtype=np.int64) - csr.indptr[rows]
    keep = pos < L
    out[rows[keep], pos[keep]] = csr.keys[keep]
    return out, np.minimum(counts, L).astype(np.int32)
