"""Dataset statistics lines for the CLI output contract.

Counterpart of reference ``Data/Extensions.cs:34-133``: the
"training data: N users, M items, K ratings, sparsity S" block the
command-line programs write to stdout after loading/splitting the data
(``Programs/RatingPrediction/RatingPrediction.cs:200``,
``Programs/ItemRecommendation/ItemRecommendation.cs:193``).

The port's own copy of ``mymedialite_tpu/data/statistics.py``:
the same behaviour, and no import of the JAX package.
"""

from __future__ import annotations

import time as _time

import numpy as np


def _sparsity_str(num_users: int, num_items: int, count: int) -> str:
    """C# ``{0,0:0.#####}`` with InvariantCulture: up to five fractional
    digits, trailing zeros (and a bare decimal point) trimmed."""
    matrix_size = num_users * num_items
    if matrix_size == 0:
        sparsity = 100.0
    else:
        sparsity = 100.0 * (matrix_size - count) / matrix_size
    s = f"{sparsity:.5f}".rstrip("0").rstrip(".")
    return s if s else "0"


def _fmt_time(unix_seconds: int) -> str:
    """C# ``string.Format(InvariantCulture, "{0}", DateTime)`` renders as
    MM/dd/yyyy HH:mm:ss."""
    return _time.strftime("%m/%d/%Y %H:%M:%S", _time.gmtime(unix_seconds))


def _interactions_block(data, test, noun: str) -> str:
    lines = []

    def one(label, d):
        users = d.all_users
        items = d.all_items
        lines.append(
            f"{label} {users.size} users, {items.size} items, "
            f"{len(d)} {noun}, sparsity "
            f"{_sparsity_str(users.size, items.size, len(d))}")
        times = getattr(d, "times", None)
        if times is not None and times.size:
            lines.append(f"rating period: {_fmt_time(int(times.min()))} "
                         f"to {_fmt_time(int(times.max()))}")

    one("training data:", data)
    if test is not None:
        one("test data:    ", test)
    return "".join(line + "\n" for line in lines)


def ratings_statistics(train, test=None, user_attributes=None,
                       item_attributes=None,
                       display_overlap: bool = False) -> str:
    """Reference ``Data/Extensions.cs:34-81`` (IRatings overload):
    training/test user-item-rating counts with percent sparsity, the
    rating period for timed data, optional train/test overlap."""
    s = _interactions_block(train, test, "ratings")
    if display_overlap and test is not None:
        t0 = _time.time()
        new_users = np.setdiff1d(test.all_users, train.all_users).size
        new_items = np.setdiff1d(test.all_items, train.all_items).size
        elapsed = _time.time() - t0
        s += (f"{new_users} new users, {new_items} new items "
              f"({elapsed:.6f} seconds)\n")
    return s + attribute_statistics(user_attributes, item_attributes)


def posonly_statistics(train, test=None, user_attributes=None,
                       item_attributes=None) -> str:
    """Reference ``Data/Extensions.cs:88-111`` (IPosOnlyFeedback
    overload): same block with "events" instead of "ratings"."""
    s = _interactions_block(train, test, "events")
    return s + attribute_statistics(user_attributes, item_attributes)


def attribute_statistics(user_attributes=None, item_attributes=None) -> str:
    """Reference ``Data/Extensions.cs:117-133``. Attribute matrices are
    InteractionData with users=entities, items=attribute ids. Mirrors the
    reference quirk that the user line counts NumberOfColumns (max id+1)
    while the item line counts distinct attributes (NonEmptyColumnIDs)."""
    s = ""
    if user_attributes is not None:
        s += (f"{user_attributes.num_items} user attributes for "
              f"{user_attributes.num_users} users, "
              f"{len(user_attributes)} assignments, "
              f"{user_attributes.all_users.size} users with attribute "
              "assignments\n")
    if item_attributes is not None:
        s += (f"{item_attributes.all_items.size} item attributes for "
              f"{item_attributes.num_users} items, "
              f"{len(item_attributes)} assignments, "
              f"{item_attributes.all_users.size} items with attribute "
              "assignments\n")
    return s
