"""File readers for interaction data.

Counterparts of reference ``IO/RatingData.cs``,
``IO/StaticRatingData.cs``, ``IO/TimedRatingData.cs``,
``IO/MovieLensRatingData.cs``, ``IO/ItemData.cs``,
``IO/ItemDataRatingThreshold.cs``, ``IO/AttributeData.cs``,
``IO/RelationData.cs``, and the transparent binary cache
``IO/FileSerializer.cs:28-80`` (here: ``.npz`` sidecar files).

Line format (reference IO/Constants.cs): columns split on tab/space/comma;
MovieLens-1M files use ``::``.

The port's own copy of ``mymedialite_tpu/data/io.py``:
the same behaviour, and no import of the JAX package.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Optional

import numpy as np

from mymedialite_tpu_torch.data.arrays import InteractionData, PosOnlyData, RatingData
from mymedialite_tpu_torch.data.mapping import IdentityMapping, Mapping

_SPLIT_RE = re.compile(r"[\t ,]+")

_CACHE_VERSION = 1


def _tokenize(line: str, separator: Optional[str] = None):
    line = line.strip()
    if separator is not None:
        return line.split(separator)
    return _SPLIT_RE.split(line)


def _cache_path(filename: str, kind: str) -> str:
    return f"{filename}.bin.{kind}.npz"


def _load_cache(filename: str, kind: str):
    path = _cache_path(filename, kind)
    try:
        if os.path.exists(path) and os.path.getmtime(path) >= os.path.getmtime(filename):
            z = np.load(path)
            if int(z.get("version", -1)) == _CACHE_VERSION:
                return z
    except (OSError, ValueError):
        pass
    return None


def _save_cache(filename: str, kind: str, **arrays):
    path = _cache_path(filename, kind)
    try:
        np.savez(path, version=np.int64(_CACHE_VERSION), **arrays)
    except OSError:
        pass  # cache is best-effort, like reference FileSerializer.CanWrite


def _identity(mapping) -> bool:
    return mapping is None or isinstance(mapping, IdentityMapping)


def read_rating_data(filename: str, user_mapping: Mapping = None,
                     item_mapping: Mapping = None, ignore_first_line: bool = False,
                     separator: Optional[str] = None, use_cache: bool = True
                     ) -> RatingData:
    """Read ``user item rating`` lines (reference IO/RatingData.cs)."""
    cacheable = use_cache and _identity(user_mapping) and _identity(item_mapping) \
        and separator is None and not ignore_first_line
    if cacheable:
        z = _load_cache(filename, "Ratings")
        if z is not None:
            return RatingData(z["users"], z["items"], z["values"])
    if _identity(user_mapping) and _identity(item_mapping) and separator is None:
        # numeric ids: the native mmap parser is ~50x faster
        from mymedialite_tpu_torch import native
        parsed = native.parse_numeric_file(filename, 3, ignore_first_line)
        if parsed is not None:
            users, items, values, _ = parsed
            data = RatingData(users, items, values)
            if cacheable:
                _save_cache(filename, "Ratings", users=data.users,
                            items=data.items, values=data.values)
            return data
    # 'or' would discard an EMPTY Mapping (falsy via __len__)
    user_mapping = IdentityMapping() if user_mapping is None else user_mapping
    item_mapping = IdentityMapping() if item_mapping is None else item_mapping
    users, items, values = [], [], []
    with open(filename) as f:
        if ignore_first_line:
            f.readline()
        for line in f:
            if not line.strip():
                continue
            tokens = _tokenize(line, separator)
            if len(tokens) < 3:
                raise ValueError(f"Expected at least 3 columns: {line!r}")
            users.append(user_mapping.to_internal(tokens[0]))
            items.append(item_mapping.to_internal(tokens[1]))
            values.append(float(tokens[2]))
    data = RatingData(users, items, values)
    if cacheable:
        _save_cache(filename, "Ratings",
                    users=data.users, items=data.items, values=data.values)
    return data


def read_rating_data_no_ratings(filename: str, user_mapping=None,
                                item_mapping=None,
                                ignore_first_line: bool = False,
                                separator: Optional[str] = None) -> RatingData:
    """``user item`` test files without a rating column (reference
    TestRatingFileFormat.WITHOUT_RATINGS, IO/StaticRatingData.cs:106):
    ratings read as 0; used with --test-no-ratings + --prediction-file."""
    user_mapping = IdentityMapping() if user_mapping is None else user_mapping
    item_mapping = IdentityMapping() if item_mapping is None else item_mapping
    users, items = [], []
    with open(filename) as f:
        if ignore_first_line:
            f.readline()
        for line in f:
            if not line.strip():
                continue
            tokens = _tokenize(line, separator)
            if len(tokens) < 2:
                raise ValueError(f"Expected at least 2 columns: {line!r}")
            users.append(user_mapping.to_internal(tokens[0]))
            items.append(item_mapping.to_internal(tokens[1]))
    return RatingData(users, items,
                      np.zeros(len(users), dtype=np.float32))


def read_movielens_1m_rating_data(filename: str, user_mapping=None,
                                  item_mapping=None) -> RatingData:
    """MovieLens-1M ``user::item::rating::timestamp`` format
    (reference IO/MovieLensRatingData.cs)."""
    # 'or' would discard an EMPTY Mapping (falsy via __len__)
    user_mapping = IdentityMapping() if user_mapping is None else user_mapping
    item_mapping = IdentityMapping() if item_mapping is None else item_mapping
    users, items, values, times = [], [], [], []
    with open(filename) as f:
        for line in f:
            if not line.strip():
                continue
            tokens = line.strip().split("::")
            if len(tokens) < 3:
                raise ValueError(f"Expected at least 3 '::' columns: {line!r}")
            users.append(user_mapping.to_internal(tokens[0]))
            items.append(item_mapping.to_internal(tokens[1]))
            values.append(float(tokens[2]))
            times.append(int(tokens[3]) if len(tokens) > 3 else 0)
    return RatingData(users, items, values, times=times)


def _parse_time(date_string: str) -> int:
    """Unix seconds from the reference's accepted time formats
    (IO/TimedRatingData.cs:100-135): integer epoch seconds,
    'YYYY-MM-DD', 'YYYY-MM-DD hh:mm:ss', or ISO-parseable datetimes."""
    date_string = date_string.strip().strip('"')
    try:
        return int(date_string)
    except ValueError:
        pass
    dt = None
    for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            dt = datetime.datetime.strptime(date_string, fmt)
            break
        except ValueError:
            continue
    if dt is None:
        dt = datetime.datetime.fromisoformat(date_string)
    return int(dt.replace(tzinfo=datetime.timezone.utc).timestamp())


def read_timed_rating_data(filename: str, user_mapping=None, item_mapping=None,
                           ignore_first_line: bool = False) -> RatingData:
    """``user item rating time`` lines (reference IO/TimedRatingData.cs)."""
    # 'or' would discard an EMPTY Mapping (falsy via __len__)
    user_mapping = IdentityMapping() if user_mapping is None else user_mapping
    item_mapping = IdentityMapping() if item_mapping is None else item_mapping
    users, items, values, times = [], [], [], []
    with open(filename) as f:
        if ignore_first_line:
            f.readline()
        for line in f:
            if not line.strip():
                continue
            tokens = _tokenize(line)
            if len(tokens) < 4:
                raise ValueError(f"Expected at least 4 columns: {line!r}")
            users.append(user_mapping.to_internal(tokens[0]))
            items.append(item_mapping.to_internal(tokens[1]))
            values.append(float(tokens[2]))
            times.append(_parse_time(tokens[3]))
    return RatingData(users, items, values, times=times)


def read_item_data(filename: str, user_mapping=None, item_mapping=None,
                   ignore_first_line: bool = False, use_cache: bool = True
                   ) -> PosOnlyData:
    """``user item`` positive-feedback pairs (reference IO/ItemData.cs)."""
    cacheable = use_cache and _identity(user_mapping) and _identity(item_mapping) \
        and not ignore_first_line
    if cacheable:
        z = _load_cache(filename, "PosOnlyFeedback")
        if z is not None:
            return PosOnlyData(z["users"], z["items"])
    if _identity(user_mapping) and _identity(item_mapping):
        from mymedialite_tpu_torch import native
        parsed = native.parse_numeric_file(filename, 2, ignore_first_line)
        if parsed is not None:
            users, items, _, _ = parsed
            data = PosOnlyData(users, items)
            if cacheable:
                _save_cache(filename, "PosOnlyFeedback",
                            users=data.users, items=data.items)
            return data
    # 'or' would discard an EMPTY Mapping (falsy via __len__)
    user_mapping = IdentityMapping() if user_mapping is None else user_mapping
    item_mapping = IdentityMapping() if item_mapping is None else item_mapping
    users, items = [], []
    with open(filename) as f:
        if ignore_first_line:
            f.readline()
        for line in f:
            if not line.strip():
                continue
            tokens = _tokenize(line)
            if len(tokens) < 2:
                raise ValueError(f"Expected at least 2 columns: {line!r}")
            users.append(user_mapping.to_internal(tokens[0]))
            items.append(item_mapping.to_internal(tokens[1]))
    data = PosOnlyData(users, items)
    if cacheable:
        _save_cache(filename, "PosOnlyFeedback", users=data.users, items=data.items)
    return data


def read_item_data_rating_threshold(filename: str, rating_threshold: float,
                                    user_mapping=None, item_mapping=None,
                                    ignore_first_line: bool = False) -> PosOnlyData:
    """Rating file -> implicit feedback, keeping ratings >= threshold
    (reference IO/ItemDataRatingThreshold.cs)."""
    # 'or' would discard an EMPTY Mapping (falsy via __len__)
    user_mapping = IdentityMapping() if user_mapping is None else user_mapping
    item_mapping = IdentityMapping() if item_mapping is None else item_mapping
    users, items = [], []
    with open(filename) as f:
        if ignore_first_line:
            f.readline()
        for line in f:
            if not line.strip():
                continue
            tokens = _tokenize(line)
            if len(tokens) < 3:
                raise ValueError(f"Expected at least 3 columns: {line!r}")
            if float(tokens[2]) >= rating_threshold:
                users.append(user_mapping.to_internal(tokens[0]))
                items.append(item_mapping.to_internal(tokens[1]))
    return PosOnlyData(users, items)


def read_attribute_data(filename: str, mapping: Mapping = None,
                        ignore_first_line: bool = False) -> InteractionData:
    """``entity_id attribute_id`` binary attribute pairs
    (reference IO/AttributeData.cs:51-80; attribute ids are raw ints).
    Returned as an InteractionData with users=entities, items=attributes."""
    mapping = IdentityMapping() if mapping is None else mapping
    entities, attrs = [], []
    with open(filename) as f:
        if ignore_first_line:
            f.readline()
        for line in f:
            if not line.strip():
                continue
            tokens = _tokenize(line)
            if len(tokens) < 2:
                raise ValueError(f"Expected at least 2 columns: {line!r}")
            entities.append(mapping.to_internal(tokens[0]))
            attrs.append(int(tokens[1]))
    return InteractionData(entities, attrs)


def read_relation_data(filename: str, mapping: Mapping = None,
                       ignore_first_line: bool = False) -> InteractionData:
    """``entity entity`` binary relation pairs (reference IO/RelationData.cs);
    both columns go through the same mapping."""
    mapping = IdentityMapping() if mapping is None else mapping
    e1, e2 = [], []
    with open(filename) as f:
        if ignore_first_line:
            f.readline()
        for line in f:
            if not line.strip():
                continue
            tokens = _tokenize(line)
            if len(tokens) < 2:
                raise ValueError(f"Expected at least 2 columns: {line!r}")
            e1.append(mapping.to_internal(tokens[0]))
            e2.append(mapping.to_internal(tokens[1]))
    return InteractionData(e1, e2)
