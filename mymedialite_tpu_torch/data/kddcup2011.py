"""KDD Cup 2011 (Yahoo! Music) data support.

TPU-native counterparts of reference ``IO/KDDCup2011/{Ratings,Items,
Track2Items}.cs`` and ``Data/KDDCupItems.cs:24``: the per-user blocked
rating format (``user|count`` header line, then ``item<TAB>rating[<TAB>...]``
lines) and the track/album/artist/genre taxonomy.

The port's own copy of ``mymedialite_tpu/data/kddcup2011.py`` (numpy
and ``data.arrays`` only): the same readers and the same results. The
CLIs do not read this format (``--file-format kddcup_2011`` reads the
default rating format, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np

from mymedialite_tpu_torch.data.arrays import RatingData


def read_kddcup_ratings(filename: str) -> RatingData:
    """Track 1 training format (reference IO/KDDCup2011/Ratings.Read):
    ``user|num_ratings`` then per-rating ``item<TAB>rating`` lines.
    Values stored uint8-ly in the reference (StaticByteRatings); here the
    COO values array is float32 regardless."""
    users, items, values = [], [], []
    with open(filename) as f:
        for line in f:
            if not line.strip():
                continue
            user_part, count = line.split("|")
            user_id = int(user_part)
            for _ in range(int(count)):
                tokens = f.readline().split("\t")
                users.append(user_id)
                items.append(int(tokens[0]))
                values.append(float(tokens[1]))
    return RatingData(users, items, values)


def read_kddcup_test_ratings(filename: str) -> RatingData:
    """Track 1 test format: like the training format but without rating
    values (reference ReadTest; ratings set to 0)."""
    users, items = [], []
    with open(filename) as f:
        for line in f:
            if not line.strip():
                continue
            user_part, count = line.split("|")
            user_id = int(user_part)
            for _ in range(int(count)):
                tokens = f.readline().split("\t")
                users.append(user_id)
                items.append(int(tokens[0]))
    return RatingData(users, items, np.zeros(len(users), dtype=np.float32))


class KDDCupItemType(enum.Enum):
    NONE = 0
    TRACK = 1
    ALBUM = 2
    ARTIST = 3
    GENRE = 4


@dataclasses.dataclass
class _ItemInfo:
    type: KDDCupItemType = KDDCupItemType.NONE
    album: int = -1
    artist: int = -1
    genres: Optional[List[int]] = None


class KDDCupItems:
    """Track/album/artist/genre taxonomy (reference Data/KDDCupItems.cs)."""

    def __init__(self, size: int = 0):
        self._items = {}

    def insert(self, item_id: int, item_type: KDDCupItemType,
               album: int = -1, artist: int = -1, genres=None):
        self._items[item_id] = _ItemInfo(item_type, album, artist,
                                         list(genres) if genres else None)

    def get_type(self, item_id: int) -> KDDCupItemType:
        return self._items.get(item_id, _ItemInfo()).type

    def get_album(self, item_id: int) -> int:
        return self._items.get(item_id, _ItemInfo()).album

    def get_artist(self, item_id: int) -> int:
        return self._items.get(item_id, _ItemInfo()).artist

    def get_genres(self, item_id: int):
        return self._items.get(item_id, _ItemInfo()).genres or []

    def has_album(self, item_id: int) -> bool:
        return self.get_album(item_id) != -1

    def has_artist(self, item_id: int) -> bool:
        return self.get_artist(item_id) != -1

    def has_genres(self, item_id: int) -> bool:
        return bool(self.get_genres(item_id))


def _parse_int(token: str) -> int:
    token = token.strip()
    return -1 if token in ("", "None") else int(token)


def read_kddcup_items(tracks_filename: str, albums_filename: str,
                      artists_filename: str, genres_filename: str
                      ) -> KDDCupItems:
    """Reference IO/KDDCup2011/Items.Read: '|'-separated taxonomy files."""
    items = KDDCupItems()
    with open(tracks_filename) as f:
        for line in f:
            if not line.strip():
                continue
            t = line.rstrip("\n").split("|")
            items.insert(int(t[0]), KDDCupItemType.TRACK,
                         album=_parse_int(t[1]) if len(t) > 1 else -1,
                         artist=_parse_int(t[2]) if len(t) > 2 else -1,
                         genres=[int(g) for g in t[3:] if g.strip()])
    with open(albums_filename) as f:
        for line in f:
            if not line.strip():
                continue
            t = line.rstrip("\n").split("|")
            items.insert(int(t[0]), KDDCupItemType.ALBUM,
                         artist=_parse_int(t[1]) if len(t) > 1 else -1,
                         genres=[int(g) for g in t[2:] if g.strip()])
    with open(artists_filename) as f:
        for line in f:
            if line.strip():
                items.insert(int(line.split("|")[0]), KDDCupItemType.ARTIST)
    with open(genres_filename) as f:
        for line in f:
            if line.strip():
                items.insert(int(line.split("|")[0]), KDDCupItemType.GENRE)
    return items
