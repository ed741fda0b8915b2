"""Rating scale: observed rating levels, min/max.

Counterpart of reference ``Data/RatingScale.cs:30-118``.

The port's own copy of ``mymedialite_tpu/data/scale.py``:
the same behaviour, and no import of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RatingScale:
    """The set of observed rating levels of a dataset.

    ``levels`` is sorted ascending. ``min`` / ``max`` bound predictions
    (used for clamping, and for the sigmoid range of BiasedMF).
    """

    levels: tuple  # sorted tuple of floats

    @property
    def min(self) -> float:
        return self.levels[0]

    @property
    def max(self) -> float:
        return self.levels[-1]

    @property
    def range(self) -> float:
        return self.max - self.min

    def level_id(self, value: float) -> int:
        """Index of a rating level (reference RatingScale.LevelID)."""
        return self.levels.index(value)

    @staticmethod
    def from_values(values) -> "RatingScale":
        values = np.asarray(values, dtype=np.float64)
        if values.size > 2_000_000:
            # big-data fast path: a full 20M-element np.unique (sort) +
            # a 20M-entry Python tuple cost ~5 s at the Netflix shape.
            # Rating scales have FEW levels in practice — detect them on
            # a sample, then verify exactly with one vectorized isin;
            # continuous values collapse to the (min, max) bounds, which
            # is all any consumer of a dense scale uses.
            sample = np.unique(values[:: max(1, values.size // 65536)])
            if sample.size > 1024:
                return RatingScale((float(values.min()), float(values.max())))
            extras = np.unique(values[~np.isin(values, sample)])
            levels = np.union1d(sample, extras)
            if levels.size > 4096:
                return RatingScale((float(levels[0]), float(levels[-1])))
        else:
            levels = np.unique(values)
        if levels.size == 0:
            levels = np.array([0.0, 1.0])
        return RatingScale(tuple(float(v) for v in levels))

    @staticmethod
    def from_min_max(lo: float, hi: float) -> "RatingScale":
        return RatingScale((float(lo), float(hi)))
