"""Nelder-Mead simplex hyperparameter search of the port.

Port of ``mymedialite_tpu/hyperopt.py`` (reference
``HyperParameter/NelderMead.cs:28-284``, ``FindMinimum`` at :171): the
same per-model hyperparameter sets and initial simplexes, the standard
moves (reflection alpha=1, expansion gamma=2, contraction rho=0.5,
shrink sigma=0.5), 50 iterations, non-negative points, and a 0.2
holdout split of the recommender's ratings, drawn from the given
``numpy`` generator (``default_rng(42)`` unless one is given). Each
evaluation prints "Nelder-Mead: <options>: <measure>" on standard error.
"""

from __future__ import annotations

import sys

import numpy as np

from mymedialite_tpu_torch.data.splits import simple_split
from mymedialite_tpu_torch.eval.rating import evaluate_ratings
from mymedialite_tpu_torch.utils.params import configure

ALPHA = 1.0
GAMMA = 2.0
RHO = 0.5
SIGMA = 0.5
NUM_IT = 50
SPLIT_RATIO = 0.2

# per-model hyperparameter sets and initial simplexes
# (reference NelderMead.Init :110-167)
HP_SPACES = {
    "UserItemBaseline": (
        ["reg_u", "reg_i"],
        [[25, 10], [10, 25], [2, 5], [5, 2], [1, 4], [4, 1], [3, 3]],
    ),
    "BiasedMatrixFactorization": (
        ["regularization", "bias_reg"],
        [[0.1, 0], [0.01, 0], [0.0001, 0], [0.00001, 0],
         [0.1, 0.0001], [0.01, 0.0001], [0.0001, 0.0001],
         [0.00001, 0.0001]],
    ),
    "MatrixFactorization": (
        ["regularization"],
        [[0.1], [0.01], [0.0001], [0.00001]],
    ),
}


class NelderMead:
    def __init__(self, evaluation_measure: str, recommender, rng=None):
        self.measure = evaluation_measure
        self.recommender = recommender
        self.rng = rng or np.random.default_rng(42)
        space = None
        for cls in type(recommender).__mro__:
            if cls.__name__ in HP_SPACES:
                space = HP_SPACES[cls.__name__]
                break
        if space is None:
            raise ValueError(
                f"not prepared for type {type(recommender).__name__}")
        self.hp_names, init = space
        self.simplex = [np.asarray(v, dtype=np.float64) for v in init]
        self._train, self._valid = simple_split(recommender.ratings,
                                                SPLIT_RATIO, self.rng)

    def _config_string(self, vector):
        return " ".join(f"{n}={v}" for n, v in zip(self.hp_names, vector))

    def _evaluate(self, vector) -> float:
        vector = np.maximum(vector, 0.0)  # EnsureNonNegativity
        configure(self.recommender, self._config_string(vector))
        self.recommender.ratings = self._train
        self.recommender.train()
        result = evaluate_ratings(self.recommender, self._valid)[self.measure]
        print(f"Nelder-Mead: {self._config_string(vector)}: {result}",
              file=sys.stderr)
        return float(result)

    def find_minimum(self) -> float:
        """Reference FindMinimum (:171-284): sets the recommender to the
        best hyperparameters, its ratings back to the whole data, and
        returns the best measure value."""
        values = {tuple(v): self._evaluate(v) for v in self.simplex}
        points = [np.asarray(k) for k in values]

        for _ in range(int(NUM_IT)):
            points.sort(key=lambda p: values[tuple(p)])
            best, worst = points[0], points[-1]
            center = np.mean(points[:-1], axis=0)

            # reflection
            reflected = np.maximum(center + ALPHA * (center - worst), 0)
            f_r = self._evaluate(reflected)
            f_best = values[tuple(best)]
            f_second_worst = values[tuple(points[-2])]
            if f_best <= f_r < f_second_worst:
                values.pop(tuple(worst))
                values[tuple(reflected)] = f_r
                points[-1] = reflected
                continue
            if f_r < f_best:
                # expansion
                expanded = np.maximum(center + GAMMA * (center - worst), 0)
                f_e = self._evaluate(expanded)
                values.pop(tuple(worst))
                if f_e < f_r:
                    values[tuple(expanded)] = f_e
                    points[-1] = expanded
                else:
                    values[tuple(reflected)] = f_r
                    points[-1] = reflected
                continue
            # contraction
            contracted = np.maximum(worst + RHO * (center - worst), 0)
            f_c = self._evaluate(contracted)
            if f_c < values[tuple(worst)]:
                values.pop(tuple(worst))
                values[tuple(contracted)] = f_c
                points[-1] = contracted
                continue
            # shrink toward the best point
            new_points = [best]
            new_values = {tuple(best): values[tuple(best)]}
            for p in points[1:]:
                shrunk = np.maximum(best + SIGMA * (p - best), 0)
                new_values[tuple(shrunk)] = self._evaluate(shrunk)
                new_points.append(shrunk)
            points, values = new_points, new_values

        points.sort(key=lambda p: values[tuple(p)])
        best = points[0]
        configure(self.recommender, self._config_string(best))
        self.recommender.ratings = self._train.concat(self._valid)
        return values[tuple(best)]
