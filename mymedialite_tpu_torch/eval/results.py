"""Evaluation result containers with the reference's output-line contract.

Counterpart of reference ``Eval/EvaluationResults.cs:26-91``,
``ItemRecommendationEvaluationResults.cs``,
``RatingPredictionEvaluationResults.cs``. The ``__str__`` format
("RMSE 0.9… MAE 0.7…" / "AUC 0.9… prec@5 0.3… num_items N num_lists N")
is machine-readable and golden-diffed by the CLI tests.

The port's own copy of ``mymedialite_tpu/eval/results.py``:
the same behaviour, and no import of the JAX package.
"""

from __future__ import annotations


def _fmt_float(x: float) -> str:
    # the reference's "0.#####" format: up to 5 decimals, no trailing zeros
    s = f"{x:.5f}".rstrip("0").rstrip(".")
    return s if s not in ("", "-0") else "0"


class EvaluationResults(dict):
    measures_to_show = ()
    ints_to_show = ()

    def __str__(self) -> str:
        parts = [f"{m} {_fmt_float(self[m])}" for m in self.measures_to_show]
        parts += [f"{i} {int(self[i])}" for i in self.ints_to_show]
        s = " ".join(parts)
        if "fit" in self:
            s += f" fit {_fmt_float(self['fit'])}"
        return s

    @classmethod
    def average(cls, result_list):
        """Fold averaging (reference EvaluationResults.cs:60-69)."""
        out = cls()
        for key in result_list[0]:
            out[key] = sum(r[key] for r in result_list) / len(result_list)
        return out


class RatingPredictionResults(EvaluationResults):
    measures_to_show = ("RMSE", "MAE", "CBD")

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # cold-start breakdowns (reference Eval/Ratings.cs:82-92)
        self.new_user_results = None
        self.new_item_results = None
        self.new_user_new_item_results = None


class ItemRecommendationResults(EvaluationResults):
    measures_to_show = ("AUC", "prec@5")
    ints_to_show = ("num_items", "num_lists")

    ALL_MEASURES = ("AUC", "MAP", "NDCG", "MRR",
                    "prec@5", "prec@10", "recall@5", "recall@10")

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        for m in self.ALL_MEASURES:
            self.setdefault(m, 0.0)
