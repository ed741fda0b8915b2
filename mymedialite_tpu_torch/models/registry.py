"""Lazy model registry of the port, under the JAX package's names.

Every name of ``mymedialite_tpu/models/registry.py`` is listed (the
port keeps its own copy of the name tables); the ones whose port is not
written yet raise ``KeyError`` saying so.
"""

from __future__ import annotations

import importlib

from mymedialite_tpu_torch.utils.params import configure

# every model name of the framework, as in mymedialite_tpu/models/registry.py
RATING_PREDICTORS = frozenset((
    "GlobalAverage", "UserAverage", "ItemAverage", "Constant", "Random",
    "UserItemBaseline", "MatrixFactorization", "BiasedMatrixFactorization",
    "SocialMF", "TimeAwareBaseline", "TimeAwareBaselineWithFrequencies",
    "ExternalRatingPredictor", "SVDPlusPlus", "GSVDPlusPlus",
    "SigmoidSVDPlusPlus", "SigmoidItemAsymmetricFactorModel",
    "SigmoidUserAsymmetricFactorModel",
    "SigmoidCombinedAsymmetricFactorModel", "UserKNN", "ItemKNN",
    "UserAttributeKNN", "ItemAttributeKNN",
))
ITEM_RECOMMENDERS = frozenset((
    "MostPopular", "Zero", "Random", "BPRMF", "MultiCoreBPRMF",
    "WeightedBPRMF", "SoftMarginRankingMF", "WRMF", "LeastSquareSLIM",
    "BPRSLIM", "MostPopularByAttributes", "BigramRules",
    "ExternalItemRecommender", "UserKNN", "ItemKNN", "UserAttributeKNN",
    "ItemAttributeKNN",
))

# name -> "module:Class" of the models ported so far
PORTED_RATING_PREDICTORS = {
    **{name: f"mymedialite_tpu_torch.models.baselines:{name}" for name in (
        "GlobalAverage", "UserAverage", "ItemAverage", "Constant",
        "UserItemBaseline")},
    "Random": "mymedialite_tpu_torch.models.baselines:RandomRating",
    "MatrixFactorization":
        "mymedialite_tpu_torch.models.mf:MatrixFactorization",
    "BiasedMatrixFactorization":
        "mymedialite_tpu_torch.models.mf:BiasedMatrixFactorization",
    **{name: f"mymedialite_tpu_torch.models.svdpp:{name}" for name in (
        "SVDPlusPlus", "GSVDPlusPlus", "SigmoidSVDPlusPlus",
        "SigmoidItemAsymmetricFactorModel",
        "SigmoidUserAsymmetricFactorModel",
        "SigmoidCombinedAsymmetricFactorModel")},
    **{name: f"mymedialite_tpu_torch.models.knn:{name}Rating" for name in (
        "UserKNN", "ItemKNN", "UserAttributeKNN", "ItemAttributeKNN")},
}
PORTED_ITEM_RECOMMENDERS = {
    **{name: f"mymedialite_tpu_torch.models.item_baselines:{name}" for name in (
        "MostPopular", "Zero", "MostPopularByAttributes", "BigramRules")},
    "Random": "mymedialite_tpu_torch.models.item_baselines:RandomItem",
    "BPRMF": "mymedialite_tpu_torch.models.bpr:BPRMF",
    "WeightedBPRMF": "mymedialite_tpu_torch.models.bpr:WeightedBPRMF",
    "SoftMarginRankingMF":
        "mymedialite_tpu_torch.models.bpr:SoftMarginRankingMF",
    "WRMF": "mymedialite_tpu_torch.models.wrmf:WRMF",
    **{name: f"mymedialite_tpu_torch.models.knn:{name}" for name in (
        "UserKNN", "ItemKNN", "UserAttributeKNN", "ItemAttributeKNN")},
}


def _create(ported, known, name: str):
    if name in ported:
        module_name, class_name = ported[name].split(":")
        return getattr(importlib.import_module(module_name), class_name)()
    if name in known:
        raise KeyError(f"{name!r} is not yet ported to mymedialite_tpu_torch")
    raise KeyError(f"Unknown recommender {name!r}; known: "
                   f"{', '.join(sorted(known))}")


def create_rating_predictor(name: str, options: str = ""):
    """A new rating predictor, configured from ``options`` (the
    ``--recommender-options`` syntax, e.g. "num_factors=40 device=cuda")."""
    model = _create(PORTED_RATING_PREDICTORS,
                    RATING_PREDICTORS, name)
    if options:
        configure(model, options)
    return model


def create_item_recommender(name: str, options: str = ""):
    """A new item recommender, configured from ``options``."""
    model = _create(PORTED_ITEM_RECOMMENDERS,
                    ITEM_RECOMMENDERS, name)
    if options:
        configure(model, options)
    return model


def list_rating_predictors():
    """Every rating predictor name the framework knows, ported or not."""
    return sorted(RATING_PREDICTORS)


def list_item_recommenders():
    return sorted(ITEM_RECOMMENDERS)
