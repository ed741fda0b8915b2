"""Lazy model registry of the port, under the JAX package's names.

Every name of ``mymedialite_tpu/models/registry.py`` resolves to the
port's class of that model (the port keeps its own copy of the name
tables); an unknown name raises ``KeyError`` with the known names.
"""

from __future__ import annotations

import importlib

from mymedialite_tpu_torch.utils.params import configure

_M = "mymedialite_tpu_torch.models"

# name -> "module:Class", as in mymedialite_tpu/models/registry.py
RATING_PREDICTOR_CLASSES = {
    **{name: f"{_M}.baselines:{name}" for name in (
        "GlobalAverage", "UserAverage", "ItemAverage", "Constant",
        "UserItemBaseline")},
    "Random": f"{_M}.baselines:RandomRating",
    "MatrixFactorization": f"{_M}.mf:MatrixFactorization",
    "BiasedMatrixFactorization": f"{_M}.mf:BiasedMatrixFactorization",
    "SocialMF": f"{_M}.social_mf:SocialMF",
    "TimeAwareBaseline": f"{_M}.time_aware:TimeAwareBaseline",
    "TimeAwareBaselineWithFrequencies":
        f"{_M}.time_aware:TimeAwareBaselineWithFrequencies",
    "ExternalRatingPredictor": f"{_M}.external:ExternalRatingPredictor",
    **{name: f"{_M}.svdpp:{name}" for name in (
        "SVDPlusPlus", "GSVDPlusPlus", "SigmoidSVDPlusPlus",
        "SigmoidItemAsymmetricFactorModel",
        "SigmoidUserAsymmetricFactorModel",
        "SigmoidCombinedAsymmetricFactorModel")},
    **{name: f"{_M}.knn:{name}Rating" for name in (
        "UserKNN", "ItemKNN", "UserAttributeKNN", "ItemAttributeKNN")},
}
ITEM_RECOMMENDER_CLASSES = {
    **{name: f"{_M}.item_baselines:{name}" for name in (
        "MostPopular", "Zero", "MostPopularByAttributes", "BigramRules")},
    "Random": f"{_M}.item_baselines:RandomItem",
    **{name: f"{_M}.bpr:{name}" for name in (
        "BPRMF", "MultiCoreBPRMF", "WeightedBPRMF", "SoftMarginRankingMF")},
    "WRMF": f"{_M}.wrmf:WRMF",
    "LeastSquareSLIM": f"{_M}.slim:LeastSquareSLIM",
    "BPRSLIM": f"{_M}.slim:BPRSLIM",
    "ExternalItemRecommender": f"{_M}.external:ExternalItemRecommender",
    **{name: f"{_M}.knn:{name}" for name in (
        "UserKNN", "ItemKNN", "UserAttributeKNN", "ItemAttributeKNN")},
}
RATING_PREDICTORS = frozenset(RATING_PREDICTOR_CLASSES)
ITEM_RECOMMENDERS = frozenset(ITEM_RECOMMENDER_CLASSES)


def _create(classes, name: str):
    if name not in classes:
        raise KeyError(f"Unknown recommender {name!r}; known: "
                       f"{', '.join(sorted(classes))}")
    module_name, class_name = classes[name].split(":")
    return getattr(importlib.import_module(module_name), class_name)()


def create_rating_predictor(name: str, options: str = ""):
    """A new rating predictor, configured from ``options`` (the
    ``--recommender-options`` syntax, e.g. "num_factors=40 device=cuda")."""
    model = _create(RATING_PREDICTOR_CLASSES, name)
    if options:
        configure(model, options)
    return model


def create_item_recommender(name: str, options: str = ""):
    """A new item recommender, configured from ``options``."""
    model = _create(ITEM_RECOMMENDER_CLASSES, name)
    if options:
        configure(model, options)
    return model


def list_rating_predictors():
    return sorted(RATING_PREDICTORS)


def list_item_recommenders():
    return sorted(ITEM_RECOMMENDERS)
