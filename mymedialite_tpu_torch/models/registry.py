"""Lazy model registry of the port, under the JAX package's names.

Every name of ``mymedialite_tpu/models/registry.py`` is listed; the ones
whose port is not written yet raise ``KeyError`` saying so.
"""

from __future__ import annotations

import importlib

from mymedialite_tpu.models import registry as _jax_registry
from mymedialite_tpu.utils.params import configure

# name -> "module:Class" of the models ported so far
PORTED_RATING_PREDICTORS = {
    "MatrixFactorization":
        "mymedialite_tpu_torch.models.mf:MatrixFactorization",
    "BiasedMatrixFactorization":
        "mymedialite_tpu_torch.models.mf:BiasedMatrixFactorization",
}
PORTED_ITEM_RECOMMENDERS: dict = {}


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
                    _jax_registry.RATING_PREDICTORS, name)
    if options:
        configure(model, options)
    return model


def create_item_recommender(name: str):
    return _create(PORTED_ITEM_RECOMMENDERS,
                   _jax_registry.ITEM_RECOMMENDERS, name)


def list_rating_predictors():
    """Every rating predictor name the framework knows, ported or not."""
    return sorted(_jax_registry.RATING_PREDICTORS)


def list_item_recommenders():
    return sorted(_jax_registry.ITEM_RECOMMENDERS)
