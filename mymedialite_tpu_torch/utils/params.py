"""Hyperparameter configuration: ``key=value`` strings applied to models.

Counterpart of reference ``RecommenderParameters.cs:29-262``
plus ``Extensions.Configure/SetProperty`` (``Extensions.cs:46,103-165``):
case-insensitive, underscore-stripping *prefix* matching against the
model's declared hyperparameters. Instead of .NET reflection, models
declare hyperparameters explicitly via the ``HYPERPARAMS`` dict
(name -> python type), which also drives the ``__str__`` echo contract
(reference IRecommender.ToString, IRecommender.cs:78-81).

The port's own copy of ``mymedialite_tpu/utils/params.py``:
the same behaviour, and no import of the JAX package.
"""

from __future__ import annotations

from typing import Dict


def parse_options(option_string: str) -> Dict[str, str]:
    """Parse ``"a=1 b=2"`` (space- or comma-separated) into a dict
    (reference RecommenderParameters.cs:38-60)."""
    result = {}
    if not option_string:
        return result
    for token in option_string.replace(",", " ").split():
        if "=" not in token:
            raise ValueError(f"Expected key=value, got {token!r}")
        key, value = token.split("=", 1)
        result[key] = value
    return result


def _normalize(name: str) -> str:
    return name.replace("_", "").lower()


def match_param(key: str, param_names) -> str:
    """Case-insensitive, underscore-stripped prefix match of ``key`` against
    declared names (reference Extensions.SetProperty, Extensions.cs:103-165).
    Exact (normalized) matches win; otherwise a unique prefix match."""
    nkey = _normalize(key)
    normalized = {name: _normalize(name) for name in param_names}
    for name, n in normalized.items():
        if n == nkey:
            return name
    candidates = [name for name, n in normalized.items() if n.startswith(nkey)]
    if len(candidates) == 1:
        return candidates[0]
    if not candidates:
        raise KeyError(f"Unknown hyperparameter {key!r}; known: {sorted(param_names)}")
    raise KeyError(f"Ambiguous hyperparameter {key!r}: matches {sorted(candidates)}")


def _coerce(value: str, ty):
    if ty is bool:
        return value.lower() in ("true", "1", "yes")
    if ty is int:
        return int(value)
    if ty is float:
        return float(value)
    if isinstance(ty, type) and hasattr(ty, "__members__"):  # Enum
        for member in ty:
            if member.name.lower() == value.lower() or \
                    str(member.value).lower() == value.lower():
                return member
        raise KeyError(f"unknown value {value!r} for {ty.__name__}")
    return ty(value)


def configure(model, option_string: str):
    """Apply a ``--recommender-options`` string to a model instance.

    Accepts everything in ``HYPERPARAMS`` plus ``EXTRA_PARAMS`` (settable
    but not echoed — e.g. the reference's ``regularization`` shorthand that
    fans out to reg_u/reg_i on BiasedMF)."""
    hyperparams = dict(getattr(model, "HYPERPARAMS", {}))
    hyperparams.update(getattr(model, "EXTRA_PARAMS", {}))
    for key, value in parse_options(option_string).items():
        name = match_param(key, hyperparams.keys())
        setattr(model, name, _coerce(value, hyperparams[name]))
    return model


def echo(model) -> str:
    """The hyperparameter-echo string: ``ModelName hp1=v1 hp2=v2``
    (reference ToString contract, e.g. BiasedMatrixFactorization.cs:555-562)."""
    hyperparams = getattr(model, "HYPERPARAMS", {})
    parts = [type(model).__name__]
    for name in hyperparams:
        value = getattr(model, name)
        if hasattr(value, "value") and hasattr(value, "name"):  # Enum
            value = value.value
        elif isinstance(value, bool):
            value = "True" if value else "False"
        elif isinstance(value, float):
            value = f"{value:g}"
        parts.append(f"{name}={value}")
    return " ".join(parts)
