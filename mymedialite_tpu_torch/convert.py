"""Tables across the two packages.

The JAX package draws its initial factors from threefry
(``mymedialite_tpu/utils/rand.py``) and the port from a
``torch.Generator``, so the two cannot re-derive each other's tables.
``tables_from_jax`` (rating MF), ``svdpp_tables_from_jax`` (SVD++
family) and ``bpr_tables_from_jax`` (BPR family) take a JAX model's
parameters as numpy arrays; the port's
``init_model(tables=...)`` starts from them, so that both packages train
from the same tables. Work from a model object or a dict, and import no
jax.
"""

from __future__ import annotations

import numpy as np

_KEYS = ("W_ext", "H_ext", "global_bias", "min_rating", "max_rating",
         "num_users_trained")


def tables_from_jax(model_or_arrays) -> dict:
    """{W_ext, H_ext (std fused layout, float32 numpy), global_bias,
    min_rating, max_rating, num_users_trained} of a JAX MF model."""
    if isinstance(model_or_arrays, dict):
        get = model_or_arrays.__getitem__
    else:
        def get(name):
            return getattr(model_or_arrays, name)
    out = {k: get(k) for k in _KEYS}
    out["W_ext"] = np.array(out["W_ext"], dtype=np.float32)
    out["H_ext"] = np.array(out["H_ext"], dtype=np.float32)
    for k in ("global_bias", "min_rating", "max_rating"):
        out[k] = float(out[k])
    out["num_users_trained"] = int(out["num_users_trained"])
    return out


def svdpp_tables_from_jax(model_or_params) -> dict:
    """{p, user_bias, item_bias, item_factors, y (float32 numpy),
    global_bias} of a JAX SVD++-family model, or of its ``params`` dict.
    The JAX package pads the user rows to its group grid: a model's are
    cut to its ``num_users_trained``, a dict's kept. A model without p
    (the AFMs) gives zeros."""
    if isinstance(model_or_params, dict):
        params = model_or_params
        U = len(params["user_bias"])
    else:
        params = model_or_params.params
        U = model_or_params.num_users_trained
    out = {k: np.array(params[k], dtype=np.float32)
           for k in ("user_bias", "item_bias", "item_factors", "y")}
    out["user_bias"] = out["user_bias"][:U]
    f = out["y"].shape[1]
    out["p"] = (np.array(params["p"], dtype=np.float32)[:U] if "p" in params
                else np.zeros((U, f), np.float32))
    out["global_bias"] = float(params["global_bias"])
    return out


def bpr_tables_from_jax(model_or_params) -> dict:
    """{user_factors, item_factors, item_bias} (float32 numpy) of a JAX
    BPR-family model, or of its ``params`` dict."""
    params = model_or_params if isinstance(model_or_params, dict) \
        else model_or_params.params
    return {k: np.array(params[k], dtype=np.float32)
            for k in ("user_factors", "item_factors", "item_bias")}
