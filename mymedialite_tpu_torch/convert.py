"""Tables across the two packages.

The JAX package draws its initial factors from threefry
(``mymedialite_tpu/utils/rand.py``) and the port from a
``torch.Generator``, so the two cannot re-derive each other's tables.
``tables_from_jax`` (rating MF), ``svdpp_tables_from_jax`` (SVD++
family), ``bpr_tables_from_jax`` (BPR family) and
``wrmf_tables_from_jax`` (WRMF) take a JAX model's parameters as numpy
arrays; the port's ``init_model(tables=...)`` starts from them, so that
both packages train from the same tables. ``baseline_state_from_jax``
(UserItemBaseline's biases), ``knn_state_from_jax`` (a KNN model's
dense correlation, or its neighbour ids and values) and
``time_aware_state_from_jax`` (the time-aware baselines' tables and
time grid) carry trained state the same way, into the port's
``load_state``; ``slim_state_from_jax`` (SLIM's W) feeds the SLIM
models' ``init_model(tables=...)``. SocialMF takes ``tables_from_jax``,
as BiasedMatrixFactorization does. Work from a model object or a dict,
and import no jax.
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
    global_bias, and x for GSVDPlusPlus} of a JAX SVD++-family model, or
    of its ``params`` dict.
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
    if "x" in params:       # GSVDPlusPlus's attribute factors
        out["x"] = np.array(params["x"], dtype=np.float32)
    return out


def bpr_tables_from_jax(model_or_params) -> dict:
    """{user_factors, item_factors, item_bias} (float32 numpy) of a JAX
    BPR-family model, or of its ``params`` dict."""
    params = model_or_params if isinstance(model_or_params, dict) \
        else model_or_params.params
    return {k: np.array(params[k], dtype=np.float32)
            for k in ("user_factors", "item_factors", "item_bias")}


def wrmf_tables_from_jax(model_or_params) -> dict:
    """{user_factors, item_factors} (float32 numpy) of a JAX WRMF model,
    or of its ``params`` dict."""
    params = model_or_params if isinstance(model_or_params, dict) \
        else model_or_params.params
    return {k: np.array(params[k], dtype=np.float32)
            for k in ("user_factors", "item_factors")}


def baseline_state_from_jax(model_or_state) -> dict:
    """{global_average, user_biases, item_biases} of a JAX
    UserItemBaseline (or of a rating KNN's ``baseline``), or of a dict."""
    if isinstance(model_or_state, dict):
        get = model_or_state.__getitem__
    else:
        def get(name):
            return getattr(model_or_state, name)
    return {"global_average": float(get("global_average")),
            "user_biases": np.array(get("user_biases"), dtype=np.float32),
            "item_biases": np.array(get("item_biases"), dtype=np.float32)}


def knn_state_from_jax(model) -> dict:
    """The correlation state of a JAX KNN model: {corr} (dense [N, N]) or
    {nbr_ids, nbr_vals} (top-k [N, k]), numpy."""
    if getattr(model, "corr", None) is not None:
        return {"corr": np.array(model.corr, dtype=np.float32)}
    return {"nbr_ids": np.array(model.nbr_ids, dtype=np.int32),
            "nbr_vals": np.array(model.nbr_vals, dtype=np.float32)}


def time_aware_state_from_jax(model) -> dict:
    """{params (float32 numpy arrays), earliest, num_days, latest_day,
    num_bins, user_mean_day, global_average, and freq_by_day for the
    frequency model} of a trained JAX time-aware baseline."""
    out = {"params": {k: np.array(v, dtype=np.float32)
                      for k, v in model.params.items()},
           "earliest": int(model._earliest),
           "num_days": int(model._num_days),
           "latest_day": int(model._latest_day),
           "num_bins": int(model._num_bins),
           "user_mean_day": np.array(model._user_mean_day, dtype=np.float32),
           "global_average": float(model.global_average)}
    if getattr(model, "_freq_by_day", None) is not None:
        out["freq_by_day"] = np.array(model._freq_by_day, dtype=np.int32)
    return out


def slim_state_from_jax(model_or_w) -> dict:
    """{W} (float32 numpy [I, I]) of a JAX SLIM model, or of its W."""
    W = getattr(model_or_w, "W", model_or_w)
    return {"W": np.array(W, dtype=np.float32)}
