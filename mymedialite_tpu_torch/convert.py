"""Tables across the two packages.

The JAX package draws its initial factors from threefry
(``mymedialite_tpu/utils/rand.py``) and the port from a
``torch.Generator``, so the two cannot re-derive each other's tables.
``tables_from_jax`` takes a JAX model's parameters as numpy arrays; the
port's ``init_model(tables=...)`` starts from them, so that both
packages train from the same tables. Works from a model object or a
dict, and imports no jax.
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
