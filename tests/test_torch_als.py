"""The batched ALS solves of the port (``mymedialite_tpu_torch/ops/
als.py``) against the JAX package's ``wrmf_optimize`` on the same
factors and padded histories, on the CPU.

The solve (``cholesky_ex`` + ``cholesky_solve``) gives the JAX rows, and
a float64 solve of the same systems, to 1e-4 relative to the largest
entry, as does the unrolled Cholesky that ``exp_torch_als_solves.py``
times beside it; the assembled systems equal a numpy float64 assembly; a
system that is not positive definite raises.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mymedialite_tpu.ops import als as jals
from mymedialite_tpu_torch.ops import als
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-4
EXP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "exp_torch_als_solves.py")


def solve_unrolled(M, b):
    spec = importlib.util.spec_from_file_location("exp_torch_als_solves",
                                                  EXP)
    exp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exp)
    return exp.solve_unrolled(M, b)


def problem(seed=0, rows=48, items=70, f=12, L=16):
    rng = np.random.default_rng(seed)
    H = rng.normal(0, 0.3, (items, f)).astype(np.float32)
    lens = rng.integers(0, L + 1, rows).astype(np.int32)
    lens[:3] = (0, 1, L)
    hist = rng.integers(0, items, (rows, L)).astype(np.int32)
    return H, hist, lens


def rel_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


@pytest.mark.parametrize("alpha,reg", [(1.0, 0.015), (40.0, 100.0)])
def test_rows_match_jax(alpha, reg):
    H, hist, lens = problem()
    want = np.asarray(jals.wrmf_optimize(
        jnp.asarray(H), jnp.asarray(hist), jnp.asarray(lens),
        jnp.float32(alpha), jnp.float32(reg), chunk=16))
    got = als.wrmf_optimize(torch.from_numpy(H),
                            torch.from_numpy(hist.astype(np.int64)),
                            torch.from_numpy(lens.astype(np.int64)),
                            alpha, reg, chunk=10)
    assert rel_err(got.numpy(), want) <= REL
    assert not np.any(got.numpy()[0])          # an empty history solves to 0


def test_systems_match_float64_assembly():
    H, hist, lens = problem(seed=1)
    alpha, reg = 2.0, 0.5
    Ht = torch.from_numpy(H)
    M, b = als.row_systems(Ht, als.gram(Ht), torch.from_numpy(
        hist.astype(np.int64)), torch.from_numpy(lens.astype(np.int64)),
        alpha, reg)
    H64 = H.astype(np.float64)
    for r in range(hist.shape[0]):
        S = H64[hist[r, :lens[r]]]
        M_want = H64.T @ H64 + alpha * S.T @ S + reg * np.eye(H.shape[1])
        b_want = (1 + alpha) * S.sum(axis=0)
        np.testing.assert_allclose(M[r].numpy(), M_want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(b[r].numpy(), b_want, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("route", ["cholesky_ex", "unrolled"])
def test_routes_agree_with_float64(route):
    """At f=40 the solve and the measured unrolled Cholesky stay within
    1e-4 of the float64 solve of the same systems."""
    H, hist, lens = problem(seed=2, rows=64, f=40, L=32)
    Ht = torch.from_numpy(H)
    M, b = als.row_systems(Ht, als.gram(Ht), torch.from_numpy(
        hist.astype(np.int64)), torch.from_numpy(lens.astype(np.int64)),
        1.0, 0.015)
    x64, _ = als.solve_cholesky(M.double(), b.double())
    x = als.solve_cholesky(M, b)[0] if route == "cholesky_ex" else \
        solve_unrolled(M, b)
    assert rel_err(x.numpy(), x64.numpy()) <= REL


def test_not_positive_definite_raises():
    """wrmf_optimize checks cholesky_ex's info once per call."""
    H, hist, lens = problem(seed=3)
    with pytest.raises(RuntimeError, match="not positive definite"):
        als.wrmf_optimize(torch.from_numpy(H),
                          torch.from_numpy(hist.astype(np.int64)),
                          torch.from_numpy(lens.astype(np.int64)),
                          1.0, -1e3, chunk=16)
