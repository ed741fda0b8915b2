"""The blocked and flat MF epochs' scatter-add whose result does not
depend on the order of its sum (``mymedialite_tpu_torch/ops/sgd.py
add_rows`` / ``exact_add``), on the CPU.

On the card ``add_rows`` sums through ``exact_add`` (int64 fixed point,
summed by integer additions), so two runs of one seed give the same
tables (``tests/test_torch_cuda.py`` checks that there). Here:
``exact_add`` equals ``index_add_`` in float64 on batches heavy with
duplicates, within its fixed point's bound, and gives the same bits in
any order of the slots; ``add_rows`` on CPU tensors is ``index_add_``
bit for bit, so the CPU epochs are unchanged; the blocked, sharded
blocked and flat epochs run through ``exact_add`` land within float64
rounding of their ``index_add_`` runs.
"""

import numpy as np
import pytest
import torch

from mymedialite_tpu_torch.ops import sgd as S
from mymedialite_tpu_torch.parallel.mesh import make_mesh
from torch_threads import one_torch_thread  # noqa: F401


def heavy_batch(seed, rows, n, width, dtype):
    """n slots over ``rows`` rows, most of them on a few hot rows."""
    gen = torch.Generator().manual_seed(seed)
    hot = torch.randint(0, rows, (4,), generator=gen)
    ids = torch.where(torch.rand(n, generator=gen) < 0.7,
                      hot[torch.randint(0, 4, (n,), generator=gen)],
                      torch.randint(0, rows, (n,), generator=gen))
    delta = torch.randn((n, width), generator=gen, dtype=dtype)
    table = torch.randn((rows, width), generator=gen, dtype=dtype)
    return table, ids, delta


def fixed_point_bound(delta, n):
    """What the fixed point may move a row's sum: each of at most n
    slots rounds by under 2**-e <= |delta|max * n * 2**-60."""
    return float(delta.abs().max()) * n * n * 2.0 ** -60 + 1e-12


@pytest.mark.parametrize("seed,rows,n,width", [
    (0, 50, 4096, 42), (1, 7, 1000, 3), (2, 1000, 200, 1), (3, 3, 65536, 8)])
def test_exact_add_equals_index_add_in_float64(seed, rows, n, width):
    table, ids, delta = heavy_batch(seed, rows, n, width, torch.float64)
    want = table.clone().index_add_(0, ids, delta)
    tol = fixed_point_bound(delta, n)
    got = S.exact_add(table.clone(), ids, delta)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)
    # int32 ids, as the blocked layout holds them, and 1-d rows
    got32 = S.exact_add(table.clone(), ids.int(), delta)
    assert torch.equal(got32, got)
    flat = S.exact_add(table[:, 0].clone(), ids, delta[:, 0])
    np.testing.assert_allclose(flat.numpy(), want[:, 0].numpy(), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_exact_add_gives_the_same_bits_in_any_order(dtype):
    table, ids, delta = heavy_batch(5, 40, 20000, 42, dtype)
    want = S.exact_add(table.clone(), ids, delta)
    ref = table.double().clone().index_add_(0, ids, delta.double())
    # one rounding of the fixed-point sum (an ulp of the dtype), beside
    # the fixed point's bound and the float64 reference's own rounding
    mag = ref.abs().max().item()
    tol = torch.finfo(dtype).eps * mag + fixed_point_bound(delta, len(ids)) \
        + len(ids) * 2.0 ** -52 * mag
    assert (want.double() - ref).abs().max().item() <= tol
    for seed in range(3):
        perm = torch.randperm(len(ids), generator=torch.Generator()
                              .manual_seed(seed))
        assert torch.equal(S.exact_add(table.clone(), ids[perm],
                                       delta[perm]), want)


def test_exact_add_edges():
    table = torch.randn((5, 3), generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([0, 3, 3])
    assert torch.equal(S.exact_add(table.clone(), ids, torch.zeros((3, 3))),
                       table)
    assert torch.equal(S.exact_add(table.clone(), ids[:0],
                                   torch.zeros((0, 3))), table)
    bad = torch.ones((3, 3))
    bad[1, 2] = float("inf")
    got = S.exact_add(table.clone(), ids, bad)
    assert not torch.isfinite(got[[0, 3]]).any()
    assert torch.equal(got[[1, 2, 4]], table[[1, 2, 4]])
    big = torch.full((3, 3), 3e37)      # past float32's range times n
    got = S.exact_add(torch.zeros((5, 3)), ids, big)
    assert torch.equal(got, torch.zeros((5, 3)).index_add_(0, ids, big))


def test_add_rows_on_the_cpu_is_index_add():
    table, ids, delta = heavy_batch(4, 30, 5000, 42, torch.float32)
    want = table.clone().index_add_(0, ids.int(), delta)
    got = S.add_rows(table.clone(), ids.int(), delta)
    assert torch.equal(got, want)


def blocked_setup(dtype):
    rng = np.random.default_rng(7)
    U, I, n = 256, 40, 6000
    u = rng.integers(0, U, n)
    i = np.minimum(rng.zipf(1.3, n) - 1, I - 1)     # a few hot items
    v = rng.integers(1, 6, n).astype(np.float32)
    data, meta = S.prepare_blocked_data(u, i, v, U, batch_size=512,
                                        group_users=64, shuffle_seed=1)
    gen = torch.Generator().manual_seed(3)
    W, H = S.extend_tables(0.1 * torch.randn((U, 6), generator=gen),
                           0.1 * torch.randn((I, 6), generator=gen),
                           group_users=64)
    nb = meta["l_pad"] // meta["batch"]
    orders = torch.stack([torch.randperm(nb, generator=gen)
                          for _ in range(meta["ngroups"])])
    freq = S.blocked_freq(np.bincount(u, minlength=U),
                          np.bincount(i, minlength=I), W.shape[0])
    rates = tuple(r.to(dtype) for r in S.column_rates(
        6, 0.05, 0.01, 0.02, 0.7, 0.1, True, True, True))
    return (data, meta, W.to(dtype), H.to(dtype), orders,
            tuple(f.to(dtype) for f in freq), rates)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("freq", [False, True])
def test_blocked_epochs_through_exact_add(monkeypatch, sharded, freq):
    data, meta, W, H, orders, f, rates = blocked_setup(torch.float64)
    kw = dict(meta=meta, loss=0, biased=True)
    hp = (0.3, 1.0, 4.0)

    def run():
        We, He = W.clone(), H.clone()
        if sharded:
            S.sgd_epoch_blocked_sharded(make_mesh(devices=["cpu"] * 2), We,
                                        He, data, orders[:2], hp, rates,
                                        f if freq else None, **kw)
        else:
            S.sgd_epoch_blocked(We, He, data, orders, hp, rates,
                                f if freq else None, **kw)
        return We, He
    want = run()
    monkeypatch.setattr(S, "add_rows", S.exact_add)
    got = run()
    assert not torch.equal(want[1], H)      # the epoch moved the items
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("sharded", [False, True])
def test_flat_epochs_through_exact_add(monkeypatch, sharded):
    rng = np.random.default_rng(8)
    U, I, n, B = 60, 25, 3000, 256
    u = rng.integers(0, U, n)
    i = np.minimum(rng.zipf(1.3, n) - 1, I - 1)
    v = rng.integers(1, 6, n).astype(np.float32)
    data = S.prepare_epoch_data(u, i, v, B, shuffle_seed=2, num_users=U,
                                num_items=I)
    data = {k: (t.double() if t.is_floating_point() else t)
            for k, t in data.items()}
    gen = torch.Generator().manual_seed(5)
    params = dict(user_factors=0.1 * torch.randn((U, 4), generator=gen),
                  item_factors=0.1 * torch.randn((I, 4), generator=gen),
                  user_bias=torch.zeros(U), item_bias=torch.zeros(I),
                  global_bias=3.0)
    params = {k: (t.double() if isinstance(t, torch.Tensor) else t)
              for k, t in params.items()}
    hp = dict(learn_rate=0.05, reg_u=0.01, reg_i=0.02, bias_reg=0.1,
              bias_learn_rate=0.7, min_rating=1.0, rating_range=4.0)
    order = torch.randperm(data["users"].shape[0] // B, generator=gen)
    kw = dict(batch_size=B, loss=0, biased=True, update_user=True,
              update_item=True, frequency_regularization=False)

    def run():
        p = {k: (t.clone() if isinstance(t, torch.Tensor) else t)
             for k, t in params.items()}
        if sharded:
            return S.sgd_epoch_sharded_flat(make_mesh(devices=["cpu"] * 2),
                                            p, data, order, hp, **kw)
        return S.sgd_epoch(p, data, order, hp, **kw)
    want = run()
    monkeypatch.setattr(S, "add_rows", S.exact_add)
    got = run()
    for k in ("user_factors", "item_factors", "user_bias", "item_bias"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-10, err_msg=k)
