"""GPU tier of the port: the CUDA kernels against their plain PyTorch
versions on the card. Marked ``cuda``; every test skips without a CUDA
device. Run on a GPU machine (the machine need not have jax, so the
suite's conftest is bypassed; ``-s`` shows the spreads that
``test_duplicate_heavy_spread`` measures):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
from mymedialite_tpu_torch.ops import plan as P
from mymedialite_tpu_torch.ops import sgd as S
from mymedialite_tpu_torch.ops.sgd_epoch import sgd_epoch, sgd_epoch_reference

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(device, biased, seed=0, num_factors=40):
    """Netflix-shaped synthetic ratings (Zipf items, log-normal users) at
    2,000 x 3,000 x 100k, tables drawn from N(0, 0.1)."""
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=seed)
    plan = P.prepare_mxu_data(data.users, data.items, data.values, 2000,
                              3000, user_block=512, item_block=1024,
                              chunk=640, shuffle_seed=1, device=device)
    rng = np.random.default_rng(seed)
    k = num_factors
    W0 = 0.1 * rng.standard_normal((2000, k)).astype(np.float32)
    H0 = 0.1 * rng.standard_normal((3000, k)).astype(np.float32)
    bu = 0.1 * rng.standard_normal(2000).astype(np.float32) if biased else None
    bi = 0.1 * rng.standard_normal(3000).astype(np.float32) if biased else None
    W, H = P.extend_tables_mxu(plan, W0, H0, bu, bi)
    return plan, W, H


COMBOS = [(loss, True, sides, 40)
          for loss in (S.LOSS_RMSE, S.LOSS_MAE, S.LOSS_LOGISTIC)
          for sides in ((True, True), (True, False), (False, True))]
COMBOS += [(S.LOSS_RMSE, False, (True, True), 40)]
# the wider register layouts: fe 104 (4 columns per lane, the last lane
# group partly masked) and fe 208 (8 columns per lane)
COMBOS += [(S.LOSS_RMSE, True, (True, True), 100),
           (S.LOSS_MAE, False, (True, True), 100),
           (S.LOSS_RMSE, True, (True, True), 200),
           (S.LOSS_LOGISTIC, False, (True, True), 200)]


@pytest.mark.parametrize("loss,biased,sides,num_factors", COMBOS)
def test_kernel_matches_reference(cuda, loss, biased, sides, num_factors):
    """Two epochs from the same tables and orders. The atomics add in an
    order that varies from run to run, so the sums differ in the last
    bits: atol 1e-4."""
    plan, W, H = _setup(cuda, biased, num_factors=num_factors)
    W0, H0 = W.clone(), H.clone()
    fe = W.shape[1]
    assert fe == P.fused_width(num_factors)
    # the models' default rates (reference BiasedMatrixFactorization.cs)
    rates = P.mxu_column_rates(num_factors, fe, 0.01, 0.015, 0.015, 1.0,
                               0.01, biased, *sides, device=cuda)
    hp = (0.5, 1.0, 4.0) if biased else (3.5, 1.0, 4.0)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=loss, biased=biased)
    Wk, Hk = W.clone(), H.clone()
    before = sgd_epoch.launches
    for epoch in range(2):
        order = plan.epoch_order(11 + epoch)
        sgd_epoch_reference(W, H, plan.packed, order, hp, rates, **kw)
        sgd_epoch(Wk, Hk, plan.packed, order, hp, rates, **kw)
    torch.cuda.synchronize()
    assert sgd_epoch.launches == before + 2
    assert torch.isfinite(Wk).all() and torch.isfinite(Hk).all()
    assert (Wk - W).abs().max().item() <= 1e-4
    assert (Hk - H).abs().max().item() <= 1e-4
    assert torch.equal(Wk, W0) != sides[0]
    assert torch.equal(Hk, H0) != sides[1]


RUNS = 8


def _dist(a, b):
    return max((x.double().cpu() - y.double().cpu()).abs().max().item()
               for x, y in zip(a, b))


def test_duplicate_heavy_spread(cuda):
    """Chunks full of duplicates at high rates: a Zipf(1.3) catalog (one
    item in about a quarter of the slots), learn rate 0.05, bias rate 1,
    bias reg 0.5, C=640, 32 chunks. Every step is sensitive, so float32
    trajectories that differ only in the order of their sums drift apart.

    Two witnesses hold the kernel to the plain version. (1) One step at a
    time, from the float64 trajectory's own state before each chunk, the
    kernel agrees with float64 to 1e-4 (the tolerance of the other
    kernel checks), as the plain float32 version does. (2) After all
    chunks, the kernel lies no farther from float64 than 4x the farthest
    plain witness (plain on CUDA, RUNS times; on the CPU; float64 from
    tables moved by 1e-7)."""
    rng = np.random.default_rng(0)
    U, I, n = 700, 900, 20000
    users = rng.integers(0, U, n).astype(np.int32)
    items = (rng.zipf(1.3, n) % I).astype(np.int32)
    values = rng.integers(1, 11, n).astype(np.float32) / 2
    plan = P.prepare_mxu_data(users, items, values, U, I, user_block=512,
                              item_block=1024, chunk=640, shuffle_seed=1,
                              device=cuda)
    W, H = P.extend_tables_mxu(plan, 0.1 * rng.standard_normal((U, 40)),
                               0.1 * rng.standard_normal((I, 40)))
    rates = P.mxu_column_rates(40, W.shape[1], 0.05, 0.02, 0.03, 1.0, 0.5,
                               True, True, True, device=cuda)
    hp = (0.3, 1.0, 4.0)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=S.LOSS_RMSE, biased=True)
    order = plan.epoch_order(5)
    cpu = lambda ts: tuple(t.cpu() for t in ts)  # noqa: E731
    packed_c, order_c, rates_c = plan.packed.cpu(), cpu(order), rates.cpu()

    def plain64(W0, H0, order64):
        W64, H64 = W0.cpu().double().clone(), H0.cpu().double().clone()
        sgd_epoch_reference(W64, H64, packed_c, order64, hp, rates_c.double(),
                            **kw)
        return W64, H64

    # (1) one step at a time from the float64 trajectory
    W64, H64 = W.double().cpu(), H.double().cpu()
    step_kernel, step_plain = [], []
    for k in range(plan.num_chunks):
        one = tuple(t[k:k + 1].contiguous() for t in order)
        nxt = plain64(W64, H64, cpu(one))
        Wk, Hk = W64.float().to(cuda), H64.float().to(cuda)
        sgd_epoch(Wk, Hk, plan.packed, one, hp, rates, **kw)
        Wp, Hp = W64.float(), H64.float()
        sgd_epoch_reference(Wp, Hp, packed_c, cpu(one), hp, rates_c, **kw)
        step_kernel.append(_dist((Wk, Hk), nxt))
        step_plain.append(_dist((Wp, Hp), nxt))
        W64, H64 = nxt
    truth = (W64, H64)

    # (2) whole trajectories against float64, several runs each: the
    # atomics and index_add_ on the card sum in a run-dependent order
    def kernel_run():
        Wk, Hk = W.clone(), H.clone()
        sgd_epoch(Wk, Hk, plan.packed, order, hp, rates, **kw)
        return Wk, Hk

    def plain_run(device):
        Wp, Hp = W.clone().to(device), H.clone().to(device)
        sgd_epoch_reference(Wp, Hp, plan.packed.to(device),
                            tuple(t.to(device) for t in order), hp,
                            rates.to(device), **kw)
        return Wp, Hp

    g = torch.Generator().manual_seed(1)
    nudge = lambda t: t.cpu() + 1e-7 * torch.randn(  # noqa: E731
        t.shape, generator=g) * (t.cpu() != 0)
    kernels = [kernel_run() for _ in range(RUNS)]
    plains = [plain_run(cuda) for _ in range(RUNS)]
    torch.cuda.synchronize()
    kernel_spread = [_dist(t, truth) for t in kernels]
    plain_spread = [_dist(t, truth) for t in plains]
    others = {"plain cpu": _dist(plain_run("cpu"), truth),
              "float64 from tables moved 1e-7":
                  _dist(plain64(nudge(W), nudge(H), order_c), truth)}
    fmt = lambda xs: " ".join(f"{x:.3f}" for x in sorted(xs))  # noqa: E731
    print(f"\nduplicate-heavy, {plan.num_chunks} chunks: one-step max err vs "
          f"float64: kernel {max(step_kernel):.3e}, plain float32 cpu "
          f"{max(step_plain):.3e}")
    print(f"after all chunks, max |x - float64| over {RUNS} runs: kernel "
          f"[{fmt(kernel_spread)}]; plain cuda [{fmt(plain_spread)}]; "
          + "; ".join(f"{k} {v:.3f}" for k, v in others.items())
          + f"; kernel vs kernel {_dist(*kernels[:2]):.3f}, plain cuda vs "
          f"plain cuda {_dist(*plains[:2]):.3f}")
    assert max(step_kernel) <= 1e-4
    assert max(step_plain) <= 1e-4
    assert all(math.isfinite(d) for d in kernel_spread)
    assert max(kernel_spread) <= 4 * max(plain_spread + list(others.values()))


def test_kernel_rejects_bad_input(cuda):
    plan, W, H = _setup(cuda, True)
    rates = P.mxu_column_rates(40, W.shape[1], 0.01, 0.015, 0.015, 1.0, 0.01,
                               True, True, True, device=cuda)
    order = plan.epoch_order(1)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=S.LOSS_RMSE, biased=True)
    with pytest.raises(TypeError):
        sgd_epoch(W.double(), H, plan.packed, order, (0., 1., 4.), rates, **kw)
    with pytest.raises(ValueError):
        sgd_epoch(W, H.cpu(), plan.packed, order, (0., 1., 4.), rates, **kw)
