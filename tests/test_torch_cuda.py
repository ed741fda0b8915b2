"""GPU tier of the port: the CUDA kernels (SGD epoch and BPR epoch, each
on the resident and on the slab-tiled schedule) against their plain
PyTorch versions on the card. Marked ``cuda``; every test skips without a CUDA
device. Run on a GPU machine (the machine need not have jax, so the
suite's conftest is bypassed; ``-s`` shows the spreads that
``test_duplicate_heavy_spread`` measures):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from mymedialite_tpu_torch.data.arrays import PosOnlyData
from mymedialite_tpu_torch.data.synthetic import (
    posonly_from_ratings, synthetic_ratings,
)
from mymedialite_tpu_torch.eval.ranking import evaluate_items
from mymedialite_tpu_torch.models.registry import (
    create_item_recommender, create_rating_predictor,
)
from mymedialite_tpu_torch.ops import bpr_plan as BP
from mymedialite_tpu_torch.ops import plan as P
from mymedialite_tpu_torch.ops import sgd as S
from mymedialite_tpu_torch.ops.bpr_epoch import (
    bpr_epoch, bpr_epoch_reference, bpr_epoch_tiled, bpr_epoch_tiled_reference,
)
from mymedialite_tpu_torch.ops.sgd_epoch import (
    sgd_epoch, sgd_epoch_reference, sgd_epoch_tiled, sgd_epoch_tiled_reference,
)

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


# --- the BPR epoch kernel -------------------------------------------------

ONE_BITS = 0x3F800000   # bits of 1.0f: a slot whose negative was found


def _bpr_tables(device, plan, num_users, num_items, num_factors, seed):
    rng = np.random.default_rng(seed)
    tabs = [torch.from_numpy((0.1 * rng.standard_normal(shape))
                             .astype(np.float32)).to(device)
            for shape in ((num_users, num_factors), (num_items, num_factors),
                          (num_items,))]
    nof = torch.from_numpy(plan.new_of_old.astype(np.int64)).to(device)
    return BP.bpr_tables_to_mxu(*tabs, nof, u_pad=plan.u_pad,
                                i_pad=plan.i_pad,
                                fe=P.fused_width(num_factors))


def _bpr_epoch_args(plan, state, meta, rates, seed, wbpr):
    """Order, negative plan and random bits of one epoch (bits over the
    whole int32 range: the sampler must mask the sign bit)."""
    dev = plan.packed.device
    order = plan.epoch_order(seed)
    neg_plan = BP.epoch_negative_plan(
        plan, state["nvalid"], order[0].cpu().numpy(), meta[3], seed + 1,
        block_mass=state["block_mass"] if wbpr else None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bits = (torch.randint(0, 2 ** 32, (plan.num_chunks, meta[2], plan.chunk),
                          generator=gen, device=dev) - 2 ** 31).to(torch.int32)
    return (plan.packed, state["keys_tbl"], state["cdf_tbl"], bits, order,
            *neg_plan, rates)


BPR_COMBOS = [(sm, wbpr, bm, 40) for sm, wbpr in ((False, False),
                                                  (True, False), (False, True))
              for bm in (False, True)]
# the wider register layouts: fe 104 (4 columns per lane) and fe 208 (8)
BPR_COMBOS += [(False, False, True, 100), (False, True, False, 100),
               (True, False, True, 200), (False, True, True, 200)]


@pytest.mark.parametrize("soft_margin,wbpr,bitmask,num_factors", BPR_COMBOS)
def test_bpr_kernel_matches_reference(cuda, soft_margin, wbpr, bitmask,
                                      num_factors):
    """Two epochs from the same tables, orders, negative plans and bits, on
    _setup's rated pairs as positive-only feedback: the sampled negatives
    are identical, the tables agree to 1e-4 (atomics add in a
    run-dependent order)."""
    fb = posonly_from_ratings(synthetic_ratings(
        num_users=2000, num_items=3000, num_ratings=100_000, seed=0))
    plan, state, meta = BP.prepare_bpr_mxu(fb, uniform_user=not wbpr,
                                           shuffle_seed=1, bitmask=True,
                                           device=cuda)
    W, H = _bpr_tables(cuda, plan, fb.num_users, fb.num_items, num_factors, 0)
    H0 = H.clone()
    rates = BP.bpr_mxu_column_rates(num_factors, W.shape[1], 0.05, 0.0025,
                                    0.0025, 0.00025, 0.01, True, device=cuda)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              soft_margin=soft_margin, wbpr=wbpr,
              bitmask_tbl=state["bitmask_tbl"] if bitmask else None,
              return_negatives=True)
    Wk, Hk = W.clone(), H.clone()
    before = bpr_epoch.launches
    for epoch in range(2):
        args = _bpr_epoch_args(plan, state, meta, rates, 11 + epoch, wbpr)
        _, _, neg_r = bpr_epoch_reference(W, H, *args, **kw)
        _, _, neg_k = bpr_epoch(Wk, Hk, *args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(neg_k, neg_r)
        assert (neg_k[:, 1] == ONE_BITS).float().mean().item() > 0.99
    assert bpr_epoch.launches == before + 2
    assert torch.isfinite(Wk).all() and torch.isfinite(Hk).all()
    assert (Wk - W).abs().max().item() <= 1e-4
    assert (Hk - H).abs().max().item() <= 1e-4
    # the item-bias column moved
    assert (Hk[:, num_factors] - H0[:, num_factors]).abs().max().item() > 0


@pytest.mark.parametrize("bitmask", [False, True], ids=["keys", "bitmask"])
def test_bpr_duplicate_heavy_one_chunk_at_a_time(cuda, bitmask):
    """Chunks full of duplicate rows: a Zipf(1.3) catalog (one item in
    about a quarter of the slots), C=640, uniform-user weights up to ~30.
    Each chunk stepped alone from the plain version's own state agrees
    with the plain step to 1e-5, so no update among duplicate rows is
    lost. After the whole epoch the kernel's distance from the plain
    version is printed beside the plain version's own CUDA spread (two
    runs; index_add_ on the card also adds in a run-dependent order)."""
    rng = np.random.default_rng(0)
    U, I, n = 700, 900, 20000
    fb = PosOnlyData(rng.integers(0, U, n), rng.zipf(1.3, n) % I,
                     num_users=U, num_items=I)
    plan, state, meta = BP.prepare_bpr_mxu(fb, uniform_user=True,
                                           shuffle_seed=1, bitmask=bitmask,
                                           device=cuda)
    W, H = _bpr_tables(cuda, plan, U, I, 40, 1)
    rates = BP.bpr_mxu_column_rates(40, W.shape[1], 0.05, 0.0025, 0.0025,
                                    0.00025, 0.01, True, device=cuda)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              bitmask_tbl=state.get("bitmask_tbl"))
    packed, keys, cdf, bits, order, jb, nval, bkt, _ = _bpr_epoch_args(
        plan, state, meta, rates, 5, False)
    real = packed[:, 3] != 0
    top = max(torch.bincount(packed[c, 1][real[c]].long()).max().item()
              for c in range(plan.num_chunks))
    assert top > 100          # one item fills many slots of a chunk

    Wp, Hp = W.clone(), H.clone()
    steps = []
    for k in range(plan.num_chunks):
        one = [t[k:k + 1].contiguous() for t in (bits, *order, jb, nval, bkt)]
        args = (packed, keys, cdf, one[0], tuple(one[1:4]), *one[4:], rates)
        Wk, Hk = Wp.clone(), Hp.clone()
        bpr_epoch(Wk, Hk, *args, **kw)
        bpr_epoch_reference(Wp, Hp, *args, **kw)
        torch.cuda.synchronize()
        steps.append(max((Wk - Wp).abs().max().item(),
                         (Hk - Hp).abs().max().item()))

    args = (packed, keys, cdf, bits, order, jb, nval, bkt, rates)
    runs = []
    for epoch in (bpr_epoch, bpr_epoch_reference, bpr_epoch_reference):
        Wr, Hr = W.clone(), H.clone()
        epoch(Wr, Hr, *args, **kw)
        runs.append((Wr, Hr))
    torch.cuda.synchronize()
    gap, spread = _dist(runs[0], runs[1]), _dist(runs[1], runs[2])
    print(f"\nbpr duplicate-heavy ({'bitmask' if bitmask else 'keys'}), "
          f"{plan.num_chunks} chunks, up to {top} slots on one item: one-step "
          f"max err {max(steps):.3e}; whole epoch kernel vs plain {gap:.3e}, "
          f"plain vs plain {spread:.3e}")
    assert max(steps) <= 1e-5
    assert math.isfinite(gap)
    assert gap <= max(1e-4, 4 * spread)


def test_bprmf_trains_on_the_card(cuda):
    """BPRMF through the registry launches the kernel once per epoch and
    keeps its kernel-layout tables on the card; it ranks held-out pairs
    above chance."""
    fb = posonly_from_ratings(synthetic_ratings(
        num_users=2000, num_items=3000, num_ratings=100_000, seed=2))
    perm = np.random.default_rng(3).permutation(len(fb))
    cut = len(fb) // 5
    train, test = fb.select(np.sort(perm[cut:])), fb.select(np.sort(perm[:cut]))
    m = create_item_recommender("BPRMF", "num_factors=40 num_iter=3 "
                                "device=cuda")
    m.feedback = train
    before = bpr_epoch.launches
    m.train()
    torch.cuda.synchronize()
    assert bpr_epoch.launches == before + 3
    assert all(t.device.type == "cuda" for t in m._mxu_tables)
    res = evaluate_items(m, test, train)
    assert math.isfinite(res["AUC"]) and res["AUC"] > 0.6


def test_bpr_kernel_rejects_bad_input(cuda):
    fb = posonly_from_ratings(synthetic_ratings(
        num_users=2000, num_items=3000, num_ratings=100_000, seed=0))
    plan, state, meta = BP.prepare_bpr_mxu(fb, uniform_user=True,
                                           shuffle_seed=1, device=cuda)
    W, H = _bpr_tables(cuda, plan, fb.num_users, fb.num_items, 40, 0)
    rates = BP.bpr_mxu_column_rates(40, W.shape[1], 0.05, 0.0025, 0.0025,
                                    0.00025, 0.0, True, device=cuda)
    args = _bpr_epoch_args(plan, state, meta, rates, 1, False)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block)
    with pytest.raises(TypeError):
        bpr_epoch(W.double(), H, *args, **kw)
    with pytest.raises(ValueError):
        bpr_epoch(W, H.cpu(), *args, **kw)
    with pytest.raises(ValueError, match="bits"):
        bpr_epoch(W, H, *args[:3], args[3][:, :, :8].contiguous(), *args[4:],
                  **kw)
    wide = torch.zeros((W.shape[0], 264), device=cuda)
    with pytest.raises(ValueError, match="fe <="):
        bpr_epoch(wide, torch.zeros((H.shape[0], 264), device=cuda),
                  *args[:-1], torch.zeros((264, 6), device=cuda), **kw)


# --- the slab-tiled schedule (kernels 2 and 4) -----------------------------

def shrink_budgets(mp):
    """At k=40 an item block is 256 KB: a 3,000-item catalog (three
    blocks) passes a 512 KB resident bound, and a 256 KB slab budget gives
    one block per slab, so three slabs."""
    mp.setattr(P, "RESIDENT_ITEM_TABLE_BYTES", 512 * 1024)
    mp.setattr(P, "TILED_SLAB_BYTES", 256 * 1024)


@pytest.mark.parametrize("loss,biased", [
    (loss, biased) for loss in (S.LOSS_RMSE, S.LOSS_MAE, S.LOSS_LOGISTIC)
    for biased in (True, False)])
def test_sgd_tiled_kernel_matches_reference(cuda, loss, biased):
    """Two tiled epochs (three one-block slabs, the histogram-chosen
    chunk) from the same tables and orders: atol 1e-4, as the resident
    kernel's check."""
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=0)
    plan = P.prepare_mxu_tiled(data.users, data.items, data.values, 2000,
                               3000, user_block=512, item_block=1024,
                               chunk=None, slab_blocks=1, shuffle_seed=1,
                               device=cuda)
    assert plan.num_slabs == 3
    rng = np.random.default_rng(0)
    W, H = P.extend_tables_mxu(
        plan, 0.1 * rng.standard_normal((2000, 40)),
        0.1 * rng.standard_normal((3000, 40)),
        0.1 * rng.standard_normal(2000) if biased else None,
        0.1 * rng.standard_normal(3000) if biased else None)
    rates = P.mxu_column_rates(40, W.shape[1], 0.01, 0.015, 0.015, 1.0, 0.01,
                               biased, True, True, device=cuda)
    hp = (0.5, 1.0, 4.0) if biased else (3.5, 1.0, 4.0)
    kw = dict(slab_blocks=plan.slab_blocks, user_block=plan.user_block,
              item_block=plan.item_block, loss=loss, biased=biased)
    Wk, Hk = W.clone(), H.clone()
    before = (sgd_epoch.launches, sgd_epoch_tiled.launches)
    for epoch in range(2):
        order = plan.epoch_order(11 + epoch)
        sgd_epoch_tiled_reference(W, H, plan.packed, order, hp, rates, **kw)
        sgd_epoch_tiled(Wk, Hk, plan.packed, order, hp, rates, **kw)
    torch.cuda.synchronize()
    assert (sgd_epoch.launches, sgd_epoch_tiled.launches) == \
        (before[0], before[1] + 2)
    assert torch.isfinite(Wk).all() and torch.isfinite(Hk).all()
    assert (Wk - W).abs().max().item() <= 1e-4
    assert (Hk - H).abs().max().item() <= 1e-4


def _bpr_tiled_state(device, fb, wbpr):
    """The models' tiled plan options, with one-block slabs."""
    plan, state, meta = BP.prepare_bpr_mxu(
        fb, uniform_user=not wbpr, shuffle_seed=1, chunk=None, kcap=128,
        subkeys=True, ksub_cap=256, bitmask=False, chunk_overhead=256,
        device=device)
    tl = BP.bpr_tiled_plan(plan, state["nvalid"], slab_blocks=1)
    return plan, state, meta, tl


def _bpr_tiled_args(plan, state, meta, tl, rates, seed, wbpr):
    """Order and random bits of one tiled epoch (bits over the whole
    int32 range)."""
    B, num_slabs, slab_items = tl
    dev = plan.packed.device
    order = BP.bpr_tiled_epoch_order(
        plan, state["nvalid"], slab_items, slab_blocks=B,
        num_slabs=num_slabs, num_items=meta[3], seed=seed,
        block_mass=state["block_mass"] if wbpr else None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bits = (torch.randint(0, 2 ** 32, (plan.num_chunks, meta[2], plan.chunk),
                          generator=gen, device=dev) - 2 ** 31).to(torch.int32)
    return (plan.packed, state["subkeys_tbl"], state["cdf_tbl"], bits, order,
            rates)


@pytest.mark.parametrize("soft_margin,wbpr,num_factors", [
    (False, False, 40), (True, False, 40), (False, True, 40),
    (True, True, 40), (False, False, 100), (False, True, 200)])
def test_bpr_tiled_kernel_matches_reference(cuda, soft_margin, wbpr,
                                            num_factors):
    """Two tiled epochs with sub-bucketed membership keys from the same
    tables, orders and bits: identical negatives, tables within 1e-4."""
    fb = posonly_from_ratings(synthetic_ratings(
        num_users=2000, num_items=3000, num_ratings=100_000, seed=0))
    plan, state, meta, tl = _bpr_tiled_state(cuda, fb, wbpr)
    assert tl[1] == 3
    W, H = _bpr_tables(cuda, plan, fb.num_users, fb.num_items, num_factors, 0)
    rates = BP.bpr_mxu_column_rates(num_factors, W.shape[1], 0.05, 0.0025,
                                    0.0025, 0.00025, 0.01, True, device=cuda)
    kw = dict(slab_blocks=tl[0], user_block=plan.user_block,
              item_block=plan.item_block, soft_margin=soft_margin, wbpr=wbpr,
              subkeys=True, return_negatives=True)
    Wk, Hk = W.clone(), H.clone()
    before = (bpr_epoch.launches, bpr_epoch_tiled.launches)
    for epoch in range(2):
        args = _bpr_tiled_args(plan, state, meta, tl, rates, 11 + epoch, wbpr)
        _, _, neg_r = bpr_epoch_tiled_reference(W, H, *args, **kw)
        _, _, neg_k = bpr_epoch_tiled(Wk, Hk, *args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(neg_k, neg_r)
        assert (neg_k[:, 1] == ONE_BITS).float().mean().item() > 0.99
    assert (bpr_epoch.launches, bpr_epoch_tiled.launches) == \
        (before[0], before[1] + 2)
    assert torch.isfinite(Wk).all() and torch.isfinite(Hk).all()
    assert (Wk - W).abs().max().item() <= 1e-4
    assert (Hk - H).abs().max().item() <= 1e-4


def test_bpr_tiled_duplicate_heavy_one_chunk_at_a_time(cuda):
    """test_bpr_duplicate_heavy_one_chunk_at_a_time for the sub-bucketed
    keys on the tiled schedule: Zipf(1.3) over 3,000 items in three
    one-block slabs, so chunks hold hundreds of slots on one item and some
    draw their negatives from their own positive block. Each chunk
    stepped alone from the plain version's state agrees with the plain
    step to 1e-5."""
    rng = np.random.default_rng(0)
    U, I, n = 700, 3000, 20000
    fb = PosOnlyData(rng.integers(0, U, n), rng.zipf(1.3, n) % I,
                     num_users=U, num_items=I)
    plan, state, meta, tl = _bpr_tiled_state(cuda, fb, False)
    W, H = _bpr_tables(cuda, plan, U, I, 40, 1)
    rates = BP.bpr_mxu_column_rates(40, W.shape[1], 0.05, 0.0025, 0.0025,
                                    0.00025, 0.01, True, device=cuda)
    kw = dict(slab_blocks=tl[0], user_block=plan.user_block,
              item_block=plan.item_block, subkeys=True)
    packed, keys, cdf, bits, order, _ = _bpr_tiled_args(
        plan, state, meta, tl, rates, 5, False)
    real = packed[:, 3] != 0
    top = max(torch.bincount(packed[c, 1][real[c]].long()).max().item()
              for c in range(plan.num_chunks))
    assert top > 100
    _, ibr, isl, _, jbr, jsl, *_ = order
    same = ((isl == jsl) & (ibr == jbr)).sum().item()
    assert same > 0           # i and j rows from one block in one chunk

    Wp, Hp = W.clone(), H.clone()
    steps = []
    for k in range(plan.num_chunks):
        one = tuple(t[k:k + 1].contiguous() for t in order)
        args = (packed, keys, cdf, bits[k:k + 1].contiguous(), one, rates)
        Wk, Hk = Wp.clone(), Hp.clone()
        bpr_epoch_tiled(Wk, Hk, *args, **kw)
        bpr_epoch_tiled_reference(Wp, Hp, *args, **kw)
        torch.cuda.synchronize()
        steps.append(max((Wk - Wp).abs().max().item(),
                         (Hk - Hp).abs().max().item()))

    args = (packed, keys, cdf, bits, order, rates)
    runs = []
    for epoch in (bpr_epoch_tiled, bpr_epoch_tiled_reference,
                  bpr_epoch_tiled_reference):
        Wr, Hr = W.clone(), H.clone()
        epoch(Wr, Hr, *args, **kw)
        runs.append((Wr, Hr))
    torch.cuda.synchronize()
    gap, spread = _dist(runs[0], runs[1]), _dist(runs[1], runs[2])
    print(f"\nbpr tiled duplicate-heavy (subkeys), {plan.num_chunks} chunks, "
          f"up to {top} slots on one item, {same} chunks with i and j in one "
          f"block: one-step max err {max(steps):.3e}; whole epoch kernel vs "
          f"plain {gap:.3e}, plain vs plain {spread:.3e}")
    assert max(steps) <= 1e-5
    assert math.isfinite(gap)
    assert gap <= max(1e-4, 4 * spread)


def test_models_take_the_tiled_kernels_on_the_card(cuda, monkeypatch):
    """BiasedMatrixFactorization and BPRMF through the registry on a
    catalog past the (shrunk) resident bound launch the tiled kernels once
    per epoch and the resident ones never."""
    shrink_budgets(monkeypatch)
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=2)
    perm = np.random.default_rng(3).permutation(len(data))
    cut = len(data) // 5
    train = data.select(np.sort(perm[cut:]))
    test = data.select(np.sort(perm[:cut]))
    counts = lambda: (sgd_epoch.launches, sgd_epoch_tiled.launches,  # noqa: E731
                      bpr_epoch.launches, bpr_epoch_tiled.launches)
    before = counts()
    mf = create_rating_predictor("BiasedMatrixFactorization",
                                 "num_factors=40 num_iter=3 device=cuda")
    mf.ratings = train
    mf.train()
    bpr = create_item_recommender("BPRMF", "num_factors=40 num_iter=3 "
                                  "device=cuda")
    bpr.feedback = posonly_from_ratings(train)
    bpr.train()
    torch.cuda.synchronize()
    after = counts()
    assert [a - b for a, b in zip(after, before)] == [0, 3, 0, 3]
    assert isinstance(mf._plan, P.MxuTiledPlan) and mf._plan.num_slabs == 3
    assert bpr._tiled["num_slabs"] == 3
    pred = mf.predict_batch(test.users, test.items)
    rmse = float(np.sqrt(np.mean((pred - test.values) ** 2)))
    base = float(np.sqrt(np.mean((test.values - train.values.mean()) ** 2)))
    assert rmse < base
    res = evaluate_items(bpr, posonly_from_ratings(test),
                         posonly_from_ratings(train))
    assert math.isfinite(res["AUC"]) and res["AUC"] > 0.6
