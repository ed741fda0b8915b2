"""GPU tier of the port: the CUDA kernels (SGD epoch and BPR epoch, each
on the resident and on the slab-tiled schedule; the SVD++ epoch) against
their plain PyTorch versions on the card. Marked ``cuda``; every test skips without a CUDA
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
from mymedialite_tpu_torch.eval.rating import evaluate_ratings
from mymedialite_tpu_torch.ops import svdpp_plan as SVP
from mymedialite_tpu_torch.ops.sgd_epoch import (
    sgd_epoch, sgd_epoch_reference, sgd_epoch_tiled, sgd_epoch_tiled_reference,
)
from mymedialite_tpu_torch.ops.svdpp import history_edges
from mymedialite_tpu_torch.ops.svdpp_epoch import (
    svdpp_epoch, svdpp_epoch_reference,
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


# --- the SVD++ epoch kernel -----------------------------------------------

SVDPP_VARIANTS = [(False, S.LOSS_RMSE, True), (True, S.LOSS_RMSE, True),
                  (True, S.LOSS_MAE, True), (True, S.LOSS_RMSE, False)]
SVDPP_IDS = ["plain", "sigmoid-rmse", "sigmoid-mae", "no-p"]


def _svdpp_setup(device, users, items, values, U, I, f=20, seed=0, **kw):
    """Plan (edges = the rated pairs) and random tables N(0, 0.1)."""
    edges = history_edges(users, items, I)
    plan = SVP.prepare_svdpp_mxu(users, items, values, *edges, U, I,
                                 shuffle_seed=1, device=device, **kw)
    rng = np.random.default_rng(seed)
    p, bu, q, bi, y = (torch.from_numpy(
        (0.1 * rng.standard_normal(shape)).astype(np.float32)).to(device)
        for shape in ((U, f), (U,), (I, f), (I,), (I, f)))
    noo = torch.from_numpy(plan.new_of_old.astype(np.int64)).to(device)

    def tables(use_p):
        return SVP.svdpp_tables_to_mxu(
            p if use_p else torch.zeros_like(p), bu, plan.inv_sqrt, q, bi, y,
            noo, u_pad=plan.u_pad, i_pad=plan.i_pad, fe=SVP.svdpp_fe(f))
    return plan, tables


def _svdpp_args(plan, device, sigmoid, loss, use_p, f=20, lr=0.003):
    rates = SVP.svdpp_mxu_rates(f, SVP.svdpp_fe(f), lr, 0.7, 0.015, 0.33,
                                0.015, use_p=use_p, update_user=True,
                                update_item=True, device=device)
    hp = (0.6, 1.0, 4.0) if sigmoid else (3.6, 1.0, 4.0)
    return hp, rates, dict(user_block=plan.user_block,
                           item_block=plan.item_block, num_factors=f,
                           loss=loss, sigmoid=sigmoid)


def _block_slices(plan):
    """[(start, end)) of each user block's steps in the schedule."""
    ub = plan.schedule[1].cpu().numpy()
    cut = np.flatnonzero(np.diff(ub)) + 1
    bounds = np.concatenate([[0], cut, [ub.size]])
    return list(zip(bounds[:-1], bounds[1:]))


def _svdpp_blockwise(plan, tables, hp, rates, kw, steps, reference):
    """One launch (kernel) or one plain call per user block, each from the
    float64 plain trajectory's state before the block; returns the
    largest distance to that trajectory after a block."""
    cpu = lambda ts: tuple(t.cpu() for t in ts)  # noqa: E731
    packed_c, rates_c = plan.packed.cpu(), rates.cpu()
    state = tuple(t.double().cpu() for t in tables)
    worst = 0.0
    for a, b in steps:
        one = tuple(t[a:b].contiguous() for t in plan.schedule)
        nxt = tuple(t.clone() for t in state)
        svdpp_epoch_reference(*nxt, packed_c, cpu(one), hp, rates_c.double(),
                              **kw)
        got = tuple(t.float().to(rates.device) for t in state)
        if reference:
            svdpp_epoch_reference(*got, plan.packed, one, hp, rates, **kw)
        else:
            svdpp_epoch(*got, plan.packed, one, hp, rates, **kw)
        worst = max(worst, _dist(got, nxt))
        state = nxt
    return worst


@pytest.mark.parametrize("sigmoid,loss,use_p", SVDPP_VARIANTS, ids=SVDPP_IDS)
def test_svdpp_kernel_matches_reference_by_user_block(cuda, sigmoid, loss,
                                                      use_p):
    """At 2,000 x 3,000 x 100k (k=20, fe=32, four user blocks): one launch
    per user block from the float64 plain trajectory's state before it,
    the kernel and the plain float32 version on the card both within 1e-5
    of float64 (whole epochs measured 1.2e-7 to 1.9e-7 apart); then one
    whole epoch, kernel against plain, within 1e-4."""
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=3)
    plan, tables = _svdpp_setup(cuda, data.users, data.items, data.values,
                                2000, 3000)
    hp, rates, kw = _svdpp_args(plan, cuda, sigmoid, loss, use_p)
    blocks = _block_slices(plan)
    assert len(blocks) == plan.n_ublocks == 4
    before = svdpp_epoch.launches
    k_err = _svdpp_blockwise(plan, tables(use_p), hp, rates, kw, blocks,
                             reference=False)
    p_err = _svdpp_blockwise(plan, tables(use_p), hp, rates, kw, blocks,
                             reference=True)
    assert svdpp_epoch.launches == before + len(blocks)
    print(f"\nsvdpp by user block: kernel {k_err:.3e}, plain {p_err:.3e}")
    assert k_err <= 1e-5 and p_err <= 1e-5
    Wk, Qk, Yk = tables(use_p)
    Wr, Qr, Yr = tables(use_p)
    svdpp_epoch(Wk, Qk, Yk, plan.packed, plan.schedule, hp, rates, **kw)
    svdpp_epoch_reference(Wr, Qr, Yr, plan.packed, plan.schedule, hp, rates,
                          **kw)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in (Wk, Qk, Yk))
    assert _dist((Wk, Qk, Yk), (Wr, Qr, Yr)) <= 1e-4
    if not use_p:
        assert not Wk[:, :20].any()


def test_svdpp_duplicate_items_within_a_chunk(cuda):
    """An 8-item catalog: every 512-slot chunk names each item about 64
    times, in R (Q rows) and in S and Y (Y rows), so a scatter that is not
    atomic loses most of a chunk's updates (about 0.4 of a row here).
    Learn rate 0.05. One launch per user block, from the float64
    trajectory's state: at this rate float32 rounding alone drifts by
    about 6e-5 over a block (the plain version on the CPU, measured), so
    the kernel is held within 1e-4 or 4x the plain float32 version's
    drift on the card, whichever is larger."""
    rng = np.random.default_rng(4)
    U, I, n = 1200, 8, 9000
    users = rng.integers(0, U, n).astype(np.int32)
    items = rng.integers(0, I, n).astype(np.int32)
    values = rng.integers(1, 11, n).astype(np.float32) / 2
    plan, tables = _svdpp_setup(cuda, users, items, values, U, I, f=20)
    d = plan.packed.cpu().numpy()
    real = d[:, 3] != 0
    top = max(np.bincount(d[k, 1][real[k]]).max() for k in range(len(d)))
    assert top >= 64
    hp, rates, kw = _svdpp_args(plan, cuda, True, S.LOSS_RMSE, True, lr=0.05)
    blocks = _block_slices(plan)
    err = _svdpp_blockwise(plan, tables(True), hp, rates, kw, blocks,
                           reference=False)
    plain = _svdpp_blockwise(plan, tables(True), hp, rates, kw, blocks,
                             reference=True)
    print(f"\nsvdpp duplicate items (up to {top} slots on one item in a "
          f"chunk): vs float64 by user block, kernel {err:.3e}, plain "
          f"{plain:.3e}")
    assert err <= max(1e-4, 4 * plain)


def test_svdpp_scratch_resets_at_each_user_block(cuda):
    """s and c start from zero at each user block inside one launch: the
    whole schedule in one launch equals one launch per user block (each
    launch starts from a fresh scratch) and the plain version. The blocks
    use the same local user rows, so sums carried over from the block
    before would land on them."""
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=6)
    plan, tables = _svdpp_setup(cuda, data.users, data.items, data.values,
                                2000, 3000)
    hp, rates, kw = _svdpp_args(plan, cuda, False, S.LOSS_RMSE, True)
    blocks = _block_slices(plan)
    d = plan.packed
    local = []
    for a, b in blocks:
        chunks = d[plan.schedule[3][a:b].long()]
        local.append(set(chunks[:, 0][chunks[:, 3] != 0].tolist()))
    assert all(local[k] & local[k + 1] for k in range(len(local) - 1))
    whole, split, plain = tables(True), tables(True), tables(True)
    svdpp_epoch(*whole, d, plan.schedule, hp, rates, **kw)
    for a, b in blocks:
        svdpp_epoch(*split, d, tuple(t[a:b].contiguous()
                                     for t in plan.schedule), hp, rates, **kw)
    svdpp_epoch_reference(*plain, d, plan.schedule, hp, rates, **kw)
    torch.cuda.synchronize()
    assert _dist(whole, split) <= 1e-5
    assert _dist(whole, plain) <= 1e-5


def test_svdpp_kernel_refuses_bad_shapes(cuda):
    """The wrapper refuses, before any launch, what the kernel does not
    take: mismatched widths, rates of the wrong shape, a width past
    MAX_FE, a chunk past MAX_CHUNK, tensors on two devices."""
    data = synthetic_ratings(num_users=300, num_items=200,
                             num_ratings=5000, seed=1)
    plan, tables = _svdpp_setup(cuda, data.users, data.items, data.values,
                                300, 200)
    W, Q, Y = tables(True)
    hp, rates, kw = _svdpp_args(plan, cuda, False, S.LOSS_RMSE, True)
    args = (plan.packed, plan.schedule, hp)
    wide = torch.zeros((W.shape[0], 264), device=cuda)
    wide_qy = torch.zeros((Q.shape[0], 264), device=cuda)
    long_chunks = torch.zeros((2, 4, 4096), dtype=torch.int32, device=cuda)
    before = svdpp_epoch.launches
    for bad, err in (
            (lambda: svdpp_epoch(W, Q, Y[:, :24].contiguous(), *args, rates,
                                 **kw), ValueError),
            (lambda: svdpp_epoch(W, Q, Y, *args, rates[:, :4].contiguous(),
                                 **kw), ValueError),
            (lambda: svdpp_epoch(wide, wide_qy, wide_qy.clone(), *args,
                                 torch.zeros((264, 8), device=cuda), **kw),
             ValueError),
            (lambda: svdpp_epoch(W, Q, Y, long_chunks, plan.schedule, hp,
                                 rates, **kw), ValueError),
            (lambda: svdpp_epoch(W, Q.cpu(), Y, *args, rates, **kw),
             ValueError),
            (lambda: svdpp_epoch(W, Q, Y.double(), *args, rates, **kw),
             TypeError)):
        with pytest.raises(err):
            bad()
    assert svdpp_epoch.launches == before


def test_svdpp_trains_on_the_card(cuda):
    """SVDPlusPlus through the registry, transductive on the held-out
    pairs, launches the kernel once per epoch and beats the global
    average."""
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=2)
    perm = np.random.default_rng(3).permutation(len(data))
    cut = len(data) // 5
    train = data.select(np.sort(perm[cut:]))
    test = data.select(np.sort(perm[:cut]))
    m = create_rating_predictor("SVDPlusPlus", "num_factors=20 num_iter=5 "
                                "learn_rate=0.01 device=cuda")
    m.ratings = train
    m.additional_feedback = (test.users, test.items)
    before = svdpp_epoch.launches
    m.train()
    torch.cuda.synchronize()
    assert svdpp_epoch.launches == before + 5
    assert all(t.device.type == "cuda" for t in m._mxu_tables)
    res = evaluate_ratings(m, test, train)
    base = float(np.sqrt(np.mean((test.values - train.values.mean()) ** 2)))
    assert math.isfinite(res["RMSE"]) and res["RMSE"] < base
