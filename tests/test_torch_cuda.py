"""GPU tier of the port: the CUDA kernels (SGD epoch and BPR epoch, each
on the resident and on the slab-tiled schedule, also once per cell of
the mesh's sharded epochs; the SVD++ epoch; the fused catalog top-k;
exact_add, the plain routes' scatter) against their plain PyTorch
versions on the card, and the epoch kernels and plain routes launched
twice from one set of inputs giving equal tables. Marked ``cuda``; every test skips without a CUDA
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
    sampler_tables, tiled_cols,
)
from mymedialite_tpu_torch.eval.rating import evaluate_ratings
from mymedialite_tpu_torch.ops import svdpp_plan as SVP
from mymedialite_tpu_torch.ops.catalog_topk import (
    NEG_INF, catalog_topk, topk_reference,
)
from mymedialite_tpu_torch.ops.sgd_epoch import (
    sgd_epoch, sgd_epoch_reference, sgd_epoch_tiled, sgd_epoch_tiled_reference,
)
from mymedialite_tpu_torch.ops.svdpp import history_edges
from mymedialite_tpu_torch.ops import svdpp_epoch as SE
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
    """Two epochs from the same tables and orders. The plain version's
    index_add_ on the card adds by atomics in an order that varies from
    run to run, so the sums differ in the last bits: atol 1e-4. The MAE gradient is the sign of the error, which
    that order can flip for a rating within rounding of its prediction,
    and two trajectories then part by a step; so the MAE cases are held
    to the witnesses of ``test_duplicate_heavy_spread``: every chunk
    stepped alone from the float64 trajectory's state within 1e-4 of the
    float64 step, and after both epochs no farther from float64 than 4x
    the farthest plain run."""
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
    orders = [plan.epoch_order(11 + epoch) for epoch in range(2)]
    order = tuple(torch.cat(ts) for ts in zip(*orders))
    Wk, Hk = W.clone(), H.clone()
    before = sgd_epoch.launches
    for o in orders:
        sgd_epoch_reference(W, H, plan.packed, o, hp, rates, **kw)
        sgd_epoch(Wk, Hk, plan.packed, o, hp, rates, **kw)
    torch.cuda.synchronize()
    assert sgd_epoch.launches == before + 2
    assert torch.isfinite(Wk).all() and torch.isfinite(Hk).all()
    if loss == S.LOSS_MAE:
        step_k, step_p = _sgd_one_step(plan, (W0, H0), order, hp, rates, kw)
        k_dist, p_dist = _sgd_witness(plan, (W0, H0), order, hp, rates, kw)
        print(f"\nsgd mae: one step vs float64, kernel {step_k:.3e}, plain "
              f"{step_p:.3e}; after both epochs vs float64, kernel "
              f"{k_dist:.3e}, farthest plain {p_dist:.3e}")
        assert step_k <= 1e-4 and step_p <= 1e-4
        assert k_dist <= 4 * p_dist
    else:
        assert (Wk - W).abs().max().item() <= 1e-4
        assert (Hk - H).abs().max().item() <= 1e-4
    assert torch.equal(Wk, W0) != sides[0]
    assert torch.equal(Hk, H0) != sides[1]


RUNS = 8


def _dist(a, b):
    return max((x.double().cpu() - y.double().cpu()).abs().max().item()
               for x, y in zip(a, b))


def _sgd_one_step(plan, tables, order, hp, rates, kw):
    """Every chunk of ``order`` stepped alone, by the kernel and by the
    plain float32 version on the CPU, from the float64 plain trajectory's
    state before it; the largest distance of each from the float64 step."""
    cpu = lambda ts: tuple(t.cpu() for t in ts)  # noqa: E731
    packed_c, rates_c = plan.packed.cpu(), rates.cpu()
    state = tuple(t.double().cpu() for t in tables)
    worst_k = worst_p = 0.0
    for k in range(order[0].numel()):
        one = tuple(t[k:k + 1].contiguous() for t in order)
        nxt = tuple(t.clone() for t in state)
        sgd_epoch_reference(*nxt, packed_c, cpu(one), hp, rates_c.double(),
                            **kw)
        got = tuple(t.float().to(rates.device) for t in state)
        sgd_epoch(*got, plan.packed, one, hp, rates, **kw)
        plain = tuple(t.float() for t in state)
        sgd_epoch_reference(*plain, packed_c, cpu(one), hp, rates_c, **kw)
        worst_k = max(worst_k, _dist(got, nxt))
        worst_p = max(worst_p, _dist(plain, nxt))
        state = nxt
    return worst_k, worst_p


def _nudged(tables, seed=1):
    """float64 host copies with every nonzero entry moved by 1e-7 N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    return tuple(t.double().cpu() + 1e-7 * torch.randn(
        t.shape, generator=g, dtype=torch.float64) * (t.cpu() != 0)
        for t in tables)


def _witness(tables, kernel_run, plain_run, runs=2):
    """(the kernel's distance from the float64 plain run after the whole
    order, the farthest plain witness's): the plain version on the card
    ``runs`` times, on the CPU, and in float64 from tables moved by 1e-7.
    ``plain_run`` runs on its tables' device and dtype."""
    truth = plain_run(tuple(t.double().cpu() for t in tables))
    plains = [plain_run(tables) for _ in range(runs)]
    plains += [plain_run(tuple(t.cpu() for t in tables)),
               plain_run(_nudged(tables))]
    return (_dist(kernel_run(tables), truth),
            max(_dist(p, truth) for p in plains))


def _sgd_witness(plan, tables, order, hp, rates, kw):
    def run(fn, tabs):
        d = tabs[0].device
        out = tuple(t.clone() for t in tabs)
        fn(*out, plan.packed.to(d), tuple(t.to(d) for t in order), hp,
           rates.to(d, tabs[0].dtype), **kw)
        return out

    return _witness(tables, lambda t: run(sgd_epoch, t),
                    lambda t: run(sgd_epoch_reference, t))


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
    # the shape contract: fe and the chunk multiples of 4, shared memory
    odd = torch.zeros((2, 4, 642), dtype=torch.int32, device=cuda)
    huge = torch.zeros((2, 4, 8192), dtype=torch.int32, device=cuda)
    before = sgd_epoch.launches
    for packed in (odd, huge):
        with pytest.raises(ValueError, match="multiples of 4"):
            sgd_epoch(W, H, packed, order, (0., 1., 4.), rates, **kw)
    wide = (W[:, :62].contiguous(), H[:, :62].contiguous())
    with pytest.raises(ValueError, match="multiples of 4"):
        sgd_epoch(*wide, plan.packed, order, (0., 1., 4.),
                  rates[:62].contiguous(), **kw)
    assert sgd_epoch.launches == before


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
    are identical, the tables agree to 1e-4 (the plain version's
    index_add_ adds in a run-dependent order on the card)."""
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


@pytest.mark.parametrize("membership", ["keys", "bitmask", "subkeys"])
@pytest.mark.parametrize("soft_margin,wbpr", [
    (False, False), (True, False), (False, True)],
    ids=["bpr", "hinge", "wbpr"])
def test_bpr_sampler_prepass_matches_reference(cuda, membership, soft_margin,
                                               wbpr):
    """The epoch's negatives, sampled for every slot before the walk,
    equal sample_negatives_reference over all chunks at once, bit for bit,
    on the three membership forms (keys and the bitmask on the resident
    schedule, the sub-bucketed keys on the tiled one)."""
    from mymedialite_tpu_torch.ops.bpr_epoch import sample_negatives_reference
    fb = posonly_from_ratings(synthetic_ratings(
        num_users=2000, num_items=3000, num_ratings=100_000, seed=0))
    tiled = membership == "subkeys"
    if tiled:
        plan, state, meta, tl = _bpr_tiled_state(cuda, fb, wbpr)
    else:
        plan, state, meta = BP.prepare_bpr_mxu(
            fb, uniform_user=not wbpr, shuffle_seed=1, bitmask=True,
            device=cuda)
    W, H = _bpr_tables(cuda, plan, fb.num_users, fb.num_items, 40, 0)
    rates = BP.bpr_mxu_column_rates(40, W.shape[1], 0.05, 0.0025, 0.0025,
                                    0.00025, 0.01, True, device=cuda)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              soft_margin=soft_margin, wbpr=wbpr, return_negatives=True)
    if tiled:
        args = _bpr_tiled_args(plan, state, meta, tl, rates, 21, wbpr)
        _, _, neg = bpr_epoch_tiled(W, H, *args, slab_blocks=tl[0],
                                    subkeys=True, **kw)
        packed, table, cdf, bits, order, _ = args
        _, _, _, jb, _, _, nval, bkt, row = order
    else:
        args = _bpr_epoch_args(plan, state, meta, rates, 21, wbpr)
        bitmask = state["bitmask_tbl"] if membership == "bitmask" else None
        _, _, neg = bpr_epoch(W, H, *args, bitmask_tbl=bitmask, **kw)
        packed, table, cdf, bits, (_, _, row), jb, nval, bkt, _ = args
    torch.cuda.synchronize()
    u_loc = packed[row.long(), 0]
    for lo in range(0, row.numel(), 16):
        sl = slice(lo, lo + 16)
        j, ok = sample_negatives_reference(
            bits[sl], jb[sl], nval[sl], bkt[sl], u_loc[sl],
            item_block=plan.item_block, keys_tbl=table,
            bitmask_tbl=state["bitmask_tbl"] if membership == "bitmask"
            else None, cdf_tbl=cdf, wbpr=wbpr, subkeys=tiled)
        assert torch.equal(neg[sl, 0], j)
        assert torch.equal(neg[sl, 1], ok.to(torch.float32).view(torch.int32))
    assert (neg[:, 1] == ONE_BITS).float().mean().item() > 0.99


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

SVDPP_VARIANTS = [(False, S.LOSS_RMSE, True, 20),
                  (True, S.LOSS_RMSE, True, 20),
                  (True, S.LOSS_MAE, True, 20), (True, S.LOSS_RMSE, False, 20)]
SVDPP_IDS = ["plain", "sigmoid-rmse", "sigmoid-mae", "no-p"]
# where R and Y read s, c and n (UB = C = 512): from a copy in shared
# memory at k=20 (up to k=28 it fits beside the owner scatter's stage),
# through L2 at k=100 (fe 104, one float4 per lane, the last lanes masked)
# and at k=200 (fe 208, two float4s per lane)
SVDPP_ON_CHIP = {20: "shared", 100: "global", 200: "global"}
# plain float32 runs whose farthest distance from float64 is the witness
# of the duplicate-heavy SVD++ test
PLAIN_WITNESS_RUNS = 3
SVDPP_VARIANTS += [(False, S.LOSS_RMSE, True, 100),
                   (True, S.LOSS_MAE, True, 200)]
SVDPP_IDS += ["plain-f100", "sigmoid-mae-f200"]


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


def _svdpp_r_steps(plan, tables, hp, rates, kw, reference):
    """Every R step run alone after its user block's S steps (a launch
    zeroes s and c, and only the block's Y steps read what an R step adds
    to c): the kernel, or the plain float32 version on the card, over
    [the block's S steps, the R step] from the float64 trajectory's state
    before the R step, against float64 over the same steps; the float64
    trajectory then takes each block whole. Returns the largest
    distance."""
    cpu = lambda ts: tuple(t.cpu() for t in ts)  # noqa: E731
    packed_c, rates_c = plan.packed.cpu(), rates.cpu().double()
    sched = cpu(plan.schedule)
    state = tuple(t.double().cpu() for t in tables)
    worst = 0.0
    for a, b in _block_slices(plan):
        steps = torch.arange(a, b)
        s_steps = steps[sched[0][a:b] == 0]
        cur = state
        for r in steps[sched[0][a:b] == 1].tolist():
            idx = torch.cat([s_steps, torch.tensor([r])])
            one = tuple(t[idx].contiguous() for t in sched)
            nxt = tuple(t.clone() for t in cur)
            svdpp_epoch_reference(*nxt, packed_c, one, hp, rates_c, **kw)
            got = tuple(t.float().to(rates.device) for t in cur)
            fn = svdpp_epoch_reference if reference else svdpp_epoch
            fn(*got, plan.packed, tuple(t.to(rates.device) for t in one), hp,
               rates, **kw)
            worst = max(worst, _dist(got, nxt))
            cur = nxt
        svdpp_epoch_reference(*state, packed_c,
                              tuple(t[a:b].contiguous() for t in sched), hp,
                              rates_c, **kw)
    return worst


def _svdpp_witness(plan, tables, hp, rates, kw):
    def run(fn, tabs):
        d = tabs[0].device
        out = tuple(t.clone() for t in tabs)
        fn(*out, plan.packed.to(d), tuple(t.to(d) for t in plan.schedule),
           hp, rates.to(d, tabs[0].dtype), **kw)
        return out

    return _witness(tables, lambda t: run(svdpp_epoch, t),
                    lambda t: run(svdpp_epoch_reference, t))


@pytest.mark.parametrize("sigmoid,loss,use_p,f", SVDPP_VARIANTS,
                         ids=SVDPP_IDS)
def test_svdpp_kernel_matches_reference_by_user_block(cuda, sigmoid, loss,
                                                      use_p, f):
    """At 2,000 x 3,000 x 100k (k=20, fe=32, four user blocks; at k=100
    and 200 both variants, ``SVDPP_ON_CHIP``): one launch
    per user block from the float64 plain trajectory's state before it,
    the kernel and the plain float32 version on the card both within 1e-5
    of float64 (whole epochs measured 1.2e-7 to 1.9e-7 apart); then one
    whole epoch, kernel against plain, within 1e-4. The MAE gradient is
    the sign of the error, which the atomics' order can flip, so the MAE
    variants are held instead to the witnesses of the SGD kernel's MAE
    cases: every R step run alone from the float64 state within 1e-4 of
    float64 (``_svdpp_r_steps``), and the whole epoch no farther from
    float64 than 4x the farthest plain run."""
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=3)
    plan, tables = _svdpp_setup(cuda, data.users, data.items, data.values,
                                2000, 3000, f=f)
    hp, rates, kw = _svdpp_args(plan, cuda, sigmoid, loss, use_p, f=f)
    assert SE.accumulator_variant(plan.user_block, f, plan.chunk,
                                  SVP.svdpp_fe(f)) == SVDPP_ON_CHIP[f]
    blocks = _block_slices(plan)
    assert len(blocks) == plan.n_ublocks == 4
    before = svdpp_epoch.launches
    if loss == S.LOSS_MAE:
        k_err = _svdpp_r_steps(plan, tables(use_p), hp, rates, kw,
                               reference=False)
        p_err = _svdpp_r_steps(plan, tables(use_p), hp, rates, kw,
                               reference=True)
        k_dist, p_dist = _svdpp_witness(plan, tables(use_p), hp, rates, kw)
        print(f"\nsvdpp mae (f={f}): R steps one at a time vs float64, "
              f"kernel {k_err:.3e}, plain {p_err:.3e}; whole epoch vs "
              f"float64, kernel {k_dist:.3e}, farthest plain {p_dist:.3e}")
        assert k_err <= 1e-4 and p_err <= 1e-4
        assert k_dist <= 4 * p_dist
        return
    k_err = _svdpp_blockwise(plan, tables(use_p), hp, rates, kw, blocks,
                             reference=False)
    p_err = _svdpp_blockwise(plan, tables(use_p), hp, rates, kw, blocks,
                             reference=True)
    assert svdpp_epoch.launches == before + len(blocks)
    print(f"\nsvdpp by user block (f={f}): kernel {k_err:.3e}, plain "
          f"{p_err:.3e}")
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
        assert not Wk[:, :f].any()


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


def test_svdpp_duplicate_users_and_items_one_step(cuda):
    """Duplicates of users and of items within every chunk, in S (s rows
    and Y rows), R (W, Q and c rows) and Y (Y rows, c rows read): Zipf(1.2)
    users over 1,100 (three user blocks, the top users in hundreds of a
    block's slots) and an 8-item catalog, learn rate 0.05, at the widths
    of ``SVDPP_ON_CHIP``. From the
    float64 trajectory's state, every R step run alone after its block's
    S steps (``_svdpp_r_steps``) and every user block in one launch are
    held within 1e-4 of float64 or 4x the distance of the farthest of
    ``PLAIN_WITNESS_RUNS`` plain float32 runs on the card, whichever is
    larger (the plain version's atomics add in a run-dependent order as
    well, so one plain run is a moving witness; chip_smoke.py's
    ``whole_epoch_witness`` takes the farthest of several too): a
    non-atomic sum into s, c or a table row loses most of a chunk's
    updates."""
    rng = np.random.default_rng(8)
    U, I, n = 1100, 8, 12000
    users = (rng.zipf(1.2, n) % U).astype(np.int32)
    items = rng.integers(0, I, n).astype(np.int32)
    values = rng.integers(1, 11, n).astype(np.float32) / 2
    out = []
    for f in SVDPP_ON_CHIP:
        plan, tables = _svdpp_setup(cuda, users, items, values, U, I, f=f)
        assert plan.n_ublocks == 3
        d = plan.packed.cpu().numpy()
        real = d[:, 3] != 0
        top_u = max(np.bincount(d[k, 0][real[k]]).max() for k in range(len(d)))
        top_i = max(np.bincount(d[k, 1][real[k]]).max() for k in range(len(d)))
        assert top_u >= 32 and top_i >= 64
        hp, rates, kw = _svdpp_args(plan, cuda, True, S.LOSS_RMSE, True, f=f,
                                    lr=0.05)
        blocks = _block_slices(plan)

        def distances(reference):
            return (_svdpp_r_steps(plan, tables(True), hp, rates, kw,
                                   reference),
                    _svdpp_blockwise(plan, tables(True), hp, rates, kw,
                                     blocks, reference))
        kernel = distances(False)
        # the plain version's atomics sum in a run-dependent order too:
        # the farthest of several plain runs is the witness
        runs = [distances(True) for _ in range(PLAIN_WITNESS_RUNS)]
        plain = tuple(max(r[k] for r in runs) for k in range(2))
        out.append(f"f={f} (users up to {top_u}, items up to {top_i} slots "
                   f"of a chunk): R steps kernel {kernel[0]:.3e} plain "
                   f"{plain[0]:.3e}, user blocks kernel {kernel[1]:.3e} "
                   f"plain {plain[1]:.3e} (farthest of "
                   f"{PLAIN_WITNESS_RUNS} plain runs)")
        for k in range(2):
            assert kernel[k] <= max(1e-4, 4 * plain[k])
    print("\nsvdpp duplicate users and items, vs float64: " + "; ".join(out))


@pytest.mark.parametrize("f", list(SVDPP_ON_CHIP))
def test_svdpp_scratch_resets_at_each_user_block(cuda, f):
    """s and c start from zero at each user block inside one launch: the
    whole schedule in one launch equals one launch per user block (each
    launch starts from a fresh scratch) and the plain version, at the
    widths of ``SVDPP_ON_CHIP``. The
    blocks use the same local user rows, so sums carried over from the
    block before would land on them."""
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=6)
    plan, tables = _svdpp_setup(cuda, data.users, data.items, data.values,
                                2000, 3000, f=f)
    assert SE.accumulator_variant(plan.user_block, f, plan.chunk,
                                  SVP.svdpp_fe(f)) == SVDPP_ON_CHIP[f]
    hp, rates, kw = _svdpp_args(plan, cuda, False, S.LOSS_RMSE, True, f=f)
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
    MAX_FE or not a multiple of 4, a chunk past the shared memory or not
    a multiple of 4, tensors on two devices."""
    data = synthetic_ratings(num_users=300, num_items=200,
                             num_ratings=5000, seed=1)
    plan, tables = _svdpp_setup(cuda, data.users, data.items, data.values,
                                300, 200)
    W, Q, Y = tables(True)
    hp, rates, kw = _svdpp_args(plan, cuda, False, S.LOSS_RMSE, True)
    args = (plan.packed, plan.schedule, hp)
    wide = torch.zeros((W.shape[0], 264), device=cuda)
    wide_qy = torch.zeros((Q.shape[0], 264), device=cuda)
    long_chunks = torch.zeros((2, 4, 8192), dtype=torch.int32, device=cuda)
    odd_chunks = torch.zeros((2, 4, 510), dtype=torch.int32, device=cuda)
    odd = torch.zeros((W.shape[0], 34), device=cuda)
    odd_qy = torch.zeros((Q.shape[0], 34), device=cuda)
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
            (lambda: svdpp_epoch(W, Q, Y, odd_chunks, plan.schedule, hp,
                                 rates, **kw), ValueError),
            (lambda: svdpp_epoch(odd, odd_qy, odd_qy.clone(), *args,
                                 torch.zeros((34, 8), device=cuda), **kw),
             ValueError),
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


# --- kernel 6: fused catalog scoring + top-k ---------------------------

def _topk_inputs(B, N, f, mask_frac=None, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    W = torch.from_numpy(rng.normal(size=(B, f)).astype(np.float32))
    H = torch.from_numpy(rng.normal(size=(N, f)).astype(np.float32))
    mask = None
    if mask_frac is not None:
        mask = torch.from_numpy((rng.random((B, N)) > mask_frac)
                                .astype(np.int8))
    return tuple(None if t is None else t.to(device) for t in (W, H, mask))


def _tie_free(vals, gap=1e-5):
    """Positions whose value differs from both neighbours by more than
    ``gap``; ``vals`` may carry one column past the compared ones."""
    v = vals.double()
    d = (v[:, 1:] - v[:, :-1]).abs() > gap
    ok = torch.ones_like(v, dtype=torch.bool)
    ok[:, 1:] &= d
    ok[:, :-1] &= d
    return ok


def assert_topk_agrees(W, H, mask, k):
    """Kernel 6 against topk_reference: values to 1e-4, ids equal where
    the reference's neighbouring values differ by more than 1e-5 (the
    reference's (k+1)-th value decides the last position)."""
    before = catalog_topk.launches
    ids, vals = catalog_topk(W, H, mask, k=k)
    torch.cuda.synchronize()
    assert catalog_topk.launches == before + 1
    ref_ids, ref_vals = topk_reference(W, H, mask, k=k)
    assert ids.shape == ref_ids.shape == (W.shape[0], k)
    assert ids.dtype == torch.int32 and vals.dtype == torch.float32
    assert (vals - ref_vals).abs().max().item() <= 1e-4
    _, ext_vals = topk_reference(W, H, mask, k=min(k + 1, H.shape[0]))
    sure = _tie_free(ext_vals)[:, :min(k, H.shape[0])]
    n = sure.shape[1]
    assert torch.equal(ids[:, :n][sure], ref_ids[:, :n][sure])
    return ids, vals, ref_ids, ref_vals


@pytest.mark.parametrize("B,N,f,k,mask_frac", [
    (16, 1000, 24, 10, None), (300, 1537, 17, 7, None),
    (32, 700, 8, 5, 0.5), (1024, 62_423, 41, 64, None),
    (1024, 17_770, 41, 10, 0.01), (37, 129, 96, 64, 0.3),
    (9, 300, 384, 33, None)],
    ids=["basic", "users-and-tiles", "half-mask", "ml25m-serving",
         "netflix-serving-masked", "ragged-k64", "widest"])
def test_catalog_topk_matches_reference(cuda, B, N, f, k, mask_frac):
    W, H, mask = _topk_inputs(B, N, f, mask_frac, seed=B + N)
    assert_topk_agrees(W, H, mask, k)


def test_catalog_topk_nearly_all_masked(cuda):
    """Fewer candidates than k: the tail holds -3e38, and the kernel's
    ids there are the reference's (the smallest masked ids)."""
    W, H, _ = _topk_inputs(4, 50, 6, seed=3)
    mask = torch.zeros((4, 50), dtype=torch.int8)
    mask[0, [3, 10]] = 1
    mask[1, :] = 1
    ids, vals, ref_ids, _ = assert_topk_agrees(W, H, mask.to(cuda), 4)
    assert (vals[0, 2:] <= NEG_INF / 2).all() and (vals[2:] <= NEG_INF / 2).all()
    assert torch.equal(ids, ref_ids)


def test_catalog_topk_k_larger_than_catalog(cuda):
    W, H, _ = _topk_inputs(8, 6, 4, seed=4)
    ids, vals, ref_ids, ref_vals = assert_topk_agrees(W, H, None, 10)
    assert (ids[:, 6:] == 0).all() and (vals[:, 6:] == NEG_INF).all()
    assert torch.equal(ids[:, :6], ref_ids[:, :6])


@pytest.mark.parametrize("N", [600, 257])
def test_catalog_topk_ties_go_to_the_smaller_id(cuda, N):
    """Identical item rows: every score ties, across tile edges; the k
    smallest ids win, in order, exactly as in the reference."""
    W = torch.ones((3, 4), device=cuda)
    H = torch.ones((N, 4), device=cuda)
    for k in (5, 64):
        ids, _ = catalog_topk(W, H, k=k)
        ref_ids, _ = topk_reference(W, H, k=k)
        assert torch.equal(ids, ref_ids)
        assert torch.equal(ids[0].cpu(), torch.arange(k, dtype=torch.int32))


def _split_case(case, device):
    """The split-and-merge cases of tests/test_torch_catalog_topk.py at a
    few users, where the split rule gives every 128-item tile its own
    split: (W, H, mask, k)."""
    rng = np.random.default_rng(7)
    mask = None
    if case == "ties-across-split-edges":
        W, H, k = np.ones((3, 4), np.float32), np.ones((600, 4), np.float32), 64
    elif case == "short-split":          # the last split holds 44 < k items
        W, H = (rng.normal(size=s).astype(np.float32)
                for s in ((8, 6), (300, 6)))
        k = 64
    elif case == "k-past-split-size":    # 129 items: splits of 128 and 1
        W, H = (rng.normal(size=s).astype(np.float32)
                for s in ((8, 5), (129, 5)))
        k = 64
    elif case == "ragged-tile":
        W, H = (rng.normal(size=s).astype(np.float32)
                for s in ((16, 17), (1537, 17)))
        mask, k = (rng.random((16, 1537)) > 0.3).astype(np.int8), 10
    else:                                # fully-masked-split
        W, H = (np.abs(rng.normal(size=s)).astype(np.float32)
                for s in ((6, 8), (700, 8)))
        H[128:256] += 10                 # the best scores, all masked
        mask, k = np.ones((6, 700), np.int8), 10
        mask[:, 128:256] = 0
    to = lambda a: None if a is None else torch.from_numpy(a).to(device)  # noqa: E731
    return to(W), to(H), to(mask), k


@pytest.mark.parametrize("case", [
    "ties-across-split-edges", "short-split", "k-past-split-size",
    "ragged-tile", "fully-masked-split"])
def test_catalog_topk_split_cases(cuda, case):
    """Kernel 6's split and merge on the card: the catalog is cut into
    several splits, and the lists equal the plain version's (ties across
    split edges exactly by id, masked splits never ahead of real items)."""
    from mymedialite_tpu_torch.ops import catalog_topk as ct
    W, H, mask, k = _split_case(case, cuda)
    room = ct._grid_room(torch.cuda.current_device(), 4 * -(-W.shape[1] // 4))
    assert -(-H.shape[0] // ct.split_items(W.shape[0], H.shape[0], *room)) > 1
    ids, vals, ref_ids, _ = assert_topk_agrees(W, H, mask, k)
    if case == "ties-across-split-edges":
        assert torch.equal(ids, ref_ids)
        assert torch.equal(ids[0].cpu(), torch.arange(64, dtype=torch.int32))
    if case == "fully-masked-split":
        assert not ((ids >= 128) & (ids < 256)).any()


def test_catalog_topk_fills_the_card(cuda):
    """At the serving width the split kernel fits three CTAs on an SM, so
    a block of 1,024 users runs at least two waves of CTAs, in one round."""
    from mymedialite_tpu_torch.ops import catalog_topk as ct
    sms, per_sm = ct._grid_room(torch.cuda.current_device(), 44)
    assert per_sm >= 3
    for N in (17_770, 62_423):
        grid = 32 * -(-N // ct.split_items(1024, N, sms, per_sm))
        assert 2 * sms <= grid <= per_sm * sms


def test_catalog_topk_refuses_bad_input(cuda):
    W, H, mask = _topk_inputs(4, 100, 4, 0.5)
    before = catalog_topk.launches
    for bad in (lambda: catalog_topk(W, H, k=65),
                lambda: catalog_topk(W.double(), H, k=5),
                lambda: catalog_topk(W, H[:, :3].contiguous(), k=5),
                lambda: catalog_topk(W, H, mask[:, :50].contiguous(), k=5),
                lambda: catalog_topk(W, H, mask.float(), k=5),
                lambda: catalog_topk(W, H.cpu(), k=5),
                lambda: catalog_topk(torch.ones((2, 385), device=cuda),
                                     torch.ones((3, 385), device=cuda), k=1)):
        with pytest.raises((ValueError, TypeError)):
            bad()
    assert catalog_topk.launches == before


def test_serving_takes_the_kernel_on_the_card(cuda, monkeypatch):
    """recommend_batch serves a BPRMF on the card through kernel 6, once
    per block, with the lists of the sort route on the same model; the
    full list (n = -1) keeps the sort."""
    from mymedialite_tpu_torch.ops import topk as T
    feedback = posonly_from_ratings(synthetic_ratings(
        num_users=3000, num_items=2000, num_ratings=60_000, seed=7))
    m = create_item_recommender("BPRMF", "num_factors=16 num_iter=2 "
                                "device=cuda")
    m.feedback = feedback
    m.train()
    users = np.arange(0, 3000, dtype=np.int32)
    cand = range(0, 2000, 2)
    before = catalog_topk.launches
    ids, scores = T.recommend_batch(m, users, 10, training=feedback,
                                    candidates=cand, block=512)
    torch.cuda.synchronize()
    assert catalog_topk.launches == before + 6
    with monkeypatch.context() as mp:
        mp.setattr(T, "takes_topk_kernel", lambda rec, k: False)
        ref_ids, ref_s = T.recommend_batch(m, users, 11, training=feedback,
                                           candidates=cand, block=512)
    assert catalog_topk.launches == before + 6
    np.testing.assert_allclose(scores, ref_s[:, :10], rtol=0, atol=1e-5)
    gap = np.abs(np.diff(ref_s.astype(np.float64), axis=1)) > 1e-5
    sure = np.ones(ref_s.shape, bool)
    sure[:, 1:] &= gap
    sure[:, :-1] &= gap
    sure = sure[:, :10]
    assert (ids[sure] == ref_ids[:, :10][sure]).all()
    assert (ids % 2 == 0).all()
    for r in (0, 999, 2999):
        assert not set(ids[r]) & set(feedback.items_by_user(r).tolist())
    T.recommend_batch(m, users[:100], 2000, training=feedback)   # the full list
    assert catalog_topk.launches == before + 6


def test_rating_models_rank_and_serve_on_the_card(cuda):
    """The MF and SVD++ catalog scorers run on the card: the ranking
    evaluator and recommend_batch take the tables' device, and the
    scores equal the host predictions."""
    data = synthetic_ratings(num_users=800, num_items=600,
                             num_ratings=20_000, seed=8)
    perm = np.random.default_rng(1).permutation(len(data))
    cut = len(data) // 5
    train = data.select(np.sort(perm[cut:]))
    test = data.select(np.sort(perm[:cut]))
    pos = lambda d: PosOnlyData(d.users, d.items, num_users=d.num_users,  # noqa: E731
                                num_items=d.num_items)
    from mymedialite_tpu_torch.ops.topk import recommend_batch
    for name in ("BiasedMatrixFactorization", "SVDPlusPlus"):
        m = create_rating_predictor(name, "num_factors=8 num_iter=2 "
                                    "device=cuda")
        m.ratings = train
        m.train()
        assert m.tables_device().type == "cuda"
        users = np.arange(0, 800, 7, dtype=np.int32)
        scores = m.score_catalog(users)
        want = np.stack([m.predict_batch(np.full(600, u, np.int32),
                                         np.arange(600, dtype=np.int32))
                         for u in users])
        np.testing.assert_allclose(scores, want, rtol=0, atol=1e-5)
        res = evaluate_items(m, pos(test), pos(train),
                             candidate_item_mode="UNION")
        assert math.isfinite(res["AUC"]) and res["num_users"] > 0
        before = catalog_topk.launches
        ids, _ = recommend_batch(m, users, 10, training=pos(train))
        assert catalog_topk.launches == before and (ids >= 0).all()


# --- the WRMF / KNN slice: the library products it trusts on the card ---

@pytest.mark.parametrize("R,C,m", [(64, 48, 40), (4096, 16384, 17776),
                                   (512, 1024, 480_000)])
def test_int_mm_overlaps_are_exact(cuda, R, C, m):
    """``torch._int_mm`` on 0/1 int8 rows, the second operand a
    transposed view as ``ops/correlation.py`` passes it, against float64:
    equal (exact int32 sums). Levels up to 11 squared too."""
    from mymedialite_tpu_torch.ops.correlation import _overlap_int8
    gen = torch.Generator(device=cuda).manual_seed(R + C)
    X = (torch.rand((R, m), generator=gen, device=cuda) < 0.05).to(torch.int8)
    Y = (torch.rand((C, m), generator=gen, device=cuda) < 0.05).to(torch.int8)
    got = _overlap_int8(X, Y)
    want = X.double() @ Y.double().T
    assert got.dtype == torch.int32
    assert torch.equal(got.double(), want)
    L = (X * torch.randint(1, 12, X.shape, generator=gen, device=cuda,
                           dtype=torch.int8))
    assert torch.equal(_overlap_int8(L * L, Y).double(),
                       (L.double() ** 2) @ Y.double().T)


def test_streaming_merge_keeps_the_tie_order(cuda):
    """A tie-heavy incidence (3,000 entities over 6 features, so cosine
    takes few distinct values) on the card: the streaming top-k equals
    the stable sort of the dense matrix (value desc, id asc) id for id,
    and the same call on the CPU."""
    from mymedialite_tpu_torch.ops import correlation as T
    rng = np.random.default_rng(5)
    n, m = 3000, 6
    data = PosOnlyData(rng.integers(0, n, 9000), rng.integers(0, m, 9000),
                       n, m)
    ids, vals = T.binary_correlation_topk(data, n, m, 50, device=cuda)
    dense = T.binary_correlation(data, n, m, device=cuda)
    want = T.nearest_neighbors(dense, 50)
    assert torch.equal(ids, want)
    assert torch.equal(vals, dense.gather(1, want.long()))
    cpu_ids, cpu_vals = T.binary_correlation_topk(data, n, m, 50,
                                                  device="cpu")
    assert torch.equal(ids.cpu(), cpu_ids)
    assert torch.equal(vals.cpu(), cpu_vals)


def test_cholesky_routes_against_float64(cuda):
    """480 WRMF rows of 40 factors from random factors: ``wrmf_optimize``
    (float32 assembly, ``cholesky_ex``) within 1e-5 of the systems
    assembled and solved in float64 from the same histories (relative to
    the largest entry), and ``cholesky_ex`` reports no failure."""
    from mymedialite_tpu_torch.ops import als
    gen = torch.Generator(device=cuda).manual_seed(3)
    H = 0.1 * torch.randn((3000, 40), generator=gen, device=cuda)
    hist = torch.randint(0, 3000, (480, 64), generator=gen, device=cuda)
    lens = torch.randint(0, 65, (480,), generator=gen, device=cuda)
    x = als.wrmf_optimize(H, hist, lens, 1.0, 0.015, chunk=128)
    H64 = H.double()
    mask = (torch.arange(64, device=cuda)[None, :] < lens[:, None]).double()
    Hs = H64[hist] * mask[:, :, None]
    M = H64.T @ H64 + Hs.transpose(1, 2) @ Hs \
        + 0.015 * torch.eye(40, dtype=torch.float64, device=cuda)
    L, info = torch.linalg.cholesky_ex(M)
    assert not bool((info != 0).any())
    x64 = torch.cholesky_solve(2.0 * Hs.sum(dim=1)[:, :, None], L)[:, :, 0]
    err = float((x.double() - x64).abs().max() / x64.abs().max())
    assert err <= 1e-5, err


# --- the XLA routes: plain PyTorch epochs on the card against the CPU ---


def _host(tables, dtype=torch.float64):
    return {k: v.detach().to("cpu", dtype).clone() for k, v in tables.items()}


def _far(card, host):
    return max((card[k].double().cpu() - host[k]).abs().max().item()
               for k in host)


@pytest.mark.parametrize("freq", [False, True])
def test_blocked_mf_epoch_card_vs_cpu(cuda, freq):
    """One blocked epoch (4 groups of 512 users, batches of 4,096) on the
    card and on the CPU in float64 from the same tables and orders."""
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=3)
    bd, meta = S.prepare_blocked_data(data.users, data.items, data.values,
                                      2000, 4096, 512, device=cuda)
    gen = torch.Generator().manual_seed(0)
    W = 0.1 * torch.randn((2000, 40), generator=gen)
    H = 0.1 * torch.randn((3000, 40), generator=gen)
    We, He = S.extend_tables(W, H, group_users=512)
    card = dict(W=We.to(cuda), H=He.to(cuda))
    host = _host(card)
    nb = meta["l_pad"] // meta["batch"]
    orders = torch.stack([torch.randperm(nb, generator=gen)
                          for _ in range(meta["ngroups"])])
    args = (40, 0.01, 0.015, 0.015, 1.0, 0.01, True, True, True)
    freq_t = S.blocked_freq(data.count_by_user, data.count_by_item, 2048,
                            cuda) if freq else None
    hp = (0.2, 1.0, 4.0)
    S.sgd_epoch_blocked(card["W"], card["H"], bd, orders, hp,
                        S.column_rates(*args, device=cuda), freq_t,
                        meta=meta, loss=0, biased=True)
    host_bd = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
               for k, v in bd.items()}
    S.sgd_epoch_blocked(host["W"], host["H"], host_bd, orders, hp,
                        S.column_rates(*args), None if freq_t is None else
                        tuple(f.double().cpu() for f in freq_t),
                        meta=meta, loss=0, biased=True)
    assert _far(card, host) <= 1e-4


def test_minibatch_bpr_card_vs_cpu(cuda):
    """Ten batches of triples drawn on the card, applied there and on the
    CPU in float64; the card's sampler against the membership truth."""
    from mymedialite_tpu_torch.ops import bpr as B
    fb = posonly_from_ratings(synthetic_ratings(2000, 3000, 100_000, seed=4))
    sampler, meta = B.make_sampler_data(fb, 8, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    card = dict(user_factors=0.1 * torch.randn((2000, 40), device=cuda),
                item_factors=0.1 * torch.randn((3000, 40), device=cuda),
                item_bias=torch.zeros(3000, device=cuda))
    host = _host(card)
    hp = dict(learn_rate=0.05, reg_u=0.0025, reg_i=0.0025, reg_j=0.00025,
              bias_reg=0.0)
    pos = set(zip(fb.users.tolist(), fb.items.tolist()))
    pop = B.popularity_cdf(fb.count_by_item, cuda)
    for b in range(10):
        regime = b % 4
        perm = torch.randperm(4096 * 10, generator=gen, device=cuda)
        u, i, j, w = B.sample_triples(gen, sampler, meta, 4096, regime,
                                      perm=perm % len(fb), batch_index=b,
                                      pop_cdf=pop)
        pairs = zip(u.tolist(), i.tolist(), j.tolist(), w.tolist())
        assert all((a, p) in pos and ((a, n) not in pos or not o)
                   for a, p, n, o in pairs)
        B.bpr_step(card, u, i, j, w, hp, update_j=True)
        B.bpr_step(host, u.cpu(), i.cpu(), j.cpu(), w.cpu(), hp,
                   update_j=True)
    assert _far(card, host) <= 1e-4


@pytest.mark.parametrize("attrs", [False, True])
def test_grouped_svdpp_epoch_card_vs_cpu(cuda, attrs):
    """One grouped epoch (16 groups of 128 users, chunks of 4,096) on the
    card and on the CPU in float64 from the same tables; gSVD++'s
    matmuls stay float32 under TF32 flags."""
    from mymedialite_tpu_torch.ops import svdpp as SV
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=5)
    hu, hi = history_edges(data.users, data.items, 3000)
    groups = SV.prepare_groups(data.users, data.items, data.values, hu, hi,
                               2000, 128, device=cuda)
    gen = torch.Generator().manual_seed(2)
    tables = dict(user_bias=torch.zeros(2000), item_bias=torch.zeros(3000),
                  item_factors=0.1 * torch.randn((3000, 20), generator=gen),
                  y=0.1 * torch.randn((3000, 20), generator=gen),
                  p=0.1 * torch.randn((2000, 20), generator=gen))
    attr = None
    if attrs:
        tables["x"] = 0.1 * torch.randn((18, 20), generator=gen)
        attr = torch.zeros((3000, 18))
        attr[torch.arange(3000), torch.arange(3000) % 18] = 1.0
    card = {k: v.to(cuda) for k, v in tables.items()}
    host = _host(card)
    regs = dict(user_reg=torch.full((2000,), 0.015),
                item_reg=torch.full((3000,), 0.015),
                y_reg=torch.full((3000,), 0.015), x_reg=torch.full((18,), 0.015))
    inv = torch.from_numpy(SV.inv_sqrt_counts(hu, 2000))
    hp = dict(global_bias=3.6, learn_rate=0.003, bias_learn_rate=0.7,
              bias_reg=0.33, min_rating=1.0, rating_range=4.0)
    kw = dict(loss=0, sigmoid=False, use_p=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        SV.svdpp_epoch_grouped(card, groups, inv.to(cuda), hp,
                               {k: r.to(cuda) for k, r in regs.items()},
                               attr_norm=None if attr is None
                               else attr.to(cuda), **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    SV.svdpp_epoch_grouped(host, groups.to("cpu"), inv.double(), hp,
                           _host(regs), attr_norm=None if attr is None
                           else attr.double(), **kw)
    assert _far(card, host) <= 1e-4


# --- the mesh (parallel/mesh.py): the sharded epochs on a rig of one card
# named four times, and on every card of the machine where it has several


def _rig(cuda, D=4):
    from mymedialite_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(devices=[f"cuda:{torch.cuda.current_device()}"] * D)


@pytest.mark.parametrize("tiled", [False, True], ids=["sharded",
                                                      "sharded-tiled"])
def test_sgd_sharded_matches_reference(cuda, tiled):
    """The sharded SGD epoch on the rig launches kernel 1 (2) once per
    non-empty cell and agrees with its plain version on the CPU."""
    from mymedialite_tpu_torch.ops.sgd_epoch import (
        sgd_epoch_sharded, sgd_epoch_sharded_tiled,
    )
    from mymedialite_tpu_torch.parallel.mesh import make_mesh
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=4)
    args = (data.users, data.items, data.values, 2000, 3000, 4)
    plan_kw = dict(chunk=None, slab_blocks=1) if tiled else dict(chunk=640)
    plans = [(P.prepare_mxu_sharded_tiled if tiled else P.prepare_mxu_sharded)(
        *args, shuffle_seed=2, device=dev, **plan_kw)
        for dev in (cuda, "cpu")]
    rng = np.random.default_rng(1)
    tabs = (0.1 * rng.standard_normal((2000, 40)),
            0.1 * rng.standard_normal((3000, 40)), None, None)
    order = plans[0].epoch_order(3)
    out = []
    for plan, mesh in ((plans[0], _rig(cuda)),
                       (plans[1], make_mesh(devices=["cpu"] * 4))):
        W, H = P.extend_tables_mxu(plan, *tabs)
        Ws, Hs = mesh.shard_rows(W), mesh.shard_rows(H)
        rates = P.mxu_column_rates(40, W.shape[1], 0.01, 0.015, 0.015, 1.0,
                                   0.01, True, True, True, device=W.device)
        kw = dict(user_block=plan.user_block, item_block=plan.item_block,
                  loss=S.LOSS_RMSE, biased=True)
        fn = sgd_epoch_tiled if tiled else sgd_epoch
        before = fn.launches
        if tiled:
            sgd_epoch_sharded_tiled(mesh, Ws, Hs, plan.packed, order,
                                    plan.cell_counts, (0.6, 1.0, 4.0), rates,
                                    slab_blocks=plan.slab_blocks, **kw)
        else:
            sgd_epoch_sharded(mesh, Ws, Hs, plan.packed, order,
                              plan.cell_counts, (0.6, 1.0, 4.0), rates, **kw)
        launched = fn.launches - before
        out.append(torch.cat([mesh.gather_rows(Ws).cpu(),
                              mesh.gather_rows(Hs).cpu()]))
        if W.device.type == "cuda":
            assert launched == int((plan.cell_counts > 0).sum())
        else:
            assert launched == 0
    torch.cuda.synchronize()
    assert (out[0] - out[1]).abs().max().item() <= 1e-4


@pytest.mark.parametrize("tiled", [False, True], ids=["sharded",
                                                      "sharded-tiled"])
def test_bpr_sharded_matches_reference(cuda, tiled):
    """The sharded BPR epoch on the rig: negatives identical to its plain
    version on the CPU, tables within 1e-4, kernel 3 (4) once per cell."""
    from mymedialite_tpu_torch.ops.bpr_epoch import (
        bpr_epoch_sharded, bpr_epoch_sharded_tiled,
    )
    from mymedialite_tpu_torch.parallel.mesh import make_mesh
    fb = posonly_from_ratings(synthetic_ratings(
        num_users=2000, num_items=3000, num_ratings=100_000, seed=5))
    outs = []
    for dev, mesh in ((cuda, _rig(cuda)), ("cpu", make_mesh(
            devices=["cpu"] * 4))):
        if tiled:
            plan, state, meta = BP.prepare_bpr_mxu_sharded_tiled(
                fb, 4, uniform_user=True, slab_blocks=1, shuffle_seed=2,
                device=dev)
            order = BP.bpr_sharded_tiled_epoch_order(plan, state["nvalid"], 3)
        else:
            plan, state, meta = BP.prepare_bpr_mxu_sharded(
                fb, 4, uniform_user=True, shuffle_seed=2, device=dev)
            order = BP.bpr_sharded_epoch_order(plan, state["nvalid"], 3)
        gen = torch.Generator().manual_seed(6)
        bits = torch.randint(0, 2 ** 31, (4, 4, plan.nc_pad, meta[2],
                                          plan.chunk), dtype=torch.int32,
                             generator=gen).to(dev)
        rng = np.random.default_rng(1)
        W, H = BP.bpr_tables_to_mxu(
            *(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
                0.1 * rng.standard_normal((fb.num_users, 40)),
                0.1 * rng.standard_normal((fb.num_items, 40)),
                np.zeros(fb.num_items))),
            torch.from_numpy(plan.new_of_old.astype(np.int64)).to(dev),
            u_pad=plan.u_pad, i_pad=plan.i_pad, fe=64)
        Ws, Hs = mesh.shard_rows(W), mesh.shard_rows(H)
        rates = BP.bpr_mxu_column_rates(40, 64, 0.05, 0.0025, 0.0025,
                                        0.00025, 0.0, True, device=dev)
        kw = dict(part_blocks=plan.part_blocks, user_block=plan.user_block,
                  item_block=plan.item_block, return_negatives=True)
        fn = bpr_epoch_tiled if tiled else bpr_epoch
        before = fn.launches
        if tiled:
            _, _, negs = bpr_epoch_sharded_tiled(
                mesh, Ws, Hs, plan.packed, state["subkeys_tbl"],
                state["cdf_tbl"], bits, order, plan.cell_counts, rates,
                slab_blocks=plan.slab_blocks, **kw)
        else:
            _, _, negs = bpr_epoch_sharded(
                mesh, Ws, Hs, plan.packed, state["keys_tbl"],
                state["cdf_tbl"], bits, order, plan.cell_counts, rates,
                bitmask_tbl=state.get("bitmask_tbl"), **kw)
        if dev != "cpu":
            assert fn.launches - before == int((plan.cell_counts > 0).sum())
        outs.append((torch.cat([mesh.gather_rows(Ws).cpu(),
                                mesh.gather_rows(Hs).cpu()]),
                     [[n if n is None else n.cpu() for n in row]
                      for row in negs]))
    (ta, na), (tb, nb) = outs
    for ra, rb in zip(na, nb):
        for a, b in zip(ra, rb):
            assert (a is None and b is None) or torch.equal(a, b)
    assert (ta - tb).abs().max().item() <= 1e-4


def test_models_on_the_rig_take_the_sharded_route(cuda):
    """BiasedMatrixFactorization and BPRMF with a mesh train on the
    sharded route on the card, and their tables come back to it."""
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=7)
    mf = create_rating_predictor("BiasedMatrixFactorization",
                                 "num_factors=16 num_iter=2")
    mf.mesh = _rig(cuda)
    mf.ratings = data
    before = sgd_epoch.launches
    mf.train()
    assert mf._route() == "sharded"
    assert sgd_epoch.launches - before == 2 * int(
        (mf._plan.cell_counts > 0).sum())
    assert mf.W_ext.device.type == "cuda" and torch.isfinite(mf.W_ext).all()
    bpr = create_item_recommender("BPRMF", "num_factors=16 num_iter=2")
    bpr.mesh = _rig(cuda)
    bpr.feedback = posonly_from_ratings(data)
    bpr.train()
    assert bpr._route() == "sharded"
    assert all(torch.isfinite(t).all() for t in bpr.params.values())


def test_sharded_epoch_on_every_card(cuda):
    """On a machine with several cards the epoch runs one cell per card at
    a time (the launches set each card current, the partitions move by
    peer copies) and equals the rig's; with one card it is skipped."""
    from mymedialite_tpu_torch.ops.sgd_epoch import sgd_epoch_sharded
    from mymedialite_tpu_torch.parallel.mesh import make_mesh
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    mesh = make_mesh()
    D = mesh.size
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=8)
    plan = P.prepare_mxu_sharded(data.users, data.items, data.values, 2000,
                                 3000, D, shuffle_seed=2, device=cuda)
    rng = np.random.default_rng(1)
    W, H = P.extend_tables_mxu(plan, 0.1 * rng.standard_normal((2000, 40)),
                               0.1 * rng.standard_normal((3000, 40)))
    rates = P.mxu_column_rates(40, W.shape[1], 0.01, 0.015, 0.015, 1.0, 0.01,
                               True, True, True, device=cuda)
    order = plan.epoch_order(3)
    out = []
    for m in (mesh, _rig(cuda, D)):
        Ws, Hs = m.shard_rows(W.clone()), m.shard_rows(H.clone())
        sgd_epoch_sharded(m, Ws, Hs, plan.packed, order, plan.cell_counts,
                          (0.6, 1.0, 4.0), rates, user_block=512,
                          item_block=1024, loss=S.LOSS_RMSE, biased=True)
        out.append(torch.cat([m.gather_rows(Ws, cuda),
                              m.gather_rows(Hs, cuda)]))
    torch.cuda.synchronize()
    assert (out[0] - out[1]).abs().max().item() <= 1e-4


def test_models_train_on_every_card_by_default(cuda):
    """With several cards, BiasedMF, BPRMF and WRMF left at their default
    mesh train on all of them (kernels 1 and 3 once per non-empty cell),
    and the eval splits its users over them; the tables equal those of an
    explicit rig of one card named as often (1e-4: the cells' atomics),
    and with one card it is skipped."""
    from mymedialite_tpu_torch.data.synthetic import split_posonly
    from mymedialite_tpu_torch.eval import ranking
    from mymedialite_tpu_torch.parallel.mesh import (
        DEFAULT_MESH, default_mesh,
    )
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    D = torch.cuda.device_count()
    assert default_mesh("cuda").size == D
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=8)
    fb, test = split_posonly(posonly_from_ratings(data), seed=2)
    tables, lines = [], []
    for mesh in (DEFAULT_MESH, _rig(cuda, D)):
        mf = create_rating_predictor("BiasedMatrixFactorization",
                                     "num_factors=16 num_iter=2")
        mf.mesh = mesh
        mf.ratings = data
        before = sgd_epoch.launches
        mf.train()
        assert mf._route() == "sharded" and mf._mesh.size == D
        assert sgd_epoch.launches - before == 2 * int(
            (mf._plan.cell_counts > 0).sum())
        bpr = create_item_recommender("BPRMF", "num_factors=16 num_iter=2")
        bpr.mesh = mesh
        bpr.feedback = fb
        before = bpr_epoch.launches
        bpr.train()
        assert bpr._route() == "sharded" and bpr._mesh.size == D
        assert bpr_epoch.launches - before == 2 * int(
            (bpr._plan.cell_counts > 0).sum())
        wrmf = create_item_recommender("WRMF", "num_factors=16 num_iter=2")
        wrmf.mesh = mesh
        wrmf.feedback = fb
        wrmf.train()
        assert wrmf._hist_mesh.size == D
        calls = []
        real = ranking._ranks_on_mesh
        ranking._ranks_on_mesh = lambda m, *a: calls.append(m.size) or \
            real(m, *a)
        try:
            lines.append(ranking.evaluate_items(bpr, test, fb))
        finally:
            ranking._ranks_on_mesh = real
        assert calls and set(calls) == {D}
        tables.append([mf.W_ext, mf.H_ext] + [
            m.params[k] for m in (bpr, wrmf)
            for k in ("user_factors", "item_factors")])
    torch.cuda.synchronize()
    for a, b in zip(*tables):
        assert (a - b.to(a.device)).abs().max().item() <= 1e-4
    assert lines[0]["num_users"] == lines[1]["num_users"] > 0
    assert abs(lines[0]["AUC"] - lines[1]["AUC"]) <= 1e-3


# --- the blocked MF epoch's exact scatter (ops/sgd.py add_rows): two runs
# of one seed give the same tables on the card


def _blocked_twice(cuda, sharded, freq):
    data = synthetic_ratings(num_users=2048, num_items=3000,
                             num_ratings=100_000, seed=3)
    bd, meta = S.prepare_blocked_data(data.users, data.items, data.values,
                                      2048, 4096, 512, device=cuda)
    gen = torch.Generator().manual_seed(0)
    We, He = S.extend_tables(0.1 * torch.randn((2048, 40), generator=gen),
                             0.1 * torch.randn((3000, 40), generator=gen),
                             group_users=512)
    nb = meta["l_pad"] // meta["batch"]
    orders = torch.stack([torch.randperm(nb, generator=gen)
                          for _ in range(meta["ngroups"])])
    rates = S.column_rates(40, 0.01, 0.015, 0.015, 1.0, 0.01, True, True,
                           True, device=cuda)
    f = S.blocked_freq(data.count_by_user, data.count_by_item, 2048,
                       cuda) if freq else None
    runs = []
    for _ in range(2):
        W, H = We.to(cuda), He.to(cuda)
        if sharded:
            S.sgd_epoch_blocked_sharded(_rig(cuda), W, H, bd, orders[:1],
                                        (0.2, 1.0, 4.0), rates, f, meta=meta,
                                        loss=0, biased=True)
        else:
            S.sgd_epoch_blocked(W, H, bd, orders, (0.2, 1.0, 4.0), rates, f,
                                meta=meta, loss=0, biased=True)
        runs.append((W.cpu(), H.cpu()))
    return runs, He


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["one-device", "rig"])
@pytest.mark.parametrize("freq", [False, True])
def test_blocked_epoch_repeats_bit_for_bit(cuda, sharded, freq):
    """Two blocked epochs (4 groups of 512 users, batches of 4,096: about
    1,400 ratings a batch on 3,000 items, so duplicates in every batch)
    from the same tables and batch orders give equal tables on the card,
    on one device and on the rig of one card named 4 times."""
    (a, b), He = _blocked_twice(cuda, sharded, freq)
    assert not torch.equal(a[1], He)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_exact_add_repeats_where_index_add_may_not(cuda):
    """``add_rows`` on a batch of 131,072 slots on 64 rows gives the same
    bits ten times, within an ulp of the float64 sum; ``index_add_``'s
    spread over the same ten runs and both calls' times are printed."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    ids = torch.randint(0, 64, (131_072,), device=cuda, generator=gen)
    delta = torch.randn((131_072, 42), device=cuda, generator=gen)
    table = torch.randn((64, 42), device=cuda, generator=gen)
    exact = [S.add_rows(table.clone(), ids, delta) for _ in range(10)]
    assert all(torch.equal(exact[0], t) for t in exact[1:])
    ref = table.double().index_add_(0, ids, delta.double())
    ulp = torch.finfo(torch.float32).eps * ref.abs().max().item()
    assert (exact[0].double() - ref).abs().max().item() <= ulp
    atomics = [table.clone().index_add_(0, ids, delta) for _ in range(10)]
    spread = max((t - atomics[0]).abs().max().item() for t in atomics)
    times = []
    for fn in (lambda t: S.add_rows(t, ids, delta),
               lambda t: t.index_add_(0, ids, delta)):
        t = table.clone()
        fn(t)
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(20):
            fn(t)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / 20)
    print(f"index_add_ spread over 10 runs: {spread:.3e}; add_rows "
          f"{times[0]:.3f} ms, index_add_ {times[1]:.3f} ms a call")


# --- one seed, one model: the epoch kernels' owner scatter (each row's
# deltas summed in slot order, csrc/owner_scatter.cuh) and exact_add's
# kernel give the same tables on every run


def _equal_twice(run):
    """Run ``run()`` twice (each from fresh copies of its inputs); True
    where every table of the two runs is equal bit for bit."""
    a, b = run(), run()
    torch.cuda.synchronize()
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _zipf_ratings(rng, U=700, I=900, n=20000):
    users = rng.integers(0, U, n).astype(np.int32)
    items = (rng.zipf(1.3, n) % I).astype(np.int32)
    values = rng.integers(1, 11, n).astype(np.float32) / 2
    return users, items, values, U, I


@pytest.mark.parametrize("case", ["resident", "tiled", "duplicate-heavy"])
def test_sgd_kernels_repeat_bit_for_bit(cuda, case):
    """Two launches of kernel 1 (resident) or 2 (tiled) from the same
    tables, order and rates give equal tables: on _setup's data, on its
    tiled plan, and on test_duplicate_heavy_spread's chunks (a Zipf(1.3)
    catalog, one item in about a quarter of the slots)."""
    kw = dict(loss=S.LOSS_RMSE, biased=True)
    if case == "duplicate-heavy":
        rng = np.random.default_rng(0)
        users, items, values, U, I = _zipf_ratings(rng)
        plan = P.prepare_mxu_data(users, items, values, U, I, user_block=512,
                                  item_block=1024, chunk=640, shuffle_seed=1,
                                  device=cuda)
        W, H = P.extend_tables_mxu(plan, 0.1 * rng.standard_normal((U, 40)),
                                   0.1 * rng.standard_normal((I, 40)))
    elif case == "tiled":
        data = synthetic_ratings(num_users=2000, num_items=3000,
                                 num_ratings=100_000, seed=0)
        plan = P.prepare_mxu_tiled(data.users, data.items, data.values, 2000,
                                   3000, user_block=512, item_block=1024,
                                   chunk=None, slab_blocks=1, shuffle_seed=4,
                                   device=cuda)
        rng = np.random.default_rng(0)
        W, H = P.extend_tables_mxu(plan, 0.1 * rng.standard_normal((2000, 40)),
                                   0.1 * rng.standard_normal((3000, 40)))
        kw["slab_blocks"] = plan.slab_blocks
    else:
        plan, W, H = _setup(cuda, True)
    rates = P.mxu_column_rates(40, W.shape[1], 0.05, 0.02, 0.03, 1.0, 0.5,
                               True, True, True, device=cuda)
    order = plan.epoch_order(5)
    epoch = sgd_epoch_tiled if case == "tiled" else sgd_epoch

    def run():
        Wk, Hk = W.clone(), H.clone()
        epoch(Wk, Hk, plan.packed, order, (0.3, 1.0, 4.0), rates,
              user_block=plan.user_block, item_block=plan.item_block, **kw)
        return Wk, Hk
    assert _equal_twice(run)


@pytest.mark.parametrize("case", ["keys", "bitmask-soft-margin",
                                  "keys-wbpr", "tiled", "duplicate-heavy"])
def test_bpr_kernels_repeat_bit_for_bit(cuda, case):
    """Two launches of kernel 3 (resident: keys, bitmask with the hinge,
    WBPR) or 4 (tiled, sub-bucketed keys) from the same tables, order and
    bits give equal tables, and the sampler's per-epoch segment tables
    equal the plain builder's on the sampled negatives; also on
    test_bpr_duplicate_heavy_one_chunk_at_a_time's chunks."""
    from mymedialite_tpu_torch.ops.segments import bpr_segments_reference
    wbpr = case == "keys-wbpr"
    if case == "duplicate-heavy":
        rng = np.random.default_rng(0)
        U, I, n = 700, 900, 20000
        fb = PosOnlyData(rng.integers(0, U, n), rng.zipf(1.3, n) % I,
                         num_users=U, num_items=I)
    else:
        fb = posonly_from_ratings(synthetic_ratings(
            num_users=2000, num_items=3000, num_ratings=100_000, seed=0))
    if case == "tiled":
        plan, state, meta = BP.prepare_bpr_mxu(
            fb, uniform_user=True, shuffle_seed=4, chunk=None, kcap=128,
            subkeys=True, ksub_cap=256, bitmask=False, chunk_overhead=256,
            device=cuda)
        B, S_, slab_items = BP.bpr_tiled_plan(plan, state["nvalid"],
                                              slab_blocks=1)
        order = BP.bpr_tiled_epoch_order(
            plan, state["nvalid"], slab_items, slab_blocks=B, num_slabs=S_,
            num_items=meta[3], seed=7)
        gen = torch.Generator(device=cuda).manual_seed(7)
        bits = torch.randint(0, 2 ** 31, (plan.num_chunks, meta[2],
                                          plan.chunk), generator=gen,
                             dtype=torch.int32, device=cuda)
        args = (plan.packed, state["subkeys_tbl"], state["cdf_tbl"], bits,
                order)
        kw = dict(slab_blocks=B, subkeys=True)
        epoch = bpr_epoch_tiled
        ib, jb, row = order[2] * B + order[1], order[3], order[8]
        cols, sample_kw = tiled_cols(order, B), dict(subkeys=True)
    else:
        plan, state, meta = BP.prepare_bpr_mxu(
            fb, uniform_user=not wbpr, shuffle_seed=1, bitmask=True,
            device=cuda)
        packed, keys, cdf, bits, order, jb, nval, bkt, _ = _bpr_epoch_args(
            plan, state, meta, None, 5, wbpr)
        args = (packed, keys, cdf, bits, order, jb, nval, bkt)
        kw = dict(bitmask_tbl=state["bitmask_tbl"]
                  if case.startswith("bitmask") else None)
        epoch = bpr_epoch
        ib, row = order[1], order[2]
        cols, sample_kw = (*order, jb, nval, bkt), dict(
            bitmask_tbl=kw["bitmask_tbl"])
    W, H = _bpr_tables(cuda, plan, fb.num_users, fb.num_items, 40, 1)
    rates = BP.bpr_mxu_column_rates(40, W.shape[1], 0.05, 0.0025, 0.0025,
                                    0.00025, 0.01, True, device=cuda)
    kw.update(user_block=plan.user_block, item_block=plan.item_block,
              soft_margin=case.endswith("soft-margin"), wbpr=wbpr,
              return_negatives=True)
    out = []

    def run():
        Wk, Hk = W.clone(), H.clone()
        _, _, neg = epoch(Wk, Hk, *args, rates, **kw)
        out.append(neg)
        return Wk, Hk, neg
    assert _equal_twice(run)
    neg, segs = sampler_tables(args[0], args[1], args[2], args[3], cols,
                               user_block=plan.user_block,
                               item_block=plan.item_block, wbpr=wbpr,
                               **sample_kw)
    assert torch.equal(neg, out[0])
    want = bpr_segments_reference(plan.packed[row.long()], neg, ib, jb,
                                  item_block=plan.item_block)
    assert torch.equal(segs, want)


@pytest.mark.parametrize("case", ["netflix-shaped", "duplicate-users-items"])
@pytest.mark.parametrize("f", list(SVDPP_ON_CHIP))
def test_svdpp_kernel_repeats_bit_for_bit(cuda, case, f):
    """Two launches of kernel 5 from the same tables and schedule give
    equal tables, at each width of ``SVDPP_ON_CHIP`` (both accumulator
    variants), on _setup-like data and on
    test_svdpp_duplicate_users_and_items_one_step's chunks (Zipf users,
    an 8-item catalog: runs of hundreds of slots in s, W, c, n, Q, Y)."""
    if case == "netflix-shaped":
        data = synthetic_ratings(num_users=2000, num_items=3000,
                                 num_ratings=100_000, seed=3)
        inputs = (data.users, data.items, data.values, 2000, 3000)
    else:
        rng = np.random.default_rng(8)
        U, I, n = 1100, 8, 12000
        inputs = ((rng.zipf(1.2, n) % U).astype(np.int32),
                  rng.integers(0, I, n).astype(np.int32),
                  rng.integers(1, 11, n).astype(np.float32) / 2, U, I)
    plan, tables = _svdpp_setup(cuda, *inputs, f=f)
    hp, rates, kw = _svdpp_args(plan, cuda, True, S.LOSS_RMSE, True, f=f,
                                lr=0.05)

    def run():
        tabs = tables(True)
        svdpp_epoch(*tabs, plan.packed, plan.schedule, hp, rates, **kw)
        return tabs
    assert _equal_twice(run)


def test_soft_margin_fits_repeat_bit_for_bit(cuda):
    """Two fits of SoftMarginRankingMF with one seed give equal tables (its
    hinge gradient is a step, where an ulp of the sum's order switched a
    slot's gradient and the runs parted)."""
    fb = posonly_from_ratings(synthetic_ratings(
        num_users=2000, num_items=3000, num_ratings=100_000, seed=0))
    fits = []
    for _ in range(2):
        model = create_item_recommender(
            "SoftMarginRankingMF", "num_factors=16 num_iter=10 device=cuda")
        model.random_seed = 3
        model.feedback = fb
        model.train()
        fits.append({k: v.clone() for k, v in model.params.items()})
    torch.cuda.synchronize()
    assert fits[0].keys() == fits[1].keys()
    assert all(torch.equal(fits[0][k], fits[1][k]) for k in fits[0])


def test_plain_routes_repeat_bit_for_bit(cuda):
    """Two runs of each plain training route (minibatch and sharded BPR,
    grouped and sharded SVD++, SocialMF, the time-aware step, BPRSLIM)
    from the same inputs give equal tables: each scatters through
    ``add_rows``, exact_add's kernel on the card."""
    from test_torch_scatter_order import ROUTES
    before = S.exact_add.launches
    for route in ROUTES:
        assert _equal_twice(lambda: route(cuda)), route.__name__
    assert S.exact_add.launches > before


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("ids64", [False, True])
def test_exact_add_kernel_equals_the_composition(cuda, ids64):
    """exact_add's kernel against its torch composition
    (``exact_add_reference``) bit for bit: 131,072 slots on 64 rows at
    width 42, the same on 1-D rows, a batch on many distinct rows, a
    batch of zeros, the first batch in float64 (the plain routes'
    witnesses), and batches with an inf and with a NaN delta (every
    touched row non-finite). Times of both and of index_add_ are
    printed."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    dt = torch.int64 if ids64 else torch.int32
    cases = []
    for rows, n, width in ((64, 131_072, 42), (64, 131_072, 1),
                           (500_000, 65_536, 42), (7, 3, 5)):
        ids = torch.randint(0, rows, (n,), device=cuda, generator=gen,
                            dtype=dt)
        delta = torch.randn((n, width), device=cuda, generator=gen)
        table = torch.randn((rows, width), device=cuda, generator=gen)
        if width == 1:
            delta, table = delta[:, 0].contiguous(), table[:, 0].contiguous()
        cases.append((table, ids, delta))
    table, ids, delta = cases[0]
    cases.append((table, ids, torch.zeros_like(delta)))
    cases.append((table.double(), ids, delta.double()))
    for bad in (math.inf, math.nan):
        d = delta.clone()
        d[17, 3] = bad
        cases.append((table, ids, d))
    before = S.exact_add.launches
    for table, ids, delta in cases:
        got = S.exact_add(table.clone(), ids, delta)
        want = S.exact_add_reference(table.clone(), ids, delta)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want))
    assert S.exact_add.launches == before + len(cases)
    table, ids, delta = cases[0]
    times = []
    for fn in (S.exact_add, S.exact_add_reference,
               lambda t, i, d: t.index_add_(0, i, d)):
        t = table.clone()
        fn(t, ids, delta)
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(20):
            fn(t, ids, delta)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / 20)
    print(f"\nexact_add 131,072 x 42 on 64 rows: kernel {times[0]:.3f} ms, "
          f"composition {times[1]:.3f} ms, index_add_ {times[2]:.3f} ms")
    assert times[0] < times[1]


def test_exact_add_takes_ids_past_int32(cuda):
    """BPRSLIM's flat view of its [I, I] table passes 2^31 entries past
    46,340 items: exact_add's kernel keeps the ids int64 and equals the
    composition bit for bit on ids on both sides of 2^31 (8.6 GB a
    table)."""
    I = 46_341
    table = torch.zeros(I * I, device=cuda)
    assert table.numel() > 2 ** 31
    gen = torch.Generator(device=cuda).manual_seed(9)
    high = torch.randint(2 ** 31 - 512, I * I, (4096,), device=cuda,
                         generator=gen)
    low = torch.randint(0, 512, (4096,), device=cuda, generator=gen)
    ids = torch.cat([high, low, high[:1024]])
    delta = torch.randn(ids.numel(), device=cuda, generator=gen)
    want = S.exact_add_reference(table.clone(), ids, delta)
    got = S.exact_add(table, ids, delta)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    assert (got[high] != 0).all()


# --- kernels 1 and 2 over a thread-block cluster with the next chunk's
# rows copied ahead: the orders of tests/test_torch_sgd_overlap.py held
# to the plain version and to a second launch, and the tables of every
# case held to digests of the tables that the one-block kernel (the
# commit before the cluster walk) gave from the same inputs

SGD_ORDERS = ["same-cell", "same-ub", "ub-boundary", "one-chunk", "epoch",
              "zipf-epoch"]
SGD_PREFIX = [(loss, biased) for biased in (True, False)
              for loss in (S.LOSS_RMSE, S.LOSS_MAE, S.LOSS_LOGISTIC)]


def _sgd_order(plan, case):
    """(ub, ib, row) int32 tensors on the plan's device: consecutive
    chunks on one cell, on one user block, across user blocks (sorted by
    block), one chunk, or an epoch's order; absolute item blocks."""
    ub, ib = plan.ub_c, plan.ib_c
    rows = np.arange(ub.size)
    if case == "same-cell":
        cells = ub.astype(np.int64) * plan.n_iblocks + ib
        sel = rows[cells == np.bincount(cells).argmax()]
    elif case == "same-ub":
        sel = rows[ub == ub[0]]
        sel = sel[np.argsort(ib[sel], kind="stable")]
    elif case == "ub-boundary":
        sel = np.lexsort((ib, ub))
    elif case == "one-chunk":
        sel = rows[:1]
    else:
        order = plan.epoch_order(7)
        sel = order[-1].cpu().numpy()
    dev = plan.packed.device
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                 for a in (ub[sel], ib[sel], sel))


def _sgd_case(device, name):
    """(plan, W, H, order, rates, hp, kw) of a named case:
    ``order-{case}-{resident|tiled}``, ``prefix-{resident|tiled}-{loss}-
    {biased|plain}`` (the first 4,096 chunks of an epoch at 48,000 x
    17,770 x 3M); the order is the wrapper's: (ub, ib, row), or on the
    tiled plans (one-block slabs) (ub, ibr, sl, row), kw with
    slab_blocks."""
    parts = name.split("-")
    tiled = "tiled" in parts
    loss, biased = S.LOSS_RMSE, True
    if parts[0] == "prefix":
        loss, biased = int(parts[2]), parts[3] == "biased"
        U, I = 48_000, 17_770
        data = synthetic_ratings(num_users=U, num_items=I,
                                 num_ratings=3_000_000, seed=1,
                                 device=device)
        users, items, values = data.users, data.items, data.values
    elif "zipf" in parts:
        users, items, values, U, I = _zipf_ratings(np.random.default_rng(0))
    else:
        U, I = 2000, 3000
        data = synthetic_ratings(num_users=U, num_items=I,
                                 num_ratings=100_000, seed=0)
        users, items, values = data.users, data.items, data.values
    prep = dict(user_block=512, item_block=1024, shuffle_seed=1,
                device=device)
    if tiled:
        plan = P.prepare_mxu_tiled(users, items, values, U, I, chunk=None,
                                   slab_blocks=1, **prep)
    else:
        plan = P.prepare_mxu_data(users, items, values, U, I, chunk=640,
                                  **prep)
    if parts[0] == "prefix":
        order = tuple(t[:4096].contiguous() for t in plan.epoch_order(5))
        assert order[0].numel() == 4096
    else:
        case = "-".join(parts[1:-1])
        order = _sgd_order(plan, "epoch" if case == "zipf-epoch" else case)
        if tiled:                  # one-block slabs: sl = ib, ibr = 0
            order = (order[0], torch.zeros_like(order[1]), order[1],
                     order[2])
    rng = np.random.default_rng(2)
    W, H = P.extend_tables_mxu(
        plan, 0.1 * rng.standard_normal((U, 40)),
        0.1 * rng.standard_normal((I, 40)),
        0.1 * rng.standard_normal(U) if biased else None,
        0.1 * rng.standard_normal(I) if biased else None)
    # BiasedMatrixFactorization's default rates: at the duplicate-heavy
    # shape's high rates (test_duplicate_heavy_spread) float32 runs that
    # sum in another order part by more than 1e-4
    rates = P.mxu_column_rates(40, W.shape[1], 0.01, 0.015, 0.015, 1.0, 0.01,
                               biased, True, True, device=device)
    hp = (0.3, 1.0, 4.0) if biased else (3.3, 1.0, 4.0)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=loss, biased=biased)
    if tiled:
        assert plan.slab_blocks == 1
        kw["slab_blocks"] = 1
    return plan, W, H, order, rates, hp, kw


def _sgd_run(case, kernel=True):
    """The case's tables after one launch of kernel 1 (``sgd_epoch``) or
    2 (``sgd_epoch_tiled``) on copies of its tables, or of the plain
    version."""
    plan, W, H, order, rates, hp, kw = case
    tiled = "slab_blocks" in kw
    fn = ((sgd_epoch_tiled if kernel else sgd_epoch_tiled_reference)
          if tiled else (sgd_epoch if kernel else sgd_epoch_reference))
    Wk, Hk = W.clone(), H.clone()
    fn(Wk, Hk, plan.packed, order, hp, rates, **kw)
    return Wk, Hk


def _sgd_mesh_run(device, tiled):
    """W shards and H partitions after one sharded epoch on a rig of the
    card named 4 times (test_sgd_sharded_matches_reference's inputs)."""
    from mymedialite_tpu_torch.ops.sgd_epoch import (
        sgd_epoch_sharded, sgd_epoch_sharded_tiled,
    )
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=4)
    args = (data.users, data.items, data.values, 2000, 3000, 4)
    plan_kw = dict(chunk=None, slab_blocks=1) if tiled else dict(chunk=640)
    plan = (P.prepare_mxu_sharded_tiled if tiled else P.prepare_mxu_sharded)(
        *args, shuffle_seed=2, device=device, **plan_kw)
    rng = np.random.default_rng(1)
    W, H = P.extend_tables_mxu(plan, 0.1 * rng.standard_normal((2000, 40)),
                               0.1 * rng.standard_normal((3000, 40)))
    mesh = _rig(device)
    Ws, Hs = mesh.shard_rows(W), mesh.shard_rows(H)
    rates = P.mxu_column_rates(40, W.shape[1], 0.01, 0.015, 0.015, 1.0, 0.01,
                               True, True, True, device=device)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=S.LOSS_RMSE, biased=True)
    order = plan.epoch_order(3)
    if tiled:
        sgd_epoch_sharded_tiled(mesh, Ws, Hs, plan.packed, order,
                                plan.cell_counts, (0.6, 1.0, 4.0), rates,
                                slab_blocks=plan.slab_blocks, **kw)
    else:
        sgd_epoch_sharded(mesh, Ws, Hs, plan.packed, order, plan.cell_counts,
                          (0.6, 1.0, 4.0), rates, **kw)
    return mesh.gather_rows(Ws), mesh.gather_rows(Hs)


def _digest(tables):
    import hashlib
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in tables:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def sgd_case_names():
    return ([f"order-{c}-{s}" for c in SGD_ORDERS
             for s in ("resident", "tiled")]
            + [f"prefix-{s}-{loss}-{'biased' if b else 'plain'}"
               for s in ("resident", "tiled") for loss, b in SGD_PREFIX]
            + ["mesh-resident", "mesh-tiled"])


def sgd_case_digest(device, name):
    if name.startswith("mesh"):
        return _digest(_sgd_mesh_run(device, name.endswith("tiled")))
    return _digest(_sgd_run(_sgd_case(device, name)))


# sgd_case_digest of each case, recorded on an H100 from `git archive` of
# the commit before the cluster walk (python3 tests/test_torch_cuda.py
# --sgd-digests with that tree's root first on PYTHONPATH)
SGD_ONE_BLOCK_SHA256 = {
    "order-same-cell-resident":
        "7d9324cbf5d159d21a3277439994996ce4afb38fee01b40ecda1b8513734b5cb",
    "order-same-cell-tiled":
        "5f067eb509e8f4d5c6276aeea11e9e894c8805c20c0c7064ea0a5c1ba0f10d70",
    "order-same-ub-resident":
        "2225232d3ab9cf2b92fdb99517d1c97caecfb1a5f7cfa69568582760544f8af7",
    "order-same-ub-tiled":
        "4db4ec4703217c423f22e93f909b27672e85e7fa7312b23c1693b1c7c5d81751",
    "order-ub-boundary-resident":
        "c9d1a644ba5955e4525b44c90afa67ad438dfa31d5fe18894f0d5c8298b91855",
    "order-ub-boundary-tiled":
        "6d73ec807832ba28ffa6663cc30e1f5ddc8784e38dbdb39b769b6c9a5554d92f",
    "order-one-chunk-resident":
        "b860d487472126c2953375484334f6b0db9344169841963a4f4a73c1ec4f4c72",
    "order-one-chunk-tiled":
        "b36f93c36b32c2e82cd4aeb1f3cd30a1e152dca3c058f2664c9bb5adba5f0929",
    "order-epoch-resident":
        "9fb64e21e00ab6cf17caf4bd2eec4734158614acccecc8c4247824f78222e498",
    "order-epoch-tiled":
        "e8b9de3ef0a5b3dc795a1da4d0d7767dd324bef728b433b93c0a9cd69812b97c",
    "order-zipf-epoch-resident":
        "da26faab08e2434717a3d8fa429039b110be4bc579679a304dc9770c9840cdee",
    "order-zipf-epoch-tiled":
        "da26faab08e2434717a3d8fa429039b110be4bc579679a304dc9770c9840cdee",
    "prefix-resident-0-biased":
        "e8eb7696c8b5a6a374586f2960d2bc7b12b876376e46a9ed32db9838d1317a1e",
    "prefix-resident-1-biased":
        "268d8e37c758f060a7cda19e3f424a343ed0c7d09c7165c766d9b255912e339d",
    "prefix-resident-2-biased":
        "a5b567f5e4dd9de317b13b452edb06bc081a063ac2beea29d46ee045251b163d",
    "prefix-resident-0-plain":
        "5bdc1e3175b03160ae7591fd94c78b8136537b960744094b897311af6aec5526",
    "prefix-resident-1-plain":
        "5bdc1e3175b03160ae7591fd94c78b8136537b960744094b897311af6aec5526",
    "prefix-resident-2-plain":
        "5bdc1e3175b03160ae7591fd94c78b8136537b960744094b897311af6aec5526",
    "prefix-tiled-0-biased":
        "5c901a4e8cb9507e7c4ce8eee34856f4d3b4732aab3d84a10b89e114101fa42c",
    "prefix-tiled-1-biased":
        "44d03716e58b778a18192343c5a6175d513583dfb213fd7e3a674d785324b6f4",
    "prefix-tiled-2-biased":
        "d556d9e5616164a3f58c24f57c3a9e0d535d2777889e9bc0e747eaff3d82ccb8",
    "prefix-tiled-0-plain":
        "f30337ecd6a869577e5fe0ec34dd2c895243341bf43e52513c3153a40a38a97b",
    "prefix-tiled-1-plain":
        "f30337ecd6a869577e5fe0ec34dd2c895243341bf43e52513c3153a40a38a97b",
    "prefix-tiled-2-plain":
        "f30337ecd6a869577e5fe0ec34dd2c895243341bf43e52513c3153a40a38a97b",
    "mesh-resident":
        "0b3366457e0c545482b5e3896f5822c21f54edf31af67c3922d9b9b06924c52d",
    "mesh-tiled":
        "50b553e0e9b6c3df5c450a8324e075e99485d420bbd2a041cf6c9198168d6067",
}


@pytest.mark.parametrize("tiled", [False, True], ids=["resident", "tiled"])
@pytest.mark.parametrize("case", SGD_ORDERS)
def test_sgd_kernels_over_orders(cuda, case, tiled):
    """Kernels 1 (resident) and 2 (tiled) over orders with consecutive
    chunks on one cell, on one user block, across user blocks, one chunk
    alone, an epoch's order and a Zipf(1.3) duplicate-heavy epoch: within
    1e-4 of the plain version, equal to a second launch bit for bit, and
    to the one-block kernel's tables."""
    name = f"order-{case}-{'tiled' if tiled else 'resident'}"
    inputs = _sgd_case(cuda, name)
    got = _sgd_run(inputs)
    again = _sgd_run(inputs)
    want = _sgd_run(inputs, kernel=False)
    torch.cuda.synchronize()
    assert max((a - b).abs().max().item() for a, b in zip(got, want)) <= 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _digest(got) == SGD_ONE_BLOCK_SHA256[name]


@pytest.mark.parametrize("tiled", [False, True], ids=["resident", "tiled"])
@pytest.mark.parametrize("loss,biased", SGD_PREFIX)
def test_sgd_prefix_equals_the_one_block_kernel(cuda, loss, biased, tiled):
    """The first 4,096 chunks of an epoch of kernel 1 (chunks of 640) and
    2 (chunks of the histogram's size) at 48,000 x 17,770 x 3M, for every
    loss, biased and plain: the one-block kernel's tables bit for bit."""
    name = (f"prefix-{'tiled' if tiled else 'resident'}-{loss}-"
            f"{'biased' if biased else 'plain'}")
    assert sgd_case_digest(cuda, name) == SGD_ONE_BLOCK_SHA256[name]


@pytest.mark.parametrize("tiled", [False, True], ids=["sharded",
                                                      "sharded-tiled"])
def test_sgd_mesh_cells_equal_the_one_block_kernel(cuda, tiled):
    """A sharded epoch on the rig (kernel 1 or 2 once a cell, each cell's
    order relative to its shard and partition): the one-block kernel's
    tables bit for bit."""
    name = f"mesh-{'tiled' if tiled else 'resident'}"
    assert sgd_case_digest(cuda, name) == SGD_ONE_BLOCK_SHA256[name]


# --- kernels 3-5 over a thread-block cluster: the tables of every case
# held to digests of the tables that the one-block kernels (the commit
# before their cluster walks) gave from the same inputs. The random bits
# are numpy's, from a seed.

BPR_PREFIX = [(sm, wbpr, form) for sm in (False, True)
              for wbpr in (False, True) for form in ("keys", "bitmask")]
BPR_TILED_PREFIX = [(sm, wbpr) for sm in (False, True)
                    for wbpr in (False, True)]


def _np_bits(nc, trials, C, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2 ** 31, (nc, trials, C),
                                         dtype=np.int32))


def _bpr_case(device, name):
    """(epoch, W, H, args, kw) of a named case: ``zipf-epoch-{resident|
    tiled}`` (test_bpr_kernels_repeat_bit_for_bit's duplicate-heavy
    chunks, one epoch), ``prefix-resident-{logistic|hinge}-{uniform|wbpr}-
    {keys|bitmask}`` and ``prefix-tiled-{logistic|hinge}-{uniform|wbpr}-
    subkeys`` (the first 4,096 chunks of an epoch at 48,000 x 17,770 x
    3M, the tiled plan's one-block slabs); bits from numpy."""
    parts = name.split("-")
    tiled = parts[2 if parts[0] == "zipf" else 1] == "tiled"
    if parts[0] == "zipf":
        rng = np.random.default_rng(0)
        U, I, n = 700, 900, 20000
        fb = PosOnlyData(rng.integers(0, U, n), rng.zipf(1.3, n) % I,
                         num_users=U, num_items=I)
        sm, wbpr, form = False, False, "subkeys" if tiled else "keys"
    else:
        fb = posonly_from_ratings(synthetic_ratings(
            num_users=48_000, num_items=17_770, num_ratings=3_000_000,
            seed=1))
        sm, wbpr, form = parts[2] == "hinge", parts[3] == "wbpr", parts[4]
    if tiled:
        plan, state, meta = BP.prepare_bpr_mxu(
            fb, uniform_user=not wbpr, shuffle_seed=4, chunk=None, kcap=128,
            subkeys=True, ksub_cap=256, bitmask=False, chunk_overhead=256,
            device=device)
        B, S_, slab_items = BP.bpr_tiled_plan(plan, state["nvalid"],
                                              slab_blocks=1)
        order = BP.bpr_tiled_epoch_order(
            plan, state["nvalid"], slab_items, slab_blocks=B, num_slabs=S_,
            num_items=meta[3], seed=7,
            block_mass=state["block_mass"] if wbpr else None)
    else:
        plan, state, meta = BP.prepare_bpr_mxu(
            fb, uniform_user=not wbpr, shuffle_seed=1, bitmask=True,
            device=device)
        order = plan.epoch_order(5)
        order = (*order, *BP.epoch_negative_plan(
            plan, state["nvalid"], order[0].cpu().numpy(), meta[3], 6,
            block_mass=state["block_mass"] if wbpr else None))
    if parts[0] == "prefix":
        order = tuple(t[:4096].contiguous() for t in order)
        assert order[0].numel() == 4096
    nc = order[0].numel()
    bits = _np_bits(nc, meta[2], plan.chunk, 11).to(device)
    W, H = _bpr_tables(device, plan, fb.num_users, fb.num_items, 40, 1)
    rates = BP.bpr_mxu_column_rates(40, W.shape[1], 0.05, 0.0025, 0.0025,
                                    0.00025, 0.01, True, device=device)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              soft_margin=sm, wbpr=wbpr)
    if tiled:
        kw.update(slab_blocks=B, subkeys=True)
        return (bpr_epoch_tiled, W, H,
                (plan.packed, state["subkeys_tbl"], state["cdf_tbl"], bits,
                 order, rates), kw)
    kw["bitmask_tbl"] = state["bitmask_tbl"] if form == "bitmask" else None
    return (bpr_epoch, W, H,
            (plan.packed, state["keys_tbl"], state["cdf_tbl"], bits,
             order[:3], *order[3:], rates), kw)


def _bpr_run(case):
    epoch, W, H, args, kw = case
    Wk, Hk = W.clone(), H.clone()
    epoch(Wk, Hk, *args, **kw)
    return Wk, Hk


def _bpr_mesh_run(device, tiled):
    """W shards and H partitions after one sharded BPR epoch on a rig of
    the card named 4 times (test_bpr_sharded_matches_reference's
    inputs)."""
    from mymedialite_tpu_torch.ops.bpr_epoch import (
        bpr_epoch_sharded, bpr_epoch_sharded_tiled,
    )
    fb = posonly_from_ratings(synthetic_ratings(
        num_users=2000, num_items=3000, num_ratings=100_000, seed=5))
    mesh = _rig(device)
    if tiled:
        plan, state, meta = BP.prepare_bpr_mxu_sharded_tiled(
            fb, 4, uniform_user=True, slab_blocks=1, shuffle_seed=2,
            device=device)
        order = BP.bpr_sharded_tiled_epoch_order(plan, state["nvalid"], 3)
    else:
        plan, state, meta = BP.prepare_bpr_mxu_sharded(
            fb, 4, uniform_user=True, shuffle_seed=2, device=device)
        order = BP.bpr_sharded_epoch_order(plan, state["nvalid"], 3)
    bits = _np_bits(16 * plan.nc_pad, meta[2], plan.chunk, 6).view(
        4, 4, plan.nc_pad, meta[2], plan.chunk).to(device)
    W, H = _bpr_tables(device, plan, fb.num_users, fb.num_items, 40, 1)
    Ws, Hs = mesh.shard_rows(W), mesh.shard_rows(H)
    rates = BP.bpr_mxu_column_rates(40, 64, 0.05, 0.0025, 0.0025, 0.00025,
                                    0.0, True, device=device)
    kw = dict(part_blocks=plan.part_blocks, user_block=plan.user_block,
              item_block=plan.item_block)
    if tiled:
        bpr_epoch_sharded_tiled(mesh, Ws, Hs, plan.packed,
                                state["subkeys_tbl"], state["cdf_tbl"], bits,
                                order, plan.cell_counts, rates,
                                slab_blocks=plan.slab_blocks, **kw)
    else:
        bpr_epoch_sharded(mesh, Ws, Hs, plan.packed, state["keys_tbl"],
                          state["cdf_tbl"], bits, order, plan.cell_counts,
                          rates, bitmask_tbl=state.get("bitmask_tbl"), **kw)
    return mesh.gather_rows(Ws), mesh.gather_rows(Hs)


def bpr_case_names():
    fm = {False: "uniform", True: "wbpr"}
    return (["zipf-epoch-resident", "zipf-epoch-tiled"]
            + [f"prefix-resident-{'hinge' if sm else 'logistic'}-{fm[w]}-"
               f"{form}" for sm, w, form in BPR_PREFIX]
            + [f"prefix-tiled-{'hinge' if sm else 'logistic'}-{fm[w]}-subkeys"
               for sm, w in BPR_TILED_PREFIX]
            + ["mesh-resident", "mesh-tiled"])


def bpr_case_digest(device, name):
    if name.startswith("mesh"):
        return _digest(_bpr_mesh_run(device, name.endswith("tiled")))
    return _digest(_bpr_run(_bpr_case(device, name)))


# (label, sigmoid, loss, use_p): SVDPlusPlus, SigmoidSVDPlusPlus with the
# RMSE and the MAE loss, and the asymmetric factor models (no p)
SVDPP_DIGEST_VARIANTS = (("plain", False, S.LOSS_RMSE, True),
                         ("sigmoid-rmse", True, S.LOSS_RMSE, True),
                         ("sigmoid-mae", True, S.LOSS_MAE, True),
                         ("no-p", True, S.LOSS_RMSE, False))
# the widths and, for each, the accumulator variants a launch can take
SVDPP_DIGEST_WIDTHS = ((20, ("shared", "global")), (50, ("shared", "global")),
                       (100, ("global",)))


def _svdpp_case(device, name):
    """(tables, packed, schedule, hp, rates, kw, variant) of a named case:
    ``zipf-epoch-k{20|100}`` (test_svdpp_kernel_repeats_bit_for_bit's
    duplicate-users-items chunks, one epoch, the wrapper's variant) and
    ``prefix-{variant}-k{f}-{shared|global}`` (the steps of the first 64
    user blocks of an epoch at 48,000 x 17,770 x 2M, the accumulator
    variant forced)."""
    parts = name.split("-")
    f = int(parts[-2 if parts[0] == "prefix" else -1][1:])
    if parts[0] == "zipf":
        rng = np.random.default_rng(8)
        U, I, n = 1100, 8, 12000
        inputs = ((rng.zipf(1.2, n) % U).astype(np.int32),
                  rng.integers(0, I, n).astype(np.int32),
                  rng.integers(1, 11, n).astype(np.float32) / 2, U, I)
        label, variant = "sigmoid-rmse", None
    else:
        U, I = 48_000, 17_770
        data = synthetic_ratings(num_users=U, num_items=I,
                                 num_ratings=2_000_000, seed=1)
        inputs = (data.users, data.items, data.values, U, I)
        label, variant = "-".join(parts[1:-2]), parts[-1]
    _, sigmoid, loss, use_p = next(v for v in SVDPP_DIGEST_VARIANTS
                                   if v[0] == label)
    plan, tables = _svdpp_setup(device, *inputs, f=f, seed=2)
    hp, rates, kw = _svdpp_args(plan, device, sigmoid, loss, use_p, f=f,
                                lr=0.01)
    schedule = plan.schedule
    if parts[0] == "prefix":
        end = _block_slices(plan)[63][1]
        schedule = tuple(t[:end].contiguous() for t in schedule)
    return tables(use_p), plan.packed, schedule, hp, rates, kw, variant


def _svdpp_run(case):
    tabs, packed, schedule, hp, rates, kw, variant = case
    out = tuple(t.clone() for t in tabs)
    real = SE.accumulator_variant
    if variant is not None:
        SE.accumulator_variant = lambda *a, **k: variant
    try:
        svdpp_epoch(*out, packed, schedule, hp, rates, **kw)
    finally:
        SE.accumulator_variant = real
    return out


def svdpp_case_names():
    return (["zipf-epoch-k20", "zipf-epoch-k100"]
            + [f"prefix-{label}-k{f}-{v}" for label, *_ in
               SVDPP_DIGEST_VARIANTS for f, vs in SVDPP_DIGEST_WIDTHS
               for v in vs])


def svdpp_case_digest(device, name):
    return _digest(_svdpp_run(_svdpp_case(device, name)))


# bpr_case_digest and svdpp_case_digest of each case, recorded on an H100
# from `git archive` of the commit before the cluster walks of kernels 3-5
# (python3 tests/test_torch_cuda.py --bpr-digests / --svdpp-digests with
# that tree's root first on PYTHONPATH)
BPR_ONE_BLOCK_SHA256 = {
    "zipf-epoch-resident":
        "c4907cd2180cc444db10ee3fea4b0931887b894d4d258a661ab179c0d665e5dc",
    "zipf-epoch-tiled":
        "ffffc975fb0692f3cbe387daf89622a520f9e87ff1cf2309af12bda47c69aa95",
    "prefix-resident-logistic-uniform-keys":
        "fd5715a5687110fe25922b4842867a1de7816086f11b807e42f03dbba05b1243",
    "prefix-resident-logistic-uniform-bitmask":
        "fd5715a5687110fe25922b4842867a1de7816086f11b807e42f03dbba05b1243",
    "prefix-resident-logistic-wbpr-keys":
        "a7f3cc7ef258413356026ce17fab250d4473ebb18f42bcdaf395ea4e8a077b58",
    "prefix-resident-logistic-wbpr-bitmask":
        "a7f3cc7ef258413356026ce17fab250d4473ebb18f42bcdaf395ea4e8a077b58",
    "prefix-resident-hinge-uniform-keys":
        "292ed5404ffe2559a30a76c1c65eb9f89a2c36f59a5f506b60b4efc559383360",
    "prefix-resident-hinge-uniform-bitmask":
        "292ed5404ffe2559a30a76c1c65eb9f89a2c36f59a5f506b60b4efc559383360",
    "prefix-resident-hinge-wbpr-keys":
        "3b669e6c141939d89aefabfb1e0b3c6f51a1fc4ff83a0542b57461178e72239d",
    "prefix-resident-hinge-wbpr-bitmask":
        "3b669e6c141939d89aefabfb1e0b3c6f51a1fc4ff83a0542b57461178e72239d",
    "prefix-tiled-logistic-uniform-subkeys":
        "811c1c25724a53a88a0af3c2969a81734e3c5103137efb150e79e921bbe42c66",
    "prefix-tiled-logistic-wbpr-subkeys":
        "02180b4f2e89d1637dee5aa112f5eb65044660f3d7bea34f6c757957a83a2571",
    "prefix-tiled-hinge-uniform-subkeys":
        "793858473c98fa1f844fc2eb92eaf199f5691c8b0e163c47a90807cb623824d5",
    "prefix-tiled-hinge-wbpr-subkeys":
        "aa845bf3a6a4defd893fd3ab91e161676b8dd2615884ff355d4b37b1ca871b9c",
    "mesh-resident":
        "338d95ea1b3fd2ef1adc0ee795e121154763bd8bea96da9f62197b0c68e0efb2",
    "mesh-tiled":
        "34be15204f45b17f6c15538dd0b67b4247ea88c31656962ae38022a1f7bc0b00",
}
SVDPP_ONE_BLOCK_SHA256 = {
    "zipf-epoch-k20":
        "9b7d646af9d4ba3339aa729eca68dec728c215eac1ee87d914edf70cd4e4fd11",
    "zipf-epoch-k100":
        "366897f83db521de251cd1d062ae262d39cd8f5dafcab72111a8577bae92e18d",
    "prefix-plain-k20-shared":
        "9431d49f69e604b44830d4498b632773c01f6f672db0942fc50b7a6383f7d873",
    "prefix-plain-k20-global":
        "9431d49f69e604b44830d4498b632773c01f6f672db0942fc50b7a6383f7d873",
    "prefix-plain-k50-shared":
        "7da06175fa3661a8fb104ea6003e615a0b5030581ecb9567b635d0297038816e",
    "prefix-plain-k50-global":
        "7da06175fa3661a8fb104ea6003e615a0b5030581ecb9567b635d0297038816e",
    "prefix-plain-k100-global":
        "a5ba4ba9463631a1ff883cf16d328ea61780ad7442684fc9610866e4ad318eb5",
    "prefix-sigmoid-rmse-k20-shared":
        "3da7fa8943de98dba6d59bdc063cb96732c42fa07ab42b764645bd73b5384449",
    "prefix-sigmoid-rmse-k20-global":
        "3da7fa8943de98dba6d59bdc063cb96732c42fa07ab42b764645bd73b5384449",
    "prefix-sigmoid-rmse-k50-shared":
        "87391d4cc0f32dd8a3901c986af21b08f95a877f4fefba4e1a682ba2dbbda544",
    "prefix-sigmoid-rmse-k50-global":
        "87391d4cc0f32dd8a3901c986af21b08f95a877f4fefba4e1a682ba2dbbda544",
    "prefix-sigmoid-rmse-k100-global":
        "3338389e16f614e2a9cc8265995d8c832976a753b84b7bf639398595fd9ac0da",
    "prefix-sigmoid-mae-k20-shared":
        "0bab73a326e6d23e95bf0f5c94b25825c718b9340a45ce98d8bd1de274de6d59",
    "prefix-sigmoid-mae-k20-global":
        "0bab73a326e6d23e95bf0f5c94b25825c718b9340a45ce98d8bd1de274de6d59",
    "prefix-sigmoid-mae-k50-shared":
        "4c6f362b817aa1f98d0df12717f392d767ab9fd88c66f351fdbf73c8d5615be8",
    "prefix-sigmoid-mae-k50-global":
        "4c6f362b817aa1f98d0df12717f392d767ab9fd88c66f351fdbf73c8d5615be8",
    "prefix-sigmoid-mae-k100-global":
        "d8607f5c3fe39eb7f2b61be5096a36a52ef1e82bd433a7b11cbcc8d8bbaf710b",
    "prefix-no-p-k20-shared":
        "4aa1e5440a3b28c44f9306b2d1c0c32233f8f5ee71b6379f65282b81f14bec93",
    "prefix-no-p-k20-global":
        "4aa1e5440a3b28c44f9306b2d1c0c32233f8f5ee71b6379f65282b81f14bec93",
    "prefix-no-p-k50-shared":
        "89b8d16383ac86a8c332dc2b9ab3e698c9f4485dba0d574da546f79fc1fb1a8b",
    "prefix-no-p-k50-global":
        "89b8d16383ac86a8c332dc2b9ab3e698c9f4485dba0d574da546f79fc1fb1a8b",
    "prefix-no-p-k100-global":
        "721634b02decf7396383dcb478ad3f9aa149451ca63964093650e4b8f7411361",
}


@pytest.mark.parametrize("tiled", [False, True], ids=["resident", "tiled"])
def test_bpr_kernels_over_zipf_orders(cuda, tiled):
    """Kernel 3 (keys) and 4 (sub-bucketed keys) over an epoch of
    test_bpr_kernels_repeat_bit_for_bit's duplicate-heavy chunks (a
    Zipf(1.3) catalog): equal to a second launch bit for bit, and to the
    one-block kernel's tables."""
    name = f"zipf-epoch-{'tiled' if tiled else 'resident'}"
    case = _bpr_case(cuda, name)
    got, again = _bpr_run(case), _bpr_run(case)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _digest(got) == BPR_ONE_BLOCK_SHA256[name]


@pytest.mark.parametrize("name", [n for n in bpr_case_names()
                                  if n.startswith("prefix")])
def test_bpr_prefix_equals_the_one_block_kernel(cuda, name):
    """The first 4,096 chunks of an epoch of kernel 3 (chunks of 640) and
    4 (one-block slabs) at 48,000 x 17,770 x 3M, for each loss (logistic,
    hinge), sampler (uniform, WBPR) and membership form (keys, bitmask;
    sub-bucketed keys on the tiled schedule): the one-block kernel's
    tables bit for bit."""
    assert bpr_case_digest(cuda, name) == BPR_ONE_BLOCK_SHA256[name]


@pytest.mark.parametrize("tiled", [False, True], ids=["sharded",
                                                      "sharded-tiled"])
def test_bpr_mesh_cells_equal_the_one_block_kernel(cuda, tiled):
    """A sharded BPR epoch on the rig (kernel 3 or 4 once a cell): the
    one-block kernel's tables bit for bit."""
    name = f"mesh-{'tiled' if tiled else 'resident'}"
    assert bpr_case_digest(cuda, name) == BPR_ONE_BLOCK_SHA256[name]


@pytest.mark.parametrize("name", svdpp_case_names())
def test_svdpp_equals_the_one_block_kernel(cuda, name):
    """Kernel 5 over an epoch of test_svdpp_kernel_repeats_bit_for_bit's
    duplicate users and items (k = 20, 100), and over the steps of the
    first 64 user blocks at 48,000 x 17,770 x 2M for each variant (plain,
    sigmoid RMSE and MAE, no p) and width (20, 50, 100 factors), with the
    sums read on chip and through L2 wherever a launch takes them: the
    one-block kernel's tables bit for bit, and a second launch's."""
    case = _svdpp_case(cuda, name)
    got = _svdpp_run(case)
    again = _svdpp_run(case)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _digest(got) == SVDPP_ONE_BLOCK_SHA256[name]


DIGESTS = {"--sgd-digests": (sgd_case_names, sgd_case_digest),
           "--bpr-digests": (bpr_case_names, bpr_case_digest),
           "--svdpp-digests": (svdpp_case_names, svdpp_case_digest)}


if __name__ == "__main__":
    import json
    import sys
    if len(sys.argv) != 2 or sys.argv[1] not in DIGESTS:
        sys.exit("usage: python3 tests/test_torch_cuda.py "
                 f"{'|'.join(DIGESTS)}")
    dev = torch.device("cuda")
    names, digest = DIGESTS[sys.argv[1]]
    print(json.dumps({name: digest(dev, name) for name in names()},
                     indent=1))
