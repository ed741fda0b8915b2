"""The port's default mesh against the JAX package's: with more than one
device visible, a model trains, and the ranking eval runs, on a mesh of
all of them.

The JAX side runs its own default on the suite's 8 virtual CPU devices
(``tests/conftest.py``): no patch of its mesh, so ``len(jax.devices()) >
1`` makes its mesh at each of its sites. The port's resolver
(``parallel/mesh.py default_mesh``, the one place that reads the device
count) is pointed at ``["cpu"] * 8`` with ``default_devices``, and the
port's models keep ``mesh`` at its default. Inputs come from numpy seeds;
where threefry draws on the JAX side (initial tables, BPR bits and
triples), the draws are passed to the port. Tolerances: WRMF's tables
1e-6 (relative to the table's largest entry, as WRMF's own mesh test
holds them), SVDPlusPlus after 2 epochs on the sharded grouped epoch
1e-5, MultiCoreBPRMF's sharded minibatch epoch 1e-5, the ranking eval's
ranks exact and measures 1e-6 (BPRMF and LeastSquareSLIM; ItemKNN and
MostPopular stay on one device), BiasedMatrixFactorization and BPRMF on
"sharded" and "sharded-tiled" under ``MML_MXU=sharded-interpret`` 1e-5
with the BPR negatives identical.

Also: one device, or ``mesh = None``, keeps every one-device route; a
clone, a deep copy or a pickle keeps the default; the resolved mesh is
one object, so WRMF lays its histories out once; across processes the
default is the global mesh over each process's devices (the resolver
with the process group and the card count patched here;
``tests/test_torch_distributed_routes.py`` trains on it under two gloo
processes); ``MML_MXU=0`` chooses the JAX package's routes.
"""

import copy
import logging
import pickle

import jax
import numpy as np
import pytest
import torch

from mymedialite_tpu.data.arrays import PosOnlyData as JPosOnly
from mymedialite_tpu.data.arrays import RatingData as JRating
from mymedialite_tpu.data.synthetic import split_posonly, synthetic_posonly
from mymedialite_tpu.eval import ranking as jranking
from mymedialite_tpu.models import bpr as jbpr
from mymedialite_tpu.models import item_baselines as jbase
from mymedialite_tpu.models import mf as jmf
from mymedialite_tpu.models import slim as jslim
from mymedialite_tpu.models import svdpp as jsv
from mymedialite_tpu.models.wrmf import WRMF as JaxWRMF
from mymedialite_tpu.ops import kernel_select
from mymedialite_tpu.ops import pallas_bpr as pb
from mymedialite_tpu.ops import pallas_sgd as ps
from mymedialite_tpu.utils.params import configure
from mymedialite_tpu_torch.convert import (
    bpr_tables_from_jax, slim_state_from_jax, svdpp_tables_from_jax,
    tables_from_jax, wrmf_tables_from_jax,
)
from mymedialite_tpu_torch.data.arrays import PosOnlyData, RatingData
from mymedialite_tpu_torch.eval import ranking as tranking
from mymedialite_tpu_torch.eval.crossval import clone_recommender
from mymedialite_tpu_torch.models import bpr as tbpr
from mymedialite_tpu_torch.models import wrmf as twrmf
from mymedialite_tpu_torch.models.registry import (
    create_item_recommender, create_rating_predictor,
)
from mymedialite_tpu_torch.ops import plan as tplan
from mymedialite_tpu_torch.parallel import mesh as tmesh
from mymedialite_tpu_torch.parallel.mesh import (
    DEFAULT_MESH, default_devices, default_mesh, make_mesh, model_mesh,
)
from test_torch_mesh_bpr import feedback, shared_sharded_runs  # noqa: F401
from test_torch_sharded import assert_same_negatives
from torch_threads import one_torch_thread  # noqa: F401

D = 8
RIG = ["cpu"] * D
MEASURES = ("AUC", "MAP", "NDCG", "MRR", "prec@5", "prec@10", "recall@5",
            "recall@10")


@pytest.fixture
def rig():
    """The port's default pointed at 8 CPU "devices", the JAX suite's."""
    assert len(jax.devices()) == D
    with default_devices(RIG):
        yield


@pytest.fixture(scope="module")
def item_data():
    fb = synthetic_posonly(num_users=300, num_items=400, num_events=6000,
                           seed=5)
    return split_posonly(fb, seed=6)


def port_posonly(p):
    return PosOnlyData(np.asarray(p.users), np.asarray(p.items),
                       num_users=p.num_users, num_items=p.num_items)


# --- the resolver ---

def test_resolver_spans_every_visible_card(monkeypatch):
    """Several cards: a mesh of all of them for a model on the default
    card, the same object at every call; none for another card, the CPU,
    or one card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mesh = default_mesh("cuda")
    assert [str(d) for d in mesh.devices] == ["cuda:0", "cuda:1", "cuda:2"]
    assert default_mesh("cuda:0") is mesh
    assert default_mesh("cuda:1") is None and default_mesh("cpu") is None

    class M:
        device = "cuda"
        mesh = DEFAULT_MESH
    assert model_mesh(M()) is mesh
    M.mesh = None
    assert model_mesh(M()) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    M.mesh = DEFAULT_MESH
    assert default_mesh("cuda") is None and model_mesh(M()) is None


@pytest.mark.parametrize("rank", [0, 1])
def test_resolver_across_processes(monkeypatch, rank):
    """Process ``rank`` of 2, no devices pointed at: the global mesh over
    the process's own devices, its half of the host's 4 cards for a
    model on a card, its one device for a model on the CPU (the JAX
    default after ``initialize_distributed()``); a model off the first
    of them raises instead of training its own copy."""
    monkeypatch.setattr(tmesh, "_processes", lambda: (rank, 2))
    monkeypatch.setattr(tmesh, "_DEFAULT_MESHES", {})
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2 * rank)
    mesh = default_mesh("cuda")
    assert [str(d) for d in mesh.devices] == [f"cuda:{2 * rank}",
                                              f"cuda:{2 * rank + 1}"]
    assert (mesh.process_index, mesh.process_count, mesh.global_size) == \
        (rank, 2, 4)
    assert default_mesh(f"cuda:{2 * rank}") is mesh
    with pytest.raises(ValueError, match="mesh devices start at"):
        default_mesh(f"cuda:{2 * rank + 1}")
    cpu = default_mesh("cpu")
    assert cpu.devices == (torch.device("cpu"),)
    assert (cpu.process_index, cpu.global_size) == (rank, 2)

    class M:
        device = "cpu"
        mesh = DEFAULT_MESH
    assert model_mesh(M()) is cpu
    with default_devices(RIG[:2]):
        rig2 = default_mesh("cpu")
        assert rig2.devices == (torch.device("cpu"),) * 2
        assert rig2.global_size == 4


def test_resolver_pointed_at_a_rig(svdpp_data):
    """The default resolves when a model plans, not when it is built: a
    model built before the default spans the rig trains on it."""
    _, tr = svdpp_data
    m = create_rating_predictor("BiasedMatrixFactorization",
                                "num_factors=4 device=cpu")
    with default_devices(RIG):
        mesh = default_mesh("cpu")
        assert mesh.devices == tuple(torch.device(d) for d in RIG)
        assert default_mesh("cpu") is mesh
        m.ratings = tr
        m.init_model()
        assert m._route() == "sharded" and m._mesh is mesh
    assert default_mesh("cpu") is None
    with default_devices(["cpu"]):
        assert default_mesh("cpu") is None


# --- WRMF ---

def test_wrmf_default_matches_jax(item_data, rig):
    train, _ = item_data
    j = JaxWRMF()
    j.num_factors, j.num_iter = 8, 2
    j.feedback = train
    j.init_model()
    assert j._mesh.devices.size == D        # JAX's own default
    t = create_item_recommender("WRMF", "num_factors=8 num_iter=2 "
                                "solve_chunk=64 device=cpu")
    assert t.mesh is DEFAULT_MESH
    t.feedback = port_posonly(train)
    t.init_model(tables=wrmf_tables_from_jax(j))
    assert t._hist_mesh.size == D
    for rows, hist, lens, chunk in t._user_hist + t._item_hist:
        assert isinstance(hist, list) and len(hist) == D
    for _ in range(2):
        j.iterate()
        t.iterate()
    for side in ("user_factors", "item_factors"):
        b = np.asarray(j.params[side], np.float64)
        err = np.abs(t.params[side].numpy() - b).max() / np.abs(b).max()
        assert err <= 1e-6, (side, err)


def test_wrmf_lays_its_histories_out_once(item_data, rig, monkeypatch):
    """The resolved mesh is one object across ``iterate()`` calls, so
    WRMF's identity check keeps its histories."""
    train, _ = item_data
    built = []
    real = twrmf.WRMF._build_histories
    monkeypatch.setattr(twrmf.WRMF, "_build_histories",
                        lambda self: built.append(1) or real(self))
    t = create_item_recommender("WRMF", "num_factors=4 num_iter=3 "
                                "device=cpu")
    t.feedback = port_posonly(train)
    t.train()
    t.iterate()
    assert len(built) == 1 and t._hist_mesh is model_mesh(t)


# --- SVD++ ---

@pytest.fixture(scope="module")
def svdpp_data():
    rng = np.random.default_rng(11)
    U, I, N = 150, 100, 6000
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    v = rng.integers(1, 6, N).astype(np.float32)
    return (JRating(u, i, v, num_users=U, num_items=I),
            RatingData(u, i, v, num_users=U, num_items=I))


@pytest.mark.parametrize("name", ["SVDPlusPlus",
                                  "SigmoidItemAsymmetricFactorModel"])
def test_svdpp_default_matches_jax(svdpp_data, rig, name):
    """Two epochs of the sharded grouped epoch, JAX's default mesh
    (``_setup_mesh``) against the port's, ``group_users`` set so that a
    step stays within the y step's bound."""
    jr, tr = svdpp_data
    opts = dict(num_factors=6, num_iter=2, group_users=16, learn_rate=0.005)
    j = getattr(jsv, name)()
    for k, val in opts.items():
        setattr(j, k, val)
    j.ratings = jr
    j.init_model()
    assert j._mesh.devices.size == D
    t = create_rating_predictor(
        name, " ".join(f"{k}={v}" for k, v in opts.items()) + " device=cpu")
    t.ratings = tr
    t.init_model(tables=svdpp_tables_from_jax(j))
    assert t.route() == "sharded" and t._shards[0].size == D
    for _ in range(2):
        j.iterate()
        t.iterate()
    for k in ("user_bias", "item_bias", "item_factors", "y") + (
            ("p",) if t.USE_P else ()):
        want = np.asarray(j.params[k])[:t.params[k].shape[0]]
        np.testing.assert_allclose(t.params[k].numpy(), want, rtol=0,
                                   atol=1e-5, err_msg=k)


def test_svdpp_default_warns_past_the_y_step_bound(svdpp_data, rig, caplog):
    """The automatic group size on the default mesh: the model warns, as
    on a mesh set by hand."""
    _, tr = svdpp_data
    t = create_rating_predictor("SVDPlusPlus", "num_factors=4 num_iter=1 "
                                "learn_rate=0.01 device=cpu")
    t.ratings = tr
    with caplog.at_level(logging.WARNING, logger="mymedialite_tpu_torch"):
        assert t.route() == "sharded"
    assert any("may diverge" in r.message and f"merges {D} groups"
               in r.message for r in caplog.records)


# --- MultiCoreBPRMF past the sharded-tiled bound ---

@pytest.mark.parametrize("opts", ["", "uniform_user_sampling=false"])
def test_multicore_default_matches_jax(feedback, shared_sharded_runs,  # noqa: F811
                                       monkeypatch, rig, opts):
    """The sharded minibatch epoch on both defaults, the JAX triples fed
    to the port's steps (``test_torch_mesh_bpr.shared_sharded_runs``)."""
    monkeypatch.setattr(tplan, "RESIDENT_ITEM_TABLE_BYTES", 64)
    jf, tf = feedback
    o = f"num_factors=6 num_iter=2 batch_size=128 {opts}"
    jm = jbpr.MultiCoreBPRMF()
    configure(jm, o)
    tm = create_item_recommender("MultiCoreBPRMF", o + " device=cpu")
    jm.feedback, tm.feedback = jf, tf
    jm.train()
    tm.train()
    assert jm._mesh.devices.size == D
    assert tm._sharded is not None and tm._sharded[0].size == D
    for k in ("user_factors", "item_factors", "item_bias"):
        np.testing.assert_allclose(tm.params[k].numpy(),
                                   np.asarray(jm.params[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


# --- the ranking eval ---

def recorded_ranks(monkeypatch, module):
    """The rank rows (each row's first m, sorted) that ``module``'s
    evaluate_items hands ``_measures_batch``."""
    rows = []
    real = module._measures_batch

    def record(ranks, m_arr, n_cand_arr, n, sums):
        r = np.sort(np.asarray(ranks), axis=1)
        rows.extend(tuple(r[k, :m].tolist()) for k, m in
                    enumerate(np.asarray(m_arr)))
        return real(ranks, m_arr, n_cand_arr, n, sums)
    monkeypatch.setattr(module, "_measures_batch", record)
    return rows


def mesh_parts(monkeypatch):
    """The users each call of the port's data-parallel rank step takes."""
    calls = []
    real = tranking._ranks_on_mesh
    monkeypatch.setattr(tranking, "_ranks_on_mesh",
                        lambda mesh, *a: calls.append(mesh.size)
                        or real(mesh, *a))
    return calls


def jax_and_port(name, jtrain):
    j = getattr(jbpr if name == "BPRMF" else jslim, name)()
    if name == "BPRMF":
        configure(j, "num_factors=8 num_iter=2")
    else:
        configure(j, "num_iter=2")
    j.feedback = jtrain
    j.train()
    t = create_item_recommender(name, "device=cpu")
    t.feedback = port_posonly(jtrain)
    t.init_model(tables=(bpr_tables_from_jax(j) if name == "BPRMF"
                         else slim_state_from_jax(j)))
    return j, t


@pytest.mark.parametrize("name", ["BPRMF", "LeastSquareSLIM"])
def test_eval_default_matches_jax(item_data, monkeypatch, rig, name):
    """JAX's eval shards over its 8 devices; the port's over the default
    mesh, one part a device, with the same ranks and measures."""
    train, test = item_data
    j, t = jax_and_port(name, train)
    assert not hasattr(t, "mesh") or t.mesh is DEFAULT_MESH
    jranks = recorded_ranks(monkeypatch, jranking)
    want = jranking.evaluate_items(j, test, train)
    tranks = recorded_ranks(monkeypatch, tranking)
    parts = mesh_parts(monkeypatch)
    ptest, ptrain = port_posonly(test), port_posonly(train)
    got = tranking.evaluate_items(t, ptest, ptrain)
    assert parts == [D]
    assert tranks == jranks and len(tranks) == got["num_users"] > 0
    for k in MEASURES:
        assert abs(got[k] - float(want[k])) <= 1e-6, k
    assert got["num_users"] == want["num_users"]


@pytest.mark.parametrize("name", ["ItemKNN", "MostPopular"])
def test_eval_of_host_scored_models_stays_on_one_device(item_data,
                                                        monkeypatch, rig,
                                                        name):
    """Models whose JAX counterparts score on the host have no default
    mesh: one device, the JAX package's numbers."""
    train, test = item_data
    parts = mesh_parts(monkeypatch)
    t = create_item_recommender(name, "device=cpu" if name == "ItemKNN"
                                else "")
    assert not hasattr(t, "mesh") and model_mesh(t) is None
    t.feedback = port_posonly(train)
    t.train()
    got = tranking.evaluate_items(t, port_posonly(test), port_posonly(train))
    assert parts == []
    if name == "MostPopular":
        j = jbase.MostPopular()
        j.feedback = train
        j.train()
        want = jranking.evaluate_items(j, test, train)
        for k in MEASURES:
            assert abs(got[k] - float(want[k])) <= 1e-6, k
    assert got["num_users"] > 0


# --- BiasedMF and BPRMF on the sharded kernel routes ---

def mf_ratings(num_items: int):
    rng = np.random.default_rng(7)
    U, n = 300, 5000
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, num_items, n).astype(np.int32)
    v = rng.integers(1, 6, n).astype(np.float32)
    return (JRating(u, i, v, num_users=U, num_items=num_items),
            RatingData(u, i, v, num_users=U, num_items=num_items))


def item_feedback(num_items: int):
    rng = np.random.default_rng(9)
    U, n = 300, 5000
    key = np.unique(rng.integers(0, U, n) * num_items
                    + rng.integers(0, num_items, n))
    u = (key // num_items).astype(np.int32)
    i = (key % num_items).astype(np.int32)
    return (JPosOnly(u, i, num_users=U, num_items=num_items),
            PosOnlyData(u, i, num_users=U, num_items=num_items))


# the catalogs of each route on 8 devices: 3 item blocks keep one block a
# partition (sharded); 9 make two, past a resident bound of one block,
# streamed as one-block slabs (sharded-tiled)
ROUTES = {"sharded": 3_000, "sharded-tiled": 9_000}


def route_budgets(mp, route):
    """The bounds of both packages: the defaults for "sharded", one item
    block (k=8, 64 columns) resident and a slab for "sharded-tiled"."""
    if route == "sharded-tiled":
        for mod, name in ((ps, "VMEM_ITEM_TABLE_BYTES"),
                          (ps, "TILED_SLAB_BYTES"),
                          (tplan, "RESIDENT_ITEM_TABLE_BYTES"),
                          (tplan, "TILED_SLAB_BYTES")):
            mp.setattr(mod, name, 1024 * 64 * 4)


@pytest.mark.parametrize("route", list(ROUTES))
def test_biasedmf_default_matches_jax(monkeypatch, rig, route):
    monkeypatch.setenv("MML_MXU", "sharded-interpret")
    route_budgets(monkeypatch, route)
    jtrain, train = mf_ratings(ROUTES[route])
    jm = jmf.BiasedMatrixFactorization()
    configure(jm, "num_factors=8 mxu_dtype=f32")
    jm.ratings = jtrain
    jm.init_model()
    assert jm._mxu_mode() == route + "-interpret"
    assert jm._mxu_mesh.devices.size == D
    tm = create_rating_predictor("BiasedMatrixFactorization",
                                 "num_factors=8 device=cpu")
    tm.ratings = train
    tm.init_model(tables=tables_from_jax(jm))
    assert tm._route() == route and tm._mesh.size == D
    for _ in range(2):
        jm.iterate()
        tm.iterate()
    np.testing.assert_allclose(tm.W_ext.numpy(), np.asarray(jm.W_ext),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.H_ext.numpy(), np.asarray(jm.H_ext),
                               rtol=0, atol=1e-5)


def jax_cell_bits(model):
    """The port's ``_cell_bits`` drawn as the JAX model draws its epoch's
    bits, ``[D, D, nc_pad, trials, C]`` cut to each cell's chunks."""
    def bits(seed, trials):
        plan = model._plan
        key = jax.random.key(seed & 0x7FFFFFFF, impl="unsafe_rbg")
        b = np.asarray(pb.epoch_random_bits(
            key, nc=D * D * plan.nc_pad, trials=trials,
            C=plan.chunk)).reshape(D, D, plan.nc_pad, trials, plan.chunk)
        return [[torch.from_numpy(b[g, k, :n].copy()) for k, n in
                 enumerate(plan.cell_counts[g])] for g in range(D)]
    return bits


def recorded_negatives(mp, route):
    """Each epoch's negatives: JAX's ``[D, D, nc_pad, 2, C]`` and the
    port's per cell, recorded around the epochs the models call."""
    jnegs, tnegs = [], []
    tiled = route == "sharded-tiled"
    jname = ("bpr_epoch_mxu_sharded_tiled_jit" if tiled
             else "bpr_epoch_mxu_sharded_jit")
    tname = "bpr_epoch_sharded_tiled" if tiled else "bpr_epoch_sharded"
    jreal, treal = getattr(pb, jname), getattr(tbpr, tname)

    def jrec(*a, **kw):
        out = jreal(*a, **kw)
        jnegs.append(np.asarray(out[2]))
        return out

    def trec(*a, **kw):
        out = treal(*a, return_negatives=True, **kw)
        tnegs.append(out[2])
        return out
    mp.setattr(pb, jname, jrec)
    mp.setattr(tbpr, tname, trec)
    return jnegs, tnegs


@pytest.mark.parametrize("route", list(ROUTES))
def test_bprmf_default_matches_jax(monkeypatch, rig, route):
    monkeypatch.setenv("MML_MXU", "sharded-interpret")
    route_budgets(monkeypatch, route)
    jtrain, train = item_feedback(ROUTES[route])
    jm = jbpr.BPRMF()
    configure(jm, "num_factors=8 mxu_dtype=f32")
    jm.feedback = jtrain
    jm.init_model()
    assert jm._mxu_mode() == route + "-interpret"
    tm = create_item_recommender("BPRMF", "num_factors=8 device=cpu")
    tm.feedback = train
    tm.init_model(tables=bpr_tables_from_jax(jm))
    tm._cell_bits = jax_cell_bits(tm)
    jnegs, tnegs = recorded_negatives(monkeypatch, route)
    for _ in range(2):
        jm.iterate()
        tm.iterate()
    assert jm._bpr_mesh.devices.size == D
    assert tm._route() == route and tm._mesh.size == D
    assert len(jnegs) == len(tnegs) == 2
    for jn, tn in zip(jnegs, tnegs):
        assert_same_negatives(tn, jn, tm._plan.cell_counts)
    for k in ("user_factors", "item_factors", "item_bias"):
        np.testing.assert_allclose(tm.params[k].numpy(),
                                   np.asarray(jm.params[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


# --- one device, a clone, the explicit mesh ---

def one_device_routes(rating_data, item_fb, mesh=DEFAULT_MESH):
    """Each site's route for models with ``mesh`` (the default unless
    given), and the trained BiasedMF."""
    mf = create_rating_predictor("BiasedMatrixFactorization",
                                 "num_factors=4 num_iter=1 device=cpu")
    mf.mesh = mesh
    mf.ratings = rating_data
    mf.train()
    out = {"mf": mf._route()}
    for name in ("BPRMF", "MultiCoreBPRMF"):
        m = create_item_recommender(name, "num_factors=4 num_iter=1 "
                                    "device=cpu")
        m.mesh = mesh
        m.feedback = item_fb
        m.train()
        out[name] = (m._route(), m._mesh, m._sharded)
    sv = create_rating_predictor("SVDPlusPlus", "num_factors=4 num_iter=1 "
                                 "group_users=16 device=cpu")
    sv.mesh = mesh
    sv.ratings = rating_data
    out["svdpp"] = sv.route()
    w = create_item_recommender("WRMF", "num_factors=4 num_iter=1 "
                                "device=cpu")
    w.mesh = mesh
    w.feedback = item_fb
    w.train()
    out["wrmf"] = w._hist_mesh
    return out, mf


@pytest.mark.parametrize("how", ["no-cards", "one-device", "mesh-None"])
def test_one_device_keeps_every_route(svdpp_data, item_data, monkeypatch,
                                      how):
    """With no card or one device visible, or ``mesh = None`` set on a
    rig of 8, every site takes its one-device route and the eval ranks
    on one device."""
    _, tr = svdpp_data
    train, test = item_data
    fb = port_posonly(train)
    devices = {"no-cards": None, "one-device": ["cpu"], "mesh-None": RIG}
    mesh = None if how == "mesh-None" else DEFAULT_MESH
    parts = mesh_parts(monkeypatch)
    with default_devices(devices[how]):
        routes, mf = one_device_routes(tr, fb, mesh)
        for name in ("BPRMF", "LeastSquareSLIM"):
            m = create_item_recommender(name, "num_iter=1 device=cpu")
            m.mesh = mesh
            m.feedback = fb
            m.train()
            tranking.evaluate_items(m, port_posonly(test), fb)
    assert routes["mf"] == "resident" and mf._mesh is None
    for name in ("BPRMF", "MultiCoreBPRMF"):
        assert routes[name] == ("resident", None, None)
    assert routes["svdpp"] == "kernel" and routes["wrmf"] is None
    assert parts == []


def test_clone_keeps_the_default(svdpp_data, rig):
    _, tr = svdpp_data
    m = create_rating_predictor("BiasedMatrixFactorization",
                                "num_factors=4 device=cpu")
    c = clone_recommender(m)
    assert c.mesh is DEFAULT_MESH
    c.ratings = tr
    c.init_model()
    assert c._route() == "sharded" and c._mesh is default_mesh("cpu")
    m.mesh = None
    assert clone_recommender(m).mesh is None


def test_copy_and_pickle_keep_the_default(svdpp_data, rig):
    """``DEFAULT_MESH`` is one object under ``copy`` and ``pickle``: a deep
    copy of an untrained BiasedMF (the early-stopping idiom) trains on
    the default mesh."""
    assert copy.copy(DEFAULT_MESH) is DEFAULT_MESH
    assert pickle.loads(pickle.dumps(DEFAULT_MESH)) is DEFAULT_MESH
    _, tr = svdpp_data
    m = create_rating_predictor("BiasedMatrixFactorization",
                                "num_factors=4 num_iter=1 device=cpu")
    assert pickle.loads(pickle.dumps(m)).mesh is DEFAULT_MESH
    c = copy.deepcopy(m)
    assert c.mesh is DEFAULT_MESH
    c.ratings = tr
    c.train()
    assert c._route() == "sharded" and c._mesh is default_mesh("cpu")
    assert torch.isfinite(c.W_ext).all()


def test_default_equals_the_explicit_mesh(svdpp_data, rig):
    """Trained on the default, BiasedMF's tables equal those of an explicit
    ``make_mesh(devices=RIG)`` bit for bit, also after an online update
    (which reads the gathered tables, no collective)."""
    _, tr = svdpp_data
    models = []
    for mesh in (DEFAULT_MESH, make_mesh(devices=RIG)):
        m = create_rating_predictor("BiasedMatrixFactorization",
                                    "num_factors=4 num_iter=2 device=cpu")
        m.mesh = mesh
        m.ratings = tr
        m.train()
        assert m._route() == "sharded" and m._mesh.size == D
        m.add_ratings(np.array([1, 2], np.int32), np.array([3, 4], np.int32),
                      np.array([4.0, 2.0], np.float32))
        models.append(m)
    a, b = models
    assert torch.equal(a.W_ext, b.W_ext) and torch.equal(a.H_ext, b.H_ext)
    users = np.arange(20, dtype=np.int32)
    np.testing.assert_array_equal(a.predict_batch(users, users),
                                  b.predict_batch(users, users))


# --- MML_MXU=0 ---

def test_mml_mxu_0_route_choice_matches_jax(monkeypatch):
    """The schedule over a grid of catalogs, factors and device counts:
    "minibatch" wherever the JAX package runs its XLA epochs."""
    monkeypatch.setenv("MML_MXU", "0")
    for n in (1, 2, 8):
        devices = jax.devices()[:n]
        monkeypatch.setattr(jax, "devices", lambda *a, **k: devices)
        for items in (100, 3_000, 41_000, 624_961, 2_200_000):
            for f in (10, 40, 120):
                assert kernel_select.select_mxu_mode(items, f) == ""
                assert tplan.select_schedule(items, f, n) == "minibatch"


def test_mml_mxu_0_models_match_jax(svdpp_data, item_data, monkeypatch,
                                    caplog):
    """Under ``MML_MXU=0`` the models take the JAX package's routes on one
    device and on the default mesh: MF the blocked epoch on one device,
    BPRMF the minibatch epoch on one device, MultiCoreBPRMF the sharded
    minibatch epoch on the mesh, SVD++ the grouped epoch, sharded on the
    mesh."""
    monkeypatch.setenv("MML_MXU", "0")
    jr, tr = svdpp_data
    train, _ = item_data
    fb = port_posonly(train)
    jm = jmf.BiasedMatrixFactorization()
    jm.ratings = jr
    assert jm._mxu_mode() == ""
    js = jsv.SVDPlusPlus()
    js.ratings = jr
    js.init_model()
    assert js._svdpp_mxu_mode() == "" and js._mesh is not None
    jmc = jbpr.MultiCoreBPRMF()
    jmc.feedback = train
    jmc.init_model()
    assert jmc._mesh is not None
    jmc._prepare_mxu()
    assert jmc._bpr_plan is None
    for devices in (None, RIG):
        with default_devices(devices), \
                caplog.at_level(logging.WARNING,
                                logger="mymedialite_tpu_torch"):
            routes, mf = one_device_routes(tr, fb)
            sv = create_rating_predictor(
                "SVDPlusPlus", "num_factors=4 group_users=16 device=cpu")
            sv.ratings = tr
            sv_route = sv.route()
        assert routes["mf"] == "minibatch" and mf._blocked is not None
        assert routes["BPRMF"][0] == "minibatch"
        assert routes["BPRMF"][2] is None
        mc_route, _, mc_sharded = routes["MultiCoreBPRMF"]
        assert mc_route == "minibatch"
        if devices is None:
            assert sv_route == "grouped" and mc_sharded is None
        else:
            assert sv_route == "sharded" and mc_sharded[0].size == D
            assert any("no sharded form" in r.message for r in caplog.records)
        assert not any("no kernel schedule" in r.message
                       for r in caplog.records)
