"""The grouped SVD++ epoch of the port (``mymedialite_tpu_torch/ops/
svdpp.py`` ``prepare_groups`` / ``svdpp_epoch_grouped``), the SVD++
family's route choice and GSVDPlusPlus, against the JAX package's XLA
grouped epoch (``mymedialite_tpu/ops/svdpp.py``) on the CPU.

The layout equals the JAX package's padded arrays. One epoch from the
same tables lands within 1e-5 of ``svdpp_epoch`` with and without p, with
the sigmoid (each loss), with gSVD++'s attribute factors, with one chunk
per group and with L past 4,096 (the last chunk clamped as the JAX
package's dynamic_slice clamps it), and with U not a multiple of the
group size. SVDPlusPlus and SigmoidSVDPlusPlus with frequency
regularization, and GSVDPlusPlus, match the JAX models after 3 epochs
from the same tables; GSVDPlusPlus model files pass between the packages.
The route (kernel or grouped) and the group size equal the JAX package's
single-device choice, ``group_users`` and the pass-length fallback
included. The JAX models run as on one device (the session's eight host
devices would shard their epoch).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mymedialite_tpu.data.arrays import InteractionData as JaxInteractions
from mymedialite_tpu.data.arrays import RatingData as JaxRatingData
from mymedialite_tpu.models import svdpp as jsv
from mymedialite_tpu.ops import pallas_svdpp as psv
from mymedialite_tpu.ops import svdpp as jops
from mymedialite_tpu.utils.params import configure as jax_configure
from mymedialite_tpu_torch.convert import svdpp_tables_from_jax
from mymedialite_tpu_torch.data.arrays import InteractionData, RatingData
from mymedialite_tpu_torch.models import svdpp as tsv
from mymedialite_tpu_torch.models.registry import create_rating_predictor
from mymedialite_tpu_torch.ops import svdpp as tops
from mymedialite_tpu_torch.ops import svdpp_plan as SP
from torch_threads import one_torch_thread  # noqa: F401

U, I, N, F, A = 150, 100, 6000, 6, 7


def padded(groups):
    """The JAX package's rectangular arrays (``prepare_groups``) from the
    port's layout: r_user, r_item, r_value, r_mask, e_user, e_item,
    e_mask [ngroups, L], each group's row zero-padded to the largest
    group's length."""
    out = {}
    for kind, names, off in (("r", ("user", "item", "value"), groups.r_off),
                             ("e", ("user", "item"), groups.e_off)):
        counts = np.diff(off)
        L = max(int(counts.max()), 1)
        g = np.repeat(np.arange(groups.ngroups), counts)
        slot = np.arange(off[-1]) - np.repeat(off[:-1], counts)
        for name in names:
            flat = getattr(groups, f"{kind}_{name}").numpy()
            buf = np.zeros((groups.ngroups, L),
                           np.float32 if name == "value" else np.int32)
            buf[g, slot] = flat
            out[f"{kind}_{name}"] = buf
        mask = np.zeros((groups.ngroups, L), np.float32)
        mask[g, slot] = 1.0
        out[f"{kind}_mask"] = mask
    return out


@pytest.fixture(autouse=True)
def single_device(monkeypatch):
    """The JAX models as on one device: the test session's host platform
    has 8 CPU devices, on which they would shard the grouped epoch."""
    monkeypatch.setattr(jsv.SVDPlusPlus, "_setup_mesh", lambda self: None)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    v = rng.integers(1, 6, N).astype(np.float32)
    hu, hi = tops.history_edges(u, i, I, (rng.integers(0, U, 500),
                                          rng.integers(0, I, 500)))
    attr = np.zeros((I, A), np.float32)
    attr[np.arange(I), rng.integers(0, A, I)] = 1
    attr[np.arange(0, I, 3), rng.integers(0, A, (I + 2) // 3)] = 1
    attr /= attr.sum(1, keepdims=True)
    attr[5] = 0
    return u, i, v, hu, hi, attr


@pytest.mark.parametrize("G,n", [(64, N), (16, N), (256, N), (256, 200)])
def test_groups_equal(data, G, n):
    u, i, v, hu, hi, _ = data
    jd, jm = jops.prepare_groups(JaxRatingData(u[:n], i[:n], v[:n],
                                               num_users=U, num_items=I),
                                 hu, hi, U, I, G)
    tg = tops.prepare_groups(u[:n], i[:n], v[:n], hu, hi, U, G)
    assert (tg.ngroups, tg.group_users) == (jm["ngroups"], jm["group_users"])
    assert tg.length == np.asarray(jd["r_user"]).shape[1]
    for k, a in padded(tg).items():
        np.testing.assert_array_equal(a, np.asarray(jd[k]), k)


@pytest.mark.parametrize("G,n", [(64, N), (256, N), (32, 1500)],
                         ids=["3 groups, U % G", "L past 4096", "short"])
@pytest.mark.parametrize("use_p,sigmoid,loss,attrs", [
    (True, False, 0, False), (True, True, 0, False), (True, True, 1, False),
    (False, True, 2, False), (True, False, 0, True), (True, True, 0, True)])
def test_epoch_matches_jax(data, G, n, use_p, sigmoid, loss, attrs):
    u, i, v, hu, hi, attr = data
    jd, jm = jops.prepare_groups(JaxRatingData(u[:n], i[:n], v[:n],
                                               num_users=U, num_items=I),
                                 hu, hi, U, I, G)
    tg = tops.prepare_groups(u[:n], i[:n], v[:n], hu, hi, U, G)
    Up = jm["ngroups"] * G
    rng = np.random.default_rng(3)

    def normal(*shape):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    def uniform(n_):
        return rng.uniform(0.01, 0.05, n_).astype(np.float32)
    tables = dict(user_bias=normal(Up), item_bias=normal(I),
                  item_factors=normal(I, F), y=normal(I, F))
    if use_p:
        tables["p"] = normal(Up, F)
    if attrs:
        tables["x"] = normal(A, F)
        jd = dict(jd, attr_norm=jnp.asarray(attr))
    regs = dict(user_reg=uniform(Up), item_reg=uniform(I), y_reg=uniform(I),
                x_reg=uniform(A))
    lr = 0.003 if attrs else 0.01
    hp = dict(learn_rate=lr, bias_learn_rate=0.7, bias_reg=0.33,
              min_rating=1.0, rating_range=4.0)
    want = jops.svdpp_epoch(
        dict({k: jnp.asarray(t) for k, t in tables.items()},
             global_bias=jnp.float32(0.2)), jd,
        dict({k: jnp.float32(x) for k, x in hp.items()},
             **{k: jnp.asarray(r) for k, r in regs.items()}),
        group_users=G, ngroups=jm["ngroups"], loss=loss, sigmoid=sigmoid,
        use_p=use_p, update_user=True, update_item=True, use_attrs=attrs)
    cut = {"user_bias", "p"}
    got = {k: torch.from_numpy(t[:U].copy() if k in cut else t.copy())
           for k, t in tables.items()}
    tregs = {k: torch.from_numpy(r[:U] if k == "user_reg" else r)
             for k, r in regs.items()}
    inv = torch.from_numpy(tops.inv_sqrt_counts(hu, U))
    tops.svdpp_epoch_grouped(
        got, tg, inv, dict(hp, global_bias=0.2), tregs, loss=loss,
        sigmoid=sigmoid, use_p=use_p,
        attr_norm=torch.from_numpy(attr) if attrs else None)
    for k, t in got.items():
        ref = np.asarray(want[k])
        ref = ref[:U] if k in cut else ref
        np.testing.assert_allclose(t.numpy(), ref, rtol=0, atol=1e-5,
                                   err_msg=k)
        assert not np.array_equal(t.numpy(), tables[k][:len(ref)]), k


def _attributes(cls, I_):
    items = np.arange(I_)
    return cls(np.concatenate([items, items[::4]]),
               np.concatenate([items % 5, 5 + items[::4] % 2]))


@pytest.fixture
def share_init(monkeypatch):
    stash = []
    jax_init, port_init = jsv.SVDPlusPlus.init_model, tsv.SVDPlusPlus.init_model
    gjax_init = jsv.GSVDPlusPlus.init_model

    def record(self):
        jax_init(self)
        stash.append(svdpp_tables_from_jax(self))

    def grecord(self):
        gjax_init(self)
        stash[-1] = svdpp_tables_from_jax(self)

    def replay(self, tables=None):
        port_init(self, stash.pop(0) if tables is None else tables)

    monkeypatch.setattr(jsv.SVDPlusPlus, "init_model", record)
    monkeypatch.setattr(jsv.GSVDPlusPlus, "init_model", grecord)
    monkeypatch.setattr(tsv.SVDPlusPlus, "init_model", replay)


def make_pair(name, opts, data):
    u, i, v, *_ = data
    cut = 5100
    o = f"num_factors={F} num_iter=3 learn_rate=0.01 {opts}"
    jm = getattr(jsv, name)()
    jax_configure(jm, o)
    tm = create_rating_predictor(name, o + " device=cpu")
    jm.ratings = JaxRatingData(u[:cut], i[:cut], v[:cut], num_users=U,
                               num_items=I)
    tm.ratings = RatingData(u[:cut], i[:cut], v[:cut], num_users=U,
                            num_items=I)
    jm.additional_feedback = tm.additional_feedback = (u[cut:], i[cut:])
    if name == "GSVDPlusPlus":
        jm.item_attributes = _attributes(JaxInteractions, I)
        tm.item_attributes = _attributes(InteractionData, I)
    return jm, tm, (u[cut:], i[cut:])


@pytest.mark.parametrize("name,opts", [
    ("SVDPlusPlus", "frequency_regularization=true"),
    ("SigmoidSVDPlusPlus", "frequency_regularization=true loss=MAE"),
    ("GSVDPlusPlus", ""),
    ("GSVDPlusPlus", "frequency_regularization=true")])
def test_models_match_jax(data, share_init, tmp_path, name, opts):
    jm, tm, (tu, ti) = make_pair(name, opts, data)
    jm.train()
    tm.train()
    assert tm.route() == "grouped"
    want = svdpp_tables_from_jax(jm)
    for k, t in tm.params.items():
        np.testing.assert_allclose(t.numpy(), want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tm.predict_batch(tu, ti),
                               jm.predict_batch(tu, ti), atol=1e-5)
    if name != "GSVDPlusPlus":
        return
    # model files both ways, loaded with the same histories
    jpath, tpath = str(tmp_path / "j.model"), str(tmp_path / "t.model")
    jm.save_model(jpath)
    tm.save_model(tpath)
    jm2, tm2, _ = make_pair(name, opts, data)
    tm2.load_model(jpath)
    jm2.load_model(tpath)
    for a, b in ((tm2, jm), (jm2, tm), (tm2, jm2)):
        np.testing.assert_allclose(a.predict_batch(tu, ti),
                                   b.predict_batch(tu, ti), atol=1e-5)
    assert open(tpath).read().split("\n", 1)[0] == "GSVDPlusPlus"


def test_gsvd_needs_attributes(data):
    u, i, v, *_ = data
    m = create_rating_predictor("GSVDPlusPlus", "device=cpu")
    m.ratings = RatingData(u, i, v, num_users=U, num_items=I)
    with pytest.raises(ValueError, match="needs item attributes"):
        m.train()


@pytest.mark.parametrize("case", ["default", "frequency", "group_users",
                                  "table budget", "pass length", "gsvd",
                                  "fast learn rate"])
def test_route_matches_jax(data, monkeypatch, case):
    """The JAX package's choice on one device (``MML_MXU=interpret`` stands
    for the single TPU chip): its kernel plan exists exactly where the
    port takes the kernel, and the grouped layouts agree."""
    monkeypatch.setenv("MML_MXU", "interpret")
    opts = {"frequency": "frequency_regularization=true",
            "group_users": "group_users=32",
            "fast learn rate": "frequency_regularization=true "
                               "learn_rate=0.05"}.get(case, "")
    if case == "table budget":
        monkeypatch.setattr(psv, "SVDPP_VMEM_TABLE_BYTES", 1024)
        monkeypatch.setattr(SP, "SVDPP_TABLE_BYTES", 1024)
    if case == "pass length":
        monkeypatch.setattr(psv, "prepare_svdpp_mxu", functools.partial(
            psv.prepare_svdpp_mxu, pass_len=2))
        monkeypatch.setattr(SP, "PASS_LEN", 2)
    name = "GSVDPlusPlus" if case == "gsvd" else "SVDPlusPlus"
    jm, tm, _ = make_pair(name, opts, data)
    jm._prepare()
    kernel = getattr(jm, "_svdpp_plan", None) is not None
    assert tm.route() == ("kernel" if kernel else "grouped")
    assert kernel == (case in ("default", "group_users"))
    if not kernel:
        assert tm._groups.group_users == jm._meta["group_users"]
        for k, a in padded(tm._groups).items():
            np.testing.assert_array_equal(a, np.asarray(jm._data[k]), k)
        for k, r in tm._regs.items():
            np.testing.assert_allclose(
                r.numpy(), np.asarray(jm._hp_arrays[k])[:len(r)], rtol=1e-7)
