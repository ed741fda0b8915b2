"""``chip_smoke.py`` on a machine without a CUDA card: it imports nothing
of jax or of the JAX package, it names every kernel source of the port
in its kernels line, its bounds count what the work needs, and without a
card (or alone, outside the repository) it exits non-zero and prints no
result line."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module


def test_smoke_imports_only_the_port():
    mods = set(_imported_modules(SMOKE))
    assert any(m.startswith("mymedialite_tpu_torch") for m in mods)
    bad = [m for m in mods
           if m.split(".")[0] in ("jax", "jaxlib", "mymedialite_tpu")]
    assert not bad, bad


def test_smoke_reports_every_kernel():
    """Each ``csrc/*.cu`` file is the source of an entry of the kernels
    line, with the TPU kernels it replaces (resident and slab-tiled), and
    every entry carries the keys of the line."""
    text = open(SMOKE).read()
    csrc = os.path.join(REPO, "mymedialite_tpu_torch", "csrc")
    sources = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    assert sources == ["bpr_epoch.cu", "catalog_topk.cu", "sgd_epoch.cu",
                       "svdpp_epoch.cu"]
    for src in sources:
        assert f'"mymedialite_tpu_torch/csrc/{src}"' in text, src
    for replaced in ("mymedialite_tpu/ops/pallas_sgd.py:324",
                     "mymedialite_tpu/ops/pallas_sgd.py:745",
                     "mymedialite_tpu/ops/pallas_bpr.py:451",
                     "mymedialite_tpu/ops/pallas_bpr.py:979",
                     "mymedialite_tpu/ops/pallas_svdpp.py:308",
                     "mymedialite_tpu/ops/pallas_topk.py:55"):
        assert f'"{replaced}"' in text
        path, line = replaced.split(":")
        with open(os.path.join(REPO, path)) as f:
            head = f.read().splitlines()[int(line) - 1]
        assert head.startswith("def _") and "_kernel(" in head, head
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert f"{key}=" in text, key


def test_svdpp_bound_counts_live_data(monkeypatch):
    """``svdpp_bound`` on a small plan against a count made from the data
    alone: W rows at 2f+3 columns (read f+2, write f+1), Q rows at 2(f+1),
    Y rows at 2f, 12 B per rating, 8 B per history edge, 16 B per
    scheduled step; 14(f+1) operations per rating and 8f per edge."""
    import importlib.util

    import numpy as np

    from mymedialite_tpu_torch.ops.svdpp import history_edges
    from mymedialite_tpu_torch.ops.svdpp_plan import prepare_svdpp_mxu

    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    rng = np.random.default_rng(3)
    U, I, n, f = 40, 30, 300, 6
    users = rng.integers(0, U - 4, n).astype(np.int32)
    items = rng.integers(0, I - 3, n).astype(np.int32)
    values = rng.integers(1, 6, n).astype(np.float32)
    extra = (rng.integers(0, U, 50).astype(np.int32),
             rng.integers(0, I, 50).astype(np.int32))
    hu, hi = history_edges(users, items, I, extra)
    plan = prepare_svdpp_mxu(users, items, values, hu, hi, U, I,
                             user_block=8, item_block=8, chunk=8)
    want_bytes = (np.unique(users).size * (2 * f + 3)
                  + np.unique(items).size * 2 * (f + 1)
                  + np.unique(hi).size * 2 * f) * 4 \
        + n * 12 + len(hu) * 8 + plan.num_steps * 16
    want_ops = 14.0 * (f + 1) * n + 8.0 * f * len(hu)

    monkeypatch.setattr(smoke, "PEAK_BYTES_PER_S", 1e3)
    monkeypatch.setattr(smoke, "PEAK_FP32_PER_S", 1e30)
    ms, by = smoke.svdpp_bound(plan, *plan.schedule, f)
    assert (ms, by) == (pytest.approx(want_bytes, rel=1e-12), "bytes")
    monkeypatch.setattr(smoke, "PEAK_BYTES_PER_S", 1e30)
    monkeypatch.setattr(smoke, "PEAK_FP32_PER_S", 1e3)
    ms, by = smoke.svdpp_bound(plan, *plan.schedule, f)
    assert (ms, by) == (pytest.approx(want_ops, rel=1e-12), "operations")


def _smoke_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_topk_bound_counts_the_calls(monkeypatch):
    """``topk_bound`` over blocks of 3 and 2 users against a 10-item
    catalog, width 5, k 4: per call the user rows, the whole item table
    and the mask read once, the (id, value) pairs written once; 2 B N f
    operations."""
    smoke = _smoke_module()
    want_bytes = sum(B * 5 * 4 + 10 * 5 * 4 + B * 10 + B * 4 * 8
                     for B in (3, 2))
    want_ops = sum(2.0 * B * 10 * 5 for B in (3, 2))
    monkeypatch.setattr(smoke, "PEAK_BYTES_PER_S", 1e3)
    monkeypatch.setattr(smoke, "PEAK_FP32_PER_S", 1e30)
    assert smoke.topk_bound([3, 2], 10, 5, 4) == (
        pytest.approx(want_bytes, rel=1e-12), "bytes")
    monkeypatch.setattr(smoke, "PEAK_BYTES_PER_S", 1e30)
    monkeypatch.setattr(smoke, "PEAK_FP32_PER_S", 1e3)
    assert smoke.topk_bound([3, 2], 10, 5, 4) == (
        pytest.approx(want_ops, rel=1e-12), "operations")


def test_topk_agreement_rule():
    """Ids are compared where the reference's neighbouring values differ
    by more than 1e-5, the last position judged by the reference's extra
    column; the tie case compares every id."""
    import numpy as np
    smoke = _smoke_module()
    ref_vals = np.array([[5.0, 4.0, 3.0, 3.0 + 5e-6, 1.0],
                         [9.0, 8.0, 7.0, 6.0, 6.0]])
    ref_ids = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]])
    ids = np.array([[1, 2, 4, 3], [6, 7, 8, 10]])
    vals = ref_vals[:, :4] + 1e-6
    err, bad = smoke.topk_agreement(ids, vals, ref_ids, ref_vals)
    assert err == pytest.approx(1e-6) and bad == 0
    ids[0, 0] = 9
    assert smoke.topk_agreement(ids, vals, ref_ids, ref_vals)[1] == 1
    assert smoke.topk_agreement(ids, vals, ref_ids, ref_vals,
                                exact=True)[1] == 4


def _small_svdpp_plan(f=6):
    import numpy as np
    import torch

    from mymedialite_tpu_torch.ops import svdpp_plan as SP
    from mymedialite_tpu_torch.ops.svdpp import history_edges
    rng = np.random.default_rng(0)
    U, I, n = 60, 50, 800
    users = rng.integers(0, U, n).astype(np.int32)
    items = rng.integers(0, I, n).astype(np.int32)
    values = (rng.integers(2, 11, n) / 2).astype(np.float32)
    hu, hi = history_edges(users, items, I)
    plan = SP.prepare_svdpp_mxu(users, items, values, hu, hi, U, I,
                                user_block=8, item_block=8, chunk=8)
    p, bu, q, bi, y = (torch.from_numpy(
        (0.1 * rng.standard_normal(shape)).astype(np.float32))
        for shape in ((U, f), (U,), (I, f), (I,), (I, f)))
    tables = SP.svdpp_tables_to_mxu(
        p, bu, plan.inv_sqrt, q, bi, y,
        torch.from_numpy(plan.new_of_old.astype(np.int64)), u_pad=plan.u_pad,
        i_pad=plan.i_pad, fe=SP.svdpp_fe(f))
    rates = SP.svdpp_mxu_rates(f, SP.svdpp_fe(f), 0.01, 0.7, 0.015, 0.33,
                               0.015, use_p=True, update_user=True,
                               update_item=True)
    return plan, tables, rates


def test_phase_schedules_and_user_block_bounds():
    """The S/R/Y split's schedules hold each phase's steps in the
    schedule's order and nothing else; the user-block bounds cut the
    schedule into its user blocks' runs."""
    import torch
    smoke = _smoke_module()
    plan, _, _ = _small_svdpp_plan()
    ph, ub, ib, row = plan.schedule
    parts = smoke.phase_schedules(plan.schedule)
    assert list(parts) == ["S", "R", "Y"]
    for code, (name, sched) in enumerate(parts.items()):
        sel = ph == code
        assert bool(sel.any())
        for got, full in zip(sched, plan.schedule):
            assert torch.equal(got, full[sel])
    assert sum(p[0].numel() for p in parts.values()) == plan.num_steps
    bounds = smoke.user_block_bounds(ub)
    assert len(bounds) == plan.n_ublocks
    assert bounds[0][0] == 0 and bounds[-1][1] == plan.num_steps
    for (a, b), (c, _) in zip(bounds, bounds[1:] + [(plan.num_steps, 0)]):
        assert b == c and bool((ub[a:b] == ub[a]).all())


def test_svdpp_variant_line():
    """The log line names the variant ``accumulator_variant`` picks and
    the shared memory of that variant."""
    from mymedialite_tpu_torch.ops import svdpp_epoch as se
    from mymedialite_tpu_torch.ops import svdpp_plan as SP
    smoke = _smoke_module()
    plan, _, _ = _small_svdpp_plan()
    plan.user_block, plan.chunk = 512, 512
    for f, variant in ((20, "shared"), (100, "shared"), (200, "global")):
        line = smoke.svdpp_variant_line(plan, f, SP.svdpp_fe(f))
        want = se.shared_bytes(SP.svdpp_fe(f), 512, 512, f, variant)
        assert f"variant {variant}:" in line and f"{want} B" in line


def test_mae_witnesses_on_the_cpu():
    """The MAE rows' witnesses run end to end on CPU tensors, where the
    wrappers run their plain versions: one step at a time both stay
    within rounding of float64, and the whole-epoch distances are those
    of float32 rounding; ``witness_check`` takes them and refuses a
    kernel past the factor."""
    import numpy as np

    from mymedialite_tpu_torch.ops import plan as P
    smoke = _smoke_module()
    rng = np.random.default_rng(2)
    U, I, n = 90, 70, 1500
    users = rng.integers(0, U, n).astype(np.int32)
    items = (rng.zipf(1.5, n) % I).astype(np.int32)
    values = (rng.integers(2, 11, n) / 2).astype(np.float32)
    tabs = (0.1 * rng.standard_normal((U, 6)),
            0.1 * rng.standard_normal((I, 6)),
            0.1 * rng.standard_normal(U), 0.1 * rng.standard_normal(I))
    for tiled in (False, True):
        kw = dict(user_block=32, item_block=32, chunk=64, shuffle_seed=4)
        plan = P.prepare_mxu_tiled(users, items, values, U, I,
                                   slab_blocks=1, **kw) if tiled else \
            P.prepare_mxu_data(users, items, values, U, I, **kw)
        W, H = P.extend_tables_mxu(plan, *tabs)
        rates = P.mxu_column_rates(6, W.shape[1], 0.05, 0.03, 0.02, 0.8, 0.4,
                                   True, True, True)
        step, k_dist, p_dist = smoke.sgd_one_step_witness(
            plan, W, H, plan.epoch_order(3), (0.2, 1.0, 4.0), rates, loss=1,
            biased=True)
        assert step <= 1e-6 and 0 < k_dist <= 1e-5 and 0 < p_dist <= 1e-5
        smoke.witness_check(step, k_dist, p_dist, "sgd")
    plan, tables, rates = _small_svdpp_plan()
    step, k_dist, p_dist = smoke.svdpp_one_step_witness(
        plan, tables, (0.6, 1.0, 4.0), rates, user_block=8, item_block=8,
        num_factors=6, loss=1, sigmoid=True)
    assert step <= 1e-6 and 0 < k_dist <= 1e-5 and 0 < p_dist <= 1e-5
    smoke.witness_check(step, k_dist, p_dist, "svdpp")
    with pytest.raises(AssertionError, match="farthest plain run"):
        smoke.witness_check(step, 5 * p_dist, p_dist, "svdpp")
    with pytest.raises(AssertionError, match="one step at a time"):
        smoke.witness_check(2e-4, k_dist, p_dist, "svdpp")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_smoke_fails_without_card_or_repo(where, tmp_path):
    cwd = REPO
    if where == "alone":
        shutil.copy(SMOKE, tmp_path)
        cwd = tmp_path
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        import time
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_wrmf_and_knn_phases_rehearse_on_the_cpu(monkeypatch, tmp_path,
                                                   capsys):
    """The new phases (WRMF, implicit KNN, rating KNN, the KNN CLIs) run
    end to end on CPU tensors at 6,000 x 300 x 150k (the CLIs at 600 x
    300 x 60k, about ML-1M's ratings per user), with the card's
    clock, synchronisation and memory counters stood in for: a WRMF user
    side agrees with the same side assembled and solved in float64, both
    KNN builds take the streaming top-k (``DENSE_NMAX`` shrunk) and match
    float64 on sampled rows, rating ItemKNN's neighbours match Pearson in
    float64 on sampled rows and its batched predictions the per-pair loop,
    in both storage modes, and the CLIs save and load, UserKNN beating
    UserItemBaseline; no kernel is launched."""
    import numpy as np
    import torch

    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, split_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.ops import correlation as corr_ops
    smoke = _smoke_module()
    for name, fn in (("Event", _HostEvent), ("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(smoke, "EVAL_USERS", 200)
    monkeypatch.setattr(smoke, "KNN_ROWS", 32)
    dev = torch.device("cpu")
    train, test = split_ratings(synthetic_ratings(6000, 300, 150_000, seed=1),
                                0.2, seed=2)
    smoke.phase_wrmf_path(dev, train, test)
    monkeypatch.setattr(corr_ops, "DENSE_NMAX", 256)
    results = smoke.phase_knn_path(dev, posonly_from_ratings(train),
                                   posonly_from_ratings(test))
    assert set(results) == {"ItemKNN", "UserKNN"}
    for limit in (16_384, 256):           # dense, then the top-k store
        monkeypatch.setattr(corr_ops, "DENSE_NMAX", limit)
        rmse = smoke.phase_rating_knn_path(dev, train, test)
        assert set(rmse) == {"ItemKNN", "ItemKNN shrinkage 100",
                             "UserItemBaseline"}
    # the CLIs on fewer users at about ML-1M's density: UserKNN's dense
    # correlation file holds one line per pair of users
    train, test = split_ratings(synthetic_ratings(600, 300, 60_000, seed=3),
                                0.2, seed=2)
    files = []
    for name, part in (("training", train), ("test", test)):
        path = str(tmp_path / f"{name}.tsv")
        np.savetxt(path, np.column_stack([part.users, part.items,
                                          part.values]),
                   fmt=("%d", "%d", "%g"), delimiter="\t")
        files += [f"--{name}-file", path]
    smoke.phase_knn_cli(dev, str(tmp_path), files, files, num_items=300)
    out = capsys.readouterr().out
    assert "assembled and solved apart from ops/als.py" in out
    assert "against Pearson recomputed in float64" in out
    assert "item attributes for" in out


def test_slab_window_runs_across_the_first_slab_boundary():
    """The tiled paths' plain check covers a window of the order that ends
    ``extra`` chunks into the second slab, at most ``length`` long."""
    import torch
    smoke = _smoke_module()
    slabs = torch.tensor([0] * 10 + [1] * 6 + [2] * 4)
    assert smoke.slab_window(slabs, length=8, extra=3) == (5, 13)
    assert smoke.slab_window(slabs, length=100, extra=3) == (0, 13)
    assert smoke.slab_window(slabs, length=8, extra=50) == (12, 20)
    with pytest.raises(AssertionError, match="no slab boundary"):
        smoke.slab_window(torch.zeros(5, dtype=torch.int64))


def test_topk_agreement_gap():
    """``gap`` sets the near-tie rule: at 1e-6 a pair 5e-6 apart is
    judged, at the default 1e-5 it is not."""
    import numpy as np
    smoke = _smoke_module()
    ref_vals = np.array([[5.0, 3.0 + 5e-6, 3.0, 1.0]])
    ref_ids = np.array([[1, 2, 3, 4]])
    ids, vals = np.array([[1, 3, 2]]), ref_vals[:, :3]
    assert smoke.topk_agreement(ids, vals, ref_ids, ref_vals)[1] == 0
    assert smoke.topk_agreement(ids, vals, ref_ids, ref_vals,
                                gap=1e-6)[1] == 2


def test_wrmf_float64_side_matches_a_per_row_solve():
    """``wrmf_user_side_f64`` (one sparse product for the sums) against a
    numpy float64 assembly and solve, row by row, on feedback with
    repeated pairs (each counted once) and users without history."""
    import numpy as np
    import torch

    from mymedialite_tpu_torch.data.arrays import PosOnlyData
    smoke = _smoke_module()
    rng = np.random.default_rng(5)
    U, I, f, alpha, reg = 30, 25, 6, 2.0, 0.5
    users = rng.integers(0, U - 3, 200)
    items = rng.integers(0, I, 200)
    fb = PosOnlyData(np.concatenate([users, users[:20]]),
                     np.concatenate([items, items[:20]]),
                     num_users=U, num_items=I)
    H = rng.normal(0, 0.5, (I, f))
    got = smoke.wrmf_user_side_f64(fb, torch.from_numpy(H), alpha, reg)
    HH = H.T @ H
    for u in range(U):
        S = H[np.unique(items[users == u])]
        M = HH + alpha * S.T @ S + reg * np.eye(f)
        want = np.linalg.solve(M, (1 + alpha) * S.sum(axis=0))
        np.testing.assert_allclose(got[u].numpy(), want, rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("shrinkage", [0.0, 10.0])
def test_pearson_float64_rows_match_the_jax_package(shrinkage):
    """``pearson_rows_f64`` against the JAX package's dense item-item
    Pearson with the same shrinkage on half-star ratings: values within
    1e-6, ids equal outside near-ties of 1e-6, the item itself last."""
    import numpy as np
    import torch

    from mymedialite_tpu.data.arrays import RatingData as JaxRatingData
    from mymedialite_tpu.ops.correlation import rating_correlation
    from mymedialite_tpu_torch.data.arrays import RatingData
    smoke = _smoke_module()
    rng = np.random.default_rng(7)
    U, I, n = 80, 40, 900
    key = np.unique(rng.integers(0, U * I, n))
    users, items = key // I, key % I
    values = rng.integers(2, 11, key.size) / 2.0
    data = RatingData(users, items, values, num_users=U, num_items=I)
    dense = np.asarray(rating_correlation(
        JaxRatingData(users, items, values, num_users=U, num_items=I),
        entity="item", kind="pearson", shrinkage=shrinkage), np.float64)
    rows = np.array([0, 3, 17, 39])
    np.fill_diagonal(dense, -np.inf)
    order = np.argsort(-dense[rows], axis=1, kind="stable")[:, :11]
    want_vals = np.take_along_axis(dense[rows], order, axis=1)
    ids, vals = smoke.pearson_rows_f64(data, torch.from_numpy(rows), 10,
                                       shrinkage)
    err, bad = smoke.topk_agreement(ids[:, :10], vals[:, :10], order,
                                    want_vals, gap=1e-6)
    assert err <= 1e-6 and bad == 0
    full = smoke.pearson_rows_f64(data, torch.from_numpy(rows), I - 1,
                                  shrinkage)[0]
    assert (full[:, -1] == rows).all()


def test_xla_route_phases_rehearse_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The phases of the XLA routes run end to end on CPU tensors at
    small sizes, the card's clock, synchronisation, memory counters and
    profiler stood in for, the budgets shrunk so that the routes are
    taken: grouped SVD++ (its first groups against float64), blocked MF
    with frequency regularization and past the tiled schedule's slabs,
    minibatch BPR (AUC above 0.5), and the CLI protocols (cross-validation
    in all three CLIs, --find-iter, --search-hp, GSVDPlusPlus save ->
    load); no kernel is launched (on the CPU the wrappers count none, so
    the CLI phase's expected launches are not checked here)."""
    import contextlib

    import numpy as np
    import torch

    from mymedialite_tpu_torch import hyperopt
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, split_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.ops import plan as tplan
    from mymedialite_tpu_torch.ops import svdpp_plan
    smoke = _smoke_module()
    for name, fn in (("Event", _HostEvent), ("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(smoke, "profiled_busy",
                        lambda fn: (fn(), 1.0, 2.0, 3)[1:])
    monkeypatch.setattr(smoke, "AUC_USERS", 100)
    monkeypatch.setattr(smoke, "GROUP_PREFIX", 2)
    monkeypatch.setattr(smoke, "PREFIX_BATCH", 256)
    monkeypatch.setattr(svdpp_plan, "SVDPP_TABLE_BYTES", 1024)
    dev = torch.device("cpu")
    train, test = split_ratings(synthetic_ratings(3000, 300, 60_000, seed=1),
                                0.2, seed=2)
    assert 0 < smoke.phase_svdpp_grouped(dev, train, test)["busy_share"]
    # batches of 1,024 give the small data as many steps per epoch as the
    # card's default batch gives its data
    smoke.phase_mf_blocked(dev, train, test, "frequency regularization",
                           "frequency_regularization=true batch_size=1024")
    monkeypatch.setattr(tplan, "RESIDENT_ITEM_TABLE_BYTES", 64 * 1024)
    assert tplan.select_schedule(300, 40) == "minibatch"
    smoke.phase_mf_blocked(dev, train, test, "big catalog", "batch_size=1024")
    smoke.phase_bpr_minibatch(dev, train, test, "big catalog")
    monkeypatch.undo()
    for name, fn in (("synchronize", lambda *a: None),):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(smoke, "counted_path",
                        lambda expected: contextlib.nullcontext({}))
    monkeypatch.setattr(hyperopt, "NUM_IT", 3)
    train, test = split_ratings(synthetic_ratings(600, 300, 30_000, seed=3),
                                0.2, seed=2)
    files, item_files = [], []
    for name, part in (("training", train), ("test", test)):
        path = str(tmp_path / f"{name}.tsv")
        np.savetxt(path, np.column_stack([part.users, part.items,
                                          part.values]),
                   fmt=("%d", "%d", "%g"), delimiter="\t")
        files += [f"--{name}-file", path]
        pos = posonly_from_ratings(part)
        path = str(tmp_path / f"items_{name}.tsv")
        np.savetxt(path, np.column_stack([pos.users, pos.items]), fmt="%d",
                   delimiter="\t")
        item_files += [f"--{name}-file", path]
    smoke.phase_cv_cli(dev, str(tmp_path), files, item_files, num_items=300)
    out = capsys.readouterr().out
    assert "svdpp grouped: first 2 groups on the card vs the CPU" in out
    assert out.count("on the card vs the CPU in float64") == 4
    assert out.count("groups of epoch 1 at a batch of 256") == 2
    assert "GSVDPlusPlus" in out and "iteration 3" in out


def test_prefix_check_holds_the_card_to_the_tolerance():
    """An XLA route's prefix passes only within KERNEL_TOL of the float64
    run, however far the CPU float32 run lies from it."""
    import torch

    smoke = _smoke_module()
    host64 = dict(W=torch.zeros(4, 3, dtype=torch.float64))
    host32 = dict(W=torch.ones(4, 3))
    near = dict(W=torch.full((4, 3), 0.5 * smoke.KERNEL_TOL))
    assert smoke.prefix_check(near, host32, host64, "near") == (
        pytest.approx(0.5 * smoke.KERNEL_TOL), 1.0)
    with pytest.raises(AssertionError, match="past"):
        smoke.prefix_check(dict(W=torch.full((4, 3), 2 * smoke.KERNEL_TOL)),
                           host32, host64, "far")
    with pytest.raises(AssertionError, match="non-finite"):
        smoke.prefix_check(dict(W=torch.full((4, 3), float("nan"))), host32,
                           host64, "nan")


def test_event_subset_is_seeded_and_stable():
    """Phase 22's event subsets: the same seed gives the same events, in
    index order; another seed other events."""
    import numpy as np

    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    smoke = _smoke_module()
    _, test = split_ratings(synthetic_ratings(300, 200, 8000, seed=1), 0.2,
                            seed=2)
    a = smoke.event_subset(test, 100, seed=22)
    b = smoke.event_subset(test, 100, seed=22)
    c = smoke.event_subset(test, 100, seed=23)
    assert len(a) == 100
    for field in ("users", "items", "values"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert not np.array_equal(a.users, c.users)
    key = a.users.astype(np.int64) * test.num_items + a.items
    full = test.users.astype(np.int64) * test.num_items + test.items
    assert np.isin(key, full).all()


def _row_witness_model(biased, loss="RMSE"):
    from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    name = "BiasedMatrixFactorization" if biased else "MatrixFactorization"
    opts = "num_factors=6 num_iter=4 learn_rate_decay=0.9 device=cpu"
    if biased:
        opts += f" loss={loss}"
    m = create_rating_predictor(name, opts)
    m.ratings = synthetic_ratings(200, 150, 6000, seed=3)
    m.train()
    return m


@pytest.mark.parametrize("case", [(True, "RMSE"), (True, "MAE"),
                                  (True, "LogisticLoss"), (False, "RMSE")],
                         ids=["biased-rmse", "biased-mae", "biased-logistic",
                              "plain"])
def test_row_witness_holds_learn_row_and_catches_a_perturbed_row(case):
    """The step-by-step float64 witness of phase 22 (numpy, apart from
    ``learn_row``) agrees with ``learn_row`` on the CPU, for both sides,
    and catches a learner that moves one entry of the row by 1e-3 and
    one that takes no step."""
    from mymedialite_tpu_torch.models.mf import learn_row
    smoke = _smoke_module()
    m = _row_witness_model(*case)
    for side, row_id in (("user", 3), ("item", 5)):
        err, n = smoke.model_row_witness(m, side, row_id)
        assert n > 0 and err <= 1e-6, (side, err)

    def perturbed(row, *a, **kw):
        out = learn_row(row, *a, **kw).clone()
        out[0] += 1e-3
        return out
    err, _ = smoke.model_row_witness(m, "user", 3, learner=perturbed)
    assert err > smoke.ROW_TOL
    for side, row_id in (("user", 3), ("item", 5)):
        err, _ = smoke.model_row_witness(m, side, row_id,
                                         learner=smoke.returns_input)
        assert err > smoke.ROW_TOL, (side, err)


def test_incremental_phase_rehearses_on_the_cpu(monkeypatch, tmp_path,
                                                capsys):
    """Phase 22 end to end on CPU tensors at a small size, with the
    card's clock and synchronisation stood in for and the launch counts
    not held (the plain versions count none): every check of (a)-(f)
    runs and passes."""
    import contextlib
    from collections import defaultdict

    import torch

    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, split_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.models.registry import (
        create_item_recommender, create_rating_predictor,
    )
    smoke = _smoke_module()
    for name, fn in (("Event", _HostEvent), ("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, fn)

    @contextlib.contextmanager
    def uncounted(expected):
        yield defaultdict(int, expected)
    monkeypatch.setattr(smoke, "counted_path", uncounted)
    for name, value in (("ONLINE_EVENTS", 300), ("FOLDIN_USERS", 40),
                        ("FOLDIN_INCREMENTAL_USERS", 4),
                        ("ONLINE_ITEM_USERS", 30), ("WRMF_ONLINE_USERS", 8),
                        ("SVDPP_CALLS", 3), ("SVDPP_EVENTS", 16),
                        ("ML100K", dict(num_users=150, num_items=200,
                                        num_ratings=5000))):
        monkeypatch.setattr(smoke, name, value)
    dev = torch.device("cpu")
    train, test = split_ratings(synthetic_ratings(600, 300, 30_000, seed=1),
                                0.2, seed=2)
    fb, test_items = posonly_from_ratings(train), posonly_from_ratings(test)
    bpr = create_item_recommender("BPRMF", "num_factors=8 num_iter=2 "
                                  "device=cpu")
    bpr.feedback = fb
    bpr.train()
    wrmf = create_item_recommender("WRMF", "num_factors=8 num_iter=2 "
                                   "regularization=100 device=cpu")
    wrmf.feedback = posonly_from_ratings(train)
    wrmf.train()
    svdpp = create_rating_predictor("SVDPlusPlus", "num_factors=6 num_iter=2 "
                                    "learn_rate=0.003 device=cpu")
    svdpp.ratings = train
    svdpp.additional_feedback = (test.users, test.items)
    svdpp.train()
    smoke.phase_incremental(dev, train, test, (bpr, fb, test_items),
                            (wrmf, wrmf.feedback, test_items), svdpp,
                            str(tmp_path))
    out = capsys.readouterr().out
    for text in ("online BiasedMF, 300 events", "online refresh rows, 16",
                 "fold-in, 40 users", "fold-in rows, 16 users",
                 "online BPRMF, ", "pairwise step of user",
                 "online WRMF, 8 users", "online SVD++, 3 add_ratings",
                 "online CLI BPRMF", "phase 22 (incremental and online)"):
        assert text in out, text


def test_last_models_phase_rehearses_on_the_cpu(monkeypatch, tmp_path,
                                                capsys):
    """Phase 23 end to end on CPU tensors at a small size, with the
    card's clock and synchronisation stood in for and the launch counts
    not held (the plain versions count none): every check of (a)-(f)
    runs and passes, the float32 steps within 1e-5 of float64."""
    import contextlib
    from collections import defaultdict

    import torch

    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, split_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models.registry import (
        create_item_recommender, create_rating_predictor,
    )
    smoke = _smoke_module()
    for name, fn in (("Event", _HostEvent), ("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None),
                     ("reset_peak_memory_stats", lambda *a: None)):
        monkeypatch.setattr(torch.cuda, name, fn)

    @contextlib.contextmanager
    def uncounted(expected):
        yield defaultdict(int, expected)
    monkeypatch.setattr(smoke, "counted_path", uncounted)
    small = dict(num_users=300, num_items=200, num_ratings=12_000)
    for name, value in (
            ("TIME_AWARE_SHAPE", dict(small, seed=1)),
            ("TIME_AWARE_ITERS", {"TimeAwareBaseline": 3,
                                  "TimeAwareBaselineWithFrequencies": 3}),
            ("TIME_AWARE_BATCH", 2048),
            ("SOCIAL_SHAPES", {"ML-1M": (dict(small, seed=100), 60),
                               "Epinions": (dict(num_users=400,
                                                 num_items=900,
                                                 num_ratings=9000,
                                                 seed=120), 60)}),
            ("SOCIAL_OPTS", "num_factors=6 learn_rate=0.002 "
                            "social_regularization=0.5"),
            ("TRUST_ROWS", 64), ("SLIM_SWEEPS", 3), ("BPRSLIM_EPOCHS", 1),
            ("PHASE23_USERS", 64), ("EVAL_USERS", 100),
            ("TIMED_CLI_SHAPE", dict(small, seed=110))):
        monkeypatch.setattr(smoke, name, value)
    dev = torch.device("cpu")
    train, test = split_ratings(synthetic_ratings(**small, seed=1), 0.2,
                                seed=2)
    fb, test_items = posonly_from_ratings(train), posonly_from_ratings(test)
    mf = create_rating_predictor("BiasedMatrixFactorization",
                                 "num_factors=6 num_iter=2 device=cpu")
    mf.ratings = train
    mf.train()
    mf_run = {"test_predictions": mf.predict_batch(test.users, test.items),
              "test_rmse": evaluate_ratings(mf, test)["RMSE"]}
    bpr = create_item_recommender("BPRMF", "num_factors=8 num_iter=2 "
                                  "device=cpu")
    bpr.feedback = fb
    bpr.train()
    smoke.phase_last_models(dev, train, test, mf_run, (bpr, fb), fb,
                            test_items, str(tmp_path))
    files = []
    for name, part in (("train", train), ("test", test)):
        path = str(tmp_path / f"{name}.tsv")
        with open(path, "w") as f:
            f.writelines(f"{u}\t{i}\t{v:g}\n" for u, i, v in
                         zip(part.users, part.items, part.values))
        files += [f"--{name.replace('train', 'training')}-file", path]
    smoke.phase_last_clis(dev, str(tmp_path), files, list(files))
    out = capsys.readouterr().out
    for text in ("TimeAwareBaseline: ", "TimeAwareBaselineWithFrequencies: ",
                 "TimeAwareBaseline minibatch: float32 step",
                 "SocialMF ML-1M step: float32 step",
                 "SocialMF Epinions: init", "LeastSquareSLIM (200 items",
                 "BPRSLIM: init", "BPRSLIM batch: float32 step",
                 "MultiCoreBPRMF: one iterate()",
                 "ExternalRatingPredictor: ", "ExternalItemRecommender: top",
                 "--profile rating CLI", "phase 23 (a)-(e)",
                 "phase 23 (f)"):
        assert text in out, text
    assert list((tmp_path / "trace_rating").glob("*.pt.trace.json"))


def test_mesh_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """Phase 24 end to end on CPU tensors at small sizes, on a rig of
    ``["cpu"] * D``, with the card's clock and synchronisation stood in
    for and the launch counts not held (the plain versions count none):
    (a) the four sharded epochs against their cells in turn and their
    plain versions (the MAE rows under the witnesses), every variant on
    4 devices, with save -> load on both sharded routes; (b) the models
    on the sharded route; (c) on the sharded-tiled route, the bounds
    lowered so that a 5,000-item catalog takes it; in (b) and (c) each
    model's kernel against its plain version on chunks drawn across its
    cells, and its gathered tables against its shards."""
    import contextlib
    from collections import defaultdict

    import torch

    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, split_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.ops import plan as tplan
    smoke = _smoke_module()
    for name, fn in (("Event", _HostEvent), ("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0)):
        monkeypatch.setattr(torch.cuda, name, fn)

    @contextlib.contextmanager
    def uncounted(expected):
        yield defaultdict(int, expected)
    monkeypatch.setattr(smoke, "counted_path", uncounted)
    monkeypatch.setattr(smoke, "MESH_CHECK_SHAPE", dict(
        num_users=300, num_items=3000, num_ratings=6000, seed=3))
    monkeypatch.setattr(smoke, "EVAL_USERS", 100)
    monkeypatch.setattr(smoke, "AUC_USERS", 100)
    monkeypatch.setattr(smoke, "MESH_BIG_EPOCHS", 1)
    dev = torch.device("cpu")
    worst = smoke.phase_mesh_kernel_check(dev)
    assert set(worst) == {"sgd_epoch", "sgd_epoch_tiled", "bpr_epoch",
                          "bpr_epoch_tiled"}
    assert all(0 <= e <= 1e-6 for e in worst.values()), worst

    train, test = split_ratings(synthetic_ratings(600, 300, 30_000, seed=1),
                                0.2, seed=2)
    fb, test_items = posonly_from_ratings(train), posonly_from_ratings(test)
    smoke.phase_mesh_netflix(
        dev, train, test, {"test_rmse": 0.9, "epoch_ms": 1.0},
        {"auc": 0.7, "epoch_ms": 1.0, "test": test_items}, fb)
    monkeypatch.setattr(tplan, "RESIDENT_ITEM_TABLE_BYTES", 256 * 1024)
    monkeypatch.setattr(tplan, "TILED_SLAB_BYTES", 256 * 1024)
    train, test = split_ratings(synthetic_ratings(300, 5000, 16_000, seed=7),
                                0.2, seed=2)
    assert tplan.select_schedule(5000, 40, 4) == "sharded-tiled"
    smoke.phase_mesh_big_catalog(dev, train, test,
                                 {"rmse": 1.0, "epoch_ms": 1.0},
                                 {"auc": 0.5, "epoch_ms": 1.0})
    out = capsys.readouterr().out
    for text in ("mesh sgd_epoch (4 devices", "mesh sgd_epoch (3 devices",
                 "mesh sgd_epoch_tiled (4 devices", "loss=1 biased=True: "
                 "one step at a time", "mesh bpr_epoch (4 devices",
                 "membership=bitmask", "mesh bpr_epoch_tiled (3 devices",
                 "(sharded): save -> load keeps",
                 "(sharded-tiled): save -> load keeps",
                 "mesh BiasedMF Netflix-shaped on the rig (sharded)",
                 "mesh BPRMF Netflix-shaped on the rig (sharded)",
                 "mesh MultiCoreBPRMF, one iterate() on the rig (sharded)",
                 "mesh BiasedMF big-catalog on the rig (sharded-tiled)",
                 "mesh BPRMF big-catalog on the rig (sharded-tiled)",
                 "phase 24 (a)", "phase 24 (b)", "phase 24 (c)"):
        assert text in out, text
    # (b) and (c): each model's kernel against its plain version across
    # its cells, its gathered tables against its shards
    for label in ("mesh BiasedMF Netflix-shaped", "mesh BPRMF Netflix-shaped",
                  "mesh BiasedMF big-catalog", "mesh BPRMF big-catalog"):
        assert f"{label}, " in out and "chunks drawn across its cells (" \
            in out.split(f"{label}, ", 1)[1].split("\n", 1)[0], label
        assert f"{label}: the gathered tables equal the rows picked out of " \
            "the shards" in out, label
    assert out.count("negatives identical; against its cells in turn") == 14


def test_mesh_phase_is_in_main_and_the_line_keeps_six_kernels():
    """Phase 24's three parts run from ``main`` (after phase 4, after
    phase 8 and after phase 20), and the kernels line still names the six
    kernels, each once: the mesh adds no kernel body."""
    import inspect
    smoke = _smoke_module()
    assert list(smoke.KERNELS) == ["sgd_epoch", "sgd_epoch_tiled",
                                   "bpr_epoch", "bpr_epoch_tiled",
                                   "svdpp_epoch", "catalog_topk"]
    main = inspect.getsource(smoke.main)
    order = [main.index(name) for name in (
        "phase_bpr_kernel_check(", "phase_mesh_kernel_check(",
        "phase_bpr_path(", "phase_mesh_netflix(", "phase_bpr_minibatch(",
        "phase_mesh_big_catalog(")]
    assert order == sorted(order)
    assert "24." in smoke.__doc__ and "phase 24" in smoke.__doc__


def test_plain_mesh_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """Phase 25 end to end on CPU tensors at small sizes, the rig a mesh
    of ``["cpu"] * 4``, with the card's clock stood in for and the launch
    counts not held: (a) each plain mesh op on the rig against the CPU
    mesh's, WRMF's sharded solves against one device's, the dry run;
    (d) the two driver processes on gloo, every route with plain cells
    at the driver's small shape, against the one-process run;
    (b) SVDPlusPlus and WRMF with ``model.mesh``, the user side against
    one device's solves, serving and the data-parallel eval; (c) the
    sharded minibatch BPR epoch with its window against the CPU."""
    import contextlib
    from collections import defaultdict

    import torch

    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, split_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    from mymedialite_tpu_torch.ops import topk as ttopk
    from mymedialite_tpu_torch.parallel import driver
    smoke = _smoke_module()
    for name, fn in (("Event", _HostEvent), ("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0)):
        monkeypatch.setattr(torch.cuda, name, fn)

    @contextlib.contextmanager
    def uncounted(expected):
        yield defaultdict(int, expected)
    monkeypatch.setattr(smoke, "counted_path", uncounted)
    monkeypatch.setattr(smoke, "MESH_CHECK_SHAPE", dict(
        num_users=300, num_items=400, num_ratings=6000, seed=3))
    monkeypatch.setattr(smoke, "EVAL_USERS", 100)
    monkeypatch.setattr(smoke, "AUC_USERS", 100)
    monkeypatch.setattr(smoke, "DRIVER_SHAPE", "small")
    monkeypatch.setattr(ttopk, "takes_topk_kernel", lambda *a, **k: True)
    monkeypatch.chdir(REPO)
    dev = torch.device("cpu")
    assert smoke.phase_plain_mesh_check(dev) > 0

    train, test = split_ratings(synthetic_ratings(1200, 300, 30_000, seed=1),
                                0.2, seed=2)
    svdpp = create_rating_predictor("SVDPlusPlus", "num_factors=20 "
                                    "num_iter=1 device=cpu")
    svdpp.ratings = train
    svdpp.train()
    smoke.phase_plain_mesh_netflix(dev, train, test, svdpp,
                                   posonly_from_ratings(train),
                                   posonly_from_ratings(test))
    train, test = split_ratings(synthetic_ratings(400, 5000, 16_000, seed=7),
                                0.2, seed=2)
    smoke.phase_plain_mesh_big_catalog(
        dev, posonly_from_ratings(train), posonly_from_ratings(test),
        {"auc": 0.5, "epoch_ms": 1.0})
    out = capsys.readouterr().out
    for text in ("sharded SVD++ epoch (", "WRMF sharded solves (",
                 "sharded BPR steps (", "sharded blocked MF epoch (",
                 "data-parallel ranking eval on the rig",
                 "dryrun paths ok: 1 sharded-blocked-SGD",
                 "two processes on gloo, each a mesh of [cpu] x 2: every "
                 "route's ranks equal bit for bit",
                 *(f"each a mesh of [cpu] x 2 (cpu), route {r}: ranks equal "
                   "bit for bit True" for r in driver.ROUTES),
                 "mesh SVDPlusPlus Netflix-shaped on the rig (sharded "
                 "grouped epoch)", "mesh WRMF user side (",
                 "mesh WRMF serving: top-10 of 1024 users",
                 "mesh WRMF data-parallel ranking eval of 100 users",
                 "big-catalog sharded BPR: the first 8 steps",
                 "big-catalog sharded minibatch BPR on the rig",
                 "phase 25 (a), (d)", "phase 25 (b)", "phase 25 (c)"):
        assert text in out, text


def test_plain_mesh_phase_is_in_main():
    """Phase 25's parts run from ``main``: (a) and (d) after phase 24 (a),
    (b) after the WRMF serving pass, (c) after phase 24 (c); its seconds
    are logged."""
    import inspect
    smoke = _smoke_module()
    main = inspect.getsource(smoke.main)
    order = [main.index(name) for name in (
        "phase_mesh_kernel_check(", "phase_plain_mesh_check(",
        "phase_wrmf_path(", "phase_plain_mesh_netflix(",
        "phase_mesh_big_catalog(", "phase_plain_mesh_big_catalog(")]
    assert order == sorted(order)
    assert "phase 25 (the plain mesh routes)" in main
    assert "25." in smoke.__doc__


def test_default_mesh_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """Phase 26 end to end on CPU tensors at small sizes, with the card's
    clock stood in for and the launch counts not held: (a) with no card
    the resolver gives None and every site keeps its one-device route;
    (b) the default pointed at a rig of ``["cpu"] * 4``: BiasedMF, BPRMF
    and MultiCoreBPRMF on "sharded", BiasedMF and BPRMF on
    "sharded-tiled" (the bounds lowered so that a 13,000-item catalog
    takes it), each beside the explicit mesh and held to its plain
    version, SVDPlusPlus and WRMF beside the explicit mesh, the eval's
    line equal on the default, the explicit mesh and one device."""
    import contextlib
    from collections import defaultdict

    import torch

    from mymedialite_tpu_torch.ops import plan as tplan
    smoke = _smoke_module()
    for name, fn in (("Event", _HostEvent), ("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0)):
        monkeypatch.setattr(torch.cuda, name, fn)

    @contextlib.contextmanager
    def uncounted(expected):
        yield defaultdict(int, expected)
    monkeypatch.setattr(smoke, "counted_path", uncounted)
    monkeypatch.setattr(smoke, "MESH_CHECK_SHAPE", dict(
        num_users=300, num_items=3000, num_ratings=6000, seed=3))
    # three item blocks resident: phase 3's 3,000 items stay resident on
    # one device; 13,000 items make partitions of four blocks on 4
    # devices, streamed in one-block slabs
    monkeypatch.setattr(smoke, "DEFAULT_BIG_ITEMS", 13_000)
    monkeypatch.setattr(tplan, "RESIDENT_ITEM_TABLE_BYTES", 3 * 256 * 1024)
    monkeypatch.setattr(tplan, "TILED_SLAB_BYTES", 256 * 1024)
    worst, seconds = smoke.phase_default_mesh(torch.device("cpu"))
    assert set(worst) == {"sgd_epoch", "sgd_epoch_tiled", "bpr_epoch",
                          "bpr_epoch_tiled"}
    assert all(0 <= e <= 1e-6 for e in worst.values()), worst
    assert seconds > 0
    out = capsys.readouterr().out
    for text in ("default mesh (a), one card: the resolver gives None; "
                 "BiasedMatrixFactorization resident (sgd_epoch once); "
                 "BPRMF resident (bpr_epoch once); MultiCoreBPRMF resident "
                 "(bpr_epoch once); SVDPlusPlus kernel (svdpp_epoch once); "
                 "WRMF one device; BPRMF's ranking eval one device",
                 *(f"default {name} {what}: the default resolves to Mesh("
                   for name, what in (
                       ("BiasedMatrixFactorization", "phase 3's shape"),
                       ("BPRMF", "phase 3's shape"),
                       ("MultiCoreBPRMF", "phase 3's shape"),
                       ("BiasedMatrixFactorization", "13,000 items"),
                       ("BPRMF", "13,000 items"))),
                 "(default mesh) on the rig (sharded)",
                 "(explicit mesh) on the rig (sharded-tiled)",
                 "default SVDPlusPlus (sharded grouped epoch",
                 "default WRMF (sharded solves on 4 devices",
                 "split over 4 devices", "equal bit for bit to the explicit "
                 "mesh's and to one device's", "phase 26 (the default mesh)"):
        assert text in out, text
    assert out.count("chunks drawn across its cells (") == 5


def test_default_mesh_phase_is_in_main():
    """Phase 26 runs from ``main`` after phase 25 (a); the phases before it
    run with the default pointed at the one card; its seconds are
    logged; the script imports nothing of the JAX package."""
    import inspect
    smoke = _smoke_module()
    main = inspect.getsource(smoke.main)
    order = [main.index(name) for name in (
        "default_devices([", "phase_kernel_check(", "phase_plain_mesh_check(",
        "phase_default_mesh(", "phase_mf_path(")]
    assert order == sorted(order)
    assert "phase 26 (the default mesh)" in main
    assert "26." in smoke.__doc__
    assert "CUDA_VISIBLE_DEVICES" in inspect.getsource(smoke.one_card_env)
    bad = [m for m in _imported_modules(SMOKE)
           if m.split(".")[0] in ("jax", "jaxlib", "mymedialite_tpu")]
    assert not bad, bad


def test_quality_phase_and_blocked_repeat_rehearse_on_the_cpu(
        monkeypatch, tmp_path, capsys):
    """Phase 27 (the quality driver at --small, a few of its rows, the
    card's launches not held: on the CPU the wrappers count none), the
    blocked MF phase with its repeated run of one seed (tables equal bit
    for bit), and the CSR builds held to the lexsort, on CPU tensors
    with the card's clock and synchronisation stood in for."""
    import contextlib

    import torch

    from mymedialite_tpu_torch import quality
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, split_ratings, synthetic_ratings,
    )
    smoke = _smoke_module()
    for name, fn in (("Event", _HostEvent), ("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(smoke, "GROUP_PREFIX", 2)
    monkeypatch.setattr(smoke, "PREFIX_BATCH", 256)
    dev = torch.device("cpu")
    train, test = split_ratings(synthetic_ratings(3000, 300, 60_000, seed=1),
                                0.2, seed=2)
    out = smoke.phase_mf_blocked(
        dev, train, test, "frequency regularization",
        "frequency_regularization=true batch_size=1024", repeat=True)
    assert out["repeat_s"] > 0
    counting_s, lexsort_s = smoke.csr_builds(posonly_from_ratings(train),
                                             posonly_from_ratings(test))
    assert counting_s >= 0 and lexsort_s > 0

    monkeypatch.setattr(smoke, "counted_path",
                        lambda expected: contextlib.nullcontext({}))
    monkeypatch.setattr(smoke, "QUALITY_KERNELS", {
        name: (route, None) for name, (route, _)
        in smoke.QUALITY_KERNELS.items()})
    monkeypatch.setattr(quality, "RATING_CONFIGS", [
        ("GlobalAverage", ""),
        ("BiasedMatrixFactorization", "num_factors=8 num_iter=10"),
        ("SVDPlusPlus", "num_factors=8 num_iter=10 learn_rate=0.01"),
        ("ItemKNN", "k=40")])
    monkeypatch.setattr(quality, "TIME_AWARE_CONFIGS", [
        ("UserItemBaseline", ""), ("TimeAwareBaseline", "num_iter=5")])
    monkeypatch.setattr(quality, "ITEM_CONFIGS", [
        ("Random", ""), ("MostPopular", ""),
        ("BPRMF", "num_factors=8 num_iter=10"),
        ("LeastSquareSLIM", "num_iter=10 reg_l1=0.0001 k=100")])
    assert smoke.phase_quality(dev, str(tmp_path)) > 0
    log = capsys.readouterr().out
    assert "the same seed again" in log and "equal bit for bit" in log
    assert "the lexsort it replaced" in log and "equal arrays" in log
    assert "phase 27 (the quality driver, --small, one seed): 10 rows" in log
    assert "reported, not held: LeastSquareSLIM AUC" in log
