"""``chip_smoke.py`` on a machine without a CUDA card: it imports nothing
of jax or of the JAX package, it names every kernel source of the port
in its kernels line, and without a card (or alone, outside the
repository) it exits non-zero and prints no result line."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

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
    assert sources == ["bpr_epoch.cu", "sgd_epoch.cu", "svdpp_epoch.cu"]
    for src in sources:
        assert f'"mymedialite_tpu_torch/csrc/{src}"' in text, src
    for replaced in ("mymedialite_tpu/ops/pallas_sgd.py:324",
                     "mymedialite_tpu/ops/pallas_sgd.py:745",
                     "mymedialite_tpu/ops/pallas_bpr.py:451",
                     "mymedialite_tpu/ops/pallas_bpr.py:979",
                     "mymedialite_tpu/ops/pallas_svdpp.py:308"):
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
