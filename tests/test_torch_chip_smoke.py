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
    assert sources == ["bpr_epoch.cu", "sgd_epoch.cu"]
    for src in sources:
        assert f'"mymedialite_tpu_torch/csrc/{src}"' in text, src
    for replaced in ("mymedialite_tpu/ops/pallas_sgd.py:324",
                     "mymedialite_tpu/ops/pallas_sgd.py:745",
                     "mymedialite_tpu/ops/pallas_bpr.py:451",
                     "mymedialite_tpu/ops/pallas_bpr.py:979"):
        assert f'"{replaced}"' in text
        path, line = replaced.split(":")
        with open(os.path.join(REPO, path)) as f:
            assert f.read().splitlines()[int(line) - 1].startswith("def _mxu_")
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert f"{key}=" in text, key


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
