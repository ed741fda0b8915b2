"""Every mesh route of the port across processes: two gloo processes of
2 CPU "devices" each (``python -m mymedialite_tpu_torch.parallel.driver
dist``, one global mesh of 4) against the one-process 4-device run
(``single``) of the same routes.

For each route the two processes' outputs agree bit for bit and agree
with the one-process run to 1e-6: the blocked MF epoch, kernels 1-4's
sharded epochs (plain cells on the CPU, the partitions passed between
the processes), BiasedMatrixFactorization and BPRMF through ``train()``
on their sharded routes (the repair of the local-only diagonal: before
it each process planned a 2-device diagonal over its own devices and
trained its own copy, silently), BiasedMatrixFactorization on the default
mesh, which resolves to the global mesh and gives the explicit global
mesh's tables bit for bit, SVDPlusPlus sharded, WRMF, the sharded
minibatch BPR epoch, the data-parallel ranking eval and the flat
epoch. The existing ``test_torch_mesh_*.py`` / ``test_torch_sharded*.py``
hold the one-process run to the JAX package.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from mymedialite_tpu_torch.parallel import driver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks and the one-process run, started together once:
    (rank outputs, single output, the ranks' logs)."""
    tmp = tmp_path_factory.mktemp("routes")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JAX_") and k != "XLA_FLAGS"}
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if "PYTHONPATH" in env else "")
    port = free_port()
    cmd = [sys.executable, "-m", "mymedialite_tpu_torch.parallel.driver"]
    argvs = [["dist", str(port), str(i), str(tmp / f"p{i}.npz")]
             for i in range(2)] + [["single", str(port), "0",
                                    str(tmp / "ref.npz")]]
    procs = [subprocess.Popen(cmd + a + ["--device", "cpu"], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for a in argvs]
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for a, p, text in zip(argvs, procs, outs):
        assert p.returncode == 0, f"{a[:3]} failed:\n{text[-3000:]}"
        assert f"driver-ok {a[0]} {a[2]}" in text
    ranks = [np.load(tmp / f"p{i}.npz") for i in range(2)]
    return ranks, np.load(tmp / "ref.npz"), outs[:2]


@pytest.mark.parametrize("route", driver.ROUTES)
def test_route_across_processes(runs, route):
    ranks, single, _ = runs
    equal, gap = driver.compare(ranks, single)[route]
    assert equal, f"{route}: the two processes disagree"
    assert gap <= 1e-6, f"{route}: {gap} from the one-process run"


@pytest.mark.parametrize("route", ["sgd_epoch", "sgd_epoch_tiled",
                                   "bpr_epoch", "bpr_epoch_tiled"])
def test_kernel_routes_split_the_cells(runs, route):
    """Each process runs its own devices' cells: the plan has empty and
    non-empty cells on both processes' devices, and every cell's
    negatives (BPR) come from the process that holds its device."""
    ranks, single, logs = runs
    cells = single[f"{route}/cells"]
    assert (cells[:2] > 0).any() and (cells[2:] > 0).any()
    assert (cells == 0).any()
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r[f"{route}/cells"], cells)
        assert f"route {route}:" in logs[i]
        own = {k for k in r.files if k.startswith(f"local/{route}/")}
        if route.startswith("bpr"):
            gs = {int(k.split("_g")[1].split("_")[0]) for k in own}
            assert gs == {2 * i, 2 * i + 1}
            assert len(own) == int((cells[2 * i:2 * i + 2] > 0).sum())
        else:
            assert not own


def test_ranking_result_on_every_process(runs):
    """Both processes rank every test user and hold one result."""
    ranks, single, _ = runs
    names = list(single["ranking/names"])
    for r in ranks:
        vals = dict(zip(r["ranking/names"], r["ranking/values"]))
        assert vals["num_users"] == dict(zip(
            names, single["ranking/values"]))["num_users"]
        assert 0.5 < vals["AUC"] <= 1.0


def test_default_is_the_global_mesh(runs):
    """On each process BiasedMatrixFactorization left at the default mesh
    (resolved to the global mesh, asserted in the route) gives the
    explicit global mesh's tables and predictions bit for bit."""
    ranks, single, _ = runs
    for r in ranks + [single]:
        for key in ("W", "H", "predictions"):
            np.testing.assert_array_equal(r[f"mf_default/{key}"],
                                          r[f"mf_train/{key}"])
