"""Multi-process runs of the port on ``torch.distributed`` and its dry
run.

The counterpart of ``tests/test_partitioning.py::TestTwoProcessDistributed``:
two processes of 2 CPU "devices" each (``python -m
mymedialite_tpu_torch.parallel.driver dist``, gloo) run every mesh
route over a 4-device global mesh; they agree bit for bit and agree
with the one-process 4-device run to 1e-6
(``test_torch_distributed_routes.py`` holds each route on its own). On
a machine with two cards the same run goes over NCCL, one card a
process (``own``). The multi-host functions fall back to one process;
``dryrun.py`` runs its paths on CPU meshes of 2, 4 and 8, and its
``entry()`` equals the JAX package's.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mymedialite_tpu_torch import dryrun
from mymedialite_tpu_torch.parallel import mesh as tmesh
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def driver_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JAX_") and k != "XLA_FLAGS"}
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if "PYTHONPATH" in env else "")
    return env


def two_processes(tmp_path, device: str):
    port = free_port()
    env = driver_env()
    cmd = [sys.executable, "-m", "mymedialite_tpu_torch.parallel.driver"]
    procs = [subprocess.Popen(
        cmd + ["dist", str(port), str(i), str(tmp_path / f"p{i}.npz"),
               "--device", device],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"process {i} failed:\n{outs[i]}"
        assert f"driver-ok dist {i}" in outs[i]
    ref = subprocess.run(cmd + ["single", str(port), "0",
                                str(tmp_path / "ref.npz"), "--device",
                                "cpu" if device == "cpu" else "cuda:0"],
                         cwd=ROOT, env=env, capture_output=True, timeout=200)
    assert ref.returncode == 0, ref.stderr.decode()[-2000:]
    return [np.load(tmp_path / n) for n in ("p0.npz", "p1.npz", "ref.npz")]


def check_routes(a, b, r, tol, exact=()):
    """Every route: the ranks equal bit for bit, within ``tol`` of one
    process (1e-6 for the routes in ``exact``)."""
    from mymedialite_tpu_torch.parallel.driver import ROUTES, compare
    result = compare([a, b], r)
    assert sorted(result) == sorted(ROUTES)
    for route, (equal, gap) in result.items():
        assert equal, f"{route}: the processes disagree"
        limit = 1e-6 if route in exact else tol
        assert gap <= limit, f"{route}: {gap} from one process"


def test_two_process_matches_single(tmp_path):
    a, b, r = two_processes(tmp_path, "cpu")
    check_routes(a, b, r, 1e-6)
    # every process holds the whole tables
    from mymedialite_tpu_torch.parallel.driver import SHAPES
    U, I = SHAPES["small"]["num_users"], SHAPES["small"]["num_items"]
    assert a["blocked/W"].shape[0] == U and a["blocked/H"].shape[0] == I
    assert np.isfinite(a["blocked/W"]).all()


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available()
                    or torch.cuda.device_count() < 2,
                    reason="needs two CUDA cards (NCCL refuses two ranks "
                    "on one card)")
def test_two_process_nccl_on_distinct_cards(tmp_path):
    a, b, r = two_processes(tmp_path, "own")
    # kernels 1-4's float atomics fix no order of a sum; the blocked epoch
    # and WRMF's solves are held as on the CPU
    check_routes(a, b, r, 1e-5, exact=("blocked", "wrmf"))


def test_multi_host_functions_in_one_process(monkeypatch):
    for k in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.initialize_distributed() is False
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    # no coordinator: still one process
    assert tmesh.initialize_distributed() is False
    m = tmesh.make_global_mesh(devices=["cpu"] * 3)
    assert (m.size, m.global_size, m.process_index, m.first_device) == \
        (3, 3, 0, 0)
    assert tmesh.host_local_rows(10) == (0, 10)
    assert tmesh.host_local_rows(10, process_id=1, num_processes=3) == (4, 8)
    assert tmesh.host_local_rows(10, process_id=2, num_processes=3) == \
        (8, 10)
    rows = np.arange(18, dtype=np.float32).reshape(6, 3)
    shards = tmesh.shard_host_local(m, rows)
    assert [s.shape[0] for s in shards] == [2, 2, 2]
    np.testing.assert_array_equal(tmesh.gather_global_rows(m, shards), rows)
    params = tmesh.shard_mf_params(dict(
        user_factors=np.ones((7, 2), np.float32), global_bias=0.5), m)
    assert [s.shape[0] for s in params["user_factors"]] == [3, 3, 3]
    assert len(params["global_bias"]) == 3
    assert float(params["global_bias"][0]) == 0.5


def test_merges():
    """``merge_deltas``: start + the sum of the copies' deltas;
    ``merge_rows``: each distinct copy gets every device's touched rows,
    once (a repeated device shares one copy)."""
    m = tmesh.make_mesh(devices=["cpu"] * 3)
    start = torch.zeros(4)
    copies = [start + torch.tensor([1.0, 0, 0, 0]),
              start + torch.tensor([0, 2.0, 0, 0]),
              start + torch.tensor([0, 0, 0, 3.0])]
    merged = m.merge_deltas(start, copies)
    assert all(t is merged[0] for t in merged)
    assert merged[0].tolist() == [1.0, 2.0, 0.0, 3.0]
    reps = m.replicate(torch.zeros(4))
    out = m.merge_rows(reps, [(torch.tensor([0, 1]), torch.tensor([1., 1.])),
                              (torch.tensor([1]), torch.tensor([2.]))])
    assert out[0].tolist() == [1.0, 3.0, 0.0, 0.0]


def test_default_partition(monkeypatch):
    """Without devices each process drives its own block of the host's
    cards (by ``LOCAL_RANK`` of ``LOCAL_WORLD_SIZE``, else its rank of
    the world), and the default backend is NCCL only where every process
    of the host gets a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.local_devices() == [f"cuda:{i}" for i in range(4)]
    assert tmesh.make_global_mesh().devices == \
        tmesh.make_mesh().devices
    assert tmesh.local_devices(1, 2) == ["cuda:2", "cuda:3"]
    assert tmesh.local_devices(2, 4) == ["cuda:2"]
    assert tmesh.local_devices(1, 3) == ["cuda:1"]
    assert tmesh.default_backend(1, 2) == "nccl"
    assert tmesh.default_backend(1, 8) == "gloo"
    with pytest.raises(ValueError, match="pass each process its devices"):
        tmesh.local_devices(5, 8)
    # one process a host, on two hosts: each gets all its host's cards
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert tmesh.local_devices(1, 2) == [f"cuda:{i}" for i in range(4)]
    assert tmesh.default_backend(1, 8) == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmesh.default_backend(1, 2) == "gloo"


def test_entry_points_ask_for_the_card(monkeypatch, tmp_path):
    """The dry run and the driver run on the card unless the CPU is
    named: without one they raise rather than fall back."""
    from mymedialite_tpu_torch.parallel import driver
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="device=cpu"):
        dryrun.main(["2"])
    with pytest.raises(RuntimeError, match="device=cpu"):
        driver.main(["single", "0", "0", str(tmp_path / "r.npz")])
    fn, args = dryrun.entry("cpu")
    assert fn(*args).device.type == "cpu"


def test_entry_equals_jax():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as jentry
    fn, args = dryrun.entry("cpu")
    jfn, jargs = jentry.entry()
    np.testing.assert_allclose(fn(*args).numpy(), np.asarray(jfn(*jargs)),
                               atol=1e-6)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_dryrun_on_cpu_meshes(D, capsys):
    dryrun.dryrun_multichip(D, ["cpu"] * D)
    out = capsys.readouterr().out
    assert "dryrun paths ok: 1 sharded-blocked-SGD, 2 flat-SPMD-SGD" in out
    assert "12 model-sharded-tiled-BPR" in out
    # the forced route is restored after the run
    from mymedialite_tpu_torch.ops import plan
    assert plan.select_schedule(100, 4, D) == "sharded"
