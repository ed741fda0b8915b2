"""A multi-process run of the sharded blocked MF epoch on
``torch.distributed`` (the port's counterpart of the JAX package's
two-process driver).

    python -m mymedialite_tpu_torch.parallel.driver MODE PORT PID OUT
        [--device cuda:0|own|cpu]

MODE ``dist``: one of two cooperating processes, 2 mesh devices each (a
4-device global mesh), through the multi-host functions of
``parallel/mesh.py``: ``initialize_distributed`` (from the
``JAX_COORDINATOR`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
variables this module sets from PORT and PID) -> ``make_global_mesh`` ->
``host_local_rows`` -> ``shard_host_local`` -> one
``sgd_epoch_blocked_sharded`` step, its merges summed across the
processes -> the user table gathered on the host -> OUT (``.npy``: W
then H, flattened). MODE ``single``: the one-process 4-device run on the
same data. ``--device``: the mesh devices, ``cuda:0`` (the default;
both processes on one card: gloo, since NCCL refuses two ranks on one
card), ``own`` (card PID for process PID: NCCL) or ``cpu`` (gloo).
Asking for a card where there is none raises. Prints ``driver-ok MODE
PID`` at the end.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_data():
    """The data of ``tests/distributed_driver.py``: one user group of 8
    per global device."""
    rng = np.random.default_rng(0)
    G = 8
    U = G * 4
    I = 48
    n = 256
    users = rng.integers(0, U, n).astype(np.int32)
    items = rng.integers(0, I, n).astype(np.int32)
    values = rng.uniform(1, 5, n).astype(np.float32)
    return G, U, I, users, items, values


def run(mode: str, port: int, pid: int, out_path: str, device: str):
    from mymedialite_tpu_torch.device import resolve_device
    from mymedialite_tpu_torch.ops import sgd
    from mymedialite_tpu_torch.parallel.mesh import (
        gather_global_rows, host_local_rows, initialize_distributed,
        make_global_mesh, shard_host_local,
    )
    n_local = 2 if mode == "dist" else 4
    if mode == "dist":
        os.environ["JAX_COORDINATOR"] = f"localhost:{port}"
        os.environ["JAX_NUM_PROCESSES"] = "2"
        os.environ["JAX_PROCESS_ID"] = str(pid)
    backend = "nccl" if device == "own" else "gloo"
    dev = resolve_device(f"cuda:{pid}" if device == "own" else device)
    inited = initialize_distributed(backend=backend)
    assert inited is (mode == "dist"), (inited, mode)
    mesh = make_global_mesh(devices=[dev] * n_local)
    assert mesh.global_size == 4, mesh

    G, U, I, users, items, values = build_data()
    data, meta = sgd.prepare_blocked_data(users, items, values, U,
                                          batch_size=32, group_users=G,
                                          shuffle_seed=0)
    rng = np.random.default_rng(1)
    W, H = sgd.extend_tables(
        0.1 * rng.standard_normal((U, 6)).astype(np.float32),
        0.1 * rng.standard_normal((I, 6)).astype(np.float32),
        group_users=G)
    # every process loads only its rows of the group axis and of W
    lo, hi = host_local_rows(meta["ngroups"])
    local = {k: v[lo:hi] for k, v in data.items()}
    wlo, whi = host_local_rows(W.shape[0])
    W_sh = shard_host_local(mesh, W[wlo:whi].numpy())
    H_dev = H.to(mesh.devices[0])
    gl = meta["ngroups"] // mesh.global_size
    nb = meta["l_pad"] // meta["batch"]
    orders = np.stack([np.random.default_rng(2 + g).permutation(nb)
                       for g in range(gl)])
    rates = sgd.column_rates(6, 0.01, 0.015, 0.015, 1.0, 0.01, True, True,
                             True, device=mesh.devices[0])
    sgd.sgd_epoch_blocked_sharded(
        mesh, W_sh, H_dev, local, orders, (0.0, 1.0, 4.0), rates,
        meta=meta, loss=sgd.LOSS_RMSE, biased=True)
    W_full = gather_global_rows(mesh, W_sh).numpy()
    np.save(out_path, np.concatenate([W_full.ravel(),
                                      H_dev.cpu().numpy().ravel()]))
    if inited:
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    print("driver-ok", mode, pid, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["dist", "single"])
    ap.add_argument("port", type=int)
    ap.add_argument("pid", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda:0")
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    run(a.mode, a.port, a.pid, a.out, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
