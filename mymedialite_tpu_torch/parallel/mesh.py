"""The device mesh of the port: one controller driving an ordered list of
devices.

Counterpart of ``mymedialite_tpu/parallel/mesh.py:18-47`` and ``:130-143``
(``make_mesh``, ``pad_rows_to_multiple``, ``shard_mf_params``). The JAX
package's mesh is one controller too: ``shard_map`` over a ``Mesh``,
whose tests run an 8-device virtual CPU mesh in one process. Here a
``Mesh`` is an ordered list of ``torch.device``s; a sharded epoch
(``ops/sgd_epoch.py sgd_epoch_sharded``, ``ops/bpr_epoch.py
bpr_epoch_sharded``) is a Python loop over sub-epochs and devices that
enqueues each device's work on that device's current stream and moves a
table between devices with ``tensor.to``, a peer-to-peer copy between
distinct cards. A list may name one device more than once: ``["cpu"] *
8`` is the CPU tests' counterpart of the virtual mesh, ``["cuda:0"] *
4`` a one-card rig whose cells run one after another.

Each device holds a contiguous block of rows of a row-sharded table
(``shard_rows``); ``gather_rows`` puts the blocks back together on one
device. The multi-host functions of the JAX module (``:69-127``) are not
ported yet (ROADMAP A9b).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

log = logging.getLogger("mymedialite_tpu_torch")


class Mesh:
    """An ordered list of devices; position d is mesh device d."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"

    def replicate(self, t) -> list:
        """One copy of ``t`` on each mesh device (``t`` itself where it
        already lies there); a device listed twice shares one copy. A
        list of copies (an earlier call's result) is returned as it is,
        so that callers can keep the copies across epochs."""
        if isinstance(t, (list, tuple)):
            return list(t)
        copies = {}
        for d in self.devices:
            if d not in copies:
                copies[d] = t.to(d)
        return [copies[d] for d in self.devices]

    def shard_rows(self, t: torch.Tensor) -> list:
        """Rows of ``t`` in D contiguous blocks, block d on mesh device d
        (``shard_mf_params``): a view of ``t`` where the device is t's own
        and D divides its rows, else of ``t`` padded with zero rows to a
        multiple of D (``pad_rows_to_multiple``; the plans pad their
        tables to whole shards themselves)."""
        D = self.size
        if t.shape[0] % D:
            t = torch.from_numpy(pad_rows_to_multiple(
                t.detach().cpu().numpy(), D)).to(t.device)
        n = t.shape[0] // D
        return [t[d * n:(d + 1) * n].to(dev)
                for d, dev in enumerate(self.devices)]

    def gather_rows(self, shards, device=None) -> torch.Tensor:
        """The row blocks ``shards`` concatenated in mesh order on
        ``device`` (the first mesh device by default)."""
        device = self.devices[0] if device is None else torch.device(device)
        return torch.cat([s.to(device) for s in shards])


def diagonal_epoch(mesh: Mesh, H_parts, order, counts, run_cell) -> list:
    """One epoch of Gemulla's DSGD diagonal over the mesh (the loop of
    ``pallas_sgd.sgd_epoch_mxu_sharded``'s ``shard_map``): D sub-epochs;
    at sub-epoch k mesh device d calls ``run_cell(d, k, H, cols)`` on
    the item partition H = (d + k) % D that it holds, then every
    partition moves one step around the ring, device d receiving device
    d + 1's (the JAX package's ppermute pairs ((i + 1) % D, i)), so that
    after D sub-epochs each is home again. Within a sub-epoch the cells
    touch disjoint user rows and disjoint partitions, so on distinct
    cards they run at once, each on its device's current stream.

    ``H_parts[p]`` is partition p on mesh device p; ``order`` the
    [D, D, nc_pad] columns of the epoch order (numpy or tensors) and
    ``counts`` [D, D] the real chunks of each cell. Each device's rows
    of ``order`` go to it once, before any cell runs, and ``cols`` holds
    views of the cell's real entries there. A cell without chunks is
    skipped. Returns the partitions, home again, in partition order."""
    D = mesh.size
    cols = [tuple(torch.as_tensor(np.ascontiguousarray(a[d])).to(dev)
                  for a in order) for d, dev in enumerate(mesh.devices)]
    held = list(H_parts)
    for k in range(D):
        for d in range(D):
            n = int(counts[d][k])
            if n:
                run_cell(d, k, held[d], tuple(c[k, :n] for c in cols[d]))
        held = [held[(d + 1) % D].to(dev) for d, dev in enumerate(mesh.devices)]
    return held


def make_mesh(num_devices: int = None, devices=None) -> Mesh:
    """A mesh over ``devices``, or over the first ``num_devices`` visible
    CUDA cards (all of them by default: the JAX package's default of all
    devices)."""
    if devices is not None:
        devices = list(devices)
        if num_devices is not None:
            devices = devices[:num_devices]
        return Mesh(devices)
    count = torch.cuda.device_count()
    n = count if num_devices is None else num_devices
    if n < 1 or n > count:
        raise ValueError(f"requested {n} CUDA devices, have {count}")
    return Mesh([f"cuda:{i}" for i in range(n)])


def model_mesh(model) -> Mesh | None:
    """The mesh a model trains on: its ``mesh`` attribute where that
    spans more than one device, else None (one device). A model trains
    on a mesh only where one is set (``model.mesh = make_mesh()`` for
    every visible card): the JAX package's default of all devices waits
    for a run across distinct cards (ROADMAP A9b)."""
    mesh = getattr(model, "mesh", None)
    return mesh if mesh is not None and mesh.size > 1 else None


def one_device_route(model, route: str, mesh: Mesh):
    """Log that ``model`` takes its one-device ``route`` on a mesh: the
    route's sharded form is not ported (ROADMAP A9b)."""
    log.warning("%s: the %s route has no sharded form in the port; it runs "
             "on one device, not on the %d-device mesh",
             type(model).__name__, route, mesh.size)


def pad_rows_to_multiple(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Pad dim 0 with zero rows to a multiple of ``multiple`` (copy of
    ``mymedialite_tpu/parallel/mesh.py pad_rows_to_multiple``)."""
    n = arr.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr
    pad_shape = (target - n,) + arr.shape[1:]
    return np.concatenate([arr, np.zeros(pad_shape, dtype=arr.dtype)], axis=0)
