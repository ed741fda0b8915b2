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
device. A replicated table that every device updates within a step is
merged as the JAX package's ``start + psum(table - start)``:
``merge_deltas`` sums whole-table deltas, ``merge_rows`` the touched
rows only (``index_add_``), so that a large table is never differenced
whole per minibatch. A device never updates its replica in place
(``replicate`` shares one copy among the entries of a repeated device):
it works on a private copy or on deltas against the start.

The multi-host functions (JAX ``:69-143``) run on ``torch.distributed``:
``initialize_distributed`` reads the same ``JAX_COORDINATOR``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` variables, and a mesh of
several processes (``make_global_mesh``) is one global mesh of
``global_size`` devices, this process driving ``size`` of them, global
devices [``first_device``, ``first_device + size``). Plans, orders,
random bits and CDF rows are indexed by the global device; ``size`` is
only the bound of a process's loop over its devices. Every route runs
across the processes as the JAX package's ``shard_map`` routes run
across hosts: ``shard_rows`` keeps this process's blocks of a whole
table and ``gather_rows`` gathers every process's (JAX
``process_allgather``); ``merge_deltas`` sums over the local devices,
then across the processes (``all_reduce``); ``merge_rows`` all-gathers
the touched rows and adds them in global device order; the diagonal's
ring (``diagonal_epoch``) passes a partition to the previous process
with ``isend`` / ``irecv``. Every process calls every collective in the
same order, also where it has no work. By default a process drives its
share of its host's cards (``local_devices``: the cards split by
``LOCAL_RANK``), so that no two ranks drive one card, and the backend is
NCCL where that share is not empty, gloo otherwise (NCCL refuses two
ranks on one card; gloo moves only host tensors, so a CUDA tensor goes
through the host).

A model's ``mesh`` starts at ``DEFAULT_MESH``, the JAX package's default
of all devices: ``model_mesh`` resolves it through ``default_mesh`` each
time the model plans, to the global mesh across processes, else to every
visible card, else to None (one device). ``default_devices`` points the
default at other devices for a block (tests, the one-card rig).
"""

from __future__ import annotations

import contextlib
import logging
import os

import numpy as np
import torch

log = logging.getLogger("mymedialite_tpu_torch")


class Mesh:
    """An ordered list of devices; position d is mesh device d."""

    def __init__(self, devices, process_index: int = 0,
                 process_count: int = 1):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.process_index = process_index
        self.process_count = process_count

    @property
    def size(self) -> int:
        """This process's devices: the bound of its loop over them
        (``global_size`` sizes plans)."""
        return len(self.devices)

    @property
    def global_size(self) -> int:
        """The devices of every process (each holds ``size``)."""
        return self.size * self.process_count

    @property
    def first_device(self) -> int:
        """The global index of this process's first device: local device
        d is global device ``first_device + d``."""
        return self.process_index * self.size

    def __repr__(self):
        procs = (f", process {self.process_index} of {self.process_count}"
                 if self.process_count > 1 else "")
        return f"Mesh({[str(d) for d in self.devices]}{procs})"

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the process group carries it: a host tensor under
        gloo (which moves only host tensors), a CUDA tensor under NCCL."""
        import torch.distributed as dist
        if dist.get_backend() == "nccl":
            if t.device.type != "cuda":
                t = t.to(self.devices[0])
        else:
            t = t.cpu()
        return t.contiguous()

    def _all_gather(self, t: torch.Tensor) -> list:
        """``t`` of every process, in process order (the shapes equal);
        on the host under gloo, on a card under NCCL."""
        if self.process_count == 1:
            return [t]
        import torch.distributed as dist
        t = self._wire(t)
        parts = [torch.empty_like(t) for _ in range(self.process_count)]
        dist.all_gather(parts, t)
        return parts

    def sum_over_processes(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the processes, in place (``all_reduce``),
        through the host under gloo."""
        if self.process_count > 1:
            import torch.distributed as dist
            wire = self._wire(t)
            dist.all_reduce(wire)
            if wire.data_ptr() != t.data_ptr():
                t.copy_(wire)
        return t

    def shift_from_next(self, t: torch.Tensor, device) -> torch.Tensor:
        """The ring's step across processes: ``t`` (this process's first
        local partition) goes to process p - 1 while the tensor of
        process p + 1 comes in, both posted at once (a blocking send
        before the receive would deadlock at two processes); returned on
        ``device``."""
        import torch.distributed as dist
        P, p = self.process_count, self.process_index
        out = self._wire(t)
        into = torch.empty_like(out)
        reqs = [dist.isend(out, (p - 1) % P), dist.irecv(into, (p + 1) % P)]
        for r in reqs:
            r.wait()
        return into.to(device)

    def merge_deltas(self, start: torch.Tensor, tables) -> list:
        """The JAX package's ``start + psum(table - start)`` over the
        devices' ``tables`` (each a private copy updated from ``start``;
        none where this process's devices had no work), replicated on
        every mesh device."""
        home = start.device
        total = torch.zeros_like(start)
        for t in tables:
            total += t.to(home) - start
        return self.replicate(start + self.sum_over_processes(total))

    def _all_parts(self, parts) -> list:
        """Every global device's touched-row deltas, in global device
        order, from this process's ``parts`` (one (rows, deltas) pair a
        local device): the counts all-gathered first, then the rows and
        deltas padded to the largest count (on the host under gloo)."""
        if self.process_count == 1:
            return list(parts)
        L = self.size
        counts = torch.tensor([int(r.numel()) for r, _ in parts])
        all_counts = torch.stack(self._all_gather(counts)).cpu()
        m = int(all_counts.max())
        delta = parts[0][1]
        rows = torch.zeros((L, m), dtype=torch.int64, device=delta.device)
        deltas = delta.new_zeros((L, m) + tuple(delta.shape[1:]))
        for d, (r, dl) in enumerate(parts):
            rows[d, :r.numel()] = r.to(rows.device)
            deltas[d, :r.numel()] = dl.to(deltas.device, deltas.dtype)
        if m == 0:
            return [(rows[0], deltas[0])] * self.global_size
        all_rows, all_deltas = self._all_gather(rows), self._all_gather(deltas)
        return [(all_rows[p][d, :int(all_counts[p, d])],
                 all_deltas[p][d, :int(all_counts[p, d])])
                for p in range(self.process_count) for d in range(L)]

    def merge_rows(self, replicas, parts) -> list:
        """Add every global device's touched-row deltas (``parts``: this
        process's (rows, deltas) pairs, one a local device, zero rows
        where a device touched none) to each distinct copy of
        ``replicas``, in global device order, so that the copies stay
        equal on every process; returns them."""
        parts = self._all_parts(parts)
        seen = set()
        for copy in replicas:
            if id(copy) in seen:
                continue
            seen.add(id(copy))
            for rows, delta in parts:
                copy.index_add_(0, rows.to(copy.device),
                                delta.to(copy.device, copy.dtype))
        return list(replicas)

    def replicate(self, t) -> list:
        """One copy of ``t`` on each of this process's devices (``t``
        itself where it already lies there); a device listed twice shares
        one copy. A list of copies (an earlier call's result) is returned
        as it is, so that callers can keep the copies across epochs."""
        if isinstance(t, (list, tuple)):
            return list(t)
        copies = {}
        for d in self.devices:
            if d not in copies:
                copies[d] = t.to(d)
        return [copies[d] for d in self.devices]

    def split_local(self, t: torch.Tensor) -> list:
        """Rows of ``t`` (this process's) in ``size`` contiguous blocks,
        block d on local device d, padded with zero rows to a multiple of
        ``size`` (``pad_rows_to_multiple``)."""
        L = self.size
        if t.shape[0] % L:
            t = torch.from_numpy(pad_rows_to_multiple(
                t.detach().cpu().numpy(), L)).to(t.device)
        n = t.shape[0] // L
        return [t[d * n:(d + 1) * n].to(dev)
                for d, dev in enumerate(self.devices)]

    def shard_rows(self, t: torch.Tensor) -> list:
        """Rows of the whole table ``t`` in ``global_size`` contiguous
        blocks, block g on global device g, of which this process keeps
        its own, block ``first_device + d`` on local device d
        (``shard_mf_params``; the JAX package's ``device_put`` of a
        global array): a view of ``t`` where the device is t's own and
        the blocks divide its rows, else of ``t`` padded with zero rows
        to a multiple of ``global_size`` (``pad_rows_to_multiple``; the
        plans pad their tables to whole shards themselves)."""
        D, g0 = self.global_size, self.first_device
        if t.shape[0] % D:
            t = torch.from_numpy(pad_rows_to_multiple(
                t.detach().cpu().numpy(), D)).to(t.device)
        n = t.shape[0] // D
        return [t[(g0 + d) * n:(g0 + d + 1) * n].to(dev)
                for d, dev in enumerate(self.devices)]

    def gather_rows(self, shards, device=None) -> torch.Tensor:
        """Every global device's row block in global order on ``device``
        (the first mesh device by default) from this process's
        ``shards``: concatenated here, then all-gathered across the
        processes (a collective there)."""
        device = self.devices[0] if device is None else torch.device(device)
        local = torch.cat([s.to(device) for s in shards])
        return torch.cat([p.to(device) for p in self._all_gather(local)])


def diagonal_epoch(mesh: Mesh, H_parts, order, counts, run_cell) -> list:
    """One epoch of Gemulla's DSGD diagonal over the mesh (the loop of
    ``pallas_sgd.sgd_epoch_mxu_sharded``'s ``shard_map``): D =
    ``global_size`` sub-epochs; at sub-epoch k global device g works on
    the item partition (g + k) % D that it holds, this process calling
    ``run_cell(d, k, H, cols)`` for its local device d = g -
    ``first_device``; then every partition moves one step around the
    ring, device g receiving device g + 1's (the JAX package's ppermute
    pairs ((i + 1) % D, i)): within a process by ``tensor.to``, at the
    process boundary by ``Mesh.shift_from_next`` (the first local
    partition to process p - 1, the last local device's from process p +
    1), so that after D sub-epochs each is home again. Within a
    sub-epoch the cells touch disjoint user rows and disjoint
    partitions, so on distinct cards they run at once, each on its
    device's current stream.

    ``H_parts[d]`` is partition ``first_device + d`` on local device d;
    ``order`` the [D, D, nc_pad] columns of the epoch order (numpy or
    tensors; every global device's rows, of which a process reads its
    own) and ``counts`` [D, D] the real chunks of each cell. Each
    device's rows of ``order`` go to it once, before any cell runs, and
    ``cols`` holds views of the cell's real entries there. A cell
    without chunks is skipped; the ring's step is not. Returns this
    process's partitions, home again."""
    L, D, g0 = mesh.size, mesh.global_size, mesh.first_device
    cols = [tuple(torch.as_tensor(np.ascontiguousarray(a[g0 + d])).to(dev)
                  for a in order) for d, dev in enumerate(mesh.devices)]
    held = list(H_parts)
    for k in range(D):
        for d in range(L):
            n = int(counts[g0 + d][k])
            if n:
                run_cell(d, k, held[d], tuple(c[k, :n] for c in cols[d]))
        if mesh.process_count == 1:
            last = held[0].to(mesh.devices[-1])
        else:
            last = mesh.shift_from_next(held[0], mesh.devices[-1])
        held = [held[d + 1].to(mesh.devices[d]) for d in range(L - 1)] + \
            [last]
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


# ---------------------------------------------------------------------------
# multi-host: torch.distributed
# ---------------------------------------------------------------------------
#
# Every process runs the same program and calls initialize_distributed()
# first; a global mesh then spans the processes, each driving its local
# devices. A process loads only its slice of the input (host_local_rows)
# and shards it over its devices (shard_host_local). One process is the
# fallback: initialize_distributed() returns False and the global mesh
# is make_mesh()'s.

def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None,
                           timeout=None) -> bool:
    """Join the process group (``torch.distributed.init_process_group``
    over ``tcp://coordinator_address``). The arguments default to
    ``JAX_COORDINATOR`` (``host:port``), ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``, as in the JAX package. Returns False, and
    initializes nothing, where the configuration says one process.
    ``backend`` defaults to NCCL where each process of this host gets
    cards of its own from ``local_devices``, else gloo; pass "gloo"
    where ranks are given devices that repeat a card. ``timeout`` (a
    ``timedelta``) bounds each collective's wait, so that a process
    whose peer failed raises instead of hanging."""
    coordinator_address = coordinator_address or \
        os.environ.get("JAX_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    import torch.distributed as dist
    if backend is None:
        backend = default_backend(process_id, num_processes)
    kw = {} if timeout is None else dict(timeout=timeout)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)
    return True


def _processes():
    """(this process's index, the process count)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_processes(rank: int, world: int):
    """(this process's index on its host, the processes on its host):
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` (torchrun's variables), else
    every process taken to be on this host."""
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def local_devices(rank: int = None, world: int = None) -> list:
    """This process's cards: the visible cards in equal contiguous
    blocks, one for each process of the host, block ``LOCAL_RANK``
    (``_local_processes``; rank and world default to the process
    group's). One process gets every card. Raises where the host has
    fewer cards than processes: pass the devices then."""
    r, w = _processes()
    lr, lw = _local_processes(r if rank is None else rank,
                              w if world is None else world)
    count = torch.cuda.device_count()
    per = count // max(lw, 1)
    if per < 1:
        raise ValueError(
            f"{count} CUDA devices for {lw} processes on this host: pass "
            "each process its devices (make_global_mesh(devices=...))")
    return [f"cuda:{i}" for i in range(lr * per, (lr + 1) * per)]


def default_backend(process_id: int, num_processes: int) -> str:
    """NCCL where CUDA is there and ``local_devices`` gives each process
    of the host a card of its own, else gloo."""
    _, lw = _local_processes(process_id, num_processes)
    return ("nccl" if torch.cuda.is_available()
            and torch.cuda.device_count() >= lw else "gloo")


def make_global_mesh(devices=None) -> Mesh:
    """The mesh over every process's devices: this process drives
    ``devices`` (default ``local_devices()``, its share of the host's
    cards); identical to ``make_mesh`` in one process."""
    if devices is None:
        devices = local_devices()
    rank, world = _processes()
    return Mesh(devices, process_index=rank, process_count=world)


def host_local_rows(num_rows: int, process_id: int = None,
                    num_processes: int = None):
    """[start, stop) of the rows this process loads: the group axis split
    contiguously over the processes (JAX ``host_local_rows``)."""
    rank, world = _processes()
    pid = rank if process_id is None else process_id
    n = world if num_processes is None else num_processes
    per = (num_rows + n - 1) // n
    return pid * per, min((pid + 1) * per, num_rows)


def shard_host_local(mesh: Mesh, host_rows) -> list:
    """This process's rows (``host_local_rows`` of the global array; in
    one process the whole array) in row blocks over its devices."""
    return mesh.split_local(torch.as_tensor(np.asarray(host_rows)))


def gather_global_rows(mesh: Mesh, shards) -> torch.Tensor:
    """Every process's row blocks, in global order, on the host (JAX
    ``process_allgather``)."""
    return mesh.gather_rows(shards, "cpu")


def shard_mf_params(params: dict, mesh: Mesh) -> dict:
    """Row shards of every table and vector of an MF-family params dict
    (padded to a multiple of the devices), replicas of every scalar
    (JAX ``shard_mf_params``)."""
    out = {}
    for name, value in params.items():
        t = torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value)
        out[name] = mesh.shard_rows(t) if t.dim() >= 1 else mesh.replicate(t)
    return out


class _DefaultMesh:
    """The type of ``DEFAULT_MESH``: one object, which a copy or a pickle
    of a model keeps (``__reduce__`` names the module's global)."""

    def __repr__(self):
        return "DEFAULT_MESH"

    def __reduce__(self):
        return "DEFAULT_MESH"


# A model's ``mesh`` before one is set: the mesh ``default_mesh`` resolves
# when the model plans its epochs (JAX: ``make_mesh()`` wherever
# ``len(jax.devices()) > 1``). ``None`` is one device.
DEFAULT_MESH = _DefaultMesh()

# The devices the default mesh spans; None: every visible CUDA card (this
# process's share of the host's, ``local_devices``, across processes).
# ``default_devices`` points it elsewhere for a block (a test's ["cpu"] *
# 8, the one-card rig ["cuda:0"] * 4).
_DEFAULT_DEVICES = None
_DEFAULT_MESHES = {}


@contextlib.contextmanager
def default_devices(devices):
    """Inside the block the default mesh spans ``devices`` (a list of one
    device: no mesh); the visible cards again after it."""
    global _DEFAULT_DEVICES
    saved = _DEFAULT_DEVICES
    _DEFAULT_DEVICES = None if devices is None else \
        tuple(torch.device(d) for d in devices)
    try:
        yield
    finally:
        _DEFAULT_DEVICES = saved


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with the current card's index where it names none."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def default_mesh(device) -> Mesh | None:
    """The JAX package's default mesh of all devices for a model on
    ``device``. Where ``torch.distributed`` holds more than one process
    (JAX: ``jax.devices()`` is global after ``initialize_distributed()``),
    the global mesh over this process's devices: its share of the host's
    cards (``local_devices``) for a model on a card, its one device for a
    model on the CPU; a model that is not on the first of them raises,
    since on one device each process would train its own copy. In one
    process, ``make_mesh()`` over every visible card where ``device`` is
    the first of them (``"cuda"``, the current card, or ``"cuda:0"``) and
    there are several; else None. ``default_devices`` overrides the
    devices in both. The only place that reads the card count. The same
    arguments give the same ``Mesh`` object, so that a model that
    compares its plan's mesh with this one by identity keeps its plan."""
    rank, world = _processes()
    dev = torch.device(device)
    if world > 1:
        if _DEFAULT_DEVICES is not None:
            devices = _DEFAULT_DEVICES
        elif dev.type == "cuda":
            devices = tuple(torch.device(d)
                            for d in local_devices(rank, world))
        else:
            devices = (dev,)
        if _indexed(dev) != devices[0]:
            raise ValueError(
                f"process {rank} of {world}: a model on {dev}, whose mesh "
                f"devices start at {devices[0]}: set the model's device to "
                "it, or its mesh")
    else:
        devices = _DEFAULT_DEVICES or tuple(
            torch.device("cuda", i) for i in range(torch.cuda.device_count()))
        if len(devices) < 2 or _indexed(dev) != devices[0]:
            return None
    key = (rank, world, devices)
    if key not in _DEFAULT_MESHES:
        _DEFAULT_MESHES[key] = make_global_mesh(devices)
    return _DEFAULT_MESHES[key]


def model_mesh(model) -> Mesh | None:
    """The mesh a model trains on: its ``mesh`` attribute, resolved by
    ``default_mesh`` on the model's device where it is left at
    ``DEFAULT_MESH`` (the default of the MF, BPR, WRMF, SVD++ and SLIM
    families: every visible card, as the JAX package's default of all
    devices), None where it spans one device. ``mesh = None`` keeps one
    device; a model without the attribute has none. Resolved each time
    a model plans, so that a model built before
    ``initialize_distributed()`` sees the global mesh."""
    mesh = getattr(model, "mesh", None)
    if mesh is DEFAULT_MESH:
        mesh = default_mesh(getattr(model, "device", "cuda"))
    return mesh if mesh is not None and mesh.global_size > 1 else None


def one_device_route(model, route: str, mesh: Mesh):
    """Log that ``model`` takes its one-device ``route`` on a mesh: the
    route has no sharded form, as in the JAX package (GSVDPlusPlus,
    frequency-regularized MF, BPR models other than MultiCoreBPRMF past
    the sharded-tiled bound)."""
    log.warning("%s: the %s route has no sharded form; it runs on one "
                "device, not on the %d-device mesh",
                type(model).__name__, route, mesh.global_size)


def pad_rows_to_multiple(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Pad dim 0 with zero rows to a multiple of ``multiple`` (copy of
    ``mymedialite_tpu/parallel/mesh.py pad_rows_to_multiple``)."""
    n = arr.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr
    pad_shape = (target - n,) + arr.shape[1:]
    return np.concatenate([arr, np.zeros(pad_shape, dtype=arr.dtype)], axis=0)
