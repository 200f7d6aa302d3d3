"""Device meshes for data-parallel bilevel learning (counterpart of
``bpldenoising_tpu.parallel.mesh``).

The JAX package shards the image batch over a ``jax.sharding.Mesh`` and
lets ``psum`` accumulate the upper-level cost and hypergradient.  Here a
:class:`Mesh` is an ordered array of ``torch.device``s, one per shard, and
a single controller drives it from one process:

* :func:`run_shards` maps a function over the shards with one host thread
  per distinct device; shards that share a device run in order in that
  device's thread (the kernels' ``ctypes`` calls release the GIL, so
  several cards overlap);
* :func:`psum` sums per-shard results on the first device in shard order,
  so a run is reproducible bit for bit (and, once
  :func:`.distributed.initialize_distributed` has set up a process group,
  adds one ``all_reduce`` across the processes);
* a device may appear more than once, the counterpart of XLA's virtual
  host devices: ``["cpu"] * 8`` builds an eight-shard mesh on the CPU,
  ``["cuda:0"] * 4`` four shards on one card.

Across processes each rank's mesh holds the shards of its global index:
rank r of W with n local shards holds global shards r·n … r·n + n − 1.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

__all__ = ["make_batch_mesh", "make_batch_rows_mesh", "shard_batch",
           "pad_batch", "BATCH_AXIS", "ROWS_AXIS", "Mesh"]

BATCH_AXIS = "batch"
ROWS_AXIS = "rows"


class Mesh:
    """An (n,) or (n_batch, n_rows) array of devices with named axes;
    ``shape`` maps each axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        arr = np.vectorize(torch.device, otypes=[object])(arr)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D devices for axes {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape}, {self.devices.tolist()})"


def _cuda_devices():
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "no CUDA device: a mesh takes every visible card by default; "
            "pass devices= (e.g. ['cpu'] * 8) for a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_batch_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the image-batch axis: every visible CUDA device (the
    first ``n_devices``), or ``devices``, which may name a device more than
    once."""
    if devices is None:
        devices = _cuda_devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(list(devices), (BATCH_AXIS,))


def make_batch_rows_mesh(n_batch: int, n_rows: int, devices=None) -> Mesh:
    """2-D mesh for composed data (batch) × spatial (rows) parallelism —
    see :func:`.halo.denoise_pdps_batch_row_sharded`."""
    if devices is None:
        devices = _cuda_devices()
    devices = list(devices)[:n_batch * n_rows]
    if len(devices) != n_batch * n_rows:
        raise ValueError(
            f"need {n_batch * n_rows} devices, have {len(devices)}")
    grid = np.empty((n_batch, n_rows), dtype=object)
    for i, d in enumerate(devices):
        grid[i // n_rows, i % n_rows] = d
    return Mesh(grid, (BATCH_AXIS, ROWS_AXIS))


def pad_batch(arr, n_shards: int):
    """Pad axis 0 to a multiple of ``n_shards``; returns (padded, weights)
    where ``weights`` is 1.0 for real elements and 0.0 for padding."""
    arr = torch.as_tensor(arr)
    O = arr.shape[0]
    target = -(-O // n_shards) * n_shards
    w = torch.ones((O,), dtype=arr.dtype, device=arr.device)
    if target == O:
        return arr, w
    pad = torch.zeros((target - O,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    return (torch.cat([arr, pad]),
            torch.cat([w, torch.zeros((target - O,), dtype=arr.dtype,
                                      device=arr.device)]))


def process_group():
    """``(rank, world_size)`` of the process group that
    :func:`.distributed.initialize_distributed` set up, else ``(0, 1)``."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def batch_devices(mesh: Mesh) -> list:
    """The devices of the batch axis, one per local batch shard (a 2-D
    mesh's first column)."""
    d = mesh.devices
    return list(d if d.ndim == 1 else d[:, 0])


def global_batch_shards(mesh: Mesh) -> int:
    """Batch shards across every process of the group."""
    return mesh.shape[BATCH_AXIS] * process_group()[1]


def local_rows(arr, mesh: Mesh):
    """This process's part of a batch padded to the global shard count:
    rank r of W takes the r-th of W equal slices."""
    rank, world = process_group()
    if world == 1:
        return arr
    n = arr.shape[0] // world
    return arr[rank * n:(rank + 1) * n]


def shard_batch(arr, mesh: Mesh):
    """Split an (O, ...) array's leading axis over the mesh's batch axis:
    the list of this process's shards, each on its device (on a 2-D mesh,
    each a list of copies over the rows axis, which the batch spec
    replicates).  O must divide by the batch shards of all processes."""
    arr = torch.as_tensor(arr)
    n_global = global_batch_shards(mesh)
    if arr.shape[0] % n_global:
        raise ValueError(f"batch {arr.shape[0]} not divisible by "
                         f"{n_global} shards")
    parts = local_rows(arr, mesh).chunk(mesh.shape[BATCH_AXIS])
    if mesh.devices.ndim == 1:
        return [p.to(d) for p, d in zip(parts, mesh.devices)]
    return [[p.to(d) for d in row] for p, row in zip(parts, mesh.devices)]


class Sharded(NamedTuple):
    """A padded dataset on a mesh: this process's shards of the true and
    noisy images and the weights, and how many real images this process
    returns."""
    utrue: list
    f: list
    w: list
    n_real: int


def shard_dataset(ds, mesh: Mesh, image_ndim: int = 2) -> Sharded:
    """``(true_images, noisy_images)`` → :class:`Sharded` (a single image
    gains a batch axis; the true images' dtype is the working dtype)."""
    utrue = torch.as_tensor(ds[0])
    f = torch.as_tensor(ds[1]).to(dtype=utrue.dtype)
    if f.ndim == image_ndim:
        utrue, f = utrue[None], f[None]
    O = utrue.shape[0]
    n_global = global_batch_shards(mesh)
    utrue_p, w = pad_batch(utrue, n_global)
    f_p, _ = pad_batch(f, n_global)
    rank, world = process_group()
    start = rank * (utrue_p.shape[0] // world)
    n_real = int(np.clip(O - start, 0, utrue_p.shape[0] // world))
    return Sharded(shard_batch(utrue_p, mesh), shard_batch(f_p, mesh),
                   shard_batch(w, mesh), n_real)


def gather_u(us, n_real: int):
    """The shards' reconstructions on the first device, padding dropped."""
    dev = us[0].device
    return torch.cat([u.to(dev) for u in us])[:n_real]


def _device_scope(dev: torch.device):
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def run_shards(devices: Sequence[torch.device], fn, *shard_args):
    """``[fn(i, *(a[i] for a in shard_args)) for i in shards]`` with one
    host thread per distinct device; shards on one device run in order in
    its thread, under ``torch.cuda.device`` of it, with the caller's grad
    mode.  The first shard's exception (in shard order) is raised."""
    devices = [torch.device(d) for d in devices]
    groups: dict = {}
    for i, d in enumerate(devices):
        groups.setdefault(d, []).append(i)
    results = [None] * len(devices)
    errors = [None] * len(devices)
    grad = torch.is_grad_enabled()

    def run(dev, idxs):
        with torch.set_grad_enabled(grad), _device_scope(dev):
            for i in idxs:
                try:
                    results[i] = fn(i, *(a[i] for a in shard_args))
                except BaseException as e:      # noqa: BLE001 — re-raised
                    errors[i] = e
                    return

    if len(groups) == 1:
        run(*next(iter(groups.items())))
    else:
        threads = [threading.Thread(target=run, args=item, daemon=True)
                   for item in groups.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def _all_reduce(t, op: str):
    rank, world = process_group()
    if world == 1:
        return t
    dist = torch.distributed
    home = t.device
    # NCCL reduces CUDA tensors only: a host number goes over on the card
    on = (torch.device("cuda", torch.cuda.current_device())
          if dist.get_backend() == "nccl" and home.type != "cuda" else home)
    t = t.to(on).contiguous().clone()
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX,
                           "min": dist.ReduceOp.MIN}[op])
    return t.to(home)


def psum(values: Sequence[torch.Tensor], device=None):
    """Σ of per-shard tensors on ``device`` (by default the first shard's),
    added in shard order, then across the process group."""
    device = values[0].device if device is None else torch.device(device)
    acc = torch.as_tensor(values[0]).to(device)
    for v in values[1:]:
        acc = acc + torch.as_tensor(v).to(device)
    return _all_reduce(acc, "sum")


def host_reduce(values, op: str) -> float:
    """max or min of per-shard host numbers, then across the process
    group (the mesh-worst telemetry)."""
    v = float(max(values) if op == "max" else min(values))
    rank, world = process_group()
    if world == 1:
        return v
    return float(_all_reduce(torch.tensor([v], dtype=torch.float64), op)[0])
