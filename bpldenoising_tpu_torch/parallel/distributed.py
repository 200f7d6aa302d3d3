"""Multi-host initialization (counterpart of
``bpldenoising_tpu.parallel.distributed``).

One process drives every card of its host through a :class:`.mesh.Mesh`;
``torch.distributed`` enters only across hosts, where the JAX package
calls ``jax.distributed.initialize``.  After :func:`initialize_distributed`
has set up the process group, each rank's mesh holds the shards of its
global index and every mesh reduction (:func:`.mesh.psum`) adds one
``all_reduce`` over the group, so the sharded learning functions and the
fused learners' trust regions run unchanged on every rank.

Placement, as in the JAX package: put the batch axis across hosts (two
reduced scalars and one parameter-sized array an evaluation tolerate the
network's latency) and keep the rows (halo) axis inside one host.
"""

from __future__ import annotations

import os

__all__ = ["initialize_distributed"]

# environment markers of a multi-process launch.  An address marker counts
# only with a world size above one (torchrun sets MASTER_ADDR and
# WORLD_SIZE for any launch); count markers count above one (a
# single-process `mpirun` or a one-node Slurm job needs no group).
_CLUSTER_ADDRESS_VARS = ("MASTER_ADDR",)
_CLUSTER_COUNT_VARS = (
    "SLURM_JOB_NUM_NODES",
    "OMPI_COMM_WORLD_SIZE",
)
# where a launcher keeps the world size and this process's rank
_WORLD_VARS = ("WORLD_SIZE", "OMPI_COMM_WORLD_SIZE", "SLURM_NTASKS")
_RANK_VARS = ("RANK", "OMPI_COMM_WORLD_RANK", "SLURM_PROCID")


def _count(var) -> int:
    n = os.environ.get(var, "")
    return int(n) if n.isdigit() else 0


def _cluster_env_present() -> bool:
    if any(os.environ.get(v) for v in _CLUSTER_ADDRESS_VARS) \
            and _count("WORLD_SIZE") > 1:
        return True
    return any(_count(v) > 1 for v in _CLUSTER_COUNT_VARS)


def _first(vars_):
    for v in vars_:
        if os.environ.get(v, "").isdigit():
            return int(os.environ[v])
    return None


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> bool:
    """Set up the ``torch.distributed`` process group when a cluster
    environment is present.

    Returns True when ``torch.distributed.init_process_group`` was called,
    False for the single-process no-op (no cluster markers in the
    environment and no explicit arguments).  Safe to call unconditionally
    at program start; explicit arguments always force the call.
    ``coordinator_address`` is ``host:port`` (``tcp://`` is added); without
    it the group reads ``MASTER_ADDR`` and ``MASTER_PORT``.  The world size
    and rank default to the launcher's (torchrun, OpenMPI, Slurm).  The
    backend is NCCL where CUDA is present, else gloo.
    """
    explicit = any(v is not None
                   for v in (coordinator_address, num_processes, process_id))
    if not explicit and not _cluster_env_present():
        return False
    import torch
    import torch.distributed as dist
    world = num_processes if num_processes is not None else _first(
        _WORLD_VARS)
    rank = process_id if process_id is not None else _first(_RANK_VARS)
    kwargs = {}
    if coordinator_address is not None:
        addr = coordinator_address
        kwargs["init_method"] = (addr if "://" in addr else f"tcp://{addr}")
    if world is not None:
        kwargs["world_size"] = int(world)
    if rank is not None:
        kwargs["rank"] = int(rank)
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend, **kwargs)
    return True
