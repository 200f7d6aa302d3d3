"""Data parallelism and spatial decomposition (counterpart of
``bpldenoising_tpu.parallel``): device meshes, the multi-host set-up, the
sharded learning functions and the halo row-sharded solvers."""

from .distributed import initialize_distributed
from .mesh import (BATCH_AXIS, make_batch_mesh, make_batch_rows_mesh,
                   pad_batch, shard_batch)
from .sharded import (
    make_sharded_sumregs_learning_function,
    make_sharded_tgv_learning_function,
    make_sharded_tvl1_learning_function,
    make_sharded_vtv_learning_function,
    make_sharded_tv_learning_function,
)

__all__ = [
    "initialize_distributed",
    "make_batch_mesh", "make_batch_rows_mesh", "shard_batch",
    "pad_batch", "BATCH_AXIS",
    "make_sharded_tv_learning_function",
    "make_sharded_sumregs_learning_function",
    "make_sharded_tgv_learning_function",
    "make_sharded_tvl1_learning_function",
    "make_sharded_vtv_learning_function",
]
