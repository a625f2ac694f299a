"""The batch axis split over ranks (counterpart of mpc_planner_tpu/parallel)."""

from mpc_planner_tpu_torch.parallel.distributed import (
    broadcast_winner,
    distributed_solve_step,
    global_argmin,
    global_batch_size,
    host_shard_slice,
    host_sharded_batch,
    initialize_distributed,
)
from mpc_planner_tpu_torch.parallel.mesh import (
    BatchMesh,
    argmin_objective,
    batch_mesh,
    shard_batch,
    sharded_batch_impl,
    sharded_solve_fn,
)

__all__ = [
    "BatchMesh",
    "argmin_objective",
    "batch_mesh",
    "shard_batch",
    "sharded_batch_impl",
    "sharded_solve_fn",
    "broadcast_winner",
    "distributed_solve_step",
    "global_argmin",
    "global_batch_size",
    "host_shard_slice",
    "host_sharded_batch",
    "initialize_distributed",
]
