"""The batch axis split over ranks: one contiguous slice of the parallel
solves per process.

Counterpart of mpc_planner_tpu/parallel/mesh.py. The reference runs its
4+1 homotopy planners on OpenMP threads (guidance_constraints.cpp:279) and
its scenario solvers likewise (scenario_constraints.cpp:67); the JAX
package makes them one leading batch axis sharded over a device mesh. Here
the axis is split over the ranks of a torch.distributed process group,
each rank solving its own slice on its own device with one `batch_impl`;
the T-MPC argmin selection (guidance_constraints.cpp:416-434) is a
gather over the group (parallel/distributed.py). Without a process group
the "mesh" is this process alone and every function runs locally.

Single axis: data-parallel over independent NLPs. There is no tensor or
pipeline dimension worth splitting at nx <= 9; scale lives in the number
of parallel problems.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from mpc_planner_tpu_torch import default_device


class BatchMesh(NamedTuple):
    """The ranks that split the batch: the process group (None: this
    process alone), this process's rank and the group's size, and the
    device this rank solves on."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world_size: int
    device: torch.device


def batch_mesh(device=None, group=None) -> BatchMesh:
    """The batch split over `group` (the default group when
    torch.distributed is initialized, else this process alone), solving on
    `device` (None: the card). Under a process group the selection runs its
    collectives even at world size 1."""
    if dist.is_available() and dist.is_initialized():
        group = group or dist.group.WORLD
        return BatchMesh(group, dist.get_rank(group), dist.get_world_size(group),
                         default_device(device))
    return BatchMesh(None, 0, 1, default_device(device))


def _slice(rank: int, world_size: int, global_B: int) -> slice:
    """Rank `rank`'s contiguous block of a global batch of `global_B` rows."""
    if global_B % world_size:
        raise ValueError(f"global batch {global_B} is not divisible by {world_size} ranks")
    per = global_B // world_size
    return slice(rank * per, (rank + 1) * per)


def _leaves(tree, fn):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_leaves(x, fn) for x in tree)
    if isinstance(tree, dict):
        return {k: _leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def _on_device(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    dtype = torch.float32 if np.issubdtype(x.dtype, np.floating) else None
    return torch.as_tensor(x, dtype=dtype, device=device)


def shard_batch(mesh: BatchMesh, tree):
    """This rank's contiguous slice of every leaf of a tree of GLOBAL
    batches (leading axis), on the mesh's device; floating arrays become
    float32 tensors."""
    return _leaves(tree, lambda x: _on_device(x[_slice(mesh.rank, mesh.world_size, x.shape[0])],
                                              mesh.device))


def sharded_batch_impl(solver, mesh: BatchMesh, num_iterations: int, warm: bool = False):
    """The batched solve of this rank's slice: `solver.batch_impl` on the
    rank's own rows (Z0, P, xinit; with `warm=True` also lam_l, lam_u, ok,
    the previous cycle's converged QP duals, the cross-cycle HPIPM
    warm_start=2 carry). The mesh only fixes which rows those are."""
    if warm:
        def solve(z, p, x, wl, wu, ok):
            return solver.batch_impl(z, p, x, num_iterations, warm0=(wl, wu, ok))
    else:
        def solve(z, p, x):
            return solver.batch_impl(z, p, x, num_iterations)
    return solve


def sharded_solve_fn(solver, mesh: BatchMesh, num_iterations: int):
    """fn(Z0 [b, N+1, nvar], P [b, N+1, npar], xinit [b, nx]) ->
    SolveResult of this rank's slice (b = B / world size rows), cold."""
    return sharded_batch_impl(solver, mesh, num_iterations)


def argmin_objective(pobj, feasible, consistency_weight=None, previous_selected=None):
    """T-MPC selection as a reduction (guidance_constraints.cpp:358,
    416-434): the lowest weighted objective among feasible batch elements.
    pobj [B], feasible [B] bool tensors; the consistency weight scales
    `previous_selected`'s objective. Returns (index, found_any) as 0-d
    tensors; on ties the first index, as jnp.argmin."""
    obj = pobj
    if consistency_weight is not None and previous_selected is not None:
        sel = torch.arange(obj.shape[0], device=obj.device) == previous_selected
        obj = torch.where(sel, obj * consistency_weight, obj)
    masked = torch.where(feasible, obj, torch.inf)
    idx = torch.argmin(masked)
    return idx, torch.isfinite(masked[idx])
