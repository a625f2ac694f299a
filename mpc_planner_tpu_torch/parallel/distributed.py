"""Multi-process fan-out of the batched solve over torch.distributed.

Counterpart of mpc_planner_tpu/parallel/distributed.py. The reference's
communication is ROS pub/sub between processes plus OpenMP inside the
planner; the JAX package joins one controller process per host with
jax.distributed. Here one process per device joins a torch.distributed
process group (NCCL between GPUs, gloo between CPU processes), the
guess/scenario batch is split over the ranks, and the T-MPC selection
(guidance_constraints.cpp:416-434) is a global argmin over an all-gather of
each rank's (weighted objective, feasible) rows.

Flow per control cycle (ranks run in lockstep):

1. every rank computes the SAME guidance trajectories (the guidance layer
   is deterministic given state and obstacles) and takes its slice of the
   batch (`host_shard_slice`, `host_sharded_batch`);
2. each rank solves its slice (`sharded_batch_impl`);
3. `global_argmin` gathers 2 floats per row and picks the winner on every
   rank; `broadcast_winner` sends exactly one trajectory from the rank that
   owns it, the only other cross-rank payload (a few kB);
4. each rank's driver acts on the identical winner.

A process without a process group runs the same code locally; under one
(NCCL with world size 1 on one card included) the collectives run.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from mpc_planner_tpu_torch import default_device
from mpc_planner_tpu_torch.parallel.mesh import BatchMesh, _leaves, _on_device, _slice
from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, device=None, timeout_s: float = 600.0) -> None:
    """Join the process group of the ranks that split the batch: NCCL when
    `device` (None: the card) is a CUDA device, gloo when it is the CPU;
    raises when that backend is not available, or when the group this
    process already joined has another backend (never switches backend).

    `init_method` ("tcp://host:port", "file:///path") with `world_size`
    and `rank`, or (None) torch's environment variables (WORLD_SIZE, RANK,
    MASTER_ADDR, MASTER_PORT). Without either this is a single process and
    nothing is joined."""
    dev = default_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    available = dist.is_available() and (
        dist.is_nccl_available() if backend == "nccl" else dist.is_gloo_available())
    if not available:
        raise RuntimeError(f"torch.distributed backend {backend!r} (for a {dev.type} device) "
                           "is not available")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()!r}, but a {dev.type} "
                               f"device needs {backend!r}")
        return
    if init_method is None:
        if "WORLD_SIZE" not in os.environ:
            return  # single process
        init_method = "env://"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    from datetime import timedelta

    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, timeout=timedelta(seconds=timeout_s))


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_batch_size(per_rank: int) -> int:
    return per_rank * _world()[1]


def host_shard_slice(global_B: int) -> slice:
    """Index range of the global batch this process owns (contiguous
    blocks in rank order)."""
    return _slice(*_world(), global_B)


def host_sharded_batch(mesh: BatchMesh, tree):
    """This rank's own rows (each leaf holds only the `host_shard_slice` of
    the global batch) as tensors on the mesh's device. No rank ever holds
    the full batch."""
    return _leaves(tree, lambda x: _on_device(x, mesh.device))


def global_argmin(pobj, feasible, mesh: Optional[BatchMesh] = None):
    """Global T-MPC selection over the split batch: pobj [b], feasible [b]
    are this rank's rows; returns (winner's global index, found_any) as 0-d
    tensors, the same on every rank: one all-gather of (pobj, feasible),
    then the first index of the minimum, as jnp.argmin."""
    rows = torch.stack([pobj.float(), feasible.float()])  # [2, b]
    if mesh is not None and mesh.group is not None:
        parts = [torch.empty_like(rows) for _ in range(mesh.world_size)]
        dist.all_gather(parts, rows, group=mesh.group)
        rows = torch.cat(parts, dim=1)
    masked = torch.where(rows[1] > 0.5, rows[0], torch.inf)
    idx = torch.argmin(masked)
    return idx, torch.isfinite(masked[idx])


def broadcast_winner(mesh: BatchMesh, Z_batch, idx):
    """The winning trajectory on every rank: Z_batch [b, N+1, nvar] is this
    rank's rows, idx the global index; the owner sends its row (one
    device->host read of idx picks the owner)."""
    per = Z_batch.shape[0]
    i = int(idx)
    owner, row = divmod(i, per)
    if mesh.group is None:
        return Z_batch[row].clone()
    Zw = Z_batch[row].clone() if mesh.rank == owner else torch.empty_like(Z_batch[0])
    dist.broadcast(Zw, src=dist.get_global_rank(mesh.group, owner), group=mesh.group)
    return Zw


def distributed_solve_step(solver, mesh: BatchMesh, num_iterations: int, warm: bool = False):
    """The per-cycle step: this rank's batched solve + the global selection
    + the winner on every rank. Returns
    step(Z0, P, xinit, consistency [b]) -> (Z_winner, idx, found, res),
    every operand and `res` this rank's rows.

    `consistency` is the per-row objective multiplier (1.0, or
    selection_weight_consistency for previously selected classes). With
    `warm=True` the step takes three more operands (lam_l, lam_u, ok), the
    previous cycle's converged QP duals, so steady-state cycles run the
    cross-cycle warm start like the single-device planner."""
    from mpc_planner_tpu_torch.parallel.mesh import sharded_batch_impl

    solve = sharded_batch_impl(solver, mesh, num_iterations, warm=warm)

    def step(Z0, P, xinit, consistency, *warm_duals):
        res = solve(Z0, P, xinit, *warm_duals)
        idx, found = global_argmin(res.pobj * consistency, res.exit_code == EXIT_SUCCESS, mesh)
        return broadcast_winner(mesh, res.Z, idx), idx, found, res

    return step


__all__ = ["broadcast_winner", "distributed_solve_step", "global_argmin",
           "global_batch_size", "host_shard_slice", "host_sharded_batch", "initialize_distributed"]
