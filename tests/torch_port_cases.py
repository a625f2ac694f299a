"""Shared builders for the tests that hold the PyTorch port
(mpc_planner_tpu_torch) against the JAX package (mpc_planner_tpu).

Each builder makes the same inputs for both packages from a seed with
numpy; the tests hand them over as numpy arrays (or through
mpc_planner_tpu_torch.interop). Small sizes: N=10, B=4, 4 RTI iterations,
like tests/conftest.py's `cfg`. torch runs on one thread because the
tier-1 run has several xdist workers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import mpc_planner_tpu.presets as jax_presets
import mpc_planner_tpu_torch.presets as torch_presets
from mpc_planner_tpu.parameters import ParameterBlock as JaxParameterBlock
from mpc_planner_tpu.types import ModuleData as JaxModuleData
from mpc_planner_tpu_torch.parameters import ParameterBlock as TorchParameterBlock
from mpc_planner_tpu_torch.types import ModuleData as TorchModuleData

torch.set_num_threads(1)

N_SMALL = 10
SOLVER_SMALL = dict(iterations=4, qp_iterations=10)


@dataclasses.dataclass
class Side:
    """One package's build of a configuration."""

    cfg: object
    model: object
    modules: object
    state: object = None
    data: object = None


def jackal_goal_pair(N: int = N_SMALL, n_pedestrians: int = 6, seed: int = 0, **solver):
    """system_jackal("goal") built by both packages, with the same
    corridor scene (same seed). `solver` overrides SolverConfig fields."""
    sides = []
    for presets in (jax_presets, torch_presets):
        cfg, model, modules = presets.system_jackal("goal", N=N)
        if solver:
            cfg, model, modules = presets.system_jackal(
                "goal", N=N, solver=dataclasses.replace(cfg.solver, **solver))
        state, data = presets.corridor_scene(cfg, n_pedestrians=n_pedestrians, seed=seed)
        sides.append(Side(cfg, model, modules, state, data))
    return sides[0], sides[1]


def parameter_blocks(jax_side: Side, torch_side: Side, jax_params, torch_params):
    """Each package's own host half fills its [N+1, npar] block for the
    same scene; returns (jax_block, torch_block) as numpy arrays."""
    N = jax_side.cfg.N
    out = []
    for side, params, PB, MD in ((jax_side, jax_params, JaxParameterBlock, JaxModuleData),
                                 (torch_side, torch_params, TorchParameterBlock, TorchModuleData)):
        pb = PB(params, N + 1)
        side.modules.set_parameters_all(side.data, MD(), pb)
        pb.data[N] = pb.data[N - 1]
        out.append(pb.data)
    return out


def place_near_pedestrian(state, data, gap: float, speed: float):
    """Put the robot `gap` m behind the first real pedestrian, heading at
    it, so the obstacle rows of the QP are active within a short horizon."""
    obs = data.obstacle_block
    i = int(np.argmax(obs.index >= 0))
    state.set("x", obs.position[i, 0] - gap)
    state.set("y", obs.position[i, 1])
    state.set("v", speed)
    data.ego_position = state.get_position()


def perturbed_warmstarts(Z0: np.ndarray, nu: int, B: int, seed: int = 0, scale: float = 0.05):
    """[B, N+1, nvar] copies of Z0 with seeded noise on the states of
    stages 1..N (the bench.py recipe)."""
    rng = np.random.default_rng(seed)
    Zb = np.tile(Z0[None], (B, 1, 1)).astype(np.float32)
    Zb[:, 1:, nu:] += rng.normal(0, scale, Zb[:, 1:, nu:].shape).astype(np.float32)
    return Zb
