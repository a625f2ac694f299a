"""mpc_planner_tpu_torch — the PyTorch + CUDA port of mpc_planner_tpu.

The JAX package (mpc_planner_tpu) stays the reference; this package
reproduces its planner's main path with torch tensors on a chosen device
and runs the QP and MIRROR steps in hand-written Hopper kernels
(ops/csrc) on a CUDA device. It never imports jax.

Layer map (file names follow the reference's):
  planner.py   — Planner.solve_mpc orchestration (ref planner.cpp)
  modules/     — objective/constraint modules (traced + host halves)
  solver/      — OCP assembly, SQP-RTI, interior-point Riccati QP
  models/      — dynamics models + RK4
  ops/         — MIRROR (plain) and the CUDA kernel wrappers
  interop.py   — state exchange with the JAX package
"""

from mpc_planner_tpu_torch.parameters import ParameterRegistry
from mpc_planner_tpu_torch.types import (
    ModuleData,
    PlannerOutput,
    PredictionType,
    RealTimeData,
    State,
    Trajectory,
)
from mpc_planner_tpu_torch.utils.config import Config, default_config

__all__ = [
    "Config",
    "default_config",
    "ModuleData",
    "PlannerOutput",
    "PredictionType",
    "RealTimeData",
    "State",
    "Trajectory",
    "ParameterRegistry",
]
