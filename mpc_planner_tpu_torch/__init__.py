"""mpc_planner_tpu_torch — the PyTorch + CUDA port of mpc_planner_tpu.

The JAX package (mpc_planner_tpu) stays the reference; this package
reproduces its planner with torch tensors and runs the solver in
hand-written Hopper kernels (ops/csrc) on a CUDA device. It never imports
jax. Entry points run on the card unless the caller asks for another
device (`default_device`).

Layer map (file names follow the reference's):
  planner.py   — Planner.solve_mpc orchestration (ref planner.cpp)
  modules/     — objective/constraint modules (traced + host halves)
  solver/      — OCP assembly, SQP-RTI, interior-point Riccati QP
  models/      — dynamics models + RK4
  ops/         — MIRROR (plain) and the CUDA kernel wrappers
  interop.py   — state exchange with the JAX package
"""

import torch


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, or (None) the card,
    cuda:0. Without CUDA that is an error, never a silent run on the CPU:
    a caller that wants the CPU says device="cpu", as the tests do."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no device was given and CUDA is not available: the port runs on the card by '
            'default; pass device="cpu" to run on the CPU')
    return torch.device("cuda:0")


from mpc_planner_tpu_torch.parameters import ParameterRegistry  # noqa: E402
from mpc_planner_tpu_torch.types import (  # noqa: E402
    Disc,
    DynamicObstacle,
    Halfspace,
    ModuleData,
    PlannerOutput,
    Prediction,
    PredictionType,
    RealTimeData,
    ReferencePath,
    State,
    Trajectory,
)
from mpc_planner_tpu_torch.utils.config import Config, default_config  # noqa: E402

__all__ = [
    "default_device",
    "Config",
    "default_config",
    "Disc",
    "Halfspace",
    "Prediction",
    "DynamicObstacle",
    "ReferencePath",
    "ModuleData",
    "PlannerOutput",
    "PredictionType",
    "RealTimeData",
    "State",
    "Trajectory",
    "ParameterRegistry",
]
