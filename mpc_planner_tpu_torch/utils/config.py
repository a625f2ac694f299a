"""Configuration tree.

Counterpart of mpc_planner_tpu/utils/config.py (ref mpc_planner_util
parameters.h and mpc_planner_jackalsimulator/config/settings.yaml). Only
the sections the ported modules read are here; the weights and every
default equal the reference's, so both packages build the same OCP from
the same overrides.

Backend selection differs: the reference's TPU keys (`qp_backend`
"pallas"/"xla", `qp_wide_blocks`, `qp_mirror_in_kernel`) give way to
`qp_backend: "auto" | "cuda" | "torch"`; `rti_fused: "auto" | "on" |
"off"` keeps the reference's meaning (the fused whole-RTI kernel, on the
cuda backend; "auto" resolves off).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass(frozen=True)
class ContouringConfig:
    dynamic_velocity_reference: bool = False


@dataclass(frozen=True)
class ProbabilisticConfig:
    enable: bool = True
    risk: float = 0.05


@dataclass(frozen=True)
class RobotConfig:
    length: float = 0.65
    width: float = 0.65


@dataclass(frozen=True)
class SolverConfig:
    iterations: int = 10  # SQP-RTI iterations (ref settings.yaml:16)
    qp_iterations: int = 9  # IP iterations of a cold QP
    # "cuda": the hand-written Hopper QP + MIRROR kernels (ops/cuda_qp.py);
    # "torch": the plain batched torch path (solver/qp.py); "auto": cuda
    # when the solver's device is CUDA and the QP kernel is instantiated
    # for (nu, nx) (ops/cuda_qp.py::QP_SHAPES), else torch.
    qp_backend: str = "auto"
    # "on": with the cuda backend, SQP_RTI and Mehrotra warm QPs, the whole
    # RTI loop runs in one launch of the fused kernel K3 (ops/cuda_rti.py);
    # otherwise the unfused loop. "auto" resolves off, as in the reference
    # (mpc_planner_tpu/solver/sqp.py:195-207).
    rti_fused: str = "auto"
    solver_type: str = "SQP_RTI"  # or "SQP"
    tol_stationarity: float = 1e-3  # ref settings.yaml tolstat
    tol_eq_residual: float = 1e-2  # res_eq failure check (ref acados_solver_interface.cpp:176-181)
    # EXACT Hessian + MIRROR regularization (generate_acados_solver.py:
    # 143-176). "auto" probes whether the cost's u-block is diagonal and
    # u-x decoupled and then eigendecomposes only the x-block.
    mirror_structure: str = "auto"  # "auto" | "x_only" | "full"
    levenberg_marquardt: float = 1e-6
    qp_mu0: float = 1e1
    # Opt-in: warm QPs drop Mehrotra's predictor (one Newton step at a
    # fixed centering `qp_warm_sigma` per IP iteration).
    qp_warm_corrector_only: bool = False
    qp_warm_sigma: float = 0.1
    # IP iterations of warm QPs; 0 = auto (4, made safe by the stall
    # escalation below).
    qp_warm_iterations: int = 0
    # Elements whose final barrier mu ends above this (or that fail
    # res_eq) are re-solved at the full cold budget in the same cycle.
    qp_mu_stall: float = 1e-3
    qp_retry_cold: bool = True
    timeout_margin: float = 0.006  # [s] subtracted from budget (ref planner.cpp:117-118)


@dataclass(frozen=True)
class Config:
    """Static planner configuration (shape-determining + tunables).

    Defaults mirror mpc_planner_jackalsimulator/config/settings.yaml.
    """

    name: str = "jackal"
    N: int = 30  # horizon
    integrator_step: float = 0.2  # [s]
    n_discs: int = 1
    max_obstacles: int = 12
    obstacle_radius: float = 0.4
    control_frequency: float = 20.0  # [Hz]
    enable_output: bool = True
    deceleration_at_infeasible: float = 3.0  # [m/s^2]
    shift_previous_solution_forward: bool = False
    debug_limits: bool = False

    robot: RobotConfig = field(default_factory=RobotConfig)
    contouring: ContouringConfig = field(default_factory=ContouringConfig)
    probabilistic: ProbabilisticConfig = field(default_factory=ProbabilisticConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)

    # Runtime-tunable weights (ref settings.yaml:76-91), streamed into the
    # parameter block each cycle.
    weights: Dict[str, float] = field(
        default_factory=lambda: {
            "goal": 1.0,
            "goal_x": 1.0,
            "goal_y": 1.0,
            "velocity": 0.55,
            "acceleration": 0.34,
            "angular_velocity": 0.85,
            "reference_velocity": 2.0,
            "contour": 0.05,
            "preview": 0.0,
            "lag": 0.75,
            "slack": 10000.0,
            "terminal_angle": 100.0,
            "terminal_contouring": 10.0,
        }
    )

    @property
    def dt(self) -> float:
        return self.integrator_step

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def with_weights(self, **weights: float) -> "Config":
        merged = dict(self.weights)
        merged.update(weights)
        return dataclasses.replace(self, weights=merged)


def default_config(**overrides: Any) -> Config:
    return Config().replace(**overrides) if overrides else Config()
