"""Configuration tree: the fields that the two configurations' modules,
planner and plain solver read, with the port's defaults (ref
mpc_planner_util parameters.h and mpc_planner_jackalsimulator/config/
settings.yaml), so the frozen presets build the same OCP as the port's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass(frozen=True)
class ContouringConfig:
    num_segments: int = 5
    dynamic_velocity_reference: bool = False
    add_road_constraints: bool = True


@dataclass(frozen=True)
class TMPCConfig:
    """T-MPC++ settings (ref settings.yaml:63-67; the reference's comments
    on each choice are in mpc_planner_tpu/utils/config.py)."""

    use_tmpc_pp: bool = True  # include the non-guided planner in parallel
    enable_constraints: bool = True  # homotopy halfspace constraints
    n_paths: int = 4  # homotopy classes (ref guidance_planner.yaml:11)
    samples_per_class: int = 1  # warmstart variations per class (batch axis)
    selection_weight_consistency: float = 0.75  # bonus for previously chosen class
    # Extra decelerate-to-stop guidance class (opt-in, selection-gated to
    # emergencies only).
    braking_class: bool = False
    braking_deceleration: float = 2.0  # [m/s^2]
    # "lateral": homotopy classes constructed in the path frame
    # (guidance/homotopy.py), the only backend of the frozen copy.
    guidance_backend: str = "lateral"


@dataclass(frozen=True)
class ProbabilisticConfig:
    enable: bool = True
    risk: float = 0.05


@dataclass(frozen=True)
class RoadConfig:
    two_way: bool = False
    width: float = 6.0


@dataclass(frozen=True)
class RobotConfig:
    length: float = 0.65
    width: float = 0.65


@dataclass(frozen=True)
class SolverConfig:
    iterations: int = 10  # SQP-RTI iterations (ref settings.yaml:16)
    qp_iterations: int = 9  # IP iterations of a cold QP
    tol_eq_residual: float = 1e-2  # res_eq failure check (ref acados_solver_interface.cpp:176-181)
    # EXACT Hessian + MIRROR regularization (generate_acados_solver.py:
    # 143-176). "auto" probes whether the cost's u-block is diagonal and
    # u-x decoupled and then eigendecomposes only the x-block.
    mirror_structure: str = "auto"  # "auto" | "x_only" | "full"
    levenberg_marquardt: float = 1e-6
    qp_mu0: float = 1e1
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
    robot_radius: float = 0.325
    obstacle_radius: float = 0.4
    control_frequency: float = 20.0  # [Hz]
    enable_output: bool = True
    deceleration_at_infeasible: float = 3.0  # [m/s^2]
    shift_previous_solution_forward: bool = False
    debug_limits: bool = False

    robot: RobotConfig = field(default_factory=RobotConfig)
    road: RoadConfig = field(default_factory=RoadConfig)
    contouring: ContouringConfig = field(default_factory=ContouringConfig)
    t_mpc: TMPCConfig = field(default_factory=TMPCConfig)
    probabilistic: ProbabilisticConfig = field(default_factory=ProbabilisticConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    linearized_add_halfspaces: int = 0  # ref settings.yaml linearized_constraints

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


def default_config(**overrides: Any) -> Config:
    return Config().replace(**overrides) if overrides else Config()
