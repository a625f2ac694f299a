"""Configuration tree.

Counterpart of mpc_planner_tpu/utils/config.py (ref mpc_planner_util
parameters.h and mpc_planner_jackalsimulator/config/settings.yaml). Only
the sections the ported modules read are here; the weights and every
default equal the reference's, so both packages build the same OCP from
the same overrides.

Backend selection differs: the reference's TPU keys (`qp_backend`
"pallas"/"xla", `qp_wide_blocks`, `qp_mirror_in_kernel`) give way to
`qp_backend: "auto" | "cuda" | "torch"`; `rti_fused: "auto" | "on" |
"off"` keeps the reference's key (the fused whole-RTI kernel, on the cuda
backend), but "auto" turns it on wherever it can be built. The SH-MPC
section (`ScenarioConfig`) and `max_obstacle_distance` equal the
reference's, and `load_config` reads the same settings dict (or YAML file),
so one settings dict configures both packages alike; keys the port does
not carry (the reference's TPU solver keys) are skipped, as the reference
skips unknown keys.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class ContouringConfig:
    num_segments: int = 5
    dynamic_velocity_reference: bool = False
    add_road_constraints: bool = True
    preview: float = 0.0


@dataclass(frozen=True)
class TMPCConfig:
    """T-MPC++ settings (ref settings.yaml:63-67; the reference's comments
    on each choice are in mpc_planner_tpu/utils/config.py)."""

    use_tmpc_pp: bool = True  # include the non-guided planner in parallel
    enable_constraints: bool = True  # homotopy halfspace constraints
    warmstart_with_mpc_solution: bool = False
    n_paths: int = 4  # homotopy classes (ref guidance_planner.yaml:11)
    samples_per_class: int = 1  # warmstart variations per class (batch axis)
    selection_weight_consistency: float = 0.75  # bonus for previously chosen class
    # Extra decelerate-to-stop guidance class (opt-in, selection-gated to
    # emergencies only).
    braking_class: bool = False
    braking_deceleration: float = 2.0  # [m/s^2]
    # "lateral" (default): homotopy classes constructed in the path frame
    # (guidance/homotopy.py); "prm": a seeded space-time Visibility-PRM
    # (guidance/prm.py); "sampled": one batched sweep of
    # `sampled_n_samples` candidate paths on the planner's device
    # (guidance/device_prm.py).
    guidance_backend: str = "lateral"
    sampled_n_samples: int = 512
    prm_n_samples: int = 30  # ref guidance_planner.yaml n_samples
    prm_seed: int = 1  # ref guidance_planner.yaml seed
    prm_max_velocity: float = 3.0  # edge velocity budget [m/s]
    prm_margin: float = 0.1  # extra clearance in collision checks [m]
    prm_n_goals: int = 5  # lateral goal fan per longitudinal station
    prm_n_goals_longitudinal: int = 3
    prm_spline_smoothing: bool = True
    prm_goal_length_weight: float = 2.0  # shortfall penalty per meter


@dataclass(frozen=True)
class ProbabilisticConfig:
    enable: bool = True
    risk: float = 0.05
    propagate_uncertainty: bool = True


@dataclass(frozen=True)
class ScenarioConfig:
    """SH-MPC settings (ref scenario_constraints.py, settings.yaml:45-46;
    the reference's comments on each choice are in
    mpc_planner_tpu/utils/config.py)."""

    parallel_solvers: int = 4
    n_constraints: int = 24  # halfspaces per stage (ref scenario_constraints.py:26)
    # Scenario samples drawn per solver. None derives the draw from
    # (probabilistic.risk, confidence, support_bound) through the nonconvex
    # scenario bound (modules/scenario_theory.py::sample_size); an int
    # overrides the sizing. The a-posteriori certificate is computed either way.
    n_samples: Optional[int] = None
    confidence: float = 0.01  # beta: the certificate holds w.p. >= 1 - beta
    # Per-stage support cardinality the draw is sized for (the certificate
    # uses the observed count).
    support_bound: int = 3
    # Lateral warm-start span [m] across the parallel solvers (0: every
    # solver starts from the planner's warm start, as the reference does).
    warmstart_span: float = 0.0
    enable_safe_horizon: bool = True


@dataclass(frozen=True)
class DecompConfig:
    range: float = 2.0
    max_constraints: int = 12
    occupancy_threshold: int = 127


@dataclass(frozen=True)
class RoadConfig:
    two_way: bool = False
    width: float = 6.0


@dataclass(frozen=True)
class RobotConfig:
    length: float = 0.65
    width: float = 0.65
    com_to_back: float = 0.0


@dataclass(frozen=True)
class SolverConfig:
    iterations: int = 10  # SQP-RTI iterations (ref settings.yaml:16)
    qp_iterations: int = 9  # IP iterations of a cold QP
    # "cuda": the hand-written Hopper QP + MIRROR kernels (ops/cuda_qp.py);
    # "torch": the plain batched torch path (solver/qp.py); "auto": cuda
    # when the solver's device is CUDA and the QP kernel is instantiated
    # for (nu, nx) (ops/cuda_qp.py::QP_SHAPES), else torch.
    qp_backend: str = "auto"
    # The fused route: with the cuda backend, SQP_RTI and Mehrotra warm QPs,
    # the whole RTI loop runs in one launch of the fused kernel K3
    # (ops/cuda_rti.py). "auto" takes it wherever those hold and the
    # stage-code generator covers the OCP (SQPSolver.rti_fused_reason says
    # why not); "on" raises for an OCP it does not cover; "off": the
    # unfused loop. (The reference's "auto" resolves off: its compiler
    # cannot build the fused program, mpc_planner_tpu/solver/sqp.py:195-207.)
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
    # Solve the QP's Newton systems with the parallel-in-horizon scans
    # (solver/parallel_riccati.py: O(log N) dependent rounds) in place of
    # the sequential Riccati sweeps. Acts on qp_backend="torch" only: the
    # kernels K1 and K3 ignore it and keep their sequential recursion, as
    # the reference's Pallas route ignores it
    # (mpc_planner_tpu/utils/config.py:229-235).
    horizon_parallel: bool = False
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
    max_obstacle_distance: float = 30.0  # [m] obstacles farther away are dropped
    debug_limits: bool = False

    robot: RobotConfig = field(default_factory=RobotConfig)
    road: RoadConfig = field(default_factory=RoadConfig)
    contouring: ContouringConfig = field(default_factory=ContouringConfig)
    t_mpc: TMPCConfig = field(default_factory=TMPCConfig)
    probabilistic: ProbabilisticConfig = field(default_factory=ProbabilisticConfig)
    scenario_constraints: ScenarioConfig = field(default_factory=ScenarioConfig)
    decomp: DecompConfig = field(default_factory=DecompConfig)
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

    def with_weights(self, **weights: float) -> "Config":
        merged = dict(self.weights)
        merged.update(weights)
        return dataclasses.replace(self, weights=merged)


def default_config(**overrides: Any) -> Config:
    return Config().replace(**overrides) if overrides else Config()


def _nested_update(cfg: Config, data: Dict[str, Any]) -> Config:
    """Apply a (possibly nested) dict of overrides onto a Config: the
    reference's rules (mpc_planner_tpu/utils/config.py:319-346), keys
    renamed as settings.yaml spells them, unknown keys skipped."""
    kwargs: Dict[str, Any] = {}
    field_names = {f.name for f in dataclasses.fields(Config)}
    rename = {"t-mpc": "t_mpc", "use_t-mpc++": "use_tmpc_pp"}
    for key, value in data.items():
        key = rename.get(key, key)
        if key not in field_names:
            continue
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            sub_fields = {f.name for f in dataclasses.fields(current)}
            sub_kwargs = {rename.get(k, k): v for k, v in value.items()
                          if rename.get(k, k) in sub_fields}
            kwargs[key] = dataclasses.replace(current, **sub_kwargs)
        elif key == "weights" and isinstance(value, dict):
            kwargs[key] = {**current, **value}
        else:
            kwargs[key] = value
    return dataclasses.replace(cfg, **kwargs)


def load_config(path: Optional[str] = None, data: Optional[Dict[str, Any]] = None) -> Config:
    """A Config from a YAML file or a dict with settings.yaml's keys. pyyaml
    is imported only for a path; without it a path raises."""
    cfg = Config()
    if path is not None:
        try:
            import yaml
        except ImportError as e:
            raise RuntimeError("pyyaml unavailable; pass `data=` instead") from e
        with open(path) as f:
            data = yaml.safe_load(f)
    if data:
        cfg = _nested_update(cfg, data)
    return cfg
