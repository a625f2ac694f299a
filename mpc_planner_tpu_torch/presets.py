"""Planner configurations and scenes (counterpart of
mpc_planner_tpu/presets.py; ref mpc_planner_jackalsimulator/scripts/
generate_jackalsimulator_solver.py:36-141 and the other systems'
generation scripts). Every configuration and system variant of the
reference builds here with the same model, modules, dimensions and
parameter names, the SH-MPC ones ("safe_horizon", "safe_horizon_hard")
included. `flagship_problem` is the batch workload's OCP instance.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from mpc_planner_tpu_torch.data_preparation import (
    HostObstacle,
    ensure_obstacle_size,
    get_constant_velocity_prediction,
    pack_obstacles,
)
from mpc_planner_tpu_torch.models import (
    BicycleModel2ndOrder,
    BicycleModel2ndOrderCurvatureAware,
    ContouringSecondOrderUnicycleModel,
    ContouringSecondOrderUnicycleModelCurvatureAware,
    ContouringSecondOrderUnicycleModelWithSlack,
    PointMassModel,
)
from mpc_planner_tpu_torch.modules import (
    ContouringModule,
    CurvatureAwareContouringModule,
    DecompConstraintModule,
    EllipsoidConstraintModule,
    GaussianConstraintModule,
    GoalModule,
    GuidanceConstraintModule,
    ModuleManager,
    MPCBaseModule,
    PathReferenceVelocityModule,
    ScenarioConstraintModule,
)
from mpc_planner_tpu_torch.parameters import ParameterBlock
from mpc_planner_tpu_torch.solver.ocp import OCP
from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
from mpc_planner_tpu_torch.types import ModuleData, RealTimeData, State
from mpc_planner_tpu_torch.utils.config import default_config


def _add_base(modules: ModuleManager, cfg, slack: bool = False) -> MPCBaseModule:
    base = modules.add_module(MPCBaseModule(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    if slack:
        base.weigh_variable("slack", "slack")
    if not cfg.contouring.dynamic_velocity_reference:
        base.weigh_variable(
            "v",
            ["velocity", "reference_velocity"],
            cost_function=lambda x, w: w[0] * (x - w[1]) ** 2,
        )
    return base


def configuration_no_obstacles(cfg):
    """Ref generate_jackalsimulator_solver.py:36-60: MPCBase + Contouring
    (+ PathReferenceVelocity with a dynamic velocity reference)."""
    modules = ModuleManager()
    model = ContouringSecondOrderUnicycleModel()
    _add_base(modules, cfg)
    modules.add_module(ContouringModule(cfg))
    if cfg.contouring.dynamic_velocity_reference:
        modules.add_module(PathReferenceVelocityModule(cfg))
    return model, modules


def configuration_basic(cfg):
    """Ref :63-68: + ellipsoidal avoidance."""
    model, modules = configuration_no_obstacles(cfg)
    modules.add_module(EllipsoidConstraintModule(cfg))
    return model, modules


def configuration_tmpc(cfg):
    """Ref :97-106: T-MPC++ with the ellipsoid safety submodule."""
    model, modules = configuration_no_obstacles(cfg)
    modules.add_module(GuidanceConstraintModule(cfg, EllipsoidConstraintModule))
    return model, modules


def configuration_safe_horizon(cfg):
    """Ref :71-94: SH-MPC on the slack model (slack an input, nu=3, nx=5)
    with scenario constraints."""
    modules = ModuleManager()
    model = ContouringSecondOrderUnicycleModelWithSlack()
    _add_base(modules, cfg, slack=True)
    modules.add_module(ContouringModule(cfg))
    if cfg.contouring.dynamic_velocity_reference:
        modules.add_module(PathReferenceVelocityModule(cfg))
    modules.add_module(ScenarioConstraintModule(cfg))
    return model, modules


def configuration_safe_horizon_hard(cfg):
    """SH-MPC without the slack: the same scenario halfspaces on the plain
    contouring model (nvar=7); infeasible draws are reported as such
    instead of being absorbed by the slack."""
    model, modules = configuration_no_obstacles(cfg)
    modules.add_module(ScenarioConstraintModule(cfg))
    return model, modules


def configuration_curvature_aware(cfg):
    """CA-MPC: curvature-aware contouring (projection-ratio s_dot cost on
    the discrete spline-projection model, ref solver_model.py:217-271 +
    curvature_aware_contouring.py:15-123) + ellipsoid avoidance."""
    modules = ModuleManager()
    model = ContouringSecondOrderUnicycleModelCurvatureAware()
    _add_base(modules, cfg)
    modules.add_module(CurvatureAwareContouringModule(cfg))
    modules.add_module(EllipsoidConstraintModule(cfg))
    return model, modules


def configuration_tmpc_ca(cfg):
    """T-MPC++ on the CA model: guidance constraints + CA contouring."""
    modules = ModuleManager()
    model = ContouringSecondOrderUnicycleModelCurvatureAware()
    _add_base(modules, cfg)
    modules.add_module(CurvatureAwareContouringModule(cfg))
    modules.add_module(GuidanceConstraintModule(cfg, EllipsoidConstraintModule))
    return model, modules


def configuration_bicycle(cfg, curvature_aware: bool = False):
    """Bicycle MPCC (ref solver_model.py:302-437): dynamic steering + slack
    input, contouring (CA variant optional) + ellipsoid avoidance (nu=3,
    nx=6, nvar=9)."""
    modules = ModuleManager()
    model = BicycleModel2ndOrderCurvatureAware() if curvature_aware else BicycleModel2ndOrder()
    _add_base(modules, cfg, slack=True)
    modules.add_module(
        CurvatureAwareContouringModule(cfg) if curvature_aware else ContouringModule(cfg))
    modules.add_module(EllipsoidConstraintModule(cfg))
    return model, modules


def configuration_lmpcc(cfg):
    """Ref :109-126: goal + velocity reference + ellipsoids."""
    modules = ModuleManager()
    model = ContouringSecondOrderUnicycleModel()
    base = modules.add_module(MPCBaseModule(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    modules.add_module(GoalModule(cfg))
    modules.add_module(PathReferenceVelocityModule(cfg))
    modules.add_module(EllipsoidConstraintModule(cfg))
    return model, modules


# -- per-system presets ------------------------------------------------------
# One factory per reference system package, each returning (cfg, model,
# modules) with the package's settings.yaml horizon, step and iteration
# values. As in the reference, a variant name a system does not know takes
# the system's last branch.

def system_jackalsimulator(variant: str = "tmpc", **overrides):
    """mpc_planner_jackalsimulator: N=30, dt=0.2, 10 RTI iterations
    (config/settings.yaml:2-17). Variants "tmpc" (the flagship), "basic",
    "no_obstacles", "safe_horizon", "safe_horizon_hard", "lmpcc",
    "curvature_aware", "tmpc_ca"."""
    kw = dict(name="jackalsimulator", N=30, integrator_step=0.2)
    kw.update(overrides)
    cfg = default_config(**kw)
    configurations = {
        "tmpc": configuration_tmpc,
        "basic": configuration_basic,
        "no_obstacles": configuration_no_obstacles,
        "safe_horizon": configuration_safe_horizon,
        "safe_horizon_hard": configuration_safe_horizon_hard,
        "lmpcc": configuration_lmpcc,
        "curvature_aware": configuration_curvature_aware,
        "tmpc_ca": configuration_tmpc_ca,
    }
    model, modules = configurations[variant](cfg)
    return cfg, model, modules


def system_jackal(variant: str = "tmpc", **overrides):
    """mpc_planner_jackal (real robot): N=30, dt=0.2; T-MPC uses the
    GAUSSIAN safety submodule (generate_jackal_solver.py:70:
    GuidanceConstraintModule(constraint_submodule=GaussianConstraintModule));
    "ca" is the same on the curvature-aware model; "goal" is goal tracking
    + ellipsoids (:31-50); "lmpcc" (:76-95) is contouring + ellipsoids."""
    kw = dict(name="jackal", N=30, integrator_step=0.2)
    kw.update(overrides)
    cfg = default_config(**kw)
    if variant == "tmpc":
        model, modules = configuration_no_obstacles(cfg)
        modules.add_module(GuidanceConstraintModule(cfg, GaussianConstraintModule))
    elif variant == "ca":
        modules = ModuleManager()
        model = ContouringSecondOrderUnicycleModelCurvatureAware()
        _add_base(modules, cfg)
        modules.add_module(CurvatureAwareContouringModule(cfg))
        modules.add_module(GuidanceConstraintModule(cfg, GaussianConstraintModule))
    elif variant == "goal":
        modules = ModuleManager()
        model = ContouringSecondOrderUnicycleModel()
        _add_base(modules, cfg)
        modules.add_module(GoalModule(cfg))
        modules.add_module(EllipsoidConstraintModule(cfg))
    else:  # lmpcc
        model, modules = configuration_basic(cfg)
    return cfg, model, modules


def system_dingo(variant: str = "tmpc", **overrides):
    """mpc_planner_dingo (omnidirectional): N=30, dt=0.1
    (config/settings.yaml:2-3). T-MPC mirrors jackalsimulator
    (generate_dingo_solver.py:48-65); the lmpcc variant uses the holonomic
    point-mass model with goal tracking + T-MPC guidance (:68-85)."""
    kw = dict(name="dingo", N=30, integrator_step=0.1)
    kw.update(overrides)
    cfg = default_config(**kw)
    if variant == "tmpc":
        model, modules = configuration_tmpc(cfg)
    else:  # point-mass goal tracking
        modules = ModuleManager()
        model = PointMassModel()
        base = modules.add_module(MPCBaseModule(cfg))
        base.weigh_variable("ax", "acceleration")
        base.weigh_variable("ay", "acceleration")
        modules.add_module(GoalModule(cfg))
        modules.add_module(GuidanceConstraintModule(cfg, EllipsoidConstraintModule))
    return cfg, model, modules


def system_rosnavigation(variant: str = "lmpcc", **overrides):
    """mpc_planner_rosnavigation (nav-stack local planner): N=20, dt=0.2,
    4 RTI iterations (config/settings.yaml:2-13); every variant adds
    costmap free-space DecompConstraints
    (generate_rosnavigation_solver.py:33-128). "tmpc" (:91-112) is the
    slack model + guidance + decomp, "safe_horizon" (:64-88) SH-MPC +
    decomp."""
    kw = dict(name="rosnavigation", N=20, integrator_step=0.2)
    kw.update(overrides)
    cfg = default_config(**kw)
    if "solver" not in overrides:  # settings.yaml iterations: 4
        cfg = cfg.replace(solver=cfg.solver.__class__(iterations=4))
    modules = ModuleManager()
    if variant == "tmpc":
        model = ContouringSecondOrderUnicycleModelWithSlack()
        _add_base(modules, cfg, slack=True)
        modules.add_module(ContouringModule(cfg))
        if cfg.contouring.dynamic_velocity_reference:
            modules.add_module(PathReferenceVelocityModule(cfg))
        modules.add_module(GuidanceConstraintModule(cfg, EllipsoidConstraintModule))
    elif variant == "safe_horizon":  # :64-88
        model, modules = configuration_safe_horizon(cfg)
    else:  # lmpcc, :33-61
        model = ContouringSecondOrderUnicycleModel()
        _add_base(modules, cfg)
        modules.add_module(ContouringModule(cfg))
        modules.add_module(PathReferenceVelocityModule(cfg))
        modules.add_module(EllipsoidConstraintModule(cfg))
    modules.add_module(DecompConstraintModule(cfg))  # :128
    return cfg, model, modules


SYSTEMS = {
    "jackalsimulator": system_jackalsimulator,
    "jackal": system_jackal,
    "dingo": system_dingo,
    "rosnavigation": system_rosnavigation,
}


def select_system(name: str, variant: str = None, **overrides):
    """System selection by name (the reference's select_system.py picks
    which robot package builds; here it picks the preset)."""
    factory = SYSTEMS[name]
    if variant is None:
        return factory(**overrides)
    return factory(variant=variant, **overrides)


def corridor_scene(cfg, n_pedestrians: int = 8, seed: int = 0) -> Tuple[State, RealTimeData]:
    """The reference's headline benchmark scene: a corridor with crossing
    pedestrians (mpc_planner_jackalsimulator/README.md corridor with
    4/8/12 pedestrians). Same seed, same scene as the JAX package."""
    rng = np.random.default_rng(seed)
    state = State(nx=5)

    data = RealTimeData()
    data.robot_area = [(0.0, cfg.robot.width / 2.0)]
    # Straight 30 m corridor
    xs = np.linspace(0.0, 30.0, 16)
    data.reference_path = {"x": xs, "y": np.zeros_like(xs)}
    data.goal = np.array([30.0, 0.0])
    data.goal_received = True

    obstacles = []
    for i in range(n_pedestrians):
        px = rng.uniform(4.0, 26.0)
        py = rng.uniform(-2.5, 2.5)
        speed = rng.uniform(0.4, 1.4)
        angle = rng.uniform(0, 2 * np.pi)
        vel = speed * np.array([np.cos(angle), np.sin(angle)])
        o = HostObstacle(index=i, position=np.array([px, py]), angle=angle,
                         radius=cfg.obstacle_radius)
        o.prediction = get_constant_velocity_prediction(
            o.position, vel, cfg.dt, cfg.N, cfg.probabilistic.enable
        )
        obstacles.append(o)
    obstacles = ensure_obstacle_size(
        obstacles, state, cfg.max_obstacles, cfg.N, cfg.dt, cfg.probabilistic.enable
    )
    data.dynamic_obstacles = obstacles
    data.obstacle_block = pack_obstacles(obstacles, cfg.N)
    data.ego_position = state.get_position()
    return state, data


def two_wall_costmap(seed: int = 0):
    """A synthetic occupancy grid for the decomp module: two walls along
    the corridor at y = +-(2.4..3.0) m (drawn from the seed), each with a
    gap, and its meta. [H, W] row-major (y, x), 0.2 m cells over x in
    [-2, 30], y in [-4, 4]."""
    rng = np.random.default_rng(seed)
    res, ox, oy = 0.2, -2.0, -4.0
    grid = np.zeros((40, 160), dtype=np.uint8)
    for side in (-1.0, 1.0):
        row = int((side * rng.uniform(2.4, 3.0) - oy) / res)
        grid[row, :] = 255
        gap = int(rng.integers(20, 140))
        grid[row, gap:gap + 6] = 0
    return grid, {"origin_x": ox, "origin_y": oy, "resolution": res}


def preset_problem(cfg, model, modules, n_pedestrians: int = 8, seed: int = 0,
                   costmap: bool = False):
    """One OCP instance of a built preset on the corridor scene (with the
    synthetic costmap for a decomp module): one host pass of the modules
    (closest point, road halfspaces, guidance, polytopes) around the
    state-held warm start, and the parameter block with its terminal row.
    Returns (ocp, Z0 [N+1, nvar], P [N+1, npar], xinit [nx]) as numpy
    arrays."""
    ocp = OCP(model, modules, cfg)
    state, data = corridor_scene(cfg, n_pedestrians=n_pedestrians, seed=seed)
    if costmap:
        data.costmap, data.costmap_meta = two_wall_costmap(seed)
    modules.on_data_received(data, "reference_path")
    Z0 = initialize_with_state(model, cfg.N, state)
    md = ModuleData()
    md.warmstart = Z0
    md.warmstart_xy = Z0[:, [model.index("x"), model.index("y")]]
    for attr, name in (("warmstart_psi", "psi"), ("warmstart_spline", "spline")):
        setattr(md, attr, Z0[:, model.index(name)] if name in model.states else np.zeros(cfg.N + 1))
    modules.update_all(state, data, md)
    pblock = ParameterBlock(ocp.params, cfg.N + 1)
    modules.set_parameters_all(data, md, pblock)
    pblock.data[cfg.N] = pblock.data[cfg.N - 1]
    xinit = np.array([state.get(n) for n in model.states])
    return ocp, Z0, pblock.data, xinit


def flagship_problem(cfg, n_pedestrians: int = 8, seed: int = 0):
    """The batch workload's one OCP instance (the reference's bench.py via
    __graft_entry__.py:13-39): configuration_tmpc on the corridor scene.
    Returns (model, ocp, Z0 [N+1, nvar], P [N+1, npar], xinit [nx]) as
    numpy arrays."""
    model, modules = configuration_tmpc(cfg)
    return (model, *preset_problem(cfg, model, modules, n_pedestrians, seed))
