"""Planner configurations and scenes (counterpart of
mpc_planner_tpu/presets.py; ref mpc_planner_jackalsimulator/scripts/
generate_jackalsimulator_solver.py:36-141). The port carries the
configurations whose modules it has: the T-MPC++ flagship
`system_jackalsimulator("tmpc")` with its "basic" and "no_obstacles"
variants, `system_jackal("goal")` (ref generate_jackal_solver.py:31-50),
and the corridor scene. Any other variant raises and names the ROADMAP.md
item that brings its modules.
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
from mpc_planner_tpu_torch.models import ContouringSecondOrderUnicycleModel
from mpc_planner_tpu_torch.modules import (
    ContouringModule,
    EllipsoidConstraintModule,
    GoalModule,
    GuidanceConstraintModule,
    ModuleManager,
    MPCBaseModule,
    PathReferenceVelocityModule,
)
from mpc_planner_tpu_torch.parameters import ParameterBlock
from mpc_planner_tpu_torch.solver.ocp import OCP
from mpc_planner_tpu_torch.solver.warmstart import initialize_with_state
from mpc_planner_tpu_torch.types import ModuleData, RealTimeData, State
from mpc_planner_tpu_torch.utils.config import default_config


def _add_base(modules: ModuleManager, cfg) -> MPCBaseModule:
    base = modules.add_module(MPCBaseModule(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
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


# Variants of the reference's presets whose modules are not ported yet, and
# the ROADMAP.md item that brings them.
_NOT_PORTED = {
    "safe_horizon": "M8 (SH-MPC)",
    "safe_horizon_hard": "M8 (SH-MPC)",
    "lmpcc": "M7 (the remaining presets)",
    "curvature_aware": "M7 (CA contouring and its models)",
    "tmpc_ca": "M7 (CA contouring and its models)",
    "tmpc_gaussian": "M7 (gaussian constraints)",
    "ca": "M7 (CA contouring and its models)",
}


def _not_ported(system: str, variant: str) -> ValueError:
    item = _NOT_PORTED.get(variant, "M7 (the remaining presets)")
    return ValueError(f"{system} variant {variant!r} is not ported yet: ROADMAP.md item {item}")


def system_jackalsimulator(variant: str = "tmpc", **overrides):
    """mpc_planner_jackalsimulator: N=30, dt=0.2, 10 RTI iterations
    (config/settings.yaml:2-17). Variants "tmpc" (the flagship), "basic"
    and "no_obstacles". Returns (cfg, model, modules)."""
    builders = {"tmpc": configuration_tmpc, "basic": configuration_basic,
                "no_obstacles": configuration_no_obstacles}
    if variant not in builders:
        raise _not_ported("system_jackalsimulator", variant)
    kw = dict(name="jackalsimulator", N=30, integrator_step=0.2)
    kw.update(overrides)
    cfg = default_config(**kw)
    model, modules = builders[variant](cfg)
    return cfg, model, modules


def system_jackal(variant: str = "goal", **overrides):
    """mpc_planner_jackal (real robot): N=30, dt=0.2. The goal variant is
    goal tracking + ellipsoidal obstacle avoidance (:31-50): MPCBase +
    Goal + EllipsoidConstraints on the contouring unicycle. (The jackal's
    T-MPC variant uses the Gaussian safety submodule, not ported yet.)
    Returns (cfg, model, modules)."""
    if variant != "goal":
        raise _not_ported("system_jackal", "tmpc_gaussian" if variant == "tmpc" else variant)
    kw = dict(name="jackal", N=30, integrator_step=0.2)
    kw.update(overrides)
    cfg = default_config(**kw)
    modules = ModuleManager()
    model = ContouringSecondOrderUnicycleModel()
    _add_base(modules, cfg)
    modules.add_module(GoalModule(cfg))
    modules.add_module(EllipsoidConstraintModule(cfg))
    return cfg, model, modules


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


def flagship_problem(cfg, n_pedestrians: int = 8, seed: int = 0):
    """The batch workload's one OCP instance (the reference's bench.py via
    __graft_entry__.py:13-39): configuration_tmpc on the corridor scene,
    one host pass of the modules (closest point, road halfspaces, guidance)
    around the state-held warm start, and the parameter block with its
    terminal row. Returns (model, ocp, Z0 [N+1, nvar], P [N+1, npar],
    xinit [nx]) as numpy arrays."""
    model, modules = configuration_tmpc(cfg)
    ocp = OCP(model, modules, cfg)
    state, data = corridor_scene(cfg, n_pedestrians=n_pedestrians, seed=seed)
    modules.on_data_received(data, "reference_path")
    Z0 = initialize_with_state(model, cfg.N, state)
    md = ModuleData()
    md.warmstart = Z0
    md.warmstart_xy = Z0[:, [model.index("x"), model.index("y")]]
    md.warmstart_psi = Z0[:, model.index("psi")]
    md.warmstart_spline = Z0[:, model.index("spline")]
    modules.update_all(state, data, md)
    pblock = ParameterBlock(ocp.params, cfg.N + 1)
    modules.set_parameters_all(data, md, pblock)
    pblock.data[cfg.N] = pblock.data[cfg.N - 1]
    xinit = np.array([state.get(n) for n in model.states])
    return model, ocp, Z0, pblock.data, xinit
