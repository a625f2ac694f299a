"""Planner configurations and scenes (counterpart of
mpc_planner_tpu/presets.py). The port carries the configurations whose
modules it has: `system_jackal("goal")` (ref generate_jackal_solver.py:
31-50) and the corridor scene.
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
    EllipsoidConstraintModule,
    GoalModule,
    ModuleManager,
    MPCBaseModule,
)
from mpc_planner_tpu_torch.types import RealTimeData, State
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


def system_jackal(variant: str = "goal", **overrides):
    """mpc_planner_jackal (real robot): N=30, dt=0.2. The goal variant is
    goal tracking + ellipsoidal obstacle avoidance (:31-50): MPCBase +
    Goal + EllipsoidConstraints on the contouring unicycle.
    Returns (cfg, model, modules)."""
    if variant != "goal":
        raise ValueError(
            f"system_jackal variant {variant!r} needs modules not ported yet; "
            "only 'goal' is available")
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
