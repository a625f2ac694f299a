"""Defining a new robot system from scratch: the workflow the reference
implements as a new `mpc_planner_<system>` package plus a
`generate_<system>_solver.py` script.

The port's counterpart of examples/03_custom_system.py. The three
ingredients are plain Python, no code generation by hand:

  1. a dynamics model (subclass `DynamicsModel`, written with torch ops;
     the reference writes a CasADi model in solver_model.py),
  2. a module set with custom weighted costs (the reference's
     `configuration_*()` in its generate script),
  3. config deltas (the reference's per-system settings.yaml).

The system: a planar omnidirectional base ("omni") with linear drag, a
custom speed-tracking cost, and ellipsoidal pedestrian avoidance. On the
card the solver builds its fused kernel from generated code for this OCP.

    python -m mpc_planner_tpu_torch.examples.custom_system [--device cpu]
"""

import numpy as np
import torch

from mpc_planner_tpu_torch import RealTimeData, State, default_config
from mpc_planner_tpu_torch.data_preparation import (
    HostObstacle,
    ensure_obstacle_size,
    get_constant_velocity_prediction,
    pack_obstacles,
)
from mpc_planner_tpu_torch.examples import parser
from mpc_planner_tpu_torch.models import DynamicsModel
from mpc_planner_tpu_torch.modules import (
    EllipsoidConstraintModule,
    GoalModule,
    ModuleManager,
    MPCBaseModule,
)
from mpc_planner_tpu_torch.planner import Planner


# -- 1. dynamics model (ref solver_model.py subclassing pattern) -----------
class OmniDragModel(DynamicsModel):
    """Omnidirectional base with linear velocity drag.

    z = (ax, ay, x, y, vx, vy);  dv = a - drag * v.
    """

    drag = 0.35
    states = ("x", "y", "vx", "vy")
    inputs = ("ax", "ay")
    lower_bound = (-1.5, -1.5, -200.0, -200.0, -2.0, -2.0)
    upper_bound = (1.5, 1.5, 200.0, 200.0, 2.0, 2.0)

    def continuous_model(self, x, u):
        return torch.stack([x[..., 2], x[..., 3],
                            u[..., 0] - self.drag * x[..., 2],
                            u[..., 1] - self.drag * x[..., 3]], dim=-1)

    def continuous_model_integrated(self, x_full, x_int, u):
        return self.continuous_model(x_int, u)


def main(argv=None):
    args = parser(__doc__.split("\n\n")[0]).parse_args(argv)
    # -- 3. config deltas (ref per-system settings.yaml) -------------------
    cfg = default_config(N=12)
    cfg.weights["speed"] = 0.08  # cruise-tracking weight
    cfg.weights["cruise_speed"] = 1.2  # live-tunable, a parameter
    cfg.weights["goal"] = 2.5

    # -- 2. module set (ref generate_<system>_solver.py configuration) ----
    model = OmniDragModel()
    modules = ModuleManager()
    base = modules.add_module(MPCBaseModule(cfg))
    base.weigh_variable("ax", "acceleration")
    base.weigh_variable("ay", "acceleration")
    # Custom cost lambda, like the reference's
    #   base.weigh_variable(var_name="v", weight_names=["velocity", ...],
    #                       cost_function=lambda x, w: w[0]*(x-w[1])**2)
    base.weigh_variable("vx", ["speed", "cruise_speed"],
                        cost_function=lambda x, w: w[0] * (x - w[1]) ** 2)
    modules.add_module(GoalModule(cfg))
    modules.add_module(EllipsoidConstraintModule(cfg))

    planner = Planner(model, modules, cfg, device=args.device)

    state = State(model)
    data = RealTimeData()
    data.robot_area = planner.default_robot_area()
    data.goal = np.array([8.0, 0.0])
    data.goal_received = True

    # One pedestrian crossing the straight-line route.
    ped_pos = np.array([4.0, -2.0])
    ped_vel = np.array([0.0, 0.55])

    for step in range(80):
        # Gaussian prediction: the ellipsoid axes grow with the propagated
        # uncertainty, chi-scaled by cfg.probabilistic.risk (ref
        # ellipsoid_constraints.cpp:80).
        obstacles = [HostObstacle(
            index=0, position=ped_pos.copy(), angle=0.0, radius=0.35,
            prediction=get_constant_velocity_prediction(ped_pos, ped_vel, cfg.dt, cfg.N,
                                                        probabilistic=True))]
        # Pad/sort to exactly cfg.max_obstacles with +100 m dummies
        # (fixed shapes; ref data_preparation.cpp:95-168).
        obstacles = ensure_obstacle_size(obstacles, state, cfg.max_obstacles, cfg.N, cfg.dt, True)
        data.dynamic_obstacles = obstacles
        data.obstacle_block = pack_obstacles(obstacles, cfg.N)
        planner.on_data_received(data, "dynamic obstacles")

        out = planner.solve_mpc(state, data)
        assert out.success

        z = np.concatenate([[planner.get_solution(0, "ax"), planner.get_solution(0, "ay")],
                            state.as_array()])
        state.from_array(model.discrete_dynamics(torch.as_tensor(z, dtype=torch.float32),
                                                 None, cfg.dt).numpy())
        ped_pos = ped_pos + ped_vel * cfg.dt

        clearance = np.linalg.norm(state.get_position() - ped_pos)
        assert clearance > 0.35 + cfg.robot_radius - 1e-6, "collision!"
        if step % 10 == 0:
            print(f"step {step:3d}: pos=({state.get('x'):5.2f}, {state.get('y'):5.2f})"
                  f"  |v|={np.hypot(state.get('vx'), state.get('vy')):4.2f}"
                  f"  ped-clearance={clearance:4.2f}")
        if planner.is_objective_reached(state, data):
            print(f"goal reached in {step} steps, no collision")
            break
    else:
        raise SystemExit("did not reach the goal")


if __name__ == "__main__":
    main()
