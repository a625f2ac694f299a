"""Minimal MPC loop: drive a unicycle to a goal point.

The port's counterpart of examples/01_goal_tracking.py: the smallest
complete use of the planner, a bare system node with only the goal
objective and input penalties (ref mpc_planner/src/planner.cpp cycle +
goal_module.py). No obstacles, no reference path.

    python -m mpc_planner_tpu_torch.examples.goal_tracking [--device cpu]
"""

import numpy as np
import torch

from mpc_planner_tpu_torch import RealTimeData, State, default_config
from mpc_planner_tpu_torch.examples import parser
from mpc_planner_tpu_torch.models import SecondOrderUnicycleModel
from mpc_planner_tpu_torch.modules import GoalModule, ModuleManager, MPCBaseModule
from mpc_planner_tpu_torch.planner import Planner


def main(argv=None):
    args = parser(__doc__.split("\n\n")[0]).parse_args(argv)
    cfg = default_config(N=10)

    # Module set: weighted input penalties + goal attraction
    # (ref configuration in generate_jackal_solver.py).
    model = SecondOrderUnicycleModel()
    modules = ModuleManager()
    base = modules.add_module(MPCBaseModule(cfg))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    modules.add_module(GoalModule(cfg))

    planner = Planner(model, modules, cfg, device=args.device)

    state = State(model)
    data = RealTimeData()
    data.robot_area = planner.default_robot_area()
    data.goal = np.array([5.0, 2.0])
    data.goal_received = True

    # Closed loop: solve -> apply the first input -> integrate the plant.
    for step in range(60):
        out = planner.solve_mpc(state, data)
        assert out.success, "solver reported infeasible"
        z = np.concatenate([[planner.get_solution(0, "a"), planner.get_solution(0, "w")],
                            state.as_array()])
        x_next = model.discrete_dynamics(torch.as_tensor(z, dtype=torch.float32), None, cfg.dt)
        state.from_array(x_next.numpy())
        dist = np.linalg.norm(state.get_position() - data.goal)
        if step % 10 == 0:
            print(f"step {step:3d}: pos=({state.get('x'):5.2f}, {state.get('y'):5.2f})"
                  f"  v={state.get('v'):4.2f}  dist-to-goal={dist:5.2f}")
        if planner.is_objective_reached(state, data):
            print(f"goal reached in {step} steps ({step * cfg.dt:.1f} s) on {planner.solver.device}")
            break
    else:
        raise SystemExit("did not reach the goal")


if __name__ == "__main__":
    main()
