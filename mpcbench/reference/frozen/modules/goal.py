"""Goal tracking objective.

Ref symbolic half mpc_planner_modules/scripts/goal_module.py:12-47,
runtime half mpc_planner_modules/src/goal_module.cpp:14-72.
"""

from __future__ import annotations

import numpy as np

from mpcbench.reference.frozen.modules.base import BoundModel, ObjectiveModule
from mpcbench.reference.frozen.parameters import ParameterBlock, ParameterRegistry


class GoalModule(ObjectiveModule):
    module_name = "GoalModule"
    description = "Tracks a goal in 2D"

    def __init__(self, cfg):
        self.cfg = cfg

    def define_parameters(self, params: ParameterRegistry) -> None:
        params.add("goal_weight", add_to_rqt_reconfigure=True)
        params.add("goal_x")
        params.add("goal_y")

    def cost(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        pos_x, pos_y = model.get("x"), model.get("y")
        goal_weight = params.get("goal_weight")
        goal_x, goal_y = params.get("goal_x"), params.get("goal_y")
        # Normalized quadratic goal cost (ref goal_module.py:35)
        return (
            goal_weight
            * ((pos_x - goal_x) ** 2 + (pos_y - goal_y) ** 2)
            / (goal_x**2 + goal_y**2 + 0.01)
        )

    # Host half (ref goal_module.cpp:29-43)
    def set_parameters(self, data, module_data, pblock: ParameterBlock) -> None:
        goal = data.goal if data.goal is not None else np.zeros(2)
        pblock.set_all_stages("goal_weight", self.cfg.weights.get("goal", 1.0))
        pblock.set_all_stages("goal_x", float(goal[0]))
        pblock.set_all_stages("goal_y", float(goal[1]))

    def is_data_ready(self, data):
        if not data.goal_received:
            return False, "goal"
        return True, ""

    def is_objective_reached(self, state, data) -> bool:
        # Within 1 m of the goal (ref goal_module.cpp:56-63)
        if data.goal is None:
            return False
        return bool(np.linalg.norm(state.get_position() - np.asarray(data.goal)) < 1.0)
