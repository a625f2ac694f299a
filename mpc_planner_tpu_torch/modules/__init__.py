from mpc_planner_tpu_torch.modules.base import (
    BoundModel,
    ConstraintModule,
    Module,
    ModuleManager,
    ObjectiveModule,
)
from mpc_planner_tpu_torch.modules.ellipsoid_constraints import EllipsoidConstraintModule
from mpc_planner_tpu_torch.modules.goal import GoalModule
from mpc_planner_tpu_torch.modules.mpc_base import MPCBaseModule

__all__ = [
    "Module",
    "ObjectiveModule",
    "ConstraintModule",
    "ModuleManager",
    "BoundModel",
    "MPCBaseModule",
    "GoalModule",
    "EllipsoidConstraintModule",
]
