from mpc_planner_tpu_torch.modules.base import (
    BoundModel,
    ConstraintModule,
    Module,
    ModuleManager,
    ObjectiveModule,
)
from mpc_planner_tpu_torch.modules.contouring import ContouringModule
from mpc_planner_tpu_torch.modules.ellipsoid_constraints import EllipsoidConstraintModule
from mpc_planner_tpu_torch.modules.goal import GoalModule
from mpc_planner_tpu_torch.modules.guidance_constraints import GuidanceConstraintModule
from mpc_planner_tpu_torch.modules.mpc_base import MPCBaseModule
from mpc_planner_tpu_torch.modules.path_reference_velocity import PathReferenceVelocityModule

__all__ = [
    "Module",
    "ObjectiveModule",
    "ConstraintModule",
    "ModuleManager",
    "BoundModel",
    "MPCBaseModule",
    "GoalModule",
    "ContouringModule",
    "PathReferenceVelocityModule",
    "EllipsoidConstraintModule",
    "GuidanceConstraintModule",
]
