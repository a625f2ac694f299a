from mpc_planner_tpu_torch.modules.base import (
    BoundModel,
    ConstraintModule,
    Module,
    ModuleManager,
    ObjectiveModule,
)
from mpc_planner_tpu_torch.modules.contouring import ContouringModule
from mpc_planner_tpu_torch.modules.contouring_constraints import ContouringConstraintModule
from mpc_planner_tpu_torch.modules.curvature_aware_contouring import CurvatureAwareContouringModule
from mpc_planner_tpu_torch.modules.decomp_constraints import DecompConstraintModule
from mpc_planner_tpu_torch.modules.ellipsoid_constraints import EllipsoidConstraintModule
from mpc_planner_tpu_torch.modules.gaussian_constraints import GaussianConstraintModule
from mpc_planner_tpu_torch.modules.goal import GoalModule
from mpc_planner_tpu_torch.modules.guidance_constraints import GuidanceConstraintModule
from mpc_planner_tpu_torch.modules.linearized_constraints import LinearizedConstraintModule
from mpc_planner_tpu_torch.modules.mpc_base import MPCBaseModule
from mpc_planner_tpu_torch.modules.path_reference_velocity import PathReferenceVelocityModule
from mpc_planner_tpu_torch.modules.scenario_constraints import ScenarioConstraintModule

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
    "CurvatureAwareContouringModule",
    "EllipsoidConstraintModule",
    "GaussianConstraintModule",
    "LinearizedConstraintModule",
    "ContouringConstraintModule",
    "DecompConstraintModule",
    "GuidanceConstraintModule",
    "ScenarioConstraintModule",
]
