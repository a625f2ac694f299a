from mpcbench.reference.frozen.modules.base import (
    BoundModel,
    ConstraintModule,
    Module,
    ModuleManager,
    ObjectiveModule,
)
from mpcbench.reference.frozen.modules.contouring import ContouringModule
from mpcbench.reference.frozen.modules.ellipsoid_constraints import EllipsoidConstraintModule
from mpcbench.reference.frozen.modules.goal import GoalModule
from mpcbench.reference.frozen.modules.guidance_constraints import GuidanceConstraintModule
from mpcbench.reference.frozen.modules.mpc_base import MPCBaseModule

__all__ = ["Module", "ObjectiveModule", "ConstraintModule", "ModuleManager", "BoundModel",
           "MPCBaseModule", "GoalModule", "ContouringModule", "EllipsoidConstraintModule",
           "GuidanceConstraintModule"]
