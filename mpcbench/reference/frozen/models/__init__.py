from mpcbench.reference.frozen.models.dynamics import (
    BicycleModel2ndOrder,
    BicycleModel2ndOrderCurvatureAware,
    ContouringSecondOrderUnicycleModel,
    ContouringSecondOrderUnicycleModelCurvatureAware,
    ContouringSecondOrderUnicycleModelWithSlack,
    DynamicsModel,
    PointMassModel,
    SecondOrderUnicycleModel,
)

__all__ = [
    "DynamicsModel",
    "SecondOrderUnicycleModel",
    "PointMassModel",
    "ContouringSecondOrderUnicycleModel",
    "ContouringSecondOrderUnicycleModelCurvatureAware",
    "ContouringSecondOrderUnicycleModelWithSlack",
    "BicycleModel2ndOrder",
    "BicycleModel2ndOrderCurvatureAware",
]
