from mpc_planner_tpu_torch.models.dynamics import (
    ContouringSecondOrderUnicycleModel,
    DynamicsModel,
    SecondOrderUnicycleModel,
)

__all__ = [
    "DynamicsModel",
    "SecondOrderUnicycleModel",
    "ContouringSecondOrderUnicycleModel",
]
