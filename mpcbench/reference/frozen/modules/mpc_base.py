"""Generic weighted state/input penalties.

Counterpart of mpc_planner_tpu/modules/mpc_base.py, the reference
MPCBaseModule:
symbolic half mpc_planner_modules/scripts/mpc_base.py:12-92, runtime half
mpc_planner_modules/src/mpc_base.cpp:10-35 (uploads CONFIG weights each
stage).
"""

from __future__ import annotations

from typing import Callable, List

from mpcbench.reference.frozen.modules.base import BoundModel, ObjectiveModule
from mpcbench.reference.frozen.parameters import ParameterBlock, ParameterRegistry


def _default_cost(x, w):
    return w[0] * x**2


class MPCBaseModule(ObjectiveModule):
    module_name = "MPCBaseModule"
    description = "Input and state penalties with runtime-tunable weights"

    def __init__(self, cfg):
        self.cfg = cfg
        self._weights: List[str] = []
        self._weights_per_function: List[List[str]] = []
        self._variables_per_function: List[str] = []
        self._cost_functions: List[Callable] = []

    def weigh_variable(self, var_name: str, weight_names, cost_function=_default_cost, **_):
        """Register a weighted penalty (ref mpc_base.py:34-49). Default cost
        w[0] * var^2; custom e.g. lambda x, w: w[0]*(x-w[1])**2."""
        if not isinstance(weight_names, list):
            weight_names = [weight_names]
        self._weights.extend(weight_names)
        self._weights_per_function.append(weight_names)
        self._variables_per_function.append(var_name)
        self._cost_functions.append(cost_function)

    def define_parameters(self, params: ParameterRegistry) -> None:
        for w in self._weights:
            params.add(w, add_to_rqt_reconfigure=True)

    def cost(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        total = 0.0
        for fn, weight_names, var_name in zip(
            self._cost_functions, self._weights_per_function, self._variables_per_function
        ):
            weights = [params.get(w) for w in weight_names]
            variable = model.get(var_name)
            total = total + fn(variable, weights)
        return total

    # Host half: stream current weight values into every stage
    # (ref mpc_base.cpp:22-33 reads CONFIG["weights"][name]).
    def set_parameters(self, data, module_data, pblock: ParameterBlock) -> None:
        for w in self._weights:
            pblock.set_all_stages(w, self.cfg.weights.get(w, 0.0))
