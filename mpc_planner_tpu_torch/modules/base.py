"""Module system: objective/constraint modules with a traced half and a
host half.

Counterpart of mpc_planner_tpu/modules/base.py. The reference's split
module architecture maps onto one class:
  * the Python symbolic half (mpc_planner_modules/scripts/*.py +
    solver_generator/control_modules.py:4-117) becomes the *traced* half —
    `cost(model, params, cfg, stage_idx)` / `constraints(...)` are pure
    tensor functions that the solver differentiates with torch.func; and
  * the C++ runtime half (ControllerModule::update/setParameters,
    controller_module.h:35-137) becomes the *host* half —
    `update(state, data, module_data)` + `set_parameters(data, module_data,
    pblock)` fill a [N+1, npar] ParameterBlock with vectorized numpy writes
    instead of the reference's per-(stage, param) setter calls.

One class holds both halves (the reference pairs them by name across two
languages; here the pairing is the class itself).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np

from mpc_planner_tpu_torch.parameters import ParameterBlock, ParameterRegistry


class BoundModel:
    """Adapter giving the traced half name-based access to z = (u, x).

    Mirrors `model.get(name)` in the reference symbolic scripts
    (solver_model.py:140-147). `z` is the traced per-stage decision vector.
    """

    def __init__(self, model, z):
        self._model = model
        self._z = z

    def get(self, name: str):
        return self._model.get(self._z, name)

    def has(self, name: str) -> bool:
        try:
            self._model.index(name)
            return True
        except KeyError:
            return False

    def get_or(self, name: str, default=0.0):
        return self.get(name) if self.has(name) else default

    @property
    def width(self) -> float:
        return self._model.width

    def get_bounds(self, name: str):
        return self._model.get_bounds(name)


class Module:
    """Base module; see class docstring above for the two halves."""

    module_name: str = "Module"
    module_type: str = "objective"  # or "constraint"
    description: str = ""

    # -- offline half ----------------------------------------------------
    def define_parameters(self, params: ParameterRegistry) -> None:
        pass

    # -- traced half -----------------------------------------------------
    def cost(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        """Stage cost contribution (objective modules). `stage_idx` is a
        *static* Python int: 0..N-1 for path stages, N for the terminal node
        (the reference evaluates the terminal expression at stage N-1,
        generate_acados_solver.py:52)."""
        return 0.0

    def constraints(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        """List of h-constraint expressions for this stage (constraint
        modules)."""
        return []

    def lower_bounds(self) -> List[float]:
        return []

    def upper_bounds(self) -> List[float]:
        return []

    @property
    def nh(self) -> int:
        return len(self.lower_bounds())

    # -- host half (ref controller_module.h API) -------------------------
    def update(self, state, data, module_data) -> None:
        pass

    def set_parameters(self, data, module_data, pblock: ParameterBlock) -> None:
        """Fill the parameter block for ALL stages (vectorized).

        Note the terminal row pblock.data[N] should carry stage N-1's
        parameters; `ParameterBlock` callers finalize that via
        `finalize_terminal_row` in the planner (matching
        acados_solver_interface.cpp:128-134)."""

    def is_data_ready(self, data) -> Tuple[bool, str]:
        return True, ""

    def on_data_received(self, data, data_name: str) -> None:
        pass

    def is_objective_reached(self, state, data) -> bool:
        return True

    def reset(self) -> None:
        pass

    def optimize(self, state, data, module_data) -> Optional[dict]:
        """Custom-optimize escape hatch (ref controller_module.h:optimize,
        EXIT_CODE_NOT_OPTIMIZED_YET=-999): return None to fall through to
        the default solver, or a result dict to take over the solve
        (T-MPC++ / SH-MPC)."""
        return None

    def save_data(self, record: dict) -> None:
        """Per-cycle metric export hook (ref controller_module.h:120-125
        saveData(DataSaver&)): write module metrics into one iteration
        record. Keys should be prefixed with the module's name to avoid
        collisions."""


def _scoped(scope, prefix: str, module):
    return contextlib.nullcontext() if scope is None else scope(prefix + module.module_name)


class ObjectiveModule(Module):
    module_type = "objective"


class ConstraintModule(Module):
    module_type = "constraint"


class ModuleManager:
    """Ordered module list + NLP stage assembly.

    Mirrors solver_generator/control_modules.py ModuleManager and
    solver_definition.py:5-77 (define_parameters / objective / constraints
    / bounds aggregation).
    """

    def __init__(self, modules: Optional[List[Module]] = None):
        self.modules: List[Module] = list(modules) if modules else []

    def add_module(self, module: Module) -> Module:
        self.modules.append(module)
        return module

    def __iter__(self):
        return iter(self.modules)

    def get(self, name: str) -> Optional[Module]:
        for m in self.modules:
            if m.module_name == name:
                return m
        return None

    # -- offline assembly -------------------------------------------------
    def define_parameters(self, params: ParameterRegistry) -> ParameterRegistry:
        for module in self.modules:
            module.define_parameters(params)
        return params

    def objective(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        total = 0.0
        for module in self.modules:
            if module.module_type == "objective":
                total = total + module.cost(model, params, cfg, stage_idx)
        return total

    def constraints(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        out = []
        for module in self.modules:
            if module.module_type == "constraint":
                out.extend(module.constraints(model, params, cfg, stage_idx))
        return out

    def constraint_lower_bounds(self) -> np.ndarray:
        out: List[float] = []
        for module in self.modules:
            if module.module_type == "constraint":
                out.extend(module.lower_bounds())
        return np.asarray(out, dtype=float)

    def constraint_upper_bounds(self) -> np.ndarray:
        out: List[float] = []
        for module in self.modules:
            if module.module_type == "constraint":
                out.extend(module.upper_bounds())
        return np.asarray(out, dtype=float)

    def constraint_number(self) -> int:
        return sum(m.nh for m in self.modules if m.module_type == "constraint")

    # -- host orchestration (ref planner.cpp loops) -----------------------
    def is_data_ready(self, data) -> Tuple[bool, str]:
        ready = True
        missing = []
        for m in self.modules:
            ok, msg = m.is_data_ready(data)
            if not ok:
                ready = False
                if msg:
                    missing.append(msg)
        return ready, ", ".join(missing)

    def update_all(self, state, data, module_data, scope=None) -> None:
        """Each module's update; `scope(name)` (a Profiler's) times each as
        `update.<module_name>`."""
        for m in self.modules:
            with _scoped(scope, "update.", m):
                m.update(state, data, module_data)

    def save_data_all(self) -> dict:
        """Collect every module's saveData metrics for one iteration
        record (ref planner.cpp saveData loop over modules)."""
        record: dict = {}
        for m in self.modules:
            m.save_data(record)
        return record

    def set_parameters_all(self, data, module_data, pblock: ParameterBlock, scope=None) -> None:
        """Each module's parameter fill, timed as `set_parameters.<module_name>`
        by `scope` where given."""
        for m in self.modules:
            with _scoped(scope, "set_parameters.", m):
                m.set_parameters(data, module_data, pblock)

    def on_data_received(self, data, data_name: str) -> None:
        for m in self.modules:
            m.on_data_received(data, data_name)

    def reset_all(self) -> None:
        for m in self.modules:
            m.reset()
