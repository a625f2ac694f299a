"""Frozen copy of the port's planner.py, without its profiler.

Planner: one MPC cycle orchestration.

Counterpart of mpc_planner_tpu/planner.py (ref mpc_planner/src/
planner.cpp:37-158): data-ready check -> warmstart choice (keep /
shift-forward, or braking after an infeasible cycle) -> module `update`
-> parameter fill -> iteration budget -> module `optimize` override chain
else the plain SQP solve -> trajectory extraction.

The timeout budget (planner.cpp:117-118: 1/f - elapsed - margin) maps to
a host-side choice of RTI iteration count from the measured time per
iteration. The solve's result is copied to the host every cycle (the
planner publishes a numpy trajectory): that is a host sync by design.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from mpcbench.reference.frozen.modules.base import ModuleManager
from mpcbench.reference.frozen.parameters import ParameterBlock
from mpcbench.reference.frozen.solver.ocp import OCP
from mpcbench.reference.frozen.solver.sqp import EXIT_SUCCESS, SQPSolver
from mpcbench.reference.frozen.solver.warmstart import (
    initialize_warmstart,
    initialize_with_braking,
)
from mpcbench.reference.frozen.types import ModuleData, PlannerOutput, RealTimeData, State
import contextlib

logger = logging.getLogger(__name__)


class Planner:
    """Ref mpc_planner/include/mpc_planner/planner.h:34-68 API, on the plain
    route in `dtype` on `device`."""

    def __init__(self, model, modules: ModuleManager, cfg, device="cpu", dtype=torch.float64):
        self.cfg = cfg
        self.model = model
        self.modules = modules
        self.ocp = OCP(model, modules, cfg)
        self.solver = SQPSolver(self.ocp, device=device, dtype=dtype)
        # The control's hook: a function that rounds the parameter block.
        self.param_rounding = None
        self.N = cfg.N
        self.dt = cfg.integrator_step

        self._Z = np.zeros((self.N + 1, model.nvar))
        self._output = PlannerOutput(self.dt, self.N)
        self._module_data = ModuleData()
        self._iter_time_estimate: Optional[float] = None  # s per RTI iteration

        # Give modules a handle to the planner (the reference passes the
        # shared Solver into each module constructor, modules.h)
        for module in self.modules:
            if hasattr(module, "attach"):
                module.attach(self)

    # -- main cycle (ref planner.cpp:37-158) ------------------------------
    def solve_mpc(self, state: State, data: RealTimeData) -> PlannerOutput:
        was_feasible = self._output.success
        self._output = PlannerOutput(self.dt, self.N)
        self._module_data = ModuleData()
        module_data = self._module_data

        ready, missing = self.modules.is_data_ready(data)
        if not ready:
            self._output.success = False
            self._output.missing_data = missing
            return self._output

        with contextlib.nullcontext():
            # Warmstart selection (ref planner.cpp:78-86)
            shift_forward = self.cfg.shift_previous_solution_forward and self.cfg.enable_output
            if was_feasible:
                self._Z = initialize_warmstart(self.model, self.N, self._Z, state, shift_forward)
            else:
                self._Z = initialize_with_braking(
                    self.model, self.N, self.dt, state, self.cfg.deceleration_at_infeasible)

            self._publish_warmstart(module_data)

            with contextlib.nullcontext():
                self.modules.update_all(state, data, module_data)
            # `update` may have changed the state's spline variable
            xinit = np.array([state.get(n) for n in self.model.states])
            self._Z[0, self.model.nu:] = xinit

            with contextlib.nullcontext():
                pblock = ParameterBlock(self.ocp.params, self.N + 1)
                self.modules.set_parameters_all(data, module_data, pblock)
                self._finalize_terminal_row(pblock)
                if self.param_rounding is not None:
                    pblock.data = self.param_rounding(pblock.data)

            num_iterations = self._iterations_for_budget(data)
            module_data.pblock = pblock
            module_data.xinit = xinit
            module_data.num_iterations = num_iterations

            with contextlib.nullcontext():
                # Module optimize override chain (ref planner.cpp:126-134)
                result = None
                for module in self.modules:
                    result = module.optimize(state, data, module_data)
                    if result is not None:
                        break
                if result is None:
                    t0 = time.perf_counter()
                    res = self.solver.solve(self._Z, pblock.data, xinit, num_iterations)
                    Z = res.Z.cpu().numpy()
                    exit_code = int(res.exit_code)
                    pobj = float(res.pobj)
                    self._update_iter_time(time.perf_counter() - t0, num_iterations)
                else:
                    Z, exit_code, pobj = result["Z"], result["exit_code"], result["pobj"]

        if exit_code != EXIT_SUCCESS:
            self._output.success = False
            return self._output

        self._Z = Z
        self._output.success = True
        self._output.pobj = pobj
        if self.cfg.debug_limits:
            self._report_bound_hits(Z)
        for k in range(1, self.N):
            self._output.trajectory.add(self.get_solution(k, "x"), self.get_solution(k, "y"))
        return self._output

    def _report_bound_hits(self, Z, tol: float = 1e-3) -> None:
        """debug_limits: report solution variables at their bounds (ref
        acados_solver_interface.cpp:426-446 printIfBoundLimited)."""
        lb = np.asarray(self.model.lower_bound)
        ub = np.asarray(self.model.upper_bound)
        names = list(self.model.inputs) + list(self.model.states)
        for j, name in enumerate(names):
            if np.isfinite(lb[j]) and np.any(Z[:, j] <= lb[j] + tol):
                logger.warning("[debug_limits] '%s' hits its lower bound %s", name, lb[j])
            if np.isfinite(ub[j]) and np.any(Z[:, j] >= ub[j] - tol):
                logger.warning("[debug_limits] '%s' hits its upper bound %s", name, ub[j])

    # -- helpers -----------------------------------------------------------
    def _publish_warmstart(self, module_data: ModuleData) -> None:
        """Expose the warmstart (ego prediction) to the modules."""
        module_data.warmstart = self._Z
        module_data.warmstart_xy = self._Z[:, [self.model.index("x"), self.model.index("y")]]
        for attr, name in (("warmstart_psi", "psi"), ("warmstart_spline", "spline")):
            try:
                setattr(module_data, attr, self._Z[:, self.model.index(name)])
            except KeyError:
                setattr(module_data, attr, np.zeros(self.N + 1))

    def _finalize_terminal_row(self, pblock: ParameterBlock) -> None:
        """Terminal node gets stage N-1's parameters
        (ref acados_solver_interface.cpp:128-134)."""
        pblock.data[self.N] = pblock.data[self.N - 1]

    def _iterations_for_budget(self, data: RealTimeData) -> int:
        """Budget -> RTI iteration count (ref planner.cpp:117-118 +
        acados_solver_interface.cpp:108-116). Any count in
        [1, iterations] is fine: nothing is compiled per count."""
        max_iter = self.cfg.solver.iterations
        if self._iter_time_estimate is None or data.planning_start_time <= 0.0:
            return max_iter
        used = time.time() - data.planning_start_time
        budget = 1.0 / self.cfg.control_frequency - used - self.cfg.solver.timeout_margin
        if budget <= 0:
            return 1
        return int(np.clip(int(budget / self._iter_time_estimate), 1, max_iter))

    def _update_iter_time(self, elapsed: float, iterations: int) -> None:
        per_iter = elapsed / max(iterations, 1)
        if self._iter_time_estimate is None:
            self._iter_time_estimate = per_iter
        else:  # EWMA; the first cycle (kernel build) is an outlier
            self._iter_time_estimate = 0.7 * self._iter_time_estimate + 0.3 * per_iter

    # -- ref planner.h API --------------------------------------------------
    def get_solution(self, k: int, var_name: str) -> float:
        return float(self._Z[k, self.model.index(var_name)])

    def on_data_received(self, data: RealTimeData, data_name: str) -> None:
        self.modules.on_data_received(data, data_name)

    def is_objective_reached(self, state: State, data: RealTimeData) -> bool:
        return all(m.is_objective_reached(state, data) for m in self.modules)

    def reset(self, state: Optional[State] = None, data: Optional[RealTimeData] = None) -> None:
        self.modules.reset_all()
        self._Z = np.zeros_like(self._Z)
        self._output = PlannerOutput(self.dt, self.N)
        if state is not None:
            state.reset()
        if data is not None:
            data.reset()
