"""Planner: one MPC cycle orchestration.

Counterpart of mpc_planner_tpu/planner.py (ref mpc_planner/src/
planner.cpp:37-158): data-ready check -> warmstart choice (keep /
shift-forward, or braking after an infeasible cycle) -> module `update`
-> parameter fill -> iteration budget -> module `optimize` override chain
else the plain SQP solve -> trajectory extraction.

The timeout budget (planner.cpp:117-118: 1/f - elapsed - margin) maps to
a host-side choice of RTI iteration count from the measured time per
iteration. The solve's result is copied to the host every cycle (the
planner publishes a numpy trajectory): that is a host sync by design.

One `Profiler` serves the planner, its modules and its solver: the scopes
`planning`, `update` (`update.<module>` each), `set_parameters`
(`set_parameters.<module>`), `optimization`, the solver's spans inside it,
and the counters; every device-to-host read goes through `Profiler.pull`.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np

from mpc_planner_tpu_torch.data_preparation import define_robot_area
from mpc_planner_tpu_torch.modules.base import ModuleManager
from mpc_planner_tpu_torch.parameters import ParameterBlock
from mpc_planner_tpu_torch.solver.ocp import OCP
from mpc_planner_tpu_torch.solver.sqp import EXIT_SUCCESS, SQPSolver
from mpc_planner_tpu_torch.solver.warmstart import (
    initialize_warmstart,
    initialize_with_braking,
)
from mpc_planner_tpu_torch.types import ModuleData, PlannerOutput, RealTimeData, State
from mpc_planner_tpu_torch.utils.profiling import Profiler

logger = logging.getLogger(__name__)


class Planner:
    """Ref mpc_planner/include/mpc_planner/planner.h:34-68 API. `device`
    is where the solver's tensors live: None (the default) is the card,
    cuda:0, and an error without CUDA; "cpu" runs the plain versions."""

    def __init__(self, model, modules: ModuleManager, cfg, device=None):
        self.cfg = cfg
        self.model = model
        self.modules = modules
        self.ocp = OCP(model, modules, cfg)
        self.profiler = Profiler(track_gc=True)
        self.solver = SQPSolver(self.ocp, device=device, profiler=self.profiler)
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

        prof = self.profiler
        with prof.scope("planning"):
            # Warmstart selection (ref planner.cpp:78-86)
            shift_forward = self.cfg.shift_previous_solution_forward and self.cfg.enable_output
            if was_feasible:
                self._Z = initialize_warmstart(self.model, self.N, self._Z, state, shift_forward)
            else:
                self._Z = initialize_with_braking(
                    self.model, self.N, self.dt, state, self.cfg.deceleration_at_infeasible)

            self._publish_warmstart(module_data)

            with prof.scope("update"):
                self.modules.update_all(state, data, module_data, scope=prof.scope)
            # `update` may have changed the state's spline variable
            xinit = np.array([state.get(n) for n in self.model.states])
            self._Z[0, self.model.nu:] = xinit

            with prof.scope("set_parameters"):
                pblock = ParameterBlock(self.ocp.params, self.N + 1)
                self.modules.set_parameters_all(data, module_data, pblock, scope=prof.scope)
                self._finalize_terminal_row(pblock)

            num_iterations = self._iterations_for_budget(data)
            module_data.pblock = pblock
            module_data.xinit = xinit
            module_data.num_iterations = num_iterations

            with prof.scope("optimization"):
                # Module optimize override chain (ref planner.cpp:126-134)
                result = None
                for module in self.modules:
                    result = module.optimize(state, data, module_data)
                    if result is not None:
                        break
                if result is None:
                    t0 = time.perf_counter()
                    res = self.solver.solve(self._Z, pblock.data, xinit, num_iterations)
                    Z = prof.pull("Z", res.Z)
                    exit_code = int(prof.pull("exit_code", res.exit_code))
                    pobj = float(prof.pull("pobj", res.pobj))
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

    def get_ego_prediction(self, k: int, var_name: str) -> float:
        return float(self._Z[k, self.model.index(var_name)])

    def on_data_received(self, data: RealTimeData, data_name: str) -> None:
        self.modules.on_data_received(data, data_name)

    def visualize(self, state: State, data: RealTimeData):
        """Collect visualization artifacts for this cycle
        (ref planner.cpp:176-223 + per-module visualize()). The guidance
        module's batch of plans stays on the device between cycles; it is
        copied to the host here, once."""
        from mpc_planner_tpu_torch.utils.visualization import Visualizer

        viz = Visualizer()
        if len(self._output.trajectory) > 0:
            viz.add_trajectory(self._output.trajectory.positions, "planned_trajectory")
        if self._module_data.warmstart_xy is not None:
            viz.add_trajectory(self._module_data.warmstart_xy, "warmstart_trajectory")
        if data.obstacle_block is not None:
            viz.add_obstacles(data.obstacle_block)
            viz.add_prediction_ellipses(data.obstacle_block)
        if data.robot_area:
            viz.add_robot_area(state.get_position(), state.get("psi"), data.robot_area)
        if self._module_data.static_obstacles is not None:
            viz.add_halfspaces(self._module_data.static_obstacles.reshape(-1, 3), "road_constraints")
        gmod = self.modules.get("GuidanceConstraints")
        if gmod is not None and gmod._last_batch_Z is not None:
            viz.add_tmpc_candidates(gmod._last_batch_Z.cpu().numpy(), self.model,
                                    gmod._selected_planner)
        return viz

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

    def default_robot_area(self):
        return define_robot_area(self.cfg.robot.length, self.cfg.robot.width, self.cfg.n_discs)
