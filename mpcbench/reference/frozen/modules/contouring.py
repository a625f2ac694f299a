"""MPCC contouring objective (+ road halfspace construction).

Counterpart of mpc_planner_tpu/modules/contouring.py: the cost is torch on
tensors (splines.py), the host half is the reference's numpy. Ref symbolic
half mpc_planner_modules/scripts/contouring.py:15-112,
runtime half mpc_planner_modules/src/contouring.cpp (closest-point search
:28-48, weight/spline parameter upload :50-124, road halfspaces :190-262,
objective-reached :167-179).
"""

from __future__ import annotations

import numpy as np

from mpcbench.reference.frozen.modules.base import BoundModel, ObjectiveModule
from mpcbench.reference.frozen.parameters import ParameterBlock, ParameterRegistry
from mpcbench.reference.frozen.spline_fit import PathSpline2D
from mpcbench.reference.frozen.splines import Spline, Spline2D
from mpcbench.reference.frozen.utils.math import atan2, haar_difference_without_abs


class ContouringModule(ObjectiveModule):
    module_name = "Contouring"
    description = "MPCC: tracks a 2D reference path with contouring costs"

    def __init__(self, cfg):
        self.cfg = cfg
        self.num_segments = cfg.contouring.num_segments
        self.dynamic_velocity_reference = cfg.contouring.dynamic_velocity_reference
        self.add_road_constraints = cfg.contouring.add_road_constraints
        self.two_way_road = cfg.road.two_way
        self.spline: PathSpline2D | None = None
        self.bound_left: PathSpline2D | None = None
        self.bound_right: PathSpline2D | None = None
        self.closest_segment = -1
        self.road_width = cfg.road.width

    # -- offline half (ref contouring.py:22-47) ---------------------------
    def define_parameters(self, params: ParameterRegistry) -> None:
        params.add("contour", add_to_rqt_reconfigure=True)
        params.add("lag", add_to_rqt_reconfigure=True)
        if not params.has_parameter("velocity"):
            params.add("velocity", add_to_rqt_reconfigure=True)
            params.add("reference_velocity", add_to_rqt_reconfigure=True)
        params.add("terminal_angle", add_to_rqt_reconfigure=True)
        params.add("terminal_contouring", add_to_rqt_reconfigure=True)
        for i in range(self.num_segments):
            for coef in "abcd":
                params.add(f"spline_x{i}_{coef}", bundle_name=f"spline_x_{coef}")
            for coef in "abcd":
                params.add(f"spline_y{i}_{coef}", bundle_name=f"spline_y_{coef}")
            params.add(f"spline{i}_start", bundle_name="spline_start")

    # -- traced half (ref contouring.py:49-101) ---------------------------
    def cost(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        pos_x, pos_y = model.get("x"), model.get("y")
        psi, v, s = model.get("psi"), model.get("v"), model.get("spline")

        contour_weight = params.get("contour")
        lag_weight = params.get("lag")

        path = Spline2D(params, self.num_segments, s)
        path_x, path_y = path.at(s)
        dxn, dyn = path.deriv_normalized(s)

        contour_error = dyn * (pos_x - path_x) - dxn * (pos_y - path_y)
        lag_error = dxn * (pos_x - path_x) + dyn * (pos_y - path_y)

        total = lag_weight * lag_error**2 + contour_weight * contour_error**2

        if self.dynamic_velocity_reference:
            path_velocity = Spline(params, "spline_v", self.num_segments, s)
            reference_velocity = path_velocity.at(s)
            velocity_weight = params.get("velocity")
            total = total + velocity_weight * (v - reference_velocity) ** 2

        # Terminal cost: the reference builds the terminal expression with
        # stage_idx = N-1 and acados applies it at the terminal node
        # (contouring.py:84-96, generate_acados_solver.py:52).
        if stage_idx == cfg.N - 1 or stage_idx == cfg.N:
            terminal_angle_weight = params.get("terminal_angle")
            terminal_contouring_mp = params.get("terminal_contouring")

            path_angle = atan2(dyn, dxn)
            angle_error = haar_difference_without_abs(psi, path_angle)

            total = total + terminal_angle_weight * angle_error**2
            total = total + terminal_contouring_mp * lag_weight * lag_error**2
            total = total + terminal_contouring_mp * contour_weight * contour_error**2

        return total

    # -- host half ---------------------------------------------------------
    def on_data_received(self, data, data_name: str) -> None:
        # (ref contouring.cpp:126-157)
        if data_name != "reference_path" or data.reference_path is None:
            return
        rp = data.reference_path
        self.spline = PathSpline2D(rp["x"], rp["y"])
        if (
            self.add_road_constraints
            and data.left_bound is not None
            and data.right_bound is not None
        ):
            self.bound_left = PathSpline2D(data.left_bound[:, 0], data.left_bound[:, 1])
            self.bound_right = PathSpline2D(data.right_bound[:, 0], data.right_bound[:, 1])
            self.road_width = float(
                np.linalg.norm(self.bound_left.at(0.0) - self.bound_right.at(0.0))
            )
        self.closest_segment = -1

    def is_data_ready(self, data):
        if data.reference_path is None:
            return False, "Reference Path"
        return True, ""

    def update(self, state, data, module_data) -> None:
        # Closest point on the path; initializes the spline state
        # (ref contouring.cpp:28-48).
        if self.spline is None:
            return
        s_hint = None if self.closest_segment < 0 else state.get("spline")
        closest_s = self.spline.closest_point(
            state.get_position(), s_hint=s_hint, window=5.0 if s_hint is not None else None
        )
        self.closest_segment = self.spline.find_segment(closest_s)
        state.set("spline", closest_s)
        module_data.path = self.spline
        module_data.current_path_segment = self.closest_segment
        if self.add_road_constraints:
            self._construct_road_constraints(data, module_data)

    def set_parameters(self, data, module_data, pblock: ParameterBlock) -> None:
        w = self.cfg.weights
        pblock.set_all_stages("contour", w.get("contour", 0.0))
        pblock.set_all_stages("lag", w.get("lag", 0.0))
        pblock.set_all_stages("terminal_angle", w.get("terminal_angle", 0.0))
        pblock.set_all_stages("terminal_contouring", w.get("terminal_contouring", 0.0))
        if self.dynamic_velocity_reference:
            pblock.set_all_stages("velocity", w.get("velocity", 0.0))
            pblock.set_all_stages("reference_velocity", w.get("reference_velocity", 0.0))

        if self.spline is None:
            return
        seg = self.segment_param_arrays()
        for coef, key in zip("abcd", ("ax", "bx", "cx", "dx")):
            pblock.set_bundle_all_stages(f"spline_x_{coef}", seg[key])
        for coef, key in zip("abcd", ("ay", "by", "cy", "dy")):
            pblock.set_bundle_all_stages(f"spline_y_{coef}", seg[key])
        pblock.set_bundle_all_stages("spline_start", seg["s_start"])

    def segment_param_arrays(self):
        return self.spline.segment_param_arrays(max(self.closest_segment, 0), self.num_segments)

    def is_objective_reached(self, state, data) -> bool:
        # Within 1 m of the path end (ref contouring.cpp:167-179)
        if self.spline is None:
            return False
        end = self.spline.at(self.spline.length)
        return bool(np.linalg.norm(state.get_position() - end) < 1.0)

    def reset(self) -> None:
        self.spline = None
        self.closest_segment = -1

    # -- road halfspaces (ref contouring.cpp:190-262) ----------------------
    def _construct_road_constraints(self, data, module_data) -> None:
        N = self.cfg.N
        if module_data.static_obstacles is None:
            module_data.static_obstacles = np.zeros((N, 0, 3))
        if module_data.warmstart is None:
            return
        halfspaces = np.zeros((N, 2, 3))

        # Ego-predicted progress per stage (k = 1..N-1; k = 0 unconstrained)
        s_pred = module_data.warmstart_spline  # set by planner: [N+1]
        if s_pred is None:
            return
        robot_radius = data.robot_area[0][1] if data.robot_area else self.cfg.robot_radius

        if self.bound_left is None or self.bound_right is None:
            width_half = self.road_width / 2.0
            width_times = 3.0 if self.two_way_road else 1.0
            for k in range(1, N):
                s = float(np.clip(s_pred[k], 0.0, self.spline.length))
                point = self.spline.at(s)
                d = self.spline.deriv(s)
                d = d / (np.linalg.norm(d) + 1e-12)
                ortho = np.array([d[1], -d[0]])  # getOrthogonal
                # LEFT: A x <= b with A = ortho
                bl = ortho @ (point + ortho * (width_times * width_half - robot_radius))
                halfspaces[k, 0] = [ortho[0], ortho[1], bl]
                # RIGHT: -A x <= -b'
                br = ortho @ (point - ortho * (width_half - robot_radius))
                halfspaces[k, 1] = [-ortho[0], -ortho[1], -br]
        else:
            for k in range(1, N):
                s = float(np.clip(s_pred[k], 0.0, self.spline.length))
                dl = self.bound_left.deriv(min(s, self.bound_left.length))
                dl = dl / (np.linalg.norm(dl) + 1e-12)
                Al = np.array([dl[1], -dl[0]])
                pl = self.bound_left.at(min(s, self.bound_left.length))
                bl = Al @ (pl + Al * robot_radius)
                halfspaces[k, 0] = [-Al[0], -Al[1], -bl]

                dr = self.bound_right.deriv(min(s, self.bound_right.length))
                dr = dr / (np.linalg.norm(dr) + 1e-12)
                Ar = np.array([dr[1], -dr[0]])
                pr = self.bound_right.at(min(s, self.bound_right.length))
                br = Ar @ (pr - Ar * robot_radius)
                halfspaces[k, 1] = [Ar[0], Ar[1], br]

        module_data.static_obstacles = halfspaces
