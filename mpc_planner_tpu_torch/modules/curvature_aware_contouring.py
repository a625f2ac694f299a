"""Curvature-Aware MPCC objective (CA-MPC).

Counterpart of mpc_planner_tpu/modules/curvature_aware_contouring.py. Ref symbolic half
mpc_planner_modules/scripts/curvature_aware_contouring.py:15-123
(Lorenzo's projection-ratio equations :79-88), runtime half
mpc_planner_modules/src/curvature_aware_contouring.cpp:10-52 (weight upload
only; spline upload shared with Contouring).
"""

from __future__ import annotations

import torch

from mpc_planner_tpu_torch.modules.base import BoundModel
from mpc_planner_tpu_torch.modules.contouring import ContouringModule
from mpc_planner_tpu_torch.parameters import ParameterBlock, ParameterRegistry
from mpc_planner_tpu_torch.splines import Spline, Spline2D
from mpc_planner_tpu_torch.utils.math import atan2, haar_difference_without_abs


class CurvatureAwareContouringModule(ContouringModule):
    module_name = "CurvatureAwareContouring"
    description = "CA-MPC: curvature-aware contouring costs"

    def cost(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        pos_x, pos_y = model.get("x"), model.get("y")
        psi, v, s = model.get("psi"), model.get("v"), model.get("spline")

        contour_weight = params.get("contour")
        velocity_weight = params.get("velocity")

        if self.dynamic_velocity_reference:
            path_velocity = Spline(params, "spline_v", self.num_segments, s)
            reference_velocity = path_velocity.at(s)
        else:
            reference_velocity = params.get("reference_velocity")

        path = Spline2D(params, self.num_segments, s)
        path_x, path_y = path.at(s)
        dxn, dyn = path.deriv_normalized(s)

        # CA-MPC s_dot with projection ratio (ref curvature_aware_contouring.py:79-88)
        ddx, ddy = path.deriv2(s)
        projection_ratio = 1.0 / (1.0 - ((pos_x - path_x) * ddx + (pos_y - path_y) * ddy))
        s_dot = v * (torch.cos(psi) * dxn + torch.sin(psi) * dyn) * projection_ratio

        contour_error_squared = (pos_x - path_x) ** 2 + (pos_y - path_y) ** 2

        total = contour_weight * contour_error_squared
        total = total + velocity_weight * (s_dot - reference_velocity) ** 2

        if stage_idx == cfg.N - 1 or stage_idx == cfg.N:
            terminal_angle_weight = params.get("terminal_angle")
            terminal_contouring_mp = params.get("terminal_contouring")
            path_angle = atan2(dyn, dxn)
            angle_error = haar_difference_without_abs(psi, path_angle)
            total = total + terminal_angle_weight * angle_error**2
            total = total + terminal_contouring_mp * contour_weight * contour_error_squared
            total = total + (terminal_contouring_mp * velocity_weight
                             * (s_dot - reference_velocity) ** 2)

        return total

    def set_parameters(self, data, module_data, pblock: ParameterBlock) -> None:
        # Same upload as Contouring; CA additionally always needs
        # velocity/reference_velocity (ref curvature_aware_contouring.cpp:18-47)
        super().set_parameters(data, module_data, pblock)
        w = self.cfg.weights
        pblock.set_all_stages("velocity", w.get("velocity", 0.0))
        pblock.set_all_stages("reference_velocity", w.get("reference_velocity", 0.0))
