"""Road-width contouring constraints.

Counterpart of mpc_planner_tpu/modules/contouring_constraints.py. Ref symbolic half
mpc_planner_modules/scripts/contouring_constraints.py:16-99
(+-contour_error + w/2 <= width_{l,r}(s)), runtime half
mpc_planner_modules/src/contouring_constraints.cpp:13-221 (width splines
fitted from bounds over path arclength).
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_planner_tpu_torch.modules.base import BoundModel, ConstraintModule
from mpc_planner_tpu_torch.parameters import ParameterBlock, ParameterRegistry
from mpc_planner_tpu_torch.spline_fit import CubicSpline
from mpc_planner_tpu_torch.splines import Spline, Spline2D, _blend_weights


class ContouringConstraintModule(ConstraintModule):
    module_name = "ContouringConstraints"
    description = "Constrain the contouring error within road boundaries"

    def __init__(self, cfg):
        self.cfg = cfg
        self.num_segments = cfg.contouring.num_segments
        self.width_left: CubicSpline | None = None
        self.width_right: CubicSpline | None = None

    def define_parameters(self, params: ParameterRegistry) -> None:
        for i in range(self.num_segments):
            for coef in "abcd":
                params.add(f"width_right{i}_{coef}", bundle_name=f"width_right_{coef}")
            for coef in "abcd":
                params.add(f"width_left{i}_{coef}", bundle_name=f"width_left_{coef}")

    def lower_bounds(self):
        return [-np.inf, -np.inf]

    def upper_bounds(self):
        return [0.0, 0.0]

    def constraints(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        pos_x, pos_y = model.get("x"), model.get("y")
        s = model.get("spline")
        slack = model.get_or("slack", 0.0)

        spline = Spline2D(params, self.num_segments, s)
        path_x, path_y = spline.at(s)
        dxn, dyn = spline.deriv_normalized(s)
        contour_error = dyn * (pos_x - path_x) - dxn * (pos_y - path_y)

        width_left = _WidthSpline(params, "width_left", self.num_segments, s)
        width_right = _WidthSpline(params, "width_right", self.num_segments, s)

        w_cur = model.width / 2.0

        return [
            contour_error + w_cur - width_right.at(s) - slack,
            -contour_error + w_cur - width_left.at(s) - slack,
        ]

    # -- host half ---------------------------------------------------------
    def on_data_received(self, data, data_name: str) -> None:
        # Fit width splines over path arclength (ref :34-70)
        if data_name != "reference_path" or data.reference_path is None:
            return
        if data.left_bound is None or data.right_bound is None:
            return
        rp = data.reference_path
        x, y = np.asarray(rp["x"], float), np.asarray(rp["y"], float)
        n = min(len(x), len(data.left_bound), len(data.right_bound))
        center = np.stack([x[:n], y[:n]], axis=-1)
        widths_left = np.linalg.norm(center - data.left_bound[:n], axis=-1)
        widths_right = np.linalg.norm(center - data.right_bound[:n], axis=-1)
        s = rp.get("s")
        if s is None:
            s = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x), np.diff(y)))])
        self.width_left = CubicSpline(np.asarray(s[:n], float), widths_left)
        self.width_right = CubicSpline(np.asarray(s[:n], float), widths_right)

    def update(self, state, data, module_data) -> None:
        if module_data.path_width_left is None and self.width_left is not None:
            module_data.path_width_left = self.width_left
            module_data.path_width_right = self.width_right

    def set_parameters(self, data, module_data, pblock: ParameterBlock) -> None:
        if self.width_left is None:
            # No bounds: wide-open road so the constraints are inactive
            big = 1e3
            for side in ("width_left", "width_right"):
                for coef in "abc":
                    pblock.set_bundle_all_stages(f"{side}_{coef}", np.zeros(self.num_segments))
                pblock.set_bundle_all_stages(f"{side}_d", np.full(self.num_segments, big))
            return
        start = max(module_data.current_path_segment, 0)
        nseg = self.width_right.n_segments
        for side, spl in (("width_right", self.width_right), ("width_left", self.width_left)):
            coeffs = np.zeros((self.num_segments, 4))
            for i in range(self.num_segments):
                index = start + i
                if index < nseg:
                    coeffs[i] = spl.coeffs[index]
                else:
                    # Past the end: constant width (ref :92-105)
                    coeffs[i] = [0.0, 0.0, 0.0, spl.coeffs[-1][3]]
            for j, coef in enumerate("abcd"):
                pblock.set_bundle_all_stages(f"{side}_{coef}", coeffs[:, j])

    def is_data_ready(self, data):
        if data.reference_path is None:
            return False, "Reference Path"
        return True, ""


class _WidthSpline:
    """Width spline sharing the path's segment starts (``spline{i}_start``)."""

    def __init__(self, params, name: str, num_segments: int, s):
        self._spline = Spline.__new__(Spline)
        self._spline.a = torch.stack([params.get(f"{name}{i}_a") for i in range(num_segments)])
        self._spline.b = torch.stack([params.get(f"{name}{i}_b") for i in range(num_segments)])
        self._spline.c = torch.stack([params.get(f"{name}{i}_c") for i in range(num_segments)])
        self._spline.d = torch.stack([params.get(f"{name}{i}_d") for i in range(num_segments)])
        self._spline.s_start = torch.stack(
            [params.get(f"spline{i}_start") for i in range(num_segments)]
        )
        self._spline.num_segments = num_segments
        self._spline._w = _blend_weights(torch.as_tensor(s), self._spline.s_start)

    def at(self, s):
        return self._spline.at(s)
