"""Dynamic velocity reference along the path.

Counterpart of mpc_planner_tpu/modules/path_reference_velocity.py
(numpy-only, copied so the port never imports the JAX package).

Ref symbolic half mpc_planner_modules/scripts/path_reference_velocity.py:11-44
(declares the spline_v coefficients; the cost itself is evaluated inside
the contouring module), runtime half
mpc_planner_modules/src/path_reference_velocity.cpp:13-133.
"""

from __future__ import annotations

import numpy as np

from mpc_planner_tpu_torch.modules.base import ObjectiveModule
from mpc_planner_tpu_torch.parameters import ParameterBlock, ParameterRegistry
from mpc_planner_tpu_torch.spline_fit import CubicSpline


class PathReferenceVelocityModule(ObjectiveModule):
    module_name = "PathReferenceVelocity"
    description = "Tracks a dynamic velocity reference along the path"

    def __init__(self, cfg):
        self.cfg = cfg
        self.num_segments = cfg.contouring.num_segments
        self.velocity_spline: CubicSpline | None = None

    def define_parameters(self, params: ParameterRegistry) -> None:
        for i in range(self.num_segments):
            for coef in "abcd":
                params.add(f"spline_v{i}_{coef}", bundle_name=f"spline_v_{coef}")

    # Cost computed inside contouring (ref path_reference_velocity.py:30-32)

    def on_data_received(self, data, data_name: str) -> None:
        # Fit v(s) when a path with velocities arrives
        # (ref path_reference_velocity.cpp:28-40)
        if data_name != "reference_path" or data.reference_path is None:
            return
        rp = data.reference_path
        if "v" in rp and rp["v"] is not None and len(rp["v"]) == len(rp["x"]):
            s = rp.get("s")
            if s is None:
                x, y = np.asarray(rp["x"], float), np.asarray(rp["y"], float)
                s = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x), np.diff(y)))])
            self.velocity_spline = CubicSpline(np.asarray(s, float), np.asarray(rp["v"], float))

    def set_parameters(self, data, module_data, pblock: ParameterBlock) -> None:
        # Upload velocity spline coefficients, or a constant reference
        # (ref path_reference_velocity.cpp:82-133)
        n = self.num_segments
        if self.velocity_spline is not None:
            start = max(module_data.current_path_segment, 0)
            last = self.velocity_spline.n_segments - 1
            # Past-end slots share the path spline's s_start=length pin
            # (spline_fit.segment_param_arrays), so their cubic is
            # evaluated at ds = s - length: pad with a CONSTANT segment
            # at the path-end velocity (same pattern as the contouring
            # width pad) instead of duplicating the last segment's
            # coefficients, which would return v at that segment's START.
            v_end = float(self.velocity_spline(self.velocity_spline.t[-1]))
            coeffs = np.zeros((n, 4))
            for i in range(n):
                index = start + i
                if index <= last:
                    coeffs[i] = self.velocity_spline.coeffs[index]
                else:
                    coeffs[i] = [0.0, 0.0, 0.0, v_end]
            for j, coef in enumerate("abcd"):
                pblock.set_bundle_all_stages(f"spline_v_{coef}", coeffs[:, j])
        else:
            ref_v = self.cfg.weights.get("reference_velocity", 0.0)
            pblock.set_bundle_all_stages("spline_v_a", np.zeros(n))
            pblock.set_bundle_all_stages("spline_v_b", np.zeros(n))
            pblock.set_bundle_all_stages("spline_v_c", np.zeros(n))
            pblock.set_bundle_all_stages("spline_v_d", np.full(n, ref_v))
