"""Gaussian chance constraints (CC-MPC).

Counterpart of mpc_planner_tpu/modules/gaussian_constraints.py. Ref symbolic half
mpc_planner_modules/scripts/gaussian_constraints.py:14-117
(linearized chance constraint a^T d - b - erfinv(1-2*risk) * sqrt(2 a^T S a) >= 0),
runtime half mpc_planner_modules/src/gaussian_constraints.cpp:15-133
(static obstacles get sigma = 0.001).
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_planner_tpu_torch.modules.base import BoundModel, ConstraintModule
from mpc_planner_tpu_torch.parameters import ParameterBlock, ParameterRegistry
from mpc_planner_tpu_torch.types import PredictionType
from mpc_planner_tpu_torch.utils.math import erfinv_approx


class GaussianConstraintModule(ConstraintModule):
    module_name = "GaussianConstraints"
    description = "Linearized Gaussian chance constraints on obstacle collision"

    def __init__(self, cfg):
        self.cfg = cfg
        self.n_discs = cfg.n_discs
        self.max_obstacles = cfg.max_obstacles
        self.risk = cfg.probabilistic.risk

    def define_parameters(self, params: ParameterRegistry) -> None:
        params.add("ego_disc_radius")
        for d in range(self.n_discs):
            params.add(f"ego_disc_{d}_offset", bundle_name="ego_disc_offset")
        for i in range(self.max_obstacles):
            for suffix in ("x", "y", "major", "minor", "risk", "r"):
                params.add(f"gaussian_obst_{i}_{suffix}", bundle_name=f"gaussian_obst_{suffix}")

    def lower_bounds(self):
        return [0.0] * (self.max_obstacles * self.n_discs)

    def upper_bounds(self):
        return [np.inf] * (self.max_obstacles * self.n_discs)

    def constraints(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        pos_x, pos_y = model.get("x"), model.get("y")
        psi = model.get_or("psi", torch.zeros_like(pos_x))
        r_vehicle = params.get("ego_disc_radius")

        out = []
        for i in range(self.max_obstacles):
            obs_x = params.get(f"gaussian_obst_{i}_x")
            obs_y = params.get(f"gaussian_obst_{i}_y")
            sigma_x = params.get(f"gaussian_obst_{i}_major")
            sigma_y = params.get(f"gaussian_obst_{i}_minor")
            risk = params.get(f"gaussian_obst_{i}_risk")
            r_obstacle = params.get(f"gaussian_obst_{i}_r")
            combined_radius = r_vehicle + r_obstacle

            for d in range(self.n_discs):
                offset = params.get(f"ego_disc_{d}_offset")
                dx = pos_x + offset * torch.cos(psi) - obs_x
                dy = pos_y + offset * torch.sin(psi) - obs_y
                dist = torch.sqrt(dx * dx + dy * dy) + 1e-12
                a1, a2 = dx / dist, dy / dist

                y_erfinv = erfinv_approx(1.0 - 2.0 * risk)
                # a^T Sigma a with Sigma = diag(sx^2, sy^2)
                aSa = a1 * a1 * sigma_x**2 + a2 * a2 * sigma_y**2
                out.append(a1 * dx + a2 * dy - combined_radius - y_erfinv * torch.sqrt(2.0 * aSa))
        return out

    # -- host half (ref gaussian_constraints.cpp:39-96) --------------------
    def set_parameters(self, data, module_data, pblock: ParameterBlock) -> None:
        blk = data.obstacle_block
        N = self.cfg.N
        n_stages = pblock.n_stages
        M = self.max_obstacles

        if data.robot_area:
            pblock.set_all_stages("ego_disc_radius", data.robot_area[0][1])
            pblock.set_bundle_all_stages(
                "ego_disc_offset", np.array([o for o, _ in data.robot_area])
            )

        x = np.empty((n_stages, M))
        y = np.empty((n_stages, M))
        major = np.full((n_stages, M), 1e-3)  # static/deterministic sigma=0.001
        minor = np.full((n_stages, M), 1e-3)
        risk = np.full((n_stages, M), self.risk)
        r = np.empty((n_stages, M))

        dummy_xy = getattr(data, "ego_position", np.zeros(2)) + 100.0
        x[0], y[0] = dummy_xy[0], dummy_xy[1]
        r[0] = 0.1

        ks = np.arange(1, n_stages)
        pred_idx = np.clip(ks - 1, 0, N - 1)
        x[1:] = blk.pred_position[:, pred_idx, 0].T
        y[1:] = blk.pred_position[:, pred_idx, 1].T
        r[1:] = blk.radius[None, :]

        gaussian = blk.pred_type == int(PredictionType.GAUSSIAN)
        if np.any(gaussian):
            major[1:, gaussian] = np.maximum(blk.pred_major[gaussian][:, pred_idx].T, 1e-3)
            minor[1:, gaussian] = np.maximum(blk.pred_minor[gaussian][:, pred_idx].T, 1e-3)

        pblock.set_bundle_all_stages("gaussian_obst_x", x)
        pblock.set_bundle_all_stages("gaussian_obst_y", y)
        pblock.set_bundle_all_stages("gaussian_obst_major", major)
        pblock.set_bundle_all_stages("gaussian_obst_minor", minor)
        pblock.set_bundle_all_stages("gaussian_obst_risk", risk)
        pblock.set_bundle_all_stages("gaussian_obst_r", r)

    def is_data_ready(self, data):
        if not data.robot_area:
            return False, "Robot area"
        if getattr(data, "obstacle_block", None) is None:
            return False, "Obstacles"
        return True, ""
