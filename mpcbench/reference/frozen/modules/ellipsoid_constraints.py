"""Ellipsoidal obstacle avoidance constraints.

Counterpart of mpc_planner_tpu/modules/ellipsoid_constraints.py. Ref
symbolic half mpc_planner_modules/scripts/ellipsoid_constraints.py:13-119
(ellipse matrix :96-117), runtime half
mpc_planner_modules/src/ellipsoid_constraints.cpp:13-165 (stage k uses
prediction step k-1 :66-69, Gaussian chi = ExponentialQuantile(0.5, 1-risk)
:80, k=0 dummies :42-56).
"""

from __future__ import annotations

import numpy as np
import torch

from mpcbench.reference.frozen.modules.base import BoundModel, ConstraintModule
from mpcbench.reference.frozen.parameters import ParameterBlock, ParameterRegistry
from mpcbench.reference.frozen.types import PredictionType
from mpcbench.reference.frozen.utils.math import exponential_quantile


class EllipsoidConstraintModule(ConstraintModule):
    module_name = "EllipsoidConstraints"
    description = "Avoid obstacles modeled as (possibly Gaussian-inflated) ellipsoids"

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
            for suffix in ("x", "y", "psi", "major", "minor", "chi", "r"):
                params.add(f"ellipsoid_obst_{i}_{suffix}", bundle_name=f"ellipsoid_obst_{suffix}")

    def lower_bounds(self):
        return [1.0] * (self.max_obstacles * self.n_discs)

    def upper_bounds(self):
        return [np.inf] * (self.max_obstacles * self.n_discs)

    def constraints(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        # (d)^T R(psi_o)^T diag(1/(axis+r)^2) R(psi_o) (d) >= 1
        # (ref ellipsoid_constraints.py:66-119)
        pos_x, pos_y = model.get("x"), model.get("y")
        psi = model.get_or("psi", torch.zeros_like(pos_x))
        r_disc = params.get("ego_disc_radius")

        out = []
        for i in range(self.max_obstacles):
            obst_x = params.get(f"ellipsoid_obst_{i}_x")
            obst_y = params.get(f"ellipsoid_obst_{i}_y")
            obst_psi = params.get(f"ellipsoid_obst_{i}_psi")
            obst_major = params.get(f"ellipsoid_obst_{i}_major")
            obst_minor = params.get(f"ellipsoid_obst_{i}_minor")
            obst_r = params.get(f"ellipsoid_obst_{i}_r")
            chi = params.get(f"ellipsoid_obst_{i}_chi")

            major = obst_major * torch.sqrt(chi)
            minor = obst_minor * torch.sqrt(chi)
            inv_a2 = 1.0 / ((major + r_disc + obst_r) ** 2)
            inv_b2 = 1.0 / ((minor + r_disc + obst_r) ** 2)

            c_o, s_o = torch.cos(obst_psi), torch.sin(obst_psi)
            for d in range(self.n_discs):
                offset = params.get(f"ego_disc_{d}_offset")
                dx = pos_x + offset * torch.cos(psi) - obst_x
                dy = pos_y + offset * torch.sin(psi) - obst_y
                # R^T d then weighted norm (expanded 2x2 rotation)
                e1 = c_o * dx + s_o * dy
                e2 = -s_o * dx + c_o * dy
                out.append(inv_a2 * e1**2 + inv_b2 * e2**2)
        return out

    # -- host half ---------------------------------------------------------
    def set_parameters(self, data, module_data, pblock: ParameterBlock) -> None:
        blk = data.obstacle_block  # packed by data_preparation.pack_obstacles
        N = self.cfg.N
        n_stages = pblock.n_stages

        if data.robot_area:
            pblock.set_all_stages("ego_disc_radius", data.robot_area[0][1])
            offsets = np.array([o for o, _ in data.robot_area])
            pblock.set_bundle_all_stages("ego_disc_offset", offsets)

        M = self.max_obstacles
        # Per stage k (1..N-1) use prediction step k-1; k=0 dummies
        # (ref ellipsoid_constraints.cpp:42-69)
        x = np.empty((n_stages, M))
        y = np.empty((n_stages, M))
        psi = np.zeros((n_stages, M))
        major = np.zeros((n_stages, M))
        minor = np.zeros((n_stages, M))
        chi = np.ones((n_stages, M))
        r = np.empty((n_stages, M))

        # k=0 dummy row (ref :42-56: x=+100 from state, r=0.1)
        dummy_xy = getattr(data, "ego_position", np.zeros(2)) + 100.0
        x[0], y[0] = dummy_xy[0], dummy_xy[1]
        r[0] = 0.1

        ks = np.arange(1, n_stages)
        pred_idx = np.clip(ks - 1, 0, N - 1)
        x[1:] = blk.pred_position[:, pred_idx, 0].T
        y[1:] = blk.pred_position[:, pred_idx, 1].T
        psi[1:] = blk.pred_angle[:, pred_idx].T
        r[1:] = blk.radius[None, :]

        gaussian = blk.pred_type == int(PredictionType.GAUSSIAN)
        if np.any(gaussian):
            chi_val = exponential_quantile(0.5, 1.0 - self.risk)
            major[1:, gaussian] = blk.pred_major[gaussian][:, pred_idx].T
            minor[1:, gaussian] = blk.pred_minor[gaussian][:, pred_idx].T
            chi[1:, gaussian] = chi_val

        pblock.set_bundle_all_stages("ellipsoid_obst_x", x)
        pblock.set_bundle_all_stages("ellipsoid_obst_y", y)
        pblock.set_bundle_all_stages("ellipsoid_obst_psi", psi)
        pblock.set_bundle_all_stages("ellipsoid_obst_major", major)
        pblock.set_bundle_all_stages("ellipsoid_obst_minor", minor)
        pblock.set_bundle_all_stages("ellipsoid_obst_chi", chi)
        pblock.set_bundle_all_stages("ellipsoid_obst_r", r)

    def is_data_ready(self, data):
        # (ref ellipsoid_constraints.cpp:93-133)
        if not data.robot_area:
            return False, "Robot area"
        if getattr(data, "obstacle_block", None) is None:
            return False, "Obstacles"
        if data.obstacle_block.position.shape[0] != self.max_obstacles:
            return False, "Obstacles"
        ok_types = (int(PredictionType.DETERMINISTIC), int(PredictionType.GAUSSIAN))
        if not all(t in ok_types for t in data.obstacle_block.pred_type):
            return False, "Obstacle Prediction (Type is incorrect)"
        return True, ""
