"""Linearized collision-avoidance halfspace constraints.

Counterpart of mpc_planner_tpu/modules/linearized_constraints.py. Ref symbolic half
mpc_planner_modules/scripts/linearized_constraints.py:18-95,
runtime half mpc_planner_modules/src/linearized_constraints.cpp:
Douglas-Rachford projection of the warmstart to a collision-free point
(:130-148), normalized separating halfspace per obstacle (:85-105),
static halfspace append, and the 1-disc "topology" guidance mode (:43-47)
used inside T-MPC.
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_planner_tpu_torch import native
from mpc_planner_tpu_torch.modules.base import BoundModel, ConstraintModule
from mpc_planner_tpu_torch.parameters import ParameterBlock, ParameterRegistry


class LinearizedConstraintModule(ConstraintModule):
    module_name = "LinearizedConstraints"
    description = "Linearized dynamic collision avoidance constraints"

    def __init__(self, cfg, use_slack: bool = False, use_guidance: bool = False,
                 n_other_halfspaces: int | None = None):
        self.cfg = cfg
        self.use_guidance = use_guidance  # topology mode (ref :43-47)
        self.n_discs = 1 if use_guidance else cfg.n_discs
        self.max_obstacles = cfg.max_obstacles
        self.n_other_halfspaces = (
            cfg.linearized_add_halfspaces if n_other_halfspaces is None else n_other_halfspaces
        )
        self.use_slack = use_slack
        self.num_constraints = self.max_obstacles + self.n_other_halfspaces
        # Computed by update(): [n_discs, N, num_constraints] halfspaces
        self._a1 = None
        self._a2 = None
        self._b = None

    def define_parameters(self, params: ParameterRegistry) -> None:
        for d in range(self.n_discs):
            if not self.use_guidance:
                params.add(f"ego_disc_{d}_offset", bundle_name="ego_disc_offset")
            for i in range(self.num_constraints):
                params.add(f"disc_{d}_lin_constraint_{i}_a1", bundle_name="lin_constraint_a1")
                params.add(f"disc_{d}_lin_constraint_{i}_a2", bundle_name="lin_constraint_a2")
                params.add(f"disc_{d}_lin_constraint_{i}_b", bundle_name="lin_constraint_b")

    def lower_bounds(self):
        return [-np.inf] * (self.num_constraints * self.n_discs)

    def upper_bounds(self):
        return [0.0] * (self.num_constraints * self.n_discs)

    def constraints(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        pos_x, pos_y = model.get("x"), model.get("y")
        psi = model.get_or("psi", torch.zeros_like(pos_x))
        slack = model.get_or("slack", 0.0) if self.use_slack else 0.0

        out = []
        for d in range(self.n_discs):
            if self.use_guidance:
                px, py = pos_x, pos_y
            else:
                offset = params.get(f"ego_disc_{d}_offset")
                px = pos_x + offset * torch.cos(psi)
                py = pos_y + offset * torch.sin(psi)
            for i in range(self.num_constraints):
                a1 = params.get(f"disc_{d}_lin_constraint_{i}_a1")
                a2 = params.get(f"disc_{d}_lin_constraint_{i}_a2")
                b = params.get(f"disc_{d}_lin_constraint_{i}_b")
                out.append(a1 * px + a2 * py - (b + slack))
        return out

    # -- host half ---------------------------------------------------------
    def update(self, state, data, module_data) -> None:
        """Build separating halfspaces per stage from the warmstart
        (ref linearized_constraints.cpp:49-148)."""
        blk = data.obstacle_block
        if blk is None or module_data.warmstart is None:
            return
        N = self.cfg.N
        robot_radius = self.cfg.robot_radius
        n_dynamic = blk.position.shape[0]

        ws_xy = module_data.warmstart_xy  # [N+1, 2] set by planner
        psi_ws = module_data.warmstart_psi  # [N+1]

        a1 = np.zeros((self.n_discs, N, self.num_constraints))
        a2 = np.zeros((self.n_discs, N, self.num_constraints))
        b = np.full((self.n_discs, N, self.num_constraints), 100.0)  # dummies

        radius = np.where(
            np.full(n_dynamic, self.use_guidance), 1e-3, blk.radius
        ) + robot_radius  # [M]

        for k in range(1, N):
            obst_pos = blk.pred_position[:, k - 1]  # [M, 2]
            for d in range(self.n_discs):
                pos = ws_xy[k].copy()
                if not self.use_guidance and data.robot_area:
                    offset = data.robot_area[d][0]
                    pos = pos + offset * np.array([np.cos(psi_ws[k]), np.sin(psi_ws[k])])
                pos = self._project_to_safety(obst_pos, radius, pos)

                diff = obst_pos - pos[None, :]  # [M, 2]
                dist = np.linalg.norm(diff, axis=-1)
                dist = np.maximum(dist, 1e-9)
                a1[d, k, :n_dynamic] = diff[:, 0] / dist
                a2[d, k, :n_dynamic] = diff[:, 1] / dist
                b[d, k, :n_dynamic] = (
                    a1[d, k, :n_dynamic] * obst_pos[:, 0]
                    + a2[d, k, :n_dynamic] * obst_pos[:, 1]
                    - radius
                )

                # Static halfspaces from module_data (ref :107-125)
                if (
                    module_data.static_obstacles is not None
                    and self.n_other_halfspaces > 0
                ):
                    H = min(module_data.static_obstacles.shape[1], self.n_other_halfspaces)
                    rows = module_data.static_obstacles[k, :H]
                    a1[d, k, n_dynamic : n_dynamic + H] = rows[:, 0]
                    a2[d, k, n_dynamic : n_dynamic + H] = rows[:, 1]
                    b[d, k, n_dynamic : n_dynamic + H] = rows[:, 2]

        self._a1, self._a2, self._b = a1, a2, b

    def _project_to_safety(self, obst_pos, radius, pos):
        """Douglas-Rachford-style projection to a collision-free point
        (ref linearized_constraints.cpp:130-148): at most 3 sweeps.
        The native library's when it is there (native.py), else the numpy
        loop below; an error of the native call is an error."""
        if obst_pos.shape[0] == 0:
            return pos
        out = native.dr_project(pos[None, :], obst_pos[None, :, :], radius)
        if out is not None:
            return out[0]
        anchor = obst_pos[0]
        for _ in range(3):
            diff = pos[None, :] - obst_pos
            dist = np.linalg.norm(diff, axis=-1)
            violated = dist < radius
            if not np.any(violated):
                break
            for i in np.where(violated)[0]:
                d = dist[i]
                if d < 1e-9:
                    # Degenerate: push along the anchor direction
                    direction = pos - anchor
                    nd = np.linalg.norm(direction)
                    direction = direction / nd if nd > 1e-9 else np.array([1.0, 0.0])
                else:
                    direction = diff[i] / d
                pos = obst_pos[i] + direction * radius[i]
        return pos

    def set_parameters(self, data, module_data, pblock: ParameterBlock) -> None:
        # (ref linearized_constraints.cpp:152-182; k=0 dummies)
        n_stages = pblock.n_stages
        if not self.use_guidance and data.robot_area:
            pblock.set_bundle_all_stages(
                "ego_disc_offset", np.array([o for o, _ in data.robot_area])
            )
        nC = self.num_constraints
        D = self.n_discs
        a1 = np.zeros((n_stages, D * nC))
        a2 = np.zeros((n_stages, D * nC))
        b = np.full((n_stages, D * nC), 100.0)
        if self._a1 is not None:
            N = self.cfg.N
            # flatten disc-major order: disc d block occupies [d*nC:(d+1)*nC]
            flat_a1 = np.transpose(self._a1, (1, 0, 2)).reshape(N, D * nC)
            flat_a2 = np.transpose(self._a2, (1, 0, 2)).reshape(N, D * nC)
            flat_b = np.transpose(self._b, (1, 0, 2)).reshape(N, D * nC)
            a1[1:N] = flat_a1[1:]
            a2[1:N] = flat_a2[1:]
            b[1:N] = flat_b[1:]
            if n_stages > N:
                a1[N:] = flat_a1[N - 1]
                a2[N:] = flat_a2[N - 1]
                b[N:] = flat_b[N - 1]
        pblock.set_bundle_all_stages("lin_constraint_a1", a1)
        pblock.set_bundle_all_stages("lin_constraint_a2", a2)
        pblock.set_bundle_all_stages("lin_constraint_b", b)

    def is_data_ready(self, data):
        if getattr(data, "obstacle_block", None) is None:
            return False, "Obstacles"
        return True, ""
