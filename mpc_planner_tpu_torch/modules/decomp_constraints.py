"""Static free-space polytope constraints from an occupancy grid.

Counterpart of mpc_planner_tpu/modules/decomp_constraints.py, the
equivalent of the reference's decomp_util integration
(mpc_planner_modules/src/decomp_constraints.cpp: occupied cells from the
costmap :122-148, EllipsoidDecomp2D::dilate along the velocity-propagated
reference :62-86, <= max_constraints halfspaces per stage :90-117; symbolic
half mpc_planner_modules/scripts/decomp_constraints.py:17-98).

Instead of decomp_util's C++ ellipsoid decomposition, free polytopes are
built with an iterative nearest-obstacle separating-halfspace sweep
(IRIS/SFC-style): repeatedly cut at the closest occupied point
perpendicular to the seed->point direction, discard points behind the cut,
until max_constraints cuts are placed. Produces a convex free region
around each (velocity-propagated) trajectory point with the same
fixed-size halfspace interface.
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_planner_tpu_torch.modules.base import BoundModel, ConstraintModule
from mpc_planner_tpu_torch.parameters import ParameterBlock, ParameterRegistry


def occupied_points_from_grid(grid: np.ndarray, meta: dict, threshold: int) -> np.ndarray:
    """Occupied cell centers in world coordinates
    (ref decomp_constraints.cpp:122-148). grid: [H, W] row-major (y, x)."""
    ys, xs = np.where(grid >= threshold)
    res = meta.get("resolution", 0.1)
    ox = meta.get("origin_x", 0.0)
    oy = meta.get("origin_y", 0.0)
    return np.stack([ox + (xs + 0.5) * res, oy + (ys + 0.5) * res], axis=-1)


def free_polytope(seed: np.ndarray, points: np.ndarray, max_constraints: int, radius: float):
    """Halfspaces (a1, a2, b) of a convex free region around `seed`.

    Iteratively cuts at the nearest occupied point, inflated by `radius`,
    then prunes points excluded by the cut.
    Returns [max_constraints, 3]; unused rows are inactive dummies.
    """
    rows = np.zeros((max_constraints, 3))
    rows[:, 0] = 1.0
    rows[:, 2] = 1e6  # inactive: x <= 1e6
    pts = points
    for c in range(max_constraints):
        if pts.shape[0] == 0:
            break
        diff = pts - seed[None, :]
        dist = np.linalg.norm(diff, axis=-1)
        i = int(np.argmin(dist))
        d = max(dist[i], 1e-9)
        a = diff[i] / d  # outward normal
        # Cut at the point, pulled toward the seed by the robot radius
        cut_point = pts[i] - a * radius
        b = float(a @ cut_point)
        if a @ seed - b > 0:  # seed itself infeasible: skip this cut
            pts = np.delete(pts, i, axis=0)
            continue
        rows[c] = [a[0], a[1], b]
        # Keep only points still inside the current region
        keep = pts @ a - b < radius
        keep[i] = False
        pts = pts[keep]
    return rows


class DecompConstraintModule(ConstraintModule):
    module_name = "DecompConstraints"
    description = "Static free-space polytope constraints (decomp_util equivalent)"

    def __init__(self, cfg):
        self.cfg = cfg
        self.n_discs = cfg.n_discs
        self.max_constraints = cfg.decomp.max_constraints
        self.range = cfg.decomp.range
        self.num_constraints = self.max_constraints * self.n_discs
        self._halfspaces = None  # [N, max_constraints, 3]

    def define_parameters(self, params: ParameterRegistry) -> None:
        for d in range(self.n_discs):
            params.add(f"ego_disc_{d}_offset", bundle_name="ego_disc_offset")
            for i in range(self.max_constraints):
                params.add(f"disc_{d}_decomp_{i}_a1", bundle_name="decomp_a1")
                params.add(f"disc_{d}_decomp_{i}_a2", bundle_name="decomp_a2")
                params.add(f"disc_{d}_decomp_{i}_b", bundle_name="decomp_b")

    def lower_bounds(self):
        return [-np.inf] * self.num_constraints

    def upper_bounds(self):
        return [0.0] * self.num_constraints

    def constraints(self, model: BoundModel, params: ParameterRegistry, cfg, stage_idx: int):
        pos_x, pos_y = model.get("x"), model.get("y")
        psi = model.get_or("psi", torch.zeros_like(pos_x))
        slack = model.get_or("slack", 0.0)
        out = []
        for d in range(self.n_discs):
            offset = params.get(f"ego_disc_{d}_offset")
            px = pos_x + offset * torch.cos(psi)
            py = pos_y + offset * torch.sin(psi)
            for i in range(self.max_constraints):
                a1 = params.get(f"disc_{d}_decomp_{i}_a1")
                a2 = params.get(f"disc_{d}_decomp_{i}_a2")
                b = params.get(f"disc_{d}_decomp_{i}_b")
                out.append(a1 * px + a2 * py - (b + slack))
        return out

    # -- host half ---------------------------------------------------------
    def update(self, state, data, module_data) -> None:
        """Decompose free space along the velocity-propagated warmstart
        (ref decomp_constraints.cpp:62-118)."""
        if data.costmap is None or module_data.warmstart_xy is None:
            return
        N = self.cfg.N
        occ = occupied_points_from_grid(
            data.costmap, data.costmap_meta or {}, self.cfg.decomp.occupancy_threshold
        )
        robot_radius = self.cfg.robot_radius
        halfspaces = np.zeros((N, self.max_constraints, 3))
        for k in range(N):
            seed = module_data.warmstart_xy[min(k, N)]
            nearby = occ
            if occ.shape[0] > 0:
                mask = np.linalg.norm(occ - seed[None, :], axis=-1) < self.range
                nearby = occ[mask]
            halfspaces[k] = free_polytope(seed, nearby, self.max_constraints, robot_radius)
        self._halfspaces = halfspaces

    def set_parameters(self, data, module_data, pblock: ParameterBlock) -> None:
        n_stages = pblock.n_stages
        nC = self.max_constraints * self.n_discs
        a1 = np.ones((n_stages, nC))
        a2 = np.zeros((n_stages, nC))
        b = np.full((n_stages, nC), 1e6)
        if data.robot_area:
            pblock.set_bundle_all_stages(
                "ego_disc_offset", np.array([o for o, _ in data.robot_area])
            )
        if self._halfspaces is not None:
            N = self.cfg.N
            hs = np.tile(self._halfspaces, (1, self.n_discs, 1))  # same region per disc
            a1[:N] = hs[:, :, 0]
            a2[:N] = hs[:, :, 1]
            b[:N] = hs[:, :, 2]
            if n_stages > N:
                a1[N:], a2[N:], b[N:] = hs[N - 1, :, 0], hs[N - 1, :, 1], hs[N - 1, :, 2]
        pblock.set_bundle_all_stages("decomp_a1", a1)
        pblock.set_bundle_all_stages("decomp_a2", a2)
        pblock.set_bundle_all_stages("decomp_b", b)

    def is_data_ready(self, data):
        if data.costmap is None:
            return False, "Costmap"
        return True, ""
