"""Visibility-PRM guidance in (x, y, t) with homology-class filtering.

Counterpart of mpc_planner_tpu/guidance/prm.py (numpy-only, copied so the
port never imports the JAX package; its native search goes through the
port's binding of the same C++ source, mpc_planner_tpu_torch/native.py).

Full-parity replacement for the reference's external `guidance_planner`
dependency (SURVEY.md §2.4: Visibility-PRM over space-time with
Homology/UVD/winding comparison, consumed by
mpc_planner_modules/src/guidance_constraints.cpp:32-108; configured by
mpc_planner_jackalsimulator/config/guidance_planner.yaml: 30 PRM samples,
n_paths=4, seeded sampling, homology comparison).

Where guidance/homotopy.py *constructs* homotopy classes directly in the
path frame (fast, deterministic — the default backend), this module
*searches* for them the way the reference does:

  1. sample nodes in the (x, y, k) space-time volume between the robot
     and goal points placed along/around the reference path,
  2. connect nodes with "visibility" edges — straight space-time segments
     that are collision-free w.r.t. the moving obstacle predictions and
     respect a velocity budget,
  3. run a homology-aware dynamic program over the (time-monotone) graph:
     each node keeps the best-cost path per winding signature, where the
     signature accumulates the relative-angle sweep of robot-minus-
     obstacle along the path (the winding-number H-signature the T-MPC
     paper uses for dynamic environments),
  4. extract up to n_paths cheapest goal-reaching paths with distinct
     passing-side signatures and resample them onto the planner horizon.

Everything is vectorized numpy on the host (the reference's PRM is a
~ms-scale CPU search as well; SURVEY.md §7.7 keeps it host-side by
design). The output is the same `GuidanceTrajectory` contract the
batched T-MPC solve consumes, so the two backends are interchangeable
via `t_mpc.guidance_backend`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from mpc_planner_tpu_torch import native
from mpc_planner_tpu_torch.guidance.homotopy import (
    GuidancePlanner,
    GuidanceTrajectory,
    _halton,
    _speed,
)
from mpc_planner_tpu_torch.spline_fit import CubicSpline


class VisibilityPRMPlanner(GuidancePlanner):
    """Space-time Visibility-PRM backend (ref guidance_planner behavior)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        t = cfg.t_mpc
        self.n_samples = getattr(t, "prm_n_samples", 30)
        self.seed = getattr(t, "prm_seed", 1)
        self.v_max = getattr(t, "prm_max_velocity", 3.0)
        self.margin = getattr(t, "prm_margin", 0.1)
        self.n_goals = getattr(t, "prm_n_goals", 5)  # lateral fan size
        self.n_goals_long = getattr(t, "prm_n_goals_longitudinal", 3)
        self.goal_length_weight = getattr(t, "prm_goal_length_weight", 2.0)
        # Cubic-spline smoothing of selected node paths (the reference's
        # guidance_planner spline_optimization). Toggle kept for A/B:
        # linear resampling leaves velocity/heading kinks at node corners
        # that the finite-difference warmstart reconstruction turns into
        # acceleration spikes.
        self.spline_smoothing = bool(getattr(t, "prm_spline_smoothing", True))
        # Per-node label cap: best-cost paths per distinct winding key
        self._labels_per_node = max(8, 3 * self.n_paths)

    # -- main entry ---------------------------------------------------------
    def update(self, state, path, obstacle_block, s0: float, v_ref: float
               ) -> List[GuidanceTrajectory]:
        cfg = self.cfg
        N, dt = cfg.N, cfg.dt
        rng = np.random.default_rng(self.seed)

        start = np.array([state.get("x"), state.get("y")], dtype=float)

        # Obstacle space-time tracks [M, N+1, 2] (stage k uses prediction
        # step k-1, like the constraint modules; row 0 = current position).
        M = obstacle_block.position.shape[0]
        pred = np.concatenate(
            [obstacle_block.position[:, None, :], obstacle_block.pred_position],
            axis=1,
        )[:, : N + 1]
        radius = np.asarray(obstacle_block.radius, dtype=float)
        clear = radius + cfg.robot_radius + self.margin  # [M]

        # Nominal progress ramp (same profile as the lateral backend).
        v0 = _speed(state)
        a_max = 1.5
        v_prof = np.minimum(v_ref, v0 + a_max * dt * np.arange(N + 1))
        s_prof = np.clip(
            s0 + np.concatenate([[0.0], np.cumsum(v_prof[:-1] * dt)]),
            0.0, path.length,
        )

        # Goal set: longitudinal x lateral grid along the path (ref
        # guidance_planner.yaml `goals: longitudinal / vertical` — the
        # reference places goal stations AT several path stations, each
        # with a lateral fan). Nearer stations carry a shortfall penalty
        # (ref selection_weights `length`) so far goals win when
        # reachable but a blocked corridor still yields plans.
        s_goal = float(s_prof[-1])
        half_width = max(cfg.road.width / 2.0 - cfg.robot_radius, 0.5)
        # Taper the lateral fan toward the path END: a planner that
        # commits to an edge goal station in the final meters reaches
        # the path end off-centerline and PARKS there, outside the task
        # completion ball — measured at B=509 (12-ped corridor: robot
        # stationary at (25.3, -2.2), s saturated, every cycle feasible,
        # 3/5 seeds timing out). Near the end all goals converge to the
        # final path point, like the reference guidance_planner's
        # path-following goal grid does.
        remaining = max(path.length - s0, 0.0)
        lat_scale = float(np.clip(remaining / 8.0, 0.1, 1.0))
        lat_offsets = (
            lat_scale * np.linspace(-half_width, half_width, self.n_goals)
            if self.n_goals > 1 else np.zeros(1)
        )
        long_step = max(1.0, (s_goal - s0) / max(2 * self.n_goals_long, 1))
        goal_list, penalty_list = [], []
        for j in range(self.n_goals_long):
            s_g = max(s0 + 0.5, s_goal - j * long_step)
            g_center = path.at(np.array([s_g]))[0]
            tangent = path.deriv(np.array([s_g]))[0]
            tangent = tangent / (np.linalg.norm(tangent) + 1e-12)
            normal = np.array([-tangent[1], tangent[0]])
            goal_list.append(
                g_center[None, :] + lat_offsets[:, None] * normal[None, :]
            )
            penalty_list.extend([self.goal_length_weight * (s_goal - s_g)]
                                * len(lat_offsets))
        goals = np.concatenate(goal_list, axis=0)
        goal_penalty = np.asarray(penalty_list)

        # -- sample nodes in the space-time ROI ------------------------------
        lo = np.minimum(start, goals.min(axis=0)) - half_width - 1.0
        hi = np.maximum(start, goals.max(axis=0)) + half_width + 1.0
        xy = rng.uniform(lo, hi, size=(self.n_samples, 2))
        kk = rng.integers(1, N, size=self.n_samples)
        # Reject samples colliding with an obstacle at their own time slice
        d_obs = np.linalg.norm(xy[:, None, :] - pred[:, kk, :].transpose(1, 0, 2),
                               axis=-1)  # [n, M]
        keep = np.all(d_obs > clear[None, :], axis=1) if M else np.ones(
            self.n_samples, bool)
        xy, kk = xy[keep], kk[keep]

        pos = np.concatenate([start[None], xy, goals], axis=0)  # [n, 2]
        tk = np.concatenate([[0], kk, np.full(len(goals), N)]).astype(int)

        # -- search: native C++ core when available, vectorized numpy else ---
        candidates = self._search(pos, tk, len(goals), pred, clear, dt,
                                  goal_penalty)

        trajectories: List[GuidanceTrajectory] = []
        seen_signatures = set()
        for cost, node_path in candidates:
            if len(trajectories) >= self.n_paths:
                break
            positions = self._resample(node_path, pos, tk, N,
                                       smooth=self.spline_smoothing)
            tracked, signature = self._signature(positions, pred, radius)
            sig_key = (tracked, signature)
            if sig_key in seen_signatures:
                continue
            seen_signatures.add(sig_key)
            s_out = self._project(path, positions, s0)
            traj = GuidanceTrajectory(
                positions=positions,
                s=s_out,
                signature=signature,
                obstacle_ids=tuple(obstacle_block.index[i] for i in tracked),
            )
            traj.previously_selected = self._matches_selected(traj)
            trajectories.append(traj)

        if not trajectories:
            # Disconnected PRM (e.g. fully blocked corridor): fall back to
            # the constructive lateral backend so T-MPC always has guesses.
            return super().update(state, path, obstacle_block, s0, v_ref)

        # Class scale-out (SURVEY.md §7.7): emit `samples_per_class`
        # retimed warmstart variants per homotopy class — same signature,
        # so selection/consistency treat them as one class while the batch
        # axis carries them all.
        # Variant scale-out tapers out near the path end like the goal
        # fan does: with the whole fleet ending at the saturated path
        # end, the min-cost variant is the gentlest deceleration, and
        # the robot crawls into the completion ball (measured: ~112 vs
        # ~78 steps). The batch stays static — T-MPC pads with
        # duplicates when fewer trajectories are returned.
        spc = max(1, int(getattr(cfg.t_mpc, "samples_per_class", 1)))
        if spc > 1 and remaining > 6.0:
            trajectories = self._expand_classes(trajectories, spc)

        if getattr(cfg.t_mpc, "braking_class", False):
            trajectories.append(self._braking_trajectory(state, path, s0))
        return trajectories

    def _expand_classes(self, trajectories, spc: int):
        """Halton-spread (speed, lateral-bump) variants: genuinely
        distinct at any spc (the 1000+-guesses scale axis) instead of a
        5-entry cycling list. Fully vectorized across classes per
        variant — at spc>100 a per-trajectory `_retime` + `_project`
        loop cost ~230 ms/cycle on the host (measured), 5x the realtime
        budget by itself. Variant progress `s` is the base trajectory's
        `s` retimed with the SAME interpolation (monotone along the
        trajectory; the perpendicular windowed bump, <=0.35 m, moves it
        negligibly), so no path projections are needed at all."""
        C = len(trajectories)
        base_pos = np.stack([t.positions for t in trajectories])  # [C, Np1, 2]
        base_s = np.stack([t.s for t in trajectories])  # [C, Np1]
        Np1 = base_pos.shape[1]
        grid = np.arange(Np1, dtype=float)
        window = np.sin(np.pi * grid / (Np1 - 1.0))
        V = spc - 1  # variants per class beyond the base

        # Speed scale >= 0.85: slower variants measurably drag the whole
        # planner into a low-cost dawdle attractor (B=509 corridor:
        # duration 27.8 s vs 15.8 s at B=5, one seed timing out — the
        # same slow-mode failure the braking class is emergency-gated
        # for). The slow end of the spectrum is already covered by the
        # base classes + braking lane; variants explore equal-or-faster
        # retimings + lateral bumps.
        speeds = np.array([0.85 + 0.5 * _halton(i, 2) for i in range(1, spc)])
        lat_amps = np.array(
            [(2.0 * _halton(i, 3) - 1.0) * 0.35 for i in range(1, spc)]
        )

        # One-shot vectorization over (variant, class, step): a
        # per-variant python loop with np.gradient cost ~24 ms/cycle at
        # spc=127 on the 2-core host — half the realtime budget.
        ks = np.clip(grid[None, :] * speeds[:, None], 0.0, Np1 - 1.0)  # [V, Np1]
        i0 = np.minimum(ks.astype(int), Np1 - 2)
        frac = (ks - i0)[None, :, :, None]  # [1, V, Np1, 1]
        pos = (base_pos[:, i0] * (1.0 - frac)
               + base_pos[:, i0 + 1] * frac)  # [C, V, Np1, 2]
        s_v = base_s[:, i0] * (1.0 - frac[..., 0]) + base_s[:, i0 + 1] * frac[..., 0]
        # Central-difference tangents -> left normals (endpoints one-sided)
        d = np.empty_like(pos)
        d[:, :, 1:-1] = 0.5 * (pos[:, :, 2:] - pos[:, :, :-2])
        d[:, :, 0] = pos[:, :, 1] - pos[:, :, 0]
        d[:, :, -1] = pos[:, :, -1] - pos[:, :, -2]
        nrm = np.linalg.norm(d, axis=-1, keepdims=True) + 1e-12
        normal = np.stack([-d[..., 1], d[..., 0]], axis=-1) / nrm
        pos = pos + (lat_amps[None, :, None, None]
                     * window[None, None, :, None] * normal)

        # Variant-major ordering: [bases..., variant1 of each class...,
        # variant2 of each class...] — stable across cycles so per-
        # element dual carries stay aligned.
        expanded = list(trajectories)
        for v in range(V):
            for c, t in enumerate(trajectories):
                out = GuidanceTrajectory(
                    positions=pos[c, v], s=s_v[c, v], signature=t.signature,
                    obstacle_ids=t.obstacle_ids,
                    base_positions=t.positions,
                )
                out.previously_selected = t.previously_selected
                expanded.append(out)
        return expanded

    def _search(self, pos, tk, n_goals: int, pred, clear, dt: float,
                goal_cost=None):
        """Up to 3*n_paths cost-ordered, homology-distinct node chains from
        node 0 to any goal (the last n_goals nodes). `goal_cost` is a
        per-goal additive penalty applied BEFORE the class dedup (so each
        homology class keeps its preferred goal station)."""
        max_out = 3 * self.n_paths
        result = native.prm_search(pos, tk, n_goals, pred, clear, dt,
                                   self.v_max, self._labels_per_node, max_out,
                                   goal_cost=goal_cost)
        if result is not None:
            return result
        return self._search_numpy(pos, tk, n_goals, pred, clear, dt, max_out,
                                  goal_cost)

    def _search_numpy(self, pos, tk, n_goals: int, pred, clear, dt: float,
                      max_out: int, goal_cost=None):
        """Pure-numpy fallback of the native prm_search (same contract)."""
        n = len(pos)
        N = pred.shape[1] - 1
        M = pred.shape[0]
        goal_ids = np.arange(n - n_goals, n)

        # -- visibility edges (vectorized over all pairs) ---------------------
        ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        valid = tk[jj] > tk[ii]
        span = np.maximum(tk[jj] - tk[ii], 1)
        seg = np.linalg.norm(pos[jj] - pos[ii], axis=-1)
        valid &= seg / (span * dt) <= self.v_max

        # Interpolated robot position at every integer stage for every pair
        ks = np.arange(N + 1)
        frac = np.clip((ks[None, None, :] - tk[ii][..., None]) / span[..., None], 0.0, 1.0)
        p_int = pos[ii][:, :, None, :] + frac[..., None] * (
            pos[jj][:, :, None, :] - pos[ii][:, :, None, :]
        )  # [n, n, N+1, 2]
        in_seg = (ks[None, None, :] >= tk[ii][..., None]) & (
            ks[None, None, :] <= tk[jj][..., None]
        )
        if M:
            rel = p_int[:, :, None, :, :] - pred[None, None, :, :, :]  # [n,n,M,N+1,2]
            d = np.linalg.norm(rel, axis=-1)  # [n, n, M, N+1]
            hit = (d < clear[None, None, :, None]) & in_seg[:, :, None, :]
            valid &= ~hit.any(axis=(2, 3))

            # Winding increment per edge per obstacle: accumulated wrapped
            # angle deltas of the robot-minus-obstacle vector over the
            # edge's time slices (H-signature building block).
            theta = np.arctan2(rel[..., 1], rel[..., 0])  # [n, n, M, N+1]
            dtheta = np.diff(theta, axis=-1)
            dtheta = np.mod(dtheta + np.pi, 2 * np.pi) - np.pi
            step_in = in_seg[:, :, None, 1:] & in_seg[:, :, None, :-1]
            edge_wind = np.sum(np.where(step_in, dtheta, 0.0), axis=-1)  # [n, n, M]
        else:
            edge_wind = np.zeros((n, n, 0))

        np.fill_diagonal(valid, False)

        # -- homology-aware DP over the time-ordered DAG ----------------------
        order = np.argsort(tk, kind="stable")
        # labels[node] = {wind_key: (cost, winding[M], parent, parent_key)}
        labels: List[dict] = [dict() for _ in range(n)]
        zero = np.zeros(M)
        labels[0][()] = (0.0, zero, -1, None)

        for i in order:
            if not labels[i]:
                continue
            items = sorted(labels[i].items(), key=lambda kv: kv[1][0])
            items = items[: self._labels_per_node]
            labels[i] = dict(items)
            succ = np.nonzero(valid[i])[0]
            for key, (cost, wind, _, _) in items:
                for j in succ:
                    w_new = wind + edge_wind[i, j]
                    # Quantize to half-turns: two paths whose winding around
                    # any obstacle differs by >= pi are homotopy-distinct
                    key_new = tuple(np.round(w_new / np.pi).astype(int))
                    c_new = cost + seg[i, j]
                    cur = labels[j].get(key_new)
                    if cur is None or c_new < cur[0]:
                        labels[j][key_new] = (c_new, w_new, i, key)

        # -- extract cost-ordered, homology-distinct goal chains --------------
        gcost = (np.zeros(n_goals) if goal_cost is None
                 else np.asarray(goal_cost, float))
        raw = []
        for gi, g in enumerate(goal_ids):
            for key, (cost, wind, parent, pkey) in labels[g].items():
                raw.append((cost + gcost[gi], g, key))
        raw.sort(key=lambda c: c[0])

        out = []
        seen_keys = set()
        for cost, g, key in raw:
            if len(out) >= max_out:
                break
            if key in seen_keys:
                continue
            seen_keys.add(key)
            out.append((cost, self._backtrack(labels, g, key)))
        return out

    # -- helpers --------------------------------------------------------------
    @staticmethod
    def _backtrack(labels, g: int, key) -> List[int]:
        node_path = [g]
        cur, ckey = g, key
        while True:
            _, _, parent, pkey = labels[cur][ckey]
            if parent < 0:
                break
            node_path.append(parent)
            cur, ckey = parent, pkey
        return node_path[::-1]

    @staticmethod
    def _resample(node_path: List[int], pos, tk, N: int,
                  smooth: bool = True) -> np.ndarray:
        """Node chain -> positions at every integer stage 0..N via a
        natural cubic spline through the PRM nodes (the reference
        spline-smooths selected paths, guidance_planner.yaml
        `spline_optimization`; consumed by guidance_constraints.cpp:
        390-414 as smoothed splines). `smooth=False` falls back to the
        linear polyline (A/B instrumentation only)."""
        ts = tk[node_path].astype(float)
        xs = pos[node_path]
        stages = np.clip(np.arange(N + 1, dtype=float), ts[0], ts[-1])
        if smooth and len(node_path) >= 3:
            out = np.stack(
                [CubicSpline(ts, xs[:, d])(stages) for d in range(2)], axis=-1
            )
        else:  # two nodes: straight segment
            out = np.stack(
                [np.interp(stages, ts, xs[:, d]) for d in range(2)], axis=-1
            )
        return out

    def _signature(self, positions, pred, radius
                   ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Passing-side signature at closest approach, comparable with the
        lateral backend's (+1 left / -1 right in the robot's frame)."""
        M = pred.shape[0]
        if M == 0:
            return (), ()
        d = positions[1:] - positions[:-1]  # [N, 2]
        heading = np.concatenate([d, d[-1:]], axis=0)
        norms = np.linalg.norm(heading, axis=-1, keepdims=True)
        heading = heading / np.maximum(norms, 1e-9)
        rel = pred - positions[None, :, :]  # [M, N+1, 2]
        dist = np.linalg.norm(rel, axis=-1)  # [M, N+1]
        k_close = np.argmin(dist, axis=1)  # [M]
        tracked, signature = [], []
        for m in range(M):
            if dist[m, k_close[m]] > radius[m] + self.clearance + 1.5:
                continue  # never interacts
            h = heading[k_close[m]]
            r = rel[m, k_close[m]]
            cross = h[0] * r[1] - h[1] * r[0]
            # Obstacle on the robot's right (cross < 0) => robot passes left
            signature.append(+1 if cross < 0 else -1)
            tracked.append(m)
        return tuple(tracked), tuple(signature)

    @staticmethod
    def _project(path, positions, s0: float) -> np.ndarray:
        """Monotone progress estimates by projecting onto the path."""
        s_out = np.empty(len(positions))
        s_prev = s0
        for k, p in enumerate(positions):
            s_prev = path.closest_point(p, s_hint=s_prev, window=4.0)
            s_out[k] = s_prev
        return s_out
