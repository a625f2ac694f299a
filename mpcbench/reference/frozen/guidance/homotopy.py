"""Homotopy-class guidance trajectory generation (T-MPC).

Counterpart of mpc_planner_tpu/guidance/homotopy.py (numpy-only, copied
so the port never imports the JAX package). Replacement for the external `guidance_planner` dependency
(SURVEY.md §2.4: Visibility-PRM over (x, y, t) with homology-class
filtering, consumed by guidance_constraints.cpp:32-108).

Redesign rationale: the reference's PRM is a sequential graph search
producing n_paths (=4) homotopy-distinct trajectories. What T-MPC
actually needs from it is (a) distinct passing-side combinations around
the nearby obstacles and (b) a dynamically plausible warmstart per class.
Both are produced here directly in path-frame coordinates: enumerate
side assignments sigma in {left, right}^m for the m closest interacting
obstacles, build a lateral-offset profile per class that clears each
obstacle on its assigned side, and smooth it. This is vectorized numpy
(sub-ms), deterministic, and scales to arbitrarily many guesses per
class by sampling margins/velocities — the batch axis the TPU solver
wants (1000+ parallel solves, BASELINE.md).

Homology bookkeeping matches the reference's selection logic: a class is
identified by its side-assignment signature; the previously selected
signature gets the consistency bonus (guidance_constraints.cpp:358-359)
and can be re-identified across cycles
(`OverrideSelectedTrajectory`, :380).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


def _halton(i: int, base: int) -> float:
    """Halton low-discrepancy sequence member i (>=1) in (0, 1): gives
    `samples_per_class` GENUINELY distinct warmstart variations at any
    scale instead of a short cycling list (the 1000+-guesses axis,
    BASELINE.md)."""
    f, r = 1.0, 0.0
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def _speed(state) -> float:
    """Forward speed; holonomic models carry (vx, vy) instead of v."""
    v = state.get("v")
    if v == 0.0 and "v" not in getattr(state, "names", ["v"]):
        v = float(np.hypot(state.get("vx"), state.get("vy")))
    return max(v, 0.0)


@dataclass
class GuidanceTrajectory:
    positions: np.ndarray  # [N+1, 2]
    s: np.ndarray  # [N+1] progress along path
    signature: Tuple[int, ...]  # passing side per tracked obstacle (+1 left / -1 right / 0 n.a.)
    obstacle_ids: Tuple[int, ...]  # which obstacles the signature refers to
    previously_selected: bool = False
    braking: bool = False  # decelerate-to-stop class (no passing signature)
    # For samples_per_class variants: the CLASS representative's
    # positions. Topology halfspaces are linearized around the class
    # representative so every variant solves the SAME constraint
    # geometry (true multistart) — linearizing around each bumped/
    # retimed variant instead lets comfortable-but-slow feasible tubes
    # win selection (measured: 12-ped corridor duration 22.3 s vs
    # 15.6 s at B=5).
    base_positions: Optional[np.ndarray] = None


class GuidancePlanner:
    """Generates homotopy-distinct guidance trajectories along a path."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.n_paths = cfg.t_mpc.n_paths
        self.max_tracked = 4  # side-enumerated obstacles (2^4 combos max)
        self.clearance = cfg.robot_radius + cfg.obstacle_radius + 0.25
        # (obstacle_ids, signature, braking) of the winning class
        self.selected_signature: Optional[
            Tuple[Tuple[int, ...], Tuple[int, ...], bool]
        ] = None

    def reset(self) -> None:
        self.selected_signature = None

    def update(
        self,
        state,
        path,  # PathSpline2D
        obstacle_block,  # ObstacleBlock
        s0: float,
        v_ref: float,
    ) -> List[GuidanceTrajectory]:
        """Build up to n_paths guidance trajectories for this cycle."""
        cfg = self.cfg
        N, dt = cfg.N, cfg.dt

        # Nominal progress: ramp from current speed toward v_ref
        v0 = _speed(state)
        a_max = 1.5
        v_prof = np.minimum(v_ref, v0 + a_max * dt * np.arange(N + 1))
        s_prof = np.clip(s0 + np.concatenate([[0.0], np.cumsum(v_prof[:-1] * dt)]),
                         0.0, path.length)
        nominal = path.at(s_prof)  # [N+1, 2]
        tangents = path.deriv(s_prof)
        tangents /= np.linalg.norm(tangents, axis=-1, keepdims=True) + 1e-12
        normals = np.stack([-tangents[:, 1], tangents[:, 0]], axis=-1)  # left normal

        # Obstacle lateral/longitudinal tracks in the path frame.
        # pred_position [M, N, 2] -> per stage k use prediction step k-1
        # like the constraints do (k=0 row uses current position).
        M = obstacle_block.position.shape[0]
        pred = np.concatenate(
            [obstacle_block.position[:, None, :], obstacle_block.pred_position], axis=1
        )[:, : N + 1]  # [M, N+1, 2]
        rel = pred - nominal[None, :, :]
        lat = np.einsum("mkd,kd->mk", rel, normals)  # lateral offset of obstacle
        lon = np.einsum("mkd,kd->mk", rel, tangents)
        dist = np.linalg.norm(rel, axis=-1)

        # Interacting obstacles: close to the nominal trajectory laterally
        # and longitudinally during the horizon
        interacting = (np.abs(lat) < self.clearance + 1.0) & (np.abs(lon) < 2.0)
        relevance = np.where(interacting.any(axis=1), dist.min(axis=1), np.inf)
        order = np.argsort(relevance)
        tracked = [int(i) for i in order[: self.max_tracked] if np.isfinite(relevance[i])]

        radius = obstacle_block.radius  # [M]

        if not tracked:
            sig = ()
            traj = GuidanceTrajectory(
                positions=nominal, s=s_prof, signature=sig, obstacle_ids=())
            traj.previously_selected = self._matches_selected(traj)
            out = [traj]
            if getattr(cfg.t_mpc, "braking_class", False):
                out.append(self._braking_trajectory(state, path, s0))
            return out

        # Enumerate side combinations, nearest obstacle varies fastest
        combos = list(itertools.product((+1, -1), repeat=len(tracked)))
        # Order: prefer combos closer to "natural" side (obstacle's current side)
        natural = tuple(+1 if lat[i, 0] <= 0 else -1 for i in tracked)

        def combo_cost(c):
            return sum(0 if ci == ni else 1 for ci, ni in zip(c, natural))

        combos.sort(key=combo_cost)
        combos = combos[: self.n_paths]

        # Scale-out beyond the reference's 4 classes (SURVEY.md §7.7): per
        # class, emit `samples_per_class` warmstart variations (margin and
        # speed-profile scalings). Same signature -> same homotopy class for
        # selection/consistency purposes; the batch axis carries them all.
        spc = max(1, int(getattr(self.cfg.t_mpc, "samples_per_class", 1)))
        variations = [(1.0, 1.0)]
        # Variant scale-out tapers out near the path end (same rationale
        # as the PRM backend: an all-variant fleet ending at the
        # saturated path end selects the gentlest deceleration and
        # crawls into the completion ball).
        if spc > 1 and (path.length - s0) > 6.0:
            # Halton-spread (margin, speed) pairs: all distinct at any spc
            variations += [
                (0.6 + 1.2 * _halton(i, 2), 0.6 + 0.6 * _halton(i, 3))
                for i in range(1, spc)
            ]

        trajectories = []
        base_clearance = self.clearance
        for combo in combos:
            ids = tuple(obstacle_block.index[i] for i in tracked)
            class_base = None  # the (1.0, 1.0) variation's positions
            for margin_scale, speed_scale in variations:
                self.clearance = base_clearance * margin_scale
                offset = self._lateral_profile(tracked, combo, lat, lon, radius, N)
                self.clearance = base_clearance
                s_var = s_prof if speed_scale == 1.0 else np.clip(
                    s0 + (s_prof - s0) * speed_scale, 0.0, path.length
                )
                pos_var = (
                    nominal if speed_scale == 1.0 else path.at(s_var)
                )
                if speed_scale != 1.0:
                    tan_var = path.deriv(s_var)
                    tan_var /= np.linalg.norm(tan_var, axis=-1, keepdims=True) + 1e-12
                    norm_var = np.stack([-tan_var[:, 1], tan_var[:, 0]], axis=-1)
                else:
                    norm_var = normals
                traj = GuidanceTrajectory(
                    positions=pos_var + offset[:, None] * norm_var,
                    s=s_var,
                    signature=tuple(combo),
                    obstacle_ids=ids,
                    # Variants share the class representative's halfspace
                    # linearization (see GuidanceTrajectory.base_positions)
                    base_positions=class_base,
                )
                if class_base is None:
                    class_base = traj.positions
                traj.previously_selected = self._matches_selected(traj)
                trajectories.append(traj)
        if getattr(cfg.t_mpc, "braking_class", False):
            trajectories.append(self._braking_trajectory(state, path, s0))
        return trajectories

    def _braking_trajectory(self, state, path, s0: float) -> GuidanceTrajectory:
        """Decelerate-to-stop class: stay in lane, comfortable decel to 0.

        Gives T-MPC a feasible plan when every passing class is blocked
        (dense crowds) — the TPU batch is wide enough that reserving a
        lane for "slow down" costs nothing."""
        cfg = self.cfg
        N, dt = cfg.N, cfg.dt
        decel = getattr(cfg.t_mpc, "braking_deceleration", 2.0)
        v0 = _speed(state)
        v_prof = np.maximum(0.0, v0 - decel * dt * np.arange(N + 1))
        s_prof = np.clip(
            s0 + np.concatenate([[0.0], np.cumsum(v_prof[:-1] * dt)]),
            0.0, path.length,
        )
        traj = GuidanceTrajectory(
            positions=path.at(s_prof), s=s_prof, signature=(),
            obstacle_ids=(), braking=True,
        )
        traj.previously_selected = self._matches_selected(traj)
        return traj

    def _lateral_profile(self, tracked, combo, lat, lon, radius, N) -> np.ndarray:
        """Offset profile l_k clearing each tracked obstacle on its side."""
        lower = np.full(N + 1, -np.inf)
        upper = np.full(N + 1, np.inf)
        target = np.zeros(N + 1)
        for side, i in zip(combo, tracked):
            clear = radius[i] + self.clearance
            active = np.abs(lon[i]) < 2.5  # longitudinally relevant stages
            if side > 0:  # pass on the left: l >= lat + clearance
                lower = np.where(active, np.maximum(lower, lat[i] + clear), lower)
            else:  # right
                upper = np.where(active, np.minimum(upper, lat[i] - clear), upper)
        # Choose the offset: closest point to 0 within [lower, upper]
        feasible = lower <= upper
        l = np.clip(target, np.where(np.isfinite(lower), lower, -1e3),
                    np.where(np.isfinite(upper), upper, 1e3))
        l = np.where(feasible, l, np.where(np.isfinite(lower), lower, upper))
        l = np.where(np.isfinite(l), l, 0.0)
        # Rate-limit the lateral motion so the warmstart stays dynamically
        # plausible (a lateral step jump makes every guided solve start far
        # from feasibility). ~1.75 m/s lateral at dt = 0.2.
        rate = 0.35
        l[0] = 0.0
        for k in range(1, N + 1):  # reachable going forward
            l[k] = np.clip(l[k], l[k - 1] - rate, l[k - 1] + rate)
        # Smooth (simple moving average, elastic-band-like)
        kernel = np.array([0.25, 0.5, 0.25])
        for _ in range(3):
            l = np.convolve(np.pad(l, 1, mode="edge"), kernel, mode="valid")
        l[0] = 0.0  # trajectory starts at the robot
        return l

    # -- selection bookkeeping (ref :358-359, :380, :416-434) --------------
    def _matches_selected(self, traj: GuidanceTrajectory) -> bool:
        if self.selected_signature is None:
            return False
        sel_ids, sel_sig, sel_braking = self.selected_signature
        if sel_braking or traj.braking:
            return sel_braking and traj.braking
        # Compare on common obstacle ids
        common = set(sel_ids) & set(traj.obstacle_ids)
        if not common and (sel_ids or traj.obstacle_ids):
            return not sel_ids and not traj.obstacle_ids
        for oid in common:
            si = sel_sig[sel_ids.index(oid)]
            ti = traj.signature[traj.obstacle_ids.index(oid)]
            if si != ti:
                return False
        return True

    def override_selected(self, traj: Optional[GuidanceTrajectory]) -> None:
        if traj is None:
            self.selected_signature = None
        else:
            self.selected_signature = (
                tuple(traj.obstacle_ids), tuple(traj.signature), traj.braking
            )
