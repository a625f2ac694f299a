"""Device-side sampled guidance: the homotopy-class search as one batched
sweep on the planner's device (`guidance_backend="sampled"`).

Counterpart of mpc_planner_tpu/guidance/device_prm.py. The host backends
search a ~30-node PRM graph sequentially (guidance/prm.py); this one
evaluates S candidate space-time paths at once: sampling, collision
checks against the moving obstacle predictions, passing-side (homotopy)
signatures and costs are fixed-shape batched tensor ops. The host then
takes the cheapest feasible candidate per distinct signature.

Candidates are piecewise-linear space-time paths start -> via1 -> via2 ->
goal (vias sampled along the start->goal chord with lateral offsets, goals
from the PRM backend's lateral fan), smoothed by a fixed endpoint-pinned
kernel: from via points to positions is one precomputed [N+1, 4] basis.

The sweep is split in two: `draw` makes the random numbers from a
torch.Generator on the planner's device (seeded from `prm_seed` every
cycle, as the reference seeds PRNGKey(seed) every cycle), and `score` is a
pure function of them. torch's generator and jax.random differ, so tests
hand the reference's draws to `score` and compare it with the reference's
sweep on the same key.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from mpc_planner_tpu_torch import default_device
from mpc_planner_tpu_torch.guidance.homotopy import GuidanceTrajectory, _speed
from mpc_planner_tpu_torch.guidance.prm import VisibilityPRMPlanner

# jnp.interp's guard against a zero-length interval: intervals this short
# take the left end's value (np.spacing of float32's eps).
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def draw(generator: torch.Generator, S: int, n_goals: int, w_lat: float):
    """The sweep's random numbers on the generator's device: goal index
    gidx [S] uniform in [0, n_goals), via stations u [S, 2] uniform in
    [0, 1), lateral offsets lat [S, 2] uniform in [-w_lat, w_lat) (the
    reference's randint and uniforms, device_prm.py:61-75)."""
    dev = generator.device
    gidx = torch.randint(0, n_goals, (S,), generator=generator, device=dev)
    u = torch.rand((S, 2), generator=generator, device=dev)
    lat = -w_lat + (2.0 * w_lat) * torch.rand((S, 2), generator=generator, device=dev)
    return gidx, u, lat


def _norm(v):
    """Euclidean norm over the last axis, as jnp.linalg.norm sums it."""
    return torch.sqrt((v * v).sum(-1))


def _interp(x, xp, fp):
    """jnp.interp row by row: x, xp [S, L] (xp ascending), fp [S, L, D] ->
    [S, L, D]. The same formula as JAX's (lax_numpy._interp): the interval
    from searchsorted(side='right') clipped to [1, L-1], a zero-length
    interval giving its left value, constant ends."""
    L = xp.shape[-1]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True).clamp(1, L - 1)
    x0, x1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    idx = (i - 1).unsqueeze(-1).expand(-1, -1, fp.shape[-1])
    f0 = fp.gather(1, idx)
    df = fp.gather(1, idx + 1) - f0
    dx = (x1 - x0).unsqueeze(-1)
    delta = (x - x0).unsqueeze(-1)
    dx0 = dx.abs() <= _INTERP_EPS
    f = torch.where(dx0, f0, f0 + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where((x < xp[:, :1]).unsqueeze(-1), fp[:, :1], f)
    return torch.where((x > xp[:, -1:]).unsqueeze(-1), fp[:, -1:], f)


def score(basis, start, goals, pred, clear, gidx, u, lat, track_thresh, s_prof, goal_weight):
    """One batched guidance sweep from given draws (the reference's
    `_sample_and_score` after its draws, device_prm.py:61-125).

    basis [N+1, 4]: smoothing @ piecewise-linear interpolation weights of
    the node sequence (start, via1, via2, goal); start [2]; goals [G, 2];
    pred [M, N+1, 2] obstacle tracks; clear [M] required clearance;
    gidx [S], u [S, 2], lat [S, 2] from `draw`; s_prof [N+1] the
    acceleration-limited arc-length budget: candidates are retimed so that
    at step k they have traveled at most s_prof[k] along their own
    geometry. Scalars are 0-d tensors (or floats). Returns positions
    [S, N+1, 2], side [S, M] int8 (+1 passes left, -1 right, 0 not
    tracked), cost [S], feasible [S] bool.
    """
    S = gidx.shape[0]
    goal = goals[gidx]  # [S, 2]
    g = goal - start[None, :]
    g_unit = g / torch.clamp(_norm(g).unsqueeze(-1), min=1e-9)
    n_unit = torch.stack([-g_unit[:, 1], g_unit[:, 0]], dim=-1)
    u1 = 0.15 + 0.30 * u[:, 0]
    u2 = 0.55 + 0.30 * u[:, 1]
    v1 = start[None, :] + u1[:, None] * g + lat[:, :1] * n_unit
    v2 = start[None, :] + u2[:, None] * g + lat[:, 1:] * n_unit
    nodes = torch.stack([start.expand(S, 2), v1, v2, goal], dim=1)  # [S, 4, 2]
    geom = torch.einsum("kn,snd->skd", basis, nodes)  # [S, N+1, 2]

    # Acceleration-limited retiming along each candidate's own arc length
    seg0 = _norm(geom[:, 1:] - geom[:, :-1])  # [S, N]
    cum = torch.cat([seg0.new_zeros(S, 1), torch.cumsum(seg0, dim=1)], dim=1)  # [S, N+1]
    target = torch.minimum(s_prof[None, :], cum[:, -1:])
    positions = _interp(target, cum, geom)

    rel = positions[:, None, :, :] - pred[None, :, :, :]  # [S, M, N+1, 2]
    dist = _norm(rel)  # [S, M, N+1]
    dmin = dist.amin(dim=-1)  # [S, M]
    feasible = (dmin > clear[None, :]).all(dim=-1)

    # Passing side at closest approach (the host backends' convention:
    # obstacle on the robot's right => robot passes left => +1).
    d = positions[:, 1:] - positions[:, :-1]
    heading = torch.cat([d, d[:, -1:]], dim=1)  # [S, N+1, 2]
    heading = heading / torch.clamp(_norm(heading).unsqueeze(-1), min=1e-9)
    kmin = torch.argmin(dist, dim=-1)  # [S, M], the first index on ties
    at = kmin[..., None, None].expand(-1, -1, 1, 2)
    h = torch.gather(heading[:, None].expand(-1, rel.shape[1], -1, -1), 2, at)[:, :, 0]
    r = torch.gather(rel, 2, at)[:, :, 0]
    cross = h[..., 0] * r[..., 1] - h[..., 1] * r[..., 0]
    tracked = dmin < clear + track_thresh
    one = torch.ones_like(cross, dtype=torch.int8)
    side = torch.where(tracked, torch.where(cross < 0, one, -one), 0 * one)

    # Length + goal shortfall (retimed candidates may not reach their goal
    # within the horizon; the PRM's selection_weights length term)
    shortfall = _norm(positions[:, -1] - goal)
    cost = _norm(d).sum(dim=-1) + goal_weight * shortfall
    return positions, side, cost, feasible


class DeviceSampledPlanner(VisibilityPRMPlanner):
    """Batched device-side guidance backend (`guidance_backend="sampled"`).

    Inherits the PRM backend's goal fan, progress projection and selection
    bookkeeping; replaces the sequential graph search with the sweep above
    on `device` (None: the card, as every entry point of the port).
    """

    def __init__(self, cfg, device=None):
        super().__init__(cfg)
        self.n_samples = int(cfg.t_mpc.sampled_n_samples)
        self.device = default_device(device)
        self._basis_cache = {}

    def _basis(self, N: int) -> torch.Tensor:
        """[N+1, 4] = smoothing @ piecewise-linear node interpolation, on
        the device."""
        b = self._basis_cache.get(N)
        if b is not None:
            return b
        ts = np.array([0.0, N / 3.0, 2.0 * N / 3.0, float(N)])
        ks = np.arange(N + 1, dtype=float)
        W = np.zeros((N + 1, 4))
        for j in range(3):
            inseg = (ks >= ts[j]) & (ks <= ts[j + 1])
            frac = (ks - ts[j]) / (ts[j + 1] - ts[j])
            W[inseg, j] = 1.0 - frac[inseg]
            W[inseg, j + 1] = frac[inseg]
        # Endpoint-pinned 121 smoothing, applied twice (the kernel the host
        # backends use on their resampled node chains).
        A = np.zeros((N + 1, N + 1))
        for k in range(N + 1):
            if k in (0, N):
                A[k, k] = 1.0
            else:
                A[k, k - 1: k + 2] = (0.25, 0.5, 0.25)
        b = torch.as_tensor(A @ A @ W, dtype=torch.float32, device=self.device)
        self._basis_cache[N] = b
        return b

    def _draws(self, S: int, n_goals: int, w_lat: float):
        """This cycle's draws: a generator seeded from `prm_seed`, every
        call."""
        return draw(torch.Generator(device=self.device).manual_seed(self.seed), S, n_goals, w_lat)

    def update(self, state, path, obstacle_block, s0: float, v_ref: float
               ) -> List[GuidanceTrajectory]:
        cfg = self.cfg
        N, dt = cfg.N, cfg.dt
        M = obstacle_block.position.shape[0]
        if M == 0:
            return super().update(state, path, obstacle_block, s0, v_ref)

        start = np.array([state.get("x"), state.get("y")], dtype=float)
        pred = np.concatenate(
            [obstacle_block.position[:, None, :], obstacle_block.pred_position], axis=1,
        )[:, : N + 1]
        clear = np.asarray(obstacle_block.radius, dtype=float) + cfg.robot_radius + self.margin

        # Goal fan + ROI identical to the PRM backend's.
        v0 = _speed(state)
        v_prof = np.minimum(v_ref, v0 + 1.5 * dt * np.arange(N + 1))
        s_goal = float(np.clip(s0 + np.sum(v_prof[:-1] * dt), 0.0, path.length))
        g_center = path.at(np.array([s_goal]))[0]
        tangent = path.deriv(np.array([s_goal]))[0]
        tangent = tangent / (np.linalg.norm(tangent) + 1e-12)
        normal = np.array([-tangent[1], tangent[0]])
        half_width = max(cfg.road.width / 2.0 - cfg.robot_radius, 0.5)
        # The PRM backend's end-of-path taper of the lateral fan
        lat_scale = float(np.clip((path.length - s0) / 8.0, 0.1, 1.0))
        lat_offsets = (
            lat_scale * np.linspace(-half_width, half_width, self.n_goals)
            if self.n_goals > 1 else np.zeros(1)
        )
        goals = g_center[None, :] + lat_offsets[:, None] * normal[None, :]
        s_prof = np.concatenate([[0.0], np.cumsum(v_prof[:-1] * dt)])

        def f32(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float32), device=self.device)

        gidx, u, lat = self._draws(self.n_samples, len(goals), float(np.float32(half_width + 1.0)))
        positions_d, side_d, cost_d, feas_d = score(
            self._basis(N), f32(start), f32(goals), f32(pred), f32(clear), gidx, u, lat,
            f32(self.clearance + 1.5), f32(s_prof),
            f32(getattr(cfg.t_mpc, "prm_goal_length_weight", 2.0)))
        # One device->host copy of (side, cost, feasible), packed
        S = self.n_samples
        packed = torch.cat([side_d.reshape(-1).float(), cost_d, feas_d.float()]).cpu().numpy()
        side = packed[: S * M].reshape(S, M).astype(np.int8)
        cost = packed[S * M: S * M + S]
        feas = packed[S * M + S:] > 0.5

        spc = max(1, int(getattr(cfg.t_mpc, "samples_per_class", 1)))
        order = np.argsort(cost, kind="stable")
        per_class: dict = {}
        chosen: List[int] = []
        for i in order:
            if not feas[i]:
                continue
            key = tuple(int(x) for x in side[i])
            n_in_class = per_class.get(key, 0)
            if n_in_class >= spc:
                continue
            if n_in_class == 0 and len(per_class) >= self.n_paths:
                continue
            per_class[key] = n_in_class + 1
            chosen.append(int(i))
            if len(chosen) >= self.n_paths * spc:
                break

        if not chosen:
            # Fully blocked sweep: the PRM and lateral fallbacks still
            # produce in-lane and braking classes.
            return super().update(state, path, obstacle_block, s0, v_ref)

        # The second and last copy: the chosen rows of positions
        rows = torch.as_tensor(chosen, device=self.device)
        pos_np = positions_d[rows].cpu().numpy()
        trajectories: List[GuidanceTrajectory] = []
        for row, i in enumerate(chosen):
            tracked = tuple(int(m) for m in np.nonzero(side[i])[0])
            # Monotonize progress: lateral swerves can project to briefly
            # decreasing s; the spline state must not run backwards.
            traj = GuidanceTrajectory(
                positions=pos_np[row],
                s=np.maximum.accumulate(self._project(path, pos_np[row], s0)),
                signature=tuple(int(side[i][m]) for m in tracked),
                obstacle_ids=tuple(int(obstacle_block.index[m]) for m in tracked),
            )
            traj.previously_selected = self._matches_selected(traj)
            trajectories.append(traj)

        if getattr(cfg.t_mpc, "braking_class", False):
            trajectories.append(self._braking_trajectory(state, path, s0))
        return trajectories
