"""Dynamics models + RK4 discretization as torch functions.

Counterpart of mpc_planner_tpu/models/dynamics.py (ref solver_generator/
solver_model.py:49-214). Linearization (A_k, B_k) is `torch.func.jacfwd`
of the discrete step, so every model function is written with tensor ops
only (no `.item()`, no branches on values).

Conventions (identical to the reference):
  z = concat(u, x)          (inputs first, solver_model.py `get`)
  bounds: lower/upper over z (solver_model.py lower_bound/upper_bound)
  discretization: explicit RK4 with `num_steps` sub-steps over dt
  (acados ERK, sim_method_num_stages=4, num_steps=3 —
   generate_acados_solver.py:151-153)
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from mpc_planner_tpu_torch.utils.math import atan2


def rk4_step(f, x, u, dt: float, num_steps: int = 3):
    """Explicit RK4 over `dt` split into `num_steps` sub-intervals."""
    h = dt / num_steps
    for _ in range(num_steps):
        k1 = f(x, u)
        k2 = f(x + 0.5 * h * k1, u)
        k3 = f(x + 0.5 * h * k2, u)
        k4 = f(x + h * k3, u)
        x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x


class DynamicsModel:
    """Base dynamics model (ref solver_model.py:49-167).

    Subclasses define `states`, `inputs`, bounds, and `continuous_model`.
    Optionally `discrete_update(z, x_next, p, ocp)` post-processes
    integrated states (used by curvature-aware models for the spline
    state, ref solver_model.py:242-271).
    """

    states: Sequence[str] = ()
    inputs: Sequence[str] = ()
    lower_bound: Sequence[float] = ()
    upper_bound: Sequence[float] = ()
    nx_integrate: Optional[int] = None  # integrate only the first n states
    width: float = 0.65  # collision width [m], used by contouring constraints

    @property
    def nu(self) -> int:
        return len(self.inputs)

    @property
    def nx(self) -> int:
        return len(self.states)

    @property
    def nvar(self) -> int:
        return self.nu + self.nx

    # -- name addressing (ref solver_model.py get/save_map) -------------
    def index(self, name: str) -> int:
        """Index of a state or input within z = (u, x)."""
        if name in self.inputs:
            return list(self.inputs).index(name)
        if name in self.states:
            return self.nu + list(self.states).index(name)
        raise KeyError(f"'{name}' is neither a state nor an input of {type(self).__name__}")

    def get(self, z, name: str):
        return z[..., self.index(name)]

    def get_bounds(self, name: str) -> Tuple[float, float, float]:
        """(lower, upper, upper - lower) of a state or input."""
        i = self.index(name)
        return self.lower_bound[i], self.upper_bound[i], self.upper_bound[i] - self.lower_bound[i]

    def save_map(self) -> dict:
        """model_map.yaml contract (ref solver_model.py:118-128)."""
        out = {}
        for idx, s in enumerate(self.states):
            out[s] = ["x", idx + self.nu, self.lower_bound[self.nu + idx], self.upper_bound[self.nu + idx]]
        for idx, u in enumerate(self.inputs):
            out[u] = ["u", idx, self.lower_bound[idx], self.upper_bound[idx]]
        return out

    # -- dynamics --------------------------------------------------------
    def continuous_model(self, x, u):
        raise NotImplementedError

    def discrete_dynamics(self, z, p, dt: float, num_steps: int = 3, ocp=None):
        """x_{k+1} = F(z_k). `p`/`ocp` feed parameter-dependent discrete
        updates (curvature-aware spline state)."""
        u = z[..., : self.nu]
        x = z[..., self.nu :]
        n_int = self.nx if self.nx_integrate is None else self.nx_integrate
        x_int = rk4_step(self.continuous_model, x[..., :n_int], u, dt, num_steps)
        return self.discrete_update(z, x_int, p, ocp)

    def discrete_update(self, z, x_int, p, ocp):
        """Append/post-process non-integrated states (default: identity)."""
        return x_int


class SecondOrderUnicycleModel(DynamicsModel):
    """Ref solver_model.py:170-190."""

    states = ("x", "y", "psi", "v")
    inputs = ("a", "w")
    lower_bound = (-2.0, -2.0, -200.0, -200.0, -math.pi * 4, -2.0)
    upper_bound = (2.0, 2.0, 200.0, 200.0, math.pi * 4, 3.0)

    def continuous_model(self, x, u):
        a, w = u[..., 0], u[..., 1]
        psi, v = x[..., 2], x[..., 3]
        return torch.stack([v * torch.cos(psi), v * torch.sin(psi), w, a], dim=-1)


class PointMassModel(DynamicsModel):
    """Holonomic double-integrator (omnidirectional base, e.g. Dingo).

    Ref mpc_planner_dingo/scripts/generate_dingo_solver.py:31-45
    (ContouringPointMassModel): states (x, y, vx, vy), inputs (ax, ay).
    """

    states = ("x", "y", "vx", "vy")
    inputs = ("ax", "ay")
    lower_bound = (-1.0, -1.0, -200.0, -200.0, -1.0, -1.0)
    upper_bound = (1.0, 1.0, 200.0, 200.0, 1.0, 1.0)

    def continuous_model(self, x, u):
        return torch.stack([x[..., 2], x[..., 3], u[..., 0], u[..., 1]], dim=-1)


class ContouringSecondOrderUnicycleModel(DynamicsModel):
    """Unicycle + spline-progress state (ref solver_model.py:193-214)."""

    states = ("x", "y", "psi", "v", "spline")
    inputs = ("a", "w")
    lower_bound = (-2.0, -0.8, -2000.0, -2000.0, -math.pi * 4, -0.01, -1.0)
    upper_bound = (2.0, 0.8, 2000.0, 2000.0, math.pi * 4, 3.0, 10000.0)

    def continuous_model(self, x, u):
        a, w = u[..., 0], u[..., 1]
        psi, v = x[..., 2], x[..., 3]
        return torch.stack([v * torch.cos(psi), v * torch.sin(psi), w, a, v], dim=-1)


class ContouringSecondOrderUnicycleModelWithSlack(ContouringSecondOrderUnicycleModel):
    """Adds a slack variable, as an INPUT (per-stage slack freedom, the form
    of the reference's other slack models, solver_model.py:310, :363). A
    slack STATE would be pinned at stage 0 by the Riccati rollout (dx0 = 0)
    and frozen over the horizon (the reference's fix 3257449)."""

    states = ("x", "y", "psi", "v", "spline")
    inputs = ("a", "w", "slack")
    lower_bound = (-2.0, -0.8, 0.0, -2000.0, -2000.0, -math.pi * 4, -0.01, -1.0)
    upper_bound = (2.0, 0.8, 5000.0, 2000.0, 2000.0, math.pi * 4, 3.0, 10000.0)


def _curvature_aware_spline_update(model, z, x_int, p, ocp):
    """Discrete spline-progress update for CA-MPC models
    (ref solver_model.py:242-271 / :398-437).

    Projects the integrated position advance onto the path to obtain the
    exact progress increment s+ = s + R * atan2(v_t, R - e_c - v_n).

    Outside an OCP context (ocp=None: a simulator integrating the true
    robot state, which has no spline parameters) the projection is
    unavailable; progress then advances by the traveled distance (the
    contouring module re-projects `spline` from the real path every cycle).
    """
    from mpc_planner_tpu_torch.splines import Spline2D

    x = z[..., model.nu :]
    pos_x, pos_y, s = x[..., 0], x[..., 1], x[..., -1]

    if ocp is None:
        ds = torch.hypot(x_int[..., 0] - pos_x, x_int[..., 1] - pos_y)
        return torch.cat([x_int, (s + ds)[..., None]], dim=-1)

    path = Spline2D(ocp.params.bind(p), ocp.num_segments, s)
    path_x, path_y = path.at(s)
    dxn, dyn = path.deriv_normalized(s)

    contour_error = dyn * (pos_x - path_x) - dxn * (pos_y - path_y)

    dpx = x_int[..., 0] - pos_x
    dpy = x_int[..., 1] - pos_y
    vt = dpx * dxn + dpy * dyn
    vn = dpx * dyn - dpy * dxn

    R = 1.0 / torch.clamp(path.get_curvature(s), min=1e-10)
    R = torch.clamp(R, min=1e5)  # ref solver_model.py:266 (cd.fmax(R, 1e5))

    theta = atan2(vt, R - contour_error - vn)
    s_next = s + R * theta
    return torch.cat([x_int, s_next[..., None]], dim=-1)


class ContouringSecondOrderUnicycleModelCurvatureAware(DynamicsModel):
    """CA-MPC unicycle: spline state via discrete projection update
    (ref solver_model.py:217-271)."""

    states = ("x", "y", "psi", "v", "spline")
    inputs = ("a", "w")
    lower_bound = (-4.0, -0.8, -2000.0, -2000.0, -math.pi * 4, -0.01, -1.0)
    upper_bound = (4.0, 0.8, 2000.0, 2000.0, math.pi * 4, 3.0, 10000.0)
    nx_integrate = 4

    def continuous_model(self, x, u):
        a, w = u[..., 0], u[..., 1]
        psi, v = x[..., 2], x[..., 3]
        return torch.stack([v * torch.cos(psi), v * torch.sin(psi), w, a], dim=-1)

    def discrete_update(self, z, x_int, p, ocp):
        return _curvature_aware_spline_update(self, z, x_int, p, ocp)


class BicycleModel2ndOrder(DynamicsModel):
    """Bicycle with dynamic steering + slack input (ref solver_model.py:302-352)."""

    states = ("x", "y", "psi", "v", "delta", "spline")
    inputs = ("a", "w", "slack")
    lower_bound = (-3.0, -1.5, 0.0, -1.0e6, -1.0e6, -math.pi * 4, -0.01, -0.55, -1.0)
    upper_bound = (3.0, 1.5, 1.0e2, 1.0e6, 1.0e6, math.pi * 4, 5.0, 0.55, 5000.0)

    wheel_base = 2.79
    width = 2.25

    def continuous_model(self, x, u):
        a, w = u[..., 0], u[..., 1]
        psi, v, delta = x[..., 2], x[..., 3], x[..., 4]
        lr = self.wheel_base / 2.0
        lf = self.wheel_base / 2.0
        ratio = lr / (lr + lf)
        beta = torch.atan(ratio * torch.tan(delta))
        return torch.stack(
            [
                v * torch.cos(psi + beta),
                v * torch.sin(psi + beta),
                (v / lr) * torch.sin(beta),
                a,
                w,
                v,
            ],
            dim=-1,
        )


class BicycleModel2ndOrderCurvatureAware(DynamicsModel):
    """CA bicycle (ref solver_model.py:355-437)."""

    states = ("x", "y", "psi", "v", "delta", "spline")
    inputs = ("a", "w", "slack")
    lower_bound = (-3.0, -1.5, 0.0, -1.0e6, -1.0e6, -math.pi * 4, -0.01, -0.55, -1.0)
    upper_bound = (3.0, 1.5, 1.0e2, 1.0e6, 1.0e6, math.pi * 4, 8.0, 0.55, 5000.0)
    nx_integrate = 5

    wheel_base = 2.79
    width = 2.25
    lr = 2.79 / 2.0
    lf = 2.79 / 2.0

    def continuous_model(self, x, u):
        a, w = u[..., 0], u[..., 1]
        psi, v, delta = x[..., 2], x[..., 3], x[..., 4]
        ratio = self.lr / (self.lr + self.lf)
        beta = torch.atan(ratio * torch.tan(delta))
        return torch.stack(
            [
                v * torch.cos(psi + beta),
                v * torch.sin(psi + beta),
                (v / self.lr) * torch.sin(beta),
                a,
                w,
            ],
            dim=-1,
        )

    def discrete_update(self, z, x_int, p, ocp):
        return _curvature_aware_spline_update(self, z, x_int, p, ocp)
