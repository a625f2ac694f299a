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
from typing import Sequence, Tuple

import torch


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
    """

    states: Sequence[str] = ()
    inputs: Sequence[str] = ()
    lower_bound: Sequence[float] = ()
    upper_bound: Sequence[float] = ()
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
        """x_{k+1} = F(z_k). The reference's signature: `p`/`ocp` feed the
        parameter-dependent updates of models not ported yet (slack)."""
        u = z[..., : self.nu]
        x = z[..., self.nu :]
        return rk4_step(self.continuous_model, x, u, dt, num_steps)


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
