"""Warmstart strategies (host-side, numpy).

Counterpart of mpc_planner_tpu/solver/warmstart.py (numpy-only, copied).
Ref acados_solver_interface.cpp: initializeWithState (:287-301),
initializeWithBraking (:303-342), initializeWarmstart shift-forward /
keep (:344-376). Operates on the ego-prediction trajectory Z [N+1, nvar]
with z = (u, x) ordering.
"""

from __future__ import annotations

import numpy as np


def initialize_with_state(model, N: int, state) -> np.ndarray:
    """All stages at the current state, zero inputs (ref :287-301)."""
    Z = np.zeros((N + 1, model.nvar))
    for name in model.states:
        Z[:, model.index(name)] = state.get(name)
    return Z


def clip_to_bounds(model, Z: np.ndarray) -> np.ndarray:
    """Clip a warmstart into the model's box bounds. The reference leaves
    e.g. a = -3 outside the [-2, 2] input bound in its braking plan
    (deceleration_at_infeasible vs solver_model.py bounds) — a needlessly
    infeasible interior-point start."""
    lb = np.asarray(model.lower_bound)
    ub = np.asarray(model.upper_bound)
    return np.clip(Z, lb, ub)


def initialize_with_braking(model, N: int, dt: float, state, deceleration: float) -> np.ndarray:
    """Constant-deceleration straight-line plan (ref :303-342)."""
    Z = initialize_with_state(model, N, state)
    a = -abs(deceleration)
    x = state.get("x")
    y = state.get("y")
    psi = state.get("psi")
    v = state.get("v")
    spline = state.get("spline")

    def set_row(k, x, y, v, spline):
        for name, val in (("x", x), ("y", y), ("psi", psi), ("v", v),
                          ("spline", spline), ("a", a), ("w", 0.0)):
            try:
                Z[k, model.index(name)] = val
            except KeyError:
                pass

    set_row(0, x, y, v, spline)
    for k in range(1, N + 1):
        x += v * dt * np.cos(psi)
        y += v * dt * np.sin(psi)
        spline += v * dt
        v = max(v + a * dt, 0.0)
        set_row(k, x, y, v, spline)
    return clip_to_bounds(model, Z)


def initialize_warmstart(model, N: int, Z_prev: np.ndarray, state,
                         shift_forward: bool) -> np.ndarray:
    """Shift-forward or keep warmstart from the previous solution
    (ref :344-376)."""
    Z = Z_prev.copy()
    if shift_forward:
        # [current_state, z_2, ..., z_{N-1}, z_{N-1}, z_{N-1}]
        Z[1 : N - 1] = Z_prev[2:N]
        Z[N - 1] = Z_prev[N - 1]
        Z[N] = Z_prev[N - 1]
    for name in model.states:
        Z[0, model.index(name)] = state.get(name)
    return Z
