"""Independent KKT-residual verification of solver output.

Counterpart of mpc_planner_tpu/solver/kkt.py, with torch.func in the place
of jax autodiff.

The reference validates its solver stack end-to-end by generating a real
acados solver in CI and checking the OCP dimensions
(reference solver_generator/test/test_acados.py:48-77); its numerical
trust comes from acados/HPIPM themselves. Our solver IS the numerical
core, so this module provides the independent optimality check the
BASELINE criterion asks for ("reproduce reference control sequences
within tolerance"): given a solution trajectory and the interior-point
duals, verify the first-order KKT conditions of the NONLINEAR problem

    min  sum_k cost_k(z_k) + cost_N(x_N)
    s.t. x_{k+1} = F(z_k)                       k = 0..N-1   (dynamics)
         lb <= rows(z_k) <= ub                                (box + h)

directly from autodiff of the module expressions — no part of the
IPM/Riccati machinery is reused, so agreement is evidence of correctness,
not self-consistency.

Method: the inequality duals (lam_l, lam_u) come from the last QP, which
at SQP convergence are the NLP multipliers. The dynamics (equality)
multipliers nu_k are reconstructed by the adjoint recursion — choosing
nu to satisfy the x-rows of stationarity exactly:

    nu_{N-1} = grad_x cost_N(x_N) + d_x-rows(N)
    nu_{k}   = grad_x cost_{k+1} + A_{k+1}' nu_{k+1} + d_x-rows(k+1)

(d = D'(lam_u - lam_l) restricted to the x entries). The remaining
u-rows of the Lagrangian gradient,

    r_u(k) = grad_u cost_k + B_k' nu_k + d_u-rows(k),

are then the true reduced-gradient stationarity residual. Primal
feasibility and complementarity are checked directly on the constraint
values. Row layout matches solver/sqp.py::_linearize: [u-box, x-box, h].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad, jacfwd, jacrev, vmap


class KKTResiduals(NamedTuple):
    stationarity: float  # max |r_u| over the horizon (scaled)
    eq_residual: float  # max dynamics defect
    primal_box: float  # max box-bound violation
    primal_h: float  # max h-constraint violation
    complementarity: float  # max |lam * slack| over active rows
    dual_feasibility: float  # max negative multiplier (should be >= 0)


def _sentinel(bounds, big: float) -> torch.Tensor:
    b = np.asarray(bounds, float)
    return torch.as_tensor(np.where(np.isfinite(b), b, big), dtype=torch.float32)


def kkt_residuals(solver, Z, P, lam_l, lam_u) -> KKTResiduals:
    """Compute KKT residuals for one solve, on the CPU in float32.
    Z [N+1, nvar], P [N+1, npar], lam_l/lam_u [N+1, nrows] (row layout
    [u-box, x-box, h])."""
    ocp = solver.ocp
    N, nu, nx, nh = ocp.N, ocp.nu, ocp.nx, ocp.nh
    Z, P, lam_l, lam_u = (torch.as_tensor(np.asarray(x.cpu() if torch.is_tensor(x) else x),
                                          dtype=torch.float32) for x in (Z, P, lam_l, lam_u))
    Zr, Pr = Z[:N], P[:N]

    # --- ingredients from autodiff (independent of the QP solve path) ----
    g_run = vmap(grad(ocp.running_cost))(Zr, Pr)  # [N, nvar]
    # (.to: forward mode promotes `0-d tensor (op) Python float` to float64)
    Jf = vmap(jacfwd(ocp.dynamics_fn))(Zr, Pr).to(Z.dtype)  # [N, nx, nvar]
    A = Jf[:, :, nu:]
    B = Jf[:, :, :nu]
    g_term_x = grad(ocp.terminal_cost)(ocp.zero_inputs(Z[N]), P[N])[nu:]

    if nh:
        h_val = vmap(ocp.constraint_fn)(Zr, Pr)  # [N, nh]
        Jh = vmap(jacfwd(ocp.constraint_fn))(Zr, Pr).to(Z.dtype)  # [N, nh, nvar]
    else:
        h_val = Z.new_zeros((N, 0))
        Jh = Z.new_zeros((N, 0, ocp.nvar))

    # Net inequality dual per row (lower rows push +, upper rows push -)
    lam_net = lam_u - lam_l  # [N+1, nrows]
    d_u = lam_net[:, :nu]  # u-box rows act on u directly
    d_x = lam_net[:, nu : nu + nx]  # x-box rows act on x directly
    lam_h = lam_net[:, nu + nx :]  # [N+1, nh]
    # h-rows' pull-back onto (u, x) at stage k (h active at 0..N-1 only)
    dh = torch.einsum("khv,kh->kv", Jh, lam_h[:N])  # [N, nvar]

    # --- costate recursion (defines nu so x-rows are exactly satisfied) --
    # x-row of stage k+1 (k+1 in 1..N-1):
    #   grad_x cost_{k+1} + A_{k+1}' nu_{k+1} - nu_k + d_x(k+1) + dh_x(k+1) = 0
    # terminal: nu_{N-1} = grad_x cost_N + d_x(N)
    nus = [None] * N
    nus[N - 1] = g_term_x + d_x[N]
    for k in range(N - 2, -1, -1):
        nus[k] = g_run[k + 1, nu:] + A[k + 1].T @ nus[k + 1] + d_x[k + 1] + dh[k + 1, nu:]
    nus = torch.stack(nus)  # [N, nx] = nu_0..nu_{N-1}

    # --- u-rows: the true stationarity residual -------------------------
    Bnu = torch.einsum("kxu,kx->ku", B, nus)
    r_u = g_run[:, :nu] + Bnu + d_u[:N] + dh[:, :nu]
    # Scale by the size of the competing gradient terms so the residual is
    # relative (the absolute gradient scale varies 1e-2..1e3 across configs).
    scale = torch.clamp(g_run[:, :nu].abs().max() + Bnu.abs().max(), min=1.0)
    stationarity = r_u.abs().max() / scale

    # --- primal feasibility ---------------------------------------------
    eq_res = ocp.eq_residual(Z, P)

    lbz, ubz = _sentinel(ocp.lb_z, -1e15), _sentinel(ocp.ub_z, 1e15)
    # u-box at 0..N-1, x-box at 1..N
    viol_u = torch.clamp(torch.maximum(lbz[:nu] - Zr[:, :nu], Zr[:, :nu] - ubz[:nu]), min=0.0)
    Zx = Z[1:, nu:]
    viol_x = torch.clamp(torch.maximum(lbz[nu:] - Zx, Zx - ubz[nu:]), min=0.0)
    primal_box = torch.maximum(viol_u.max(), viol_x.max())

    if nh:
        lh, uh = _sentinel(ocp.lh, -1e15), _sentinel(ocp.uh, 1e15)
        primal_h = torch.clamp(torch.maximum(lh[None] - h_val, h_val - uh[None]), min=0.0).max()
    else:
        primal_h = Z.new_zeros(())

    # --- complementarity: lam * distance-to-bound -----------------------
    # Row values at the solution, layout [u-box, x-box, h] per stage.
    rows_run = torch.cat([Zr[:, :nu], Zr[:, nu:], h_val], dim=1)  # [N, nrows]
    lb_rows = torch.cat([lbz] + ([lh] if nh else []))
    ub_rows = torch.cat([ubz] + ([uh] if nh else []))
    # Active-row masks mirror _linearize: u/h rows at 0..N-1, x rows at 1..N.
    comp_l_run = lam_l[:N] * (rows_run - lb_rows[None]).abs()
    comp_u_run = lam_u[:N] * (ub_rows[None] - rows_run).abs()
    # x rows at stage N
    comp_l_term = lam_l[N, nu : nu + nx] * (Z[N, nu:] - lbz[nu:]).abs()
    comp_u_term = lam_u[N, nu : nu + nx] * (ubz[nu:] - Z[N, nu:]).abs()

    def mask_big(c):  # rows with infinite bounds (sentinel distance ~1e15)
        return torch.where(c > 1e10, 0.0, c)

    complementarity = torch.maximum(
        mask_big(torch.cat([comp_l_run.ravel(), comp_l_term])).max(),
        mask_big(torch.cat([comp_u_run.ravel(), comp_u_term])).max(),
    )

    dual_feas = torch.maximum((-lam_l).max(), (-lam_u).max())

    return KKTResiduals(
        stationarity=float(stationarity),
        eq_residual=float(eq_res),
        primal_box=float(primal_box),
        primal_h=float(primal_h),
        complementarity=float(complementarity),
        dual_feasibility=float(dual_feas),
    )


def dense_reference_solve(ocp, x0, P, U0, maxiter: int = 300):
    """Slow, independent dense solve of the same OCP via scipy
    trust-constr on the condensed (control-only) problem: states are
    eliminated by the exact rollout, box/h constraints become nonlinear
    inequality constraints of U. Used to cross-check the Riccati-IPM
    solver on small instances.

    Returns (U [N, nu], objective, scipy result)."""
    from scipy.optimize import Bounds, NonlinearConstraint, minimize

    N, nu = ocp.N, ocp.nu
    P = torch.as_tensor(np.asarray(P), dtype=torch.float32)
    x0 = torch.as_tensor(np.asarray(x0), dtype=torch.float32)

    def to_Z(U_flat):
        U = U_flat.reshape(N, nu)
        X = ocp.rollout(x0, U, P)  # [N+1, nx]
        U_full = torch.cat([U, U.new_zeros((1, nu))], dim=0)
        return torch.cat([U_full, X], dim=1)  # [N+1, nvar]

    def obj(U_flat):
        return ocp.total_cost(to_Z(U_flat), P)

    obj_grad = grad(obj)

    # Inequality rows: x-box (stages 1..N) + h (stages 0..N-1)
    lbz = np.asarray(ocp.lb_z, float)
    ubz = np.asarray(ocp.ub_z, float)

    def cons(U_flat):
        Z = to_Z(U_flat)
        parts = [Z[1:, nu:].ravel()]  # states
        if ocp.nh:
            parts.append(vmap(ocp.constraint_fn)(Z[:N], P[:N]).ravel())
        return torch.cat(parts)

    cons_jac = jacrev(cons)

    def tensor(u):
        return torch.as_tensor(np.asarray(u), dtype=torch.float32)

    cl = [np.tile(lbz[nu:], N)]
    cu = [np.tile(ubz[nu:], N)]
    if ocp.nh:
        cl.append(np.tile(np.asarray(ocp.lh, float), N))
        cu.append(np.tile(np.asarray(ocp.uh, float), N))

    nlc = NonlinearConstraint(
        lambda u: cons(tensor(u)).numpy().astype(float),
        np.concatenate(cl),
        np.concatenate(cu),
        jac=lambda u: cons_jac(tensor(u)).numpy().astype(float),
    )
    bounds = Bounds(np.tile(lbz[:nu], N), np.tile(ubz[:nu], N))

    res = minimize(
        lambda u: float(obj(tensor(u))),
        np.asarray(U0, float).ravel(),
        jac=lambda u: obj_grad(tensor(u)).numpy().astype(float),
        method="trust-constr",
        constraints=[nlc],
        bounds=bounds,
        options={"maxiter": maxiter, "gtol": 1e-10, "xtol": 1e-12},
    )
    return res.x.reshape(N, nu), float(res.fun), res
